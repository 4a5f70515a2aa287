"""Benchmark cases and FLOP accounting for the flagship LM on a GPU.

Counterpart of ``kubernetes_tpu/perf/chip_bench.py``: the cases, the
analytic FLOPs per token, the card's peak rates and the train bench
(:func:`run_case`, :func:`run`):

    python -m kubernetes_tpu_torch.perf.chip_bench

FLOPs are counted from the model config, not from a profiler, so the
number is comparable across runs:

- matmul params N = L*(4*e^2 + 3*e*f) + e*V (the tied embedding counted
  once, via the output projection; the input embedding is a gather);
- attention score and value FLOPs per token per layer = 2*T*e, the
  CAUSAL (useful) FLOPs of the standard MFU convention;
- forward flops/token = 2*N + 2*T*e*L; a training step ~= 3x that.
"""
from __future__ import annotations

import dataclasses
import json

#: (substring of ``torch.cuda.get_device_name()``, lower-cased; dense
#: bf16 FLOP/s; device-memory bytes/s). NVIDIA's data sheets; the
#: first match wins, so the PCIe part precedes the SXM default.
PEAKS = [
    ("h100 pcie", 756e12, 2.0e12),
    ("h100", 989e12, 3.35e12),
]
DEFAULT_PEAK = (989e12, 3.35e12)


def _peaks_for(device_name: str) -> tuple[float, float, bool]:
    name = device_name.lower()
    for sub, flops, bytes_s in PEAKS:
        if sub in name:
            return flops, bytes_s, True
    return *DEFAULT_PEAK, False


def peak_flops_for(device_name: str) -> tuple[float, bool]:
    """(peak dense bf16 FLOP/s, known); ``known=False`` means the
    H100 SXM figure was assumed and an MFU computed from it must be
    flagged, not trusted."""
    flops, _, known = _peaks_for(device_name)
    return flops, known


def peak_bytes_for(device_name: str) -> tuple[float, bool]:
    """(device-memory bytes/s, known), as :func:`peak_flops_for`."""
    _, bytes_s, known = _peaks_for(device_name)
    return bytes_s, known


@dataclasses.dataclass(frozen=True)
class BenchCase:
    name: str
    d_model: int
    n_layers: int
    n_heads: int
    d_ff: int
    vocab: int
    batch: int
    seq: int
    #: "ring" (one causal kernel launch a layer on one device) or "flash"
    #: (the attention kernel).
    attn_impl: str = "ring"
    #: Param storage dtype.
    param_dtype: str = "bfloat16"


def _case(name: str, batch: int, seq: int, attn: str = "ring",
          dtype: str = "bfloat16") -> BenchCase:
    return BenchCase(name, d_model=2048, n_layers=8, n_heads=16,
                     d_ff=8192, vocab=32768, batch=batch, seq=seq,
                     attn_impl=attn, param_dtype=dtype)


#: One model (600M dense transformer) at a fixed 8k-token step across
#: sequence regimes and both attention kernels, as in the reference.
CASES = [
    _case("lm-600m-t512", 16, 512),
    _case("lm-600m-t1k", 8, 1024),
    _case("lm-600m-t2k", 4, 2048, dtype="float32"),
    _case("lm-600m-t512-flash", 16, 512, "flash"),
    _case("lm-600m-t1k-flash", 8, 1024, "flash"),
    _case("lm-600m-t2k-flash", 4, 2048, "flash"),
    _case("lm-600m-t4k-flash", 2, 4096, "flash"),
    _case("lm-600m-t8k-flash", 1, 8192, "flash"),
]


#: The MoE at the 600M widths: the cases' widths with ``MoEConfig``'s
#: own expert defaults (4 experts, top-2, capacity factor 1.25), f32
#: params and bf16 compute, at MOE_BATCH (B, T): ``chip_smoke.py``'s
#: ``moe`` and ``moe_ep`` phases. The reference has no MoE bench case.
MOE_WIDTHS = dict(vocab=32768, d_model=2048, n_heads=16, d_ff=8192,
                  n_experts=4, top_k=2)
MOE_BATCH = (4, 2048)


def moe_flops(cfg, batch: int, seq: int) -> dict:
    """Matmul FLOPs of one forward of the MoE ``cfg`` (a
    ``moe.MoEConfig``) at B x T, two counts. ``executed``, as the port
    runs it: the dense projections, causal attention, the router, the
    one-hot dispatch and combine einsums over every capacity slot, the
    experts over every slot, filled or not, and the unembedding.
    ``model``, the MFU convention's: the same without the one-hot
    einsums, and the experts over each token's top_k picks."""
    n, d, e = batch * seq, cfg.d_model, cfg.n_experts
    c = max(1, int(cfg.capacity_factor * cfg.top_k * n / e))
    expert = 3 * 2.0 * d * cfg.d_ff  # one token through one expert
    model = {"projections": 2.0 * n * d * d * 4,
             "attention": 4.0 * batch * d * seq * (seq + 1) / 2,
             "router": 2.0 * n * d * e,
             "experts": n * cfg.top_k * expert}
    executed = {**model, "dispatch": 2.0 * n * e * c * d,
                "experts": e * c * expert,
                "combine": 2.0 * n * e * c * d}
    unembed = 2.0 * n * d * cfg.vocab
    return {"capacity": c, "executed_per_layer": executed,
            "model_per_layer": model, "unembed": unembed,
            "executed": cfg.n_layers * sum(executed.values()) + unembed,
            "model": cfg.n_layers * sum(model.values()) + unembed}


def case(name: str) -> BenchCase:
    for c in CASES:
        if c.name == name:
            return c
    raise KeyError(name)


def matmul_params(case: BenchCase) -> int:
    e, f, l, v = case.d_model, case.d_ff, case.n_layers, case.vocab
    return l * (4 * e * e + 3 * e * f) + e * v


def forward_flops_per_token(case: BenchCase) -> float:
    return (2.0 * matmul_params(case)
            + 2.0 * case.seq * case.d_model * case.n_layers)


def train_flops_per_token(case: BenchCase) -> float:
    return 3.0 * forward_flops_per_token(case)


def run_case(case: BenchCase, steps: int = 10, warmup: int = 2) -> dict:
    """Train-step throughput of one case on the GPU: init, ``warmup``
    steps, then the best of three trials of ``steps`` steps, each timed
    with CUDA events. Raises without a CUDA device. The ring cases run on
    one card, where the ring is one causal launch a layer."""
    import torch

    from ..device import resolve_device
    from ..workloads import lm

    dev = resolve_device()
    cfg = lm.LMConfig(vocab=case.vocab, d_model=case.d_model,
                      n_layers=case.n_layers, n_heads=case.n_heads,
                      d_ff=case.d_ff, attn_impl=case.attn_impl,
                      param_dtype=getattr(torch, case.param_dtype))
    params, opt_state = lm.init_train_state(
        torch.Generator(device=dev).manual_seed(0), cfg)
    step = lm.make_train_step(cfg, device=dev)
    batch = lm.synthetic_batch(torch.Generator(device=dev).manual_seed(1),
                               cfg, case.batch, case.seq, dev)
    for _ in range(max(warmup, 1)):
        params, opt_state, loss = step(params, opt_state, batch)
    torch.cuda.synchronize(dev)
    best_ms = float("inf")
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps):
            params, opt_state, loss = step(params, opt_state, batch)
        end.record()
        end.synchronize()
        best_ms = min(best_ms, start.elapsed_time(end))

    tok_s = case.batch * case.seq * steps / (best_ms * 1e-3)
    name = torch.cuda.get_device_name(dev)
    peak, peak_known = peak_flops_for(name)
    res = {
        "case": case.name,
        "tokens_per_sec_per_chip": round(tok_s, 1),
        "mfu": round(tok_s * train_flops_per_token(case) / peak, 4),
        "step_ms": round(best_ms / steps, 2),
        "loss": round(float(loss), 4),
        "device_kind": name,
        "peak_bf16_tflops": peak / 1e12,
    }
    if not peak_known:
        res["peak_is_fallback_guess"] = True
    return res


def run(steps: int = 10) -> dict:
    """Run every case; returns the best-MFU result and the per-case
    details, a case that fails as ``{"case", "error"}``. Raises without
    a CUDA device: a CPU has no train throughput to report."""
    import torch

    from ..device import resolve_device

    resolve_device()
    results = []
    for case in CASES:
        try:
            results.append(run_case(case, steps=steps))
        except Exception as exc:  # noqa: BLE001 -- OOM etc: report others
            results.append({"case": case.name,
                            "error": f"{type(exc).__name__}: {exc}"[:200]})
        torch.cuda.empty_cache()
    ok = [r for r in results if "mfu" in r]
    if not ok:
        return {"cases": results}
    best = max(ok, key=lambda r: r["mfu"])
    return {**best, "cases": results}


if __name__ == "__main__":
    print(json.dumps(run(), indent=2))
