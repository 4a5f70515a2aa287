"""Benchmark cases and FLOP accounting for the flagship LM on a GPU.

Counterpart of ``kubernetes_tpu/perf/chip_bench.py``, limited to what
the forward path needs: the cases, the analytic FLOPs per token and the
card's peak rates. FLOPs are counted from the model config, not from a
profiler, so the number is comparable across runs:

- matmul params N = L*(4*e^2 + 3*e*f) + e*V (the tied embedding counted
  once, via the output projection; the input embedding is a gather);
- attention score and value FLOPs per token per layer = 2*T*e, the
  CAUSAL (useful) FLOPs of the standard MFU convention;
- forward flops/token = 2*N + 2*T*e*L; a training step ~= 3x that.

The train bench itself is ported with the train step.
"""
from __future__ import annotations

import dataclasses

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
    #: "ring" (blockwise on one device) or "flash" (the attention kernel).
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
