"""Where the MoE's f32 steps through the flash kernels part from plain f32.

    python -m kubernetes_tpu_torch.perf.moe_f32_routing [--steps N] [--layers L]

On one card: the MoE at ``chip_bench.MOE_WIDTHS`` (head dim 128) in f32
params and compute at ``chip_bench.MOE_BATCH``, TF32 off, ``--steps``
train steps on one batch (seed 1) from the params of seed 0 (the model's
``make_train_step``, AdamW at lr 3e-3), in four paths that differ in the
attention alone (:data:`PATHS`):

- ``kernels``: the default ring at sp = 1, the flash kernels' f32
  instances (each operand as two bf16 parts, three products of them);
- ``plain``: plain f32 attention (``ring_attention.reference_attention``);
- ``f64``: plain attention in float64 (``gates.attention_f64``);
- ``split``: plain f32 attention on q, k and v rounded to the kernels'
  two bf16 parts (hi + lo, within 2^-17 relative of each value): the
  kernels' operand precision without their products.

Prints each path's losses and their relative distance from ``plain`` by
step and, at each step's params of the plain path, layer by layer with
every path given the plain path's input to the layer, the tokens whose
top-k set of experts (``top_k``), or whose experts kept after the
capacity cut (``kept``), differ from the plain path's. The last line is
one JSON object with the card's name.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch

from ..workloads import moe
from ..workloads.ring_attention import reference_attention
from . import chip_bench
from .gates import _moe_layer, _one_device, attention_f64


def split_operands(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to the sum of its two bf16 parts (hi, its rounding;
    lo, the rounding of the rest), as the f32 kernels take it; the
    gradient passes through unchanged."""
    hi = x.to(torch.bfloat16).float()
    lo = (x - hi).to(torch.bfloat16).float()
    return x + (hi + lo - x).detach()


def split_attention(q, k, v) -> torch.Tensor:
    """Plain f32 attention on :func:`split_operands` of q, k and v."""
    return reference_attention(*(split_operands(t) for t in (q, k, v)))


#: The paths: the attention each step takes (None: the model's default,
#: the ring through the kernels).
PATHS = {"kernels": None, "plain": reference_attention, "f64": attention_f64,
         "split": split_attention}


def routing_differs(params: dict, tokens: torch.Tensor, cfg) -> dict:
    """At ``params``, layer by layer, each path fed the plain path's input
    to the layer: for every path but ``plain``, the tokens per layer
    whose top-k set (``top_k``) or kept experts (``kept``) differ from
    the plain path's."""
    x = params["embed"].to(cfg.compute_dtype)[tokens.long()]
    out = {n: {"top_k": [], "kept": []} for n in PATHS if n != "plain"}
    for layer in range(cfg.n_layers):
        got = {n: _moe_layer(x, params, layer, cfg, att or _one_device)
               for n, att in PATHS.items()}
        _, _, sets, kept = got["plain"]
        for n in out:
            out[n]["top_k"].append(int((got[n][2] != sets).any(-1).sum()))
            out[n]["kept"].append(int((got[n][3] != kept).any(-1).sum()))
        x = got["plain"][0]
        del got
    return out


def readings(cfg, batch: int, seq: int, steps: int, device="cuda") -> dict:
    """Each path's ``steps`` losses, their distance from ``plain``'s, and
    :func:`routing_differs` at each step's params of the plain path."""
    data = moe.synthetic_batch(torch.Generator(device).manual_seed(1), cfg,
                               batch, seq, device)
    losses, differs = {}, []
    for name, attention in PATHS.items():
        params, opt_state = moe.init_train_state(
            torch.Generator(device).manual_seed(0), cfg)
        step = moe.make_train_step(cfg, device=device, attention=attention)
        losses[name] = []
        for _ in range(steps):
            if name == "plain":
                differs.append(routing_differs(params, data[:, :-1], cfg))
            params, opt_state, loss = step(params, opt_state, data)
            losses[name].append(float(loss))
        del params, opt_state
        if device == "cuda":
            torch.cuda.empty_cache()
    rel = {n: [abs(x - y) / abs(y) for x, y in zip(got, losses["plain"])]
           for n, got in losses.items() if n != "plain"}
    return {"losses": losses, "rel_to_plain": rel,
            "routing_differs_by_step": differs}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--layers", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("moe_f32_routing: torch sees no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    batch, seq = chip_bench.MOE_BATCH
    cfg = moe.MoEConfig(n_layers=args.layers, **chip_bench.MOE_WIDTHS,
                        compute_dtype=torch.float32)
    out = readings(cfg, batch, seq, args.steps)
    print(smi)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "n_layers": cfg.n_layers, "batch": batch, "seq": seq,
                      "tokens_per_layer": batch * seq, **out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
