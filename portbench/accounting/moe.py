"""Operations and bytes of the MoE family (the LFM2 stack of
``configs/lfm2-8b-a1b.json``): a step's model FLOPs and each expert
GEMM's work. Written for the benchmark on 2026-10-18 from the layer
equations of ``reference/lfm2.py``; frozen with it.

- Active matmul params a token: each conv mixer's in_proj (d x 3d) and
  out_proj (d x d); each attention mixer's q (d x H dh), k and v (d x KV
  dh each) and o (H dh x d); each dense FFN's three d x F matrices; each
  sparse FFN's router (d x E) and its top_k experts' three d x f
  matrices; the tied unembedding (d x V) once.
- Forward FLOPs a token = 2 x those + 2 T d per attention layer (the
  causal score and value products, the MFU convention); a training step
  3x that. Recomputation under remat is not counted, nor the short
  conv's and the routing's elementwise work.

A grouped expert GEMM over ``rows`` routed rows of width d into f (or
its transposes: every one of a layer's three forward and six backward
GEMMs has this shape) needs 2 rows d f operations, and reads its inputs
and writes its output once: rows x d and rows x f elements, and the E
experts' d x f weights (or weight gradients), 2 bytes each.

``attention_launch`` and ``bound_s`` are the LM family's
(``accounting/lm.py``): GQA's k and v enter the kernels repeated to
every query head.
"""
from __future__ import annotations

from .lm import attention_launch, bound_s  # noqa: F401


def active_matmul_params(run: dict) -> int:
    d, v = run["d_model"], run["vocab"]
    dh = d // run["n_heads"]
    q, kv = run["n_heads"] * dh, run["n_kv_heads"] * dh
    types = run["layer_types"]
    dense = run["n_dense_layers"]
    mixers = types.count("conv") * 4 * d * d \
        + types.count("attention") * (2 * d * q + 2 * d * kv)
    ffns = dense * 3 * d * run["dense_d_ff"] + (len(types) - dense) * (
        d * run["n_experts"] + run["top_k"] * 3 * d * run["expert_d_ff"])
    return mixers + ffns + d * v


def forward_flops_per_token(run: dict, seq: int) -> float:
    return 2.0 * active_matmul_params(run) + 2.0 * seq * run["d_model"] \
        * run["layer_types"].count("attention")


def train_flops_per_token(run: dict, seq: int) -> float:
    return 3.0 * forward_flops_per_token(run, seq)


def expert_gemm(rows: float, d: int, f: int, experts: int,
                elem_bytes: int = 2) -> tuple:
    """``(operations, bytes)`` of one grouped expert GEMM over ``rows``
    rows."""
    return (2.0 * rows * d * f,
            elem_bytes * (rows * d + rows * f + experts * d * f))
