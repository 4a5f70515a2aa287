"""Operations and bytes of the LM family: a step's model FLOPs and each
attention kernel launch's work.

Frozen copy, taken on 2026-10-18, of ``matmul_params``,
``forward_flops_per_token`` and ``train_flops_per_token`` in
``kubernetes_tpu_torch/perf/chip_bench.py``, counted for the port's
block (q, k, v, o projections of d_model x d_model; SwiGLU's three
d_model x d_ff matrices; the tied unembedding counted once):

- matmul params N = L * (4 e^2 + 3 e f) + e V;
- attention score and value FLOPs per token per layer = 2 T e, the
  causal (useful) count of the MFU convention;
- forward FLOPs per token = 2 N + 2 T e L; a training step 3x that.
  Recomputation under remat is not counted.

A launch of the attention kernels at [B, H, T, D] (the true head dim,
whatever tile it runs on) needs 4 B H D T^2 operations forward and 10 B
H D T^2 backward (S and P V; S again, dP, dV, dQ, dK), half of each
when causal, and reads each input and writes each output once: q, k, v
in, o and the f32 row sums out forward; q, k, v, o, dO and the row sums
in, dq, dk, dv out backward.
"""
from __future__ import annotations


def matmul_params(run: dict) -> int:
    e, f, l, v = run["d_model"], run["d_ff"], run["n_layers"], run["vocab"]
    return l * (4 * e * e + 3 * e * f) + e * v


def forward_flops_per_token(run: dict, seq: int) -> float:
    return 2.0 * matmul_params(run) + 2.0 * seq * run["d_model"] \
        * run["n_layers"]


def train_flops_per_token(run: dict, seq: int) -> float:
    return 3.0 * forward_flops_per_token(run, seq)


def attention_launch(direction: str, batch: int, heads: int, seq: int,
                     head_dim: int, causal: bool = True,
                     elem_bytes: int = 2) -> tuple:
    """``(operations, bytes)`` of one launch, ``direction`` ``"fwd"`` or
    ``"bwd"``, with q, k, v (and o, dO) of ``elem_bytes`` each."""
    per = {"fwd": 4.0, "bwd": 10.0}[direction]
    ops = per * batch * heads * head_dim * seq * seq
    if causal:
        ops /= 2
    plane = batch * heads * seq * head_dim * elem_bytes
    rows = batch * heads * seq * 4
    if direction == "fwd":
        return ops, 4 * plane + rows
    return ops, 8 * plane + rows


def bound_s(ops: float, nbytes: float, peak_flops: float,
            peak_bytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the peak rate and the bytes over the memory's rate."""
    return max(ops / peak_flops, nbytes / peak_bytes)
