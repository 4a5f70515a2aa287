"""Plain causal attention, the numerics reference for the kernels.

Counterpart of ``reference_attention`` in
``kubernetes_tpu/workloads/ring_attention.py``. The sequence-parallel
ring itself is ported in a later change, on top of the flash kernel's
``(o, lse)``.
"""
from __future__ import annotations

import torch

_NEG = -1e30


def causal_mask(t: int, device) -> torch.Tensor:
    """[T, T] bool, True where query row ``i`` may see key ``j <= i``."""
    pos = torch.arange(t, device=device)
    return pos[:, None] >= pos[None, :]


def _masked_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """f32 ``q k^T / sqrt(D)`` plus an additive causal mask, [B,H,T,T]."""
    d, t = q.shape[-1], q.shape[2]
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / (d ** 0.5)
    return scores + torch.where(causal_mask(t, q.device), 0.0, _NEG)


def reference_attention(q, k, v) -> torch.Tensor:
    """Plain global causal attention over [B, H, T, D]; f32 softmax,
    output in ``q.dtype``."""
    p = torch.softmax(_masked_scores(q, k), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def reference_attention_with_lse(q, k, v):
    """:func:`reference_attention` and the natural-log row sums of the
    scaled, masked scores, ``lse`` [B, H, T] f32: the plain version of
    the flash-attention kernel's two outputs."""
    scores = _masked_scores(q, k)
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
    return o, torch.logsumexp(scores, dim=-1)
