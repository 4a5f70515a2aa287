"""Causal flash-attention forward: the kernel of ``csrc/flash_attn_fwd.cu``.

One kernel in place of the reference's two TPU attention kernels,
``_splash_attention`` and ``_flash_attention``
(``kubernetes_tpu/workloads/lm.py:163-239``). On CUDA tensors
:func:`flash_attention_fwd` launches it; on CPU tensors it computes the
plain :func:`~.ring_attention.reference_attention_with_lse`.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..kernels import build
from .ring_attention import reference_attention_with_lse

#: Kernel launches so far; the wrapper adds one per launch and nowhere
#: else, so a run can show that it went through the kernel.
launches = 0

HEAD_DIMS = (32, 64, 128)

_ARGS = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 4 + (ctypes.c_float,
                                                        ctypes.c_void_p)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Causal attention over [B, H, T, D] with ``sm_scale = 1/sqrt(D)``.

    Returns ``(o, lse)``: ``o`` [B, H, T, D] in ``q.dtype`` and the
    natural-log row sums of the scaled scores, ``lse`` [B, H, T] f32."""
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must be one [B, H, T, D] shape, got "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    if q.device.type == "cpu":
        return reference_attention_with_lse(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"flash attention kernel takes bfloat16, got "
                        f"{q.dtype} {k.dtype} {v.dtype}")
    b, h, t, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash attention kernel takes head dim "
                         f"{HEAD_DIMS}, not {d}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous():
            raise ValueError(f"flash attention kernel takes contiguous "
                             f"tensors; {name} is not (call .contiguous())")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    if b > 65535 or h > 65535:
        raise ValueError(f"batch and heads must be <= 65535, got {b}, {h}")
    o = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return o, lse
    lib = build.load("flash_attn_fwd", {"flash_attn_fwd_bf16": _ARGS})
    stream = torch.cuda.current_stream(q.device).cuda_stream
    scale_log2 = (1.0 / math.sqrt(d)) * math.log2(math.e)
    rc = lib.flash_attn_fwd_bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 o.data_ptr(), lse.data_ptr(), b, h, t, d,
                                 scale_log2, stream)
    build.check(lib, rc, "flash_attn_fwd")
    global launches
    launches += 1
    return o, lse


def flash_attention(q, k, v) -> torch.Tensor:
    """The attention output alone, in ``q.dtype``."""
    return flash_attention_fwd(q, k, v)[0]
