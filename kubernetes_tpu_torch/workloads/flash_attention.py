"""Causal flash attention: the kernels of ``csrc/flash_attn_fwd.cu`` and
``csrc/flash_attn_bwd.cu``.

One forward kernel in place of the reference's two TPU attention
kernels, ``_splash_attention`` and ``_flash_attention``
(``kubernetes_tpu/workloads/lm.py:163-239``), and one backward in place
of their Pallas backward kernels (the fused dq/dk/dv kernel of splash,
``lm.py:232-236``, and flash's dq / dkv kernels, ``lm.py:193-197``).

On CUDA tensors :func:`flash_attention_fwd` and :func:`flash_attention_bwd`
launch the kernels; on CPU tensors they compute the plain versions,
:func:`~.ring_attention.reference_attention_with_lse` and
:func:`flash_attention_bwd_plain`. :class:`FlashAttention` joins the two
into one differentiable op.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..kernels import build
from .ring_attention import causal_mask, reference_attention_with_lse

#: Forward kernel launches so far; the wrapper adds one per launch and
#: nowhere else, so a run can show that it went through the kernel.
launches = 0
#: Backward kernel launches so far (one per :func:`flash_attention_bwd`
#: call on CUDA tensors), counted like :data:`launches`.
bwd_launches = 0

HEAD_DIMS = (32, 64, 128)

_FWD = build.Kernel(
    "flash_attn_fwd", "flash_attn_fwd_bf16",
    (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 4 + (ctypes.c_float,
                                                    ctypes.c_void_p))
_BWD = build.Kernel(
    "flash_attn_bwd", "flash_attn_bwd_bf16",
    (ctypes.c_void_p,) * 10 + (ctypes.c_int,) * 4 + (ctypes.c_float,
                                                     ctypes.c_void_p))


def _check_kernel_inputs(what: str, **tensors) -> None:
    """The checks every kernel wrapper makes on its bf16 [B, H, T, D]
    inputs before a launch: dtype, head dim, contiguity, alignment and
    grid limits. Raises on what the kernels do not take."""
    for x in tensors.values():
        if x.dtype is not torch.bfloat16:
            bad = {n: t.dtype for n, t in tensors.items()
                   if t.dtype is not torch.bfloat16}
            raise TypeError(f"{what} kernel takes bfloat16, got {bad}")
    b, h, _, d = next(iter(tensors.values())).shape
    if d not in HEAD_DIMS:
        raise ValueError(f"{what} kernel takes head dim {HEAD_DIMS}, not {d}")
    for name, x in tensors.items():
        if not x.is_contiguous():
            raise ValueError(f"{what} kernel takes contiguous tensors; "
                             f"{name} is not (call .contiguous())")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    if b > 65535 or h > 65535:
        raise ValueError(f"batch and heads must be <= 65535, got {b}, {h}")


def _check_shapes(**tensors) -> torch.device:
    """The one [B, H, T, D] shape and the one device (cuda or cpu) of
    ``tensors``; raises otherwise. Reads each tensor's shape and device
    once and builds the message only to raise it."""
    first = next(iter(tensors.values()))
    shape, dev = first.shape, first.device
    for x in tensors.values():
        if len(shape) != 4 or x.shape != shape:
            shapes = {n: tuple(t.shape) for n, t in tensors.items()}
            raise ValueError(f"{', '.join(shapes)} must be one [B, H, T, D] "
                             f"shape, got {shapes}")
        if x.device != dev:
            raise ValueError(f"{', '.join(tensors)} must be on one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cuda or cpu, not {dev}")
    return dev


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Causal attention over [B, H, T, D] with ``sm_scale = 1/sqrt(D)``.

    Returns ``(o, lse)``: ``o`` [B, H, T, D] in ``q.dtype`` and the
    natural-log row sums of the scaled scores, ``lse`` [B, H, T] f32."""
    if _check_shapes(q=q, k=k, v=v).type == "cpu":
        return reference_attention_with_lse(q, k, v)
    _check_kernel_inputs("flash attention", q=q, k=k, v=v)
    b, h, t, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return o, lse
    scale_log2 = (1.0 / math.sqrt(d)) * math.log2(math.e)
    rc = _FWD.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     lse.data_ptr(), b, h, t, d, scale_log2,
                     build.current_stream(q.get_device()))
    if rc:
        raise _FWD.error(rc)
    global launches
    launches += 1
    return o, lse


def flash_attention(q, k, v) -> torch.Tensor:
    """The attention output alone, in ``q.dtype``."""
    return flash_attention_fwd(q, k, v)[0]


def flash_attention_bwd_plain(q, k, v, o, lse, do):
    """Gradients of causal attention, written out as the kernel computes
    them: ``P = exp(S * scale - lse)`` recomputed from the saved LSE,
    ``delta = rowsum(dO * O)``, ``dS = P * (dP - delta)``; then
    ``dq = scale * dS K``, ``dk = scale * dS^T Q``, ``dv = P^T dO``.
    All in f32, cast to ``q.dtype``. [B, H, T, T] intermediates: for
    checks, not for long sequences."""
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, of, dof = (x.float() for x in (q, k, v, o, do))
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    p = torch.where(causal_mask(q.shape[2], q.device),
                    torch.exp(s - lse.float()[..., None]), 0.0)
    del s
    delta = (dof * of).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", dof, vf) - delta)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    del p
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def flash_attention_bwd(q, k, v, o, lse, do):
    """``(dq, dk, dv)`` of causal attention given the forward's ``o``
    and ``lse`` and the output gradient ``do``, all [B, H, T, D] but
    ``lse`` [B, H, T] f32. CUDA tensors launch the kernel (bf16,
    contiguous, head dim 32, 64 or 128); CPU tensors take
    :func:`flash_attention_bwd_plain`."""
    dev = _check_shapes(q=q, k=k, v=v, o=o, do=do)
    if tuple(lse.shape) != tuple(q.shape[:3]) or lse.device != dev:
        raise ValueError(f"lse must be [B, H, T] = {tuple(q.shape[:3])} on "
                         f"{dev}, got {tuple(lse.shape)} on {lse.device}")
    if dev.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do)
    _check_kernel_inputs("flash attention backward", q=q, k=k, v=v, o=o,
                         do=do)
    if lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("lse must be contiguous float32")
    b, h, t, d = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    if q.numel() == 0:
        return dq, dk, dv
    delta = torch.empty((b, h, t), dtype=torch.float32, device=dev)
    rc = _BWD.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                     dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, t, d,
                     1.0 / math.sqrt(d), build.current_stream(q.get_device()))
    if rc:
        raise _BWD.error(rc)
    global bwd_launches
    bwd_launches += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Differentiable causal attention: the forward kernel, saving
    ``q, k, v, o, lse``, and the backward kernel (the plain versions of
    both on CPU tensors). ``dO`` from autograd is often a strided view,
    so the backward makes it contiguous; the kernel wrapper refuses
    strided input."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = flash_attention_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return flash_attention_bwd(q, k, v, o, lse, do.contiguous())
