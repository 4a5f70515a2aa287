"""Flash attention: the kernels of ``csrc/flash_attn_fwd.cu`` and
``csrc/flash_attn_bwd.cu``, causal or not.

One forward kernel in place of the reference's two TPU attention
kernels, ``_splash_attention`` and ``_flash_attention``
(``kubernetes_tpu/workloads/lm.py:163-239``), and one backward in place
of their Pallas backward kernels (the fused dq/dk/dv kernel of splash,
``lm.py:232-236``, and flash's dq / dkv kernels, ``lm.py:193-197``).

On CUDA tensors :func:`flash_attention_fwd` and :func:`flash_attention_bwd`
launch the kernels; on CPU tensors they compute the plain versions,
:func:`~.ring_attention.reference_attention_with_lse` and
:func:`flash_attention_bwd_plain`. :class:`FlashAttention` joins the two
into one differentiable causal op. ``causal=False`` takes the kernels'
non-causal instances, which mask nothing, and ``out_dtype=torch.float32``
their instances that write the output (or the gradients) in f32: the ring
(:mod:`.ring_attention`) runs both, non-causal on a block of keys wholly
before its queries, and sums its blocks in f32 before it rounds.

Head dims: the kernels take any head dim up to :data:`MAX_HEAD_DIM`. A
multiple of 8 launches as it is (the smallest of their tile widths 16,
32, 64, 128, 256 that holds it runs, its extra columns zeros that TMA
fills in); any other is copied into a zero-padded ``[B, H, T,
ceil8(D)]`` buffer first, the result sliced back to D, with
``1/sqrt(D)`` of the true D. A head dim over 256 raises ``ValueError``.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from ..kernels import build
from .ring_attention import causal_mask, reference_attention_with_lse

#: Forward kernel launches so far; the wrapper adds one per launch and
#: nowhere else, so a run can show that it went through the kernel.
launches = 0
#: Backward kernel launches so far (one per :func:`flash_attention_bwd`
#: call on CUDA tensors), counted like :data:`launches`.
bwd_launches = 0
#: Of those, the launches of the non-causal instances, forward and
#: backward: the ring's blocks before their queries.
non_causal_launches = 0
non_causal_bwd_launches = 0


def counts() -> dict:
    """The launches so far by kernel instance: causal and non-causal
    apart, forward and backward."""
    return {"flash_attn_fwd": launches - non_causal_launches,
            "flash_attn_bwd": bwd_launches - non_causal_bwd_launches,
            "flash_attn_fwd_non_causal": non_causal_launches,
            "flash_attn_bwd_non_causal": non_causal_bwd_launches}

#: The widest head dim the kernels take: their widest tile (GPT-J-6B's
#: 256). From 1 (the trainer's default LM has 16) to this one, every
#: head dim launches them.
MAX_HEAD_DIM = 256


def takes_head_dim(d: int) -> bool:
    """Whether the kernels take head dim ``d``: 1 to :data:`MAX_HEAD_DIM`."""
    return 0 < d <= MAX_HEAD_DIM


def _padded(d: int) -> int:
    """The width a head dim ``d`` launches at: ``d`` rounded up to a
    multiple of 8 (TMA takes row strides of 16 bytes)."""
    return -(-d // 8) * 8


def _pad(x: torch.Tensor, width: int) -> torch.Tensor:
    """``x`` [..., d] as a contiguous [..., width], zeros after column d;
    ``x`` itself when it is that wide already."""
    return x if x.shape[-1] == width else F.pad(x, (0, width - x.shape[-1]))

_FWD = build.Kernel(
    "flash_attn_fwd", "flash_attn_fwd_bf16",
    (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 6
    + (ctypes.c_float, ctypes.c_int, ctypes.c_void_p))
_BWD = build.Kernel(
    "flash_attn_bwd", "flash_attn_bwd_bf16",
    (ctypes.c_void_p,) * 10 + (ctypes.c_int,) * 6
    + (ctypes.c_float, ctypes.c_int, ctypes.c_void_p))


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
    if not takes_head_dim(d):
        raise ValueError(f"{what} kernel takes head dim 1 to {MAX_HEAD_DIM}, "
                         f"not {d}")
    for name, x in tensors.items():
        if not x.is_contiguous():
            raise ValueError(f"{what} kernel takes contiguous tensors; "
                             f"{name} is not (call .contiguous())")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    if b > 65535 or h > 65535:
        raise ValueError(f"batch and heads must be <= 65535, got {b}, {h}")


def _out_dtype(q: torch.Tensor, out_dtype) -> torch.dtype:
    """The output dtype asked for: ``q.dtype`` by default, else f32 (the
    kernels' other output) or ``q.dtype`` itself."""
    if out_dtype is None or out_dtype == q.dtype:
        return q.dtype
    if out_dtype != torch.float32:
        raise ValueError(f"out_dtype must be {q.dtype} or float32, "
                         f"not {out_dtype}")
    return out_dtype


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


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, out_dtype=None):
    """Attention over [B, H, T, D] with ``sm_scale = 1/sqrt(D)``; causal
    (query ``i`` sees keys ``j <= i``) or, with ``causal=False``, every
    query sees every key.

    Returns ``(o, lse)``: ``o`` [B, H, T, D] in ``out_dtype`` (default
    ``q.dtype``; or f32, unrounded) and the natural-log row sums of the
    scaled scores, ``lse`` [B, H, T] f32. CUDA tensors launch the kernel
    (bf16, contiguous, D up to :data:`MAX_HEAD_DIM`; one not a multiple
    of 8 through a zero-padded copy); CPU tensors take
    :func:`~.ring_attention.reference_attention_with_lse`."""
    out_dtype = _out_dtype(q, out_dtype)
    if _check_shapes(q=q, k=k, v=v).type == "cpu":
        return reference_attention_with_lse(q, k, v, causal, out_dtype)
    _check_kernel_inputs("flash attention", q=q, k=k, v=v)
    return _kernel_fwd(q, k, v, causal, out_dtype)


def _kernel_fwd(q, k, v, causal: bool, out_dtype):
    """The forward kernel's launch on checked inputs: at the head dim
    padded to a multiple of 8, with the scale of the true one, ``o``
    sliced back to it."""
    b, h, t, d = q.shape
    w = _padded(d)
    if q.numel() == 0:
        return (torch.empty_like(q, dtype=out_dtype),
                torch.empty((b, h, t), dtype=torch.float32, device=q.device))
    q, k, v = (_pad(x, w) for x in (q, k, v))
    o = torch.empty_like(q, dtype=out_dtype)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    scale_log2 = (1.0 / math.sqrt(d)) * math.log2(math.e)
    device = q.get_device()
    rc = _FWD.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     lse.data_ptr(), b, h, t, w, int(causal),
                     int(out_dtype == torch.float32), scale_log2, device,
                     build.current_stream(device))
    if rc:
        raise _FWD.error(rc)
    global launches, non_causal_launches
    launches += 1
    non_causal_launches += not causal
    return (o if w == d else o[..., :d].contiguous()), lse


def flash_attention(q, k, v) -> torch.Tensor:
    """The causal attention output alone, in ``q.dtype``."""
    return flash_attention_fwd(q, k, v)[0]


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal: bool = True,
                              out_dtype=None):
    """Gradients of attention, causal or not, written out as the kernel
    computes them: ``P = exp(S * scale - lse)`` recomputed from the saved
    LSE, ``delta = rowsum(dO * O)``, ``dS = P * (dP - delta)``; then
    ``dq = scale * dS K``, ``dk = scale * dS^T Q``, ``dv = P^T dO``.
    All in f32, cast to ``out_dtype`` (default ``q.dtype``). [B, H, T, T]
    intermediates: for checks, not for long sequences."""
    out_dtype = out_dtype or q.dtype
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, of, dof = (x.float() for x in (q, k, v, o, do))
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    p = torch.exp(s - lse.float()[..., None])
    del s
    if causal:
        p = torch.where(causal_mask(q.shape[2], q.device), p, 0.0)
    delta = (dof * of).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", dof, vf) - delta)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    del p
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    return dq.to(out_dtype), dk.to(out_dtype), dv.to(out_dtype)


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = True,
                        out_dtype=None):
    """``(dq, dk, dv)`` of attention, causal or not, given the forward's
    ``o`` and ``lse`` and the output gradient ``do``, all [B, H, T, D]
    but ``lse`` [B, H, T] f32; the gradients in ``out_dtype`` (default
    ``q.dtype``; or f32, unrounded). CUDA tensors launch the kernel
    (bf16, contiguous, D up to :data:`MAX_HEAD_DIM`; one not a multiple
    of 8 through zero-padded copies); CPU tensors take
    :func:`flash_attention_bwd_plain`."""
    out_dtype = _out_dtype(q, out_dtype)
    dev = _check_shapes(q=q, k=k, v=v, o=o, do=do)
    if tuple(lse.shape) != tuple(q.shape[:3]) or lse.device != dev:
        raise ValueError(f"lse must be [B, H, T] = {tuple(q.shape[:3])} on "
                         f"{dev}, got {tuple(lse.shape)} on {lse.device}")
    if dev.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal,
                                         out_dtype)
    _check_kernel_inputs("flash attention backward", q=q, k=k, v=v, o=o,
                         do=do)
    if lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("lse must be contiguous float32")
    return _kernel_bwd(q, k, v, o, lse, do, causal, out_dtype)


def _kernel_bwd(q, k, v, o, lse, do, causal: bool, out_dtype):
    """The backward kernel's launch on checked inputs, as
    :func:`_kernel_fwd`: padded, the true scale, the gradients sliced
    back."""
    b, h, t, d = q.shape
    w = _padded(d)
    if q.numel() == 0:
        return tuple(torch.empty_like(q, dtype=out_dtype) for _ in range(3))
    q, k, v, o, do = (_pad(x, w) for x in (q, k, v, o, do))
    dq, dk, dv = (torch.empty_like(q, dtype=out_dtype) for _ in range(3))
    delta = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    device = q.get_device()
    rc = _BWD.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                     dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, t, w,
                     int(causal), int(out_dtype == torch.float32),
                     1.0 / math.sqrt(d), device, build.current_stream(device))
    if rc:
        raise _BWD.error(rc)
    global bwd_launches, non_causal_bwd_launches
    bwd_launches += 1
    non_causal_bwd_launches += not causal
    if w == d:
        return dq, dk, dv
    return tuple(g[..., :d].contiguous() for g in (dq, dk, dv))


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
