"""Flash attention: the kernels of ``csrc/flash_attn_fwd.cu``,
``csrc/flash_attn_bwd.cu`` and, at head dims wider than their tiles,
``csrc/flash_attn_wide.cu``; causal or not.

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

Dtypes: q, k, v (and o, dO) all bf16 or all f32; any other dtype, or
two dtypes, raise ``TypeError``. bf16 takes the ``*_bf16`` entry points;
f32 the ``*_f32`` ones, whose pre-pass splits each operand into two
fp16 parts under a power-of-2 scale per [batch, head] slice that the
kernels multiply three times (hi.hi + hi.lo + lo.hi,
``csrc/hopper.cuh``), so the products keep ~22 significant bits, near
f32's own 24, where one-pass TF32 keeps ~11; their outputs are f32. The
pre-pass writes the parts and the slices' largest |x| into scratch that
the wrapper allocates.

Head dims: every head dim from 1 launches a kernel, in either dtype.
Up to :data:`MAX_HEAD_DIM` in bf16 and :data:`MAX_F32_HEAD_DIM` in f32
(:func:`one_tile`) the fused kernels run, on the smallest of their tile
widths 16, 32, 64, 128, 256 that holds it, its extra columns zeros that
TMA fills in; over it the wide kernels, which split the head dim into
64-column slices (``csrc/flash_attn_wide.cu``). A multiple of 8 launches
as it is; any other is copied into a zero-padded ``[B, H, T, ceil8(D)]``
buffer first, the result sliced back to D, with ``1/sqrt(D)`` of the
true D.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from ..kernels import build
from .ring_attention import causal_mask, reference_attention_with_lse

def _instance(direction: str, wide: bool, causal: bool, f32: bool) -> str:
    """The name of a kernel instance: ``flash_attn_`` and ``fwd`` or
    ``bwd``, then ``_wide`` (head dims over :func:`one_tile`), ``_f32``
    (f32 q, k, v) and ``_non_causal`` where they apply."""
    return (f"flash_attn_{direction}{'_wide' if wide else ''}"
            f"{'_f32' if f32 else ''}{'' if causal else '_non_causal'}")


#: Launches so far by kernel instance (:func:`_instance`); a wrapper adds
#: one where it launches and nowhere else, so a run can show that it
#: went through the kernels.
_launches = {_instance(d, w, c, f): 0 for d in ("fwd", "bwd")
             for w in (False, True) for f in (False, True)
             for c in (True, False)}


def counts() -> dict:
    """The launches so far by kernel instance: the fused and the wide
    kernels, bf16 and f32, causal and non-causal apart, forward and
    backward."""
    return dict(_launches)


def zero_counts() -> None:
    """Every launch counter to 0."""
    for name in _launches:
        _launches[name] = 0


#: The widest head dim one tile of the fused kernels holds in bf16: their
#: widest tile (GPT-J-6B's 256). Wider bf16 head dims take the wide
#: kernels.
MAX_HEAD_DIM = 256
#: The same in f32: an f32 operand's two fp16 parts take twice a bf16
#: tile's bytes, so the widest f32 tile, 128, fills the shared memory of
#: the bf16 tile of 256. Wider f32 head dims take the wide kernels.
MAX_F32_HEAD_DIM = 128
#: The dtypes the kernels take, and each one's widest one-tile head dim.
_MAX_D = {torch.bfloat16: MAX_HEAD_DIM, torch.float32: MAX_F32_HEAD_DIM}


def takes_head_dim(d: int, dtype=torch.bfloat16) -> bool:
    """Whether the kernels take head dim ``d`` in ``dtype``: every head
    dim from 1 in bf16 and in f32 (the wide kernels over
    :func:`one_tile`), none in any other dtype."""
    return d > 0 and dtype in _MAX_D


def one_tile(d: int, dtype=torch.bfloat16) -> bool:
    """Whether head dim ``d`` in ``dtype`` runs on one tile of the fused
    kernels: 1 to :data:`MAX_HEAD_DIM` in bf16, 1 to
    :data:`MAX_F32_HEAD_DIM` in f32; a wider one takes the wide
    kernels."""
    return 0 < d <= _MAX_D.get(dtype, 0)


#: The wide kernels' plan (``csrc/flash_attn_wide.cu``, ``make_plan``):
#: a tile part's bytes (64 rows x 64 columns of 16 bits), a block's
#: shared memory, the slice ring's most stages and the stages a plan
#: wants first, and each kernel's widest
#: column group in 64-column boxes by operand parts (1: bf16; 2: the fp16
#: hi and lo of f32), which the output's registers bound.
_WIDE_UNIT = 64 * 64 * 2
_WIDE_SMEM = 232448
_WIDE_MAX_STAGES = 8
_WIDE_WANT_STAGES = 3
_WIDE_GROUP_CAP = {"forward": {1: 5, 2: 2}, "dkdv": {1: 5, 2: 2},
                   "dq": {1: 6, 2: 4}}


def _wide_bytes(kernel: str, parts: int, slices: int, boxes: int,
                resident: bool, s_stages: int, g_stages: int) -> int:
    """Shared memory of one wide-kernel block: alignment slack, resident
    A operands (Q for 128 rows; K and V; Q and dO), the slice ring (K_j
    and Q_j; Q_j and dO_j, + K_j and V_j; K_j and V_j, + Q_j and dO_j,
    unless resident), the group ring (V_c; dO_c and Q_c; K_c), the f32
    exchange buffers (none; P^T; P and dS) and 256 bytes of barriers."""
    u = _WIDE_UNIT * parts
    res = 2 * slices * u if resident else 0
    s_item = (1 if kernel == "forward" else 2) * u + (0 if resident
                                                     else 2 * u)
    g_item = (2 if kernel == "dkdv" else 1) * boxes * u
    xch = {"forward": 0, "dkdv": 1, "dq": 2}[kernel] * 64 * 64 * 4
    return (1024 + res + s_stages * s_item + g_stages * g_item + xch
            + 256)


def wide_plan(d: int, dtype=torch.bfloat16) -> dict:
    """The wide kernels' column-group plan at head dim ``d`` in ``dtype``
    (bf16 or f32), as ``make_plan`` in ``csrc/flash_attn_wide.cu`` makes
    it for the width ``d`` launches at.

    Per kernel (``"forward"``, ``"dkdv"``, ``"dq"``): ``group_boxes``,
    the 64-column boxes of each column group a block owns (S and dP are
    computed once per tile pair for all of them); ``groups``, the blocks
    per row tile (each recomputing S); ``resident``, whether the score
    products' A operands stay in shared memory; the rings' stages; the
    block's shared memory; and ``executed_over_useful``, the products
    executed (S and dP per group, the outputs over the 64-padded head
    dim Dp) over those of one pass at ``d``: (groups + 1) Dp / 2d forward
    and dK/dV, (2 groups + 1) Dp / 3d dQ. ``"backward"`` holds the two
    backward kernels' ratio together."""
    parts = 2 if dtype is torch.float32 else 1
    slices = -(-_padded(d) // 64)
    dp = 64 * slices
    plan = {}
    for kernel in _WIDE_GROUP_CAP:
        plan[kernel] = _wide_kernel_plan(kernel, parts, slices)
        groups = plan[kernel]["groups"]
        plan[kernel]["executed_over_useful"] = (
            (2 * groups + 1) * dp / (3 * d) if kernel == "dq"
            else (groups + 1) * dp / (2 * d))
    kv, q = plan["dkdv"]["groups"], plan["dq"]["groups"]
    plan["backward"] = {"executed_over_useful":
                        (2 * kv + 2 + 2 * q + 1) * dp / (7 * d)}
    return plan


def _wide_kernel_plan(kernel: str, parts: int, slices: int) -> dict:
    """One kernel's plan: the fewest groups of the widest boxes that fit;
    then :data:`_WIDE_WANT_STAGES` slice stages, resident A operands, two
    group stages, in that order; then as many slice stages (up to
    :data:`_WIDE_MAX_STAGES`) as fit; 2 at least."""
    for want in range(min(_WIDE_GROUP_CAP[kernel][parts], slices), 0, -1):
        groups = -(-slices // want)
        boxes = -(-slices // groups)
        groups = -(-slices // boxes)
        for s_stages, resident, g_stages in (
                (s, r, g) for s in (_WIDE_WANT_STAGES, 2)
                for r in (True, False) for g in (2, 1)):
            if _wide_bytes(kernel, parts, slices, boxes, resident, s_stages,
                           g_stages) > _WIDE_SMEM:
                continue
            while (s_stages < _WIDE_MAX_STAGES and _wide_bytes(
                    kernel, parts, slices, boxes, resident, s_stages + 1,
                    g_stages) <= _WIDE_SMEM):
                s_stages += 1
            return {
                "groups": groups, "boxes": boxes,
                "group_boxes": [min(boxes, slices - g * boxes)
                                for g in range(groups)],
                "resident": resident, "slice_stages": s_stages,
                "group_stages": g_stages,
                "smem_bytes": _wide_bytes(kernel, parts, slices, boxes,
                                          resident, s_stages, g_stages)}
    raise ValueError(f"no wide-kernel plan fits {slices} slices")


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
_FWDW = build.Kernel("flash_attn_wide", "flash_attn_fwd_wide_bf16",
                     _FWD.argtypes)
_BWDW = build.Kernel("flash_attn_wide", "flash_attn_bwd_wide_bf16",
                     _BWD.argtypes)
_FWD32 = build.Kernel(
    "flash_attn_fwd", "flash_attn_fwd_f32",
    (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 5
    + (ctypes.c_float, ctypes.c_int, ctypes.c_void_p))
_BWD32 = build.Kernel(
    "flash_attn_bwd", "flash_attn_bwd_f32",
    (ctypes.c_void_p,) * 12 + (ctypes.c_int,) * 5
    + (ctypes.c_float, ctypes.c_int, ctypes.c_void_p))
_FWDW32 = build.Kernel("flash_attn_wide", "flash_attn_fwd_wide_f32",
                       _FWD32.argtypes)
_BWDW32 = build.Kernel("flash_attn_wide", "flash_attn_bwd_wide_f32",
                       _BWD32.argtypes)


def _f32_scratch(n: int, like: torch.Tensor) -> tuple:
    """What the f32 entry points' pre-pass writes for ``n`` operands
    shaped as ``like`` [B, H, T, D]: their fp16 hi and lo parts ([n, 2,
    B, H, T, D]), and the bits of each [batch, head] slice's largest |x|
    ([n, B * H] int32)."""
    b, h = like.shape[:2]
    return (torch.empty((n, 2) + tuple(like.shape), dtype=torch.float16,
                        device=like.device),
            torch.empty((n, b * h), dtype=torch.int32, device=like.device))


def _check_kernel_inputs(what: str, **tensors) -> None:
    """The checks every kernel wrapper makes on its [B, H, T, D] inputs
    before a launch: one dtype, bf16 or f32; a head dim of 1 or more (any
    width: the wide kernels take what one tile does not hold);
    contiguity, alignment and grid limits. Raises on what the kernels do
    not take."""
    dtype = next(iter(tensors.values())).dtype
    if dtype not in _MAX_D or any(x.dtype is not dtype
                                  for x in tensors.values()):
        got = {n: t.dtype for n, t in tensors.items()}
        raise TypeError(f"{what} kernel takes bfloat16 or float32, one "
                        f"dtype for all, got {got}")
    b, h, _, d = next(iter(tensors.values())).shape
    if d < 1:
        raise ValueError(f"{what} kernel takes head dims from 1, not {d}")
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
    (contiguous, bf16 or f32, any head dim: the fused kernel where
    :func:`one_tile` holds it, else the wide one; a D not a multiple of 8
    through a zero-padded copy); CPU tensors take
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
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr())
    f32 = q.dtype is torch.float32
    wide = not one_tile(d, q.dtype)
    if f32:
        # The fp16 parts of q, k and v and their slices' largest |x|,
        # which the pre-pass writes.
        parts, amax = _f32_scratch(3, q)
        kernel, args = _FWDW32 if wide else _FWD32, (
            *ptrs, parts.data_ptr(), amax.data_ptr(), b, h, t, w, int(causal))
    else:
        kernel, args = _FWDW if wide else _FWD, (
            *ptrs, b, h, t, w, int(causal), int(out_dtype == torch.float32))
    rc = kernel.launch(*args, scale_log2, device,
                       build.current_stream(device))
    if rc:
        raise kernel.error(rc)
    _launches[_instance("fwd", wide, causal, f32)] += 1
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
    (contiguous, all bf16 or all f32, any head dim: the fused kernels
    where :func:`one_tile` holds it, else the wide ones; a D not a
    multiple of 8 through zero-padded copies); CPU tensors take
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
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
           do.data_ptr(), lse.data_ptr(), delta.data_ptr())
    outs = (dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    f32 = q.dtype is torch.float32
    wide = not one_tile(d, q.dtype)
    if f32:
        # The fp16 parts of q, k, v and do and their slices' largest |x|,
        # which the pre-pass writes.
        parts, amax = _f32_scratch(4, q)
        kernel, args = _BWDW32 if wide else _BWD32, (
            *ins, parts.data_ptr(), amax.data_ptr(), *outs, b, h, t, w,
            int(causal))
    else:
        kernel, args = _BWDW if wide else _BWD, (
            *ins, *outs, b, h, t, w, int(causal),
            int(out_dtype == torch.float32))
    rc = kernel.launch(*args, 1.0 / math.sqrt(d), device,
                       build.current_stream(device))
    if rc:
        raise kernel.error(rc)
    _launches[_instance("bwd", wide, causal, f32)] += 1
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
