"""AdamW's update of a list of leaves: the hand-written kernel of
``csrc/adamw.cu`` for CUDA tensors, the plain ``torch._foreach_*`` chain
for CPU tensors.

:func:`adamw_` is the one entry: it updates ``params``, ``mu`` and ``nu``
(f32) in place from ``grads`` by the rule of ``lm.AdamW`` and, given
``out``, writes each param rounded to ``out``'s dtype there. On CUDA it
takes two dtype patterns, the kernel's two instances, and raises on
anything else:

- bf16 gradients, f32 params (the master), bf16 ``out``: mixed
  precision, the gradients read as they are and never cast;
- f32 gradients, f32 params, no ``out``: the param its own master.

Every tensor on one CUDA device and contiguous; nothing falls back.
Leaves that are all on the CPU take :func:`adamw_plain`, the arithmetic
the kernel repeats, in the same order.

:func:`counts` tells what went through the kernel: ``updates`` (calls),
``launches``, ``leaves``, ``elements`` and ``bytes``, the bytes the
update has to move (each element's gradient, 24 bytes of f32 param, mu
and nu read and written, and its ``out``), counted where the wrapper
launches. The plain path counts nothing.
"""
from __future__ import annotations

import ctypes

import torch

from ..kernels import build

#: Bytes of f32 param, mu and nu each element reads and writes.
STATE_BYTES = 24

_ARGS = (ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
         *(ctypes.c_float,) * 9, ctypes.c_int, ctypes.c_void_p,
         ctypes.POINTER(ctypes.c_int))
#: The kernel for each gradient dtype, resolved at its first launch; the
#: bf16 instance writes ``out``, the f32 one takes none.
KERNELS = {torch.bfloat16: build.Kernel("adamw", "adamw_bf16", _ARGS),
           torch.float32: build.Kernel("adamw", "adamw_f32", _ARGS)}

_counts = {"updates": 0, "launches": 0, "leaves": 0, "elements": 0,
           "bytes": 0}


def counts() -> dict:
    """The kernel's updates, launches, leaves, elements and bytes so
    far."""
    return dict(_counts)


def zero_counts() -> None:
    """Every count to 0."""
    for name in _counts:
        _counts[name] = 0


@torch.no_grad()
def adamw_plain(params: list, grads: list, mu: list, nu: list, *,
                lr: float, b1: float, b2: float, eps: float,
                weight_decay: float, t: int, out: list | None = None) -> None:
    """The update as ``torch._foreach_*`` passes: with ``out``, the
    gradients cast to f32 first and each param copied into ``out``
    after."""
    if out is not None:
        grads = [g.float() for g in grads]
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, grads, alpha=1 - b1)
    torch._foreach_mul_(nu, b2)
    torch._foreach_addcmul_(nu, grads, grads, value=1 - b2)
    denom = torch._foreach_div(nu, 1 - b2 ** t)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    upd = torch._foreach_div(mu, 1 - b1 ** t)
    torch._foreach_div_(upd, denom)
    del denom
    torch._foreach_add_(upd, params, alpha=weight_decay)
    torch._foreach_add_(params, upd, alpha=-lr)
    del upd
    if out is not None:
        for o, p in zip(out, params):
            o.copy_(p)


def adamw_(params: list, grads: list, mu: list, nu: list, *, lr: float,
           b1: float, b2: float, eps: float, weight_decay: float, t: int,
           out: list | None = None) -> None:
    """One AdamW step (the ``t``-th) of ``params`` with ``grads``, moments
    ``mu`` and ``nu``; ``out`` as the module says. Lists of equal length,
    leaf by leaf of one shape."""
    n = len(params)
    if not (len(grads) == len(mu) == len(nu) == n
            and (out is None or len(out) == n)):
        raise ValueError("adamw_ needs lists of one length")
    if n == 0:
        return
    device = params[0].device
    for group in (params, grads, mu, nu, out or ()):
        for x in group:
            if x.device != device:
                raise ValueError(f"adamw_ takes leaves on one device: "
                                 f"{x.device} beside {device}")
    if device.type == "cpu":
        adamw_plain(params, grads, mu, nu, lr=lr, b1=b1, b2=b2, eps=eps,
                    weight_decay=weight_decay, t=t, out=out)
        return
    if device.type != "cuda":
        raise ValueError(f"adamw_ runs on cuda or cpu, not {device}")
    gdtype = grads[0].dtype
    kernel = KERNELS.get(gdtype)
    if kernel is None or (out is None) != (gdtype is torch.float32):
        given = "no out" if out is None else f"an out of {out[0].dtype}"
        raise TypeError(f"adamw_ kernel takes bf16 gradients with a bf16 "
                        f"out, or f32 gradients without one; got {gdtype} "
                        f"gradients and {given}")
    rows = []
    elements = 0
    for i in range(n):
        p, g, m, v = params[i], grads[i], mu[i], nu[i]
        o = None if out is None else out[i]
        leaf = (g, p, m, v) if o is None else (g, p, m, v, o)
        if not all(x.is_contiguous() for x in leaf):
            raise ValueError("adamw_ kernel takes contiguous leaves")
        if not (g.dtype is gdtype and p.dtype is m.dtype is v.dtype
                is torch.float32 and (o is None or o.dtype is gdtype)):
            raise TypeError(
                f"adamw_ leaf {i}: gradient {g.dtype}, param {p.dtype}, mu "
                f"{m.dtype}, nu {v.dtype}"
                + ("" if o is None else f", out {o.dtype}")
                + f"; the kernel takes {gdtype} gradients and f32 state")
        shape = p.shape
        if not (g.shape == m.shape == v.shape == shape
                and (o is None or o.shape == shape)):
            raise ValueError(f"adamw_ leaf {i}: shapes differ")
        size = p.numel()
        if size:
            rows.append((g.data_ptr(), p.data_ptr(), m.data_ptr(),
                         v.data_ptr(), 0 if o is None else o.data_ptr(),
                         size))
            elements += size
    # 1 - b1, 1 - b2 and the reciprocals of the bias corrections in
    # double, as PyTorch's foreach kernels take them on the card.
    scalars = (lr, b1, b2, eps, weight_decay, 1 - b1, 1 - b2,
               1 / (1 - b1 ** t), 1 / (1 - b2 ** t))
    table = (ctypes.c_int64 * (6 * len(rows)))(
        *(x for row in rows for x in row))
    launches = ctypes.c_int(0)
    rc = kernel.launch(table, len(rows), *scalars, device.index,
                       build.current_stream(device.index),
                       ctypes.byref(launches))
    if rc:
        raise kernel.error(rc)
    out_bytes = 0 if out is None else out[0].element_size()
    _counts["updates"] += 1
    _counts["launches"] += launches.value
    _counts["leaves"] += len(rows)
    _counts["elements"] += elements
    _counts["bytes"] += elements * (grads[0].element_size() + STATE_BYTES
                                    + out_bytes)

