"""cuda-vector-add: the e2e smoke payload.

Counterpart of ``kubernetes_tpu/workloads/vector_add.py``: a minimal
kernel that proves the pod really has a live accelerator. On a CUDA
tensor :func:`vector_add` launches the hand-written kernel of
``csrc/vector_add.cu``; on a CPU tensor it computes the plain ``x + y``.
"""
from __future__ import annotations

import ctypes

import torch

from ..device import resolve_device
from ..kernels import build

#: Kernel launches so far; the wrapper adds one per launch and nowhere
#: else, so a run can show that it went through the kernel.
launches = 0

_SYMBOLS = {torch.float32: "vector_add_f32", torch.bfloat16: "vector_add_bf16"}
_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
         ctypes.c_void_p)


def vector_add_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return x + y


def vector_add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x + y`` for two tensors of one shape, dtype and device."""
    if x.shape != y.shape or x.dtype != y.dtype or x.device != y.device:
        raise ValueError(
            f"vector_add needs matching tensors, got {tuple(x.shape)} "
            f"{x.dtype} {x.device} and {tuple(y.shape)} {y.dtype} {y.device}")
    if x.device.type == "cpu":
        return vector_add_plain(x, y)
    if x.device.type != "cuda":
        raise ValueError(f"vector_add runs on cuda or cpu, not {x.device}")
    if x.dtype not in _SYMBOLS:
        raise TypeError(f"vector_add kernel takes float32 or bfloat16, "
                        f"not {x.dtype}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("vector_add kernel takes contiguous tensors")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = build.load("vector_add", {s: _ARGS for s in _SYMBOLS.values()})
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = getattr(lib, _SYMBOLS[x.dtype])(
        x.data_ptr(), y.data_ptr(), out.data_ptr(), x.numel(), stream)
    build.check(lib, rc, "vector_add")
    global launches
    launches += 1
    return out


def smoke_test(n: int = 1 << 16, device=None) -> dict:
    """Returns the payload's report; raises if the device lied."""
    dev = resolve_device(device)
    x = torch.arange(n, dtype=torch.float32, device=dev)
    y = torch.full((n,), 2.0, dtype=torch.float32, device=dev)
    out = vector_add(x, y)
    if not torch.equal(out, x + 2.0):
        raise AssertionError("vector_add mismatch")
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev)
    return {"ok": True, "n": n, "platform": dev.type, "device": name}


if __name__ == "__main__":
    import json
    print(json.dumps(smoke_test()))
