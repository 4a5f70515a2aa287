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

_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
         ctypes.c_int, ctypes.c_void_p)
#: The kernel for each dtype it takes, resolved at its first launch.
KERNELS = {torch.float32: build.Kernel("vector_add", "vector_add_f32", _ARGS),
           torch.bfloat16: build.Kernel("vector_add", "vector_add_bf16", _ARGS)}


def vector_add_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return x + y


def vector_add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x + y`` for two tensors of one shape, dtype and device.

    Two CUDA tensors the kernel takes (float32 or bfloat16, contiguous)
    launch it; the test for that case comes first and reads each
    attribute once. Anything else goes to :func:`_plain_or_raise`."""
    dtype, device = x.dtype, x.get_device()
    kernel = KERNELS.get(dtype)
    if not (kernel is not None and x.is_cuda and y.is_cuda
            and y.dtype is dtype and y.get_device() == device
            and x.shape == y.shape and x.is_contiguous()
            and y.is_contiguous()):
        return _plain_or_raise(x, y)
    out = torch.empty_like(x)
    n = x.numel()
    if n:
        rc = kernel.launch(x.data_ptr(), y.data_ptr(), out.data_ptr(), n,
                           device, build.current_stream(device))
        if rc:
            raise kernel.error(rc)
        global launches
        launches += 1
    return out


def _plain_or_raise(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """What :func:`vector_add` does with inputs its kernel does not take:
    the plain sum of CPU tensors, else an error that names the reason."""
    if x.shape != y.shape or x.dtype != y.dtype or x.device != y.device:
        raise ValueError(
            f"vector_add needs matching tensors, got {tuple(x.shape)} "
            f"{x.dtype} {x.device} and {tuple(y.shape)} {y.dtype} {y.device}")
    if x.device.type == "cpu":
        return vector_add_plain(x, y)
    if x.device.type != "cuda":
        raise ValueError(f"vector_add runs on cuda or cpu, not {x.device}")
    if x.dtype not in KERNELS:
        raise TypeError(f"vector_add kernel takes float32 or bfloat16, "
                        f"not {x.dtype}")
    # Matching CUDA tensors of a dtype the kernel takes: what is left is
    # a tensor that is not contiguous.
    raise ValueError("vector_add kernel takes contiguous tensors")


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
