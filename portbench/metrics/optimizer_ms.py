"""optimizer_ms: device ms per step of the multi-tensor kernels of
``torch._foreach_*``, which carry AdamW's update of the f32 master."""
from portbench.trace import kernel_seconds

KERNELS = ("multi_tensor_apply",)


def read(ctx: dict):
    s = kernel_seconds(ctx, KERNELS)
    return s / ctx["steps"] * 1e3 if s > 0 else None
