"""allreduce_ms: device ms per step of NCCL's kernels on this rank: the
all-reduce of the loss and gradients over the trainer's group, waits for
the other ranks included."""
from portbench.trace import kernel_seconds

KERNELS = ("nccl",)


def read(ctx: dict):
    s = kernel_seconds(ctx, KERNELS)
    return s / ctx["steps"] * 1e3 if s > 0 else None
