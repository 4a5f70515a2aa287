"""matmul_ms: device ms per step of the GEMM kernels (cuBLAS, CUTLASS):
the projections, SwiGLU and the unembedding with their gradients."""
from portbench.trace import kernel_seconds

KERNELS = ("gemm", "Gemm", "xmma", "cutlass", "nvjet")


def read(ctx: dict):
    s = kernel_seconds(ctx, KERNELS)
    return s / ctx["steps"] * 1e3 if s > 0 else None
