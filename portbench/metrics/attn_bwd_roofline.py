"""attn_bwd_roofline: the backward attention kernels' share of their
bound (``_attention.roofline``): delta, dK/dV and dQ, fused and wide."""
from portbench.metrics._attention import roofline

KERNELS = ("flash_bwd_delta_kernel", "flash_bwd_dkdv_kernel",
           "flash_bwd_dq_kernel", "wide_delta_kernel", "wide_dkdv_kernel",
           "wide_dq_kernel")


def read(ctx: dict):
    return roofline(ctx, "bwd", KERNELS)
