"""attn_fwd_roofline: the forward attention kernels' share of their
bound (``_attention.roofline``): the fused and wide forward kernels,
and the f32 operands' pre-pass where it runs."""
from portbench.metrics._attention import roofline

KERNELS = ("flash_fwd_kernel", "wide_fwd_kernel", "slice_amax_kernel",
           "split_parts_kernel")


def read(ctx: dict):
    return roofline(ctx, "fwd", KERNELS)
