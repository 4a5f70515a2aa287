"""The share of their bound that the attention kernels of one direction
reach, in %: the least time of the launches made in the traced steps
(counted by the program's launch counters, their work from the cell's
shape by ``accounting``) over the device time of the kernels named."""
from portbench.trace import kernel_seconds


def roofline(ctx: dict, direction: str, kernels) -> float | None:
    acc, shape = ctx["accounting"], ctx["shape"]
    bound = 0.0
    for name, n in ctx["launch_counts"].items():
        if not n or not name.startswith(f"flash_attn_{direction}"):
            continue
        f32 = "_f32" in name
        ops, nbytes = acc.attention_launch(
            direction, shape["batch"], shape["heads"], shape["seq"],
            shape["head_dim"], causal=not name.endswith("_non_causal"),
            elem_bytes=4 if f32 else shape["elem_bytes"])
        # f32 operands: against the TF32 rate, half the bf16 one.
        peak = ctx["peak_flops"] / (2 if f32 else 1)
        bound += n * acc.bound_s(ops, nbytes, peak, ctx["peak_bytes"])
    spent = kernel_seconds(ctx, kernels)
    if bound <= 0 or spent <= 0:
        return None
    return bound / spent * 100.0
