"""mfu: the whole train step's share of the card's dense bf16 peak, in
%: the model FLOPs of the traced steps (``accounting``, remat's
recomputation not counted) over their host-clock window and the peak."""


def read(ctx: dict):
    if ctx["window_s"] <= 0 or not ctx["kernels"]:
        return None
    return ctx["flops_per_step"] * ctx["steps"] / ctx["window_s"] \
        / ctx["peak_flops"] * 100.0
