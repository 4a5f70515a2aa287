"""idle_share: the share of the traced window, in %, in which no kernel
ran on the device: 1 - (union of kernel intervals / host-clock window)."""
from portbench.trace import busy_s


def read(ctx: dict):
    if ctx["window_s"] <= 0 or not ctx["kernels"]:
        return None
    return (1.0 - busy_s(ctx) / ctx["window_s"]) * 100.0
