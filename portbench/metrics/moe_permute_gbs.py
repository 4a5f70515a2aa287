"""moe_permute_gbs: the MoE layers' permutation rate, GB/s: the bytes
that the gather kernels between tokens and expert rows have to move in a
step, as the program counts them where it launches them
(``moe.counts``: ``permute_launches``, ``permute_bytes``), over the
device time of the spans that hold only those kernels: ``moe.dispatch``,
``moe.dispatch.bwd``, ``moe.combine`` and ``moe.combine.bwd``, one
launch a span. A step launches the same mix every time, so bytes a
launch times the spans of the window over its steps is a step's bytes.
Nothing where the program has no such counter."""
from portbench.metrics._spans import device_ms, spans

SPANS = ("moe.dispatch", "moe.dispatch.bwd", "moe.combine",
         "moe.combine.bwd")

#: The two kernels' name marks, so that ``elementwise_ms`` leaves them
#: out.
KERNELS = ("moe_gather_reduce", "moe_scatter_rows")


def read(ctx: dict):
    try:
        from kubernetes_tpu_torch.workloads import moe
        counts = moe.counts()
    except (ImportError, AttributeError):
        return None
    if not counts.get("permute_launches"):
        return None
    intervals = sorted(s for name in SPANS for s in spans(ctx, name))
    ms = device_ms(ctx, intervals)
    if not ms:
        return None
    per_step = counts["permute_bytes"] / counts["permute_launches"] \
        * len(intervals) / ctx["steps"]
    return per_step / (ms * 1e-3) * 1e-9
