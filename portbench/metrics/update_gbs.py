"""update_gbs: the optimizer update's rate, GB/s: the bytes the fused
AdamW kernel has to move in a step, as the program counts them where it
launches it (``adamw.counts``: its updates, the bytes of each: every
parameter's gradient, its f32 master, mu and nu read and written, its
bf16 param), over the device time of ``lm.update`` (``update_ms``).
Nothing where the program has no such counter."""
from portbench.metrics import _spans

#: The fused kernel's name mark, so that ``elementwise_ms`` leaves it
#: out.
KERNELS = ("adamw_kernel",)


def read(ctx: dict):
    try:
        from kubernetes_tpu_torch.workloads import adamw
        counts = adamw.counts()
    except (ImportError, AttributeError):
        return None
    ms = _spans.phase_ms(ctx, "lm.update")
    if not ms or not counts.get("updates"):
        return None
    per_step = counts["bytes"] / counts["updates"] \
        * len(_spans.spans(ctx, "lm.update")) / ctx["steps"]
    return per_step / (ms * 1e-3) * 1e-9
