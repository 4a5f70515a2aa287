"""grad_sync_gbs: the gradient exchange's rate, GB/s: the bytes of the
all-reduces of a step's loss and gradients, as the program counts them
where it issues them (``collectives.counts``: its exchanges, the bytes
of their calls), over the device time of ``lm.grad_sync``
(``grad_sync_ms``)."""
from portbench.metrics import _spans


def read(ctx: dict):
    try:
        from kubernetes_tpu_torch.workloads import collectives
        counts = collectives.counts()
    except (ImportError, AttributeError):
        return None
    ms = _spans.phase_ms(ctx, "lm.grad_sync")
    if not ms or not counts.get("exchanges"):
        return None
    per_step = counts["bytes"] / counts["exchanges"] \
        * len(_spans.spans(ctx, "lm.grad_sync")) / ctx["steps"]
    return per_step / (ms * 1e-3) * 1e-9
