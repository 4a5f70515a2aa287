"""grad_sync_ms: device ms per step of the events launched in the span
``lm.grad_sync``: the all-reduces of the loss and gradients over the
trainer's group (waits for the other ranks included) and the copies
around them, into one flat buffer, the division and back (``_spans``)."""
from portbench.metrics._spans import phase_ms


def read(ctx: dict):
    return phase_ms(ctx, "lm.grad_sync")
