"""backward_ms: device ms per step of the events launched in the span
``lm.backward`` (``torch.autograd.grad``), remat's recompute of each
layer included (``_spans``)."""
from portbench.metrics._spans import phase_ms


def read(ctx: dict):
    return phase_ms(ctx, "lm.backward")
