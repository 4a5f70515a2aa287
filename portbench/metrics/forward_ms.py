"""forward_ms: device ms per step of the events launched in the span
``lm.forward``: the embedding, the layers (attention kernels included),
``ln_f`` and the loss (``_spans``)."""
from portbench.metrics._spans import phase_ms


def read(ctx: dict):
    return phase_ms(ctx, "lm.forward")
