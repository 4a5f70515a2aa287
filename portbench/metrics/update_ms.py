"""update_ms: device ms per step of the events launched in the span
``lm.update``: the gradients' f32 cast, AdamW against the f32 master and
the cast back to the bf16 params (``_spans``)."""
from portbench.metrics._spans import phase_ms


def read(ctx: dict):
    return phase_ms(ctx, "lm.update")
