"""attention_ms: device ms per step of the events launched in the spans
``attention.fwd`` and ``attention.bwd``, in the forward, the recompute
and the backward: the flash kernels, the f32 operands' pre-pass, and
the pads, slices and copies around them (``_spans``)."""
from portbench.metrics._spans import device_ms, spans


def read(ctx: dict):
    return device_ms(ctx, sorted(spans(ctx, "attention.fwd")
                                 + spans(ctx, "attention.bwd")))
