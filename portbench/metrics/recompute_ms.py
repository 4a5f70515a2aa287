"""recompute_ms: device ms per step of the events launched in the spans
``lm.layer`` that lie inside ``lm.backward``: remat's recompute of each
layer's forward, attention kernels included (``_spans``)."""
from portbench.metrics._spans import device_ms, nested, spans


def read(ctx: dict):
    return device_ms(ctx, nested(spans(ctx, "lm.layer"),
                                 spans(ctx, "lm.backward")))
