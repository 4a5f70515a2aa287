"""expert_ms: device ms per step of the events launched in the spans
``moe.experts`` and ``moe.experts.bwd``: the routed experts' grouped
GEMMs (three forward, again in remat's recompute, six backward) and
SwiGLU between them (``_spans``). Nothing where the program opens no
such span."""
from portbench.metrics._spans import device_ms, spans


def read(ctx: dict):
    return device_ms(ctx, sorted(spans(ctx, "moe.experts")
                                 + spans(ctx, "moe.experts.bwd")))
