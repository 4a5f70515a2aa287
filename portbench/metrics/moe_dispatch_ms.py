"""moe_dispatch_ms: device ms per step of the events launched in the
MoE layers' routing and data movement: the spans ``moe.route`` (the f32
router, top-k, the sort by expert, the loads and offsets),
``moe.dispatch`` and ``moe.combine`` (the gather into expert order and
the weighted scatter-add back) and their backwards ``moe.dispatch.bwd``
and ``moe.combine.bwd``, in the forward and remat's recompute
(``_spans``). Nothing where the program opens no such span."""
from portbench.metrics._spans import device_ms, spans

SPANS = ("moe.route", "moe.dispatch", "moe.combine", "moe.dispatch.bwd",
         "moe.combine.bwd")


def read(ctx: dict):
    return device_ms(ctx, sorted(s for name in SPANS
                                 for s in spans(ctx, name)))
