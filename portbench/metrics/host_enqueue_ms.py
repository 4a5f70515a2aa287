"""host_enqueue_ms: the host's own time to enqueue one step, by the
host clock, mean over the traced steps: each step's span from its call
to its return, less the time its kernel launches spent blocked.

A step dispatched back to back with the next returns as soon as its
work is queued; once the card's launch queue is full, each launch
waits for a slot, and the call's length becomes the card's step time.
So from each CUDA launch call in a step the time beyond the median
launch call's is taken off (calls that wait for the card on purpose,
such as a synchronize or a copy to the host, are kept). Where this nears
the step's time, the host sets the pace."""
import statistics


def read(ctx: dict):
    spans = ctx.get("step_spans") or []
    if not spans:
        return None
    launches = [(s, e) for n, s, e in ctx["host"]
                if n.startswith("cu") and "Launch" in n]
    typical = statistics.median(e - s for s, e in launches) if launches \
        else 0.0
    total = 0.0
    for a, b in spans:
        waited = sum(max(0.0, e - s - typical) for s, e in launches
                     if a <= s and e <= b)
        total += (b - a) - waited
    return total / len(spans) * 1e-3
