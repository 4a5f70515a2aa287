"""Which span of the program each traced device event belongs to: the
rule of the readers of the port's spans (``kubernetes_tpu_torch/
tracing.py``).

The spans are host events of the traced window, in ``ctx["host"]``
beside the aten ops and the CUDA runtime's calls, ``(name, start_us,
end_us)``. A device event belongs to the span in which the host
*launched* it, not to the one the host is in while it runs: the host
runs ahead of the card by up to a full launch queue.

Each device event's launch is found by order. A stream runs its work in
the order of its launch calls, and every kernel, copy and fill of the
window comes from one launch call of its kind in ``ctx["host"]``
(:data:`CALLS`): the n-th kernel to start is the n-th kernel launch, and
so on for copies and fills. Where kernels of two streams overlap,
neighbours could swap; work that waits on the other stream, as the
exchange's copies wait on NCCL's kernels, keeps its place. Where the
counts of a kind differ, the pairing fails and the readers report
nothing.

- The phases ``lm.forward``, ``lm.backward``, ``lm.grad_sync`` and
  ``lm.update`` run one after another on the host: each holds every
  device event launched inside its interval (autograd's thread launches
  the backward's while the caller waits in it).
- ``lm.layer`` and ``attention.*`` nest inside them; each holds the
  device events launched inside its interval. A layer's span inside
  ``lm.backward`` is remat's recompute.
"""
from __future__ import annotations

import bisect

#: Host calls that put one device event on a stream, by the event's kind.
CALLS = {"kernel": ("cudaLaunchKernel", "cudaLaunchKernelExC",
                    "cuLaunchKernel", "cuLaunchKernelEx",
                    "cudaLaunchCooperativeKernel"),
         "Memcpy": ("cudaMemcpyAsync", "cudaMemcpy", "cuMemcpyAsync",
                    "cuMemcpy"),
         "Memset": ("cudaMemsetAsync", "cudaMemset", "cuMemsetAsync",
                    "cuMemsetD8Async", "cuMemsetD32Async")}
_KIND_OF_CALL = {call: kind for kind, calls in CALLS.items()
                 for call in calls}


def _kind(device_name: str) -> str:
    """A device event's kind: its copies and fills are named so."""
    head = device_name[:6]
    return head if head in ("Memcpy", "Memset") else "kernel"


def spans(ctx: dict, name: str) -> list:
    """The ``(start, end)`` of each host span ``name``, in time order."""
    return sorted((s, e) for n, s, e in ctx["host"] if n == name)


def launched(ctx: dict) -> list | None:
    """Each device event of the window with its launch's host time,
    ``(launch_us, start_us, end_us)``; None where the launch calls and
    the device events of a kind do not pair off."""
    calls = {kind: [] for kind in CALLS}
    for n, s, _ in ctx["host"]:
        kind = _KIND_OF_CALL.get(n)
        if kind is not None:
            calls[kind].append(s)
    events = {kind: [] for kind in CALLS}
    for n, s, e in ctx["kernels"]:
        events[_kind(n)].append((s, e))
    out = []
    for kind in CALLS:
        if len(calls[kind]) != len(events[kind]):
            return None
        out += [(t, s, e) for t, (s, e) in zip(sorted(calls[kind]),
                                               sorted(events[kind]))]
    return out


def _last_from(intervals: list, t: float):
    """The last of the sorted ``intervals`` that starts at ``t`` or
    before, or None."""
    i = bisect.bisect_right(intervals, (t, float("inf"))) - 1
    return intervals[i] if i >= 0 else None


def inside(intervals: list, t: float) -> bool:
    """Whether ``t`` lies in one of the disjoint, sorted ``intervals``."""
    last = _last_from(intervals, t)
    return last is not None and t < last[1]


def nested(inner: list, outer: list) -> list:
    """The intervals of ``inner`` that lie inside one of the disjoint,
    sorted ``outer``."""
    return [(s, e) for s, e in inner
            if (last := _last_from(outer, s)) is not None and e <= last[1]]


def device_ms(ctx: dict, intervals: list) -> float | None:
    """Device ms per step of the events launched inside ``intervals``
    (disjoint); None without a span, a pairing or such an event."""
    if not intervals:
        return None
    events = launched(ctx)
    if events is None:
        return None
    us = sum(e - s for t, s, e in events if inside(intervals, t))
    return us * 1e-3 / ctx["steps"] if us > 0 else None


def phase_ms(ctx: dict, name: str) -> float | None:
    """Device ms per step of the events launched in the phase ``name``."""
    return device_ms(ctx, spans(ctx, name))
