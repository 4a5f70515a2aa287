"""The traced window of a ``--trace 1`` run: a few steady steps under
``torch.profiler`` (CUPTI kernel intervals on the card, host operations
beside them), reduced to what the per-layer readers read.

The reduction follows ``kubernetes_tpu_torch/perf/profile_forward.py``
(copied 2026-10-18): kernels are the trace's events on the CUDA device,
the card is busy over the union of their intervals, and a kernel belongs
to a group by marks in its name. Each per-layer metric keeps its own
marks (``metrics/<name>.py``, ``KERNELS``).
"""
from __future__ import annotations

import time

import torch

#: Entries kept in each list of the breakdown.
TOP = 10


def union_s(intervals) -> float:
    """Length of the union of [start, end) intervals, in their unit."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def _busy_spans(intervals) -> list:
    spans = []
    for s, e in sorted(intervals):
        if spans and s <= spans[-1][1]:
            spans[-1][1] = max(spans[-1][1], e)
        else:
            spans.append([s, e])
    return spans


def matches(name: str, marks) -> bool:
    return any(m in name for m in marks)


def kernel_seconds(ctx: dict, marks) -> float:
    """Device seconds of the traced kernels whose names hold a mark."""
    return sum(e - s for n, s, e in ctx["kernels"] if matches(n, marks)) \
        * 1e-6


def traced_steps(entry, first: int, steps: int, sync) -> dict:
    """Steps ``first`` .. ``first + steps - 1`` of ``entry`` under the
    profiler: the kernels and host operations as ``(name, start_us,
    end_us)``, each step's span from its call to its return in the
    profiler's clock, and the window's host-clock length, from the first
    call to the synchronize after the last step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sync()
        t0 = time.perf_counter()
        for i in range(steps):
            with record_function("portbench.step"):
                entry.step(first + i)
        sync()
        window = time.perf_counter() - t0
    kernels, host, spans = [], [], []
    for e in prof.events():
        row = (e.name, e.time_range.start, e.time_range.end)
        if getattr(e, "is_user_annotation", False) \
                or e.name == "portbench.step":
            # A record_function range, on the host and mirrored on the
            # device: no operation of either.
            if e.device_type == DeviceType.CPU and e.name == "portbench.step":
                spans.append(row[1:])
        elif e.device_type == DeviceType.CUDA:
            kernels.append(row)
        elif e.device_type == DeviceType.CPU:
            host.append(row)
    return {"kernels": kernels, "host": host, "step_spans": spans,
            "window_s": window, "steps": steps}


def busy_s(ctx: dict) -> float:
    return union_s((s, e) for _, s, e in ctx["kernels"]) * 1e-6


def _host_at(host: list, t: float) -> str:
    """The innermost host operation (not a CUDA runtime call) running at
    ``t``, or "none"."""
    best = None
    for n, s, e in host:
        if s <= t < e and not n.startswith("cuda") and (
                best is None or e - s < best[2] - best[1]):
            best = (n, s, e)
    return best[0] if best else "none"


def breakdown(ctx: dict) -> dict:
    """The heaviest device operations, and the longest idle gaps between
    busy spans, each named by what the host was doing as it began."""
    by_name: dict = {}
    for n, s, e in ctx["kernels"]:
        by_name[n] = by_name.get(n, 0.0) + (e - s) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    spans = _busy_spans((s, e) for _, s, e in ctx["kernels"])
    gaps = sorted(((b[0] - a[1], a[1]) for a, b in zip(spans, spans[1:])),
                  reverse=True)[:TOP]
    return {"device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": [[_host_at(ctx["host"], t), g * 1e-6]
                          for g, t in gaps]}


def sync_for(device) -> callable:
    device = torch.device(device)
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None
