"""One rank's part of a run of a training cell: set-up, the window, the
traced window of a ``--trace 1`` run, and the comparison with the
reference.

1. Set-up builds the port's step and state from the seed (the entry),
   and drives it through the checked steps: the window's own call on
   the window's own feed, fresh rows each step. They warm every shape
   the window uses. The readings of the port (each step's loss, each
   leaf's gradient norm after the first step and its change after the
   last) are taken then, before the next step moves the state.
2. The window runs a fixed number of steps back to back, with no host
   sync between them, as ``lm.train`` runs without a reporter: as many
   as fit in ``--seconds`` at the last checked step's time, the same on
   every rank. It ends with a synchronize.
3. Once the window has closed and the peak memory is read, the port's
   state is freed and the plain reference runs the checked steps on the
   same inputs.
"""
from __future__ import annotations

import gc
import math
import time

import torch

from . import check, spec, trace
from .peaks import peaks_for

#: A traced window holds about this many seconds of steps, 2 at least.
TRACE_SECONDS = 3.0


def _agree(n: int, group, device) -> int:
    """The largest ``n`` over the ranks of ``group``."""
    if group is None:
        return n
    from torch import distributed as dist
    t = torch.tensor([n], dtype=torch.int64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return int(t.item())


def _barrier(group, device) -> None:
    if group is not None:
        from torch import distributed as dist
        dev = torch.device(device)
        dist.barrier(group=group, device_ids=[dev.index or 0]
                     if dev.type == "cuda" else None)


def device_name(device) -> str:
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def checked_steps(entry, checked: int, sync) -> tuple:
    """The first ``checked`` steps of ``entry``, each timed on the host
    clock to its synchronize; ``(readings, seconds of each step)``."""
    losses, took = [], []
    for i in range(checked):
        sync()
        t = time.perf_counter()
        losses.append(entry.step(i))
        sync()
        took.append(time.perf_counter() - t)
        if i == 0:
            grad = entry.grad_norms()
    ours = {"loss": [float(x) for x in losses], "grad": grad,
            "change": entry.change_norms()}
    return ours, took


def run_rank(cell: dict, seed: int, seconds: float, traced: bool, device,
             group=None) -> dict:
    """This rank's run of ``cell`` (``spec.load``) on ``device``; under
    ``group`` one rank of a data-parallel gang."""
    device = torch.device(device)
    sync = trace.sync_for(device)
    cuda = device.type == "cuda"
    wl, config, traffic = cell["workload"], cell["config"], cell["traffic"]
    entries = spec.module("entries", wl["entry"])
    accounting = spec.module("accounting", wl["accounting"])
    world = 1
    if group is not None:
        from torch import distributed as dist
        world = dist.get_world_size(group)
    checked = wl["check_steps"]

    marks = {"run_rank": time.time()}
    entry = entries.Entry(config, traffic, seed, device, group)
    marks["entry"] = time.time()
    ours, took = checked_steps(entry, checked, sync)
    marks["checked_steps"] = time.time()
    steps = max(1, round(seconds / took[-1]))
    if traced:
        steps = max(2, min(steps, math.ceil(TRACE_SECONDS / took[-1])))
    steps = _agree(steps, group, device)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    entry.zero_launches()
    _barrier(group, device)
    sync()
    marks["window"] = time.time()
    out = {"window_start_wall": marks["window"], "steps": steps,
           "step_s_checked": took, "marks": marks}
    if traced:
        tr = trace.traced_steps(entry, checked, steps, sync)
        window_losses = []
    else:
        t0 = time.perf_counter()
        window_losses, returns = [], []
        for i in range(steps):
            window_losses.append(entry.step(checked + i))
            returns.append(time.perf_counter())
        sync()
        tr = {"window_s": time.perf_counter() - t0}
        # When each step's call returned: a stall shows as a long gap.
        out["returns_s"] = [b - a for a, b in zip([t0] + returns, returns)]
    out["window_s"] = tr["window_s"]
    out["peak_bytes"] = torch.cuda.max_memory_allocated(device) if cuda else 0
    out["failed"] = sum(not math.isfinite(float(x)) for x in window_losses)
    out["launches"] = {**entry.launches(),
                       "least": entries.least_launches(config, steps)}
    out["tokens"] = entries.tokens_per_step(traffic, world) * steps
    name = device_name(device)
    out["device_kind"] = name
    if traced:
        peak_flops, peak_bytes, _ = peaks_for(name)
        ctx = {**tr, "launch_counts": entry.launch_counts(),
               "shape": entries.shape(config, traffic, world),
               "flops_per_step": entries.flops_per_step(
                   accounting, config, traffic, world),
               "peak_flops": peak_flops, "peak_bytes": peak_bytes,
               "accounting": accounting}
        out["per_layer"] = {}
        for m in cell["per_layer"]:
            value = spec.module("metrics", m["name"]).read(ctx)
            if value is not None:
                out["per_layer"][m["name"]] = value
        out["busy_s"] = trace.busy_s(ctx)
        out["breakdown"] = trace.breakdown(ctx)
        del ctx, tr
    entry.free()
    del entry, window_losses
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ref = entries.reference_readings(config, traffic, seed, checked, device,
                                     group)
    out["reference_s"] = time.perf_counter() - t
    out["numbers"] = check.numbers(ours, ref)
    out["ours"], out["reference"] = ours, ref
    return out
