#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check what it computes.

    python3 chip_smoke.py

Run from the root of the repository on a machine with a CUDA card and
nvcc. Phases, in order; any failure exits non-zero and nothing falls
back:

1. device: the card as ``nvidia-smi`` reports it (name, power limit);
2. build: every kernel of ``kubernetes_tpu_torch/csrc`` with nvcc;
3. vector_add: the kernel against plain ``x + y``, bit for bit, in f32
   and bf16 at lengths around its 16-byte vectors and their ragged tail
   (1 to 2^26) and on views at odd offsets (``x[1:]`` with ``y[1:]``
   and with ``y[2:]``); then at n = 2^16 and 2^26 in both dtypes, timed
   beside ``torch.add``: device time by CUDA events, in turns, and
   ``host_us``, the host time per call over back-to-back calls read
   before the closing synchronize;
4. host_path: the host cost of each piece of a K1 launch at the payload
   size (the checks, the allocation, the stream, the ctypes call with
   and without a launch) beside ``torch.add``'s;
5. flash_attn: the flash-attention forward against plain attention at
   the listed shapes (ragged tails, the edges of the kernels' tiles and
   TMA boxes, many heads and a batch, the main path's shapes), and timed
   at the main shapes beside PyTorch's SDPA pinned to each backend that
   takes the inputs (flash, cuDNN, efficient) as a yardstick, with the
   wrapper's ``host_us``;
6. flash_attn_bwd: the flash-attention backward against the plain
   backward at the same shapes, gated against an f32 backward, and timed
   beside the backward of SDPA under each backend, with ``host_us``;
7. entry: the tiny entry-point forward on the card against the CPU;
8. main path (serving): the payload ``smoke_test`` and the 600M-config
   LM forward (d_model 2048, 8 layers, 16 heads of 128, d_ff 8192, vocab
   32768, bf16 params, random weights from a seed) at the t2k and t8k
   cases, with every launch counter set to 0 just before and read just
   after; then its logits against the plain-attention forward and an
   f32 forward, and its time, tokens/s and MFU;
9. train (training path): the 600M train step (forward, backward through
   both attention kernels under remat, AdamW against an f32 master) at
   t2k and t8k, every counter set to 0 just before one step and read
   just after; its time, tokens/s, MFU and peak memory, and the loss
   over 10 steps, which must fall;
10. train_grads: at full width but 2 layers (t2k), every gradient of the
   kernel path against an f32 plain-attention step, no further from it
   than the plain bf16 step's gradients are;
11. train_loop: ``lm.train`` on the card at the entry config with
   checkpoints every 2 steps, 4 steps then a resume to 6, the marker and
   the metrics report;
12. trainer (the TrainJob worker payload): ``trainer.main()`` in this
   process as a one-rank gang, ``MODEL=lm`` at the 600M width and depth
   (f32 params, as the reference trainer's), B4 T2048, 3 steps, every
   counter set to 0 just before and read just after (16 forward and 8
   backward attention launches a step); its loss against a direct
   ``lm.train`` call, its attempt record, and its step time, tokens/s,
   MFU (from the metrics report of its last step) and peak memory;
13. trainer_group: ``lm.train`` at full width, 2 layers, t2k, 6 steps,
   without a process group and under a world-1 NCCL group on a store of
   its own (the gradient all-reduce through NCCL on CUDA tensors): the
   same loss at every step, and the step times of both;
14. trainer_resume: two ``python -m kubernetes_tpu_torch.workloads.
   trainer`` processes at full width, 2 layers, on one checkpoint dir
   (4 steps saving every 2, then to 6): the attempt records, the marker
   and the ``TRAINER DONE`` lines; then the time of one save and one
   resume of that state in this process;
15. demo: ``python -m kubernetes_tpu_torch.workloads.distributed_demo``
   on the card, 6 steps, and its exact final value;
16. trainer_dp2: with two cards or more, two rank processes over NCCL,
   one card each, at full width, 2 layers, 6 steps: each step's loss the
   same on both ranks and within 5e-2 of the world-1 run's, and their
   step times; with one card, a line that says it was not run;
17. vector_add_device_us: ``device_us`` of K1 and of ``torch.add`` at
   the timed cases, from ``torch.profiler`` (CUPTI) kernel events; last,
   so that nothing is timed after the profiler ran;
18. a ``kernels`` line, then the card line, then the last line
   ``{"ok": true, "device": {...}}``.

Every subprocess is waited on with a timeout and killed at it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import torch
import torch.nn.functional as F

from torch import distributed as dist
from torch.autograd import DeviceType
from torch.nn.attention import SDPBackend, sdpa_kernel
from torch.profiler import ProfilerActivity, profile

from kubernetes_tpu_torch.kernels import build
from kubernetes_tpu_torch.perf import chip_bench
from kubernetes_tpu_torch.perf.launch_cost import host_us
from kubernetes_tpu_torch.entry import entry
from kubernetes_tpu_torch.preemption import read_marker
from kubernetes_tpu_torch.workloads import checkpoint as ckpt
from kubernetes_tpu_torch.workloads import flash_attention as fa
from kubernetes_tpu_torch.workloads import lm
from kubernetes_tpu_torch.workloads import metrics_reporter
from kubernetes_tpu_torch.workloads import rendezvous
from kubernetes_tpu_torch.workloads import trainer
from kubernetes_tpu_torch.workloads import vector_add as va
from kubernetes_tpu_torch.workloads.ring_attention import (
    reference_attention_with_lse)

#: Flash-attention shapes (B, H, T, D): ragged tails and every head dim;
#: T at the edges of the kernels' 64- and 128-row tiles and 64-row TMA
#: boxes at every head dim; many heads and a batch (the grid's y and z
#: axes); then the main path's shapes (the t2k and t8k cases at 16
#: heads), which are also timed.
MAIN_FLASH_SHAPES = [(4, 16, 2048, 128), (1, 16, 8192, 128)]
FLASH_SHAPES = ([(2, 4, 65, 32), (1, 2, 1000, 64)]
                + [(1, 2, t, d) for d in (32, 64, 128)
                   for t in (1, 127, 128, 129, 255, 257)]
                + [(8, 32, 129, 64)] + MAIN_FLASH_SHAPES)
#: SDPA backends timed as the attention kernels' yardstick, each pinned
#: with ``sdpa_kernel``; ``library_ms`` is the fastest that runs.
SDPA_BACKENDS = {"flash": SDPBackend.FLASH_ATTENTION,
                 "cudnn": SDPBackend.CUDNN_ATTENTION,
                 "efficient": SDPBackend.EFFICIENT_ATTENTION}
MAIN_CASES = ("lm-600m-t2k-flash", "lm-600m-t8k-flash")
#: o against the plain version: both round o to bf16 and the kernel also
#: rounds P to bf16 for the tensor cores, so allow two bf16 steps of |o|
#: (2^-6) plus an absolute 1e-2 for outputs near 0.
O_ATOL, O_RTOL = 1e-2, 2 ** -6
#: lse is f32 in both; only the order of the sums differs.
LSE_ATOL = 1e-3
#: f32 arithmetic outside the tensor cores, H100 SXM (the vector add).
F32_FLOPS = 67e12
#: K1 checked bit for bit at (n, x offset, y offset): lengths around one
#: 16-byte vector and its ragged tail, the payload's 2^16 and its
#: neighbours, 2^20 + 3, 2^26; then views at an odd offset, also at two
#: different offsets, which no vector fits. Each in f32 and bf16.
VA_EXACT = ([(n, 0, 0) for n in (1, 3, 4, 5, 1000, 65535, 65536, 65537,
                                 (1 << 20) + 3, 1 << 26)]
            + [(n, xo, yo) for n in (65537, (1 << 20) + 3)
               for xo, yo in ((1, 1), (1, 2))])
#: K1 timed beside torch.add: the payload's n and a size that streams
#: from device memory, in both dtypes; the main path's case first.
VA_TIMED = [(n, dtype) for n in (1 << 16, 1 << 26)
            for dtype in (torch.float32, torch.bfloat16)]
#: Back-to-back calls over which a host time per call is read; for the
#: attention kernels, few enough that their queued work never fills the
#: queue of launches and holds the host back.
HOST_CALLS = 10_000
ATTN_HOST_CALLS = 20
#: Train steps whose loss must fall, on one fixed batch (as the train
#: bench runs); the steps after the first TRAIN_WARM are timed.
TRAIN_STEPS = 10
TRAIN_WARM = 3
#: The trainer's model-size env at the main path's 600M width; the
#: trainer phases run it at full depth or at 2 layers, B4 T2048.
TRAINER_ENV = {"MODEL": "lm", "LM_VOCAB": "32768", "LM_D_MODEL": "2048",
               "LM_LAYERS": "8", "LM_HEADS": "16", "LM_D_FF": "8192",
               "BATCH": "4", "SEQ": "2048"}
#: Steps of the trainer phase.
TRAINER_STEPS = 3
#: Steps of each trainer_group run (five timed after the first) and of
#: the two-card run, which is held against it.
GROUP_STEPS = 6
#: Seconds any subprocess may take before it is killed and the run fails.
SUBPROCESS_TIMEOUT = 600


def say(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timed(kernel, plain, libraries: dict, iters: int,
          plain_iters: int = 3, rounds: int = 1) -> dict:
    """Device times of ``kernel`` and of each library call, in turns
    (kernel, libraries, libraries in reverse, kernel), ``rounds`` times,
    each reported as the mean of its runs; ``plain`` timed once after.
    Where the host sets the time, more and shorter rounds keep a drift of
    its clock out of the comparison."""
    k_runs, lib_runs = [], {n: [] for n in libraries}
    for _ in range(rounds):
        k_runs.append(time_ms(kernel, iters))
        for n, f in libraries.items():
            lib_runs[n].append(time_ms(f, iters))
        for n, f in reversed(libraries.items()):
            lib_runs[n].append(time_ms(f, iters))
        k_runs.append(time_ms(kernel, iters))
    lib = {n: sum(r) / len(r) for n, r in lib_runs.items()}
    best = min(lib, key=lib.get) if lib else None
    return {"ms": sum(k_runs) / len(k_runs), "ms_runs": k_runs,
            "plain_ms": time_ms(plain, plain_iters, 1),
            "library_ms": lib[best] if best else None,
            "library": best, "library_ms_by_name": lib,
            "library_runs": lib_runs}


def add_bound(row: dict, flops: float, nbytes: float, name: str,
              peak_ops: float | None = None) -> dict:
    """``bound_ms`` and ``bound_by`` of the work, and the row's
    ``share_of_bound`` (bound over its time) and ``ratio_to_library``
    (its time over the fastest library call's)."""
    row["bound_ms"], row["bound_by"] = bound_ms(flops, nbytes, name, peak_ops)
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    row["ratio_to_library"] = (row["ms"] / row["library_ms"]
                               if row["library_ms"] else None)
    return row


def sdpa_forwards(q, k, v) -> dict:
    """{backend: SDPA forward pinned to it} for each backend that takes
    these inputs."""
    fns = {}
    for name, backend in SDPA_BACKENDS.items():
        def fn(backend=backend):
            with sdpa_kernel(backend):
                return F.scaled_dot_product_attention(q, k, v, is_causal=True)
        try:
            fn()
        except RuntimeError:
            continue
        fns[name] = fn
    return fns


def sdpa_backwards(q, k, v, do) -> dict:
    """{backend: SDPA backward of a forward pinned to it} for each
    backend that takes these inputs."""
    fns = {}
    for name, backend in SDPA_BACKENDS.items():
        qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
        try:
            with sdpa_kernel(backend):
                out = F.scaled_dot_product_attention(qs, ks, vs,
                                                     is_causal=True)
            torch.autograd.grad(out, (qs, ks, vs), do, retain_graph=True)
        except RuntimeError:
            continue
        fns[name] = (lambda out=out, leaves=(qs, ks, vs): torch.autograd.grad(
            out, leaves, do, retain_graph=True))
    return fns


def bound_ms(flops: float, nbytes: float, name: str,
             peak_ops: float | None = None) -> tuple[float, str]:
    """Least time for the work on this card: the larger of operations
    over the peak rate for their type (bf16 tensor cores unless
    ``peak_ops`` is given) and bytes over the memory rate."""
    t_ops = flops / (peak_ops or chip_bench.peak_flops_for(name)[0])
    t_bytes = nbytes / chip_bench.peak_bytes_for(name)[0]
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def check_vector_add(gen, name: str) -> list[dict]:
    """K1 against plain ``x + y``, bit for bit, at VA_EXACT (lengths and
    offset views); then timed at each VA_TIMED case beside ``torch.add``:
    device time by CUDA events in turns, and host time per call
    (``host_us``) in turns. Returns the timed rows, the main path's
    (2^16 f32) first; ``device_us`` is added by :func:`profile_vector_add`
    at the end of the run."""
    exact = []
    for dtype in (torch.float32, torch.bfloat16):
        for n, x_off, y_off in VA_EXACT:
            x = torch.randn(n + x_off, generator=gen, device="cuda").to(dtype)
            y = torch.randn(n + y_off, generator=gen, device="cuda").to(dtype)
            x, y = x[x_off:], y[y_off:]
            before = va.launches
            out = va.vector_add(x, y)
            torch.cuda.synchronize()
            if va.launches != before + 1:
                raise AssertionError("vector_add did not count its launch")
            if not torch.equal(out, va.vector_add_plain(x, y)):
                raise AssertionError(f"vector_add mismatch at n={n} {dtype} "
                                     f"offsets {x_off}, {y_off}")
            exact.append([n, x_off, y_off, _dtype_name(dtype)])
    results = []
    for n, dtype in VA_TIMED:
        x = torch.randn(n, generator=gen, device="cuda").to(dtype)
        y = torch.randn(n, generator=gen, device="cuda").to(dtype)
        err = float((va.vector_add(x, y).float()
                     - va.vector_add_plain(x, y).float()).abs().max())
        if err != 0.0:
            raise AssertionError(f"vector_add mismatch at n={n} {dtype}")
        row = {"n": n, "dtype": _dtype_name(dtype), "max_abs_err": err}
        # At 2^16 the host sets both times (some 10 us a call against ~1
        # us of device work), so they are taken in many short turns. At
        # 2^26, few enough host calls that the queue of launches never
        # fills and holds the host back.
        small = n <= 1 << 16
        iters, rounds = (200, 10) if small else (50, 1)
        calls, host_rounds = (HOST_CALLS, 4) if small else (200, 1)
        kernel = lambda: va.vector_add(x, y)  # noqa: E731
        library = lambda: torch.add(x, y)  # noqa: E731
        row.update(timed(kernel, lambda: va.vector_add_plain(x, y),
                         {"torch.add": library}, iters, iters, rounds))
        add_bound(row, n, 3 * n * x.element_size(), name, F32_FLOPS)
        k_runs, l_runs = [], []
        for _ in range(host_rounds):
            k_runs.append(host_us(kernel, calls))
            l_runs += [host_us(library, calls), host_us(library, calls)]
            k_runs.append(host_us(kernel, calls))
        row.update(host_us=sum(k_runs) / len(k_runs), host_us_runs=k_runs,
                   library_host_us=sum(l_runs) / len(l_runs),
                   library_host_us_runs=l_runs, host_calls=calls)
        results.append(row)
        del x, y
    say("vector_add", ok=True, exact=exact, results=results)
    return results


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def device_us(fn, calls: int) -> tuple[float, int, list[str]]:
    """Device time per call of ``fn``, which launches one kernel a call:
    the mean duration of the kernel events that a ``torch.profiler``
    (CUPTI) trace of ``calls`` calls shows; also how many it shows and
    their names. CUPTI may miss an event at the edge of the window, so
    the trace must show one kernel name and between one and ``calls``
    events, not exactly ``calls``."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    names = sorted({e.name[:100] for e in kernels})
    if not 1 <= len(kernels) <= calls or len(names) != 1:
        raise AssertionError(f"{len(kernels)} kernel events of {names} "
                             f"for {calls} calls of one kernel")
    total = sum(e.time_range.elapsed_us() for e in kernels)
    return total / len(kernels), len(kernels), names


def profile_vector_add(rows: list[dict]) -> None:
    """``device_us`` of K1 and of ``torch.add`` at each timed row's case,
    from kernel events. Run last: the profiler is the only one in the
    run, so no other phase is timed after it."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    for row in rows:
        n, dtype = row["n"], getattr(torch, row["dtype"])
        x = torch.randn(n, generator=gen, device="cuda").to(dtype)
        y = torch.randn(n, generator=gen, device="cuda").to(dtype)
        calls = 200 if n <= 1 << 16 else 20
        for prefix, fn in (("", lambda: va.vector_add(x, y)),
                           ("library_", lambda: torch.add(x, y))):
            us, seen, names = device_us(fn, calls)
            row[f"{prefix}device_us"] = us
            row[f"{prefix}device_kernel"] = names[0]
            row[f"{prefix}device_events"] = seen
        del x, y
    say("vector_add_device_us", results=[
        {k: row[k] for k in ("n", "dtype", "device_us", "library_device_us",
                             "device_kernel", "library_device_kernel",
                             "device_events", "library_device_events")}
        for row in rows])


def check_host_path() -> None:
    """What a K1 launch costs the host at the payload size, piece by
    piece, by the host clock over HOST_CALLS calls of each piece, every
    piece twice (in order, then in reverse); ``lambda`` is the empty
    call that each number includes."""
    n = 1 << 16
    x, y = (torch.randn(n, device="cuda") for _ in range(2))
    out, x0, y0 = torch.empty_like(x), x[:0], y[:0]
    dev = x.get_device()
    kernel = va.KERNELS[torch.float32]
    stream = build.current_stream(dev)
    xp, yp, op = x.data_ptr(), y.data_ptr(), out.data_ptr()
    pieces = {
        "lambda": lambda: None,
        "torch.add": lambda: torch.add(x, y),
        "vector_add": lambda: va.vector_add(x, y),
        "vector_add_at_n0": lambda: va.vector_add(x0, y0),
        "empty_like": lambda: torch.empty_like(x),
        "data_ptr": lambda: x.data_ptr(),
        "raw_stream": lambda: build.current_stream(dev),
        "stream_object": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "ctypes_call_at_n0": lambda: kernel.launch(xp, yp, op, 0, dev,
                                                   stream),
        "ctypes_call_and_launch": lambda: kernel.launch(xp, yp, op, n, dev,
                                                        stream),
    }
    first = {k: host_us(f, HOST_CALLS) for k, f in pieces.items()}
    second = {k: host_us(f, HOST_CALLS) for k, f in reversed(pieces.items())}
    if not torch.equal(out, x + y):
        raise AssertionError("the bare launch wrote a wrong sum")
    say("host_path", n=n, calls=HOST_CALLS,
        us={k: (first[k] + second[k]) / 2 for k in pieces},
        us_runs={k: [first[k], second[k]] for k in pieces})


def check_flash(gen, name: str) -> list[dict]:
    results = {}
    for b, h, t, d in FLASH_SHAPES:
        q, k, v = (torch.randn((b, h, t, d), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        before = fa.launches
        o, lse = fa.flash_attention_fwd(q, k, v)
        torch.cuda.synchronize()
        if fa.launches != before + 1:
            raise AssertionError("flash_attn_fwd did not count its launch")
        o_ref, lse_ref = reference_attention_with_lse(q, k, v)
        err = (o.float() - o_ref.float()).abs()
        lse_err = float((lse - lse_ref).abs().max())
        bad = int((err > O_ATOL + O_RTOL * o_ref.float().abs()).sum())
        row = {"shape": [b, h, t, d], "max_abs_err": float(err.max()),
               "lse_max_abs_err": lse_err, "o_outside_tol": bad}
        if bad or not lse_err <= LSE_ATOL or not bool(torch.isfinite(o).all()):
            raise AssertionError(f"flash_attn_fwd disagrees: {row}")
        del o_ref, lse_ref, err
        if (b, h, t, d) in MAIN_FLASH_SHAPES:
            flops = 4.0 * b * h * d * t * (t + 1) / 2
            nbytes = 4 * b * h * t * d * 2 + b * h * t * 4
            row.update(timed(lambda: fa.flash_attention_fwd(q, k, v),
                             lambda: reference_attention_with_lse(q, k, v),
                             sdpa_forwards(q, k, v), 20))
            add_bound(row, flops, nbytes, name)
            row["host_us"] = host_us(lambda: fa.flash_attention_fwd(q, k, v),
                                     ATTN_HOST_CALLS)
            row["tflops"] = flops / (row["ms"] * 1e-3) / 1e12
            torch.cuda.empty_cache()
        results[(b, h, t, d)] = row
    say("flash_attn", ok=True, o_atol=O_ATOL, o_rtol=O_RTOL,
        lse_atol=LSE_ATOL, results=list(results.values()))
    return [results[shape] for shape in MAIN_FLASH_SHAPES]


def drift(got: torch.Tensor, plain: torch.Tensor,
          exact: torch.Tensor) -> dict:
    """How far ``got`` and the plain version ``plain`` are from the f32
    ``exact``; ``ok`` when ``got`` is within twice the plain version's
    largest and 1.5 times its mean deviation."""
    dev_got = (got.float() - exact).abs()
    dev_plain = (plain.float() - exact).abs()
    row = {"max_abs_vs_f32": float(dev_got.max()),
           "plain_max_abs_vs_f32": float(dev_plain.max()),
           "mean_abs_vs_f32": float(dev_got.mean()),
           "plain_mean_abs_vs_f32": float(dev_plain.mean())}
    row["ok"] = (row["max_abs_vs_f32"] <= 2 * row["plain_max_abs_vs_f32"]
                 and row["mean_abs_vs_f32"]
                 <= 1.5 * row["plain_mean_abs_vs_f32"])
    return row


def check_flash_bwd(gen, name: str) -> list[dict]:
    """The backward kernel against the plain backward on the same bf16
    inputs (o and lse from the forward kernel). Gate: each gradient's
    deviation from the f32 gradient (the plain backward of f32 attention
    at the unrounded f32 inputs) within 2x the largest and 1.5x the mean
    deviation of the plain bf16 backward's."""
    results = {}
    for b, h, t, d in FLASH_SHAPES:
        x32 = [torch.randn((b, h, t, d), generator=gen, device="cuda")
               for _ in range(4)]
        q, k, v, do = (x.to(torch.bfloat16) for x in x32)
        o, lse = fa.flash_attention_fwd(q, k, v)
        before = fa.bwd_launches
        got = fa.flash_attention_bwd(q, k, v, o, lse, do)
        torch.cuda.synchronize()
        if fa.bwd_launches != before + 1:
            raise AssertionError("flash_attn_bwd did not count its launch")
        plain = fa.flash_attention_bwd_plain(q, k, v, o, lse, do)
        o32, lse32 = reference_attention_with_lse(*x32[:3])
        exact = fa.flash_attention_bwd_plain(*x32[:3], o32, lse32, x32[3])
        del o32, lse32
        row = {"shape": [b, h, t, d], "max_abs_err": max(
            float((g.float() - p.float()).abs().max())
            for g, p in zip(got, plain))}
        for gname, g, p, e in zip(("dq", "dk", "dv"), got, plain, exact):
            row[gname] = drift(g, p, e)
            if gname in ("dq", "dk") and t == 1:
                # At T = 1 a softmax over one key has no score gradient:
                # dS, dq and dk are 0, and both deviations are f32
                # rounding of the cancelling dP - delta, whose ratio says
                # nothing. The kernel is held to O_ATOL of them, the
                # bound the card tests keep against the plain version.
                row[gname]["ok"] = row[gname]["max_abs_vs_f32"] <= O_ATOL
            if not (row[gname]["ok"] and bool(torch.isfinite(g).all())):
                raise AssertionError(f"flash_attn_bwd {gname} drifts: {row}")
        del plain, exact, x32
        if (b, h, t, d) in MAIN_FLASH_SHAPES:
            flops = 10.0 * b * h * d * t * (t + 1) / 2
            nbytes = 8 * b * h * t * d * 2 + b * h * t * 4
            row.update(timed(
                lambda: fa.flash_attention_bwd(q, k, v, o, lse, do),
                lambda: fa.flash_attention_bwd_plain(q, k, v, o, lse, do),
                sdpa_backwards(q, k, v, do), 20))
            add_bound(row, flops, nbytes, name)
            row["host_us"] = host_us(
                lambda: fa.flash_attention_bwd(q, k, v, o, lse, do),
                ATTN_HOST_CALLS)
            row["tflops"] = flops / (row["ms"] * 1e-3) / 1e12
        del got, q, k, v, do, o, lse
        torch.cuda.empty_cache()
        results[(b, h, t, d)] = row
    say("flash_attn_bwd", ok=True, results=list(results.values()))
    return [results[shape] for shape in MAIN_FLASH_SHAPES]


def check_entry() -> None:
    """The tiny entry-point forward on the card against the CPU's plain
    path, at the reference tests' bf16 bound (5e-2)."""
    fn, (params, _) = entry()
    tokens = torch.randint(0, 256, (2, 64), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(3))
    got = fn(params, tokens).cpu()
    cpu_params = {k: ({kk: vv.cpu() for kk, vv in v.items()}
                      if isinstance(v, dict) else v.cpu())
                  for k, v in params.items()}
    cfg = lm.LMConfig(vocab=256, d_model=128, n_layers=2, n_heads=4,
                      d_ff=512, attn_impl="flash")
    want = lm.make_forward(cfg, "cpu")(cpu_params, tokens.cpu())
    err = float((got - want).abs().max())
    if not (got.shape == (2, 64, 256) and err < 5e-2):
        raise AssertionError(f"entry forward on the card: {got.shape}, {err}")
    say("entry", ok=True, shape=list(got.shape), max_abs_err_vs_cpu=err)


def counters() -> dict:
    return {"vector_add": va.launches, "flash_attn_fwd": fa.launches,
            "flash_attn_bwd": fa.bwd_launches}


def zero_counters() -> None:
    va.launches = fa.launches = fa.bwd_launches = 0


def check_train(base: lm.LMConfig, cases, peak: float, known: bool) -> dict:
    """The training path: one counted step per case, then the loss over
    TRAIN_STEPS steps on one batch and the time of the steps after the
    first TRAIN_WARM. Returns the launches of the counted steps."""
    total = dict.fromkeys(counters(), 0)
    want = {"vector_add": 0, "flash_attn_fwd": 2 * base.n_layers,
            "flash_attn_bwd": base.n_layers}
    for case in cases:
        params, opt_state = lm.init_train_state(
            torch.Generator("cuda").manual_seed(0), base)
        step = lm.make_train_step(base)
        batch = lm.synthetic_batch(torch.Generator("cuda").manual_seed(1),
                                   base, case.batch, case.seq)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counters()
        params, opt_state, loss = step(params, opt_state, batch)
        torch.cuda.synchronize()
        launches = counters()
        if launches != want:
            raise AssertionError(f"{case.name}: launches per train step "
                                 f"{launches}, want {want}")
        for key, n in launches.items():
            total[key] += n
        losses = [loss]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for i in range(1, TRAIN_STEPS):
            if i == TRAIN_WARM:
                start.record()
            params, opt_state, loss = step(params, opt_state, batch)
            losses.append(loss)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / (TRAIN_STEPS - TRAIN_WARM)
        losses = [float(x) for x in losses]
        if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
            raise AssertionError(f"{case.name}: loss does not fall: {losses}")
        ntok = case.batch * case.seq
        flops = chip_bench.train_flops_per_token(case) * ntok
        say("train", case=case.name, batch=case.batch, seq=case.seq,
            launches_per_step=launches, step_ms=ms,
            tokens_per_s=ntok / (ms * 1e-3),
            mfu=flops / (ms * 1e-3) / peak, peak_known=known,
            train_bound_ms=flops / peak * 1e3,
            peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
            losses=losses)
        del params, opt_state, step, batch, loss
        torch.cuda.empty_cache()
    return total


def check_train_grads(base: lm.LMConfig) -> None:
    """Every gradient of the kernel path, at full width but 2 layers and
    the t2k shape, against an f32 plain-attention step, under the same
    rule as the forward's logits: within 2x the largest and 1.5x the
    mean deviation of the plain bf16 step's gradients."""
    cfg = dataclasses.replace(base, n_layers=2)
    case = chip_bench.case(MAIN_CASES[0])
    params = lm.init_params(torch.Generator("cuda").manual_seed(0), cfg)
    batch = lm.synthetic_batch(torch.Generator("cuda").manual_seed(1), cfg,
                               case.batch, case.seq)
    loss_k, grads_k = lm.loss_and_grads(params, batch, cfg)
    loss_p, grads_p = lm.loss_and_grads(
        params, batch, dataclasses.replace(cfg, attn_impl="local"))
    cfg32 = dataclasses.replace(cfg, attn_impl="local",
                                param_dtype=torch.float32,
                                compute_dtype=torch.float32)
    loss_32, grads_32 = lm.loss_and_grads(
        lm._tree_map(lambda p: p.float(), params), batch, cfg32)
    rows = {}
    for path, g_k, g_p, g_32 in zip(_paths(grads_k), lm._leaves(grads_k),
                                    lm._leaves(grads_p),
                                    lm._leaves(grads_32)):
        rows[path] = drift(g_k, g_p, g_32)
        if not (rows[path]["ok"] and bool(torch.isfinite(g_k).all())):
            raise AssertionError(f"gradient {path} drifts: {rows[path]}")
    say("train_grads", ok=True, n_layers=cfg.n_layers, case=case.name,
        loss=float(loss_k), plain_loss=float(loss_p), f32_loss=float(loss_32),
        grads=rows)
    del grads_k, grads_p, grads_32
    torch.cuda.empty_cache()


def _paths(tree, prefix="") -> list[str]:
    if isinstance(tree, dict):
        return [p for key, val in tree.items()
                for p in _paths(val, f"{prefix}{key}.")]
    return [prefix[:-1]]


def check_train_loop() -> None:
    """``lm.train`` on the card at the entry config: 4 steps with a
    checkpoint every 2, then a new incarnation that resumes at 4 and
    ends at 6, publishing markers and a metrics report."""
    cfg = lm.LMConfig(vocab=256, d_model=128, n_layers=2, n_heads=4,
                      d_ff=512, attn_impl="flash")
    old = os.environ.get("KTPU_SANDBOX")
    with tempfile.TemporaryDirectory() as tmp:
        ckpt_dir = os.path.join(tmp, "job")
        os.environ["KTPU_SANDBOX"] = tmp
        try:
            first = lm.train(cfg, steps=4, batch=2, seq=64, ckpt_dir=ckpt_dir,
                             checkpoint_every=2, publish_marker=True)
            second = lm.train(cfg, steps=6, batch=2, seq=64,
                              ckpt_dir=ckpt_dir, checkpoint_every=2,
                              publish_marker=True)
        finally:
            if old is None:
                os.environ.pop("KTPU_SANDBOX", None)
            else:
                os.environ["KTPU_SANDBOX"] = old
        marker = read_marker(ckpt_dir)
        report = metrics_reporter.read_report(tmp)
    if not (first["resumed_from"] == 0 and second["resumed_from"] == 4
            and second["final_step"] == 6 and marker == 5 and report
            and report.get("step") == 5 and report.get("hbm_used_bytes")):
        raise AssertionError(f"train loop: {first} {second} marker={marker} "
                             f"report={report}")
    say("train_loop", ok=True, first=first, second=second, marker=marker,
        report=report)


@contextlib.contextmanager
def environ(values: dict):
    """``os.environ`` with ``values`` set (None removes a name), put back
    as it was after."""
    old = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def gang_of_one(**values) -> dict:
    """A one-rank gang's env for the trainer on the card, ``values`` on
    top; None removes a name."""
    return {"TPU_WORKER_ID": "0",
            "TPU_WORKER_HOSTNAMES": "smoke-0.smoke-workers.default",
            "KTPU_TRAINER_PLATFORM": None, "KTPU_DEMO_PLATFORM": None,
            "KTPU_CHECKPOINT_DIR": None, "KTPU_PREEMPT": None,
            "KTPU_PREEMPT_FILE": None, "KTPU_SANDBOX": None,
            "STEP_DELAY": None, **values}


def trainer_cfg(n_layers: int) -> lm.LMConfig:
    """The config the trainer builds from TRAINER_ENV at ``n_layers``
    on the card: f32 params, bf16 compute, the flash kernels."""
    return lm.LMConfig(vocab=32768, d_model=2048, n_layers=n_layers,
                       n_heads=16, d_ff=8192, attn_impl="flash")


def run_module(module: str, env: dict) -> subprocess.CompletedProcess:
    """``python -m module`` from the repository root with this process's
    env and ``env`` on top; killed at SUBPROCESS_TIMEOUT."""
    child = dict(os.environ)
    for k, v in env.items():
        if v is None:
            child.pop(k, None)
        else:
            child[k] = v
    return subprocess.run([sys.executable, "-m", module], env=child,
                          cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True,
                          timeout=SUBPROCESS_TIMEOUT)


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tail(proc: subprocess.CompletedProcess) -> str:
    return (proc.stdout + proc.stderr)[-3000:]


def check_trainer(peak: float, known: bool) -> dict:
    """The TrainJob worker payload at the 600M width and depth:
    ``trainer.main()`` as a one-rank gang, counted. Returns its
    launches."""
    cfg = trainer_cfg(8)
    batch, seq = int(TRAINER_ENV["BATCH"]), int(TRAINER_ENV["SEQ"])
    case = chip_bench.BenchCase("trainer", cfg.d_model, cfg.n_layers,
                                cfg.n_heads, cfg.d_ff, cfg.vocab, batch, seq)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt_dir = os.path.join(tmp, "job")
        env = gang_of_one(**TRAINER_ENV, TOTAL_STEPS=str(TRAINER_STEPS),
                          CHECKPOINT_EVERY="0", CKPT_DIR=ckpt_dir,
                          KTPU_SANDBOX=tmp)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with environ(env):
            zero_counters()
            rc = trainer.main()
            torch.cuda.synchronize()
            launches = counters()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        report = metrics_reporter.read_report(tmp)
        with open(os.path.join(ckpt_dir, "attempt-rank0-start0.json")) as f:
            record = json.load(f)
        torch.cuda.empty_cache()
        direct = timed_train(cfg, None, os.path.join(tmp, "direct"),
                             TRAINER_STEPS)
    torch.cuda.empty_cache()
    events_ms = f32_step_ms(cfg, batch, seq)
    want = {"vector_add": 0, "flash_attn_fwd": 2 * cfg.n_layers * TRAINER_STEPS,
            "flash_attn_bwd": cfg.n_layers * TRAINER_STEPS}
    if rc != 0 or launches != want:
        raise AssertionError(f"trainer: rc {rc}, launches {launches}, "
                             f"want {want}")
    got = {k: record[k] for k in ("resumed_from", "final_step", "steps_run")}
    if got != {"resumed_from": 0, "final_step": TRAINER_STEPS,
               "steps_run": TRAINER_STEPS}:
        raise AssertionError(f"trainer: attempt record {record}")
    loss = record["loss"]
    if not (math.isfinite(loss)
            and abs(loss - direct["loss"]) <= 1e-3 * abs(direct["loss"])):
        raise AssertionError(f"trainer: loss {loss} against lm.train's "
                             f"{direct['loss']}")
    if not (report and report.get("step") == TRAINER_STEPS - 1):
        raise AssertionError(f"trainer: metrics report {report}")
    ms = report["step_time_ms"]
    ntok = batch * seq
    flops = chip_bench.train_flops_per_token(case) * ntok
    say("trainer", batch=batch, seq=seq, n_layers=cfg.n_layers,
        param_dtype="float32", steps=TRAINER_STEPS,
        launches_per_step={k: n // TRAINER_STEPS for k, n in launches.items()},
        launches=launches, loss=loss, direct_train_loss=direct["loss"],
        attempt_record=got, step_ms=ms, step_timed="last step, by the "
        "metrics report (host clock, to the loss's sync)",
        tokens_per_s=ntok / (ms * 1e-3), mfu=flops / (ms * 1e-3) / peak,
        peak_known=known, peak_memory_gb=peak_gb,
        direct_train_step_ms=direct["step_ms"],
        f32_step_events_ms=events_ms,
        f32_step_events_mfu=flops / (events_ms * 1e-3) / peak)
    return launches


def f32_step_ms(cfg: lm.LMConfig, batch: int, seq: int) -> float:
    """The trainer's step (f32 params) without its loop: back-to-back
    steps on one batch, timed by CUDA events after TRAIN_WARM steps, as
    the ``train`` phase times the bf16 step."""
    params, opt_state = lm.init_train_state(
        torch.Generator("cuda").manual_seed(0), cfg)
    step = lm.make_train_step(cfg)
    tokens = lm.synthetic_batch(torch.Generator("cuda").manual_seed(1), cfg,
                                batch, seq)
    for _ in range(TRAIN_WARM):
        params, opt_state, _ = step(params, opt_state, tokens)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TRAIN_STEPS - TRAIN_WARM):
        params, opt_state, _ = step(params, opt_state, tokens)
    end.record()
    end.synchronize()
    del params, opt_state, step
    torch.cuda.empty_cache()
    return start.elapsed_time(end) / (TRAIN_STEPS - TRAIN_WARM)


@contextlib.contextmanager
def step_losses():
    """The loss of every step that ``lm.train`` runs inside the block, in
    order: ``lm.make_train_step`` is wrapped to record them."""
    losses, make = [], lm.make_train_step

    def recording(*args, **kwargs):
        step = make(*args, **kwargs)

        def run(params, opt_state, batch):
            params, opt_state, loss = step(params, opt_state, batch)
            losses.append(float(loss))
            return params, opt_state, loss
        return run
    lm.make_train_step = recording
    try:
        yield losses
    finally:
        lm.make_train_step = make


def timed_train(cfg: lm.LMConfig, group, ckpt_dir: str, steps: int) -> dict:
    """``lm.train`` for ``steps`` steps at B4 T2048 with no saves; its
    result with ``losses``, the loss of each step, and ``step_ms``, the
    host time of each step after the first, each ended by a synchronize
    in the step callback."""
    ends = []

    def mark(_step):
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
    with step_losses() as losses:
        out = lm.train(cfg, steps=steps, batch=int(TRAINER_ENV["BATCH"]),
                       seq=int(TRAINER_ENV["SEQ"]), ckpt_dir=ckpt_dir,
                       checkpoint_every=0, step_callback=mark, group=group)
    return {**out, "losses": losses,
            "step_ms": [(b - a) * 1e3 for a, b in zip(ends, ends[1:])]}


def losses_agree(got: list, want: list, rtol: float) -> bool:
    """As many finite step losses as ``want``, each within ``rtol`` of
    it, relative."""
    return len(got) == len(want) and all(
        math.isfinite(g) and abs(g - w) <= rtol * abs(w)
        for g, w in zip(got, want))


def check_trainer_group() -> list:
    """``lm.train`` at full width, 2 layers, without a group and under a
    world-1 NCCL group (its gradient all-reduce, preemption verdict and
    barriers through NCCL on CUDA tensors): every step's loss within 1e-3
    relative. Returns the group run's losses."""
    cfg = trainer_cfg(2)
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        runs["no_group"] = timed_train(cfg, None, os.path.join(tmp, "a"),
                                       GROUP_STEPS)
        torch.cuda.empty_cache()
        rendezvous.init_process_group("127.0.0.1", free_port(), 0, 1, "nccl",
                                      timeout=120.0, bind_ip="127.0.0.1")
        try:
            runs["nccl_world_1"] = timed_train(cfg, dist.group.WORLD,
                                               os.path.join(tmp, "b"),
                                               GROUP_STEPS)
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    want, got = runs["no_group"]["losses"], runs["nccl_world_1"]["losses"]
    if len(want) != GROUP_STEPS or not losses_agree(got, want, 1e-3):
        raise AssertionError(f"trainer_group: losses {runs}")
    say("trainer_group", ok=True, n_layers=cfg.n_layers, steps=GROUP_STEPS,
        runs=runs, mean_step_ms={n: sum(r["step_ms"]) / len(r["step_ms"])
                                 for n, r in runs.items()})
    return got


def check_trainer_resume() -> None:
    """Two trainer processes at full width, 2 layers, on one checkpoint
    dir: 4 steps with a save every 2, then a resume to 6. Then one save
    and one resume of that state (2 layers, f32 params and AdamW), timed
    in this process."""
    env = gang_of_one(**{**TRAINER_ENV, "LM_LAYERS": "2"},
                      CHECKPOINT_EVERY="2")
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        ckpt_dir = os.path.join(tmp, "job")
        for total in (4, 6):
            t0 = time.perf_counter()
            proc = run_module("kubernetes_tpu_torch.workloads.trainer",
                              {**env, "CKPT_DIR": ckpt_dir,
                               "TOTAL_STEPS": str(total)})
            wall = time.perf_counter() - t0
            done = [ln for ln in proc.stdout.splitlines()
                    if ln.startswith("TRAINER DONE rank=0 ")]
            if proc.returncode != 0 or len(done) != 1:
                raise AssertionError(f"trainer_resume: exit {proc.returncode}"
                                     f", {done}: {_tail(proc)}")
            runs.append({"total_steps": total, "wall_s": wall,
                         "done": done[0]})
        records = []
        for start in (0, 4):
            with open(os.path.join(
                    ckpt_dir, f"attempt-rank0-start{start}.json")) as f:
                rec = json.load(f)
            records.append({k: rec[k] for k in
                            ("resumed_from", "final_step", "steps_run")})
        marker = read_marker(ckpt_dir)
        free_gb = shutil.disk_usage(tmp).free / 1e9
    if records != [{"resumed_from": 0, "final_step": 4, "steps_run": 4},
                   {"resumed_from": 4, "final_step": 6, "steps_run": 2}] \
            or marker != 5:
        raise AssertionError(f"trainer_resume: {records}, marker {marker}")

    cfg = trainer_cfg(2)

    def init():
        params, opt_state = lm.init_train_state(
            torch.Generator("cuda").manual_seed(0), cfg)
        return {"params": params, "opt_state": opt_state}
    with tempfile.TemporaryDirectory() as tmp:
        state = init()
        nbytes = sum(x.numel() * x.element_size()
                     for x in lm._leaves(state["params"])
                     + lm._leaves(state["opt_state"]["mu"])
                     + lm._leaves(state["opt_state"]["nu"]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.save(0, state, tmp)
        save_s = time.perf_counter() - t0
        want = state["params"]["embed"].clone()
        del state
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        restored, start = ckpt.resume_or_init(tmp, init)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        if start != 1 or not torch.equal(restored["params"]["embed"], want):
            raise AssertionError("trainer_resume: the timed resume")
        del restored, want
    torch.cuda.empty_cache()
    say("trainer_resume", ok=True, runs=runs, records=records, marker=marker,
        disk_free_gb_after_runs=free_gb, state_gb=nbytes / 1e9,
        save_s=save_s, resume_s=resume_s)


def check_demo() -> None:
    """The counting demo on the card as a one-rank gang: the exact final
    value of 6 steps, sum(1 + s)."""
    total = 6
    proc = run_module("kubernetes_tpu_torch.workloads.distributed_demo",
                      gang_of_one(MODEL=None, TOTAL_STEPS=str(total),
                                  CKPT_DIR=None))
    want = float(sum(1 + s for s in range(total)))
    done = [ln for ln in proc.stdout.splitlines() if ln.startswith("DONE ")]
    if proc.returncode != 0 or done != [f"DONE rank=0 start=0 final={want}"]:
        raise AssertionError(f"demo: exit {proc.returncode}, {done}, want "
                             f"{want}: {_tail(proc)}")
    say("demo", ok=True, final=want, line=done[0])


#: One rank of the two-card data-parallel run: NCCL on the card that
#: CUDA_VISIBLE_DEVICES gives it, ``timed_train`` of this script at full
#: width, 2 layers; its result as the last line.
DP2_RANK = r"""
import json, os, torch
from torch import distributed as dist
import chip_smoke
from kubernetes_tpu_torch.workloads import rendezvous
torch.cuda.set_device(0)
rendezvous.init_process_group("127.0.0.1", int(os.environ["DP2_PORT"]),
                              int(os.environ["DP2_RANK"]), 2, "nccl",
                              timeout=300.0, bind_ip="127.0.0.1")
out = chip_smoke.timed_train(chip_smoke.trainer_cfg(2), dist.group.WORLD,
                             os.environ["DP2_CKPT"], chip_smoke.GROUP_STEPS)
dist.destroy_process_group()
print(json.dumps(out))
"""


def check_trainer_dp2(world_1_losses: list) -> None:
    """Two ranks over NCCL, one card each, on the global batch of the
    world-1 run: every step's loss the same on both ranks and within
    5e-2 relative of the world-1 run's; their step times. Not run with
    one card."""
    if torch.cuda.device_count() < 2:
        say("trainer_dp2", skipped="one card")
        return
    port = free_port()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen(
            [sys.executable, "-c", DP2_RANK],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            env={**os.environ, "CUDA_VISIBLE_DEVICES": str(r),
                 "DP2_RANK": str(r), "DP2_PORT": str(port), "DP2_CKPT": tmp},
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(2)]
        outs = []
        try:
            for proc in procs:
                out, err = proc.communicate(timeout=SUBPROCESS_TIMEOUT)
                if proc.returncode != 0:
                    raise AssertionError(f"trainer_dp2: exit "
                                         f"{proc.returncode}: {err[-3000:]}")
                outs.append(json.loads(out.strip().splitlines()[-1]))
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
    losses = [o["losses"] for o in outs]
    if losses[0] != losses[1] or not losses_agree(losses[0], world_1_losses,
                                                  5e-2):
        raise AssertionError(f"trainer_dp2: losses {losses}, world 1 "
                             f"{world_1_losses}")
    say("trainer_dp2", ok=True, losses=losses[0],
        world_1_losses=world_1_losses,
        step_ms=[o["step_ms"] for o in outs])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    name = torch.cuda.get_device_name(0)
    peak, known = chip_bench.peak_flops_for(name)
    # A reference states its f32 precision: full f32, no TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("device", name=name, nvidia_smi=smi, count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda,
        peak_bf16_tflops=peak / 1e12, peak_known=known)

    t0 = time.perf_counter()
    logs = build.build()
    ptxas = {src: [ln.strip() for ln in log.splitlines()
                   if any(w in ln for w in ("entry function", "registers",
                                            "spill"))]
             for src, log in logs.items()}
    spills = [ln for lines in ptxas.values() for ln in lines
              if re.search(r"[1-9][0-9]* bytes spill", ln)]
    say("build", ok=True, seconds=time.perf_counter() - t0, spills=spills,
        ptxas=ptxas)

    gen = torch.Generator(device="cuda").manual_seed(0)
    va_rows = check_vector_add(gen, name)
    check_host_path()
    fa_rows = check_flash(gen, name)
    bwd_rows = check_flash_bwd(gen, name)
    check_entry()

    # The main path, counted: every counter to 0 just before, read after.
    cases = [chip_bench.case(c) for c in MAIN_CASES]
    base = lm.LMConfig(vocab=32768, d_model=2048, n_layers=8, n_heads=16,
                       d_ff=8192, param_dtype=torch.bfloat16,
                       attn_impl="flash")
    params = lm.init_params(torch.Generator("cuda").manual_seed(0), base)
    batches = [lm.synthetic_batch(torch.Generator("cuda").manual_seed(1), base,
                                  c.batch, c.seq)[:, :-1] for c in cases]
    torch.cuda.synchronize()
    forward = lm.make_forward(base)
    zero_counters()
    report = va.smoke_test()
    logits, per_forward = [], []
    for tokens in batches:
        before = fa.launches
        logits.append(forward(params, tokens))
        per_forward.append(fa.launches - before)
    torch.cuda.synchronize()
    launches = counters()
    if not report["ok"] or launches["vector_add"] != 1 \
            or launches["flash_attn_bwd"] != 0:
        raise AssertionError(f"payload smoke test: {report}, {launches}")
    if per_forward != [base.n_layers] * len(cases):
        raise AssertionError(f"flash launches per forward: {per_forward}")

    local = lm.make_forward(dataclasses.replace(base, attn_impl="local"))
    exact = lm.make_forward(dataclasses.replace(
        base, attn_impl="local", compute_dtype=torch.float32))
    for case, tokens, out in zip(cases, batches, logits):
        if out.shape != (case.batch, case.seq, base.vocab) or \
                not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{case.name}: logits {tuple(out.shape)}, "
                                 f"finite={bool(torch.isfinite(out).all())}")
        plain = local(params, tokens)
        ref32 = exact(params, tokens)
        # The kernel's forward must be as close to the f32 forward as the
        # plain bf16 forward is.
        errs = {"max_abs_vs_plain": float((out - plain).abs().max()),
                **drift(out, plain, ref32)}
        del plain, ref32
        if not errs.pop("ok"):
            raise AssertionError(f"{case.name}: flash forward drifts: {errs}")
        ms = time_ms(lambda: forward(params, tokens), 10)
        plain_ms = time_ms(lambda: local(params, tokens), 3, 1)
        ntok = case.batch * case.seq
        flops = chip_bench.forward_flops_per_token(case) * ntok
        say("main_path", case=case.name, batch=case.batch, seq=case.seq,
            shape=list(out.shape), flash_launches=per_forward[0],
            forward_ms=ms, plain_attention_forward_ms=plain_ms,
            tokens_per_s=ntok / (ms * 1e-3),
            mfu=flops / (ms * 1e-3) / peak, peak_known=known,
            forward_bound_ms=flops / peak * 1e3, **errs)
        torch.cuda.empty_cache()
    say("main_path_counts", launches=launches, payload=report)
    del params, logits
    torch.cuda.empty_cache()

    # The training path, counted per step inside check_train.
    train_launches = check_train(base, cases, peak, known)
    check_train_grads(base)
    check_train_loop()

    # The TrainJob worker payload, counted inside check_trainer; then the
    # trainer's group, resume and demo paths and, with two cards, dp.
    trainer_launches = check_trainer(peak, known)
    world_1_losses = check_trainer_group()
    check_trainer_resume()
    check_demo()
    check_trainer_dp2(world_1_losses)
    by_path = {k: {"forward": launches[k], "train": train_launches[k],
                   "trainer": trainer_launches[k]}
               for k in launches}

    # Last of all: the one profiled phase (K1's device_us).
    profile_vector_add(va_rows)

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library", "ratio_to_library", "share_of_bound",
            "host_us")
    va_keys = keys + ("library_host_us", "device_us", "library_device_us")
    kernels = [
        {"name": "vector_add", "route": "cuda",
         "source": "kubernetes_tpu_torch/csrc/vector_add.cu",
         "replaces": "kubernetes_tpu/workloads/vector_add.py:17-26",
         "at": f"n={row['n']} {row['dtype']}", **{k: row[k] for k in va_keys}}
        for row in va_rows]
    for shape, fa_row, bwd_row in zip(MAIN_FLASH_SHAPES, fa_rows, bwd_rows):
        at = "B{} H{} T{} D{} bf16".format(*shape)
        kernels += [
            {"name": "flash_attn_fwd", "route": "cuda",
             "source": "kubernetes_tpu_torch/csrc/flash_attn_fwd.cu",
             "replaces": "kubernetes_tpu/workloads/lm.py:163-239",
             "at": at, **{k: fa_row[k] for k in keys}},
            {"name": "flash_attn_bwd", "route": "cuda",
             "source": "kubernetes_tpu_torch/csrc/flash_attn_bwd.cu",
             "replaces": "kubernetes_tpu/workloads/lm.py:193-197, 232-236",
             "at": at, **{k: bwd_row[k] for k in keys}}]
    for kern in kernels:
        kern["launches"] = sum(by_path[kern["name"]].values())
        kern["launches_by_path"] = by_path[kern["name"]]
    if not all(kern["launches"] > 0 for kern in kernels):
        raise AssertionError(f"a kernel of the main path never ran: {by_path}")
    for kern in kernels:
        if not all(math.isfinite(kern[k])
                   for k in ("ms", "plain_ms", "bound_ms", "host_us")):
            raise AssertionError(f"bad timing: {kern}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
