"""Spans of the port's own work, on PyTorch's profiler clock.

``with span("lm.forward"):`` marks a stretch of the host's work by name.
While a profiler records, the span is one of PyTorch's record
functions: under ``torch.profiler.profile`` it is a host event on the
clock of the card's kernels (CUPTI's), nested in the span or operation
that opened it, and the kernels launched inside it are its kernels;
under ``torch.autograd.profiler.emit_nvtx`` it is an NVTX range, as
Nsight Systems shows it. While none records, ``span`` returns one shared
no-op context: one test of the profiler's flag, no allocation, no
dispatcher call.

Where PyTorch has ``torch._C._profiler._RecordFunctionFast`` the span is
one of those: it never enters the dispatcher (so a dispatch mode, such
as selective checkpointing's, never sees it) and the trace lists it
among the host's operations, beside the aten ops it holds. Else it is
``torch.profiler.record_function``, a user annotation.

The spans the port opens: ``lm.forward``, ``lm.backward``,
``lm.grad_sync`` and ``lm.update`` around the phases of
``lm.make_train_step``'s step, one after another on the host (and
``lm.forward``, ``lm.backward`` and ``lm.update`` around those of
``moe.make_train_step``'s); ``lm.layer`` around each layer, again inside
``lm.backward`` (on autograd's thread) where remat recomputes it (the
MoE's per-kind stacks too); ``attention.fwd`` and ``attention.bwd``
around the flash attention Function's forward and backward, the shape
as their ``args``. In the MoE's per-kind stacks (``moe.py``,
``layer_types``): ``moe.conv`` around each gated short-conv mixer;
``moe.route`` around the sigmoid router, top-k and the sort by expert;
``moe.dispatch``, ``moe.experts`` and ``moe.combine`` around the
forwards of the gather into expert order, the grouped expert GEMMs and
the weighted scatter-add back, and ``moe.dispatch.bwd``,
``moe.experts.bwd`` and ``moe.combine.bwd`` around their backwards.
"""
from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

#: What :func:`span` returns while no profiler records.
OFF = contextlib.nullcontext()

_FAST = getattr(torch._C._profiler, "_RecordFunctionFast", None)


def span(name: str, args="", of=None):
    """A context that records ``name`` while a profiler records, else
    :data:`OFF`. ``args``: a string recorded with the span, or a function
    of ``of`` that makes it, called only while a profiler records."""
    if not _profiler._is_profiler_enabled:
        return OFF
    if callable(args):
        args = args(of)
    if _FAST is not None:
        return _FAST(name, [], {"args": args}) if args else _FAST(name)
    return torch.profiler.record_function(name, args or None)
