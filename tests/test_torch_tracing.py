"""The port's spans (``kubernetes_tpu_torch/tracing.py``) and its count of
the gradient exchange (``collectives.counts``), on a tiny LM train step
on the CPU under ``torch.profiler``, remat per layer.

- One step shows one ``lm.forward``, one ``lm.backward`` and one
  ``lm.update``, in that order, and no ``lm.grad_sync`` without a group,
  under either remat policy and either kind of record function.
- ``n_layers`` ``lm.layer`` spans lie in the forward and ``n_layers``
  more in the backward, the recompute; each holds one ``attention.fwd``,
  and the backward holds one ``attention.bwd`` a layer.
- On a gloo group of 2, ``lm.grad_sync`` follows the backward and the
  counter reads one exchange, two all-reduces (the f32 loss, the bf16
  gradients) and exactly their bytes.
- Without a profiler ``span`` returns the one shared no-op context and
  makes no ``args``; with one, two steps' losses and params are bit for
  bit those without.
"""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kubernetes_tpu_torch import tracing
from kubernetes_tpu_torch.workloads import collectives, lm

ROOT = Path(__file__).resolve().parent.parent
TINY = dict(vocab=64, d_model=32, n_layers=3, n_heads=2, d_ff=64)
NAMES = ("lm.", "attention.")


def _cfg(policy: str = "dots") -> lm.LMConfig:
    return lm.LMConfig(**TINY, param_dtype=torch.bfloat16,
                       compute_dtype=torch.bfloat16, remat=True,
                       remat_policy=policy, attn_impl="flash")


def _state(cfg: lm.LMConfig):
    return lm.init_train_state(torch.Generator().manual_seed(0), cfg)


def _batch(cfg: lm.LMConfig, i: int) -> torch.Tensor:
    return lm.synthetic_batch(torch.Generator().manual_seed(i), cfg, 2, 16,
                              "cpu")


def _spans(prof) -> list:
    """The port's spans of a profile: ``(name, start, end)``."""
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.name.startswith(NAMES)]


def _named(spans: list, name: str) -> list:
    return [s for s in spans if s[0] == name]


def _inside(spans: list, outer: tuple) -> list:
    return [s for s in spans if outer[1] <= s[1] and s[2] <= outer[2]]


@pytest.fixture(scope="module", params=["dots", "full", "dots-annotated"])
def traced(request):
    """The spans of one traced train step under each remat policy, and
    as ``record_function``'s user annotations, where PyTorch lacks the
    fast record function."""
    policy, _, annotated = request.param.partition("-")
    fast = tracing._FAST
    tracing._FAST = None if annotated else fast
    try:
        cfg = _cfg(policy)
        params, opt_state = _state(cfg)
        step = lm.make_train_step(cfg, device="cpu")
        batch = _batch(cfg, 1)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            step(params, opt_state, batch)
    finally:
        tracing._FAST = fast
    return cfg, _spans(prof)


def test_step_shows_each_phase_once_in_order(traced):
    _, spans = traced
    phases = [_named(spans, n) for n in ("lm.forward", "lm.backward",
                                         "lm.update")]
    assert [len(p) for p in phases] == [1, 1, 1]
    (fwd,), (bwd,), (upd,) = phases
    assert fwd[2] <= bwd[1] and bwd[2] <= upd[1]
    assert not _named(spans, "lm.grad_sync")


def test_layers_in_the_forward_and_again_in_the_backward(traced):
    cfg, spans = traced
    (fwd,), (bwd,) = _named(spans, "lm.forward"), _named(spans, "lm.backward")
    layers = _named(spans, "lm.layer")
    assert len(_inside(layers, fwd)) == cfg.n_layers
    assert len(_inside(layers, bwd)) == cfg.n_layers
    assert len(layers) == 2 * cfg.n_layers


def test_attention_spans_one_a_layer_each_way(traced):
    cfg, spans = traced
    (fwd,), (bwd,) = _named(spans, "lm.forward"), _named(spans, "lm.backward")
    attn_fwd = _named(spans, "attention.fwd")
    attn_bwd = _named(spans, "attention.bwd")
    for phase in (fwd, bwd):
        for layer in _inside(_named(spans, "lm.layer"), phase):
            assert len(_inside(attn_fwd, layer)) == 1
    assert len(_inside(attn_fwd, fwd)) == len(_inside(attn_fwd, bwd)) \
        == cfg.n_layers
    assert len(_inside(attn_bwd, bwd)) == len(attn_bwd) == cfg.n_layers


def test_span_without_a_profiler_is_the_shared_no_op():
    def never(_):
        raise AssertionError("args made with no profiler")

    assert tracing.span("lm.forward") is tracing.OFF
    assert tracing.span("attention.fwd", never, torch.empty(1)) is tracing.OFF
    with tracing.span("lm.layer") as inside:
        assert inside is None


def test_span_args_recorded_with_shapes():
    q = torch.randn(2, 4, 16, 8, dtype=torch.bfloat16, requires_grad=True)
    k, v = (torch.randn_like(q, requires_grad=True) for _ in range(2))
    from kubernetes_tpu_torch.workloads.flash_attention import FlashAttention
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as p:
        FlashAttention.apply(q, k, v).sum().backward()
    args = {e.name: e.kwinputs.get("args") for e in p.events()
            if e.name.startswith("attention.")}
    assert args == {"attention.fwd": "B2 H4 T16 D8 bf16 causal",
                    "attention.bwd": "B2 H4 T16 D8 bf16 causal"}


def test_profiler_changes_no_number():
    """Two steps with the profiler on are bit for bit two without."""
    cfg = _cfg()
    runs = []
    for traced in (False, True):
        params, opt_state = _state(cfg)
        step = lm.make_train_step(cfg, device="cpu")
        losses = []
        for i in range(2):
            if traced:
                with profile(activities=[ProfilerActivity.CPU]):
                    params, opt_state, loss = step(params, opt_state,
                                                   _batch(cfg, i))
            else:
                params, opt_state, loss = step(params, opt_state,
                                               _batch(cfg, i))
            losses.append(loss)
        runs.append((losses, lm._leaves(params) + lm._leaves(opt_state[1])))
    (loss_a, leaves_a), (loss_b, leaves_b) = runs
    assert all(torch.equal(a, b) for a, b in zip(loss_a, loss_b))
    assert all(torch.equal(a, b) for a, b in zip(leaves_a, leaves_b))


def test_counter_counts_calls_and_bytes():
    saved = collectives.counts()
    collectives.zero_counts()
    try:
        collectives.count_exchange()
        collectives.count_all_reduce(torch.zeros(10, dtype=torch.bfloat16))
        collectives.count_all_reduce(torch.zeros(3), calls=2)
        assert collectives.counts() == {"exchanges": 1, "calls": 3,
                                        "bytes": 20 + 2 * 12}
        collectives.zero_counts()
        assert set(collectives.counts().values()) == {0}
    finally:
        collectives._exchanged.update(saved)


#: One rank of a gloo group of 2: a traced train step on its rows; its
#: spans' names, the counter and the bytes of its loss and gradients as
#: the last line.
_RANK = r"""
import json, os, sys
import torch
from torch import distributed as dist
from torch.profiler import ProfilerActivity, profile
sys.path.insert(0, os.environ["TESTS"])
import test_torch_tracing as t
from kubernetes_tpu_torch.workloads import collectives, lm, rendezvous
rank = int(os.environ["RANK"])
rendezvous.init_process_group("127.0.0.1", int(os.environ["PORT"]), rank, 2,
                              "gloo", 60.0, "127.0.0.1")
cfg = t._cfg()
params, opt_state = t._state(cfg)
step = lm.make_train_step(cfg, device="cpu", group=dist.group.WORLD)
rows = t._batch(cfg, 1)[rank:rank + 1]
collectives.zero_counts()
with profile(activities=[ProfilerActivity.CPU]) as prof:
    step(params, opt_state, rows)
dist.destroy_process_group()
spans = t._spans(prof)
order = [s[0] for s in sorted(spans, key=lambda s: s[1])
         if s[0] in ("lm.forward", "lm.backward", "lm.grad_sync", "lm.update")]
grads = sum(p.numel() * p.element_size() for p in lm._leaves(params))
print(json.dumps({"order": order, "counts": collectives.counts(),
                  "bytes": 4 + grads}))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_grad_sync_span_and_counter_on_a_gloo_group():
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK], cwd=ROOT, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env={**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1",
             "TESTS": str(ROOT / "tests"), "RANK": str(r),
             "PORT": str(port)}) for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            assert p.returncode == 0, out[-3000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for got in outs:
        assert got["order"] == ["lm.forward", "lm.backward", "lm.grad_sync",
                                "lm.update"]
        assert got["counts"] == {"exchanges": 1, "calls": 2,
                                 "bytes": got["bytes"]}
