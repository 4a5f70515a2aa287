"""Helpers of the benchmark's CPU tests: cells cut to a size a test run
holds, the kernels' plain versions counted as launches (on CPU tensors
the port runs them uncounted), and faults planted in the port's step."""
from __future__ import annotations

import copy

from portbench import spec

#: Limits for the cut cells: above what sound runs of the port read at
#: these sizes (loss <= 6e-4, grad <= 2.1e-3, change <= 1.8e-3 over the
#: seeds the tests use), under what each planted fault reads.
TEST_LIMITS = {"loss": 0.005, "grad": 0.01, "change": 0.01}

TINY = {"vocab": 256, "d_model": 64, "n_layers": 2, "n_heads": 4,
        "d_ff": 128}


def tiny_cell(name: str, batch: int = 2, seq: int = 64, chips: int = 1,
              **run) -> dict:
    """The cell ``name`` at tiny widths, B ``batch`` T ``seq``, with the
    test limits; ``run`` overrides the configuration's ``run``."""
    cell = copy.deepcopy(spec.load(name))
    cell["config"]["run"].update(TINY, **run)
    cell["traffic"].update(global_batch=batch, seq=seq)
    cell["workload"]["limits"] = dict(TEST_LIMITS)
    cell["chips"] = chips
    return cell


def count_cpu_launches() -> None:
    """Count each call of the attention's plain forward and backward as
    a launch of the kernel the card would run."""
    from kubernetes_tpu_torch.workloads import flash_attention as fa

    fwd, bwd = fa.flash_attention_fwd, fa.flash_attention_bwd

    def counted_fwd(*args, **kw):
        fa._launches["flash_attn_fwd"] += 1
        return fwd(*args, **kw)

    def counted_bwd(*args, **kw):
        fa._launches["flash_attn_bwd"] += 1
        return bwd(*args, **kw)

    fa.flash_attention_fwd, fa.flash_attention_bwd = counted_fwd, counted_bwd


def plant(fault: str) -> None:
    """Break the port's train step underneath the harness:
    ``unchanged``, the step leaves the state as it was; ``half``, half of
    the batch is left out and the mean taken over the rest; ``exchange``,
    the gradients are not averaged over the group (the loss still is)."""
    from kubernetes_tpu_torch.workloads import lm

    if fault == "unchanged":
        lm.AdamW.update_ = lambda self, params, grads, state: None
    elif fault == "half":
        loss_fn = lm.loss_fn

        def half(params, batch, cfg, mesh=None, attention=None):
            b, t = batch.shape
            batch = batch[:b // 2] if b > 1 else batch[:, :t // 2 + 1]
            return loss_fn(params, batch, cfg, mesh, attention)

        lm.loss_fn = half
    elif fault == "exchange":
        average = lm._average_
        lm._average_ = lambda tensors, group: average(tensors[:1], group)
    elif fault:
        raise ValueError(f"no fault {fault!r}")


#: A rank of a two-rank gloo gang that runs a cut cell with a fault
#: planted: CELL, SEED, FAULT, RANK, PORT in its environment; its
#: result as the last line.
RANK_SCRIPT = r"""
import json, os
from torch import distributed as dist
from kubernetes_tpu_torch.workloads import rendezvous
from portbench import cell as cells
from portbench.tests import rehearsal
rehearsal.count_cpu_launches()
rehearsal.plant(os.environ["FAULT"])
rendezvous.init_process_group("127.0.0.1", int(os.environ["PORT"]),
                              int(os.environ["RANK"]), 2, "gloo",
                              timeout=120.0, bind_ip="127.0.0.1")
out = cells.run_rank(json.loads(os.environ["CELL"]), int(os.environ["SEED"]),
                     0.5, False, "cpu", dist.group.WORLD)
dist.destroy_process_group()
print(json.dumps(out))
"""
