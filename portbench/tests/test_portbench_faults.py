"""A run of a cut cell on the CPU, the look for a card skipped, with the
port's step broken underneath the harness: ``correct`` comes out false
for each fault a training cell can have (a step that returns its state
unchanged, half of the batch left out, the exchange between ranks left
out), and true for the sound step."""
import json
import os
import subprocess
import sys

import pytest

from portbench import run, spec
from portbench.tests import rehearsal


def _one_process(fault, monkeypatch, seed):
    from kubernetes_tpu_torch.workloads import flash_attention as fa
    from kubernetes_tpu_torch.workloads import lm
    for mod, name in ((fa, "flash_attention_fwd"), (fa, "flash_attention_bwd"),
                      (lm, "loss_fn"), (lm, "_average_")):
        monkeypatch.setattr(mod, name, getattr(mod, name))
    monkeypatch.setattr(lm.AdamW, "update_", lm.AdamW.update_)
    rehearsal.count_cpu_launches()
    rehearsal.plant(fault)
    cell = rehearsal.tiny_cell("phi3-mini-train-t16k")
    res = run.run_cell(cell, seed, 0.3, False, "cpu")
    return run.result_line(cell, res, False)[1]


@pytest.mark.parametrize("seed", [31, 2 ** 31 + 77])
def test_sound_step_is_correct(monkeypatch, seed):
    assert _one_process("", monkeypatch, seed)


@pytest.mark.parametrize("fault", ["unchanged", "half"])
def test_fault_is_not_correct(monkeypatch, fault):
    assert not _one_process(fault, monkeypatch, 31)


def _two_ranks(fault, seed=41):
    cell = rehearsal.tiny_cell("gptj-6b-dp4-t2k", batch=4, seq=64, chips=2)
    port = run._free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", rehearsal.RANK_SCRIPT], cwd=spec.ROOT,
        env={**os.environ, "CELL": json.dumps(cell), "SEED": str(seed),
             "FAULT": fault, "RANK": str(r), "PORT": str(port)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-3000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return run.result_line(cell, run.merge(outs), False)[1]


@pytest.mark.parametrize("fault,correct", [("", True), ("exchange", False),
                                           ("half", False)])
def test_two_ranks(fault, correct):
    assert _two_ranks(fault) is correct
