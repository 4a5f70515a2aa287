"""The plain reference against the port: its blocked attention against
plain attention, and its train step against the port's CPU step in f32
(plain attention) on a tiny LM, alone and over a two-rank gloo group."""
import math

import pytest
import torch

from portbench import calibrate, run
from portbench.reference import lm as ref
from portbench.tests import rehearsal


def _plain(q, k, v):
    t, d = q.shape[2], q.shape[3]
    s = (q @ k.transpose(-1, -2)) / math.sqrt(d)
    mask = torch.ones(t, t, dtype=torch.bool).triu(1)
    return torch.softmax(s.masked_fill(mask, float("-inf")), -1) @ v


def test_blocked_attention_matches_plain(monkeypatch):
    # Blocks of 16 query rows out of 100: several blocks and a ragged one.
    monkeypatch.setattr(ref, "SCORE_BLOCK_BYTES", 2 * 3 * 100 * 4 * 16)
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 3, 100, 24, generator=g, dtype=torch.float64,
                           requires_grad=True) for _ in range(3))
    do = torch.randn(2, 3, 100, 24, generator=g, dtype=torch.float64)
    o = ref.BlockedAttention.apply(q, k, v)
    grads = torch.autograd.grad(o, (q, k, v), do)
    o2 = _plain(q, k, v)
    grads2 = torch.autograd.grad(o2, (q, k, v), do)
    assert torch.allclose(o, o2, atol=1e-12)
    for a, b in zip(grads, grads2):
        assert torch.allclose(a, b, atol=1e-10)


def _f32_cell(chips):
    return rehearsal.tiny_cell(
        "gptj-6b-dp4-t2k" if chips > 1 else "phi3-mini-train-t16k",
        batch=4, seq=32, chips=chips, param_dtype="float32",
        compute_dtype="float32", attn_impl="local")


@pytest.mark.parametrize("chips", [1, 2])
def test_reference_step_matches_the_ports_f32_step(chips):
    """Three steps of the port in f32 with plain attention (``device=
    "cpu"``) and of the reference, from the same params and batches: each
    loss, gradient norm and change agrees to f32 rounding; with two
    ranks, each taking its rows, the port averaging over its group and
    the reference summing its gradients."""
    cell = _f32_cell(chips)
    if chips == 1:
        rows = [calibrate.rank_readings(cell, [11], [], "cpu")]
    else:
        rows = run.run_ranks(cell, {"mode": "calibrate", "seeds": [11],
                                    "control_seeds": []}, chips, "cpu")
    for per_rank in rows:
        nums = per_rank[0]["port"]
        assert max(nums.values()) < 2e-5, nums
