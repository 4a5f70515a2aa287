"""On the card (marker ``cuda``; skips without one): a cut cell through
the whole harness, its window through the kernels, its trace read.

    python -m pytest -q portbench/tests/test_portbench_cuda.py
"""
import pytest
import torch

from portbench import run
from portbench.tests import rehearsal


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("traced", [False, True])
def test_cut_cell_on_the_card(card, traced):
    cell = rehearsal.tiny_cell("phi3-mini-train-t16k", batch=2, seq=256,
                               d_model=256, n_heads=4, d_ff=512)
    cell["workload"]["limits"] = {"loss": 0.02, "grad": 0.05, "change": 0.05}
    res = run.run_cell(cell, 5, 1.0, traced)
    line, correct, _ = run.result_line(cell, res, traced)
    assert res["launches"]["fwd"] >= res["launches"]["least"] > 0
    assert correct, line
    if traced:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        for name in ("mfu", "matmul_ms", "attn_fwd_roofline",
                     "attn_bwd_roofline", "idle_share"):
            assert name in line["metrics"], name
        assert 0 < line["metrics"]["attn_bwd_roofline"]["value"] <= 105
