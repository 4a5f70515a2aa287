"""The benchmark's frozen copies against the port they were copied from:
the FLOP accounting and peaks of ``perf/chip_bench.py`` at both cells'
shapes, the batch stream of ``lm.synthetic_batch`` and the scales of
``lm.init_params``; the attention bounds against the kernel table's."""
import pytest
import torch

from portbench import feed, peaks, spec
from portbench.accounting import lm as acc

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_flops_equal_chip_bench(cell):
    from kubernetes_tpu_torch.perf import chip_bench
    c = spec.load(cell)
    run, t = c["config"]["run"], c["traffic"]
    case = chip_bench.BenchCase(cell, run["d_model"], run["n_layers"],
                                run["n_heads"], run["d_ff"], run["vocab"],
                                t["global_batch"], t["seq"])
    assert acc.matmul_params(run) == chip_bench.matmul_params(case)
    assert acc.train_flops_per_token(run, t["seq"]) \
        == chip_bench.train_flops_per_token(case)


def test_peaks_equal_chip_bench():
    from kubernetes_tpu_torch.perf import chip_bench
    assert peaks.PEAKS == chip_bench.PEAKS
    assert peaks.DEFAULT_PEAK == chip_bench.DEFAULT_PEAK
    assert peaks.peaks_for("NVIDIA H100 80GB HBM3") == (989e12, 3.35e12, True)


def test_attention_bounds_as_the_kernel_table():
    # PERF.md's kernel table: B4 H16 T2048 D128 causal, 0.0695 ms forward
    # and 0.1738 ms backward by operations at 989 TFLOP/s.
    for direction, ms in (("fwd", 0.0695), ("bwd", 0.1738)):
        ops, nbytes = acc.attention_launch(direction, 4, 16, 2048, 128)
        assert acc.bound_s(ops, nbytes, 989e12, 3.35e12) * 1e3 \
            == pytest.approx(ms, rel=1e-3)


def test_batch_stream_equals_synthetic_batch():
    from kubernetes_tpu_torch.workloads import lm
    cfg = lm.LMConfig(vocab=32064)
    for seed, step in ((7, 0), (2 ** 31 + 9, 5)):
        ours = feed.global_batch(seed, step, 32064, 3, 300, "cpu")
        theirs = lm.synthetic_batch(feed.generator("cpu", seed, "batch", step),
                                    cfg, 3, 300, "cpu")
        assert torch.equal(ours, theirs)
    a = feed.global_batch(1, 0, 32064, 16, 64, "cpu")
    assert len({tuple(r.tolist()) for r in a}) == 16  # every row differs
    assert not torch.equal(a, feed.global_batch(1, 1, 32064, 16, 64, "cpu"))


def test_init_params_as_the_port_scales_them():
    from kubernetes_tpu_torch.workloads import lm
    run = {"vocab": 512, "d_model": 128, "n_layers": 3, "n_heads": 4,
           "d_ff": 256, "param_dtype": "bfloat16"}
    cfg = lm.LMConfig(vocab=512, d_model=128, n_layers=3, n_heads=4,
                      d_ff=256, param_dtype=torch.bfloat16)
    ours = feed.flat(feed.init_params(5, run, "cpu"))
    theirs = feed.flat(lm.init_params(torch.Generator().manual_seed(5), cfg))
    assert list(ours) == list(theirs)
    for name in ours:
        a, b = ours[name], theirs[name]
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert float(a.float().std()) == pytest.approx(
            float(b.float().std()), rel=0.05, abs=1e-6), name
    again = feed.init_leaf(5, run, "layers.w2", "cpu")
    assert torch.equal(again, ours["layers.w2"])
