"""The port's training metrics reporter against the reference's contract.

A report the port writes is read by the reference's ``read_report`` (the
node agent's side) with the same keys and values the reference's
reporter writes for the same step; the reporter is off without
``KTPU_SANDBOX`` and never raises. Device memory comes from
``torch.cuda`` only on a CUDA device, so a CPU report has none.
"""
import pytest
import torch

from kubernetes_tpu.workloads import metrics_reporter as jax_mr
from kubernetes_tpu_torch.workloads import lm
from kubernetes_tpu_torch.workloads import metrics_reporter as torch_mr

STEP = dict(step=7, step_time_s=0.25, tokens=4096, loss=2.345678)


def test_port_report_reads_back_through_the_reference(monkeypatch, tmp_path):
    monkeypatch.setenv("KTPU_SANDBOX", str(tmp_path / "port"))
    (tmp_path / "port").mkdir()
    got = torch_mr.TrainingMetricsReporter(
        flops_per_token=1e9, peak_flops=1e15, device="cpu").report(**STEP)
    monkeypatch.setenv("KTPU_SANDBOX", str(tmp_path / "ref"))
    (tmp_path / "ref").mkdir()
    want = jax_mr.TrainingMetricsReporter(
        flops_per_token=1e9, peak_flops=1e15).report(
            **STEP, hbm_used_bytes=None)
    read = jax_mr.read_report(str(tmp_path / "port"))
    assert read is not None and read["stale"] is False
    for rec in (got, read):
        for key in ("step", "step_time_ms", "tokens_per_sec", "loss", "mfu"):
            assert rec[key] == want[key], key
    assert torch_mr.REPORT_BASENAME == jax_mr.REPORT_BASENAME
    assert torch_mr.STALE_AFTER_SECONDS == jax_mr.STALE_AFTER_SECONDS


def test_cpu_reports_carry_no_device_memory(monkeypatch, tmp_path):
    monkeypatch.setenv("KTPU_SANDBOX", str(tmp_path))
    rec = torch_mr.TrainingMetricsReporter(device="cpu").report(**STEP)
    assert "hbm_used_bytes" not in rec and "hbm_total_bytes" not in rec
    rec = torch_mr.TrainingMetricsReporter(device="cpu").report(
        **STEP, hbm_used_bytes=5, hbm_total_bytes=9)
    assert (rec["hbm_used_bytes"], rec["hbm_total_bytes"]) == (5, 9)


def test_mfu_only_with_a_known_peak(monkeypatch, tmp_path):
    """On the CPU there is no card peak, so no MFU is reported."""
    monkeypatch.setenv("KTPU_SANDBOX", str(tmp_path))
    reporter = torch_mr.TrainingMetricsReporter(flops_per_token=1e9,
                                                device="cpu")
    assert reporter.peak_flops is None
    assert "mfu" not in reporter.report(**STEP)


def test_disabled_without_a_sandbox(monkeypatch, tmp_path):
    monkeypatch.delenv("KTPU_SANDBOX", raising=False)
    reporter = torch_mr.TrainingMetricsReporter()
    assert not reporter.enabled
    assert reporter.report(**STEP) is None
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("step_time_s", [0.0, -1.0])
def test_no_report_for_a_step_without_time(monkeypatch, tmp_path,
                                           step_time_s):
    monkeypatch.setenv("KTPU_SANDBOX", str(tmp_path))
    assert torch_mr.TrainingMetricsReporter().report(
        7, step_time_s, 10) is None


def test_never_raises(tmp_path):
    reporter = torch_mr.TrainingMetricsReporter(
        path=str(tmp_path / "missing" / "dir" / "m.json"))
    assert reporter.report(**STEP) is None
    assert reporter.report(1, 1.0, 1, loss="not a number") is None


def test_stale_reports_are_marked(monkeypatch, tmp_path):
    monkeypatch.setenv("KTPU_SANDBOX", str(tmp_path))
    rec = torch_mr.TrainingMetricsReporter().report(**STEP)
    late = rec["timestamp"] + torch_mr.STALE_AFTER_SECONDS + 1
    for read_report in (torch_mr.read_report, jax_mr.read_report):
        assert read_report(str(tmp_path), now=late)["stale"] is True
        assert read_report(str(tmp_path / "none")) is None


def test_lm_train_publishes_its_steps(monkeypatch, tmp_path):
    monkeypatch.setenv("KTPU_SANDBOX", str(tmp_path))
    cfg = lm.LMConfig(vocab=64, d_model=32, n_layers=1, n_heads=2, d_ff=64,
                      attn_impl="local")
    out = lm.train(cfg, steps=2, batch=2, seq=8,
                   ckpt_dir=str(tmp_path / "ckpt"), checkpoint_every=0,
                   device="cpu")
    rec = jax_mr.read_report(str(tmp_path))
    assert rec["step"] == 1 and rec["loss"] == round(out["loss"], 4)
    assert rec["tokens_per_sec"] > 0 and "mfu" not in rec
