"""The optimizer's rate, ``update_gbs``: the bytes that the program's
AdamW counter gives an update, times the updates a traced step makes,
over the device time of the span ``lm.update``; nothing without the
counter (the program before its fused update), without a count or
without the span. Its ``KERNELS`` take the fused kernel out of
``elementwise_ms``."""
import sys

import pytest

from portbench import spec
from portbench.tests.test_portbench_spans import window


def read(name, ctx):
    return spec.module("metrics", name).read(ctx)


def test_update_rate_from_the_programs_counter(monkeypatch):
    from kubernetes_tpu_torch.workloads import adamw
    monkeypatch.setattr(adamw, "_counts",
                        {"updates": 4, "launches": 12, "leaves": 600,
                         "elements": 4 * 1e8, "bytes": 4 * 2.4e9})
    # The window's update: 1500 + 1600 + 1700 us of device time a step,
    # so 2.4e9 bytes over 4.8 ms.
    assert read("update_ms", window(2)) == pytest.approx(4.8)
    assert read("update_gbs", window(2)) == pytest.approx(500.0)


def test_nothing_without_a_count_or_the_span(monkeypatch):
    from kubernetes_tpu_torch.workloads import adamw
    monkeypatch.setattr(adamw, "_counts",
                        {"updates": 0, "launches": 0, "leaves": 0,
                         "elements": 0, "bytes": 0})
    assert read("update_gbs", window(2)) is None
    monkeypatch.setattr(adamw, "_counts",
                        {"updates": 1, "launches": 1, "leaves": 1,
                         "elements": 1, "bytes": 28})
    ctx = window(2)
    ctx["host"] = [h for h in ctx["host"] if h[0] != "lm.update"]
    assert read("update_gbs", ctx) is None


def test_nothing_from_a_program_without_the_counter(monkeypatch):
    from kubernetes_tpu_torch import workloads
    monkeypatch.delattr(workloads, "adamw", raising=False)
    monkeypatch.setitem(sys.modules, "kubernetes_tpu_torch.workloads.adamw",
                        None)
    assert read("update_gbs", window(2)) is None


def test_the_fused_kernel_leaves_elementwise_ms():
    fused = "void (anonymous namespace)::adamw_kernel<unsigned short, true>" \
        "((anonymous namespace)::Table, (anonymous namespace)::Hyper)"
    ctx = {"kernels": [(fused, 0.0, 3000.0), ("rms_norm", 3000.0, 4000.0)],
           "steps": 1}
    assert read("elementwise_ms", ctx) == pytest.approx(1.0)
    ctx["kernels"] = ctx["kernels"][:1]
    assert read("elementwise_ms", ctx) is None
