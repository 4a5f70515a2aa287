"""The MoE permutation's rate, ``moe_permute_gbs``: the bytes that the
program's MoE counter gives a launch of the permutation kernels, times
the spans ``moe.dispatch``, ``moe.dispatch.bwd``, ``moe.combine`` and
``moe.combine.bwd`` of a traced window (one launch each), over their
device time; nothing without the counter (the program before its
kernels), without a launch or without the spans. Its ``KERNELS`` take
the two kernels out of ``elementwise_ms``."""
import sys

import pytest

from portbench import spec

#: One sparse layer's step as the host runs it, in microseconds: its
#: route, forward and remat's recompute, then the backward, each span
#: with its launches ``(host_time, device_name, device_us)``.
STEP = [
    (("moe.route", 0, 10), [(5, "topk", 50)]),
    (("moe.dispatch", 10, 20), [(15, "moe_scatter_rows_kernel<8>", 100)]),
    (("moe.experts", 20, 30), [(25, "GroupProblemShape", 900)]),
    (("moe.combine", 30, 40), [(35, "moe_gather_reduce_kernel<8, true>",
                                110)]),
    (("moe.route", 100, 110), [(105, "topk", 50)]),
    (("moe.dispatch", 110, 120), [(115, "moe_scatter_rows_kernel<8>", 100)]),
    (("moe.combine", 130, 140), [(135, "moe_gather_reduce_kernel<8, true>",
                                  110)]),
    (("moe.combine.bwd", 150, 160), [(155, "moe_scatter_rows_kernel<8, "
                                           "true, true>", 190)]),
    (("moe.dispatch.bwd", 170, 180), [(175, "moe_gather_reduce_kernel<8, "
                                            "false>", 100)]),
]


def window(steps: int) -> dict:
    host, kernels, clock = [], [], 10_000.0
    for i in range(steps):
        at = i * 1000
        for (name, s, e), launches in STEP:
            host.append((name, at + s, at + e))
            for t, kernel, us in launches:
                host.append(("cudaLaunchKernel", at + t, at + t + 1))
                kernels.append((kernel, clock, clock + us))
                clock += us + 5
    return {"host": host, "kernels": kernels, "steps": steps}


def read(name, ctx):
    return spec.module("metrics", name).read(ctx)


def _counts(launches: int, nbytes: float) -> dict:
    return {"layers": 2, "rows": 8, "gemm_calls": 0, "gemm_rows": 0,
            "max_rows": 0, "permute_launches": launches,
            "permute_bytes": nbytes}


def test_rate_from_the_programs_counter(monkeypatch):
    from kubernetes_tpu_torch.workloads import moe
    # Three steps of 6 launches, 1e8 bytes each: 6e8 bytes a step over
    # the spans' 710 us.
    monkeypatch.setattr(moe, "_counts", _counts(18, 18e8))
    assert read("moe_permute_gbs", window(3)) == pytest.approx(
        6e8 / 710e-6 * 1e-9)
    # moe_dispatch_ms holds the same spans and the route's.
    assert read("moe_dispatch_ms", window(3)) == pytest.approx(0.81)


def test_nothing_without_a_launch_or_the_spans(monkeypatch):
    from kubernetes_tpu_torch.workloads import moe
    monkeypatch.setattr(moe, "_counts", _counts(0, 0))
    assert read("moe_permute_gbs", window(2)) is None
    monkeypatch.setattr(moe, "_counts", _counts(12, 12e8))
    ctx = window(2)
    ctx["host"] = [h for h in ctx["host"]
                   if not h[0].startswith(("moe.dispatch", "moe.combine"))]
    assert read("moe_permute_gbs", ctx) is None


def test_nothing_from_a_program_without_the_counter(monkeypatch):
    from kubernetes_tpu_torch.workloads import moe
    counts = _counts(0, 0)
    del counts["permute_launches"], counts["permute_bytes"]
    monkeypatch.setattr(moe, "_counts", counts)
    assert read("moe_permute_gbs", window(2)) is None
    from kubernetes_tpu_torch import workloads
    monkeypatch.delattr(workloads, "moe", raising=False)
    monkeypatch.setitem(sys.modules, "kubernetes_tpu_torch.workloads.moe",
                        None)
    assert read("moe_permute_gbs", window(2)) is None


@pytest.mark.parametrize("kernel", [
    "void (anonymous namespace)::moe_gather_reduce_kernel<8, true>("
    "unsigned short const*, int const*, float const*, unsigned short*, int, "
    "int, long)",
    "void (anonymous namespace)::moe_scatter_rows_kernel<8, true, true>("
    "unsigned short const*, int const*, float const*, unsigned short const*, "
    "unsigned short*, float*, int, int, long)"])
def test_the_kernels_leave_elementwise_ms(kernel):
    ctx = {"kernels": [(kernel, 0.0, 3000.0), ("rms_norm", 3000.0, 4000.0)],
           "steps": 1}
    assert read("elementwise_ms", ctx) == pytest.approx(1.0)
    ctx["kernels"] = ctx["kernels"][:1]
    assert read("elementwise_ms", ctx) is None
