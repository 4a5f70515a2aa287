"""The readers of the port's spans (``metrics/_spans.py`` and the
metrics that use it) on synthetic traced windows: each device event
goes to the span whose interval holds its launch call, nested spans
hold what their parents hold, the recompute is the layers inside the
backward, a kernel launched outside every span goes to none, and a
window whose launches and device events do not pair off, or that has no
span (the program before its spans), reads nothing."""
import pytest

from portbench import spec
from portbench.metrics import _spans

#: One step as the host runs it: spans ``(name, start, end)`` and launch
#: calls ``(host_time, call, device_name, device_us)``, in microseconds.
#: Two layers; the backward's first layer is remat's recompute, its
#: launches on autograd's thread; the batch of the next step is launched
#: after the update, outside every span.
SPANS = [
    ("lm.forward", 0, 100), ("lm.layer", 10, 40), ("attention.fwd", 20, 30),
    ("lm.layer", 50, 80), ("attention.fwd", 60, 70),
    ("lm.backward", 100, 300), ("lm.layer", 110, 140),
    ("attention.fwd", 120, 130), ("attention.bwd", 150, 170),
    ("lm.grad_sync", 300, 320), ("lm.update", 320, 400),
]
LAUNCHES = [
    (5, "cudaLaunchKernel", "embed", 100),
    (15, "cudaLaunchKernel", "nvjet_qkv", 200),
    (25, "cudaLaunchKernel", "flash_fwd_kernel", 300),
    (35, "cudaLaunchKernel", "nvjet_wo", 400),
    (55, "cudaLaunchKernel", "rms_norm", 500),
    (65, "cudaLaunchKernel", "flash_fwd_kernel", 600),
    (90, "cudaMemsetAsync", "Memset (Device)", 700),
    (105, "cudaLaunchKernel", "xent_bwd", 800),
    (115, "cudaLaunchKernel", "rms_norm", 900),
    (125, "cudaLaunchKernel", "flash_fwd_kernel", 1000),
    (160, "cudaLaunchKernel", "flash_bwd_dq_kernel", 1100),
    (200, "cudaLaunchKernel", "nvjet_dw", 1200),
    (305, "cudaLaunchKernel", "cat", 1300),
    (310, "cuLaunchKernelEx", "ncclDevKernel_AllReduce", 1400),
    (330, "cudaLaunchKernel", "to_f32", 1500),
    (340, "cudaMemcpyAsync", "Memcpy DtoD (Device -> Device)", 1600),
    (350, "cudaLaunchKernel", "multi_tensor_apply_kernel", 1700),
    (410, "cudaLaunchKernel", "randint", 1800),
]


def window(steps: int = 1, drop: str = "") -> dict:
    """``steps`` copies of the step as ``trace.traced_steps`` reduces
    them: the host's events, the device's in launch order, each starting
    well after its launch (the host runs ahead); ``drop`` leaves out the
    device events so named."""
    host, kernels, clock = [], [], 10_000.0
    for i in range(steps):
        at = i * 1000
        host += [(n, at + s, at + e) for n, s, e in SPANS]
        host += [(call, at + t, at + t + 2) for t, call, _, _ in LAUNCHES]
        host += [("aten::mm", at + 14, at + 16)]
        for _, _, name, us in LAUNCHES:
            if name != drop:
                kernels.append((name, clock, clock + us))
            clock += us + 5
    return {"host": host, "kernels": kernels, "steps": steps,
            "step_spans": [(i * 1000, i * 1000 + 420) for i in range(steps)],
            "window_s": 1.0}


def read(name: str, ctx: dict):
    return spec.module("metrics", name).read(ctx)


def us(name: str, ctx: dict) -> float:
    """A reader's ms per step, in microseconds."""
    return pytest.approx(read(name, ctx) * 1e3)


def test_launches_pair_with_device_events_by_kind_in_order():
    got = _spans.launched(window())
    assert len(got) == len(LAUNCHES)
    by_start = {s: t for t, s, _ in got}
    kernels = window()["kernels"]
    for (name, s, _), (t, _, want, _) in zip(kernels, LAUNCHES):
        assert name == want and by_start[s] == t


@pytest.mark.parametrize("steps", [1, 3])
def test_each_phase_holds_what_it_launched(steps):
    ctx = window(steps)
    assert 100 + 200 + 300 + 400 + 500 + 600 + 700 == us("forward_ms", ctx)
    assert 800 + 900 + 1000 + 1100 + 1200 == us("backward_ms", ctx)
    assert 1300 + 1400 == us("grad_sync_ms", ctx)
    assert 1500 + 1600 + 1700 == us("update_ms", ctx)


def test_nested_spans_and_the_recompute():
    ctx = window(2)
    # The layer inside the backward (autograd's thread): its norm and
    # its attention's forward kernel; not the backward kernels after it.
    assert 900 + 1000 == us("recompute_ms", ctx)
    # Attention: the forward's two launches, the recompute's, the dQ.
    assert 300 + 600 + 1000 + 1100 == us("attention_ms", ctx)


def test_a_kernel_launched_outside_every_span_goes_to_none():
    ctx = window(2)
    phases = sum(read(n, ctx) for n in ("forward_ms", "backward_ms",
                                        "grad_sync_ms", "update_ms"))
    total = sum(e - s for _, s, e in ctx["kernels"]) * 1e-3 / ctx["steps"]
    assert total - phases == pytest.approx(1800 * 1e-3)


def test_grad_sync_rate_from_the_programs_counter(monkeypatch):
    from kubernetes_tpu_torch.workloads import collectives
    monkeypatch.setattr(collectives, "_exchanged",
                        {"exchanges": 4, "calls": 8, "bytes": 4 * 2.7e9})
    # 2.7e9 bytes a step over 2.7 ms.
    assert read("grad_sync_gbs", window(2)) == pytest.approx(1000.0)
    monkeypatch.setattr(collectives, "_exchanged",
                        {"exchanges": 0, "calls": 0, "bytes": 0})
    assert read("grad_sync_gbs", window(2)) is None


NEW = ("forward_ms", "backward_ms", "recompute_ms", "update_ms",
       "attention_ms", "grad_sync_ms", "grad_sync_gbs")


@pytest.mark.parametrize("name", NEW)
def test_nothing_without_spans_or_a_pairing(name):
    parent = window(2)
    parent["host"] = [h for h in parent["host"]
                      if not h[0].startswith(("lm.", "attention."))]
    assert read(name, parent) is None
    assert read(name, window(2, drop="cat")) is None


@pytest.mark.parametrize("name", NEW)
def test_span_readers_name_no_kernels(name):
    """No reader of a span names kernels, so ``elementwise_ms`` reads
    what it read before they came."""
    assert not hasattr(spec.module("metrics", name), "KERNELS")
