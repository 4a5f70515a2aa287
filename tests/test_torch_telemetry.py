"""The port's node telemetry against the reference's, on the CPU.

The same stats dicts go through both ``export_tpu_stats``; every gauge
of the ``tpu_*`` family must then hold the same series with the same
values, in both registries, including the removal of a chip's series
when the chip leaves the node's stats. Each test uses node names of its
own: the gauges are process-wide in both packages.
"""
import pytest

from kubernetes_tpu.metrics.registry import REGISTRY as JAX_REGISTRY
from kubernetes_tpu.node import telemetry as jax_tel
from kubernetes_tpu_torch.metrics.registry import REGISTRY
from kubernetes_tpu_torch.node import telemetry as torch_tel

GAUGES = ["TPU_DUTY_CYCLE", "TPU_HBM_USED", "TPU_HBM_TOTAL", "TPU_ICI_TX",
          "TPU_ICI_RX", "TPU_ICI_LINKS", "TPU_CHIP_HEALTHY",
          "TPU_CHIP_ASSIGNED", "TPU_LIBTPU_HEALTH"]


def _chip(i, **extra):
    return {"id": f"gpu-{i}", "health": "Healthy", "assigned_to": "",
            "hbm_total_bytes": 85520809984, "hbm_used_bytes": 1000 * i,
            **extra}


def _series(module, node):
    """{gauge name: {labels: value}} of ``node``'s series."""
    out = {}
    for attr in GAUGES:
        gauge = getattr(module, attr)
        out[gauge.name] = {key: gauge.value(**dict(zip(gauge.label_names,
                                                       key)))
                           for key in gauge.labeled_keys() if key[0] == node}
    return out


def _export_both(node, tpu):
    jax_tel.export_tpu_stats(node, tpu)
    torch_tel.export_tpu_stats(node, tpu)
    return _series(jax_tel, node), _series(torch_tel, node)


def test_same_gauge_family():
    for attr in GAUGES:
        ref, got = getattr(jax_tel, attr), getattr(torch_tel, attr)
        assert (got.name, got.help, got.label_names) == (
            ref.name, ref.help, ref.label_names)
        assert REGISTRY.get(got.name) is got


@pytest.mark.parametrize("stats", [
    {"chips": [_chip(0), _chip(1, assigned_to="default/p")]},
    {"chips": [_chip(0, health="Unhealthy", duty_cycle_pct=0.0,
                     ici_links=0),
               _chip(1, duty_cycle_pct=52.0, ici_tx_bytes=7, ici_rx_bytes=9,
                     ici_links=6)]},
    {"chips": []},
    {},
], ids=["two", "sick_and_busy", "no_chips", "no_section"])
def test_same_series_for_the_same_stats(stats, request):
    node = request.node.name
    ref, got = _export_both(node, stats)
    assert got == ref
    assert got["tpu_libtpu_probe_healthy"] == {
        (node,): 1.0 if stats.get("chips") else 0.0}


def test_a_chip_that_leaves_loses_its_series_in_both():
    node = "n-removal"
    _export_both(node, {"chips": [_chip(0), _chip(1)]})
    ref, got = _export_both(node, {"chips": [_chip(1)]})
    assert got == ref
    for name, series in got.items():
        assert all(key[1] != "gpu-0" for key in series if len(key) > 1), name
    assert got["tpu_hbm_total_bytes"] == {(node, "gpu-1"): 85520809984.0}
    ref, got = _export_both(node, {"chips": []})
    assert got == ref
    assert all(not s for n, s in got.items()
               if n != "tpu_libtpu_probe_healthy")


def test_rendered_exposition_matches():
    node = "n-render"
    _export_both(node, {"chips": [_chip(3, duty_cycle_pct=12.5)]})
    for attr in GAUGES:
        ref = [ln for ln in getattr(jax_tel, attr).render().splitlines()
               if ln.startswith("#") or f'node="{node}"' in ln]
        got = [ln for ln in getattr(torch_tel, attr).render().splitlines()
               if ln.startswith("#") or f'node="{node}"' in ln]
        assert got == ref, attr
    assert JAX_REGISTRY.get("tpu_duty_cycle_pct") is jax_tel.TPU_DUTY_CYCLE
