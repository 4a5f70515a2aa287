"""Node GPU telemetry, as the per-chip ``tpu_*`` gauge family.

Counterpart of ``kubernetes_tpu/node/telemetry.py``, the DCGM-exporter
analog of the reference stack's GPU monitoring (DCGM -> Prometheus ->
Grafana): per-chip duty cycle, memory and link counters, health and
assignment from a node's stats (``chip_metrics`` of the device plugin:
``deviceplugin/gpu_plugin.py`` for GPUs), exported into the metrics
registry. The gauge family and series names stay ``tpu_*``: the
monitoring chain of the control plane (aggregator, alert rules, ``ktl
top``) reads those names, whatever the chip.

Series hygiene: a chip that disappears from the topology (plugin
restart, a card gone) has its labeled series REMOVED, not frozen at the
last value: a dashboard reading a dead chip's stale duty cycle is worse
than a gap.
"""
from __future__ import annotations

from ..metrics.registry import Gauge

TPU_DUTY_CYCLE = Gauge(
    "tpu_duty_cycle_pct",
    "Per-chip compute duty cycle over the last sample window (%)",
    labels=("node", "chip"))

TPU_HBM_USED = Gauge(
    "tpu_hbm_used_bytes",
    "Per-chip HBM bytes in use",
    labels=("node", "chip"))

TPU_HBM_TOTAL = Gauge(
    "tpu_hbm_total_bytes",
    "Per-chip HBM capacity in bytes",
    labels=("node", "chip"))

TPU_ICI_TX = Gauge(
    "tpu_ici_tx_bytes",
    "Cumulative ICI bytes transmitted per chip (driver counter)",
    labels=("node", "chip"))

TPU_ICI_RX = Gauge(
    "tpu_ici_rx_bytes",
    "Cumulative ICI bytes received per chip (driver counter)",
    labels=("node", "chip"))

TPU_ICI_LINKS = Gauge(
    "tpu_ici_links_up",
    "ICI links up per chip (torus degree; 0 = isolated/unhealthy)",
    labels=("node", "chip"))

TPU_CHIP_HEALTHY = Gauge(
    "tpu_chip_healthy",
    "1 when the device plugin reports the chip Healthy",
    labels=("node", "chip"))

TPU_CHIP_ASSIGNED = Gauge(
    "tpu_chip_assigned",
    "1 when a live pod holds the chip",
    labels=("node", "chip"))

TPU_LIBTPU_HEALTH = Gauge(
    "tpu_libtpu_probe_healthy",
    "1 when the node's TPU runtime probe (libtpu / driver sim) is "
    "reporting a topology",
    labels=("node",))

#: Per-metric exported chip label sets, for stale-series removal.
_exported: dict[str, set[tuple[str, str]]] = {}

_CHIP_GAUGES = {
    "duty_cycle_pct": TPU_DUTY_CYCLE,
    "hbm_used_bytes": TPU_HBM_USED,
    "hbm_total_bytes": TPU_HBM_TOTAL,
    "ici_tx_bytes": TPU_ICI_TX,
    "ici_rx_bytes": TPU_ICI_RX,
    "ici_links": TPU_ICI_LINKS,
}


def export_tpu_stats(node_name: str, tpu: dict) -> None:
    """Publish one node's summary ``tpu`` section (stats.py
    ``tpu_stats`` shape) into the ``tpu_*`` family."""
    chips = tpu.get("chips") or []
    TPU_LIBTPU_HEALTH.set(1.0 if chips else 0.0, node=node_name)
    seen: set[tuple[str, str]] = set()
    for chip in chips:
        labels = {"node": node_name, "chip": chip["id"]}
        seen.add((node_name, chip["id"]))
        TPU_CHIP_HEALTHY.set(
            1.0 if chip.get("health") == "Healthy" else 0.0, **labels)
        TPU_CHIP_ASSIGNED.set(
            1.0 if chip.get("assigned_to") else 0.0, **labels)
        for key, gauge in _CHIP_GAUGES.items():
            if key in chip:
                gauge.set(float(chip[key]), **labels)
    # Drop series for chips this node no longer reports.
    stale = _exported.get(node_name, set()) - seen
    for node, chip in stale:
        for gauge in (TPU_CHIP_HEALTHY, TPU_CHIP_ASSIGNED,
                      *_CHIP_GAUGES.values()):
            gauge.remove(node=node, chip=chip)
    _exported[node_name] = seen
