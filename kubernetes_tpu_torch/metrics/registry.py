"""A Prometheus-style gauge with labels, and the registry it joins.

The port's copy of what ``kubernetes_tpu/node/telemetry.py`` takes from
``kubernetes_tpu/metrics/registry.py``: ``Gauge`` (set, read, remove a
labeled series, render in the text exposition format) and the
process-wide :data:`REGISTRY`.
"""
from __future__ import annotations

import threading
from typing import Optional, Sequence


def _label_key(label_names: Sequence[str], labels: dict) -> tuple:
    return tuple(str(labels.get(n, "")) for n in label_names)


def _fmt_labels(names: Sequence[str], values: tuple) -> str:
    parts = [f'{n}="{v}"' for n, v in zip(names, values)]
    return "{" + ",".join(parts) + "}" if parts else ""


class Gauge:
    def __init__(self, name: str, help_: str = "",
                 labels: Sequence[str] = (),
                 registry: Optional["MetricsRegistry"] = None):
        self.name = name
        self.help = help_
        self.label_names = tuple(labels)
        self._lock = threading.Lock()
        self._values: dict[tuple, float] = {}
        (registry if registry is not None else REGISTRY).register(self)

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[_label_key(self.label_names, labels)] = value

    def value(self, **labels) -> float:
        return self._values.get(_label_key(self.label_names, labels), 0.0)

    def remove(self, **labels) -> None:
        """Drop one labeled series: a gauge of an object that is gone
        stops being exported instead of freezing at its last value."""
        with self._lock:
            self._values.pop(_label_key(self.label_names, labels), None)

    def labeled_keys(self) -> list[tuple]:
        with self._lock:
            return list(self._values)

    def render(self) -> str:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} gauge"]
        with self._lock:
            for key, v in sorted(self._values.items()):
                lines.append(
                    f"{self.name}{_fmt_labels(self.label_names, key)} {v:g}")
        return "\n".join(lines)


class MetricsRegistry:
    def __init__(self) -> None:
        self._metrics: dict[str, Gauge] = {}
        self._lock = threading.Lock()

    def register(self, m: Gauge) -> None:
        with self._lock:
            # The first registration of a name wins, so a module loaded
            # twice shares its gauges.
            self._metrics.setdefault(m.name, m)

    def get(self, name: str) -> Optional[Gauge]:
        return self._metrics.get(name)


#: The process-wide registry.
REGISTRY = MetricsRegistry()
