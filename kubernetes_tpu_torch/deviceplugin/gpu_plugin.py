"""The GPU device plugin: advertises the host's NVIDIA GPUs, one by one.

Counterpart of ``kubernetes_tpu/deviceplugin/tpu_plugin.py``, and of
the out-of-tree nvidia-gpu-device-plugin that the reference deploys
(``cluster/addons/device-plugins/nvidia-gpu/daemonset.yaml``). Each GPU
is a chip ``gpu-<index>`` at coords (index, 0, 0) of an [n, 1, 1] mesh,
so the scheduler picks device IDs and the node agent hands the picked
ones to the container.

Enumeration runs in a short-lived probe subprocess with one JSON line
of output: the NVML probe (``native/nvml_probe.cpp``) first, then a
``torch.cuda`` probe with the same contract, as the reference keeps its
jax probe behind its libtpu probe. The plugin process itself never
creates a CUDA context.

``InitContainer`` sets ``CUDA_VISIBLE_DEVICES`` to the assigned GPUs'
UUIDs, where the reference sets ``TPU_VISIBLE_DEVICES``. NVML numbers
GPUs in PCI bus order while CUDA's default order is fastest first, so
an index could name another card; a UUID cannot be misread. It also
sets ``CUDA_DEVICE_ORDER=PCI_BUS_ID``. A payload then takes ``cuda:0``
as its card (``workloads/trainer.py``).

The resource name is the one the control plane places chips for,
``google.com/tpu``, unless the caller names another.

Nothing here imports ``grpc`` or ``protobuf``: the probe, the topology
and the container env are plain Python, and only :meth:`serve` and the
RPC methods of ``deviceplugin/stub.py`` reach the gRPC edge.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
from typing import Optional

from .. import native
from .stub import Chip, StubGpuPlugin, Topology

RESOURCE = "google.com/tpu"
#: Seconds the probe chain may take (the NVML probe at most half).
PROBE_TIMEOUT_S = 120.0

#: The fallback probe: ``torch.cuda`` in a subprocess, in PCI bus order
#: like NVML, printing the NVML probe's JSON contract.
_TORCH_PROBE_SRC = r"""
import json, sys
try:
    import torch
    n = torch.cuda.device_count()
except Exception as e:  # noqa: BLE001
    print(json.dumps({"gpu": False, "error": str(e), "source": "torch_probe"}))
    sys.exit(0)
if n == 0:
    print(json.dumps({"gpu": False, "error": "torch sees no CUDA device",
                      "source": "torch_probe"}))
    sys.exit(0)
devices = []
for i in range(n):
    p = torch.cuda.get_device_properties(i)
    free, total = torch.cuda.mem_get_info(i)
    devices.append({"index": i, "kind": p.name, "uuid": "GPU-%s" % p.uuid,
                    "coords": [i, 0, 0],
                    "memory": {"hbm_used_bytes": total - free,
                               "hbm_total_bytes": total}})
print(json.dumps({"gpu": True, "source": "torch_probe", "process_index": 0,
                  "devices": devices}))
"""


def _probe_env() -> dict:
    """The env a probe runs under: every GPU of the host, in PCI bus
    order."""
    env = {k: v for k, v in os.environ.items()
           if k != "CUDA_VISIBLE_DEVICES"}
    env["CUDA_DEVICE_ORDER"] = "PCI_BUS_ID"
    return env


def run_probe(cmd: list, timeout: float) -> Optional[dict]:
    """The JSON verdict of one probe command, ``{"gpu": false, ...}``
    included; None when it crashed, hung past ``timeout`` or printed no
    JSON."""
    try:
        proc = subprocess.run(cmd, env=_probe_env(), capture_output=True,
                              text=True, timeout=timeout)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        return None
    try:
        return json.loads(lines[-1])
    except json.JSONDecodeError:
        return None


def nvml_probe_command(library: Optional[str] = None) -> list:
    """The NVML probe's command line, building it if needed (raises
    when g++ is missing or fails); ``library`` is the NVML library to
    open, else ``libnvidia-ml.so.1``."""
    return [native.build("nvml_probe")] + ([library] if library else [])


def torch_probe_command() -> list:
    return [sys.executable, "-c", _TORCH_PROBE_SRC]


def detect_topology(library: Optional[str] = None) -> Optional[dict]:
    """The probe dict of the host's GPUs, or None when it has none.

    The NVML probe of ``library`` first, with at most half of
    :data:`PROBE_TIMEOUT_S` (its build, once, outside it); then the
    torch probe with what is left."""
    cmd = nvml_probe_command(library)
    deadline = time.monotonic() + PROBE_TIMEOUT_S
    probe = run_probe(cmd, PROBE_TIMEOUT_S / 2)
    if probe and probe.get("gpu"):
        return probe
    remaining = deadline - time.monotonic()
    if remaining <= 0:
        return None
    probe = run_probe(torch_probe_command(), remaining)
    return probe if probe and probe.get("gpu") else None


def _chip_type_of(kind: str) -> str:
    """The model of an NVIDIA name: 'NVIDIA H100 80GB HBM3' -> 'h100',
    'NVIDIA A100-SXM4-80GB' -> 'a100', 'Tesla V100-SXM2-16GB' -> 'v100';
    else the whole name as a slug."""
    words = [w for w in re.split(r"[\s_-]+", kind.lower()) if w]
    for word in words:
        if re.fullmatch(r"[a-z]{1,2}\d{2,3}[a-z]?", word):
            return word
    return "-".join(words)


def topology_from_probe(probe: dict, slice_id: str = "") -> Topology:
    """Each GPU a chip ``gpu-<index>`` at its coords, the id the runtime
    hook resolves; the mesh bounds the coords ([n, 1, 1] for n GPUs)."""
    devices = probe["devices"]
    bounds = [1, 1, 1]
    for d in devices:
        for i, c in enumerate(d["coords"][:3]):
            bounds[i] = max(bounds[i], c + 1)
    chip_type = _chip_type_of(devices[0]["kind"])
    chips = [Chip(id=f"gpu-{d['index']}", coords=list(d["coords"][:3]),
                  attributes={"chip_type": chip_type,
                              "device_kind": d["kind"],
                              "device_index": str(d["index"]),
                              "uuid": d.get("uuid", "")})
             for d in devices]
    return Topology(chip_type=chip_type,
                    slice_id=slice_id or f"slice-{os.uname().nodename}",
                    mesh_shape=bounds,
                    worker_index=int(probe.get("process_index", 0)),
                    chips=chips)


class GpuDevicePlugin(StubGpuPlugin):
    """The plugin in front of the host's GPUs: the probe's topology, and
    the env that points a container at the GPUs it was given."""

    #: Real hardware: the chaos driver (``kubernetes_tpu/chaos/driver.py``)
    #: must not flip its chips' health.
    chaos_drivable = False

    def __init__(self, probe: Optional[dict] = None,
                 resource: str = RESOURCE, slice_id: str = "",
                 library: Optional[str] = None):
        probe = probe or detect_topology(library=library)
        if probe is None:
            raise RuntimeError("no NVIDIA GPU found on this host (both "
                               "probes failed)")
        super().__init__(topology_from_probe(probe, slice_id=slice_id),
                         resource=resource)
        self._probe = probe
        self._uuid = {c.id: c.attributes["uuid"] for c in self._topology.chips}

    def chip_metrics(self) -> dict:
        """Per-chip memory from the probe, under the keys of the
        reference plugin (``tpu_plugin.py:207-224``): the capacity, and
        the bytes in use when the plugin started (not a live reading:
        the plugin does not poll the driver on a scrape)."""
        out = {}
        for d in self._probe.get("devices", []):
            mem = d.get("memory")
            if mem and mem.get("hbm_total_bytes"):
                out[f"gpu-{d['index']}"] = {
                    "hbm_total_bytes": mem["hbm_total_bytes"],
                    "hbm_used_at_probe_bytes": mem.get("hbm_used_bytes", 0),
                }
        return out

    def container_env(self, chip_ids) -> dict:
        env = super().container_env(chip_ids)
        env["CUDA_VISIBLE_DEVICES"] = ",".join(
            self._uuid[c] for c in chip_ids if c in self._uuid)
        env["CUDA_DEVICE_ORDER"] = "PCI_BUS_ID"
        return env


def main() -> None:
    """Serve the plugin in a node agent's plugin directory:
    ``python -m kubernetes_tpu_torch.deviceplugin.gpu_plugin <dir>``."""
    import signal
    import threading

    plugin_dir = (sys.argv[1] if len(sys.argv) > 1
                  else "/var/lib/ktpu/device-plugins")
    plugin = GpuDevicePlugin()
    sock = os.path.join(plugin_dir, "gpu.sock")
    plugin.serve(sock)
    print(json.dumps({"serving": sock, "chips": len(plugin._topology.chips),
                      "chip_type": plugin._topology.chip_type}), flush=True)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    stop.wait()
    plugin.stop()


if __name__ == "__main__":
    main()
