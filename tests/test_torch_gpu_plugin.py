"""The port's GPU device plugin, served on a socket and read by the
reference's node agent, on the CPU.

The plugin enumerates a stub NVML library of two H100s (built by
``tests/test_torch_nvml_probe.py``'s helper) and serves the
device-plugin API; the reference ``DeviceManager`` connects to it as a
node agent does. Capacity, coordinates, admission and the container env
(the GPUs' UUIDs in ``CUDA_VISIBLE_DEVICES``) are checked through it and
through the port's own client, and ``chip_metrics`` against the
reference plugin's on the same probe dict.
"""
import asyncio
import concurrent.futures
import json
import os
import subprocess
import sys
import time

import pytest

from kubernetes_tpu.api import types as t
from kubernetes_tpu.api.meta import ObjectMeta
from kubernetes_tpu.chaos.driver import ChaosDriver
from kubernetes_tpu.deviceplugin.tpu_plugin import TpuDevicePlugin
from kubernetes_tpu.node.devicemanager import DeviceManager
from kubernetes_tpu_torch.deviceplugin import gpu_plugin
from kubernetes_tpu_torch.deviceplugin.service import DevicePluginClient

from tests.test_torch_nvml_probe import TWO_H100, build_stub_nvml

UUIDS = [d["uuid"] for d in TWO_H100["devices"]]


@pytest.fixture
def plugin(tmp_path):
    lib = build_stub_nvml(str(tmp_path))
    p = gpu_plugin.GpuDevicePlugin(library=lib, slice_id="slice-g")
    p.serve(str(tmp_path / "plugins" / "gpu.sock"))
    yield p
    p.stop()


def _pod(chips):
    return t.Pod(
        metadata=ObjectMeta(name="p", namespace="default", uid="u1"),
        spec=t.PodSpec(
            containers=[t.Container(name="main", tpu_requests=["gpu"])],
            tpu_resources=[t.PodTpuRequest(name="gpu", chips=len(chips),
                                           assigned=list(chips))]))


async def _ready(dm, timeout=10.0):
    await dm.start()
    await asyncio.wait_for(dm.ready.wait(), timeout)


async def test_reference_device_manager_reads_the_plugin(plugin, tmp_path):
    dm = DeviceManager(str(tmp_path / "plugins"), poll_interval=0.05)
    try:
        await _ready(dm)
        assert dm.capacity() == {"google.com/tpu": 2.0}
        topo = dm.topology()
        assert topo.chip_type == "h100" and topo.slice_id == "slice-g"
        assert topo.mesh_shape == [2, 1, 1]
        assert [(c.id, c.coords, c.health) for c in topo.chips] == [
            ("gpu-0", [0, 0, 0], t.TPU_HEALTHY),
            ("gpu-1", [1, 0, 0], t.TPU_HEALTHY)]
        assert [c.attributes["uuid"] for c in topo.chips] == UUIDS

        assert await dm.admit_pod(_pod(["gpu-1"])) is None
        reason = await dm.admit_pod(_pod(["gpu-7"]))
        assert "gpu-7" in reason

        env, mounts, devices, ann = await dm.container_options(
            _pod(["gpu-1"]), _pod(["gpu-1"]).spec.containers[0])
        assert env["CUDA_VISIBLE_DEVICES"] == UUIDS[1]
        assert env["CUDA_DEVICE_ORDER"] == "PCI_BUS_ID"
        assert env["TPU_VISIBLE_CHIPS"] == "gpu-1"
        assert env["TPU_CHIP_COORDS"] == "1,0,0"
        assert env["TPU_MESH_SHAPE"] == "2x1x1"
        assert (mounts, devices) == ([], [])
        assert ann == {"tpu.dev/chips": "gpu-1"}
    finally:
        await dm.stop()


def test_watch_stays_open_until_the_plugin_stops(plugin):
    """``ListAndWatch`` sends the topology, then holds the stream open
    (a node agent's watch) and ends it when the plugin stops."""
    client = DevicePluginClient(plugin.socket_path)
    try:
        stream = client.list_and_watch()
        assert [c.id for c in next(stream).chips] == ["gpu-0", "gpu-1"]
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            rest = pool.submit(list, stream)
            time.sleep(0.3)
            assert not rest.done()
            plugin.stop()
            assert rest.result(timeout=10) == []
    finally:
        client.close()


def test_the_ports_client_reads_the_plugin(plugin):
    client = DevicePluginClient(plugin.socket_path)
    try:
        assert client.get_plugin_info().resource == "google.com/tpu"
        first = next(iter(client.list_and_watch()))
        assert [c.id for c in first.chips] == ["gpu-0", "gpu-1"]
        assert list(first.mesh_shape) == [2, 1, 1]
        ok = client.admit_pod("default", "p", "u", ["gpu-0", "gpu-1"])
        assert ok.allowed
        no = client.admit_pod("default", "p", "u", ["gpu-2"])
        assert not no.allowed and "gpu-2" in no.reason
        resp = client.init_container("default", "p", "u", "main",
                                     ["gpu-1", "gpu-0"])
        assert resp.envs["CUDA_VISIBLE_DEVICES"] == f"{UUIDS[1]},{UUIDS[0]}"
        assert dict(resp.envs) == plugin.container_env(["gpu-1", "gpu-0"])
    finally:
        client.close()


def test_chip_metrics_match_the_reference_plugin():
    """The same probe dict through both plugins: per chip, the same
    keys and values (the reference names its chips tpu-<i>)."""
    ref = TpuDevicePlugin(probe=TWO_H100).chip_metrics()
    got = gpu_plugin.GpuDevicePlugin(probe=TWO_H100).chip_metrics()
    assert got == {f"gpu-{i}": ref[f"tpu-{i}"] for i in range(2)}
    assert set(got["gpu-0"]) == {"hbm_total_bytes", "hbm_used_at_probe_bytes"}


def test_real_hardware_is_not_driven_by_chaos():
    plugin = gpu_plugin.GpuDevicePlugin(probe=TWO_H100)
    assert ChaosDriver([plugin]).plugins == []


def test_no_gpu_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(gpu_plugin, "run_probe", lambda cmd, timeout: None)
    with pytest.raises(RuntimeError, match="no NVIDIA GPU"):
        gpu_plugin.GpuDevicePlugin()


#: Builds the plugin's topology, admission and container env where
#: ``grpc`` and ``protobuf`` cannot be imported.
_WITHOUT_GRPC = r"""
import json, sys
sys.modules["grpc"] = None
sys.modules["google.protobuf"] = None
from kubernetes_tpu_torch.deviceplugin import gpu_plugin
probe = json.loads(sys.argv[1])
plugin = gpu_plugin.GpuDevicePlugin(probe=probe)
print(json.dumps({"chips": [c.id for c in plugin._topology.chips],
                  "admit": plugin.admit(["gpu-0"]),
                  "env": plugin.container_env(["gpu-0"])}))
"""


def test_plugin_works_without_grpc_or_protobuf():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _WITHOUT_GRPC,
                           json.dumps(TWO_H100)], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["chips"] == ["gpu-0", "gpu-1"]
    assert out["admit"] == [True, ""]
    assert out["env"]["CUDA_VISIBLE_DEVICES"] == UUIDS[0]
