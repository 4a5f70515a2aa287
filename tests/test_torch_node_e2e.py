"""The GPU node layer through the reference control plane.

Port of ``tests/e2e/test_real_tpu.py`` (reference:
``test/e2e/scheduling/nvidia-gpus.go``): deploy the device plugin, wait
for the node's advertised capacity, run pods on the advertised GPUs.
``LocalCluster`` builds a real-hardware node's plugin and hook from
``kubernetes_tpu.deviceplugin.tpu_plugin.TpuDevicePlugin`` and
``kubernetes_tpu.node.runtimehook.TpuRuntimeHook``, looked up when the
node starts; the tests put factories of the port's plugin and hook in
their place.

- On the CPU, against a stub NVML library of two H100s: the node's
  capacity is 2, and a pod created over HTTP for one chip is scheduled,
  admitted and started with the assigned GPU's UUID in
  ``CUDA_VISIBLE_DEVICES``.
- Marked ``cuda``, on the host's real NVML: the capacity is the GPU
  count, and the vector-add pod completes on the card on every
  advertised GPU (each pod pinned to one by the chip attribute
  ``device_index``), each seeing the GPU it was given. It skips without a
  card or without ``grpc``, and is a plain function (the coroutine
  hook of ``tests/conftest.py`` is not needed), so it also runs under
  ``--noconftest``.
"""
import asyncio
import importlib.util
import json
import sys
import tempfile

import pytest

from kubernetes_tpu.api import types as t
from kubernetes_tpu.api.meta import ObjectMeta
from kubernetes_tpu.api.selectors import Requirement
from kubernetes_tpu.cluster import LocalCluster
from kubernetes_tpu.cluster.local import NodeSpec
from kubernetes_tpu_torch.deviceplugin import gpu_plugin
from kubernetes_tpu_torch.node.runtimehook import GpuRuntimeHook

NODE = "gpu-node-0"


@pytest.fixture
def short_dir():
    """The cluster's data dir: short, since the plugin's unix socket
    path under it must fit in 107 characters."""
    with tempfile.TemporaryDirectory(prefix="g") as d:
        yield d


def _use_port_node_layer(monkeypatch, library=None):
    """Make the cluster's real-hardware node take the port's plugin (on
    ``library``'s NVML) and hook."""
    from kubernetes_tpu.deviceplugin import tpu_plugin
    from kubernetes_tpu.node import runtimehook

    def plugin(slice_id=""):
        return gpu_plugin.GpuDevicePlugin(library=library, slice_id=slice_id)

    def hook(allow_missing_devices=True):
        return GpuRuntimeHook(allow_missing_devices=allow_missing_devices,
                              library=library)
    monkeypatch.setattr(tpu_plugin, "TpuDevicePlugin", plugin)
    monkeypatch.setattr(runtimehook, "TpuRuntimeHook", hook)


def _pod(name, command, image="inline", index=None):
    """A pod of one chip; with ``index``, pinned by the chip attribute
    ``device_index`` to that GPU."""
    pin = [] if index is None else [Requirement(key="device_index",
                                                values=[str(index)])]
    return t.Pod(
        metadata=ObjectMeta(name=name, namespace="default"),
        spec=t.PodSpec(
            restart_policy="Never",
            containers=[t.Container(name="main", image=image,
                                    command=command, tpu_requests=["gpu"])],
            tpu_resources=[t.PodTpuRequest(name="gpu", chips=1,
                                           affinity=pin)]))


async def _finish(client, name, timeout=90.0):
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while loop.time() < deadline:
        pod = await client.get("pods", "default", name)
        if pod.status.phase in (t.POD_SUCCEEDED, t.POD_FAILED):
            return pod
        await asyncio.sleep(0.2)
    raise TimeoutError(f"pod {name} did not finish")


async def _run_pods(data_dir, pods, want_capacity):
    """Start a one-node cluster, check the node's capacity, run ``pods``
    one after the other; ``[(pod, its last log line)]``."""
    cluster = LocalCluster(data_dir=data_dir, tls=False,
                           nodes=[NodeSpec(name=NODE, real_tpu=True)],
                           status_interval=0.3, heartbeat_interval=0.3)
    await cluster.start()
    client = cluster.make_client()
    try:
        await cluster.wait_for_nodes_ready(timeout=30)
        node = await client.get("nodes", "", NODE)
        for _ in range(100):
            if node.status.capacity.get(t.RESOURCE_TPU):
                break
            await asyncio.sleep(0.1)
            node = await client.get("nodes", "", NODE)
        assert node.status.capacity.get(t.RESOURCE_TPU) == want_capacity
        assert len(node.status.tpu.chips) == want_capacity
        out = []
        for pod in pods:
            await client.create(pod)
            final = await _finish(client, pod.metadata.name)
            cid = final.status.container_statuses[0].container_id
            logs = await cluster.nodes[0].runtime.container_logs(cid)
            assert final.status.phase == t.POD_SUCCEEDED, logs
            out.append((final, logs.strip().splitlines()[-1]))
        return out
    finally:
        await client.close()
        await cluster.stop()


async def test_pod_gets_its_gpu_uuid_over_http(tmp_path, short_dir,
                                               monkeypatch):
    from tests.test_torch_nvml_probe import TWO_H100, build_stub_nvml
    lib = build_stub_nvml(str(tmp_path))
    _use_port_node_layer(monkeypatch, library=lib)
    show = [sys.executable, "-c", "import json, os; print(json.dumps("
            "{k: os.environ[k] for k in ('CUDA_VISIBLE_DEVICES', "
            "'CUDA_DEVICE_ORDER', 'TPU_VISIBLE_CHIPS')}))"]
    [(pod, line)] = await _run_pods(short_dir,
                                    [_pod("show-gpu", show)], 2.0)
    [chip] = pod.spec.tpu_resources[0].assigned
    assert pod.spec.node_name == NODE and chip in ("gpu-0", "gpu-1")
    uuid = TWO_H100["devices"][int(chip.split("-")[1])]["uuid"]
    assert json.loads(line) == {"CUDA_VISIBLE_DEVICES": uuid,
                                "CUDA_DEVICE_ORDER": "PCI_BUS_ID",
                                "TPU_VISIBLE_CHIPS": chip}


@pytest.mark.cuda
def test_vector_add_on_every_advertised_gpu(short_dir, monkeypatch):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    if importlib.util.find_spec("grpc") is None:
        pytest.skip("grpc is not installed: the plugin cannot be served")
    probe = gpu_plugin.detect_topology()
    assert probe is not None and probe["source"] == "nvml_probe", probe
    n = len(probe["devices"])
    _use_port_node_layer(monkeypatch)
    command = [sys.executable, "-m", "kubernetes_tpu_torch.workloads.vector_add"]
    pods = [_pod(f"vector-add-{i}", command, image="cuda-vector-add", index=i)
            for i in range(n)]
    done = asyncio.run(_run_pods(short_dir, pods, float(n)))
    given = set()
    for pod, line in done:
        report = json.loads(line)
        [chip] = pod.spec.tpu_resources[0].assigned
        index = int(chip.split("-")[1])
        assert pod.metadata.name == f"vector-add-{index}"
        assert report["ok"] is True and report["platform"] == "cuda", report
        assert report["uuid"] == probe["devices"][index]["uuid"], report
        given.add(chip)
    assert len(given) == n
