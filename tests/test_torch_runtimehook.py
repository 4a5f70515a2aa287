"""The port's GPU runtime hook: the native binary against the Python
discovery, strict mode and config matching, on the CPU.

Port of ``tests/node/test_runtimehook.py``. A temporary directory
stands in for ``/dev`` (``dev-root``), holding empty files named as the
NVIDIA driver's nodes; the binary and :func:`discover` must pick the
same nodes from it for every assignment. A GPU's node is named by its
minor number, which the stub NVML library of
``tests/test_torch_nvml_probe.py`` makes differ from its index: 3 for
``gpu-0`` and 7 for ``gpu-1``.
"""
import json
import subprocess
import types

import pytest

from kubernetes_tpu.api import types as t
from kubernetes_tpu.api.meta import ObjectMeta
from kubernetes_tpu_torch import native
from kubernetes_tpu_torch.node.runtimehook import (GpuRuntimeHook, HookConfig,
                                                   device_minors, discover,
                                                   load_hook_configs, parse,
                                                   request)

from tests.test_torch_nvml_probe import build_stub_nvml

#: Minor numbers: the stub's two cards, and a GPU whose node no root has.
MINORS = {"gpu-0": 3, "gpu-1": 7, "gpu-2": 5}
#: Device roots: a host with both GPUs, a node named by an index
#: (nvidia0) and every control node; one with gpu-0's node only and no
#: uvm nodes; one without nvidiactl.
DEV_ROOTS = {
    "full": ["nvidia0", "nvidia3", "nvidia7", "nvidiactl", "nvidia-uvm",
             "nvidia-uvm-tools"],
    "sparse": ["nvidia0", "nvidia3", "nvidiactl"],
    "no_ctl": ["nvidia3", "nvidia7"],
    "empty": [],
}
#: Assignments: none, one, two out of order with a duplicate, an id
#: without a minor number, a GPU without a node, and one with and one
#: without.
ASSIGNMENTS = [[], ["gpu-1"], ["gpu-1", "gpu-0", "gpu-1"], ["chip-0"],
               ["gpu-2"], ["gpu-0", "gpu-2"]]


@pytest.fixture(scope="module")
def stub_nvml(tmp_path_factory):
    return build_stub_nvml(str(tmp_path_factory.mktemp("nvml")))


def _dev_root(tmp_path, name):
    root = tmp_path / name
    root.mkdir()
    for node in DEV_ROOTS[name]:
        (root / node).write_text("")
    return root


def _native(chips, dev_root, allow_missing):
    return subprocess.run([native.build("gpu_hook")],
                          input=request(chips, MINORS, str(dev_root),
                                        allow_missing),
                          capture_output=True, text=True, timeout=30)


def mk_pod(annotations=None):
    return t.Pod(metadata=ObjectMeta(name="p", namespace="default",
                                     annotations=annotations or {}))


def test_hook_config_matching():
    """The reference's own pod and container types, and duck-typed ones."""
    cfg = HookConfig(images=["cuda-"], annotations=["ktpu/gpu"],
                     match_tpu_requests=True)
    gpu_c = t.Container(name="c", image="x", tpu_requests=["gpu"])
    img_c = t.Container(name="c", image="cuda-vector-add:v1")
    plain = t.Container(name="c", image="busybox")
    assert cfg.matches(mk_pod(), gpu_c)
    assert cfg.matches(mk_pod(), img_c)
    assert not cfg.matches(mk_pod(), plain)
    assert cfg.matches(mk_pod({"ktpu/gpu": "1"}), plain)
    duck_pod = types.SimpleNamespace(
        metadata=types.SimpleNamespace(annotations={}))
    assert cfg.matches(duck_pod, types.SimpleNamespace(
        image="busybox", tpu_requests=["gpu"]))
    assert not cfg.matches(duck_pod, types.SimpleNamespace(image="busybox"))
    assert not HookConfig(match_tpu_requests=False).matches(mk_pod(), gpu_c)


def test_load_hook_configs(tmp_path):
    (tmp_path / "gpu.json").write_text(json.dumps(
        {"name": "gpu", "images": ["cuda-"], "match_tpu_requests": True}))
    (tmp_path / "broken.json").write_text("{nope")
    configs = load_hook_configs(str(tmp_path))
    assert len(configs) == 1
    assert configs[0].images == ["cuda-"] and configs[0].match_tpu_requests


@pytest.mark.parametrize("allow_missing", [False, True])
@pytest.mark.parametrize("chips", ASSIGNMENTS, ids=repr)
@pytest.mark.parametrize("root", sorted(DEV_ROOTS))
def test_native_matches_python_discovery(tmp_path, root, chips,
                                         allow_missing):
    """Same devices in the same order, and the same refusal: the binary
    exits 1 exactly where :func:`discover` raises."""
    dev_root = _dev_root(tmp_path, root)
    proc = _native(chips, dev_root, allow_missing)
    try:
        want = discover(chips, MINORS, str(dev_root), allow_missing)
    except RuntimeError as e:
        assert proc.returncode == 1, proc.stdout
        assert "gpu_hook: " in proc.stderr
        assert str(e).split(" but ")[1] in proc.stderr
        return
    assert proc.returncode == 0, proc.stderr
    env, devices = parse(proc.stdout)
    assert devices == want
    assert env == ({"GPU_RUNTIME_HOOK": "native"} if want else {})


def test_discovery_injects_the_assigned_gpus_and_control_nodes(tmp_path):
    root = _dev_root(tmp_path, "full")
    assert discover(["gpu-1"], MINORS, str(root), allow_missing=False) == [
        f"{root}/nvidia7", f"{root}/nvidiactl", f"{root}/nvidia-uvm",
        f"{root}/nvidia-uvm-tools"]
    sparse = _dev_root(tmp_path, "sparse")
    assert discover(["gpu-0"], MINORS, str(sparse), allow_missing=False) == [
        f"{sparse}/nvidia3", f"{sparse}/nvidiactl"]


def test_minor_numbers_come_from_nvml(stub_nvml, tmp_path):
    assert device_minors(stub_nvml) == {"gpu-0": 3, "gpu-1": 7}
    assert device_minors(str(tmp_path / "libnvidia-ml.so.1")) == {}


async def test_hook_hands_over_the_node_of_the_minor_number(stub_nvml,
                                                            tmp_path):
    """gpu-<i> gets /dev/nvidia<NVML's minor number>, never the node
    named by its index; without NVML no GPU node is resolved."""
    root = _dev_root(tmp_path, "full")
    hook = GpuRuntimeHook(allow_missing_devices=False, dev_root=str(root),
                          library=stub_nvml)
    c = t.Container(name="c", tpu_requests=["gpu"])
    for chip, node in (("gpu-0", "nvidia3"), ("gpu-1", "nvidia7")):
        env, devices = await hook.run(mk_pod(), c, [chip])
        assert devices == [f"{root}/{node}", f"{root}/nvidiactl",
                           f"{root}/nvidia-uvm", f"{root}/nvidia-uvm-tools"]
    no_nvml = GpuRuntimeHook(allow_missing_devices=False, dev_root=str(root),
                             library=str(tmp_path / "libnvidia-ml.so.1"))
    with pytest.raises(RuntimeError, match="no device node for gpu-0"):
        await no_nvml.run(mk_pod(), c, ["gpu-0"])


async def test_hook_merges_native_output(stub_nvml, tmp_path):
    root = _dev_root(tmp_path, "full")
    hook = GpuRuntimeHook(dev_root=str(root), library=stub_nvml)
    pod = mk_pod()
    env, devices = await hook.run(
        pod, t.Container(name="c", tpu_requests=["gpu"]), ["gpu-0"])
    assert devices == [f"{root}/nvidia3", f"{root}/nvidiactl",
                       f"{root}/nvidia-uvm", f"{root}/nvidia-uvm-tools"]
    assert env == {"GPU_RUNTIME_HOOK": "native"}
    # A container no config matches: nothing.
    env, devices = await hook.run(pod, t.Container(name="c", image="b"), [])
    assert env == {} and devices == []


async def test_hook_strict_mode_raises(stub_nvml, tmp_path):
    hook = GpuRuntimeHook(allow_missing_devices=False,
                          dev_root=str(_dev_root(tmp_path, "no_ctl")),
                          library=stub_nvml)
    with pytest.raises(RuntimeError, match="no nvidiactl"):
        await hook.run(mk_pod(), t.Container(name="c", tpu_requests=["gpu"]),
                       ["gpu-0"])
    lenient = GpuRuntimeHook(dev_root=hook.dev_root, library=stub_nvml)
    env, devices = await lenient.run(
        mk_pod(), t.Container(name="c", tpu_requests=["gpu"]), ["gpu-0"])
    assert devices == [f"{hook.dev_root}/nvidia3"]


async def test_hook_configs_from_a_directory(stub_nvml, tmp_path):
    (tmp_path / "hooks").mkdir()
    (tmp_path / "hooks" / "cuda.json").write_text(json.dumps(
        {"name": "cuda", "images": ["cuda-"]}))
    root = _dev_root(tmp_path, "full")
    hook = GpuRuntimeHook(hooks_dir=str(tmp_path / "hooks"),
                          dev_root=str(root), library=stub_nvml)
    # match_tpu_requests is off in this config: only the image matches.
    env, devices = await hook.run(
        mk_pod(), t.Container(name="c", tpu_requests=["gpu"]), ["gpu-0"])
    assert (env, devices) == ({}, [])
    env, devices = await hook.run(
        mk_pod(), t.Container(name="c", image="cuda-vector-add"), ["gpu-1"])
    assert devices[0] == f"{root}/nvidia7"
