"""The port's NVML probe (``native/nvml_probe.cpp``) and the device
plugin's probe chain, on the CPU, against stub NVML libraries.

Port of ``tests/unit/test_libtpu_probe.py``. The probe's contract:
always exit 0 with one JSON line (``gpu`` true or false). The tests need
no NVIDIA driver: each builds a stub ``libnvidia-ml.so`` with g++ in its
temporary directory (two H100s with UUIDs and memory, none, or one
whose ``nvmlInit_v2`` never returns) and names it as the probe's
library.
"""
import json
import os
import subprocess
import time

import pytest

from kubernetes_tpu.deviceplugin import tpu_plugin as jax_plugin
from kubernetes_tpu_torch import native
from kubernetes_tpu_torch.deviceplugin import gpu_plugin

#: The stub NVML library: N_DEVICES cards, card i with minor number
#: 4 i + 3 (not its index, as on real hosts); INIT_BODY runs in nvmlInit_v2.
STUB_NVML = r"""
#include <string.h>
#include <unistd.h>
struct nvmlMemory_t { unsigned long long total, free, used; };
static const char* kUuids[] = {"GPU-00000000-1111-2222-3333-444444444444",
                               "GPU-55555555-6666-7777-8888-999999999999"};
extern "C" {
int nvmlInit_v2(void) { INIT_BODY; return 0; }
int nvmlShutdown(void) { return 0; }
int nvmlDeviceGetCount_v2(unsigned int* n) { *n = N_DEVICES; return 0; }
int nvmlDeviceGetHandleByIndex_v2(unsigned int i, void** h) {
  if (i >= N_DEVICES) return 2;
  *h = (void*)(size_t)(i + 1);
  return 0;
}
int nvmlDeviceGetName(void*, char* buf, unsigned int len) {
  strncpy(buf, "NVIDIA H100 80GB HBM3", len);
  return 0;
}
int nvmlDeviceGetUUID(void* h, char* buf, unsigned int len) {
  strncpy(buf, kUuids[(size_t)h - 1], len);
  return 0;
}
int nvmlDeviceGetMemoryInfo(void* h, nvmlMemory_t* m) {
  m->total = 85520809984ULL;
  m->used = 1000ULL * (size_t)h;
  m->free = m->total - m->used;
  return 0;
}
int nvmlDeviceGetMinorNumber(void* h, unsigned int* minor) {
  *minor = 4 * ((unsigned)(size_t)h - 1) + 3;
  return 0;
}
const char* nvmlErrorString(int) { return "stub NVML error"; }
}
"""

#: What the probe prints for the two-card stub.
TWO_H100 = {
    "gpu": True, "source": "nvml_probe", "process_index": 0,
    "devices": [
        {"index": i, "kind": "NVIDIA H100 80GB HBM3", "uuid": uuid,
         "coords": [i, 0, 0], "minor_number": 4 * i + 3,
         "memory": {"hbm_used_bytes": 1000 * (i + 1),
                    "hbm_total_bytes": 85520809984}}
        for i, uuid in enumerate(("GPU-00000000-1111-2222-3333-444444444444",
                                  "GPU-55555555-6666-7777-8888-999999999999"))],
}


def build_stub_nvml(directory, n_devices: int = 2,
                    init_body: str = "") -> str:
    """A stub ``libnvidia-ml.so`` with ``n_devices`` H100s in
    ``directory``; ``init_body`` runs inside ``nvmlInit_v2``."""
    src = os.path.join(directory, "stub_nvml.cpp")
    lib = os.path.join(directory, f"libnvidia-ml-stub{n_devices}.so")
    with open(src, "w") as f:
        f.write(STUB_NVML)
    subprocess.run(["g++", "-O1", "-shared", "-fPIC",
                    f"-DN_DEVICES={n_devices}u",
                    f"-DINIT_BODY={init_body or '(void)0'}", src, "-o", lib],
                   check=True, capture_output=True, timeout=120)
    return lib


@pytest.fixture(scope="module")
def stub_nvml(tmp_path_factory):
    return build_stub_nvml(str(tmp_path_factory.mktemp("nvml")))


def _run(cmd, timeout=60, **env):
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=timeout, env={**os.environ, **env})
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_probe_without_nvml_reports_no_gpu(tmp_path):
    """No library is an answer (gpu: false, exit 0), not a crash; the
    path given is authoritative."""
    probe = native.build("nvml_probe")
    out = _run([probe, str(tmp_path / "libnvidia-ml.so.1")])
    assert out["gpu"] is False and out["source"] == "nvml_probe"
    assert "dlopen" in out["error"] and str(tmp_path) in out["error"]


def test_probe_of_a_library_without_nvml_reports_no_gpu():
    out = _run([native.build("nvml_probe"), "libm.so.6"])
    assert out["gpu"] is False
    assert "lacks the NVML functions" in out["error"]


def test_probe_reads_every_card_of_the_stub(stub_nvml):
    assert _run([native.build("nvml_probe"), stub_nvml]) == TWO_H100


def test_probe_of_a_host_without_cards(tmp_path):
    lib = build_stub_nvml(str(tmp_path), n_devices=0)
    out = _run([native.build("nvml_probe"), lib])
    assert out == {"gpu": False, "error": "NVML reports no device",
                   "source": "nvml_probe"}


def test_watchdog_answers_for_an_nvml_that_never_returns(tmp_path):
    """A driver that hangs in nvmlInit_v2 is no GPU, said within the
    watchdog's time: the probe never wedges its caller."""
    lib = build_stub_nvml(str(tmp_path), init_body="for (;;) pause()")
    t0 = time.monotonic()
    out = _run([native.build("nvml_probe"), lib], timeout=30,
               NVML_PROBE_TIMEOUT_S="1")
    assert time.monotonic() - t0 < 10
    assert out["gpu"] is False and "watchdog" in out["error"]


def test_topology_of_the_stub_probe(stub_nvml):
    """Each GPU a chip gpu-<index> at (index, 0, 0) of a [2, 1, 1] mesh,
    as the reference builds the same probe dict's TPU topology."""
    probe = _run([native.build("nvml_probe"), stub_nvml])
    topo = gpu_plugin.topology_from_probe(probe, slice_id="s")
    ref = jax_plugin.topology_from_probe(probe, slice_id="s")
    assert topo.chip_type == "h100" and topo.slice_id == "s"
    assert topo.mesh_shape == [2, 1, 1] == list(ref.mesh_shape)
    assert topo.worker_index == ref.worker_index == 0
    assert [c.id for c in topo.chips] == ["gpu-0", "gpu-1"]
    assert [c.coords for c in topo.chips] == [list(c.coords)
                                              for c in ref.chips]
    assert [c.health for c in topo.chips] == ["Healthy"] * 2
    for chip, dev in zip(topo.chips, probe["devices"]):
        assert chip.attributes == {
            "chip_type": "h100", "device_kind": "NVIDIA H100 80GB HBM3",
            "device_index": str(dev["index"]), "uuid": dev["uuid"]}


@pytest.mark.parametrize("kind,chip_type", [
    ("NVIDIA H100 80GB HBM3", "h100"), ("NVIDIA H100 PCIe", "h100"),
    ("NVIDIA H200", "h200"), ("NVIDIA GH200 480GB", "gh200"),
    ("NVIDIA A100-SXM4-80GB", "a100"), ("Tesla V100-SXM2-16GB", "v100"),
    ("NVIDIA L40S", "l40s"), ("NVIDIA GeForce RTX 4090",
                              "nvidia-geforce-rtx-4090")])
def test_chip_type_of_nvidia_names(kind, chip_type):
    assert gpu_plugin._chip_type_of(kind) == chip_type


def test_detect_topology_takes_the_nvml_probe_first(stub_nvml, monkeypatch):
    calls = []
    real = gpu_plugin.run_probe

    def spy(cmd, timeout):
        calls.append(cmd)
        return real(cmd, timeout)
    monkeypatch.setattr(gpu_plugin, "run_probe", spy)
    assert gpu_plugin.detect_topology(library=stub_nvml) == TWO_H100
    assert calls == [[native.build("nvml_probe"), stub_nvml]]


def test_detect_topology_falls_back_to_the_torch_probe(tmp_path,
                                                       monkeypatch):
    """NVML absent: the torch probe answers, under the same contract."""
    answer = {"gpu": True, "source": "torch_probe", "process_index": 0,
              "devices": [{"index": 0, "kind": "NVIDIA H100 80GB HBM3",
                           "uuid": "GPU-x", "coords": [0, 0, 0]}]}
    calls = []
    real = gpu_plugin.run_probe

    def fake(cmd, timeout):
        calls.append(cmd)
        if cmd == gpu_plugin.torch_probe_command():
            return answer
        return real(cmd, timeout)
    monkeypatch.setattr(gpu_plugin, "run_probe", fake)
    missing = str(tmp_path / "libnvidia-ml.so.1")
    assert gpu_plugin.detect_topology(library=missing) == answer
    assert calls == [[native.build("nvml_probe"), missing],
                     gpu_plugin.torch_probe_command()]


def test_torch_probe_answers_under_the_probe_contract():
    """The fallback probe itself: ``gpu`` true with the cards torch
    sees, or false with the reason, as the NVML probe answers."""
    import torch
    out = _run(gpu_plugin.torch_probe_command(), timeout=120)
    assert out["source"] == "torch_probe"
    assert out["gpu"] is torch.cuda.is_available()
    if out["gpu"]:
        assert [d["index"] for d in out["devices"]] == list(
            range(torch.cuda.device_count()))
    else:
        assert out["error"]


def test_native_build_without_gxx_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setenv("PATH", str(tmp_path))
    for _ in range(2):  # nothing about the failure is kept
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            native.build("gpu_hook")
    assert not (tmp_path / "_build").exists()


def test_failed_native_build_raises_with_compiler_output(monkeypatch,
                                                         tmp_path):
    (tmp_path / "gpu_hook.cpp").write_text("int main() { return }\n")
    monkeypatch.setattr(native, "SRC_DIR", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    for _ in range(2):
        with pytest.raises(RuntimeError, match="gpu_hook.cpp failed"):
            native.build("gpu_hook")
    assert list((tmp_path / "_build").iterdir()) == []


def test_native_target_follows_its_source(monkeypatch, tmp_path):
    (tmp_path / "gpu_hook.cpp").write_text("int main() { return 0; }\n")
    monkeypatch.setattr(native, "SRC_DIR", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    first = native.build("gpu_hook")
    assert native.build("gpu_hook") == first
    (tmp_path / "gpu_hook.cpp").write_text("int main() { return 1; }\n")
    second = native.build("gpu_hook")
    assert second != first
    assert subprocess.run([second]).returncode == 1
