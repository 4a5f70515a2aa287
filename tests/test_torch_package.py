"""The port stands alone: no JAX, nothing of the reference package.

``tests/conftest.py`` imports jax into this process, so the import check
runs in a fresh interpreter. A static scan of every source backs it up,
covering imports that a run does not reach.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "kubernetes_tpu_torch"

_IMPORT_ALL = r"""
import importlib, json, pkgutil, sys
import kubernetes_tpu_torch as pkg
mods = sorted(m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."))
for name in mods:
    importlib.import_module(name)
from kubernetes_tpu_torch.entry import entry
fn, args = entry(device="cpu")
shape = tuple(fn(*args).shape)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "kubernetes_tpu"))
print(json.dumps({"modules": mods, "shape": shape, "bad": bad}))
"""


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in ("jax", "jaxlib", "kubernetes_tpu")


def test_port_imports_no_jax_at_run_time():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    import json
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["bad"] == []
    assert report["shape"] == [2, 64, 256]
    for mod in ("entry", "workloads.lm", "workloads.vector_add",
                "workloads.flash_attention", "workloads.ring_attention",
                "workloads.checkpoint", "workloads.metrics_reporter",
                "preemption", "perf.chip_bench", "perf.profile_forward",
                "kernels.build"):
        assert f"kubernetes_tpu_torch.{mod}" in report["modules"]


@pytest.mark.parametrize(
    "path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, names)


def test_every_kernel_source_is_built():
    from kubernetes_tpu_torch.kernels import build
    assert sorted(build.SOURCES) == sorted(
        p.stem for p in build.CSRC.glob("*.cu"))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from kubernetes_tpu_torch.kernels import build
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "DEFAULT_NVCC", tmp_path / "nvcc")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()
    assert not (tmp_path / "_build").exists()


def test_build_target_follows_source_and_flags(monkeypatch, tmp_path):
    from kubernetes_tpu_torch.kernels import build
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// one\n")
    monkeypatch.setattr(build, "CSRC", csrc)
    first = build._target("k")
    assert first == build._target("k")
    (csrc / "common.cuh").write_text("// header\n")
    second = build._target("k")
    (csrc / "k.cu").write_text("// two\n")
    third = build._target("k")
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    fourth = build._target("k")
    assert len({first, second, third, fourth}) == 4
    assert first.name.startswith("k-") and first.suffix == ".so"


def test_hopper_header_is_in_every_library_hash(monkeypatch, tmp_path):
    """Every attention kernel includes ``csrc/hopper.cuh``: an edit to it
    must rebuild every library, so each target's hash covers it."""
    import shutil
    from kubernetes_tpu_torch.kernels import build
    assert (build.CSRC / "hopper.cuh").is_file()
    for name in ("flash_attn_fwd", "flash_attn_bwd"):
        assert '#include "hopper.cuh"' in (build.CSRC / f"{name}.cu").read_text()
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    before = {name: build._target(name) for name in build.SOURCES}
    with open(csrc / "hopper.cuh", "a") as f:
        f.write("// edited\n")
    after = {name: build._target(name) for name in build.SOURCES}
    assert all(before[n] != after[n] for n in build.SOURCES)
