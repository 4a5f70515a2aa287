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


class _FakeLibrary:
    """Stands in for a loaded kernel library: every symbol is a function
    that records its calls and returns ``rc``."""

    def __init__(self, rc=0):
        self.calls = []
        self.rc = rc
        self.kernel_error_string = lambda code: b"an illegal memory access"

    def __getattr__(self, symbol):
        if symbol.startswith("__"):
            raise AttributeError(symbol)
        lib = self

        class _Fn:
            argtypes = restype = None

            def __call__(self, *args):
                lib.calls.append((symbol, args))
                return lib.rc
        fn = _Fn()
        setattr(self, symbol, fn)
        return fn


def _fake_loading(monkeypatch, rc=0):
    """Count builds and loads of a kernel library without nvcc: the
    build is a no-op that counts, ``ctypes.CDLL`` a fake that counts."""
    import ctypes
    from kubernetes_tpu_torch.kernels import build
    counts = {"build": 0, "load": 0}
    lib = _FakeLibrary(rc)

    def fake_build(names=build.SOURCES):
        counts["build"] += 1
        return {n: "" for n in names}

    def fake_cdll(path):
        counts["load"] += 1
        assert str(path).endswith(".so")
        return lib
    monkeypatch.setattr(build, "build", fake_build)
    monkeypatch.setattr(ctypes, "CDLL", fake_cdll)
    monkeypatch.setattr(build, "_loaded", {})
    return build, counts, lib


def test_launcher_resolves_library_and_symbols_once(monkeypatch):
    import ctypes
    build, counts, lib = _fake_loading(monkeypatch)
    args = (ctypes.c_void_p, ctypes.c_int64)
    f32 = build.Kernel("vector_add", "vector_add_f32", args)
    bf16 = build.Kernel("vector_add", "vector_add_bf16", args)
    assert counts == {"build": 0, "load": 0}  # nothing before a launch
    assert [f32.launch(16 * i, i) for i in range(3)] == [0, 0, 0]
    assert bf16.launch(32, 4) == 0
    assert counts == {"build": 1, "load": 1}
    assert lib.calls == [("vector_add_f32", (0, 0)),
                         ("vector_add_f32", (16, 1)),
                         ("vector_add_f32", (32, 2)),
                         ("vector_add_bf16", (32, 4))]
    # After the first launch, ``launch`` is the declared C function itself.
    assert f32.launch is lib.vector_add_f32
    assert lib.vector_add_f32.argtypes == list(args)
    assert lib.vector_add_f32.restype is ctypes.c_int


def test_launcher_turns_a_cuda_error_into_runtime_error(monkeypatch):
    build, counts, lib = _fake_loading(monkeypatch, rc=700)
    kernel = build.Kernel("flash_attn_fwd", "flash_attn_fwd_bf16", ())
    rc = kernel.launch()
    assert rc == 700
    err = kernel.error(rc)
    assert isinstance(err, RuntimeError)
    assert str(err) == ("flash_attn_fwd_bf16: CUDA error 700 "
                        "(an illegal memory access)")
    assert counts == {"build": 1, "load": 1}


@pytest.mark.parametrize("wrapper", ["vector_add", "flash_attention"])
def test_wrappers_raise_on_every_nonzero_launch_code(wrapper):
    """Every launch in the wrappers' source is followed by the test of
    its code: ``rc = K.launch(...)`` then ``if rc: raise K.error(rc)``."""
    import re
    from kubernetes_tpu_torch.kernels import build
    text = (build.CSRC.parent / "workloads" / f"{wrapper}.py").read_text()
    launches = re.findall(r"rc = (\w+)\.launch\(", text)
    raises = re.findall(r"if rc:\n\s+raise (\w+)\.error\(rc\)", text)
    assert launches and launches == raises
    assert text.count(".launch(") == len(launches)


def test_launcher_keeps_nothing_about_a_failed_build(monkeypatch, tmp_path):
    from kubernetes_tpu_torch.kernels import build
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "DEFAULT_NVCC", tmp_path / "nvcc")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "_loaded", {})
    kernel = build.Kernel("vector_add", "vector_add_f32", ())
    for _ in range(2):  # the second launch tries again
        with pytest.raises(RuntimeError, match="nvcc not found"):
            kernel.launch()
    assert build._loaded == {}
    assert kernel.launch == kernel._first_launch


def _c_entry_points(source: str) -> dict:
    """{symbol: number of parameters} of the ``extern "C" int`` entry
    points of a CUDA source."""
    import re
    from kubernetes_tpu_torch.kernels import build
    text = (build.CSRC / f"{source}.cu").read_text()
    found = re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text)
    return {name: len(params.split(",")) for name, params in found}


def test_every_launcher_matches_its_c_entry_point():
    """Each wrapper's launcher names an entry point of its library's
    source, with one argtype per C parameter, the stream last."""
    import ctypes
    from kubernetes_tpu_torch.workloads import flash_attention as fa
    from kubernetes_tpu_torch.workloads import vector_add as va
    kernels = [*va.KERNELS.values(), fa._FWD, fa._BWD]
    for kernel in kernels:
        entries = _c_entry_points(kernel.library)
        assert kernel.symbol in entries, kernel.symbol
        assert len(kernel.argtypes) == entries[kernel.symbol], kernel.symbol
        assert kernel.argtypes[-1] is ctypes.c_void_p


def test_current_stream_is_the_raw_getter_where_torch_has_it(monkeypatch):
    """The raw getter where the installed torch has it; otherwise the
    public ``torch.cuda.current_stream(i).cuda_stream``."""
    import types
    import torch
    from kubernetes_tpu_torch.kernels import build
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        assert build.current_stream is raw
        return
    asked = []

    def fake_current_stream(index):
        asked.append(index)
        return types.SimpleNamespace(cuda_stream=1234)
    monkeypatch.setattr(torch.cuda, "current_stream", fake_current_stream)
    assert build.current_stream(3) == 1234 and asked == [3]
