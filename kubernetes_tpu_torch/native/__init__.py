"""The node layer's native binaries, built with g++ at first use.

- ``nvml_probe.cpp``: the GPU enumeration probe that the device plugin
  execs (``deviceplugin/gpu_plugin.py``), the gonvml analog;
- ``gpu_hook.cpp``: the container runtime hook that injects a
  container's GPU device nodes (``node/runtimehook.py``).

Counterpart of ``kubernetes_tpu/native/__init__.py``, under the port's
build rule (``kernels/build.py``): each binary goes into the ignored
``kubernetes_tpu_torch/_build/`` under a name that hashes its source
and flags, so an edit rebuilds and an unchanged tree reuses it. A
missing compiler or a failed build raises with the compiler's output;
nothing about a failure is kept, and nothing falls back.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parent / "_build"
#: Each binary and the g++ flags it builds with (the probe dlopens NVML).
BINARIES = {"nvml_probe": ("-ldl",), "gpu_hook": ()}
GXX_FLAGS = ("-O2", "-std=c++17")
#: Seconds g++ may take for one binary.
BUILD_TIMEOUT_S = 300.0


def _target(name: str) -> Path:
    src = SRC_DIR / f"{name}.cpp"
    h = hashlib.sha256(" ".join(GXX_FLAGS + BINARIES[name]).encode())
    h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}"


def build(name: str) -> str:
    """The path of binary ``name`` (a key of :data:`BINARIES`), compiled
    with g++ if it is not built yet. Raises ``RuntimeError`` with the
    compiler's output when g++ is missing or the build fails."""
    target = _target(name)
    if target.exists():
        return str(target)
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found on PATH: {name} cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    cmd = [gxx, *GXX_FLAGS, str(SRC_DIR / f"{name}.cpp"), *BINARIES[name],
           "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=BUILD_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ {name}.cpp failed (exit "
                               f"{proc.returncode}):\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, target)
    finally:
        tmp.unlink(missing_ok=True)
    return str(target)
