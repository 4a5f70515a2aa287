"""Build the CUDA sources of ``csrc/`` with nvcc and load them by ctypes.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, ``_build/<name>-<hash>.so``, where the hash covers the
source, the shared headers and the compiler flags: an edit rebuilds,
an unchanged tree reuses what is there. Sources build in parallel, one
nvcc process each. A missing nvcc or a failed build raises with the
compiler's output; nothing is cached about a failure, and nothing falls
back to another implementation.

Every C entry point takes its pointers and its stream as
``ctypes.c_void_p`` and the index of its tensors' device as an int,
makes that device current for the launch (``DeviceGuard``,
``csrc/common.cuh``) whatever device the calling thread had current,
launches on the stream it is given, allocates nothing, and returns
``cudaGetLastError()``. A wrapper calls it through
a :class:`Kernel`, the one launch path of the package: the library is
built, loaded and its symbol declared at the first launch and kept, so
every later launch is one ctypes call and one test of its return code.
:data:`current_stream` gives the raw handle of PyTorch's current stream
without making a ``torch.cuda.Stream`` object.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

SOURCES = ("vector_add", "flash_attn_fwd", "flash_attn_bwd", "flash_attn_wide",
           "adamw", "moe_permute")

DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """nvcc from ``CUDA_HOME``, then ``PATH``, then ``/usr/local/cuda``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(DEFAULT_NVCC)
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    if not src.is_file():
        raise FileNotFoundError(f"no CUDA source {src}")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, str]:
    """Compile every named source whose library is missing, all at once.

    Returns ``{name: compiler output}`` (the ``-Xptxas -v`` report of
    registers, shared memory and spills), read back from the log kept
    beside a library that was already built."""
    targets = {name: _target(name) for name in names}
    missing = {n: t for n, t in targets.items() if not t.exists()}
    if missing:
        nvcc = nvcc_path()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name, target in missing.items():
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failures = []
        for name, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"--- nvcc {name}.cu (exit {proc.returncode})"
                                f"\n{out}")
                tmp.unlink(missing_ok=True)
                continue
            missing[name].with_suffix(".log").write_text(out)
            os.replace(tmp, missing[name])
        if failures:
            raise RuntimeError("CUDA kernel build failed:\n"
                               + "\n".join(failures))
    return {n: t.with_suffix(".log").read_text() for n, t in targets.items()}


def _library(name: str) -> ctypes.CDLL:
    """``csrc/<name>.cu``'s library, built if needed and loaded once."""
    lib = _loaded.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(_target(name)))
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


class Kernel:
    """One C entry point of ``csrc/<library>.cu``, the launch path that
    every wrapper of the package shares.

    ``launch(*args)`` calls the entry point and returns its CUDA error
    code; on a non-zero code the wrapper raises ``error(code)``, a
    ``RuntimeError`` with CUDA's text for it:

        rc = kernel.launch(x.data_ptr(), ..., device,
                           current_stream(device))
        if rc:
            raise kernel.error(rc)

    The first launch builds and loads the library and declares the
    symbol (``argtypes``, ``int`` return), then puts the ctypes function
    itself in ``launch``: every later launch is the ctypes call and
    nothing else of Python. A failed build raises from the launch that
    tried it and is tried again by the next: nothing about a failure is
    kept."""

    __slots__ = ("library", "symbol", "argtypes", "launch")

    def __init__(self, library: str, symbol: str, argtypes) -> None:
        self.library, self.symbol = library, symbol
        self.argtypes = tuple(argtypes)
        self.launch = self._first_launch

    def _first_launch(self, *args) -> int:
        fn = getattr(_library(self.library), self.symbol)
        fn.argtypes = list(self.argtypes)
        fn.restype = ctypes.c_int
        self.launch = fn
        return fn(*args)

    def error(self, rc: int) -> RuntimeError:
        text = _library(self.library).kernel_error_string(rc).decode()
        return RuntimeError(f"{self.symbol}: CUDA error {rc} ({text})")


#: ``current_stream(device_index)``: the raw ``cudaStream_t`` of PyTorch's
#: current stream on that device, as an int. It is
#: ``torch._C._cuda_getCurrentRawStream``, the private call that PyTorch's
#: own Triton launcher makes; where the installed torch lacks it (a build
#: without CUDA has none), the public
#: ``torch.cuda.current_stream(i).cuda_stream``, which makes a
#: ``torch.cuda.Stream`` object on every call.
current_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
    lambda device_index: torch.cuda.current_stream(device_index).cuda_stream)
