"""elementwise_ms: device ms per step of every kernel that no other
reader of this folder names in its ``KERNELS`` (norms, RoPE, SwiGLU's
product, residuals, the f32 cross-entropy, casts and copies). The
readers are found by their files, so one added later takes its kernels
out of this metric without an edit here."""
from pathlib import Path

from portbench import spec
from portbench.trace import matches


def named() -> list:
    """The name marks of every other reader's ``KERNELS``."""
    here = Path(__file__)
    return [mark for path in sorted(here.parent.glob("*.py"))
            if not path.stem.startswith("_") and path != here
            for mark in getattr(spec.module("metrics", path.stem),
                                "KERNELS", ())]


def read(ctx: dict):
    marks = named()
    s = sum(e - b for n, b, e in ctx["kernels"] if not matches(n, marks))
    return s * 1e-6 / ctx["steps"] * 1e3 if s > 0 else None
