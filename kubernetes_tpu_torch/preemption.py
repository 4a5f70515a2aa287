"""Checkpoint-complete marker helpers of the graceful-preemption protocol.

The port's own copy of the marker contract of
``kubernetes_tpu/preemption.py``: the file name, its path beside the
per-step checkpoint directories, and the readers the node agent uses.
A marker written by the port's trainer reads back through the
reference's readers and the other way round; the format is JSON
``{"step": int, "time": float}``, published by tmp + rename
(``workloads/checkpoint.write_marker``), so a reader never sees a torn
file.
"""
from __future__ import annotations

import json
import os
from typing import Optional

#: Checkpoint-complete marker file name, beside the step directories.
MARKER_NAME = "ktpu-preempt-complete.json"


def job_checkpoint_dir(job: str, base: str = "") -> str:
    """The path ``workloads.checkpoint.checkpoint_dir`` gives a job:
    ``<base>/<job>``, ``base`` defaulting to ``KTPU_CHECKPOINT_DIR``."""
    base = base or os.environ.get("KTPU_CHECKPOINT_DIR", "/tmp/ktpu-ckpt")
    return os.path.join(base, job)


def marker_path(ckpt_dir: str) -> str:
    return os.path.join(ckpt_dir, MARKER_NAME)


def read_marker_info(ckpt_dir: str) -> Optional[tuple[int, float]]:
    """(step, write time) of the published marker, or None when absent or
    unreadable. The write time lets a caller reject a stale marker left
    by an earlier round."""
    try:
        with open(marker_path(ckpt_dir), encoding="utf-8") as f:
            data = json.load(f)
    except (OSError, ValueError):
        return None
    step = data.get("step")
    if not isinstance(step, int) or step < 0:
        return None
    ts = data.get("time")
    return step, float(ts) if isinstance(ts, (int, float)) else 0.0


def read_marker(ckpt_dir: str) -> Optional[int]:
    info = read_marker_info(ckpt_dir)
    return info[0] if info is not None else None
