"""Training-job checkpoint/restore: the workload half of elasticity.

Counterpart of ``kubernetes_tpu/workloads/checkpoint.py`` with its API
and on-disk contracts: the job identity (``KTPU_JOB_NAME``, else
``POD_NAME``) keys the checkpoint directory, so every incarnation of a
job finds the same one; :func:`resume_or_init` restores the latest step
and resumes at step + 1; the checkpoint-complete marker is published
atomically beside the step directories.

Storage: in place of Orbax, one ``torch.save`` of the state (a nested
dict/tuple/list of tensors and Python scalars) per step, in a directory
named by the step number. A step directory is written under a temporary
name and renamed into place, so a process killed mid-save leaves the
previous step as the latest; ``max_to_keep`` newest steps are kept.
:func:`restore` places each tensor on the device of its template leaf.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, NamedTuple, Optional

import torch

from ..preemption import MARKER_NAME, marker_path, read_marker  # noqa: F401

STATE_FILE = "state.pt"


class TensorSpec(NamedTuple):
    """Shape, dtype and device of a tensor: a restore template leaf that
    holds no memory (Orbax's ``ShapeDtypeStruct`` with its sharding)."""
    shape: tuple
    dtype: torch.dtype
    device: torch.device


def checkpoint_dir(base: str = "", job: str = "") -> str:
    """Canonical location: <base>/<job>. Inside a pod ``KTPU_JOB_NAME``
    (agent-injected) names the job; callers can override both."""
    base = base or os.environ.get("KTPU_CHECKPOINT_DIR", "/tmp/ktpu-ckpt")
    job = job or os.environ.get("KTPU_JOB_NAME") \
        or os.environ.get("POD_NAME", "job")
    return os.path.join(base, job)


def preempt_requested() -> bool:
    """Has the orchestrator requested a preemption checkpoint? True when
    ``KTPU_PREEMPT=1`` or the agent-managed ``KTPU_PREEMPT_FILE`` exists.
    Training loops check this each step (:func:`..lm.train`)."""
    if os.environ.get("KTPU_PREEMPT") == "1":
        return True
    path = os.environ.get("KTPU_PREEMPT_FILE", "")
    return bool(path) and os.path.exists(path)


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def write_marker(ckpt_dir: str, step: int) -> None:
    """Atomically publish "checkpoint for ``step`` is durable". Call only
    after :func:`save` returned."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = marker_path(ckpt_dir) + f".tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump({"step": int(step), "time": time.time()}, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, marker_path(ckpt_dir))


def clear_marker(ckpt_dir: str) -> None:
    """Remove a stale marker: the resumed incarnation calls this at start
    so a new preemption round never reads the old round's step."""
    try:
        os.remove(marker_path(ckpt_dir))
    except OSError:
        pass


def _steps(ckpt_dir: str) -> list[int]:
    """Completed steps under ``ckpt_dir``, ascending."""
    try:
        names = os.listdir(ckpt_dir)
    except OSError:
        return []
    return sorted(int(n) for n in names if n.isdigit()
                  and os.path.isfile(os.path.join(ckpt_dir, n, STATE_FILE)))


def save(step: int, state: Any, ckpt_dir: str, max_to_keep: int = 3) -> None:
    """Save ``state`` for ``step``; returns once it is durable (the
    orchestrator may kill the pod any time after). Keeps the
    ``max_to_keep`` newest steps."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, str(int(step)))
    tmp = os.path.join(ckpt_dir, f".tmp-{int(step)}-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    with open(os.path.join(tmp, STATE_FILE), "wb") as f:
        torch.save(state, f)
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(tmp)
    shutil.rmtree(final, ignore_errors=True)  # a re-save of one step
    os.replace(tmp, final)
    _fsync_dir(ckpt_dir)
    for old in _steps(ckpt_dir)[:-max_to_keep]:
        shutil.rmtree(os.path.join(ckpt_dir, str(old)), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def as_template(state: Any) -> Any:
    """Shape/dtype/device skeleton of ``state`` (:class:`TensorSpec`
    leaves), so the live tensors can be freed before a restore lands."""
    return _map(lambda x: TensorSpec(tuple(x.shape), x.dtype, x.device)
                if isinstance(x, torch.Tensor) else x, state)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, TensorSpec):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _place(like: Any, loaded: Any, path: str = "state") -> Any:
    """``loaded`` laid out like ``like``: the same tree, each tensor on
    its template leaf's device; raises on a mismatch of structure,
    shape or dtype."""
    if isinstance(like, dict):
        if not isinstance(loaded, dict) or set(loaded) != set(like):
            raise ValueError(f"{path}: checkpoint keys {sorted(loaded)} != "
                             f"template keys {sorted(like)}")
        return {k: _place(v, loaded[k], f"{path}.{k}") for k, v in like.items()}
    if isinstance(like, (list, tuple)) and not isinstance(like, TensorSpec):
        if not isinstance(loaded, (list, tuple)) or len(loaded) != len(like):
            raise ValueError(f"{path}: checkpoint and template differ in "
                             f"length")
        return type(like)(_place(v, w, f"{path}[{i}]")
                          for i, (v, w) in enumerate(zip(like, loaded)))
    if isinstance(like, (torch.Tensor, TensorSpec)):
        if not isinstance(loaded, torch.Tensor) \
                or tuple(loaded.shape) != tuple(like.shape) \
                or loaded.dtype != like.dtype:
            raise ValueError(f"{path}: checkpoint holds {loaded!r:.80}, the "
                             f"template a {like.dtype} {tuple(like.shape)}")
        return loaded.to(like.device)
    return loaded


def restore(ckpt_dir: str, like: Any, step: Optional[int] = None) -> Any:
    """The state saved at ``step`` (default: the latest), laid out like
    the template ``like`` (real tensors or :func:`as_template`
    skeletons): each tensor lands on its template leaf's device."""
    if not os.path.isdir(ckpt_dir):
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir!r}")
    if step is None:
        step = latest_step(ckpt_dir)
    path = os.path.join(ckpt_dir, str(step), STATE_FILE)
    if step is None or not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint for step {step} under "
                                f"{ckpt_dir!r}")
    loaded = torch.load(path, map_location="cpu", weights_only=True)
    return _place(like, loaded)


def resume_or_init(ckpt_dir: str, init_fn, *init_args, template_fn=None):
    """(state, start_step): restore the latest checkpoint or build a
    fresh state, so eviction and reschedule is a resume, not a restart.

    ``template_fn``: optional () -> skeleton (:func:`as_template`) used on
    the resume path instead of building a fresh state to read its
    shapes."""
    step = latest_step(ckpt_dir)
    if step is None:
        return init_fn(*init_args), 0
    if template_fn is not None:
        template = template_fn()
    else:
        fresh = init_fn(*init_args)
        template = as_template(fresh)
        del fresh  # free device memory before the restored copy lands
    return restore(ckpt_dir, template, step), step + 1
