"""Multi-process trainer entrypoint — the TrainJob worker payload.

``python -m kubernetes_tpu_torch.workloads.trainer``

Counterpart of ``kubernetes_tpu/workloads/trainer.py``, with its
observable contract: the same env, files and stdout lines. Rendezvous
from framework env + cluster DNS (:mod:`.rendezvous`: TPU_WORKER_ID /
TPU_WORKER_HOSTNAMES / KTPU_DNS_SERVER / KTPU_COORD_PORT / POD_IP, all
injected by the controllers and the node agent) into a
``torch.distributed`` process group (``nccl`` on the card, ``gloo`` on
the CPU), then one of two workloads:

- ``MODEL=lm``   the flagship LM (:func:`.lm.train`), data-parallel over
  the gang (one card per rank, the reference's ``dp`` mesh), with
  periodic checkpoints to the shared checkpoint dir and the
  checkpoint-complete marker published per save, preempt-signal aware;
- ``MODEL=demo`` the exactly-computable counting loop the e2e tier
  asserts against (step ``s`` adds ``mean_over_ranks(rank + 1 + s)``;
  any lost, repeated, or desynchronized step shows in the final value).

Both paths write a per-attempt record to the checkpoint dir
(``attempt-rank<r>-start<s>.json``: resumed_from / final_step /
steps_run), so a harness can assert resume-from-checkpoint re-ran
strictly fewer steps than restart-from-scratch.

Env knobs (the TrainJob controller injects these from spec):
MODEL, TOTAL_STEPS, BATCH, SEQ, CHECKPOINT_EVERY, STEP_DELAY seconds,
CKPT_DIR (default: the KTPU_JOB_NAME contract via
``checkpoint.checkpoint_dir``), LM_VOCAB / LM_D_MODEL / LM_LAYERS /
LM_HEADS / LM_D_FF / LM_ATTN model-size overrides,
KTPU_RENDEZVOUS_TIMEOUT seconds, and KTPU_TRAINER_PLATFORM (falling
back to KTPU_DEMO_PLATFORM): ``cpu`` runs on the CPU; anything else,
or nothing, runs on the card, and raises without one. (The reference
defaults to the CPU.)
"""
from __future__ import annotations

import json
import os
import sys
import time

import torch


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name) or default)


def _device() -> torch.device:
    """The rank's device: the CPU when ``KTPU_TRAINER_PLATFORM`` (or
    ``KTPU_DEMO_PLATFORM``) is ``cpu``, else the card. On the card the
    rank's device is made current before any launch or collective: the
    first card it sees, which under the device plugin's
    ``CUDA_VISIBLE_DEVICES`` is the one it was given."""
    from ..device import resolve_device
    platform = os.environ.get("KTPU_TRAINER_PLATFORM",
                              os.environ.get("KTPU_DEMO_PLATFORM", ""))
    dev = resolve_device("cpu" if platform == "cpu" else "cuda:0")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def _write_attempt_record(ckpt_dir: str, rank: int, start: int,
                          final_step: int, extra: dict) -> None:
    """Durable per-attempt summary (tmp+rename like the checkpoint
    marker): the resume-beats-restart evidence harnesses assert on."""
    if not ckpt_dir:
        return
    os.makedirs(ckpt_dir, exist_ok=True)
    rec = {"rank": rank, "resumed_from": start, "final_step": final_step,
           "steps_run": final_step - start, "time": time.time(), **extra}
    path = os.path.join(ckpt_dir, f"attempt-rank{rank}-start{start}.json")
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(rec, f)
    os.replace(tmp, path)


def _group():
    """The default process group, or None for a single process."""
    from torch import distributed as dist
    return dist.group.WORLD if dist.is_initialized() else None


def _world(group) -> int:
    from torch import distributed as dist
    return dist.get_world_size(group) if group is not None else 1


def lm_config(device: torch.device):
    """The LM of the ``LM_*`` env, the reference trainer's defaults
    where a name is unset (a 32-wide model of 2 heads: head dim 16).
    The flash-attention kernels on the card: each rank runs them on its
    own rows, which is the computation dp sharding does. Plain attention
    on the CPU. ``LM_ATTN=ring`` runs the ring over a mesh that is dp
    alone, as the reference trainer's is: on each rank, one causal
    launch a layer."""
    from . import lm
    attn = os.environ.get("LM_ATTN") or (
        "flash" if device.type == "cuda" else "local")
    return lm.LMConfig(
        vocab=_env_int("LM_VOCAB", 64),
        d_model=_env_int("LM_D_MODEL", 32),
        n_layers=_env_int("LM_LAYERS", 2),
        n_heads=_env_int("LM_HEADS", 2),
        d_ff=_env_int("LM_D_FF", 64),
        attn_impl=attn)


def run_lm(rank: int, ckpt_dir: str, device: torch.device) -> int:
    from . import lm

    total = _env_int("TOTAL_STEPS", 100)
    batch = _env_int("BATCH", 4)
    seq = _env_int("SEQ", 16)
    every = _env_int("CHECKPOINT_EVERY", 10)
    delay = float(os.environ.get("STEP_DELAY") or 0.0)
    cfg = lm_config(device)
    # Pure data parallelism across the gang, one device per rank: the
    # cheapest collectives, and the sharding every worker count supports.
    group = _group()
    dp = _world(group)
    if batch % dp:
        # The batch splits over dp; a non-divisible batch would fail the
        # first step on EVERY rank and burn the whole backoff budget on
        # identical crashes. Round up — never down to 0.
        batch = ((batch + dp - 1) // dp) * dp
        print(f"TRAINER rank={rank}: batch rounded up to {batch} "
              f"(multiple of {dp} devices)", flush=True)
    cb = (lambda _s: time.sleep(delay)) if delay else None
    out = lm.train(cfg, steps=total, batch=batch, seq=seq,
                   ckpt_dir=ckpt_dir, checkpoint_every=every,
                   publish_marker=True, step_callback=cb, device=device,
                   group=group)
    _write_attempt_record(
        ckpt_dir, rank, out["resumed_from"], out["final_step"],
        {"loss": out["loss"], "preempted": out["preempted"]})
    print(f"TRAINER DONE rank={rank} start={out['resumed_from']} "
          f"final={out['final_step']} loss={out['loss']} "
          f"preempted={out['preempted']}", flush=True)
    return 0


def run_demo(rank: int, ckpt_dir: str, device: torch.device) -> int:
    """The counting workload, with the reference's observable contract:
    the done-rank files, the DONE line, the exact final value."""
    from torch import distributed as dist

    from . import checkpoint as ckpt
    from .rendezvous import barrier

    group = _group()
    n = _world(group)
    total = _env_int("TOTAL_STEPS", 20)
    delay = float(os.environ.get("STEP_DELAY") or 0.0)

    start_step = 0
    w = torch.zeros((8,), dtype=torch.float32, device=device)
    if ckpt_dir:
        latest = ckpt.latest_step(ckpt_dir)
        if latest is not None:
            w = ckpt.restore(ckpt_dir, {"w": w})["w"]
            start_step = latest

    for s in range(start_step, total):
        # Every rank contributes (rank + 1 + s); the mean over all ranks
        # is (n-1)/2 + 1 + s, added to every element of w.
        x = torch.full((1,), float(rank + 1 + s), device=device)
        if group is not None:
            dist.all_reduce(x, group=group)
        w += x / n
        if ckpt_dir:
            # One writer, then a barrier: no rank goes on before the step
            # is durable, and the marker follows the save.
            if rank == 0:
                ckpt.save(s + 1, {"w": w}, ckpt_dir)
                ckpt.write_marker(ckpt_dir, s + 1)
            if group is not None:
                barrier(group, device)
        if delay:
            time.sleep(delay)

    final = float(w[0])
    print(f"DONE rank={rank} start={start_step} final={final}", flush=True)
    if ckpt_dir:
        with open(os.path.join(
                ckpt_dir, f"done-rank{rank}-attempt{start_step}"), "w") as f:
            f.write(f"{final}")
        _write_attempt_record(ckpt_dir, rank, start_step, total,
                              {"final": final})
    return 0


def main() -> int:
    from torch import distributed as dist

    from . import checkpoint as ckpt
    from . import rendezvous

    model = os.environ.get("MODEL", "demo")
    if model not in ("lm", "demo"):
        raise SystemExit(f"trainer: unknown MODEL {model!r} (lm|demo)")
    device = _device()
    rank = rendezvous.initialize_from_env(
        timeout=float(os.environ.get("KTPU_RENDEZVOUS_TIMEOUT") or 60.0),
        device=device)
    try:
        ckpt_dir = os.environ.get("CKPT_DIR", "")
        if model == "lm":
            # The LM path always checkpoints (resume is its whole point);
            # the demo keeps its legacy "no CKPT_DIR = no checkpointing".
            ckpt_dir = ckpt_dir or ckpt.checkpoint_dir()
            return run_lm(rank, ckpt_dir, device)
        # Legacy contract: no CKPT_DIR = no checkpointing — EXCEPT under
        # the TrainJob controller, whose KTPU_CHECKPOINT_DIR injection IS
        # the checkpoint opt-in.
        if not ckpt_dir and os.environ.get("KTPU_CHECKPOINT_DIR"):
            ckpt_dir = ckpt.checkpoint_dir()
        return run_demo(rank, ckpt_dir, device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
