"""Entry points: the flagship workload's forward on one GPU, and one
training step over a mesh of ``n`` GPUs.

Counterparts of ``__graft_entry__``:

- :func:`entry`: the same tiny LM config and a [2, 64] -> [2, 64, 256]
  forward, with the reference's default attention, the
  sequence-parallel ring: on one device, one causal launch of the
  flash-attention kernel per layer (head dim 32);
- :func:`dryrun_multichip`: ONE full training step (forward, backward,
  AdamW) of the dense LM over an ``n``-device mesh with the reference's
  ``dp``/``fsdp``/``sp``/``tp`` sizes (``sharding.default_axis_sizes``;
  sequence parallelism is the ring over ``sp``, each rank running its
  ``H / tp`` heads through the flash kernels at head dim 16, or 48 at
  n = 3, 24 at 6, up to 128), then one MoE step over an expert-parallel
  mesh: the token/expert exchange over ``ep``. Every rank is a process
  of its own, over the port's rendezvous (NCCL on ``n`` cards, or gloo
  on the CPU).
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import socket
import subprocess
import sys

import torch

from .device import resolve_device
from .workloads import lm, moe, sharding


def entry(device=None):
    """Returns ``(forward_fn, (params, tokens))`` on ``device`` (default
    ``cuda``; raises without one unless ``device="cpu"``)."""
    dev = resolve_device(device)
    cfg = lm.LMConfig(vocab=256, d_model=128, n_layers=2, n_heads=4, d_ff=512)
    params = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    tokens = torch.zeros((2, 64), dtype=torch.int32, device=dev)
    return lm.make_forward(cfg, dev), (params, tokens)


@dataclasses.dataclass(frozen=True)
class Dryrun:
    """The meshes and configs of :func:`dryrun_multichip` at ``n``
    devices, the reference's: tiny shapes, but every axis constraint
    honoured (batch % (dp * fsdp), seq % sp, heads % tp, d_model and
    d_ff % (fsdp, tp))."""
    sizes: dict
    cfg: lm.LMConfig
    batch: int
    seq: int
    moe_sizes: dict
    moe_cfg: moe.MoEConfig
    moe_batch: int
    moe_seq: int


def dryrun_config(n_devices: int) -> Dryrun:
    """The dense LM at ``default_axis_sizes(n)``: ``d_model = 32 *
    max(sizes)``, ``2 * tp`` heads (head dim 16 at a power of 2; 48 at
    n = 3, 24 at 6, over 128 at an odd n >= 9, which the kernels do not
    take), ``d_ff = 64 * max``, batch ``2 * dp * fsdp``, seq ``16 *
    sp``; the MoE at ``ep = 2`` when ``n`` is even, ``sp = 2`` when
    ``4 | n``, dp the rest, tp 1."""
    sizes = sharding.default_axis_sizes(n_devices)
    width = max(sizes.values())
    cfg = lm.LMConfig(vocab=64, d_model=32 * width, n_layers=2,
                      n_heads=2 * sizes["tp"], d_ff=64 * width)
    ep = 2 if n_devices % 2 == 0 else 1
    sp = 2 if n_devices % 4 == 0 else 1
    dp = n_devices // (ep * sp)
    moe_cfg = moe.MoEConfig(vocab=64, d_model=32, n_layers=1, n_heads=2,
                            d_ff=64, n_experts=2 * ep, top_k=2)
    return Dryrun(sizes, cfg, 2 * sizes["dp"] * sizes["fsdp"],
                  16 * sizes["sp"], dict(dp=dp, ep=ep, sp=sp, tp=1),
                  moe_cfg, 2 * dp * ep, 8 * sp)


def dryrun_inputs(run: Dryrun, device) -> dict:
    """The whole params and global batches of a dryrun on ``device``,
    from the seeds of the reference's keys: dense params 0, batch 1; MoE
    params 2, batch 3. Every rank draws them alike and keeps its
    blocks."""
    dev = torch.device(device)

    def gen(seed):
        return torch.Generator(dev).manual_seed(seed)

    return {"params": lm.init_params(gen(0), run.cfg),
            "batch": lm.synthetic_batch(gen(1), run.cfg, run.batch,
                                        run.seq, dev),
            "moe_params": moe.init_params(gen(2), run.moe_cfg),
            "moe_batch": moe.synthetic_batch(gen(3), run.moe_cfg,
                                             run.moe_batch, run.moe_seq,
                                             dev)}


def dryrun_rank(n_devices: int, device) -> dict:
    """This rank's share of :func:`dryrun_multichip`, in a process group
    of ``n_devices`` ranks already initialised: one dense train step over
    the ``(dp, fsdp, sp, tp)`` mesh, then one MoE step over the ``(dp,
    ep, sp, tp)`` mesh. Returns its coordinates, both losses and its
    flash-kernel launches (``flash_attention.counts``)."""
    from torch import distributed as dist
    from .workloads import flash_attention
    dev = torch.device(device)
    run = dryrun_config(n_devices)
    inputs = dryrun_inputs(run, dev)
    mesh = sharding.make_mesh(device_type=dev.type, **run.sizes)
    params = sharding.shard_params(mesh, inputs["params"],
                                   lm.param_specs(run.cfg))
    opt_state = lm.init_opt_state(params, run.cfg)
    step = lm.make_train_step(run.cfg, device=dev, mesh=mesh)
    _, _, loss = step(params, opt_state, inputs["batch"])

    moe_mesh = moe.make_moe_mesh(device_type=dev.type, **run.moe_sizes)
    mparams = moe.shard_params(inputs["moe_params"], run.moe_cfg, moe_mesh)
    mopt = moe.make_optimizer().init(mparams)
    mstep = moe.make_train_step(run.moe_cfg, moe_mesh, device=dev)
    _, _, mloss = mstep(mparams, mopt, inputs["moe_batch"])
    return {"rank": dist.get_rank(),
            "coordinate": dict(zip(mesh.mesh_dim_names,
                                   mesh.get_coordinate())),
            "moe_coordinate": dict(zip(moe_mesh.mesh_dim_names,
                                       moe_mesh.get_coordinate())),
            "loss": float(loss), "moe_loss": float(mloss),
            "launches": flash_attention.counts()}


def _rank_main() -> dict:
    """A rank process of :func:`dryrun_multichip`: its rank, the world,
    the store's port and the device type from the environment."""
    from torch import distributed as dist
    from .workloads import rendezvous
    rank, n = int(os.environ["DRYRUN_RANK"]), int(os.environ["DRYRUN_N"])
    device = torch.device(os.environ["DRYRUN_DEVICE"])
    if device.type == "cuda":
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    rendezvous.init_process_group(
        "127.0.0.1", int(os.environ["DRYRUN_PORT"]), rank, n,
        "nccl" if device.type == "cuda" else "gloo", timeout=300.0,
        bind_ip="127.0.0.1")
    try:
        return dryrun_rank(n, device)
    finally:
        dist.destroy_process_group()


_RANK = ("import json; from kubernetes_tpu_torch import entry; "
         "print(json.dumps(entry._rank_main()))")


def dryrun_multichip(n_devices: int, device=None,
                     timeout: float = 600.0) -> list:
    """One dense train step over ``default_axis_sizes(n_devices)`` and
    one MoE ep step (:func:`dryrun_config`), each rank a process of its
    own: NCCL on the first ``n_devices`` cards (the default), or gloo
    with ``device="cpu"``. Raises when fewer than ``n_devices`` cards
    are present (there is no CPU fallback), when a rank fails or
    outlasts ``timeout`` seconds, or unless both losses are finite and
    positive on every rank. Returns each rank's :func:`dryrun_rank`."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        resolve_device(dev)
        if torch.cuda.device_count() < n_devices:
            raise RuntimeError(f"dryrun_multichip({n_devices}) needs "
                               f"{n_devices} CUDA devices, this host has "
                               f"{torch.cuda.device_count()}")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH"))
                           if p)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK], cwd=root,
        env={**os.environ, "PYTHONPATH": path, "DRYRUN_RANK": str(r),
             "DRYRUN_N": str(n_devices), "DRYRUN_PORT": str(port),
             "DRYRUN_DEVICE": dev.type},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(n_devices)]
    ranks = []
    try:
        for r, proc in enumerate(procs):
            out, err = proc.communicate(timeout=timeout)
            if proc.returncode != 0:
                raise RuntimeError(f"dryrun rank {r}: exit "
                                   f"{proc.returncode}: {err[-3000:]}")
            ranks.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for row in ranks:
        for key in ("loss", "moe_loss"):
            if not (math.isfinite(row[key]) and row[key] > 0):
                raise AssertionError(f"dryrun rank {row['rank']}: {key} "
                                     f"{row[key]}")
    return ranks


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print("entry ok", tuple(out.shape))
    dryrun_multichip(torch.cuda.device_count())
    print("dryrun_multichip ok")
