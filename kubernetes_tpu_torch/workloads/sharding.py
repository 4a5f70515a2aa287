"""Mesh construction over the ranks of a process group.

Counterpart of ``kubernetes_tpu/workloads/sharding.py``: the four
canonical training axes, in the reference's order and under its names,

- ``dp``   pure data parallelism (gradients all-reduced),
- ``fsdp`` data parallelism with parameters sharded,
- ``sp``   sequence/context parallelism (ring attention),
- ``tp``   tensor parallelism (attention heads + FFN columns),

as a ``torch.distributed.device_mesh.DeviceMesh`` with one device per
rank. The trainer uses ``dp`` alone (``workloads/trainer.py``); the
reference's partition specs (``ACT_SPEC``, ``DATA_SPEC``, ``shard``)
come with the sharded axes.
"""
from __future__ import annotations

AXES = ("dp", "fsdp", "sp", "tp")


def default_axis_sizes(n_devices: int) -> dict[str, int]:
    """Factor a device count into (dp, fsdp, sp, tp) sizes.

    Prefers giving each parallelism style a non-trivial axis when the
    count allows (8 -> fsdp=2, sp=2, tp=2), then grows dp — the axis
    whose collectives are cheapest — with whatever remains.
    """
    sizes = {"dp": 1, "fsdp": 1, "sp": 1, "tp": 1}
    remaining = n_devices
    for axis in ("tp", "sp", "fsdp"):
        if remaining % 2 == 0:
            sizes[axis] = 2
            remaining //= 2
    sizes["dp"] = remaining
    return sizes


def make_mesh(devices=None, *, dp: int = 1, fsdp: int = 1, sp: int = 1,
              tp: int = 1, device_type: str = "cuda"):
    """Mesh with all four canonical axes (unused axes get size 1, so
    every code path is the same at any scale) over the first
    ``dp * fsdp * sp * tp`` of ``devices``: the ranks of the default
    process group (default: all of them), one device of ``device_type``
    (``cuda`` or ``cpu``) each. Every rank of the group calls it."""
    import torch
    from torch import distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    if devices is None:
        devices = list(range(dist.get_world_size()))
    want = dp * fsdp * sp * tp
    if len(devices) < want:
        raise ValueError(f"need {want} devices, have {len(devices)}")
    grid = torch.tensor(devices[:want]).reshape(dp, fsdp, sp, tp)
    return DeviceMesh(device_type, grid, mesh_dim_names=AXES)


def mesh_for(n_devices: int, devices=None, device_type: str = "cuda"):
    return make_mesh(devices, device_type=device_type,
                     **default_axis_sizes(n_devices))
