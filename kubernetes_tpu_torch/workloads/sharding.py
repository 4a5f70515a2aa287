"""Mesh construction over the ranks of a process group.

Counterpart of ``kubernetes_tpu/workloads/sharding.py``: the four
canonical training axes, in the reference's order and under its names,

- ``dp``   pure data parallelism (gradients all-reduced),
- ``fsdp`` data parallelism with parameters sharded,
- ``sp``   sequence/context parallelism (ring attention),
- ``tp``   tensor parallelism (attention heads + FFN columns),

as a ``torch.distributed.device_mesh.DeviceMesh`` with one device per
rank, and the reference's partition specs for activations and token
batches, each a tuple with one entry per tensor dim: None, an axis name,
or a tuple of names. Batch is split over ``(dp, fsdp)``, sequence over
``sp``. :func:`shard` takes this rank's block of a global tensor; no
DTensor is needed, since every rank holds whole params and its own
block of the data. The trainer uses ``dp`` alone
(``workloads/trainer.py``); the LM takes a mesh with ``dp`` and ``sp``
(``workloads/lm.py``). fsdp and tp shard nothing yet: FSDP2 over fsdp,
tensor parallelism over tp and the sharding of params are ROADMAP queue
1 item 4.
"""
from __future__ import annotations

AXES = ("dp", "fsdp", "sp", "tp")

#: Activations [batch, seq, embed].
ACT_SPEC = (("dp", "fsdp"), "sp", None)
#: Token batches [batch, seq].
DATA_SPEC = (("dp", "fsdp"), "sp")


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


def block(tensor, spec: tuple, sizes: dict, coordinate: dict):
    """The block of ``tensor`` at mesh ``coordinate`` ({axis: index}) of
    a mesh of ``sizes`` ({axis: size}) under ``spec``: each dim split
    evenly over its axes, the first axis of a tuple the major one, as
    ``jax.sharding.NamedSharding`` splits it. A view, not a copy. Raises
    when a dim does not split evenly."""
    if len(spec) > tensor.dim():
        raise ValueError(f"spec {spec} has more entries than the tensor's "
                         f"{tensor.dim()} dims")
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else axes
        parts, index = 1, 0
        for axis in axes:
            parts *= sizes[axis]
            index = index * sizes[axis] + coordinate[axis]
        if parts == 1:
            continue
        length = tensor.shape[dim]
        if length % parts:
            raise ValueError(f"dim {dim} of length {length} does not split "
                             f"evenly over {axes} ({parts} parts)")
        tensor = tensor.narrow(dim, index * (length // parts),
                               length // parts)
    return tensor


def mesh_sizes(mesh) -> dict[str, int]:
    """{axis: size} of ``mesh``; every axis 1 for None (one device)."""
    if mesh is None:
        return dict.fromkeys(AXES, 1)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def shard(mesh, tensor, spec: tuple):
    """This rank's block of the global ``tensor`` under ``spec`` (e.g.
    :data:`DATA_SPEC`): rows by its ``(dp, fsdp)`` coordinate, sequence
    by its ``sp`` coordinate. ``mesh=None`` is one device: the whole
    tensor."""
    if mesh is None:
        return tensor
    coordinate = mesh.get_coordinate()
    if coordinate is None:
        raise ValueError("this rank is not on the mesh")
    return block(tensor, spec, mesh_sizes(mesh),
                 dict(zip(mesh.mesh_dim_names, coordinate)))
