"""Mesh construction over the ranks of a process group, and the blocks
of tensors laid out on it.

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
``sp``. No DTensor is needed: every rank holds plain tensors, its blocks.
:func:`shard` takes this rank's block of a global tensor,
:func:`shard_params` of every leaf of a tree under a tree of specs (the
LM's ``param_specs``: weights over ``fsdp`` and ``tp``, the MoE's over
``ep`` and ``tp``), and :func:`gather_params` makes the blocks whole
again (checkpoints, tests). :func:`axis_group` is the process group of
one axis through this rank's coordinate. The trainer uses ``dp`` alone
(``workloads/trainer.py``); the LM takes all four axes
(``workloads/lm.py``).
"""
from __future__ import annotations

import math

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
    return block(tensor, spec, mesh_sizes(mesh), _coordinate(mesh))


def spec_axes(spec: tuple) -> set:
    """The axis names that ``spec`` shards any dim over."""
    out = set()
    for axes in spec:
        if axes is not None:
            out.update((axes,) if isinstance(axes, str) else axes)
    return out


def _coordinate(mesh) -> dict:
    coordinate = mesh.get_coordinate()
    if coordinate is None:
        raise ValueError("this rank is not on the mesh")
    return dict(zip(mesh.mesh_dim_names, coordinate))


def axis_group(mesh, axis: str):
    """The process group of ``mesh``'s ``axis`` through this rank's
    coordinate, its group ranks in the axis's order; None for an axis of
    one rank, one the mesh lacks, or no mesh."""
    if mesh is None or mesh_sizes(mesh).get(axis, 1) == 1:
        return None
    from torch import distributed as dist
    group = mesh[axis].get_group()
    # all_gather / reduce_scatter order the blocks by group rank.
    if dist.get_rank(group) != _coordinate(mesh)[axis]:
        raise ValueError(f"the {axis} axis's group ranks are not its mesh "
                         "order")
    return group


def axis_groups(mesh, axes) -> list:
    """Groups whose sums in turn are the sum over ``axes`` of ``mesh``:
    the default group when they span the whole mesh (one collective),
    else the group of each axis of more than one rank."""
    sizes = mesh_sizes(mesh)
    if mesh is not None and math.prod(sizes[a] for a in axes) \
            == math.prod(sizes.values()) > 1:
        from torch import distributed as dist
        return [dist.group.WORLD]
    return [g for g in (axis_group(mesh, a) for a in axes) if g is not None]


def map_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree of dicts, lists and tuples whose
    leaves are tensors, ``specs`` shaped like it with a spec at each
    leaf."""
    if isinstance(tree, dict):
        return {key: map_specs(fn, val, specs[key])
                for key, val in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_specs(fn, val, spec)
                          for val, spec in zip(tree, specs))
    return fn(tree, specs)


def shard_params(mesh, tree, specs):
    """This rank's block of every leaf of ``tree`` under ``specs`` (each
    a copy of its own, so the whole tree can be freed); ``tree`` itself
    for no mesh."""
    if mesh is None:
        return tree
    return map_specs(lambda x, spec: shard(mesh, x, spec).clone(), tree,
                      specs)


def gather(mesh, tensor, spec: tuple):
    """The whole tensor of which ``tensor`` is this rank's block under
    ``spec``: each dim all-gathered over its axes, the minor axis first
    (the inverse of :func:`shard`). Every rank of the mesh calls it."""
    from .collectives import all_gather
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        for axis in reversed((axes,) if isinstance(axes, str) else axes):
            group = axis_group(mesh, axis)
            if group is not None:
                tensor = all_gather(tensor, group, dim)
    return tensor


def gather_params(mesh, tree, specs):
    """The whole tree of which ``tree`` holds this rank's blocks (the
    inverse of :func:`shard_params`), on every rank."""
    if mesh is None:
        return tree
    return map_specs(lambda x, spec: gather(mesh, x, spec), tree, specs)


def whole_shape(shape, spec: tuple, sizes: dict) -> tuple:
    """The shape of the whole tensor whose block under ``spec`` has
    ``shape`` on a mesh of ``sizes``."""
    out = list(shape)
    for dim, axes in enumerate(spec):
        if axes is not None:
            out[dim] *= math.prod(sizes[a] for a in (
                (axes,) if isinstance(axes, str) else axes))
    return tuple(out)
