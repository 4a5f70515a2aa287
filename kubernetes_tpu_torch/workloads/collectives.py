"""Collectives over ``torch.distributed`` whose backward is their
transpose, and the gradient sums of a mesh.

- :func:`all_gather` / :func:`reduce_scatter` / :func:`all_reduce`: the
  plain collectives, along any dim, on a fresh tensor;
- :class:`_AllReduce`: a sum over groups whose backward is the same sum
  of the gradients (the MoE's aux loss);
- :func:`gather`: the fsdp gather, all-gather along a dim forward and
  reduce-scatter of the gradient backward (in f32, cast back once), so
  a parameter sharded over ``fsdp`` is whole inside a layer and its
  gradient comes back summed over the axis and sharded again;
- :func:`enter_tp` / :func:`leave_tp`: the Megatron pair over ``tp``.
  "enter" is the identity forward and an all-reduce of the gradient
  backward (a tp-replicated activation feeding column-sharded weights);
  "leave" is an all-reduce forward (the partial sums of row-sharded
  weights) and the identity backward. Both sum in f32 and cast back
  once;
- :func:`reduce_gradients_`: each gradient summed over the ranks that
  hold a replica of its leaf's block (in f32) and divided by the number
  of token blocks, the one rule of the dense LM's and the MoE's steps;
- :func:`counts`: the train steps' exchanges of their loss and
  gradients so far, the all-reduces those issued and their bytes.

Every sum of activations or gradients runs in f32 and casts back once:
a bf16 sum would round each partial and each running total, where one
device rounds each value once.

Each of them is the identity, and launches nothing, where its group is
None: an axis of one rank.
"""
from __future__ import annotations

import math

import torch


def _dist():
    from torch import distributed as dist
    return dist


#: The loss and gradient exchanges so far: ``exchanges``, one a train
#: step under a group or mesh (:func:`count_exchange`); ``calls`` and
#: ``bytes``, the all-reduces they issued and the bytes each reduced
#: (:func:`count_all_reduce`, where they are issued).
_exchanged = {"exchanges": 0, "calls": 0, "bytes": 0}


def counts() -> dict:
    """The exchanges, all-reduce calls and bytes so far."""
    return dict(_exchanged)


def zero_counts() -> None:
    """Every exchange counter to 0."""
    for name in _exchanged:
        _exchanged[name] = 0


def count_exchange() -> None:
    """One train step's exchange of its loss and gradients begins."""
    _exchanged["exchanges"] += 1


def count_all_reduce(x: torch.Tensor, calls: int = 1) -> None:
    """``calls`` all-reduces of ``x`` for the loss or gradients."""
    _exchanged["calls"] += calls
    _exchanged["bytes"] += calls * x.numel() * x.element_size()


def all_reduce(x: torch.Tensor, groups) -> torch.Tensor:
    """A copy of ``x`` summed over the ranks of each of ``groups`` in
    turn (None in ``groups``: the default group)."""
    x = x.contiguous().clone()
    for group in groups:
        _dist().all_reduce(x, group=group)
    return x


def reduce_scatter(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """``x`` summed over ``group``, this rank's part of ``dim`` (the
    parts in group-rank order)."""
    n = _dist().get_world_size(group)
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // n, *x.shape[1:]))
    _dist().reduce_scatter_tensor(out, x, group=group)
    return out.movedim(0, dim).contiguous()


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` of ``group`` concatenated along ``dim`` in
    group-rank order."""
    n = _dist().get_world_size(group)
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] * n, *x.shape[1:]))
    _dist().all_gather_into_tensor(out, x, group=group)
    return out.movedim(0, dim).contiguous()


class _AllReduce(torch.autograd.Function):
    """Sum over the ranks of each of ``groups`` in turn; the backward is
    the same sum of the gradients."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return all_reduce(x, groups)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.groups), None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` over ``group``; backward: reduce-scatter
    of the gradient along the same dim, in f32."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter(grad.float(), ctx.group, ctx.dim).to(
            grad.dtype), None, None


def gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The fsdp gather: ``x`` whole along ``dim`` (identity without a
    group)."""
    return x if group is None else _Gather.apply(x, group, dim)


def _sum_f32(x: torch.Tensor, group) -> torch.Tensor:
    return all_reduce(x.float(), (group,)).to(x.dtype)


class _EnterTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _sum_f32(grad, ctx.group), None


class _LeaveTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum_f32(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def enter_tp(x: torch.Tensor, group) -> torch.Tensor:
    """A tp-replicated activation entering column-sharded weights: the
    identity; its gradient summed over ``group`` (in f32)."""
    return x if group is None else _EnterTp.apply(x, group)


def leave_tp(x: torch.Tensor, group) -> torch.Tensor:
    """The partial sums of row-sharded weights, summed over ``group`` in
    f32 and cast back once; the gradient passes unchanged."""
    return x if group is None else _LeaveTp.apply(x, group)


def reduce_gradients_(grads: list, specs: list, mesh,
                      token_axes: tuple) -> None:
    """Sum each of ``grads`` in place over the ``token_axes`` (the axes
    that split the global batch) on which its leaf is not sharded, and
    divide by the number of token blocks, the product of their sizes.
    ``specs``: each leaf's partition spec. An axis a leaf is sharded on
    was summed over already, by the collective that made the leaf whole
    (the fsdp gather's reduce-scatter, the expert exchange). tp, outside
    ``token_axes``, is never summed: a tp-sharded leaf's blocks differ,
    and a tp-replicated leaf carries the whole gradient on every tp rank
    (:func:`enter_tp`). One flat f32 all-reduce per set of axes; each
    gradient cast back to its dtype once, after the division."""
    from .sharding import axis_groups, mesh_sizes, spec_axes
    sizes = mesh_sizes(mesh)
    blocks = math.prod(sizes[a] for a in token_axes)
    buckets: dict = {}
    for g, spec in zip(grads, specs):
        axes = tuple(a for a in token_axes
                     if sizes[a] > 1 and a not in spec_axes(spec))
        buckets.setdefault(axes, []).append(g)
    for axes, same in buckets.items():
        flat = torch.cat([g.reshape(-1).float() for g in same])
        groups = axis_groups(mesh, axes)
        count_all_reduce(flat, len(groups))
        flat = all_reduce(flat, groups).div_(blocks)
        for g, part in zip(same, flat.split([g.numel() for g in same])):
            g.copy_(part.view_as(g))
