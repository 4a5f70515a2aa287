"""Ring attention: causal attention with the sequence split over the
``sp`` mesh axis, and the plain attention that is the kernels' numerics
reference.

Counterpart of ``kubernetes_tpu/workloads/ring_attention.py``. Rank
``i`` of the ring holds positions ``[i * Tl, (i + 1) * Tl)`` of q, k and
v. K/V blocks rotate around the ring over ``torch.distributed`` P2P;
after ``s`` rotations rank ``i`` holds block ``j = (i - s) mod sp``,
which is one of three things to its queries:

- ``j == i``, the diagonal block: one launch of the causal flash kernel;
- ``j < i``, a block wholly before the queries: one launch of its
  non-causal instance, which masks nothing;
- ``j > i``, a block wholly after them: nothing to compute, no launch.

Every block gives ``(o_j, lse_j)``, ``o_j`` in f32 (the kernels'
f32-output instances); the blocks merge in f32 (``lse = logsumexp_j
lse_j``, ``o = sum_j exp(lse_j - lse) o_j``) and the output is cast once
to ``q.dtype``. f32 q, k, v (an LM or MoE at ``compute_dtype`` f32) take
the kernels' f32 instances, causal and non-causal alike, and the same
f32 merge and sums. The backward runs the ring again, one
backward launch per block with the merged ``o`` and ``lse``, so that the
kernel's ``P`` is the global softmax restricted to the block and its
``delta`` the global one; dQ accumulates on its rank, dK and dV travel
with their block and are home after ``sp`` rotations; every block's
gradients come out in f32 too, and each sum is rounded once. Peak memory per
rank is O(T / sp), as in the reference.

The per-block arithmetic (:func:`block_forward`, :func:`merge`,
:func:`block_backward`, :func:`accumulate`) is kept apart from the
communication, so :func:`loopback_forward` and :func:`loopback_backward`
compute every rank's share in one process from the list of all blocks,
in the ring's own order. On CUDA tensors the blocks launch the kernels;
on CPU tensors the same ring runs their plain versions, over gloo.
"""
from __future__ import annotations

import dataclasses

import torch

_NEG = -1e30

#: P2P tags of the two rotations the backward has in flight at once.
_KV_TAGS = (0, 1)
_DKV_TAGS = (2, 3)


def causal_mask(t: int, device) -> torch.Tensor:
    """[T, T] bool, True where query row ``i`` may see key ``j <= i``."""
    pos = torch.arange(t, device=device)
    return pos[:, None] >= pos[None, :]


def _masked_scores(q: torch.Tensor, k: torch.Tensor,
                   causal: bool = True) -> torch.Tensor:
    """f32 ``q k^T / sqrt(D)``, [B,H,T,T], plus an additive causal mask
    when ``causal``."""
    d, t = q.shape[-1], q.shape[2]
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / (d ** 0.5)
    if not causal:
        return scores
    return scores + torch.where(causal_mask(t, q.device), 0.0, _NEG)


def reference_attention(q, k, v) -> torch.Tensor:
    """Plain global causal attention over [B, H, T, D]; f32 softmax,
    output in ``q.dtype``."""
    p = torch.softmax(_masked_scores(q, k), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def reference_attention_with_lse(q, k, v, causal: bool = True,
                                 out_dtype=None):
    """Plain attention, causal or not, in ``out_dtype`` (default
    ``q.dtype``), and the natural-log row sums of the scaled (masked)
    scores, ``lse`` [B, H, T] f32: the plain version of the
    flash-attention kernel's two outputs."""
    scores = _masked_scores(q, k, causal)
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(out_dtype or q.dtype)
    return o, torch.logsumexp(scores, dim=-1)


# -- The per-block arithmetic, apart from the communication. --

def block_forward(q, k, v, i: int, j: int):
    """Rank ``i``'s queries against block ``j``'s keys: ``(o_j, lse_j)``
    of one forward launch, causal on the diagonal, non-causal for a block
    before it, ``o_j`` in f32; None for a block after it, which launches
    nothing."""
    if j > i:
        return None
    from .flash_attention import flash_attention_fwd
    return flash_attention_fwd(q, k, v, causal=j == i,
                               out_dtype=torch.float32)


def merge(acc, part):
    """``acc`` (None, or the f32 ``(o, lse)`` of the blocks so far)
    merged with one block's ``(o_j, lse_j)`` (or None), in f32."""
    if part is None:
        return acc
    if acc is None:
        return part
    (o, lse), (o_j, lse_j) = acc, part
    new = torch.logaddexp(lse, lse_j)
    return (o * torch.exp(lse - new)[..., None]
            + o_j * torch.exp(lse_j - new)[..., None]), new


def block_backward(q, k, v, o, lse, do, i: int, j: int):
    """``(dq_j, dk_j, dv_j)`` of block ``j`` for rank ``i``'s queries,
    in f32, given the whole sequence's ``o`` and ``lse``: one backward
    launch, causal on the diagonal, non-causal before it; None after
    it."""
    if j > i:
        return None
    from .flash_attention import flash_attention_bwd
    return flash_attention_bwd(q, k, v, o, lse, do, causal=j == i,
                               out_dtype=torch.float32)


def rank_forward(q, held, i: int, n: int):
    """The f32 ``(o, lse)`` of rank ``i`` of a ring of ``n``: its blocks
    (:func:`block_forward`) merged in ring order, ``held`` being the
    ``(k, v)`` it holds after ``s = 0 .. n-1`` rotations."""
    acc = None
    for s, (k, v) in enumerate(held):
        acc = merge(acc, block_forward(q, k, v, i, (i - s) % n))
    return acc


def accumulate(acc, part):
    """``acc`` (None or an f32 tensor) plus one block's f32 gradient (or
    None), in place."""
    if part is None:
        return acc
    if acc is None:
        return part
    return acc.add_(part)


# -- The ring over torch.distributed. --

@dataclasses.dataclass(frozen=True)
class Ring:
    """This rank's place on the ring of one mesh axis: its ``index`` on
    that axis of ``size`` ranks, the axis's process ``group`` and the
    global ranks of the ``next`` and ``prev`` members, to which K/V go
    and from which they come."""
    index: int
    size: int
    group: object
    next: int
    prev: int


def ring_of(mesh, seq_axis: str = "sp") -> Ring | None:
    """This rank's :class:`Ring` on ``mesh``'s ``seq_axis``: the ranks
    that share its every other coordinate (each ``(dp, fsdp, tp)``
    coordinate has a ring of its own); None without a mesh or when the
    axis has one member. Peers are global ranks, read from the mesh in
    the axis's order: under ``dp > 1`` or ``tp > 1`` the axis group's
    own ranks are not the global ones."""
    if mesh is None:
        return None
    axis = mesh[seq_axis]
    size = axis.size()
    if size == 1:
        return None
    ranks = axis.mesh.tolist()
    index = axis.get_local_rank()
    return Ring(index, size, axis.get_group(), ranks[(index + 1) % size],
                ranks[(index - 1) % size])


def rotate(ring: Ring, tensors, tags):
    """Posts one rotation: each of ``tensors`` to the next rank, as many
    fresh buffers filled from the previous one, in one
    ``batch_isend_irecv`` (at ``sp = 2`` both go to and come from one
    peer). Returns ``(buffers, works)``; the buffers hold the data once
    every work has been waited on."""
    from torch import distributed as dist
    recv = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t, ring.next, ring.group, tag)
           for t, tag in zip(tensors, tags)]
    ops += [dist.P2POp(dist.irecv, r, ring.prev, ring.group, tag)
            for r, tag in zip(recv, tags)]
    return recv, dist.batch_isend_irecv(ops)


def received(pending):
    """The buffers of a :func:`rotate`, once its data has arrived."""
    buffers, works = pending
    for work in works:
        work.wait()
    return buffers


def _rotating(ring: Ring, k, v):
    """Yields the ``(k, v)`` this rank holds after ``s = 0 .. sp-1``
    rotations: each rotation is posted before the block in hand is
    yielded and waited on after it comes back, so the copy overlaps the
    kernel. ``sp - 1`` rotations: the last block is not sent on. Every
    rank makes the same calls, whether its block launches or not."""
    for s in range(ring.size):
        last = s == ring.size - 1
        pending = None if last else rotate(ring, (k, v), _KV_TAGS)
        yield k, v
        if pending is not None:
            k, v = received(pending)


def ring_forward(q, k, v, ring: Ring | None):
    """``(o, lse)`` of causal attention of this rank's [B, H, Tl, D]
    queries over the whole ring's keys: ``o`` in ``q.dtype``, ``lse``
    f32. Without a ring (one member), one causal launch."""
    from .flash_attention import flash_attention_fwd
    if ring is None:
        return flash_attention_fwd(q, k, v)
    o, lse = rank_forward(q, _rotating(ring, k, v), ring.index, ring.size)
    return o.to(q.dtype), lse


def ring_backward(q, k, v, o, lse, do, ring: Ring | None):
    """``(dq, dk, dv)`` of this rank's blocks, in ``q.dtype``, given the
    merged ``o`` and ``lse`` of :func:`ring_forward` and this rank's
    output gradient ``do``. K/V rotate as in the forward; each block's
    f32 dK/dV accumulator rotates with a lag of one step (posted after
    the block's launch, waited on after the next one's), ``sp`` times, so
    that it is home at the end."""
    from .flash_attention import flash_attention_bwd
    if ring is None:
        return flash_attention_bwd(q, k, v, o, lse, do)
    dq, pending = None, None
    for s, (k_s, v_s) in enumerate(_rotating(ring, k, v)):
        j = (ring.index - s) % ring.size
        dq_j, dk_j, dv_j = (block_backward(q, k_s, v_s, o, lse, do,
                                           ring.index, j)
                            or (None, None, None))
        dq = accumulate(dq, dq_j)
        dk, dv = received(pending) if pending is not None else (None, None)
        pending = rotate(ring, (accumulate(dk, dk_j), accumulate(dv, dv_j)),
                         _DKV_TAGS)
    dk, dv = received(pending)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


class RingAttention(torch.autograd.Function):
    """Differentiable ring attention: :func:`ring_forward`, saving the
    local q, k, v and the merged o and lse, and :func:`ring_backward`,
    written out rather than differentiated through the send and recv."""

    @staticmethod
    def forward(ctx, q, k, v, ring):
        o, lse = ring_forward(q, k, v, ring)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.ring = ring
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = ring_backward(q, k, v, o, lse, do.contiguous(),
                                   ctx.ring)
        return dq, dk, dv, None


def ring_attention(q, k, v, mesh, *, seq_axis: str = "sp",
                   batch_axes: tuple = ("dp", "fsdp")) -> torch.Tensor:
    """Causal MHA over this rank's [B, H, Tl, D] blocks of q, k and v,
    laid out as the reference's spec ``(batch_axes, "tp", seq_axis,
    None)``: the batch split over ``batch_axes`` (the dense LM's ``(dp,
    fsdp)``, the MoE's ``(dp, ep)``), the heads over ``tp``, the sequence
    over the ring axis ``seq_axis``; each tp coordinate has a ring of its
    own (:func:`ring_of`). Degenerates to one causal launch when the ring
    has one member or ``mesh`` is None. Differentiable
    (:class:`RingAttention`) while grad is enabled."""
    if mesh is not None:
        spec = (batch_axes, "tp", seq_axis, None)
        missing = [a for a in (*batch_axes, "tp", seq_axis)
                   if a not in mesh.mesh_dim_names]
        if missing:
            raise ValueError(f"mesh has no axis {missing} of the spec "
                             f"{spec}")
    return ring_apply(q, k, v, ring_of(mesh, seq_axis))


def ring_apply(q, k, v, ring: Ring | None) -> torch.Tensor:
    """:func:`ring_attention` on a :class:`Ring` already looked up (the
    LM looks it up once a forward, not once a layer)."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if torch.is_grad_enabled():
        return RingAttention.apply(q, k, v, ring)
    return ring_forward(q, k, v, ring)[0]


def gathered_attention(q, k, v, ring: Ring | None) -> torch.Tensor:
    """The ring's plain version, in any dtype: causal attention of this
    rank's [B, H, Tl, D] queries over the whole ring's keys, K and V
    all-gathered over the ring's group (their gradients reduce-scattered
    back, ``collectives.gather``), f32 softmax, the output in
    ``q.dtype``; :func:`reference_attention` without a ring. The mesh
    runs' f32 witness steps through it, beside their f32 steps through
    the ring itself."""
    if ring is None:
        return reference_attention(q, k, v)
    from torch import distributed as dist
    from .collectives import gather
    if dist.get_rank(ring.group) != ring.index:
        raise ValueError("the ring's group ranks are not its order")
    k, v = gather(k, ring.group, 2), gather(v, ring.group, 2)
    d, tl = q.shape[-1], q.shape[2]
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / d ** 0.5
    rows = torch.arange(tl, device=q.device) + ring.index * tl
    cols = torch.arange(k.shape[2], device=q.device)
    scores = scores + torch.where(rows[:, None] >= cols[None, :], 0.0, _NEG)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


# -- One process, every rank: the ring's arithmetic without the ring. --

def loopback_forward(qs, ks, vs) -> list:
    """``[(o_i, lse_i)]`` for every rank ``i`` of a ring of ``len(qs)``,
    from the lists of all ranks' blocks, by the ring's block arithmetic
    in its order."""
    n = len(qs)
    out = []
    for i in range(n):
        held = [(ks[(i - s) % n], vs[(i - s) % n]) for s in range(n)]
        o, lse = rank_forward(qs[i], held, i, n)
        out.append((o.to(qs[i].dtype), lse))
    return out


def loopback_backward(qs, ks, vs, os, lses, dos) -> list:
    """``[(dq_i, dk_i, dv_i)]`` for every rank ``i``, as
    :func:`ring_backward` computes them, in one process: block ``j``'s
    dK/dV take the ranks' contributions in the order the ring's
    accumulator meets them (ranks ``j, j+1, ...``)."""
    n = len(qs)
    dq, dk, dv = [None] * n, [None] * n, [None] * n
    for i in range(n):
        for s in range(n):
            j = (i - s) % n
            dq_j, dk_j, dv_j = (block_backward(qs[i], ks[j], vs[j], os[i],
                                               lses[i], dos[i], i, j)
                                or (None, None, None))
            dq[i] = accumulate(dq[i], dq_j)
            dk[j] = accumulate(dk[j], dk_j)
            dv[j] = accumulate(dv[j], dv_j)
    dtype = qs[0].dtype
    return [(a.to(dtype), b.to(dtype), c.to(dtype))
            for a, b, c in zip(dq, dk, dv)]
