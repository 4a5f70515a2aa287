"""Mixture-of-Experts transformer, with expert parallelism over ``ep``.

Counterpart of ``kubernetes_tpu/workloads/moe.py``: the same config,
parameter tree, GShard top-k routing under a fixed capacity, dense
one-hot dispatch and combine einsums, SwiGLU experts in the compute
dtype, Switch aux loss, and causal attention through
:func:`~.ring_attention.ring_apply` (the hand-written flash kernels on
CUDA tensors: one causal launch a layer at ``sp = 1``, the ring of
causal and non-causal launches at ``sp > 1``; their plain versions on
CPU tensors).

The mesh (:func:`make_moe_mesh`) has the reference's axes ``(dp, ep, sp,
tp)``. Every public function takes the GLOBAL token batch; a rank at
``(dp i, ep j, sp s)`` computes rows ``[(i * ep + j) * Bl, ...)`` and
positions ``[s * Tl, (s + 1) * Tl)`` of it (:data:`MOE_ACT_SPEC`), and
holds the ``E / ep`` experts of its ep index (:func:`param_specs`,
:func:`shard_params`). Under ``tp`` it holds its block of the q/k/v
columns and ``wo`` rows (``H / tp`` heads, as in the dense LM) and of
every expert's ``w1/w3`` columns and ``w2`` rows; the activations
entering those weights are tp-replicated (``collectives.enter_tp``) and
the attention's and experts' partial sums are all-reduced over tp in f32
(``collectives.leave_tp``), the experts' before :func:`from_experts`.
The router stays replicated and in f32, so the tp ranks of one token
block route it alike. The reference's routing and einsums run on global
arrays under ``jit``, and the port keeps their semantics exactly:

- one capacity ``C`` for all ``N = B * T`` tokens of the mesh, each
  expert's buffer filled in global token order ``n = b * T + t``: every
  rank learns, per layer, the exclusive prefix of every earlier (row,
  sp segment)'s picks per round and expert from one ``all_gather`` of
  its ``[k, Bl, E]`` pick counts (:func:`_positions`);
- the aux loss over the global batch (its ``mean(probs)`` all-reduced);
- the expert buffers ``[E, C, d]`` as the reference constrains them,
  ``P("ep", None, None)``: each rank fills its own tokens' slots (the
  slots are disjoint across the mesh, so every sum below is exact),
  reduce-scatters them over ``ep``, all-reduces them over the ``dp``
  and ``sp`` ranks of its ep index (the replicas of its experts), runs
  its experts, and all-gathers their outputs over ``ep``
  (:class:`_ToExperts`, :class:`_FromExperts`); each collective's
  backward is its transpose;
- the gradients of one step over the global batch: the loss averaged
  over the mesh, the dense gradients summed over the token blocks'
  ranks, expert gradients over their replicas (each replica saw only its
  ep group's tokens' output gradients), each divided by the number of
  token blocks (:func:`loss_and_grads`).

At any ``(dp, ep, sp, tp)`` the forward logits, the loss and every
gradient are the one-process forward's and step's on the global batch
(``tests/test_torch_moe_ep.py``).

``MoEConfig.layer_types`` (LFM2's hybrid stack; one device) stacks the
params per kind, not per layer (:func:`_hybrid_shapes`): each layer's
mixer is a gated short conv (:func:`causal_conv`) or GQA attention with
q/k norms (one causal launch of the flash kernels, k and v repeated to
the query heads), its FFN a dense SwiGLU (the first ``n_dense_layers``)
or the experts. Their router picks by sigmoid score plus an expert bias
that only selects and moves after each step outside the gradient
(:func:`update_bias_`); its picks, sorted by expert, run through
:class:`Dispatch`, :class:`Experts` (grouped GEMMs over each expert's
rows: ``torch._grouped_mm`` on the card, a loop on the CPU) and
:class:`Combine` (the hand-written gather kernels of
``csrc/moe_permute.cu`` on the card, their plain versions on the CPU),
with no capacity, so nothing dropped, and nothing that waits for the
device. :func:`counts` counts that work.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..kernels import build
from ..tracing import span
from . import lm, sharding
from .collectives import (_AllReduce, all_gather, all_reduce, count_exchange,
                          enter_tp, leave_tp, reduce_gradients_,
                          reduce_scatter)
from .flash_attention import FlashAttention, flash_attention
from .lm import Layout, _leaves, _rms_norm, _rope, _tree_map, make_optimizer
from .ring_attention import ring_apply
from .sharding import mesh_sizes, shard

MOE_AXES = ("dp", "ep", "sp", "tp")

#: Activations [batch, seq, embed]: batch over (dp, ep), the ep axis
#: doubling as data parallelism outside the expert computation.
MOE_ACT_SPEC = (("dp", "ep"), "sp", None)
#: Token batches [batch, seq].
MOE_DATA_SPEC = (("dp", "ep"), "sp")

#: The expert weights, sharded over ep on their expert dim (dim 1).
EXPERT_KEYS = ("w1", "w3", "w2")
#: The axes that split the global batch into token blocks.
TOKEN_AXES = ("dp", "ep", "sp")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    vocab: int = 256
    d_model: int = 128
    n_layers: int = 2
    n_heads: int = 4
    d_ff: int = 256
    n_experts: int = 4
    top_k: int = 2
    #: Per-expert buffer = capacity_factor * top_k * tokens / experts.
    capacity_factor: float = 1.25
    aux_loss_weight: float = 1e-2
    rope_base: float = 10_000.0
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    remat: bool = True
    # The options below, at their defaults, are the GShard model above;
    # any other value needs ``layer_types`` (the stack of per-kind
    # parameter groups, :func:`init_params`) and one device.
    #: Each layer's token mixer, "attention" or "conv" (the gated short
    #: conv); () is every layer attention, in one stacked tree. Given, the
    #: experts are routed by sigmoid score plus an expert bias and
    #: dispatched without a capacity (:func:`sorted_moe_ffn`): no capacity
    #: factor, no aux loss.
    layer_types: tuple = ()
    #: Key/value heads of the attention (GQA); 0: ``n_heads``.
    n_kv_heads: int = 0
    #: RMSNorm over the head dim on q and k, before RoPE.
    qk_norm: bool = False
    #: The short conv's kernel size (depthwise, causal).
    conv_kernel: int = 3
    #: The leading layers whose FFN is one dense SwiGLU of ``dense_d_ff``.
    n_dense_layers: int = 0
    dense_d_ff: int = 0
    #: The sigmoid router's top-k weights over their sum (+ 1e-6), then
    #: times ``routed_scale``.
    norm_topk: bool = True
    routed_scale: float = 1.0
    #: The expert bias's step after each train step:
    #: bias += rate * sign(mean load - load).
    bias_rate: float = 1e-3

    def __post_init__(self):
        if self.d_model % self.n_heads:
            raise ValueError("d_model must divide into heads")
        if not 1 <= self.top_k <= self.n_experts:
            raise ValueError("need 1 <= top_k <= n_experts")
        if self.n_heads % self.kv_heads:
            raise ValueError(f"n_kv_heads={self.n_kv_heads} must divide "
                             f"n_heads={self.n_heads}")
        if not self.layer_types:
            changed = [f.name for f in dataclasses.fields(self)
                       if f.name in _HYBRID_OPTIONS
                       and getattr(self, f.name) != f.default]
            if changed:
                raise ValueError(f"{changed} need layer_types (the per-kind "
                                 f"stacks)")
            return
        if len(self.layer_types) != self.n_layers \
                or set(self.layer_types) - set(MIXERS):
            raise ValueError(f"layer_types must give each of the "
                             f"{self.n_layers} layers one of {MIXERS}")
        if not 0 <= self.n_dense_layers <= self.n_layers \
                or (self.n_dense_layers and self.dense_d_ff <= 0):
            raise ValueError("need 0 <= n_dense_layers <= n_layers, and "
                             "dense_d_ff > 0 with dense layers")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def hybrid(self) -> bool:
        """Whether the layers are stacked per kind (``layer_types``)."""
        return bool(self.layer_types)

    @property
    def sparse_layers(self) -> int:
        return self.n_layers - self.n_dense_layers


#: The mixers of ``layer_types``.
MIXERS = ("attention", "conv")
#: The options that need ``layer_types``.
_HYBRID_OPTIONS = ("n_kv_heads", "qk_norm", "conv_kernel", "n_dense_layers",
                   "dense_d_ff", "norm_topk", "routed_scale", "bias_rate")


def make_moe_mesh(devices=None, *, dp: int = 1, ep: int = 1, sp: int = 1,
                  tp: int = 1, device_type: str = "cuda"):
    """Mesh of the axes :data:`MOE_AXES` over the first ``dp * ep * sp *
    tp`` of ``devices``: the ranks of the default process group (default:
    all of them), one device of ``device_type`` each. Every rank of the
    group calls it."""
    from torch import distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    if devices is None:
        devices = list(range(dist.get_world_size()))
    want = dp * ep * sp * tp
    if len(devices) < want:
        raise ValueError(f"need {want} devices, have {len(devices)}")
    grid = torch.tensor(devices[:want]).reshape(dp, ep, sp, tp)
    return DeviceMesh(device_type, grid, mesh_dim_names=MOE_AXES)


def param_specs(cfg: MoEConfig) -> dict:
    """The reference's specs, one entry per dim: q/k/v columns and ``wo``
    rows over tp, as in the dense LM; the experts over ep, their
    ``w1/w3`` columns and ``w2`` rows over tp; the rest replicated. The
    per-kind stacks (``cfg.hybrid``) run on one device: every leaf
    replicated."""
    if cfg.hybrid:
        return _tree_map(lambda shape: (None,) * len(shape),
                         _hybrid_shapes(cfg))
    return {
        "embed": (None, None),
        "layers": {
            "ln1": (None, None),
            "wq": (None, None, "tp"),
            "wk": (None, None, "tp"),
            "wv": (None, None, "tp"),
            "wo": (None, "tp", None),
            "ln2": (None, None),
            "router": (None, None, None),
            "w1": (None, "ep", None, "tp"),
            "w3": (None, "ep", None, "tp"),
            "w2": (None, "ep", "tp", None),
        },
        "ln_f": (None,),
    }


def init_params(generator: torch.Generator, cfg: MoEConfig) -> dict:
    """Random params on ``generator``'s device, the reference's tree,
    shapes and scales. The numbers differ from ``jax.random``'s; use
    :func:`params_from_jax` where both sides need the same params. With
    ``cfg.hybrid`` the per-kind stacks (:func:`_hybrid_shapes`), and
    with sparse layers ``expert_bias``, f32 zeros."""
    dt, dev = cfg.param_dtype, generator.device
    if cfg.hybrid:
        return _hybrid_init(generator, cfg)

    def norm(shape, scale):
        x = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32)
        return (x * scale).to(dt)

    L, d, ff, E = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "embed": norm((cfg.vocab, d), d ** -0.5),
        "layers": {
            "ln1": torch.ones((L, d), dtype=dt, device=dev),
            "wq": norm((L, d, d), d ** -0.5),
            "wk": norm((L, d, d), d ** -0.5),
            "wv": norm((L, d, d), d ** -0.5),
            "wo": norm((L, d, d), d ** -0.5),
            "ln2": torch.ones((L, d), dtype=dt, device=dev),
            "router": norm((L, d, E), d ** -0.5),
            "w1": norm((L, E, d, ff), d ** -0.5),
            "w3": norm((L, E, d, ff), d ** -0.5),
            "w2": norm((L, E, ff, d), ff ** -0.5),
        },
        "ln_f": torch.ones((d,), dtype=dt, device=dev),
    }


#: ``params_from_jax(tree, cfg, device)``: the reference's parameter tree
#: (leaves as numpy arrays) as this module's global params, in
#: ``cfg.param_dtype`` on ``device``; both sides store weights
#: ``[in, out]``, as the LM's do.
params_from_jax = lm.params_from_jax


def _check_mesh(cfg: MoEConfig, mesh) -> dict:
    """The mesh's axis sizes, after the refusals: a mesh of other axes
    and experts that do not split over ep."""
    if mesh is None:
        return dict.fromkeys(MOE_AXES, 1)
    if cfg.hybrid and mesh.size() > 1:
        raise ValueError(
            "layer_types and its options run on one device: the sorted "
            "dispatch has no all-to-all over ep, kv heads do not split "
            "over tp, and the short conv has no halo over sp")
    if tuple(mesh.mesh_dim_names) != MOE_AXES:
        raise ValueError(f"an MoE mesh has the axes {MOE_AXES} "
                         f"(make_moe_mesh), not {mesh.mesh_dim_names}")
    sizes = mesh_sizes(mesh)
    if cfg.n_experts % sizes["ep"]:
        raise ValueError(f"n_experts={cfg.n_experts} does not split over "
                         f"ep={sizes['ep']}")
    return sizes


def shard_params(params: dict, cfg: MoEConfig, mesh=None) -> dict:
    """This rank's params of the global ``params`` (:func:`param_specs`):
    the ``E / ep`` experts of its ep index and, under tp, its block of
    the heads and expert FFN columns, each a copy of its own."""
    _check_mesh(cfg, mesh)
    return sharding.shard_params(mesh, params, param_specs(cfg))


# -- The mesh, as one forward sees it. --

def expert_mesh(mesh) -> Layout | None:
    """The :class:`~.lm.Layout` of ``mesh``, the same type the dense LM
    uses (here: its sp ring, the ep and tp groups, the dp and sp groups
    that hold the replicas of this rank's experts, sizes, coordinate and
    mesh order); None without a mesh or for one rank, the single-device
    path. The mesh must span the default process group, over which the
    pick counts, the aux loss and the dense gradients are reduced."""
    if mesh is None or mesh.size() == 1:
        return None
    from torch import distributed as dist
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"the mesh's {mesh.size()} ranks must span the "
                         f"process group's {dist.get_world_size()}")
    return lm.mesh_layout(mesh)


# -- The expert exchange: collectives whose backward is their transpose
# (``collectives.py``). --

class _ToExperts(torch.autograd.Function):
    """[E, C, d] slots filled by this rank -> [E / ep, C, d] of its ep
    index's experts, summed over the mesh: reduce-scatter over ep, then
    all-reduce over the experts' replicas. Backward: all-reduce over the
    replicas, all-gather over ep."""

    @staticmethod
    def forward(ctx, x, em: Layout):
        ctx.em = em
        if em.ep is not None:
            x = reduce_scatter(x, em.ep)
        return all_reduce(x, em.replicas)

    @staticmethod
    def backward(ctx, grad):
        grad = all_reduce(grad, ctx.em.replicas)
        if ctx.em.ep is not None:
            grad = all_gather(grad, ctx.em.ep)
        return grad, None


class _FromExperts(torch.autograd.Function):
    """[E / ep, C, d] outputs of this rank's experts -> [E, C, d] of all
    experts: all-gather over ep. Backward: reduce-scatter over ep."""

    @staticmethod
    def forward(ctx, x, em: Layout):
        ctx.em = em
        return x if em.ep is None else all_gather(x, em.ep)

    @staticmethod
    def backward(ctx, grad):
        if ctx.em.ep is None:
            return grad, None
        return reduce_scatter(grad, ctx.em.ep), None


def to_experts(buffers: torch.Tensor, em: Layout | None):
    """The expert exchange, token side to expert side (identity without
    a mesh)."""
    return buffers if em is None else _ToExperts.apply(buffers, em)


def from_experts(outputs: torch.Tensor, em: Layout | None):
    """The expert exchange, expert side back to token side."""
    return outputs if em is None else _FromExperts.apply(outputs, em)


# -- Routing. --

def _positions(picks: torch.Tensor, rows: int, em: Layout | None):
    """``(before [k, n, E], totals [k, E])`` for this rank's ``picks``
    ([k, n, E] one-hot int64 of each round, ``n = rows * Tl`` tokens in
    row-major order): how many tokens before each one in GLOBAL order
    (``b * T + t``) picked each expert in the same round, and each
    round's total picks over the mesh. Without a mesh the rank's tokens
    are all of them."""
    k, n, e = picks.shape
    per_row = picks.view(k, rows, n // rows, e)
    within = per_row.cumsum(2) - per_row
    counts = per_row.sum(2)                                   # [k, rows, E]
    blocks, segs, block, seg = 1, 1, 0, 0
    if em is None:
        grid = counts[None]
    else:
        from torch import distributed as dist
        gathered = counts.new_empty((em.world * k, rows, e))
        dist.all_gather_into_tensor(gathered, counts.contiguous())
        grid = gathered.view(em.world, k, rows, e)
        if em.order != tuple(range(em.world)):
            # Stacked views: an index tensor made from the list would be
            # a copy from the host that waits for the device.
            grid = torch.stack([grid[r] for r in em.order])
        # The tp ranks of a token block route it alike: keep one copy.
        grid = grid.view(em.blocks, em.sizes["tp"], k, rows, e)[:, 0]
        blocks = em.sizes["dp"] * em.sizes["ep"]
        segs = em.sizes["sp"]
        block = em.coord["dp"] * em.sizes["ep"] + em.coord["ep"]
        seg = em.coord["sp"]
    # Mesh order (row block, sp segment) -> global order (row, segment).
    grid = grid.view(blocks, segs, k, rows, e).permute(2, 0, 3, 1, 4)
    flat = grid.reshape(k, -1, e)
    prefix = (flat.cumsum(1) - flat).view(k, blocks, rows, segs, e)
    before = within + prefix[:, block, :, seg, None, :]
    return before.reshape(k, n, e), flat.sum(1)


def _route(y: torch.Tensor, router_w: torch.Tensor, cfg: MoEConfig,
           rows: int = 1, em: Layout | None = None,
           parts: dict | None = None):
    """Top-k routing (GShard) of this rank's tokens ``y`` [n, d] (``rows``
    rows of ``n / rows`` positions): ``(dispatch [n, E, C] one-hot,
    combine [n, E, C] weights, aux load-balance loss)``, in f32. ``C``
    is the capacity of the global batch of ``N`` tokens (``n`` times the
    mesh's ranks); each expert's buffer position accumulates across the
    k rounds, and within a round follows global token order; a token
    past ``C`` is dropped (no slot, combine weight 0). ``parts``, where
    given, receives ``top_k``: each token's k picks [n, k], before the
    capacity cut."""
    n, E, K = y.shape[0], cfg.n_experts, cfg.top_k
    N = n * (em.blocks if em is not None else 1)
    capacity = max(1, int(cfg.capacity_factor * cfg.top_k * N / E))
    logits = y.float() @ router_w.float()                     # [n, E]
    probs = torch.softmax(logits, dim=-1)

    masked = probs
    gate_sum = torch.zeros(n, dtype=torch.float32, device=y.device)
    picks = []
    for _ in range(K):
        idx = torch.argmax(masked, dim=-1)                    # first max
        gate = torch.gather(probs, -1, idx[:, None])[:, 0]
        picks.append((idx, gate))
        gate_sum = gate_sum + gate
        masked = masked * (1.0 - F.one_hot(idx, E).to(masked.dtype))
    if parts is not None:
        parts["top_k"] = torch.stack([idx for idx, _ in picks], dim=-1)
    onehots = torch.stack([F.one_hot(idx, E) for idx, _ in picks])
    before, totals = _positions(onehots, rows, em)

    # Switch-style aux loss over the global batch: E * sum(mean prob mass
    # * mean top-1 share); the top-1 share carries no gradient.
    prob_sum = probs.sum(0)
    if em is not None:
        # Over the whole mesh, each token block counted once per tp rank.
        prob_sum = _AllReduce.apply(prob_sum, (None,)) / em.sizes["tp"]
    aux = E * torch.sum(prob_sum / N * (totals[0].float() / N))

    fill = torch.zeros(E, dtype=torch.int64, device=y.device)
    tok = torch.arange(n, device=y.device)
    slots, weights, kept = [], [], []
    for r, (idx, gate) in enumerate(picks):
        pos = fill[idx] + before[r, tok, idx]
        fits = pos < capacity
        gate_n = torch.where(gate_sum > 0, gate / gate_sum, 0.0)
        slots.append((tok * E + idx) * capacity
                     + torch.clamp(pos, max=capacity - 1))
        kept.append(fits.float())
        weights.append(fits.float() * gate_n)
        # Round r fills each expert as far as its capacity.
        fill = fill + torch.minimum(totals[r], (capacity - fill).clamp(min=0))
    slots = torch.cat(slots)
    size = n * E * capacity
    zeros = torch.zeros(size, dtype=torch.float32, device=y.device)
    dispatch = zeros.index_add(0, slots, torch.cat(kept))
    combine = zeros.index_add(0, slots, torch.cat(weights))
    shape = (n, E, capacity)
    return dispatch.view(shape), combine.view(shape), aux


def _moe_ffn(y: torch.Tensor, lp: dict, cfg: MoEConfig,
             em: Layout | None = None, parts: dict | None = None):
    """[B, T, d] -> ([B, T, d], aux) through the top-k routed experts.
    ``lp``'s expert weights are this rank's ``E / ep`` experts (under tp
    its block of their FFN columns); the buffers cross the mesh at
    :func:`to_experts` and :func:`from_experts`, the reference's
    ``P("ep", None, None)`` constraints, and the experts' partial sums
    are all-reduced over tp in f32 between. ``parts``, where given,
    receives the routing: ``dispatch`` and ``top_k`` (:func:`_route`)."""
    cdt = cfg.compute_dtype
    b, t, d = y.shape
    yf = y.reshape(b * t, d)
    dispatch, combine, aux = _route(yf, lp["router"], cfg, b, em, parts)
    if parts is not None:
        parts["dispatch"] = dispatch
    tp = None if em is None else em.tp
    expert_in = enter_tp(to_experts(
        torch.einsum("nec,nd->ecd", dispatch.to(cdt), yf), em), tp)
    h = F.silu(torch.einsum("ecd,edf->ecf", expert_in, lp["w1"].to(cdt)))
    h = h * torch.einsum("ecd,edf->ecf", expert_in, lp["w3"].to(cdt))
    out = from_experts(leave_tp(
        torch.einsum("ecf,efd->ecd", h, lp["w2"].to(cdt)), tp), em)
    mixed = torch.einsum("nec,ecd->nd", combine.to(cdt), out)
    return mixed.reshape(b, t, d), aux


# -- The model. --

#: One layer's weights, in the order :func:`_layer` takes them.
_LAYER_KEYS = ("ln1", "wq", "wk", "wv", "wo", "ln2", "router", "w1", "w3",
               "w2")


def _attention_block(x: torch.Tensor, lp: dict, cfg: MoEConfig, attend,
                     offset: int, tp=None) -> torch.Tensor:
    """``x`` plus causal self-attention of its rms-normed self, at global
    positions from ``offset``; ``attend(q, k, v)`` over [B, H, T, D].
    Under tp (its group ``tp``) this rank's heads, those of its ``wq``
    columns, and their partial sums all-reduced in f32."""
    b, t, _ = x.shape
    dh = cfg.head_dim
    h = lp["wq"].shape[1] // dh
    y = enter_tp(_rms_norm(x, lp["ln1"]), tp)
    q = (y @ lp["wq"]).reshape(b, t, h, dh).transpose(1, 2)
    k = (y @ lp["wk"]).reshape(b, t, h, dh).transpose(1, 2)
    v = (y @ lp["wv"]).reshape(b, t, h, dh).transpose(1, 2)
    q, k = _rope(q, cfg, offset), _rope(k, cfg, offset)
    o = attend(q, k, v).to(q.dtype)
    return x + leave_tp(o.transpose(1, 2).reshape(b, t, h * dh) @ lp["wo"],
                        tp)


def _layer(x: torch.Tensor, cfg: MoEConfig, attend, offset: int,
           em: Layout | None, *weights, parts: dict | None = None):
    """One pre-norm layer, attention then MoE FFN: ``(x, aux)``. Weights
    in ``_LAYER_KEYS`` order, cast to the compute dtype here, inside the
    rematerialized region (the router stays as it is: routing is
    f32). ``parts``, where given, receives the routing
    (:func:`_moe_ffn`): what the card's layer-wise gate holds."""
    cdt = cfg.compute_dtype
    lp = {name: w if name == "router" else w.to(cdt)
          for name, w in zip(_LAYER_KEYS, weights)}
    x = _attention_block(x, lp, cfg, attend, offset,
                         None if em is None else em.tp)
    moe_out, aux = _moe_ffn(_rms_norm(x, lp["ln2"]), lp, cfg, em, parts)
    return x + moe_out, aux


# -- The per-kind stacks (``cfg.hybrid``): gated short-conv and GQA
# mixers, leading dense FFNs, and experts behind a sorted dispatch. --

#: Each group's leaves, in the order its layer function takes them; a
#: group holds one stack per leaf, its layers on the leading axis.
CONV_KEYS = ("ln", "in_proj", "conv", "out_proj")
DENSE_KEYS = ("ln", "w1", "w3", "w2")
SPARSE_KEYS = ("ln", "router", "w1", "w3", "w2")


def _group_keys(cfg: MoEConfig) -> dict:
    attention = ("ln", "wq", "wk", "wv",
                 *(("q_norm", "k_norm") if cfg.qk_norm else ()), "wo")
    return {"attention": attention, "conv": CONV_KEYS, "dense": DENSE_KEYS,
            "sparse": SPARSE_KEYS}


def _hybrid_shapes(cfg: MoEConfig) -> dict:
    """The per-kind stacks' shapes: ``embed``; a group per mixer kind and
    FFN kind that some layer has (``attention``, ``conv``, ``dense``,
    ``sparse``), each of its leaves stacked over that kind's layers;
    ``ln_f``; and with sparse layers ``expert_bias``, [sparse layers, E],
    which no gradient reaches."""
    d, v, E, f = cfg.d_model, cfg.vocab, cfg.n_experts, cfg.d_ff
    dh, h, kv, k = cfg.head_dim, cfg.n_heads, cfg.kv_heads, cfg.conv_kernel
    la, lc = cfg.layer_types.count("attention"), cfg.layer_types.count("conv")
    ld, ls = cfg.n_dense_layers, cfg.sparse_layers
    groups = {
        "attention": (la, {"ln": (d,), "wq": (d, h * dh),
                           "wk": (d, kv * dh), "wv": (d, kv * dh),
                           "q_norm": (dh,), "k_norm": (dh,),
                           "wo": (h * dh, d)}),
        "conv": (lc, {"ln": (d,), "in_proj": (d, 3 * d), "conv": (d, k),
                      "out_proj": (d, d)}),
        "dense": (ld, {"ln": (d,), "w1": (d, cfg.dense_d_ff),
                       "w3": (d, cfg.dense_d_ff), "w2": (cfg.dense_d_ff, d)}),
        "sparse": (ls, {"ln": (d,), "router": (d, E), "w1": (E, d, f),
                        "w3": (E, d, f), "w2": (E, f, d)}),
    }
    out = {"embed": (v, d)}
    for name, keys in _group_keys(cfg).items():
        n, shapes = groups[name]
        if n:
            out[name] = {key: (n, *shapes[key]) for key in keys}
    out["ln_f"] = (d,)
    if ls:
        out["expert_bias"] = (ls, E)
    return out


def _hybrid_init(generator: torch.Generator, cfg: MoEConfig) -> dict:
    """:func:`init_params` of the per-kind stacks: norms at 1, the expert
    bias at 0 (f32), each weight normal over the square root of its
    fan-in (the short conv's: its kernel size)."""
    dt, dev = cfg.param_dtype, generator.device

    def make(path: str, shape: tuple):
        leaf = path.rsplit("/", 1)[-1]
        if path == "expert_bias":
            return torch.zeros(shape, dtype=torch.float32, device=dev)
        if leaf in ("ln", "q_norm", "k_norm", "ln_f"):
            return torch.ones(shape, dtype=dt, device=dev)
        fan_in = shape[-1] if leaf in ("conv", "embed") else shape[-2]
        x = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32)
        return (x * fan_in ** -0.5).to(dt)

    def build(tree, prefix=""):
        return {key: build(val, f"{prefix}{key}/") if isinstance(val, dict)
                else make(f"{prefix}{key}", val) for key, val in tree.items()}

    return build(_hybrid_shapes(cfg))


def trainable(params: dict) -> dict:
    """``params`` but for ``expert_bias``: the leaves of the gradient and
    of AdamW."""
    return {key: val for key, val in params.items() if key != "expert_bias"}


# The counter of the routed experts' work, counted where the program
# launches it: MoE layer calls (``layers``), rows routed (``rows``, n x
# k), grouped-GEMM calls and the rows summed over them (``gemm_calls``,
# ``gemm_rows``; on CUDA only: the CPU's per-expert loop counts none), the
# most-loaded expert's rows summed over calls (``max_rows``, kept on the
# device until :func:`counts` reads it, so counting syncs nothing), and the
# permutation kernels' launches and the bytes they have to move
# (``permute_launches``, ``permute_bytes``: each row, token row, index and
# weight read or written once; on CUDA only, as the GEMMs).
_counts: dict = {}


def zero_counts() -> None:
    """Every count to 0."""
    _counts.update(layers=0, rows=0, gemm_calls=0, gemm_rows=0, max_rows=0,
                   permute_launches=0, permute_bytes=0)


zero_counts()


def counts() -> dict:
    """The counts so far, as ints (reading ``max_rows`` waits for the
    device)."""
    return {key: int(val) for key, val in _counts.items()}


def grouped_mm(a: torch.Tensor, b: torch.Tensor, offs: torch.Tensor):
    """Group ``g``'s rows of ``a`` [rows, k] (rows ``offs[g-1]`` to
    ``offs[g]``, ``offs`` int32 cumulative ends) times ``b[g]`` [k, n]:
    [rows, n]. ``torch._grouped_mm`` on CUDA bf16, ``offs`` read on the
    device; a loop over the groups on CPU tensors."""
    if a.device.type == "cpu":
        ends = [0, *offs.tolist()]
        return torch.cat([a[s:e] @ b[g] for g, (s, e)
                          in enumerate(zip(ends, ends[1:]))])
    _check_grouped(a, b)
    _counts["gemm_calls"] += 1
    _counts["gemm_rows"] += a.shape[0]
    return torch._grouped_mm(a, b, offs=offs)


def grouped_mm_wgrad(a: torch.Tensor, g: torch.Tensor, offs: torch.Tensor):
    """Per group, ``a``'s rows transposed times ``g``'s: [groups, k, n]
    from ``a`` [rows, k] and ``g`` [rows, n] (the weight gradient of
    :func:`grouped_mm`); a group of no rows gives zeros."""
    if a.device.type == "cpu":
        ends = [0, *offs.tolist()]
        return torch.stack([a[s:e].t() @ g[s:e]
                            for s, e in zip(ends, ends[1:])])
    _check_grouped(a, g)
    _counts["gemm_calls"] += 1
    _counts["gemm_rows"] += a.shape[0]
    return torch._grouped_mm(a.t(), g, offs=offs)


def _check_grouped(*tensors) -> None:
    if any(x.device.type != "cuda" or x.dtype != torch.bfloat16
           for x in tensors):
        raise TypeError("the grouped GEMMs take bf16 CUDA tensors (or CPU "
                        "tensors, through the loop); got "
                        f"{[(str(x.device), x.dtype) for x in tensors]}")


@dataclasses.dataclass
class SortedRoute:
    """A layer's picks in expert order: for each of the n * k rows its
    ``token`` and combine ``weight`` (f32), ``offs`` (int32 cumulative
    ends of each expert's rows), ``load`` (picks per expert) and ``pos``
    (int32 [k, n]: the row of each token's j-th pick, the sort's
    inverse), all on the device."""
    token: torch.Tensor
    weight: torch.Tensor
    offs: torch.Tensor
    load: torch.Tensor
    pos: torch.Tensor


def route_sorted(y: torch.Tensor, router_w: torch.Tensor,
                 bias: torch.Tensor | None, cfg: MoEConfig) -> SortedRoute:
    """The sigmoid router over ``y`` [n, d], in f32: s = sigmoid(y W),
    each token's experts ``topk(s + bias, k)``, their weights s at the
    picks over their sum + 1e-6 (``norm_topk``), times ``routed_scale``;
    the n * k picks sorted stably by expert. Nothing waits for the
    device: the loads are a scatter-add, not ``bincount`` (which reads
    its largest input on the host), and ``pos`` a scatter of the rows'
    numbers into the sort's places."""
    n, E, K = y.shape[0], cfg.n_experts, cfg.top_k
    s = torch.sigmoid(y.float() @ router_w.float())
    pick = s.detach() if bias is None else s.detach() + bias
    idx = torch.topk(pick, K, dim=-1).indices
    w = torch.gather(s, 1, idx)
    if cfg.norm_topk:
        w = w / (w.sum(-1, keepdim=True) + 1e-6)
    w = w * cfg.routed_scale
    flat = idx.t().reshape(-1)
    order = torch.argsort(flat, stable=True)
    load = torch.zeros(E, dtype=torch.int64, device=y.device).scatter_add_(
        0, flat, torch.ones_like(flat))
    pos = torch.empty(n * K, dtype=torch.int32, device=y.device).scatter_(
        0, order, torch.arange(n * K, dtype=torch.int32, device=y.device))
    _counts["layers"] += 1
    _counts["rows"] += n * K
    _counts["max_rows"] += load.max()
    return SortedRoute(order % n, w.t().reshape(-1)[order],
                       load.cumsum(0).to(torch.int32), load, pos.view(K, n))


def gather_reduce_plain(rows: torch.Tensor, pos: torch.Tensor,
                        weight: torch.Tensor | None = None) -> torch.Tensor:
    """[n, d]: token t's row the sum over j of ``weight[r] * rows[r]``, r
    = ``pos[j, t]`` (no ``weight``: the rows as they are), each product
    and the running sum in f32 (f64 for f64 rows) in j order, cast to the
    rows' dtype once."""
    acc_dtype = torch.promote_types(rows.dtype, torch.float32)
    acc = None
    for r in pos.long():
        term = rows.index_select(0, r).to(acc_dtype)
        if weight is not None:
            term = term * weight.index_select(0, r).to(acc_dtype)[:, None]
        acc = term if acc is None else acc + term
    return acc.to(rows.dtype)


def scatter_rows_plain(src: torch.Tensor, pos: torch.Tensor,
                       weight: torch.Tensor | None = None,
                       rows: torch.Tensor | None = None):
    """[n * k, d]: row ``pos[j, t]`` a copy of token t's row ``src[t]``.
    With ``weight`` and ``rows`` (both or neither), ``(out, dot)``: the
    copy times its weight in f32 (f64 for f64 rows), cast to the rows'
    dtype, and dot[r] the f32 sum of ``src[token of r] * rows[r]``."""
    k, n = pos.shape
    token = torch.empty(k * n, dtype=torch.int64, device=src.device)
    token[pos.reshape(-1).long()] = torch.arange(
        n, device=src.device).repeat(k)
    gathered = src.index_select(0, token)
    if weight is None:
        return gathered
    acc = gathered.to(torch.promote_types(src.dtype, torch.float32))
    return ((acc * weight.to(acc.dtype)[:, None]).to(src.dtype),
            (acc * rows.to(acc.dtype)).sum(-1))


def _check_permute(rows: tuple, pos: torch.Tensor, weights: tuple) -> int:
    """The kernels' terms: bf16 rows, int32 ``pos`` and f32 weights, all
    contiguous on one CUDA device; its index."""
    tensors = (*rows, pos, *weights)
    device = rows[0].device
    if any(x.device != device for x in tensors) or device.type != "cuda" \
            or any(x.dtype != torch.bfloat16 for x in rows) \
            or pos.dtype != torch.int32 \
            or any(x.dtype != torch.float32 for x in weights):
        raise TypeError("the permutation kernels take bf16 rows, int32 pos "
                        "and f32 weights on one CUDA device (or CPU tensors, "
                        "through the plain versions); got "
                        f"{[(str(x.device), x.dtype) for x in tensors]}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("the permutation kernels take contiguous tensors")
    return device.index


def _permuted(nbytes: int) -> None:
    _counts["permute_launches"] += 1
    _counts["permute_bytes"] += nbytes


_VP, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_GATHER_REDUCE = build.Kernel("moe_permute", "moe_gather_reduce",
                              (_VP, _VP, _VP, _VP, _I, _I, _I64, _I, _VP))
_SCATTER_ROWS = build.Kernel("moe_permute", "moe_scatter_rows",
                             (_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I64, _I,
                              _VP))


def _ptr(x: torch.Tensor | None):
    return None if x is None else x.data_ptr()


def gather_reduce(rows: torch.Tensor, pos: torch.Tensor,
                  weight: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`gather_reduce_plain` of ``rows`` [n * k, d] by ``pos`` [k,
    n]: on CUDA the kernel ``moe_gather_reduce``, counted; CPU tensors
    take the plain version."""
    weights = () if weight is None else (weight,)
    if all(x.device.type == "cpu" for x in (rows, pos, *weights)):
        return gather_reduce_plain(rows, pos, weight)
    device = _check_permute((rows,), pos, weights)
    (k, n), d = pos.shape, rows.shape[-1]
    if rows.dim() != 2 or rows.shape[0] != k * n \
            or any(w.shape != (k * n,) for w in weights):
        raise ValueError(f"gather_reduce: rows {tuple(rows.shape)}, pos "
                         f"{tuple(pos.shape)}, weight "
                         f"{[tuple(w.shape) for w in weights]}")
    out = rows.new_empty((n, d))
    if n:
        rc = _GATHER_REDUCE.launch(rows.data_ptr(), pos.data_ptr(),
                                   _ptr(weight), out.data_ptr(), n, k, d,
                                   device, build.current_stream(device))
        if rc:
            raise _GATHER_REDUCE.error(rc)
        _permuted((k + 1) * n * d * rows.element_size()
                  + 4 * k * n * (1 + len(weights)))
    return out


def scatter_rows(src: torch.Tensor, pos: torch.Tensor,
                 weight: torch.Tensor | None = None,
                 rows: torch.Tensor | None = None):
    """:func:`scatter_rows_plain` of ``src`` [n, d] by ``pos`` [k, n]: on
    CUDA the kernel ``moe_scatter_rows``, counted; CPU tensors take the
    plain version."""
    if (weight is None) != (rows is None):
        raise ValueError("scatter_rows takes weight and rows together")
    weighted = weight is not None
    row_args = (src, rows) if weighted else (src,)
    weights = (weight,) if weighted else ()
    if all(x.device.type == "cpu" for x in (*row_args, pos, *weights)):
        return scatter_rows_plain(src, pos, weight, rows)
    device = _check_permute(row_args, pos, weights)
    (k, n), d = pos.shape, src.shape[-1]
    if src.dim() != 2 or src.shape[0] != n or (weighted and (
            weight.shape != (k * n,) or rows.shape != (k * n, d))):
        shapes = [tuple(x.shape) for x in (*row_args, pos, *weights)]
        raise ValueError(f"scatter_rows: src, (rows,) pos, (weight): "
                         f"{shapes}")
    out = src.new_empty((k * n, d))
    dot = torch.empty(k * n, dtype=torch.float32, device=src.device) \
        if weighted else None
    if n:
        rc = _SCATTER_ROWS.launch(src.data_ptr(), pos.data_ptr(),
                                  _ptr(weight), _ptr(rows), out.data_ptr(),
                                  _ptr(dot), n, k, d, device,
                                  build.current_stream(device))
        if rc:
            raise _SCATTER_ROWS.error(rc)
        row_bytes = n * d * src.element_size()
        _permuted((1 + 2 * k) * row_bytes + 12 * k * n if weighted
                  else (1 + k) * row_bytes + 4 * k * n)
    return out if dot is None else (out, dot)


class Dispatch(torch.autograd.Function):
    """Token rows [n, d] -> their copies in expert order [n * k, d] (row
    ``pos[j, t]`` token t's); backward: each token's gradient the f32 sum
    of its rows', cast back (:func:`scatter_rows`, :func:`gather_reduce`).
    Spans ``moe.dispatch`` and ``moe.dispatch.bwd``."""

    @staticmethod
    def forward(ctx, x, pos):
        with span("moe.dispatch"):
            ctx.save_for_backward(pos)
            return scatter_rows(x, pos)

    @staticmethod
    def backward(ctx, grad):
        (pos,) = ctx.saved_tensors
        with span("moe.dispatch.bwd"):
            return gather_reduce(grad.contiguous(), pos), None


class Combine(torch.autograd.Function):
    """Expert rows [n * k, d] -> tokens [n, d]: each token the f32 sum of
    its rows times their weights, cast to the rows' dtype
    (:func:`gather_reduce`); backward (:func:`scatter_rows`): the rows'
    gradient, the token's times the weight, and the weights', the row's
    dot the token's gradient. Spans ``moe.combine`` and
    ``moe.combine.bwd``."""

    @staticmethod
    def forward(ctx, rows, weight, pos):
        with span("moe.combine"):
            ctx.save_for_backward(rows, weight, pos)
            return gather_reduce(rows, pos, weight)

    @staticmethod
    def backward(ctx, grad):
        rows, weight, pos = ctx.saved_tensors
        with span("moe.combine.bwd"):
            d_rows, d_weight = scatter_rows(grad.contiguous(), pos, weight,
                                            rows)
            return d_rows, d_weight, None


class Experts(torch.autograd.Function):
    """Each expert's SwiGLU over its rows: ``(silu(x W1) * (x W3)) W2``,
    three grouped GEMMs over the ``offs`` segments; backward: six (the
    input's gradient through W2, W1 and W3, and the three weights'),
    SwiGLU's derivative in f32. Spans ``moe.experts`` and
    ``moe.experts.bwd``."""

    @staticmethod
    def forward(ctx, x, w1, w3, w2, offs):
        with span("moe.experts"):
            h1, h3 = grouped_mm(x, w1, offs), grouped_mm(x, w3, offs)
            ctx.save_for_backward(x, w1, w3, w2, offs, h1, h3)
            return grouped_mm(F.silu(h1) * h3, w2, offs)

    @staticmethod
    def backward(ctx, grad):
        x, w1, w3, w2, offs, h1, h3 = ctx.saved_tensors
        with span("moe.experts.bwd"):
            grad = grad.contiguous()
            d_w2 = grouped_mm_wgrad(F.silu(h1) * h3, grad, offs)
            d_act = grouped_mm(grad, w2.transpose(1, 2), offs)
            h1f = h1.float()
            sig = torch.sigmoid(h1f)
            d_h3 = (d_act * h1f * sig).to(x.dtype)
            d_h1 = (d_act * h3.float() * sig * (1 + h1f * (1 - sig))) \
                .to(x.dtype)
            del d_act, h1f, sig
            d_x = grouped_mm(d_h1, w1.transpose(1, 2), offs)
            d_x += grouped_mm(d_h3, w3.transpose(1, 2), offs)
            return (d_x, grouped_mm_wgrad(x, d_h1, offs),
                    grouped_mm_wgrad(x, d_h3, offs), d_w2, None)


def sorted_moe_ffn(y: torch.Tensor, lp: dict, bias, cfg: MoEConfig):
    """[B, T, d] -> ``([B, T, d], load [E])`` through the sigmoid router
    and the experts in expert order (:func:`route_sorted`,
    :class:`Dispatch`, :class:`Experts`, :class:`Combine`)."""
    b, t, d = y.shape
    yf = y.reshape(b * t, d)
    with span("moe.route"):
        route = route_sorted(yf, lp["router"], bias, cfg)
    rows = Experts.apply(Dispatch.apply(yf, route.pos), lp["w1"],
                         lp["w3"], lp["w2"], route.offs)
    out = Combine.apply(rows, route.weight, route.pos)
    return out.reshape(b, t, d), route.load


def causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv of [B, T, d] by ``w`` [d, K]: out[t] =
    sum_j w[:, j] x[t + j - K + 1] (x before 0 taken as 0), in f32, cast
    back."""
    k, t = w.shape[-1], x.shape[1]
    padded = F.pad(x, (0, 0, k - 1, 0))
    taps = w.float().t().contiguous()
    out = padded[:, :t] * taps[0]
    for j in range(1, k):
        out += padded[:, j:j + t] * taps[j]
    return out.to(x.dtype)


def _conv_mixer(y: torch.Tensor, lp: dict) -> torch.Tensor:
    """The gated short conv: B, C, u = split3(y W_in); out_proj(C *
    conv(B * u)). Span ``moe.conv``."""
    with span("moe.conv"):
        b_gate, c_gate, u = (y @ lp["in_proj"]).chunk(3, dim=-1)
        return (c_gate * causal_conv(b_gate * u, lp["conv"])) \
            @ lp["out_proj"]


def _gqa_mixer(y: torch.Tensor, lp: dict, cfg: MoEConfig, attend):
    """Causal attention of ``n_heads`` query heads over ``kv_heads`` key
    and value heads (query head i reads kv head i // (H / KV)), q and k
    rms-normed over the head dim (``qk_norm``) before RoPE; k and v
    repeated to H heads for ``attend``."""
    b, t, _ = y.shape
    dh, h, kv = cfg.head_dim, cfg.n_heads, cfg.kv_heads
    q = (y @ lp["wq"]).reshape(b, t, h, dh)
    k = (y @ lp["wk"]).reshape(b, t, kv, dh)
    v = (y @ lp["wv"]).reshape(b, t, kv, dh).transpose(1, 2)
    if cfg.qk_norm:
        q, k = _rms_norm(q, lp["q_norm"]), _rms_norm(k, lp["k_norm"])
    q, k = _rope(q.transpose(1, 2), cfg), _rope(k.transpose(1, 2), cfg)
    if kv != h:
        k = k.repeat_interleave(h // kv, dim=1)
        v = v.repeat_interleave(h // kv, dim=1)
    o = attend(q.contiguous(), k.contiguous(), v.contiguous()).to(q.dtype)
    return o.transpose(1, 2).reshape(b, t, h * dh) @ lp["wo"]


def _flash(q, k, v):
    """One causal launch of the flash kernels, differentiable under grad
    (spans ``attention.fwd`` / ``attention.bwd``)."""
    if torch.is_grad_enabled():
        return FlashAttention.apply(q, k, v)
    return flash_attention(q, k, v)


def _hybrid_layer(x: torch.Tensor, cfg: MoEConfig, attend, mixer: str,
                  ffn: str, n_mixer: int, bias, *weights):
    """One pre-norm layer of the per-kind stacks: ``x + mixer(rms(x))``,
    then ``h + ffn(rms(h))``; ``weights`` the mixer's group's leaves then
    the FFN's, each in its group's key order, cast to the compute dtype
    here (the router stays as it is: routing is f32). Returns ``(x,
    load)``: the picks per expert, or None after a dense FFN. Span
    ``lm.layer``, again where remat recomputes it."""
    with span("lm.layer"):
        keys = _group_keys(cfg)
        cdt = cfg.compute_dtype
        mp = dict(zip(keys[mixer], (w.to(cdt) for w in weights[:n_mixer])))
        fp = {key: w if key == "router" else w.to(cdt)
              for key, w in zip(keys[ffn], weights[n_mixer:])}
        y = _rms_norm(x, mp["ln"])
        x = x + (_conv_mixer(y, mp) if mixer == "conv"
                 else _gqa_mixer(y, mp, cfg, attend))
        y = _rms_norm(x, fp["ln"])
        if ffn == "dense":
            return x + (F.silu(y @ fp["w1"]) * (y @ fp["w3"])) @ fp["w2"], None
        out, load = sorted_moe_ffn(y, fp, bias, cfg)
        return x + out, load


def _hybrid_hidden(params: dict, tokens: torch.Tensor, cfg: MoEConfig,
                   attention, stats: dict | None):
    """:func:`hidden_states` of the per-kind stacks on one device:
    ``(x, None)``; ``stats``, where given, receives each sparse layer's
    load under its index."""
    cdt = cfg.compute_dtype
    x = params["embed"].to(cdt)[tokens.long()]
    stacks = {name: list(zip(*(params[name][key].unbind(0) for key in keys)))
              for name, keys in _group_keys(cfg).items() if name in params}
    bias = params.get("expert_bias")
    bias = None if bias is None else bias.detach().unbind(0)
    seen = dict.fromkeys(MIXERS, 0)
    remat = cfg.remat and torch.is_grad_enabled()
    for i, mixer in enumerate(cfg.layer_types):
        mixer_w = stacks[mixer][seen[mixer]]
        seen[mixer] += 1
        dense = i < cfg.n_dense_layers
        j = i - cfg.n_dense_layers
        ffn_w = stacks["dense"][i] if dense else stacks["sparse"][j]
        args = (x, cfg, attention, mixer, "dense" if dense else "sparse",
                len(mixer_w), None if dense else bias[j], *mixer_w, *ffn_w)
        x, load = (checkpoint(_hybrid_layer, *args, use_reentrant=False)
                   if remat else _hybrid_layer(*args))
        if load is not None and stats is not None:
            stats[j] = load
    return _rms_norm(x, params["ln_f"].to(cdt)), None


@torch.no_grad()
def update_bias_(bias: torch.Tensor, stats: dict, cfg: MoEConfig) -> None:
    """The expert bias's step after a train step, outside the gradient
    (DeepSeek-V3's aux-loss-free balancing, arXiv:2412.19437 section
    2.1.2): bias += rate * sign(mean load - load), per sparse layer."""
    load = torch.stack([stats[j] for j in range(bias.shape[0])]).float()
    bias.add_(torch.sign(load.mean(-1, keepdim=True) - load),
              alpha=cfg.bias_rate)


def hidden_states(params: dict, tokens: torch.Tensor, cfg: MoEConfig,
                  mesh=None, attention=None, stats: dict | None = None):
    """tokens [B, T] -> ``(x, aux)``: final hidden states (post-ln_f) of
    this rank's block, [B / (dp * ep), T / sp, d_model], and the aux loss
    averaged over layers. ``attention(q, k, v)``, default the ring over
    the mesh's sp axis (looked up once here), takes the place of the
    attention; the layer is otherwise the same. With ``cfg.remat`` and
    grad enabled each layer is one ``torch.utils.checkpoint`` region: a
    train step at sp = 1 makes 2 x n_layers causal forward launches and
    n_layers backward ones, and every collective of a layer runs again,
    on every rank in the same order, in its backward.

    With ``cfg.hybrid``, one device: each layer's mixer and FFN by
    ``layer_types`` and ``n_dense_layers`` (the attention layers' one
    causal launch each through the flash kernels, by default), ``aux``
    None (no aux loss), and ``stats``, where given, each sparse layer's
    picks per expert under its index."""
    _check_mesh(cfg, mesh)
    if cfg.hybrid:
        return _hybrid_hidden(params, tokens, cfg, attention or _flash,
                              stats)
    em = expert_mesh(mesh)
    tokens = shard(mesh, tokens, MOE_DATA_SPEC)
    offset = 0 if em is None else em.coord["sp"] * tokens.shape[1]
    if attention is None:
        ring = None if em is None else em.ring

        def attention(q, k, v):
            return ring_apply(q, k, v, ring)
    cdt = cfg.compute_dtype
    x = params["embed"].to(cdt)[tokens.long()]
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for weights in zip(*(params["layers"][name].unbind(0)
                         for name in _LAYER_KEYS)):
        args = (x, cfg, attention, offset, em, *weights)
        x, aux = (checkpoint(_layer, *args, use_reentrant=False) if remat
                  else _layer(*args))
        aux_total = aux_total + aux
    return _rms_norm(x, params["ln_f"].to(cdt)), aux_total / cfg.n_layers


def forward(params: dict, tokens: torch.Tensor, cfg: MoEConfig, mesh=None,
            attention=None, stats: dict | None = None):
    """tokens [B, T] -> ``(logits, aux)``: this rank's block of the f32
    logits, [B / (dp * ep), T / sp, vocab], and the mean aux loss of the
    global batch (None with ``layer_types``)."""
    x, aux = hidden_states(params, tokens, cfg, mesh, attention, stats)
    return (x @ params["embed"].to(cfg.compute_dtype).T).float(), aux


def loss_fn(params: dict, batch: torch.Tensor, cfg: MoEConfig, mesh=None,
            attention=None, stats: dict | None = None) -> torch.Tensor:
    """batch [B, T+1] -> mean next-token cross-entropy of this rank's
    block plus ``aux_loss_weight`` times the global aux loss: averaged
    over the mesh's ranks (equal shares), the reference's loss. The
    sigmoid router adds no aux loss."""
    inputs, targets = batch[:, :-1], batch[:, 1:]
    targets = shard(mesh, targets, MOE_DATA_SPEC)
    logits, aux = forward(params, inputs, cfg, mesh, attention, stats)
    b, t = targets.shape
    loss = lm._xent_sum(logits.reshape(b * t, -1), targets.reshape(b * t)) \
        / (b * t)
    return loss if aux is None else loss + cfg.aux_loss_weight * aux


def _paths(tree, prefix="") -> list[str]:
    if isinstance(tree, dict):
        return [p for key, val in tree.items()
                for p in _paths(val, f"{prefix}{key}/")]
    return [prefix[:-1]]


def is_expert(path: str) -> bool:
    """Whether the leaf at ``path`` ("layers/w1") is sharded over ep."""
    return path.rsplit("/", 1)[-1] in EXPERT_KEYS


def loss_and_grads(params: dict, batch: torch.Tensor, cfg: MoEConfig,
                   mesh=None, attention=None, stats: dict | None = None):
    """``(loss, grads)`` of the global ``batch``: the loss detached,
    grads shaped like this rank's ``params``. Under a mesh the loss is
    averaged over its ranks; a dense gradient is summed over the token
    blocks' ranks (dp, ep and sp; a tp-replicated leaf carries the whole
    gradient on every tp rank, a tp-sharded one its own block), an
    expert's over its replicas (the dp and sp ranks of its ep index, each
    of which saw the output gradients of its own ep group's tokens), and
    each divided by the number of token blocks. ``attention`` and
    ``stats`` as in :func:`hidden_states`; the grads are of
    :func:`trainable`'s leaves. Spans ``lm.forward`` (the loss), then
    ``lm.backward``."""
    wrt = _tree_map(lambda p: p.detach().requires_grad_(), trainable(params))
    with span("lm.forward"):
        loss = loss_fn({**params, **wrt}, batch, cfg, mesh, attention, stats)
    with span("lm.backward"):
        grads = list(torch.autograd.grad(loss, _leaves(wrt)))
    loss = loss.detach()
    if expert_mesh(mesh) is not None:
        from torch import distributed as dist
        count_exchange()
        lm._average_([loss], dist.group.WORLD)
        reduce_gradients_(grads, lm._spec_leaves(wrt, param_specs(cfg)),
                          mesh, TOKEN_AXES)
    grads = iter(grads)
    return loss, _tree_map(lambda _: next(grads), wrt)


def init_train_state(generator: torch.Generator, cfg: MoEConfig,
                     lr: float = 3e-3, mesh=None):
    """This rank's params (:func:`shard_params` of :func:`init_params`,
    the same on every rank from the same seed) and AdamW's state over
    them: the counterpart of the reference's ``init_sharded``."""
    params = shard_params(init_params(generator, cfg), cfg, mesh)
    if cfg.hybrid:
        return params, init_opt_state(params, cfg, lr)
    return params, make_optimizer(lr).init(params)


def init_opt_state(params: dict, cfg: MoEConfig, lr: float = 3e-3):
    """AdamW's state over :func:`trainable`'s leaves of ``params``, or
    with params stored low-precision ``(state over the master, f32
    master)`` (``lm.init_opt_state``)."""
    return lm.init_opt_state(trainable(params), cfg, lr)


def make_forward(cfg: MoEConfig, device=None, mesh=None):
    """``fn(params, tokens) -> (logits, aux)`` on ``device`` (default
    ``cuda``; raises without one unless ``device="cpu"``), inference
    only."""
    dev = resolve_device(device)

    def fn(params: dict, tokens: torch.Tensor):
        if tokens.device != dev:
            raise ValueError(f"tokens are on {tokens.device}, the forward "
                             f"was made for {dev}")
        with torch.inference_mode():
            return forward(params, tokens, cfg, mesh)

    return fn


def make_train_step(cfg: MoEConfig, mesh=None, lr: float = 3e-3,
                    device=None, attention=None):
    """``step(params, opt_state, batch) -> (params, opt_state, loss)`` on
    ``device`` (default ``cuda``): forward, loss, backward and AdamW (the
    reference's ``make_optimizer``) over this rank's params, updated in
    place where the reference donates them. ``batch`` is the global
    batch; ``attention`` as in :func:`hidden_states`. The kernels take
    bf16 and f32 q, k, v (f32 up to head dim 128), so an f32 step
    (``compute_dtype=torch.float32``) runs through them by default too.
    ``opt_state`` is :func:`init_opt_state`'s (or AdamW's state over f32
    params); the update, AdamW then the expert bias's step
    (:func:`update_bias_`), is the span ``lm.update``. Nothing in the
    step waits for the device."""
    dev = resolve_device(device)
    opt = make_optimizer(lr)
    _check_mesh(cfg, mesh)

    def step(params: dict, opt_state, batch: torch.Tensor):
        if batch.device != dev:
            raise ValueError(f"batch is on {batch.device}, the step was "
                             f"made for {dev}")
        stats = {}
        loss, grads = loss_and_grads(params, batch, cfg, mesh, attention,
                                     stats)
        with torch.no_grad(), span("lm.update"):
            opt.update_(trainable(params), grads, opt_state)
            if stats:
                update_bias_(params["expert_bias"], stats, cfg)
        return params, opt_state, loss

    return step


def synthetic_batch(generator: torch.Generator, cfg: MoEConfig, batch: int,
                    seq: int, device=None) -> torch.Tensor:
    """Uniform random tokens [B, T+1] int32 drawn from ``generator`` (on
    ``device``): the global batch, as the reference draws it."""
    dev = resolve_device(device)
    return torch.randint(0, cfg.vocab, (batch, seq + 1), generator=generator,
                         device=dev, dtype=torch.int64).to(torch.int32)
