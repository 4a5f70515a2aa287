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
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from . import lm, sharding
from .collectives import (_AllReduce, all_gather, all_reduce, count_exchange,
                          enter_tp, leave_tp, reduce_gradients_,
                          reduce_scatter)
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

    def __post_init__(self):
        if self.d_model % self.n_heads:
            raise ValueError("d_model must divide into heads")
        if not 1 <= self.top_k <= self.n_experts:
            raise ValueError("need 1 <= top_k <= n_experts")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


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
    ``w1/w3`` columns and ``w2`` rows over tp; the rest replicated."""
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
    :func:`params_from_jax` where both sides need the same params."""
    dt, dev = cfg.param_dtype, generator.device

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


def hidden_states(params: dict, tokens: torch.Tensor, cfg: MoEConfig,
                  mesh=None, attention=None):
    """tokens [B, T] -> ``(x, aux)``: final hidden states (post-ln_f) of
    this rank's block, [B / (dp * ep), T / sp, d_model], and the aux loss
    averaged over layers. ``attention(q, k, v)``, default the ring over
    the mesh's sp axis (looked up once here), takes the place of the
    attention; the layer is otherwise the same. With ``cfg.remat`` and
    grad enabled each layer is one ``torch.utils.checkpoint`` region: a
    train step at sp = 1 makes 2 x n_layers causal forward launches and
    n_layers backward ones, and every collective of a layer runs again,
    on every rank in the same order, in its backward."""
    _check_mesh(cfg, mesh)
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
            attention=None):
    """tokens [B, T] -> ``(logits, aux)``: this rank's block of the f32
    logits, [B / (dp * ep), T / sp, vocab], and the mean aux loss of the
    global batch."""
    x, aux = hidden_states(params, tokens, cfg, mesh, attention)
    return (x @ params["embed"].to(cfg.compute_dtype).T).float(), aux


def loss_fn(params: dict, batch: torch.Tensor, cfg: MoEConfig, mesh=None,
            attention=None) -> torch.Tensor:
    """batch [B, T+1] -> mean next-token cross-entropy of this rank's
    block plus ``aux_loss_weight`` times the global aux loss: averaged
    over the mesh's ranks (equal shares), the reference's loss."""
    inputs, targets = batch[:, :-1], batch[:, 1:]
    targets = shard(mesh, targets, MOE_DATA_SPEC)
    logits, aux = forward(params, inputs, cfg, mesh, attention)
    b, t = targets.shape
    return (lm._xent_sum(logits.reshape(b * t, -1), targets.reshape(b * t))
            / (b * t) + cfg.aux_loss_weight * aux)


def _paths(tree, prefix="") -> list[str]:
    if isinstance(tree, dict):
        return [p for key, val in tree.items()
                for p in _paths(val, f"{prefix}{key}/")]
    return [prefix[:-1]]


def is_expert(path: str) -> bool:
    """Whether the leaf at ``path`` ("layers/w1") is sharded over ep."""
    return path.rsplit("/", 1)[-1] in EXPERT_KEYS


def loss_and_grads(params: dict, batch: torch.Tensor, cfg: MoEConfig,
                   mesh=None, attention=None):
    """``(loss, grads)`` of the global ``batch``: the loss detached,
    grads shaped like this rank's ``params``. Under a mesh the loss is
    averaged over its ranks; a dense gradient is summed over the token
    blocks' ranks (dp, ep and sp; a tp-replicated leaf carries the whole
    gradient on every tp rank, a tp-sharded one its own block), an
    expert's over its replicas (the dp and sp ranks of its ep index, each
    of which saw the output gradients of its own ep group's tokens), and
    each divided by the number of token blocks. ``attention`` as in
    :func:`hidden_states`."""
    wrt = _tree_map(lambda p: p.detach().requires_grad_(), params)
    loss = loss_fn(wrt, batch, cfg, mesh, attention)
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
    return params, make_optimizer(lr).init(params)


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
    (``compute_dtype=torch.float32``) runs through them by default too."""
    dev = resolve_device(device)
    opt = make_optimizer(lr)
    _check_mesh(cfg, mesh)

    def step(params: dict, opt_state: dict, batch: torch.Tensor):
        if batch.device != dev:
            raise ValueError(f"batch is on {batch.device}, the step was "
                             f"made for {dev}")
        loss, grads = loss_and_grads(params, batch, cfg, mesh, attention)
        opt.update_(params, grads, opt_state)
        return params, opt_state, loss

    return step


def synthetic_batch(generator: torch.Generator, cfg: MoEConfig, batch: int,
                    seq: int, device=None) -> torch.Tensor:
    """Uniform random tokens [B, T+1] int32 drawn from ``generator`` (on
    ``device``): the global batch, as the reference draws it."""
    dev = resolve_device(device)
    return torch.randint(0, cfg.vocab, (batch, seq + 1), generator=generator,
                         device=dev, dtype=torch.int64).to(torch.int32)
