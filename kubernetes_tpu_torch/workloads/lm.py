"""Flagship workload: decoder-only transformer LM, forward and training.

Counterpart of ``kubernetes_tpu/workloads/lm.py``: the same config,
parameter tree (layers stacked on a leading axis, weights stored
``[in, out]`` and used as ``y @ W``), RoPE, RMSNorm, SwiGLU FFN, tied
embeddings, bf16 compute with f32 softmax and loss. Parameters are a
plain dictionary of tensors, so a JAX parameter tree carries over
through numpy (:func:`params_from_jax`).

``attn_impl="ring"`` (the default, as in the reference) runs
:func:`~.ring_attention.ring_attention` over the mesh's ``sp`` axis
(its :class:`~.ring_attention.Ring` looked up once a forward):
without a mesh, or at ``sp = 1``, one causal launch of the hand-written
flash-attention kernels per layer; at ``sp > 1`` a ring of their causal
and non-causal launches whose K/V blocks rotate over ``torch.distributed``
P2P. ``"flash"`` runs the kernels directly on one device, forward and
(under grad, through :class:`~.flash_attention.FlashAttention`)
backward. Both take the kernels' plain versions on CPU tensors.
``"local"`` runs the plain :func:`~.ring_attention.reference_attention`
under autograd.

The parallel layout: given a ``mesh`` (``sharding.make_mesh``, the
reference's argument) every public function takes the global token batch
and each rank computes its block, rows by its ``(dp, fsdp)`` coordinate
and positions by its ``sp`` coordinate (RoPE at global positions). Params
are each rank's blocks under :func:`param_specs`, the reference's ZeRO-3
plus Megatron layout (:func:`init_sharded`): every weight sharded over
``fsdp`` on one dim, all-gathered inside its layer's rematerialized
region (so the backward gathers again and no layer's whole weights
outlive it) and its gradient reduce-scattered back; attention heads and
FFN columns over ``tp``, the activation entering the column-sharded
``wq/wk/wv/w1/w3`` (its gradient summed over tp) and the ``wo``/``w2``
partial sums leaving by an all-reduce in f32 (``collectives.py``). Each
rank runs ``H / tp`` heads through the ring over the sp group of its own
``(dp, fsdp, tp)`` coordinate. The loss is averaged over the mesh and
each gradient summed over the ranks that hold a replica of its block
(:func:`loss_and_grads`).

Training: :func:`make_train_step` (forward, loss, backward, AdamW
against an f32 master for bf16 params), :func:`init_train_state` and
:func:`train`, the elastic loop with checkpoint/resume
(``checkpoint.py``) and the metrics report (``metrics_reporter.py``).
Given a ``torch.distributed`` process group, the step and the loop are
data-parallel over its ranks, the reference's ``dp`` mesh axis: each
rank takes its rows of the global batch, and the loss and gradients are
averaged over the group before AdamW, so every rank holds the same
params and the step equals one step over the global batch.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from ..device import resolve_device
from ..tracing import span
from . import sharding
from .adamw import adamw_
from .collectives import (count_all_reduce, count_exchange, enter_tp, gather,
                          leave_tp, reduce_gradients_)
from .flash_attention import FlashAttention, flash_attention
from .rendezvous import barrier
from .ring_attention import reference_attention, ring_apply, ring_of
from .sharding import (DATA_SPEC, axis_group, map_specs, mesh_sizes, shard,
                       shard_params, whole_shape)


@dataclasses.dataclass(frozen=True)
class LMConfig:
    vocab: int = 256
    d_model: int = 128
    n_layers: int = 2
    n_heads: int = 4
    d_ff: int = 512
    rope_base: float = 10_000.0
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    #: Rematerialize each layer in backward (``torch.utils.checkpoint``):
    #: activations are recomputed instead of kept, O(L*T) memory.
    remat: bool = True
    #: "full" recomputes everything; "dots" saves the weight matmuls'
    #: outputs and recomputes the rest (:data:`_DOTS_SAVED`).
    remat_policy: str = "dots"
    #: Cross-entropy in row-chunks of this many tokens so the
    #: [B*T, vocab] f32 logits are never materialized; 0 disables.
    loss_chunk: int = 0
    #: "ring" (sequence-parallel ring over the mesh's sp axis; one
    #: causal kernel launch on one device), "flash" (the attention
    #: kernel; single device) or "local" (plain attention; sp and tp 1).
    attn_impl: str = "ring"

    def __post_init__(self):
        if self.remat_policy not in ("full", "dots"):
            raise ValueError(f"remat_policy must be 'full' or 'dots', "
                             f"got {self.remat_policy!r}")
        if self.attn_impl not in ("ring", "flash", "local"):
            raise ValueError(f"attn_impl must be 'ring', 'flash' or "
                             f"'local', got {self.attn_impl!r}")
        if self.loss_chunk < 0:
            raise ValueError(
                f"loss_chunk must be >= 0 (0 disables chunking), "
                f"got {self.loss_chunk}")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def param_specs(cfg: LMConfig) -> dict:
    """The reference's partition specs of the params, one entry per dim
    (the leading None is the stacked-layers axis): the embedding over
    vocab rows by ``fsdp``; each weight over ``fsdp`` on one dim and over
    ``tp`` on its heads or FFN columns (``wq/wk/wv/w1/w3``) or rows
    (``wo/w2``); the norms replicated."""
    return {
        "embed": ("fsdp", None),
        "layers": {
            "ln1": (None, None),
            "wq": (None, "fsdp", "tp"),
            "wk": (None, "fsdp", "tp"),
            "wv": (None, "fsdp", "tp"),
            "wo": (None, "tp", "fsdp"),
            "ln2": (None, None),
            "w1": (None, "fsdp", "tp"),
            "w3": (None, "fsdp", "tp"),
            "w2": (None, "tp", "fsdp"),
        },
        "ln_f": (None,),
    }


#: The dim of one layer's weight (its layer axis taken off) that is
#: sharded over fsdp, or None.
_FSDP_DIMS = {name: spec.index("fsdp") - 1 if "fsdp" in spec else None
              for name, spec in param_specs(None)["layers"].items()}


def init_params(generator: torch.Generator, cfg: LMConfig) -> dict:
    """Random params on ``generator``'s device, scaled as the reference
    initialises them. The numbers differ from ``jax.random``'s; use
    :func:`params_from_jax` where both sides need the same params."""
    e, f, l = cfg.d_model, cfg.d_ff, cfg.n_layers
    dt, dev = cfg.param_dtype, generator.device

    def norm(shape, scale):
        x = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32)
        return (x * scale).to(dt)

    def ones(shape):
        return torch.ones(shape, dtype=dt, device=dev)

    return {
        "embed": norm((cfg.vocab, e), e ** -0.5),
        "layers": {
            "ln1": ones((l, e)),
            "wq": norm((l, e, e), e ** -0.5),
            "wk": norm((l, e, e), e ** -0.5),
            "wv": norm((l, e, e), e ** -0.5),
            "wo": norm((l, e, e), (2 * l * e) ** -0.5),
            "ln2": ones((l, e)),
            "w1": norm((l, e, f), e ** -0.5),
            "w3": norm((l, e, f), e ** -0.5),
            "w2": norm((l, f, e), (2 * l * f) ** -0.5),
        },
        "ln_f": ones((e,)),
    }


def _to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # numpy has no bf16; keep the bits
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))  # a writable copy


def params_from_jax(tree: dict, cfg: LMConfig, device=None) -> dict:
    """The reference's parameter tree (its leaves as numpy arrays, or
    anything ``np.asarray`` takes) as this module's params, in
    ``cfg.param_dtype`` on ``device``. Shapes carry over unchanged: both
    sides store weights ``[in, out]``."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {key: conv(val) for key, val in node.items()}
        return _to_tensor(node).to(device=dev, dtype=cfg.param_dtype)

    return conv(tree)


def _rms_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Normalise in f32, cast back to ``x.dtype``, then scale."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + 1e-6)).to(x.dtype) * scale


def _rope(x: torch.Tensor, cfg: LMConfig, offset: int = 0) -> torch.Tensor:
    """x: [B, H, T, D] at global positions ``offset .. offset + T - 1``
    (``offset`` = the rank's sp index times T under sequence
    parallelism). Rotates the INTERLEAVED pairs (x[..., 0::2],
    x[..., 1::2]) by f32 angles and re-interleaves them."""
    d, t = x.shape[-1], x.shape[2]
    freqs = cfg.rope_base ** (
        -torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    pos = torch.arange(offset, offset + t, dtype=torch.float32,
                       device=x.device)
    ang = pos[:, None] * freqs[None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x1 * sin + x2 * cos
    return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)


def _attention(q, k, v, cfg: LMConfig, ring) -> torch.Tensor:
    if cfg.attn_impl == "flash":
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if torch.is_grad_enabled():
            return FlashAttention.apply(q, k, v)
        return flash_attention(q, k, v)
    if cfg.attn_impl == "local":
        return reference_attention(q, k, v)
    return ring_apply(q, k, v, ring)


def _check_mesh(cfg: LMConfig, mesh) -> dict:
    """The mesh's axis sizes, after the reference's refusals: "flash" on
    more than one device, "local" with the attention sharded."""
    sizes = mesh_sizes(mesh)
    if cfg.attn_impl == "flash" and math.prod(sizes.values()) != 1:
        raise ValueError(
            "attn_impl='flash' is the single-device fast path (the kernel "
            "sees one device's whole sequence); use 'ring' on multi-device "
            "meshes")
    if cfg.attn_impl == "local" and (sizes["sp"] != 1 or sizes["tp"] != 1):
        raise ValueError(
            "attn_impl='local' is batch-parallel only (plain attention over "
            "one rank's sequence); use 'ring' when sp/tp shard the "
            "attention itself")
    return sizes


@dataclasses.dataclass(frozen=True)
class Layout:
    """What a forward needs of its mesh, looked up once, for the dense LM
    and the MoE (``moe.py``'s meshes have ``ep`` where this has
    ``fsdp``): this rank's place on its sp ring (None at sp = 1); the
    groups of the fsdp, tp and ep axes through its coordinate (None for
    an axis of one rank or one the mesh lacks); ``replicas``, the groups
    of its dp and sp axes of more than one rank (under ep, the ranks
    holding copies of its experts); the axis ``sizes``, this rank's
    ``coord`` and the global ranks in mesh order (``order``). Without a
    mesh: one rank, every group None."""
    ring: Any = None
    fsdp: Any = None
    tp: Any = None
    ep: Any = None
    replicas: tuple = ()
    sizes: dict = dataclasses.field(default_factory=dict)
    coord: dict = dataclasses.field(default_factory=dict)
    order: tuple = (0,)

    @property
    def world(self) -> int:
        return len(self.order)

    @property
    def blocks(self) -> int:
        """The token blocks: ranks but for the tp copies of each."""
        return self.world // self.sizes.get("tp", 1)


def mesh_layout(mesh) -> Layout:
    """The :class:`Layout` of ``mesh`` (of any axis names), with no
    refusals; ``Layout()`` without one."""
    if mesh is None:
        return Layout()
    sizes = mesh_sizes(mesh)
    # Only summed over: their group ranks may be in any order.
    replicas = tuple(mesh[a].get_group() for a in ("dp", "sp")
                     if sizes.get(a, 1) > 1)
    return Layout(ring_of(mesh), axis_group(mesh, "fsdp"),
                  axis_group(mesh, "tp"), axis_group(mesh, "ep"),
                  replicas, sizes,
                  dict(zip(mesh.mesh_dim_names, mesh.get_coordinate())),
                  tuple(mesh.mesh.flatten().tolist()))


def layout(cfg: LMConfig, mesh) -> Layout:
    """The :class:`Layout` of ``mesh``, after :func:`_check_mesh`'s
    refusals."""
    _check_mesh(cfg, mesh)
    return mesh_layout(mesh)


def _embedding(params: dict, lay: Layout, cfg: LMConfig) -> torch.Tensor:
    """The whole embedding in the compute dtype, gathered over fsdp (its
    vocab rows): for the lookup and the tied unembed."""
    return gather(params["embed"], lay.fsdp, 0).to(cfg.compute_dtype)


#: One layer's weights, in the order :func:`_layer` takes them.
_LAYER_KEYS = ("ln1", "wq", "wk", "wv", "wo", "ln2", "w1", "w3", "w2")

#: The "dots" remat policy: save the outputs of the weight matmuls and
#: recompute everything else. ``aten.mm``/``addmm`` carry every weight
#: product (``y @ W`` folds batch and time into rows). ``aten.bmm`` is
#: left out: here it only comes from the plain attention's batched
#: einsums, whose [B, H, T, T] scores the reference's
#: ``dots_with_no_batch_dims_saveable`` does not save either. The flash
#: attention Function is no matmul op, so it is recomputed under both
#: policies, as the reference's splash custom call is.
_DOTS_SAVED = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default]


def _layer(x: torch.Tensor, cfg: LMConfig, lay: Layout, attend,
           offset: int, *weights) -> torch.Tensor:
    """One pre-norm transformer layer over this rank's block of the
    sequence, which starts at global position ``offset``, on the mesh's
    :class:`Layout` ``lay``, its attention ``attend(q, k, v)``;
    ``weights``, this rank's blocks in ``_LAYER_KEYS`` order, in any
    dtype: gathered over fsdp and cast to the compute dtype here, inside
    the rematerialized region, as the reference casts inside its scan.
    Under tp the rank runs its ``H / tp`` heads and ``d_ff / tp`` FFN
    columns. Its span, ``lm.layer``, opens again where remat recomputes
    it in the backward."""
    with span("lm.layer"):
        cdt = cfg.compute_dtype
        lp = {name: (w if _FSDP_DIMS[name] is None
                     else gather(w, lay.fsdp, _FSDP_DIMS[name])).to(cdt)
              for name, w in zip(_LAYER_KEYS, weights)}
        b, t, _ = x.shape
        dh = cfg.head_dim
        h = lp["wq"].shape[1] // dh
        y = enter_tp(_rms_norm(x, lp["ln1"]), lay.tp)
        q = (y @ lp["wq"]).reshape(b, t, h, dh).transpose(1, 2)
        k = (y @ lp["wk"]).reshape(b, t, h, dh).transpose(1, 2)
        v = (y @ lp["wv"]).reshape(b, t, h, dh).transpose(1, 2)
        q, k = _rope(q, cfg, offset), _rope(k, cfg, offset)
        o = attend(q, k, v).to(q.dtype)
        o = o.transpose(1, 2).reshape(b, t, h * dh)
        x = x + leave_tp(o @ lp["wo"], lay.tp)

        y = enter_tp(_rms_norm(x, lp["ln2"]), lay.tp)
        gate = F.silu(y @ lp["w1"]) * (y @ lp["w3"])
        return x + leave_tp(gate @ lp["w2"], lay.tp)


def hidden_states(params: dict, tokens: torch.Tensor, cfg: LMConfig,
                  mesh=None, attention=None) -> torch.Tensor:
    """tokens [B, T] int -> final hidden states [B, T, d_model]
    (post-ln_f, pre-unembed). Under a ``mesh`` ``tokens`` is the global
    batch, ``params`` this rank's blocks, and the result this rank's
    block of the states, [B / (dp * fsdp), T / sp, d_model]
    (``sharding.ACT_SPEC``), whole over tp.

    With ``cfg.remat`` and grad enabled each layer is one
    ``torch.utils.checkpoint`` region, so its activations are recomputed
    in the backward pass: with attn_impl="flash" (or "ring" at sp = 1) a
    train step then makes 2 x n_layers forward attention launches
    (n_layers without remat) and n_layers backward ones; at sp > 1, 2 x
    n_layers ring forwards and n_layers ring backwards.

    ``attention(q, k, v)``, where given, takes the place of
    ``cfg.attn_impl``'s attention over this rank's [B, H / tp, T / sp, D]
    block (e.g. ``ring_attention.gathered_attention``, the plain version
    that also takes f32); the layer is otherwise the same."""
    lay = layout(cfg, mesh)
    return _hidden(params, tokens, cfg, lay, mesh,
                   _embedding(params, lay, cfg), attention)


def _hidden(params: dict, tokens: torch.Tensor, cfg: LMConfig, lay: Layout,
            mesh, embed: torch.Tensor, attention=None) -> torch.Tensor:
    """:func:`hidden_states`, given the :class:`Layout` and the whole
    embedding (:func:`_embedding`), which the unembed shares."""
    tokens = shard(mesh, tokens, DATA_SPEC)
    offset = 0 if lay.ring is None else lay.ring.index * tokens.shape[1]
    cdt = cfg.compute_dtype
    if attention is None:
        def attention(q, k, v):
            return _attention(q, k, v, cfg, lay.ring)
    x = embed[tokens.long()]
    # unbind, not w[i]: its backward stacks the layers' grads once,
    # where indexing would add a full-size zero tensor per layer.
    per_layer = zip(*(params["layers"][name].unbind(0)
                      for name in _LAYER_KEYS))
    remat = cfg.remat and torch.is_grad_enabled()
    for weights in per_layer:
        args = (x, cfg, lay, attention, offset, *weights)
        if not remat:
            x = _layer(*args)
        elif cfg.remat_policy == "dots":
            x = checkpoint(_layer, *args, use_reentrant=False,
                           context_fn=_dots_context)
        else:
            x = checkpoint(_layer, *args, use_reentrant=False)
    return _rms_norm(x, params["ln_f"].to(cdt))


def _dots_context():
    return create_selective_checkpoint_contexts(_DOTS_SAVED)


def forward(params: dict, tokens: torch.Tensor, cfg: LMConfig,
            mesh=None, attention=None) -> torch.Tensor:
    """tokens [B, T] int -> logits [B, T, vocab] f32; under a ``mesh``
    this rank's block of them, [B / (dp * fsdp), T / sp, vocab].
    ``attention`` as in :func:`hidden_states`. The embedding is gathered
    once, for the lookup and the tied unembed."""
    lay = layout(cfg, mesh)
    embed = _embedding(params, lay, cfg)
    x = _hidden(params, tokens, cfg, lay, mesh, embed, attention)
    return (x @ embed.T).float()


def _xent_sum(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Sum over rows of (logsumexp - gold) for f32 [N, V] logits."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[:, None])[:, 0]
    return (logz - gold).sum()


def _chunk_xent_sum(x: torch.Tensor, targets: torch.Tensor,
                    embed: torch.Tensor) -> torch.Tensor:
    return _xent_sum((x @ embed.T).float(), targets)


def _chunked_xent(x: torch.Tensor, targets: torch.Tensor, embed: torch.Tensor,
                  chunk: int) -> torch.Tensor:
    """Mean next-token cross-entropy without materializing [B, T, V] f32
    logits: unembed and reduce ``chunk`` tokens at a time, the ragged
    tail last. Under grad each chunk is rematerialized, as the
    reference's scan body is, so the backward too holds one chunk's
    logits at a time."""
    b, t, e = x.shape
    flat_x = x.reshape(b * t, e)
    flat_t = targets.reshape(b * t)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = torch.is_grad_enabled()
    for s in range(0, b * t, chunk):
        args = (flat_x[s:s + chunk], flat_t[s:s + chunk], embed)
        total = total + (checkpoint(_chunk_xent_sum, *args, use_reentrant=False)
                         if remat else _chunk_xent_sum(*args))
    return total / (b * t)


def loss_fn(params: dict, batch: torch.Tensor, cfg: LMConfig,
            mesh=None, attention=None) -> torch.Tensor:
    """batch [B, T+1] int -> mean next-token cross-entropy (f32). Under
    a ``mesh`` ``batch`` is the global one and the loss the mean over
    this rank's block of tokens: inputs and targets are shifted first,
    then sharded, so no rank needs its neighbour's tokens. ``attention``
    as in :func:`hidden_states`."""
    inputs, targets = batch[:, :-1], batch[:, 1:]
    targets = shard(mesh, targets, DATA_SPEC)
    b, t = targets.shape
    if cfg.loss_chunk and b * t > cfg.loss_chunk:
        lay = layout(cfg, mesh)
        embed = _embedding(params, lay, cfg)
        x = _hidden(params, inputs, cfg, lay, mesh, embed, attention)
        return _chunked_xent(x, targets, embed, cfg.loss_chunk)
    logits = forward(params, inputs, cfg, mesh, attention)
    return _xent_sum(logits.reshape(b * t, -1), targets.reshape(b * t)) \
        / (b * t)


def make_forward(cfg: LMConfig, device=None, mesh=None):
    """``fn(params, tokens) -> logits`` on ``device`` (default ``cuda``;
    raises without one unless ``device="cpu"`` is asked for); under a
    ``mesh``, this rank's block of the logits of the global ``tokens``.
    Inference only: no autograd graph is kept."""
    dev = resolve_device(device)

    def fn(params: dict, tokens: torch.Tensor) -> torch.Tensor:
        if tokens.device != dev:
            raise ValueError(f"tokens are on {tokens.device}, the forward "
                             f"was made for {dev}")
        with torch.inference_mode():
            return forward(params, tokens, cfg, mesh)

    return fn


def _leaves(tree) -> list:
    """Leaves of a nested dict of tensors, in insertion order."""
    if isinstance(tree, dict):
        return [leaf for val in tree.values() for leaf in _leaves(val)]
    return [tree]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {key: _tree_map(fn, val) for key, val in tree.items()}
    return fn(tree)


@dataclasses.dataclass(frozen=True)
class AdamW:
    """``optax.adamw(lr, b1, b2, eps, weight_decay)`` with no mask (decay
    on every leaf), updating a dict of f32 tensors in place:

        mu = b1 mu + (1 - b1) g;   nu = b2 nu + (1 - b2) g^2
        p -= lr * (mu / (1 - b1^t) / (sqrt(nu / (1 - b2^t)) + eps) + wd p)

    State ``{"count", "mu", "nu"}`` as optax's ``ScaleByAdamState``;
    ``count`` is a CPU int64 scalar, so the bias corrections need no
    device sync. The arithmetic is ``adamw.adamw_``'s: one hand-written
    kernel on the card, ``torch._foreach_*`` on the CPU."""
    lr: float
    b1: float
    b2: float
    weight_decay: float
    eps: float = 1e-8

    def init(self, params: dict) -> dict:
        return {"count": torch.zeros((), dtype=torch.int64),
                "mu": _tree_map(torch.zeros_like, params),
                "nu": _tree_map(torch.zeros_like, params)}

    @torch.no_grad()
    def update_(self, params: dict, grads: dict, state) -> None:
        """One step of ``params`` in place. ``state`` is this optimizer's
        state over ``params``, or, for params stored low-precision, the
        pair ``(state over the master, master)`` that
        :func:`init_opt_state` makes: then the f32 master takes the step,
        ``grads`` are read in the params' dtype, and ``params`` are
        written as the new master rounded to nearest even."""
        out = None
        if isinstance(state, tuple):
            state, master = state
            out, params = _leaves(params), master
        state["count"] += 1
        adamw_(_leaves(params), _leaves(grads), _leaves(state["mu"]),
               _leaves(state["nu"]), lr=self.lr, b1=self.b1, b2=self.b2,
               eps=self.eps, weight_decay=self.weight_decay,
               t=int(state["count"]), out=out)


def make_optimizer(lr: float = 3e-3) -> AdamW:
    return AdamW(lr, b1=0.9, b2=0.95, weight_decay=0.01)


def _is_mixed(cfg: LMConfig) -> bool:
    """Mixed-precision storage: working params in a low-precision dtype
    (bfloat16) and an f32 master copy in the optimizer state. AdamW runs
    in f32 against the master; the params are the master cast down."""
    return cfg.param_dtype != torch.float32


def init_opt_state(params: dict, cfg: LMConfig, lr: float = 3e-3):
    """The optimizer state for ``params``: AdamW's state, or with mixed
    precision ``(adamw_state_over_master, master_f32)``, the reference's
    layout. The master is a copy: params and master never share memory."""
    opt = make_optimizer(lr)
    if _is_mixed(cfg):
        master = _tree_map(lambda p: p.detach().float().clone(), params)
        return opt.init(master), master
    return opt.init(params)


def init_train_state(generator: torch.Generator, cfg: LMConfig,
                     lr: float = 3e-3):
    """Whole params and optimizer state on ``generator``'s device, for
    one device: :func:`init_sharded` without a mesh."""
    params = init_params(generator, cfg)
    return params, init_opt_state(params, cfg, lr)


def init_sharded(generator: torch.Generator, cfg: LMConfig, mesh,
                 lr: float = 3e-3):
    """This rank's params and optimizer state on ``mesh``: the whole
    params initialised (the same on every rank from the same seed), this
    rank's block of each kept under :func:`param_specs`, and the f32
    master and AdamW state made over the blocks, as the reference's
    ``init_sharded`` lays them out. Without a mesh,
    :func:`init_train_state`."""
    params = shard_params(mesh, init_params(generator, cfg),
                          param_specs(cfg))
    return params, init_opt_state(params, cfg, lr)


def state_specs(cfg: LMConfig) -> dict:
    """The partition specs of a train state ``{"params", "opt_state"}``
    (:func:`init_sharded`): the params', for the params, the AdamW
    moments and the f32 master; ``()`` for the step count."""
    specs = param_specs(cfg)
    adam = {"count": (), "mu": specs, "nu": specs}
    return {"params": specs,
            "opt_state": (adam, specs) if _is_mixed(cfg) else adam}


def _average_(tensors: list, group) -> None:
    """Average ``tensors`` over the ranks of ``group`` in place: one
    all-reduce per dtype, over one flat buffer, as a SUM and then a
    division by the group's size (gloo has no AVG)."""
    from torch import distributed as dist
    world = dist.get_world_size(group)
    by_dtype: dict = {}
    for x in tensors:
        by_dtype.setdefault(x.dtype, []).append(x)
    for same in by_dtype.values():
        flat = torch.cat([x.reshape(-1) for x in same])
        count_all_reduce(flat)
        dist.all_reduce(flat, group=group)
        flat.div_(world)
        for x, part in zip(same, flat.split([x.numel() for x in same])):
            x.copy_(part.view_as(x))


def _mesh_group(mesh):
    """The process group of all of ``mesh``'s ranks, over which the loss
    and gradients are averaged: the default group, which the mesh must
    span; None for no mesh or a mesh of one."""
    if mesh is None or mesh.size() == 1:
        return None
    from torch import distributed as dist
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"the mesh's {mesh.size()} ranks must span the "
                         f"process group's {dist.get_world_size()}")
    return dist.group.WORLD


def _one_of(group, mesh):
    """The group to average over: ``group`` (data parallelism over its
    ranks, each given its rows) or the ranks of ``mesh`` (each given the
    global batch); not both."""
    if group is not None and mesh is not None:
        raise ValueError("pass a process group (dp over its ranks) or a "
                         "mesh, not both")
    return group if mesh is None else _mesh_group(mesh)


#: The axes that split the global batch into token blocks.
TOKEN_AXES = ("dp", "fsdp", "sp")


def _spec_leaves(tree: dict, specs: dict) -> list:
    """The spec of each leaf of ``tree``, in :func:`_leaves` order."""
    if isinstance(tree, dict):
        return [s for key, val in tree.items()
                for s in _spec_leaves(val, specs[key])]
    return [specs]


def loss_and_grads(params: dict, batch: torch.Tensor, cfg: LMConfig,
                   group=None, mesh=None, attention=None):
    """``(loss, grads)``: the loss detached, grads a dict shaped like
    ``params`` in the params' dtype (``jax.value_and_grad(loss_fn)``).
    Under a process ``group`` (``batch`` this rank's rows) both are
    averaged over its ranks. Under a ``mesh`` (``batch`` the global one,
    ``params`` this rank's blocks) the loss is averaged over the mesh and
    each leaf's gradient, already summed over fsdp where the leaf is
    sharded on it (the gather's reduce-scatter), is summed over the other
    ranks that hold a replica of its block among ``dp``, ``fsdp`` and
    ``sp`` (never over tp: see ``collectives.reduce_gradients_``) and
    divided by ``dp * fsdp * sp``, the number of token blocks. Either
    way: the loss and gradients of the whole batch. ``attention`` as in
    :func:`hidden_states`. Spans: ``lm.forward`` (the loss), then
    ``lm.backward``, then, under a group or mesh, ``lm.grad_sync``."""
    group = _one_of(group, mesh)
    wrt = _tree_map(lambda p: p.detach().requires_grad_(), params)
    with span("lm.forward"):
        loss = loss_fn(wrt, batch, cfg, mesh, attention)
    with span("lm.backward"):
        grads = torch.autograd.grad(loss, _leaves(wrt))
    loss = loss.detach()
    if group is not None:
        with span("lm.grad_sync"):
            count_exchange()
            if mesh is not None:
                _average_([loss], group)
                reduce_gradients_(list(grads),
                                  _spec_leaves(wrt, param_specs(cfg)),
                                  mesh, TOKEN_AXES)
            else:
                _average_([loss, *grads], group)
    grads = iter(grads)
    return loss, _tree_map(lambda _: next(grads), wrt)


def make_train_step(cfg: LMConfig, lr: float = 3e-3, device=None,
                    group=None, mesh=None, attention=None):
    """``step(params, opt_state, batch) -> (params, opt_state, loss)`` on
    ``device`` (default ``cuda``; raises without one unless
    ``device="cpu"``): forward, loss, backward and AdamW (against the
    f32 master when params are stored low-precision). Params and state
    are updated in place and returned, where the reference donates its
    buffers; ``loss`` is a 0-dim f32 tensor on the device. Under a
    process ``group`` (data parallelism: ``batch`` is this rank's rows)
    or a ``mesh`` (``batch`` is the global batch; params, master and AdamW
    state this rank's blocks) the loss and gradients are those of the
    whole batch (:func:`loss_and_grads`) before AdamW. ``attention`` as
    in :func:`hidden_states`. The kernels take bf16 and f32 q, k, v
    (f32 up to head dim 128), so an f32 step (``compute_dtype=
    torch.float32``) runs through them by default too. The update (AdamW
    against the master, which writes the params) is the span
    ``lm.update``."""
    dev = resolve_device(device)
    opt = make_optimizer(lr)
    _one_of(group, mesh)

    def step(params: dict, opt_state, batch: torch.Tensor):
        if batch.device != dev:
            raise ValueError(f"batch is on {batch.device}, the step was "
                             f"made for {dev}")
        loss, grads = loss_and_grads(params, batch, cfg, group, mesh,
                                     attention)
        with torch.no_grad(), span("lm.update"):
            opt.update_(params, grads, opt_state)
        return params, opt_state, loss

    return step


def synthetic_batch(generator: torch.Generator, cfg: LMConfig, batch: int,
                    seq: int, device=None) -> torch.Tensor:
    """Deterministic learnable stream tok_n = (3^n * tok_0 + 7n) % vocab
    with 2% replacement noise, [B, T+1] int32, drawn from ``generator``
    (which lives on ``device``)."""
    dev = resolve_device(device)
    start = torch.randint(0, cfg.vocab, (batch, 1), generator=generator,
                          device=dev, dtype=torch.int64)
    # Powers of 3 reduced mod vocab with Python ints: 3**t would overflow.
    pow3, p = [], 1
    for _ in range(seq + 1):
        pow3.append(p)
        p = (p * 3) % cfg.vocab
    steps = torch.arange(seq + 1, device=dev)
    toks = (start * torch.tensor(pow3, device=dev) + 7 * steps) % cfg.vocab
    noise = torch.rand(toks.shape, generator=generator, device=dev) < 0.02
    rand = torch.randint(0, cfg.vocab, toks.shape, generator=generator,
                         device=dev, dtype=torch.int64)
    return torch.where(noise, rand, toks).to(torch.int32)


def _batch_generator(device: torch.device, rng_seed: int,
                     step: int) -> torch.Generator:
    """The generator of step ``step``'s batch: a function of the seed
    and the step alone, so a resumed run sees the batches an unbroken
    one would."""
    return torch.Generator(device=device).manual_seed(
        (rng_seed * 1_000_003 + step) % (1 << 63))


def train(cfg: LMConfig, steps: int, batch: int, seq: int,
          lr: float = 3e-3, ckpt_dir: str = "",
          checkpoint_every: int = 50, rng_seed: int = 0,
          publish_marker: bool = False, step_callback=None,
          device=None, group=None, mesh=None) -> dict:
    """Elastic training loop: resumes from the job's checkpoint when one
    exists (``checkpoint.py``: eviction and reschedule is a resume, not a
    restart), saving every ``checkpoint_every`` steps. Returns
    ``{"final_step", "loss", "resumed_from", "preempted"}``.

    ``publish_marker``: also publish the checkpoint-complete marker after
    every periodic save, the durable progress record the TrainJob
    controller reads. ``step_callback(step)`` runs after each completed
    step. A preemption request (``checkpoint.preempt_requested``) saves,
    publishes the marker and returns with ``preempted: True``; the next
    incarnation resumes at step + 1.

    Under a process ``group`` the loop is data-parallel over its ranks:
    ``batch`` is the global batch, a multiple of the group's size; every
    rank draws the same global batch of each step and trains on its own
    rows. Under a ``mesh`` (over all the process group's ranks) every
    rank draws the same global batch and the step shards it: rows by dp
    and fsdp, positions by sp; each rank holds its blocks of the state
    (:func:`init_sharded`). A save gathers the whole state (every rank
    takes part) and writes it in the one-device format, so a checkpoint
    resumes on any mesh or none; a resume restores the whole state on
    the host and keeps each rank's blocks. Either way the ranks agree on
    the start step (a barrier before reading the checkpoint) and on the
    preemption verdict (the largest of their flags, every step), so all
    of them save at the same step. Rank 0 is the one writer of
    checkpoints and markers; a barrier after each save keeps every rank
    from going on before it is durable."""
    import time

    from ..perf.chip_bench import BenchCase, train_flops_per_token
    from . import checkpoint as ckpt
    from .metrics_reporter import TrainingMetricsReporter

    dev = resolve_device(device)
    ckpt_dir = ckpt_dir or ckpt.checkpoint_dir()
    # The ranks that agree on the start, the verdict and the saves.
    gang = _one_of(group, mesh)
    rank, rows = 0, batch
    if gang is not None:
        from torch import distributed as dist
        rank, world = dist.get_rank(gang), dist.get_world_size(gang)
        if group is not None:
            if batch % world:
                raise ValueError(f"batch {batch} is not a multiple of the "
                                 f"group's {world} ranks")
            rows = batch // world
        barrier(gang, dev)

    def init():
        params, opt_state = init_sharded(
            torch.Generator(device=dev).manual_seed(rng_seed), cfg, mesh, lr)
        return {"params": params, "opt_state": opt_state}

    specs, template = state_specs(cfg), None
    if mesh is not None:
        sizes = mesh_sizes(mesh)

        def template():
            """The whole state's skeleton, on the host."""
            return map_specs(lambda x, spec: ckpt.TensorSpec(
                whole_shape(x.shape, spec, sizes), x.dtype,
                torch.device("cpu")), init(), specs)

    state, start = ckpt.resume_or_init(ckpt_dir, init, template_fn=template)
    if start and mesh is not None:
        # This rank's blocks on the device; the step count (spec ())
        # stays on the host, as AdamW keeps it.
        state = map_specs(lambda x, spec: shard(mesh, x, spec).to(
            dev, copy=True) if spec else x, state, specs)
    if rank == 0:
        # A marker left by the previous incarnation's preemption round
        # must not satisfy a new round's wait.
        ckpt.clear_marker(ckpt_dir)

    def preempt_agreed() -> bool:
        """The gang's verdict: the signal reaches each pod at its own
        time, and every rank must save at the same step boundary."""
        local = ckpt.preempt_requested()
        if gang is None:
            return local
        flag = torch.tensor([int(local)], dtype=torch.int32, device=dev)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=gang)
        return bool(flag.item())

    def whole(x: torch.Tensor, spec: tuple):
        """``x`` gathered whole; on the host at the writer, None at the
        other ranks."""
        x = sharding.gather(mesh, x, spec)
        return x.cpu() if rank == 0 else None

    def save(step: int) -> None:
        state = {"params": params, "opt_state": opt_state}
        if mesh is not None:
            state = map_specs(whole, state, specs)
        if rank == 0:
            ckpt.save(step, state, ckpt_dir)
        if gang is not None:
            barrier(gang, dev)

    step_fn = make_train_step(cfg, lr, dev, group, mesh)
    params, opt_state = state["params"], state["opt_state"]
    loss = None
    reporter = TrainingMetricsReporter(
        flops_per_token=train_flops_per_token(BenchCase(
            "train", cfg.d_model, cfg.n_layers, cfg.n_heads, cfg.d_ff,
            cfg.vocab, batch, seq)), device=dev)
    for step in range(start, steps):
        t0 = time.perf_counter()
        data = synthetic_batch(_batch_generator(dev, rng_seed, step), cfg,
                               batch, seq, dev)
        if group is not None:
            data = data[rank * rows:(rank + 1) * rows]
        params, opt_state, loss = step_fn(params, opt_state, data)
        if reporter.enabled:
            value = float(loss)  # waits for the step: an honest step time
            reporter.report(step, time.perf_counter() - t0, batch * seq,
                            loss=value)
        if preempt_agreed():
            save(step)
            if rank == 0:
                ckpt.write_marker(ckpt_dir, step)
            return {"final_step": step + 1, "resumed_from": start,
                    "loss": float(loss), "preempted": True}
        if checkpoint_every and (step + 1) % checkpoint_every == 0:
            save(step)
            if publish_marker and rank == 0:
                # Only after every rank passed the save: the marker
                # asserts the step is durable.
                ckpt.write_marker(ckpt_dir, step)
        if step_callback is not None:
            step_callback(step)
    return {"final_step": steps, "resumed_from": start,
            "loss": float(loss) if loss is not None else None,
            "preempted": False}
