"""Flagship workload: decoder-only transformer LM, forward and training.

Counterpart of ``kubernetes_tpu/workloads/lm.py``: the same config,
parameter tree (layers stacked on a leading axis, weights stored
``[in, out]`` and used as ``y @ W``), RoPE, RMSNorm, SwiGLU FFN, tied
embeddings, bf16 compute with f32 softmax and loss. Parameters are a
plain dictionary of tensors, so a JAX parameter tree carries over
through numpy (:func:`params_from_jax`).

``attn_impl="flash"`` runs the hand-written flash-attention kernels on
CUDA tensors, forward and (under grad, through
:class:`~.flash_attention.FlashAttention`) backward; their plain
versions on CPU tensors. ``"local"`` runs the plain
:func:`~.ring_attention.reference_attention` under autograd. The ring is
ported in a later change.

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
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from ..device import resolve_device
from .flash_attention import FlashAttention, flash_attention
from .rendezvous import barrier
from .ring_attention import reference_attention


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
    #: "ring" (sequence-parallel ring; ported later), "flash" (the
    #: attention kernel; single device) or "local" (plain attention).
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


def _rope(x: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    """x: [B, H, T, D]. Rotates the INTERLEAVED pairs (x[..., 0::2],
    x[..., 1::2]) by f32 angles and re-interleaves them."""
    d, t = x.shape[-1], x.shape[2]
    freqs = cfg.rope_base ** (
        -torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] \
        * freqs[None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x1 * sin + x2 * cos
    return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)


def _attention(q, k, v, cfg: LMConfig) -> torch.Tensor:
    if cfg.attn_impl == "flash":
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if torch.is_grad_enabled():
            return FlashAttention.apply(q, k, v)
        return flash_attention(q, k, v)
    if cfg.attn_impl == "local":
        return reference_attention(q, k, v)
    raise NotImplementedError(
        "attn_impl='ring' (sequence-parallel ring attention) is not ported "
        "yet; use 'flash' or 'local' on one device")


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


def _layer(x: torch.Tensor, cfg: LMConfig, *weights) -> torch.Tensor:
    """One pre-norm transformer layer; ``weights`` in ``_LAYER_KEYS``
    order, in any dtype (cast to the compute dtype here, inside the
    rematerialized region, as the reference casts inside its scan)."""
    cdt = cfg.compute_dtype
    lp = {name: w.to(cdt) for name, w in zip(_LAYER_KEYS, weights)}
    b, t, _ = x.shape
    h, dh = cfg.n_heads, cfg.head_dim
    y = _rms_norm(x, lp["ln1"])
    q = (y @ lp["wq"]).reshape(b, t, h, dh).transpose(1, 2)
    k = (y @ lp["wk"]).reshape(b, t, h, dh).transpose(1, 2)
    v = (y @ lp["wv"]).reshape(b, t, h, dh).transpose(1, 2)
    q, k = _rope(q, cfg), _rope(k, cfg)
    o = _attention(q, k, v, cfg).to(q.dtype)
    o = o.transpose(1, 2).reshape(b, t, h * dh)
    x = x + o @ lp["wo"]

    y = _rms_norm(x, lp["ln2"])
    gate = F.silu(y @ lp["w1"]) * (y @ lp["w3"])
    return x + gate @ lp["w2"]


def hidden_states(params: dict, tokens: torch.Tensor,
                  cfg: LMConfig) -> torch.Tensor:
    """tokens [B, T] int -> final hidden states [B, T, d_model]
    (post-ln_f, pre-unembed).

    With ``cfg.remat`` and grad enabled each layer is one
    ``torch.utils.checkpoint`` region, so its activations are recomputed
    in the backward pass: with attn_impl="flash" a train step then makes
    2 x n_layers forward attention launches (n_layers without remat)
    and n_layers backward ones."""
    cdt = cfg.compute_dtype
    x = params["embed"].to(cdt)[tokens.long()]
    # unbind, not w[i]: its backward stacks the layers' grads once,
    # where indexing would add a full-size zero tensor per layer.
    per_layer = zip(*(params["layers"][name].unbind(0)
                      for name in _LAYER_KEYS))
    remat = cfg.remat and torch.is_grad_enabled()
    for weights in per_layer:
        if not remat:
            x = _layer(x, cfg, *weights)
        elif cfg.remat_policy == "dots":
            x = checkpoint(_layer, x, cfg, *weights, use_reentrant=False,
                           context_fn=_dots_context)
        else:
            x = checkpoint(_layer, x, cfg, *weights, use_reentrant=False)
    return _rms_norm(x, params["ln_f"].to(cdt))


def _dots_context():
    return create_selective_checkpoint_contexts(_DOTS_SAVED)


def forward(params: dict, tokens: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    """tokens [B, T] int -> logits [B, T, vocab] f32."""
    x = hidden_states(params, tokens, cfg)
    return (x @ params["embed"].to(cfg.compute_dtype).T).float()


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


def loss_fn(params: dict, batch: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    """batch [B, T+1] int -> mean next-token cross-entropy (f32)."""
    inputs, targets = batch[:, :-1], batch[:, 1:]
    b, t = inputs.shape
    if cfg.loss_chunk and b * t > cfg.loss_chunk:
        x = hidden_states(params, inputs, cfg)
        return _chunked_xent(x, targets,
                             params["embed"].to(cfg.compute_dtype),
                             cfg.loss_chunk)
    logits = forward(params, inputs, cfg)
    return _xent_sum(logits.reshape(b * t, -1), targets.reshape(b * t)) \
        / (b * t)


def make_forward(cfg: LMConfig, device=None):
    """``fn(params, tokens) -> logits`` on ``device`` (default ``cuda``;
    raises without one unless ``device="cpu"`` is asked for). Inference
    only: no autograd graph is kept."""
    dev = resolve_device(device)

    def fn(params: dict, tokens: torch.Tensor) -> torch.Tensor:
        if tokens.device != dev:
            raise ValueError(f"tokens are on {tokens.device}, the forward "
                             f"was made for {dev}")
        with torch.inference_mode():
            return forward(params, tokens, cfg)

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
    device sync."""
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
    def update_(self, params: dict, grads: dict, state: dict) -> None:
        p, g = _leaves(params), _leaves(grads)
        mu, nu = _leaves(state["mu"]), _leaves(state["nu"])
        state["count"] += 1
        t = int(state["count"])
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, g, alpha=1 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, g, g, value=1 - self.b2)
        denom = torch._foreach_div(nu, 1 - self.b2 ** t)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu, 1 - self.b1 ** t)
        torch._foreach_div_(upd, denom)
        del denom
        torch._foreach_add_(upd, p, alpha=self.weight_decay)
        torch._foreach_add_(p, upd, alpha=-self.lr)


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
    """Params and optimizer state on ``generator``'s device: the
    one-device counterpart of the reference's ``init_sharded``."""
    params = init_params(generator, cfg)
    return params, init_opt_state(params, cfg, lr)


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
        dist.all_reduce(flat, group=group)
        flat.div_(world)
        for x, part in zip(same, flat.split([x.numel() for x in same])):
            x.copy_(part.view_as(x))


def loss_and_grads(params: dict, batch: torch.Tensor, cfg: LMConfig,
                   group=None):
    """``(loss, grads)``: the loss detached, grads a dict shaped like
    ``params`` in the params' dtype (``jax.value_and_grad(loss_fn)``).
    Under a process ``group`` both are averaged over its ranks, each of
    which holds an equal share of the batch: the loss and gradients of
    the whole batch."""
    wrt = _tree_map(lambda p: p.detach().requires_grad_(), params)
    loss = loss_fn(wrt, batch, cfg)
    grads = torch.autograd.grad(loss, _leaves(wrt))
    loss = loss.detach()
    if group is not None:
        _average_([loss, *grads], group)
    grads = iter(grads)
    return loss, _tree_map(lambda _: next(grads), wrt)


def make_train_step(cfg: LMConfig, lr: float = 3e-3, device=None,
                    group=None):
    """``step(params, opt_state, batch) -> (params, opt_state, loss)`` on
    ``device`` (default ``cuda``; raises without one unless
    ``device="cpu"``): forward, loss, backward and AdamW (against the
    f32 master when params are stored low-precision). Params and state
    are updated in place and returned, where the reference donates its
    buffers; ``loss`` is a 0-dim f32 tensor on the device. Under a
    process ``group`` (data parallelism: ``batch`` is this rank's rows)
    the loss and gradients are averaged over its ranks before AdamW."""
    dev = resolve_device(device)
    opt = make_optimizer(lr)

    def step(params: dict, opt_state, batch: torch.Tensor):
        if batch.device != dev:
            raise ValueError(f"batch is on {batch.device}, the step was "
                             f"made for {dev}")
        loss, grads = loss_and_grads(params, batch, cfg, group)
        with torch.no_grad():
            if _is_mixed(cfg):
                inner, master = opt_state
                opt.update_(master, _tree_map(lambda g: g.float(), grads),
                            inner)
                del grads
                for p, m in zip(_leaves(params), _leaves(master)):
                    p.copy_(m)
            else:
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
          device=None, group=None) -> dict:
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
    rows. The ranks agree on the start step (a barrier before reading
    the checkpoint) and on the preemption verdict (the largest of their
    flags, every step), so all of them save at the same step. Rank 0 is
    the one writer of checkpoints and markers; a barrier after each
    save keeps every rank from going on before it is durable."""
    import time

    from ..perf.chip_bench import BenchCase, train_flops_per_token
    from . import checkpoint as ckpt
    from .metrics_reporter import TrainingMetricsReporter

    dev = resolve_device(device)
    ckpt_dir = ckpt_dir or ckpt.checkpoint_dir()
    rank, rows = 0, batch
    if group is not None:
        from torch import distributed as dist
        rank, world = dist.get_rank(group), dist.get_world_size(group)
        if batch % world:
            raise ValueError(f"batch {batch} is not a multiple of the "
                             f"group's {world} ranks")
        rows = batch // world
        barrier(group, dev)

    def init():
        params, opt_state = init_train_state(
            torch.Generator(device=dev).manual_seed(rng_seed), cfg, lr)
        return {"params": params, "opt_state": opt_state}

    state, start = ckpt.resume_or_init(ckpt_dir, init)
    if rank == 0:
        # A marker left by the previous incarnation's preemption round
        # must not satisfy a new round's wait.
        ckpt.clear_marker(ckpt_dir)

    def preempt_agreed() -> bool:
        """The gang's verdict: the signal reaches each pod at its own
        time, and every rank must save at the same step boundary."""
        local = ckpt.preempt_requested()
        if group is None:
            return local
        flag = torch.tensor([int(local)], dtype=torch.int32, device=dev)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
        return bool(flag.item())

    def save(step: int) -> None:
        if rank == 0:
            ckpt.save(step, {"params": params, "opt_state": opt_state},
                      ckpt_dir)
        if group is not None:
            barrier(group, dev)

    step_fn = make_train_step(cfg, lr, dev, group)
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
