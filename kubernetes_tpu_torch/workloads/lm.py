"""Flagship workload: decoder-only transformer LM, forward pass.

Counterpart of ``kubernetes_tpu/workloads/lm.py``: the same config,
parameter tree (layers stacked on a leading axis, weights stored
``[in, out]`` and used as ``y @ W``), RoPE, RMSNorm, SwiGLU FFN, tied
embeddings, bf16 compute with f32 softmax and loss. Parameters are a
plain dictionary of tensors, so a JAX parameter tree carries over
through numpy (:func:`params_from_jax`).

``attn_impl="flash"`` runs the hand-written flash-attention kernel on
CUDA tensors (its plain version on CPU tensors); ``"local"`` runs the
plain :func:`~.ring_attention.reference_attention`. The ring and the
training step are ported in later changes.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from .flash_attention import flash_attention
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
    #: Rematerialize each layer in backward; read by the train step,
    #: which is ported later (the forward keeps no autograd graph).
    remat: bool = True
    #: "full" or "dots"; read by the train step.
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
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    if cfg.attn_impl == "local":
        return reference_attention(q, k, v)
    raise NotImplementedError(
        "attn_impl='ring' (sequence-parallel ring attention) is not ported "
        "yet; use 'flash' or 'local' on one device")


def hidden_states(params: dict, tokens: torch.Tensor,
                  cfg: LMConfig) -> torch.Tensor:
    """tokens [B, T] int -> final hidden states [B, T, d_model]
    (post-ln_f, pre-unembed)."""
    cdt = cfg.compute_dtype
    b, t = tokens.shape
    h, dh = cfg.n_heads, cfg.head_dim
    x = params["embed"].to(cdt)[tokens.long()]
    lp_all = params["layers"]
    for i in range(cfg.n_layers):
        lp = {name: w[i].to(cdt) for name, w in lp_all.items()}
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
        x = x + gate @ lp["w2"]
    return _rms_norm(x, params["ln_f"].to(cdt))


def forward(params: dict, tokens: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    """tokens [B, T] int -> logits [B, T, vocab] f32."""
    x = hidden_states(params, tokens, cfg)
    return (x @ params["embed"].to(cfg.compute_dtype).T).float()


def _xent_sum(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Sum over rows of (logsumexp - gold) for f32 [N, V] logits."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[:, None])[:, 0]
    return (logz - gold).sum()


def _chunked_xent(x: torch.Tensor, targets: torch.Tensor, embed: torch.Tensor,
                  chunk: int) -> torch.Tensor:
    """Mean next-token cross-entropy without materializing [B, T, V] f32
    logits: unembed and reduce ``chunk`` tokens at a time, the ragged
    tail last."""
    b, t, e = x.shape
    flat_x = x.reshape(b * t, e)
    flat_t = targets.reshape(b * t)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for s in range(0, b * t, chunk):
        logits = (flat_x[s:s + chunk] @ embed.T).float()
        total = total + _xent_sum(logits, flat_t[s:s + chunk])
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
