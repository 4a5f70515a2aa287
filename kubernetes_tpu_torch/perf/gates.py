"""The correctness gates that a run on the card holds the kernel paths to.

- :func:`drift`: the kernel path no further from an f32 reference than
  the plain bf16 path is: within 2x its largest and 1.5x its mean
  deviation.
- :func:`moe_layer_gate`: the MoE model layer by layer, each layer given
  the same input in three paths (the flash kernels, the plain bf16 path,
  f32). Under bf16, routing near-ties flip between paths, and a flipped
  token takes other experts' weights, so whole-forward logits are no
  fair drift target. Each layer is held to :func:`drift` on the tokens
  whose top-k sets, and kept experts after the capacity cut, agree in all
  three paths, and to at most :data:`MOE_FLIP_SHARE` of its tokens with
  another top-k set in any path. Its attention's output, where the
  paths differ in the attention alone, is held to :func:`drift` on
  every token. With ``f32_kernels``, a fourth path (the flash kernels'
  f32 instances at f32 compute) is held to the f32 path within
  :data:`F32_RULE` of the flash path's deviation, on the same tokens.
- :func:`f32_rule`: the f32 instances' outputs no further from an exact
  version than :data:`F32_RULE` of the bf16 path's largest deviation;
  :func:`plain64`, attention and its gradients in float64, that exact
  version; :func:`attention_f64`, the same as a differentiable attention
  for a model's train step; :func:`attention_tf32`, plain attention with
  every product in one-pass TF32, the lower-precision control that a
  rule on an f32 model's steps must reject; :func:`f32_steps_rule`, that
  rule.

``chip_smoke.py`` and ``tests/test_torch_cuda.py`` run them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch

from ..workloads import moe
from ..workloads.ring_attention import (causal_mask, reference_attention,
                                        ring_apply)

#: The largest share of a layer's tokens whose top-k set may differ
#: between the three paths.
MOE_FLIP_SHARE = 0.01
#: The f32 instances' largest deviation from an exact version, as a
#: share of the bf16 instances' deviation from it at the most.
F32_RULE = 1 / 256
#: The f32 LM's and f32 MoE's losses against plain f32 attention's,
#: relative: the forward's and the first step's. After the first step
#: an f32 model's train steps are held by :func:`f32_steps_rule`.
F32_LOSS_RTOL = 1e-4
#: Bytes of f64 scores a chunk of heads may take at once.
_CHUNK_BYTES = 1 << 30


def drift(got: torch.Tensor, plain: torch.Tensor,
          exact: torch.Tensor) -> dict:
    """How far ``got`` and the plain version ``plain`` are from the f32
    ``exact``; ``ok`` when ``got`` is within twice the plain version's
    largest and 1.5 times its mean deviation."""
    dev_got = (got.float() - exact).abs()
    dev_plain = (plain.float() - exact).abs()
    row = {"max_abs_vs_f32": float(dev_got.max()),
           "plain_max_abs_vs_f32": float(dev_plain.max()),
           "mean_abs_vs_f32": float(dev_got.mean()),
           "plain_mean_abs_vs_f32": float(dev_plain.mean())}
    row["ok"] = (row["max_abs_vs_f32"] <= 2 * row["plain_max_abs_vs_f32"]
                 and row["mean_abs_vs_f32"]
                 <= 1.5 * row["plain_mean_abs_vs_f32"])
    return row


def _one_device(q, k, v):
    """The default attention of one device: one causal launch of the
    flash kernel on CUDA tensors, its plain version on CPU tensors."""
    return ring_apply(q, k, v, None)


@torch.no_grad()
def _moe_layer(x, params, layer: int, cfg, attend):
    """:func:`moe._layer` of ``params``' layer ``layer`` on ``x`` in
    ``cfg``'s compute dtype: ``(out, attention, top-k sets [N, k], kept
    experts [N, E])``: the layer's output, its attention's output
    [B, H, T, D], each token's picks sorted and the experts that
    capacity keeps."""
    weights = [params["layers"][name][layer] for name in moe._LAYER_KEYS]
    parts, seen = {}, []

    def attention(q, k, v):
        seen.append(attend(q, k, v))
        return seen[-1]

    out, _ = moe._layer(x.to(cfg.compute_dtype), cfg, attention, 0, None,
                        *weights, parts=parts)
    return (out, seen[0], parts["top_k"].sort(dim=-1).values,
            parts["dispatch"].sum(dim=-1) > 0)


def moe_layer_gate(params: dict, tokens: torch.Tensor, cfg,
                   plain_params: dict | None = None,
                   plain_attention=None, f32_kernels: bool = False
                   ) -> list[dict]:
    """Each layer of the one-device MoE forward of ``tokens`` [B, T] in
    three paths, given the flash path's input to the layer: the flash
    kernels (``params`` on the card, ``cfg``), the plain bf16 path and
    the f32 path (``plain_params``, default ``params``, with
    ``plain_attention``, default the one-device attention: on CPU params
    that is the kernels' plain version). A row per layer: :func:`drift`
    of the flash path's output on the tokens whose routing agrees in all
    three (``held`` of ``tokens``); ``attention``, :func:`drift` of its
    attention's output on every token (before the output projection and
    the residual, whose rounding the paths share); ``flip_share`` (top-k
    sets that differ), ``kept_differ`` (of the agreeing sets, tokens that
    capacity keeps differently) and ``ok``, which the caller holds. With
    ``f32_kernels`` a fourth path, the flash kernels at f32 compute
    (``params``, one-device attention), joins the routing agreement, and
    ``f32_kernels`` of a row holds its layer output's and attention
    output's largest deviation from the f32 path and each one's ratio to
    the flash path's; ``ok`` needs both at most :data:`F32_RULE`."""
    plain_params = params if plain_params is None else plain_params
    attend = plain_attention or _one_device
    paths = {"flash": (params, cfg, _one_device),
             "plain": (plain_params, cfg, attend),
             "f32": (plain_params, dataclasses.replace(
                 cfg, compute_dtype=torch.float32), attend)}
    if f32_kernels:
        paths["f32_flash"] = (params, dataclasses.replace(
            cfg, compute_dtype=torch.float32), _one_device)
    dev = tokens.device
    x = params["embed"].to(cfg.compute_dtype)[tokens.long()]
    d = cfg.d_model
    rows = []
    for layer in range(cfg.n_layers):
        outs, attended, sets, kept = {}, {}, {}, {}
        for name, (p, c, att) in paths.items():
            where = p["embed"].device
            got = _moe_layer(x.to(where), p, layer, c, att)
            outs[name], attended[name], sets[name], kept[name] = (
                t.to(dev) for t in got)
        same_sets = torch.stack([(sets["flash"] == sets[n]).all(-1)
                                 for n in paths]).all(0)
        same_kept = torch.stack([(kept["flash"] == kept[n]).all(-1)
                                 for n in paths]).all(0)
        agree = same_sets & same_kept
        flat = {n: o.reshape(-1, d)[agree] for n, o in outs.items()}
        row = drift(flat["flash"], flat["plain"], flat["f32"].float())
        attention = drift(attended["flash"], attended["plain"],
                          attended["f32"].float())
        row.update(layer=layer, tokens=int(agree.numel()),
                   held=int(agree.sum()),
                   flip_share=1 - float(same_sets.float().mean()),
                   kept_differ=int((same_sets & ~same_kept).sum()),
                   finite=bool(torch.isfinite(outs["flash"]).all()),
                   attention=attention)
        row["ok"] = (row["ok"] and attention["ok"] and row["finite"]
                     and row["flip_share"] <= MOE_FLIP_SHARE)
        if f32_kernels:
            f32 = {"max_abs_vs_f32": float(
                (flat["f32_flash"].float() - flat["f32"].float()).abs().max()),
                "attention_max_abs_vs_f32": float(
                    (attended["f32_flash"].float()
                     - attended["f32"].float()).abs().max())}
            f32["ratio"] = f32["max_abs_vs_f32"] / row["max_abs_vs_f32"]
            f32["attention_ratio"] = (f32["attention_max_abs_vs_f32"]
                                      / attention["max_abs_vs_f32"])
            row["f32_kernels"] = f32
            row["ok"] = (row["ok"] and f32["ratio"] <= F32_RULE
                         and f32["attention_ratio"] <= F32_RULE)
        rows.append(row)
        x = outs["flash"]
    return rows


def f32_rule(got: dict, bf16: dict, exact: dict) -> dict:
    """Each output's largest deviation from ``exact`` (a dict of the
    same names), the bf16 path's, and their ratio; ``ok`` when every
    ratio is at most :data:`F32_RULE` and ``got`` is finite."""
    row = {}
    for key, want in exact.items():
        dev = float((got[key].double() - want).abs().max())
        ref = float((bf16[key].double() - want).abs().max())
        row[key] = {"max_abs_vs_exact": dev, "bf16_max_abs_vs_exact": ref,
                    "ratio": dev / ref if ref else math.inf}
    row["ok"] = all(row[key]["ratio"] <= F32_RULE for key in exact) and all(
        bool(torch.isfinite(got[key]).all()) for key in exact)
    return row


def _heads(q: torch.Tensor) -> int:
    """Heads a chunk takes: about :data:`_CHUNK_BYTES` of f64 scores."""
    b, _, t, _ = q.shape
    return max(1, _CHUNK_BYTES // (8 * b * t * t))


def _scores64(q, k, causal: bool) -> torch.Tensor:
    """``q k^T / sqrt(D)`` of float64 ``q``, ``k``, -inf where masked."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(q.shape[-1])
    if causal:
        s = s.masked_fill(~causal_mask(q.shape[2], q.device), -math.inf)
    return s


def _chunk64(q, k, v, do, causal: bool) -> dict:
    """o, lse, dq, dk, dv of float64 [B, h, T, D] blocks."""
    s = _scores64(q, k, causal)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    del s
    o = p @ v
    ds = p * (do @ v.transpose(-1, -2) - (do * o).sum(-1, keepdim=True))
    scale = 1 / math.sqrt(q.shape[-1])
    return {"o": o, "lse": lse, "dq": ds @ k * scale,
            "dk": ds.transpose(-1, -2) @ q * scale,
            "dv": p.transpose(-1, -2) @ do}


def plain64(q, k, v, do, causal: bool = True) -> dict:
    """Attention (causal or not) and its gradients for the output
    gradient ``do``, in float64, all [B, H, T, D]: o, lse, dq, dk, dv,
    computed a few heads at a time."""
    n = _heads(q)
    parts = [_chunk64(*(x[:, h:h + n].double() for x in (q, k, v, do)),
                      causal) for h in range(0, q.shape[1], n)]
    return {key: torch.cat([p[key] for p in parts], dim=1)
            for key in parts[0]}


class _AttentionF64(torch.autograd.Function):
    """Plain causal attention in float64, a few heads at a time, output
    and gradients in the inputs' dtype; the backward recomputes P, so
    nothing of [T, T] is kept between the two."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        n = _heads(q)
        return torch.cat([
            (torch.softmax(_scores64(q[:, h:h + n].double(),
                                     k[:, h:h + n].double(), True), dim=-1)
             @ v[:, h:h + n].double()).to(q.dtype)
            for h in range(0, q.shape[1], n)], dim=1)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        got = plain64(q, k, v, do)
        return tuple(got[g].to(q.dtype) for g in ("dq", "dk", "dv"))


def attention_f64(q, k, v) -> torch.Tensor:
    """Plain causal attention in float64, the output (and, under
    autograd, the gradients) in ``q.dtype``, at the memory of a few
    heads' f64 scores: the more exact attention that an f32 model's steps
    are read against."""
    return _AttentionF64.apply(q, k, v)


@contextlib.contextmanager
def _tf32():
    """f32 matmuls in one-pass TF32 (10-bit operands) inside the block."""
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


class _AttentionTF32(torch.autograd.Function):
    """Plain causal attention with every product of the forward and of
    the backward in one-pass TF32, softmax and sums in f32; the backward
    recomputes the forward."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        with _tf32():
            return reference_attention(q, k, v)

    @staticmethod
    def backward(ctx, do):
        q, k, v = (x.detach().requires_grad_() for x in ctx.saved_tensors)
        with torch.enable_grad(), _tf32():
            return torch.autograd.grad(reference_attention(q, k, v),
                                       (q, k, v), do)


def attention_tf32(q, k, v) -> torch.Tensor:
    """Plain causal attention whose products, forward and backward, take
    one-pass TF32 on the card (the same as plain f32 on the CPU, which
    has no TF32): 10-bit operands, coarser than the f32 kernels' split
    route (two bf16 parts, 16 bits) and finer than bf16 (8 bits), the
    control that shows a rule on an f32 model's steps can tell an
    attention of less than f32 precision from the kernels."""
    return _AttentionTF32.apply(q, k, v)


def f32_steps_rule(kernels: list, plain: list, exact: list) -> dict:
    """An f32 path's train-step losses (``kernels``: one card's through
    the kernels, or a mesh's through the ring) against one card's with
    plain f32 attention (``plain``) and with plain attention in f64
    (``exact``), the three from the same params and batch.

    - Step 1: within F32_LOSS_RTOL of ``plain``.
    - Every step: no further from ``exact`` than F32_LOSS_RTOL or, where
      ``plain`` itself is further from it, twice ``plain``'s distance.

    A loss a few steps on is no finer than f32 attention's own rounding
    carried through AdamW: where ``plain`` is more than F32_LOSS_RTOL
    from ``exact``, an attention as exact as f64 fails F32_LOSS_RTOL
    against ``plain``; ``lm_f32`` reads the distances on the card, and
    shows the rule rejects one-pass TF32 attention. Returns the
    distances and ``ok``."""
    def rel(a, b):
        return [abs(x - y) / abs(y) for x, y in zip(a, b)]
    row = {"kernels_vs_plain": rel(kernels, plain),
           "kernels_vs_exact": rel(kernels, exact),
           "plain_vs_exact": rel(plain, exact)}
    row["bound"] = [max(F32_LOSS_RTOL, 2 * p) for p in row["plain_vs_exact"]]
    row["ok"] = (len(kernels) == len(plain) == len(exact)
                 and all(map(math.isfinite, kernels))
                 and row["kernels_vs_plain"][0] <= F32_LOSS_RTOL
                 and all(d <= b for d, b in zip(row["kernels_vs_exact"],
                                                row["bound"])))
    return row
