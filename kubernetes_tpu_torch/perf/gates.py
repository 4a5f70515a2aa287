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
  every token.

``chip_smoke.py`` and ``tests/test_torch_cuda.py`` run them.
"""
from __future__ import annotations

import dataclasses

import torch

from ..workloads import moe
from ..workloads.ring_attention import ring_apply

#: The largest share of a layer's tokens whose top-k set may differ
#: between the three paths.
MOE_FLIP_SHARE = 0.01


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
                   plain_attention=None) -> list[dict]:
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
    capacity keeps differently) and ``ok``, which the caller holds."""
    plain_params = params if plain_params is None else plain_params
    attend = plain_attention or _one_device
    paths = {"flash": (params, cfg, _one_device),
             "plain": (plain_params, cfg, attend),
             "f32": (plain_params, dataclasses.replace(
                 cfg, compute_dtype=torch.float32), attend)}
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
        same_sets = ((sets["flash"] == sets["plain"]).all(-1)
                     & (sets["flash"] == sets["f32"]).all(-1))
        same_kept = ((kept["flash"] == kept["plain"]).all(-1)
                     & (kept["flash"] == kept["f32"]).all(-1))
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
        rows.append(row)
        x = outs["flash"]
    return rows
