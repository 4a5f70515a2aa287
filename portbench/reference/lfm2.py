"""The plain reference of LFM2-8B-A1B's training step (Hugging Face's
``lfm2_moe`` model), in f32.

Written for the benchmark from the layer equations that the
configuration file states, not from the program: it imports nothing of
``kubernetes_tpu_torch`` and takes nothing that the program made. It is
handed what the benchmark made from the seed (the initial params, the
batches) and works out the rest itself. This one file is also the
reference of the repository's CPU tests of the port's MoE path.

The model, layer i of ``layer_types``:

- ``h = x + mixer(rms(x))``, then ``out = h + ffn(rms(h))``; a final
  RMSNorm after the last layer; the unembedding tied to the embedding;
  the mean next-token cross-entropy.
- ``conv`` mixer (the gated short conv): ``B, C, u = split3(y W_in)``,
  ``z = conv1d(B * u)`` depthwise and causal (``conv_kernel`` taps, left
  padding, Hugging Face's ``Conv1d(padding=K-1)[..., :T]``), output
  ``(C * z) W_out``; no biases.
- ``attention`` mixer: ``n_heads`` query heads of ``d_model / n_heads``
  over ``n_kv_heads`` key/value heads, RMSNorm over the head dim on q
  and on k, then RoPE, causal softmax attention over each kv group
  (query head i reads kv head i // (H / KV)), output projection.
- FFN: the first ``n_dense_layers`` a dense SwiGLU of ``dense_d_ff``;
  the rest sparse: ``s = sigmoid(y W_router)``, each token's experts
  ``topk(s + expert_bias, top_k)``, their weights ``s`` at the picks
  over their sum + 1e-6, times ``routed_scale``; each pick through a
  SwiGLU expert of ``expert_d_ff``, the weighted outputs summed; no
  capacity, no token dropped (a loop over the experts here).
- After each AdamW step the expert bias moves, outside the gradient:
  ``bias += bias_rate * sign(mean load - load)`` per sparse layer
  (DeepSeek-V3's aux-loss-free rule, arXiv:2412.19437 section 2.1.2).

Departures from the published model, each one stated in the
configuration file: the unembedding is tied; RMSNorm's eps is the
run's ``norm_eps``; RoPE rotates interleaved pairs (x[..., 0::2],
x[..., 1::2]), a fixed permutation of q's and k's columns and of their
norms' weights, not the two halves.

Everything runs in f32 with TF32 off (``lm.exact_matmuls``), each layer
recomputed in the backward pass, attention over blocks of query rows
with its own backward (``lm.BlockedAttention``), the loss over blocks
of rows. ``matmul="fp8"`` is the control (``lm.product``): every weight
product but the router's takes e4m3 operands and an e5m2 output
gradient. ``dispatch="capacity"`` is a fault: GShard's capacity in the
dropless route's place, each expert keeping its first
``capacity_factor * top_k * tokens / experts`` picks, round by round in
token order.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .lm import (LOSS_ROWS, BlockedAttention, _adamw_, _loss_rows, _norms,
                 _rms, _rope, exact_matmuls, product)

#: Each group's leaves; a group stacks its leaves over its layers.
GROUPS = {
    "attention": ("ln", "wq", "wk", "wv", "q_norm", "k_norm", "wo"),
    "conv": ("ln", "in_proj", "conv", "out_proj"),
    "dense": ("ln", "w1", "w3", "w2"),
    "sparse": ("ln", "router", "w1", "w3", "w2"),
}


#: The leaves that :func:`read` leaves out: the RMSNorms' gains, the
#: short conv's taps and the router.
UNREAD = ("ln", "q_norm", "k_norm", "ln_f", "conv", "router")


def read(name: str) -> bool:
    """Whether the benchmark reads the leaf ``name``
    (:func:`leaf_shapes`'s): the weight matrices and the expert bias.
    The norms of :data:`UNREAD`'s small leaves move with the few tokens
    whose top-k set bf16's rounding flips against f32's (by up to 1% at
    the LFM2 cell's size) as much as with the rounding of every product,
    so that no limit on them tells fp8 products from bf16 ones; the
    weight matrices' norms sum over every routed row, flips and all, and
    the rounding of fp8 products lifts them."""
    return name.rsplit(".", 1)[-1] not in UNREAD


def leaf_shapes(run: dict) -> dict:
    """``{dotted name: shape}`` of the params: ``embed``; each group's
    leaves (``attention.wq``, ...), stacked over the layers of its kind;
    ``ln_f``; ``expert_bias`` [sparse layers, experts], which no
    gradient reaches."""
    d, v = run["d_model"], run["vocab"]
    h, kv = run["n_heads"], run["n_kv_heads"]
    dh = d // h
    e, f, ff = run["n_experts"], run["expert_d_ff"], run["dense_d_ff"]
    types = run["layer_types"]
    dense = run["n_dense_layers"]
    counts = {"attention": types.count("attention"),
              "conv": types.count("conv"), "dense": dense,
              "sparse": len(types) - dense}
    one = {
        "attention": {"ln": (d,), "wq": (d, h * dh), "wk": (d, kv * dh),
                      "wv": (d, kv * dh), "q_norm": (dh,), "k_norm": (dh,),
                      "wo": (h * dh, d)},
        "conv": {"ln": (d,), "in_proj": (d, 3 * d),
                 "conv": (d, run["conv_kernel"]), "out_proj": (d, d)},
        "dense": {"ln": (d,), "w1": (d, ff), "w3": (d, ff), "w2": (ff, d)},
        "sparse": {"ln": (d,), "router": (d, e), "w1": (e, d, f),
                   "w3": (e, d, f), "w2": (e, f, d)},
    }
    out = {"embed": (v, d)}
    for group, keys in GROUPS.items():
        if counts[group]:
            out.update({f"{group}.{k}": (counts[group], *one[group][k])
                        for k in keys})
    out["ln_f"] = (d,)
    out["expert_bias"] = (counts["sparse"], e)
    return out


# -- the mixers ----------------------------------------------------------

def conv_mixer(y, p: dict, matmul: str):
    """The gated short conv of [B, T, d]."""
    t = y.shape[1]
    b_gate, c_gate, u = product(y, p["in_proj"], matmul).chunk(3, dim=-1)
    bu = (b_gate * u).transpose(1, 2)
    k = p["conv"].shape[-1]
    z = F.conv1d(bu, p["conv"][:, None, :], padding=k - 1,
                 groups=bu.shape[1])[..., :t].transpose(1, 2)
    return product(c_gate * z, p["out_proj"], matmul)


def grouped_attention(q, k, v):
    """Causal attention of q [B, H, T, D] over k, v [B, KV, T, D], one
    kv group at a time: query heads g * H / KV .. (g + 1) * H / KV - 1
    over kv head g."""
    rep = q.shape[1] // k.shape[1]
    outs = []
    for g in range(k.shape[1]):
        kg = k[:, g:g + 1].expand(-1, rep, -1, -1).contiguous()
        vg = v[:, g:g + 1].expand(-1, rep, -1, -1).contiguous()
        outs.append(BlockedAttention.apply(
            q[:, g * rep:(g + 1) * rep].contiguous(), kg, vg))
    return torch.cat(outs, dim=1)


def attention_mixer(y, p: dict, run: dict, matmul: str):
    b, t, d = y.shape
    h, kv = run["n_heads"], run["n_kv_heads"]
    dh = d // h
    eps = run["norm_eps"]
    q = _rms(product(y, p["wq"], matmul).reshape(b, t, h, dh), p["q_norm"],
             eps)
    k = _rms(product(y, p["wk"], matmul).reshape(b, t, kv, dh), p["k_norm"],
             eps)
    v = product(y, p["wv"], matmul).reshape(b, t, kv, dh).transpose(1, 2)
    q = _rope(q.transpose(1, 2), run["rope_base"])
    k = _rope(k.transpose(1, 2), run["rope_base"])
    o = grouped_attention(q, k, v)
    return product(o.transpose(1, 2).reshape(b, t, h * dh), p["wo"], matmul)


# -- the FFNs ------------------------------------------------------------

def swiglu(y, w1, w3, w2, matmul: str):
    return product(F.silu(product(y, w1, matmul)) * product(y, w3, matmul),
                   w2, matmul)


def route(y, router, bias, run: dict):
    """``(experts [n, k], weights [n, k])`` of the tokens ``y`` [n, d]."""
    s = torch.sigmoid(y @ router)
    idx = torch.topk(s.detach() + bias, run["top_k"], dim=-1).indices
    w = torch.gather(s, 1, idx)
    if run["norm_topk"]:
        w = w / (w.sum(-1, keepdim=True) + 1e-6)
    return idx, w * run["routed_scale"]


def sparse_ffn(y, p: dict, bias, run: dict, matmul: str, dispatch: str):
    """``(out [B, T, d], load [E])``: each token's picks through their
    experts, one expert at a time; under ``dispatch="capacity"`` each
    expert keeps its first picks in (round, token) order."""
    b, t, d = y.shape
    yf = y.reshape(b * t, d)
    idx, w = route(yf, p["router"], bias, run)
    e = run["n_experts"]
    if dispatch == "capacity":
        cap = int(run["capacity_factor"] * run["top_k"] * b * t / e)
    out = torch.zeros_like(yf)
    load = torch.zeros(e, device=y.device)
    for x in range(e):
        rnd, tok = (idx.t() == x).nonzero(as_tuple=True)
        load[x] = tok.numel()
        if dispatch == "capacity":
            rnd, tok = rnd[:cap], tok[:cap]
        if tok.numel():
            h = swiglu(yf[tok], p["w1"][x], p["w3"][x], p["w2"][x], matmul)
            out = out.index_add(0, tok, w[tok, rnd][:, None] * h)
    return out.reshape(b, t, d), load


# -- the model -----------------------------------------------------------

def _layer(x, run: dict, matmul: str, dispatch: str, mixer: str, mp: dict,
           fp: dict, bias):
    eps = run["norm_eps"]
    y = _rms(x, mp["ln"], eps)
    x = x + (conv_mixer(y, mp, matmul) if mixer == "conv"
             else attention_mixer(y, mp, run, matmul))
    y = _rms(x, fp["ln"], eps)
    if bias is None:
        return x + swiglu(y, fp["w1"], fp["w3"], fp["w2"], matmul), None
    out, load = sparse_ffn(y, fp, bias, run, matmul, dispatch)
    return x + out, load


def hidden_states(params: dict, inputs: torch.Tensor, run: dict,
                  matmul: str = "f32", dispatch: str = "dropless",
                  loads: dict | None = None) -> torch.Tensor:
    """The final hidden states [B, T, d] (after the last RMSNorm) of
    ``inputs`` [B, T] under the flat f32 ``params``
    (:func:`leaf_shapes`); ``loads``, where given, gets each sparse
    layer's picks per expert added in, under its index."""
    x = params["embed"][inputs.long()]
    seen = {"attention": 0, "conv": 0}
    dense = run["n_dense_layers"]
    for i, mixer in enumerate(run["layer_types"]):
        mp = {k: params[f"{mixer}.{k}"][seen[mixer]] for k in GROUPS[mixer]}
        seen[mixer] += 1
        group, j = ("dense", i) if i < dense else ("sparse", i - dense)
        fp = {k: params[f"{group}.{k}"][j] for k in GROUPS[group]}
        bias = None if group == "dense" else params["expert_bias"][j]
        x, load = checkpoint(_layer, x, run, matmul, dispatch, mixer, mp, fp,
                             bias, use_reentrant=False)
        if load is not None and loads is not None:
            loads[j] = loads.get(j, 0) + load
    return _rms(x, params["ln_f"], run["norm_eps"])


def logits(params: dict, inputs: torch.Tensor, run: dict) -> torch.Tensor:
    """[B, T, vocab] f32 logits of ``inputs`` [B, T]."""
    return hidden_states(params, inputs, run) @ params["embed"].t()


def loss_sum(params: dict, tokens: torch.Tensor, run: dict,
             matmul: str = "f32", dispatch: str = "dropless",
             loads: dict | None = None) -> torch.Tensor:
    """The summed next-token cross-entropy of ``tokens`` [B, T+1] under
    the flat f32 ``params``; ``loads`` as in :func:`hidden_states`."""
    x = hidden_states(params, tokens[:, :-1], run, matmul, dispatch, loads)
    x = x.reshape(-1, x.shape[-1])
    targets = tokens[:, 1:].long().reshape(-1)
    total = x.new_zeros(())
    for s in range(0, x.shape[0], LOSS_ROWS):
        total = total + checkpoint(
            _loss_rows, x[s:s + LOSS_ROWS], targets[s:s + LOSS_ROWS],
            params["embed"], matmul, use_reentrant=False)
    return total


def update_bias_(bias: torch.Tensor, loads: dict, rate: float) -> None:
    """bias += rate * sign(mean load - load), each sparse layer."""
    with torch.no_grad():
        for j in range(bias.shape[0]):
            load = loads[j]
            bias[j] += rate * torch.sign(load.mean() - load)


def train_readings(run: dict, init_leaf, rows_of_step, steps: int,
                   opt: dict, matmul: str = "f32", dispatch: str = "dropless",
                   row_block: int = 0) -> dict:
    """``steps`` training steps from the initial params, one process, and
    what the benchmark compares of them (``lm.train_readings``'s
    readings, of the leaves that :func:`read` keeps): each step's loss,
    each leaf's gradient norm at the first step (the expert bias's: the
    norm of its first step), and each leaf's change after the last.
    ``init_leaf(name)`` gives a leaf's initial value
    (any dtype), ``rows_of_step(i)`` the rows [n, T+1] of step ``i``;
    ``row_block`` rows go through the model at a time (0: all; the
    capacity fault needs all)."""
    exact_matmuls()
    shapes = leaf_shapes(run)
    names = [n for n in shapes if n != "expert_bias"]
    params = {n: init_leaf(n).float().requires_grad_() for n in names}
    bias = init_leaf("expert_bias").float()
    state = {"count": 0, "m": {}, "v": {}}
    out = {"loss": []}
    for i in range(steps):
        rows = rows_of_step(i)
        scale = 1.0 / (rows.shape[0] * (rows.shape[1] - 1))
        total = torch.zeros((), device=rows.device)
        loads: dict = {}
        blk = row_block or rows.shape[0]
        for s in range(0, rows.shape[0], blk):
            part = loss_sum({**params, "expert_bias": bias}, rows[s:s + blk],
                            run, matmul, dispatch, loads) * scale
            part.backward()
            total += part.detach()
        grads = {n: params[n].grad for n in names}
        out["loss"].append(float(total))
        if i == 0:
            out["grad"] = _norms({n: g for n, g in grads.items() if read(n)})
        _adamw_({n: params[n].data for n in names}, grads, state, opt)
        update_bias_(bias, loads, run["bias_rate"])
        if i == 0:
            out["grad"]["expert_bias"] = float(torch.linalg.vector_norm(
                bias - init_leaf("expert_bias").float()))
        for p in params.values():
            p.grad = None
    del state
    with torch.no_grad():
        out["change"] = {n: float(torch.linalg.vector_norm(
            params[n] - init_leaf(n).float())) for n in names if read(n)}
        out["change"]["expert_bias"] = float(torch.linalg.vector_norm(
            bias - init_leaf("expert_bias").float()))
    return out
