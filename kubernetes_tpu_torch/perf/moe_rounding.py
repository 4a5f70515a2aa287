"""Whether an ep mesh's MoE losses differ from one card's only by
rounding.

On a mesh of ep ranks alone (dp = sp = 1) each rank computes its rows'
share of every dense weight's gradient in bf16, rounded once by the
matmul that makes it, and the all-reduce sums the shares in f32; one card
rounds the whole sum once. Each rank also runs its E / ep experts in
products of its own, whose shapes may make the GEMM library sum in
another order. This runs the full-width MoE's train steps from the
params and batch of ``chip_smoke.py``'s ``moe_ep`` phase (seeds 0 and 1)
and prints their losses as one JSON line:

- ``one_card``: ``moe.make_train_step``;
- ``shares_1``: :func:`make_step` with one share, this module's own
  composition of the model's layers: the control, which must give
  ``one_card``'s losses;
- ``rows_<n>``: :func:`make_step` with n shares: each rank's block of
  rows takes the dense weights through an alias of its own, so that an
  alias's gradient is that rank's share, rounded by itself, and the
  aliases' gradients are summed in f32; each block's projections and
  attention launch run at the rank's shapes. The router's gradient
  (f32) and the experts' are taken whole;
- ``ranks_<n>``: the same, with the experts also run as n groups of
  E / n, each in products of its own, as the ranks run them.

The mesh itself, in bf16 and in f32 beside one card's f32 steps, is
``chip_smoke.py``'s ``moe_ep`` phase (its f32 witness).

    python -m kubernetes_tpu_torch.perf.moe_rounding [--layers 8] \\
        [--steps 3] [--shares 1,2]
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..workloads import lm, moe
from ..workloads.lm import _rms_norm
from ..workloads.ring_attention import ring_apply
from . import chip_bench

#: The weights each block of rows takes through an alias of its own:
#: those used in the compute dtype on the rows alone (the embedding and
#: ``ln_f`` too, outside the layers).
SPLIT = ("ln1", "wq", "wk", "wv", "wo", "ln2")
#: The weights taken whole: the router (f32) and the experts.
WHOLE = ("router", *moe.EXPERT_KEYS)


def _attend(q, k, v):
    return ring_apply(q, k, v, None)


def _ffn(y: torch.Tensor, lp: dict, cfg: moe.MoEConfig, groups: int):
    """``moe._moe_ffn`` (itself for one group) with the experts run as
    ``groups`` groups of E / groups, each in products of its own: the
    shapes of an ep = ``groups`` mesh's ranks."""
    if groups == 1:
        return moe._moe_ffn(y, lp, cfg)
    cdt = cfg.compute_dtype
    b, t, d = y.shape
    yf = y.reshape(b * t, d)
    dispatch, combine, aux = moe._route(yf, lp["router"], cfg, b)
    expert_in = torch.einsum("nec,nd->ecd", dispatch.to(cdt), yf)
    outs = []
    for x, w1, w3, w2 in zip(*(w.chunk(groups) for w in (
            expert_in, lp["w1"], lp["w3"], lp["w2"]))):
        h = F.silu(torch.einsum("ecd,edf->ecf", x, w1))
        h = h * torch.einsum("ecd,edf->ecf", x, w3)
        outs.append(torch.einsum("ecf,efd->ecd", h, w2))
    mixed = torch.einsum("nec,ecd->nd", combine.to(cdt), torch.cat(outs))
    return mixed.reshape(b, t, d), aux


def _layer(xs: list, cfg: moe.MoEConfig, dense: list, whole: dict,
           groups: int):
    """One layer over the blocks ``xs`` ([B / n, T, d] each): each
    block's attention through its own ``dense`` weights, the MoE FFN over
    all rows at once (one capacity, one fill order). ``(xs, aux)``."""
    cdt = cfg.compute_dtype
    mids, ys = [], []
    for x, weights in zip(xs, dense):
        lp = {name: w.to(cdt) for name, w in weights.items()}
        mid = moe._attention_block(x, lp, cfg, _attend, 0)
        mids.append(mid)
        ys.append(_rms_norm(mid, lp["ln2"]))
    lp = {name: w if name == "router" else w.to(cdt)
          for name, w in whole.items()}
    out, aux = _ffn(torch.cat(ys), lp, cfg, groups)
    return [m + o for m, o in zip(mids, out.split(xs[0].shape[0]))], aux


def loss_fn(aliases: list, batch: torch.Tensor, cfg: moe.MoEConfig,
            groups: int = 1) -> torch.Tensor:
    """``moe.loss_fn`` of the global ``batch`` on one device, with block
    i of ``len(aliases)`` blocks of rows through ``aliases[i]``'s
    embedding, ``ln_f`` and :data:`SPLIT` weights, the :data:`WHOLE`
    weights from ``aliases[0]``, and the experts in ``groups`` groups
    (:func:`_ffn`)."""
    cdt = cfg.compute_dtype
    inputs, targets = batch[:, :-1], batch[:, 1:]
    rows = inputs.shape[0] // len(aliases)
    blocks = [slice(i * rows, (i + 1) * rows) for i in range(len(aliases))]
    xs = [a["embed"].to(cdt)[inputs[s].long()]
          for a, s in zip(aliases, blocks)]
    aux_total = torch.zeros((), dtype=torch.float32, device=batch.device)
    for layer in range(cfg.n_layers):
        dense = [{k: a["layers"][k][layer] for k in SPLIT} for a in aliases]
        whole = {k: aliases[0]["layers"][k][layer] for k in WHOLE}
        args = (xs, cfg, dense, whole, groups)
        xs, aux = (checkpoint(_layer, *args, use_reentrant=False)
                   if cfg.remat else _layer(*args))
        aux_total = aux_total + aux
    xent = 0.0
    for a, x, s in zip(aliases, xs, blocks):
        h = _rms_norm(x, a["ln_f"].to(cdt))
        logits = (h @ a["embed"].to(cdt).T).float()
        t = targets[s]
        xent = xent + lm._xent_sum(logits.reshape(t.numel(), -1),
                                   t.reshape(-1))
    return (xent / targets.numel()
            + cfg.aux_loss_weight * aux_total / cfg.n_layers)


def make_step(cfg: moe.MoEConfig, shares: int, lr: float = 3e-3,
              groups: int = 1):
    """``step(params, opt_state, batch) -> (params, opt_state, loss)``:
    ``moe.make_train_step``'s step on one device with the gradient of
    every weight but :data:`WHOLE` the f32 sum of ``shares`` blocks'
    gradients, and the experts in ``groups`` groups (:func:`loss_fn`)."""
    opt = lm.make_optimizer(lr)

    def step(params: dict, opt_state: dict, batch: torch.Tensor):
        aliases = [lm._tree_map(lambda p: p.detach().requires_grad_(),
                                params) for _ in range(shares)]
        loss = loss_fn(aliases, batch, cfg, groups)
        leaves = [lm._leaves(a) for a in aliases]
        grads = torch.autograd.grad(loss, [x for ls in leaves for x in ls],
                                    allow_unused=True)
        n = len(leaves[0])
        summed = []
        for j in range(n):
            parts = [g for g in grads[j::n] if g is not None]
            total = parts[0]
            for g in parts[1:]:
                total = total + g
            summed.append(total)
        it = iter(summed)
        opt.update_(params, lm._tree_map(lambda _: next(it), params),
                    opt_state)
        return params, opt_state, loss.detach()

    return step


def losses(cfg: moe.MoEConfig, batch: int, seq: int, steps: int,
           shares: int | None = None, device="cuda", groups: int = 1) -> list:
    """``steps`` train steps from the params of seed 0 on the batch of
    seed 1: ``moe.make_train_step``'s (``shares`` None), or
    :func:`make_step`'s with ``shares`` blocks and ``groups`` expert
    groups."""
    params, opt_state = moe.init_train_state(
        torch.Generator(device).manual_seed(0), cfg)
    tokens = moe.synthetic_batch(torch.Generator(device).manual_seed(1), cfg,
                                 batch, seq, device)
    step = (moe.make_train_step(cfg, device=device) if shares is None
            else make_step(cfg, shares, groups=groups))
    out = []
    for _ in range(steps):
        params, opt_state, loss = step(params, opt_state, tokens)
        out.append(float(loss))
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--layers", type=int, default=8)
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--shares", default="1,2")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("moe_rounding: torch sees no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    cfg = moe.MoEConfig(n_layers=args.layers, **chip_bench.MOE_WIDTHS)
    b, t = chip_bench.MOE_BATCH
    row = {"device": smi, "n_layers": args.layers, "batch": b, "seq": t,
           "one_card": losses(cfg, b, t, args.steps)}
    shares = [int(n) for n in args.shares.split(",")]
    for n in shares:
        torch.cuda.empty_cache()
        row[f"shares_{n}" if n == 1 else f"rows_{n}"] = losses(
            cfg, b, t, args.steps, n)
        if n > 1:
            torch.cuda.empty_cache()
            row[f"ranks_{n}"] = losses(cfg, b, t, args.steps, n, groups=n)
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
