"""Where the MoE's f32 steps through the flash kernels part from plain f32,
and which 16-bit route of f32 operands keeps them with f64.

    python -m kubernetes_tpu_torch.perf.moe_f32_routing [--steps N]
        [--layers L] [--routes R [R ...]] [--no-routing]

On one card: the MoE at ``chip_bench.MOE_WIDTHS`` (head dim 128) in f32
params and compute at ``chip_bench.MOE_BATCH``, TF32 off, ``--steps``
train steps on one batch (seed 1) from the params of seed 0 (the model's
``make_train_step``, AdamW at lr 3e-3), in paths that differ in the
attention alone (:data:`PATHS`):

- ``kernels``: the default ring at sp = 1, the flash kernels' f32
  instances;
- ``plain``: plain f32 attention (``ring_attention.reference_attention``);
- ``f64``: plain attention in float64 (``gates.attention_f64``);
- ``split``: plain f32 attention on q, k and v rounded to two bf16 parts
  (hi + lo, within 2^-17 relative of each value): 16-bit operand
  precision without the products;
- ``split_<route>`` for each of ``--routes`` (:data:`ROUTES`): attention
  computed with the route's arithmetic (:func:`route_forward`,
  :func:`route_backward`): each operand as the route's 16-bit parts,
  each product the sum of the route's part products in f32, P and dS
  split the same way. ``bf16x2`` is the arithmetic of the kernels as
  they were before their fp16 parts, the others the candidates for a
  more exact one.

Prints each path's losses, their relative distance from ``plain`` and,
for the route paths, ``gates.f32_steps_rule`` against ``plain`` and
``f64`` with the share of its bound each step takes (a route kept with a
margin of 2x takes at most 0.5); unless ``--no-routing``, at each step's
params of the plain path, layer by layer with every path given the plain
path's input to the layer, the tokens whose top-k set of experts
(``top_k``), or whose experts kept after the capacity cut (``kept``),
differ from the plain path's. The last line is one JSON object with the
card's name.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess

import torch

from ..workloads import moe
from ..workloads.ring_attention import causal_mask, reference_attention
from . import chip_bench
from .gates import _moe_layer, _one_device, attention_f64, f32_steps_rule


@dataclasses.dataclass(frozen=True)
class Route:
    """How an f32 operand enters the 16-bit tensor-core products: as
    ``parts`` values of ``dtype`` (each the rounding of what the ones
    before it left out), under a power-of-2 scale where the dtype's
    range needs one (``scaled``: fp16), a product of two operands the
    sum of the part products with ``i + j`` at most 1 (``lolo``: every
    pair) or, in three parts, at most 2."""
    dtype: torch.dtype
    parts: int
    scaled: bool
    lolo: bool = False

    def terms(self) -> list:
        """The (part of A, part of B) pairs whose products are summed."""
        n = self.parts
        top = 2 * n - 2 if self.lolo else n - 1
        return [(i, j) for i in range(n) for j in range(n) if i + j <= top]


#: The candidate routes, in the order they are tried: the former bf16 hi
#: + lo (16 bits), fp16 hi + lo under a power-of-2 scale (22 bits) with
#: three products or with lo.lo kept, bf16 hi + mid + lo (24 bits).
ROUTES = {"bf16x2": Route(torch.bfloat16, 2, False),
          "fp16x2": Route(torch.float16, 2, True),
          "fp16x2_lolo": Route(torch.float16, 2, True, True),
          "bf16x3": Route(torch.bfloat16, 3, False)}
#: The route the flash kernels' f32 instances take (``csrc/hopper.cuh``),
#: chosen by this script's reading on the card (``PERF.md``).
KERNEL_ROUTE = "fp16x2"
#: fp16 operands are scaled so that a slice's largest |x| lands in
#: [2^14, 2^15): below fp16's largest finite value (65504) after
#: rounding, with 2^-14 of the range to spare above its subnormals.
SCALE_TOP = 14
#: The largest exponent of a scale (a slice whose largest |x| is under
#: 2^-112, or zero, takes 2^126, whose inverse is still a normal f32).
SCALE_MAX_EXP = 126
#: P lies in [0, 1]; it enters fp16 parts under this one fixed scale, so
#: small probabilities stay normal numbers.
P_SCALE = 2.0 ** 15


def scale_of(x: torch.Tensor, dims) -> torch.Tensor:
    """The power of 2 that takes the largest |x| over ``dims`` (kept as
    size-1 dims) into [2^SCALE_TOP, 2^(SCALE_TOP + 1)): 2^(SCALE_TOP -
    floor(log2 max|x|)), at most 2^SCALE_MAX_EXP."""
    amax = x.abs().amax(dim=dims, keepdim=True)
    _, e = torch.frexp(amax)  # amax = m 2^e, m in [0.5, 1)
    exp = torch.where(amax > 0, SCALE_TOP + 1 - e,
                      torch.full_like(e, SCALE_MAX_EXP))
    return torch.ldexp(torch.ones_like(amax),
                       exp.clamp(max=SCALE_MAX_EXP))


def parts_of(x: torch.Tensor, route: Route, dims=(-2, -1),
             fixed: float | None = None) -> list:
    """``x`` (f32) as ``route``'s parts, each in f32 and back at ``x``'s
    scale: their sum is ``x`` rounded to the route. A scaled route takes
    one scale per slice over ``dims`` (:func:`scale_of`; by default per
    [batch, head] slice of a [B, H, T, D] operand), or ``fixed``."""
    x = x.float()
    s = None
    if route.scaled:
        s = fixed if fixed is not None else scale_of(x, dims)
        x = x * s
    out = []
    for _ in range(route.parts):
        part = x.to(route.dtype).float()
        out.append(part)
        x = x - part
    return out if s is None else [p / s for p in out]


def slice_amax_bits(x: torch.Tensor) -> torch.Tensor:
    """The bits of each [batch, head] slice's largest |x| of a [B, H, T,
    D] f32 ``x``, [B * H] int32: what the kernels' pre-pass writes."""
    amax = x.float().abs().amax(dim=(-2, -1)).reshape(-1)
    return amax.contiguous().view(torch.int32)


def fp16_parts(x: torch.Tensor) -> tuple:
    """The fp16 hi and lo of [B, H, T, D] f32 ``x`` times its slices'
    scales (:func:`scale_of`): the pre-pass's parts, as the kernels read
    them."""
    y = x.float() * scale_of(x.float(), (-2, -1))
    hi = y.to(torch.float16)
    return hi, (y - hi.float()).to(torch.float16)


def product(eq: str, a: list, b: list, route: Route) -> torch.Tensor:
    """``einsum(eq)`` of two operands in parts: the route's part
    products, summed in f32."""
    return sum(torch.einsum(eq, a[i], b[j]) for i, j in route.terms())


def _scores(qp, kp, route, scale, causal):
    s = product("bhqd,bhkd->bhqk", qp, kp, route) * scale
    if causal:
        s = s.masked_fill(~causal_mask(s.shape[-1], s.device), -math.inf)
    return s


def _p_parts(p, route):
    return parts_of(p, route, fixed=P_SCALE if route.scaled else None)


def route_forward(q, k, v, causal: bool, route: Route, scale=None):
    """``(o, lse)`` of attention over [B, H, T, D] in ``route``'s
    arithmetic, both f32: S = Q K^T and O = P V from the operands' parts,
    P = exp(S * scale - lse) split as the route splits it."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    qp, kp, vp = (parts_of(x, route) for x in (q, k, v))
    s = _scores(qp, kp, route, scale, causal)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    del s
    return product("bhqk,bhkd->bhqd", _p_parts(p, route), vp, route), lse


def route_backward(q, k, v, o, do, lse, causal: bool, route: Route,
                   scale=None):
    """``(dq, dk, dv)`` in ``route``'s arithmetic, f32: P recomputed from
    the parts of Q and K, dP = dO V^T from the parts of dO and V, delta =
    rowsum(dO o) in f32, dS = P (dP - delta); dV = P^T dO; dQ = dS K with
    dS under a scale per query row (a row of the product); dK = dS^T Q
    with dS under a scale per key (a row of the product)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    qp, kp, vp, dop = (parts_of(x, route) for x in (q, k, v, do))
    p = torch.exp(_scores(qp, kp, route, scale, causal) - lse[..., None])
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    ds = p * (product("bhqd,bhkd->bhqk", dop, vp, route) - delta)
    dv = product("bhqk,bhqd->bhkd", _p_parts(p, route), dop, route)
    del p
    dq = product("bhqk,bhkd->bhqd", parts_of(ds, route, (-1,)), kp,
                 route) * scale
    dk = product("bhqk,bhqd->bhkd", parts_of(ds, route, (-2,)), qp,
                 route) * scale
    return dq, dk, dv


#: Bytes of f32 scores a chunk of heads of the route attention may take.
_CHUNK_BYTES = 1 << 28


def _chunks(q) -> range:
    b, h, t, _ = q.shape
    return range(0, h, max(1, _CHUNK_BYTES // (4 * b * t * t)))


class _RouteAttention(torch.autograd.Function):
    """Causal attention whose forward and backward take a route's
    arithmetic, a few heads at a time; output and gradients in
    ``q.dtype``."""

    @staticmethod
    def forward(ctx, q, k, v, route):
        n = _chunks(q).step
        outs = [route_forward(*(x[:, h:h + n] for x in (q, k, v)), True,
                              route) for h in _chunks(q)]
        o = torch.cat([x[0] for x in outs], dim=1)
        lse = torch.cat([x[1] for x in outs], dim=1)
        ctx.route = route
        ctx.save_for_backward(q, k, v, o, lse)
        return o.to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        n = _chunks(q).step
        grads = [route_backward(*(x[:, h:h + n] for x in (q, k, v, o, do)),
                                lse[:, h:h + n], True, ctx.route)
                 for h in _chunks(q)]
        return (*(torch.cat([g[i] for g in grads], dim=1).to(q.dtype)
                  for i in range(3)), None)


def route_attention(route: str):
    """Causal attention in the arithmetic of ``ROUTES[route]``."""
    r = ROUTES[route]
    return lambda q, k, v: _RouteAttention.apply(q, k, v, r)


def split_operands(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to the sum of its two bf16 parts (hi, its rounding;
    lo, the rounding of the rest), as the f32 kernels took it before
    their fp16 parts; the gradient passes through unchanged."""
    hi = x.to(torch.bfloat16).float()
    lo = (x - hi).to(torch.bfloat16).float()
    return x + (hi + lo - x).detach()


def split_attention(q, k, v) -> torch.Tensor:
    """Plain f32 attention on :func:`split_operands` of q, k and v."""
    return reference_attention(*(split_operands(t) for t in (q, k, v)))


#: The paths: the attention each step takes (None: the model's default,
#: the ring through the kernels). Each route read adds ``split_<route>``.
PATHS = {"kernels": None, "plain": reference_attention, "f64": attention_f64,
         "split": split_attention}


def routing_differs(params: dict, tokens: torch.Tensor, cfg,
                    paths: dict) -> dict:
    """At ``params``, layer by layer, each of ``paths`` fed the plain
    path's input to the layer: for every path but ``plain``, the tokens
    per layer whose top-k set (``top_k``) or kept experts (``kept``)
    differ from the plain path's."""
    x = params["embed"].to(cfg.compute_dtype)[tokens.long()]
    out = {n: {"top_k": [], "kept": []} for n in paths if n != "plain"}
    for layer in range(cfg.n_layers):
        got = {n: _moe_layer(x, params, layer, cfg, att or _one_device)
               for n, att in paths.items()}
        _, _, sets, kept = got["plain"]
        for n in out:
            out[n]["top_k"].append(int((got[n][2] != sets).any(-1).sum()))
            out[n]["kept"].append(int((got[n][3] != kept).any(-1).sum()))
        x = got["plain"][0]
        del got
    return out


def readings(cfg, batch: int, seq: int, steps: int, device="cuda",
             routes=(), routing: bool = True) -> dict:
    """Each path's ``steps`` losses, their distance from ``plain``'s,
    each route path's :func:`gates.f32_steps_rule` reading and the share
    of its bound each step takes, and (``routing``)
    :func:`routing_differs` at each step's params of the plain path."""
    paths = {**PATHS, **{f"split_{r}": route_attention(r) for r in routes}}
    data = moe.synthetic_batch(torch.Generator(device).manual_seed(1), cfg,
                               batch, seq, device)
    losses, differs = {}, []
    for name, attention in paths.items():
        params, opt_state = moe.init_train_state(
            torch.Generator(device).manual_seed(0), cfg)
        step = moe.make_train_step(cfg, device=device, attention=attention)
        losses[name] = []
        for _ in range(steps):
            if name == "plain" and routing:
                differs.append(routing_differs(params, data[:, :-1], cfg,
                                               paths))
            params, opt_state, loss = step(params, opt_state, data)
            losses[name].append(float(loss))
        del params, opt_state
        if device == "cuda":
            torch.cuda.empty_cache()
    rel = {n: [abs(x - y) / abs(y) for x, y in zip(got, losses["plain"])]
           for n, got in losses.items() if n != "plain"}
    rules = {}
    for name in ("kernels", *(f"split_{r}" for r in routes)):
        rule = f32_steps_rule(losses[name], losses["plain"], losses["f64"])
        rule["share_of_bound"] = [d / b for d, b in zip(
            rule["kernels_vs_exact"], rule["bound"])]
        rule["margin_2x"] = rule["ok"] and max(rule["share_of_bound"]) <= 0.5
        rules[name] = rule
    return {"losses": losses, "rel_to_plain": rel, "steps_rule": rules,
            "routing_differs_by_step": differs}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--routes", nargs="*", default=[], choices=list(ROUTES))
    ap.add_argument("--no-routing", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("moe_f32_routing: torch sees no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    batch, seq = chip_bench.MOE_BATCH
    cfg = moe.MoEConfig(n_layers=args.layers, **chip_bench.MOE_WIDTHS,
                        compute_dtype=torch.float32)
    out = readings(cfg, batch, seq, args.steps, routes=args.routes,
                   routing=not args.no_routing)
    print(smi)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "n_layers": cfg.n_layers, "batch": batch, "seq": seq,
                      "tokens_per_layer": batch * seq, **out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
