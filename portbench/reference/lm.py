"""The plain reference of the LM family's training step, in f32.

Written for the benchmark from the block that the configuration files
state, not from the program: it imports nothing of
``kubernetes_tpu_torch`` and takes nothing that the program made. It is
handed what the benchmark made from the seed (the initial params, the
batches) and works out the rest itself.

The block: embedding lookup; L x [RMSNorm, q/k/v projections, RoPE on
interleaved pairs (x[..., 0::2], x[..., 1::2]) at base ``rope_base``,
causal softmax attention with scale 1/sqrt(head_dim), output projection,
residual; RMSNorm, SwiGLU (silu(y W1) * (y W3)) W2, residual]; a final
RMSNorm; the unembedding tied to the embedding; the mean next-token
cross-entropy. RMSNorm is x / sqrt(mean(x^2) + eps) times its scale.
AdamW is decoupled: p -= lr (m_hat / (sqrt(v_hat) + eps) + wd p).

Everything runs in f32 with TF32 off (:func:`exact_matmuls`), in blocks
so that the full-size cells fit beside nothing else on one card: each
layer is recomputed in the backward pass, attention runs over blocks of
query rows with its own backward (:class:`BlockedAttention`), the loss
over blocks of rows, and the batch in blocks of rows whose gradients add
up. Under a process group each rank takes its rows and the gradients are
summed over the group.

``matmul="fp8"`` is the control: every weight product (the projections,
SwiGLU's three and the unembedding) takes operands rounded to
float8_e4m3fn under a per-tensor scale, and its output's gradient is
rounded to float8_e5m2 the same way, the recipe of fp8 training. The
attention stays in f32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

LAYER_KEYS = ("ln1", "wq", "wk", "wv", "wo", "ln2", "w1", "w3", "w2")

#: The bytes one block of attention scores may take.
SCORE_BLOCK_BYTES = 4 << 30
#: Rows of the loss computed at a time.
LOSS_ROWS = 4096


def exact_matmuls() -> None:
    """f32 products in f32: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# -- fp8 rounding, for the control ----------------------------------------

def _round_fp8(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` under one scale that maps its largest
    |x| to the format's largest finite value, and scaled back, in f32."""
    top = torch.finfo(dtype).max
    amax = x.detach().abs().amax().clamp_min(1e-30)
    scale = top / amax
    return (x * scale).clamp(-top, top).to(dtype).to(torch.float32) / scale


class _GradToE5M2(torch.autograd.Function):
    """The identity forward; the incoming gradient rounded to e5m2."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g, torch.float8_e5m2)


def _e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to e4m3 forward, its gradient passed through."""
    return x + (_round_fp8(x, torch.float8_e4m3fn) - x).detach()


def product(a: torch.Tensor, w: torch.Tensor, matmul: str) -> torch.Tensor:
    """``a @ w`` in f32, or as fp8 training computes it."""
    if matmul == "f32":
        return a @ w
    return _GradToE5M2.apply(_e4m3(a) @ _e4m3(w))


# -- attention --------------------------------------------------------------

def _query_block(b: int, h: int, t: int) -> int:
    rows = SCORE_BLOCK_BYTES // max(1, b * h * t * 4)
    return max(16, min(t, rows))


def _scores(qs, k, start: int, stop: int) -> torch.Tensor:
    """Scores of the pre-scaled query rows start..stop-1 against keys
    0..stop-1, the keys after each query (all in the last stop - start
    columns) set to -inf."""
    s = qs[:, :, start:stop] @ k[:, :, :stop].transpose(-1, -2)
    n = stop - start
    after = torch.ones(n, n, dtype=torch.bool, device=s.device).triu_(1)
    s[..., start:].masked_fill_(after, float("-inf"))
    return s


class BlockedAttention(torch.autograd.Function):
    """Causal softmax attention over [B, H, T, D] f32, a block of query
    rows at a time, so that no [B, H, T, T] tensor exists. The backward
    recomputes each block's probabilities from the saved row sums."""

    @staticmethod
    def forward(ctx, q, k, v):
        b, h, t, d = q.shape
        scale = 1.0 / math.sqrt(d)
        qs = q * scale
        blk = _query_block(b, h, t)
        o = torch.empty_like(q)
        lse = torch.empty((b, h, t, 1), dtype=q.dtype, device=q.device)
        for s in range(0, t, blk):
            e = min(t, s + blk)
            p = _scores(qs, k, s, e)
            m = p.amax(dim=-1, keepdim=True)
            p.sub_(m).exp_()
            total = p.sum(dim=-1, keepdim=True)
            o[:, :, s:e] = (p @ v[:, :, :e]) / total
            lse[:, :, s:e] = m + total.log()
        ctx.save_for_backward(qs, k, v, o, lse)
        ctx.blk, ctx.scale = blk, scale
        return o

    @staticmethod
    def backward(ctx, do):
        qs, k, v, o, lse = ctx.saved_tensors
        t = qs.shape[2]
        delta = (do * o).sum(dim=-1, keepdim=True)
        dq, dk, dv = (torch.zeros_like(x) for x in (qs, k, v))
        for s in range(0, t, ctx.blk):
            e = min(t, s + ctx.blk)
            p = _scores(qs, k, s, e).sub_(lse[:, :, s:e]).exp_()
            dob = do[:, :, s:e]
            dv[:, :, :e] += p.transpose(-1, -2) @ dob
            ds = (dob @ v[:, :, :e].transpose(-1, -2)).sub_(
                delta[:, :, s:e]).mul_(p)
            del p
            dq[:, :, s:e] = (ds @ k[:, :, :e]).mul_(ctx.scale)
            dk[:, :, :e] += ds.transpose(-1, -2) @ qs[:, :, s:e]
        return dq, dk, dv


# -- the model --------------------------------------------------------------

def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) \
        * scale


def _rope(x: torch.Tensor, base: float) -> torch.Tensor:
    """Rotate interleaved pairs of [B, H, T, D] at positions 0..T-1."""
    d, t = x.shape[-1], x.shape[2]
    freqs = base ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                   device=x.device) / d)
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] \
        * freqs[None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                       dim=-1).reshape(x.shape)


def _layer(x, run: dict, matmul: str, ln1, wq, wk, wv, wo, ln2, w1, w3, w2):
    b, t, e = x.shape
    h = run["n_heads"]
    d = e // h
    eps = run["norm_eps"]

    def heads(y):
        return y.reshape(b, t, h, d).transpose(1, 2)

    y = _rms(x, ln1, eps)
    q = _rope(heads(product(y, wq, matmul)), run["rope_base"])
    k = _rope(heads(product(y, wk, matmul)), run["rope_base"])
    v = heads(product(y, wv, matmul))
    o = BlockedAttention.apply(q.contiguous(), k.contiguous(), v.contiguous())
    x = x + product(o.transpose(1, 2).reshape(b, t, e), wo, matmul)
    y = _rms(x, ln2, eps)
    gate = F.silu(product(y, w1, matmul)) * product(y, w3, matmul)
    return x + product(gate, w2, matmul)


def _loss_rows(x, targets, embed, matmul: str) -> torch.Tensor:
    logits = product(x, embed.t(), matmul)
    gold = torch.gather(logits, -1, targets[:, None])[:, 0]
    return (torch.logsumexp(logits, dim=-1) - gold).sum()


def loss_sum(params: dict, tokens: torch.Tensor, run: dict,
             matmul: str = "f32") -> torch.Tensor:
    """The summed next-token cross-entropy of ``tokens`` [B, T+1] under
    the flat f32 ``params`` (``{"embed", "layers.wq", ..., "ln_f"}``,
    layers stacked on the leading axis)."""
    inputs, targets = tokens[:, :-1].long(), tokens[:, 1:].long()
    x = params["embed"][inputs]
    stacks = [params[f"layers.{k}"].unbind(0) for k in LAYER_KEYS]
    for weights in zip(*stacks):
        x = checkpoint(_layer, x, run, matmul, *weights, use_reentrant=False)
    x = _rms(x, params["ln_f"], run["norm_eps"]).reshape(-1, x.shape[-1])
    targets = targets.reshape(-1)
    total = x.new_zeros(())
    for s in range(0, x.shape[0], LOSS_ROWS):
        total = total + checkpoint(
            _loss_rows, x[s:s + LOSS_ROWS], targets[s:s + LOSS_ROWS],
            params["embed"], matmul, use_reentrant=False)
    return total


# -- training ---------------------------------------------------------------

def _adamw_(params: dict, grads: dict, state: dict, opt: dict) -> None:
    state["count"] += 1
    t = state["count"]
    b1, b2 = opt["b1"], opt["b2"]
    with torch.no_grad():
        for name, p in params.items():
            g = grads[name]
            m = state["m"].setdefault(name, torch.zeros_like(p))
            v = state["v"].setdefault(name, torch.zeros_like(p))
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            upd = (m / (1 - b1 ** t)) / ((v / (1 - b2 ** t)).sqrt_()
                                         .add_(opt["eps"]))
            upd.add_(p, alpha=opt["weight_decay"])
            p.add_(upd, alpha=-opt["lr"])


def _norms(tensors: dict) -> dict:
    return {name: float(torch.linalg.vector_norm(x))
            for name, x in tensors.items()}


def train_readings(run: dict, init_leaf, rows_of_step, steps: int,
                   opt: dict, matmul: str = "f32", group=None,
                   exchange: bool = True, row_block: int = 0) -> dict:
    """``steps`` training steps of the reference from the initial params,
    and what the benchmark compares of them: each step's loss, each
    leaf's gradient norm at the first step and each leaf's change after
    the last.

    ``init_leaf(name)`` gives a leaf's initial value (made again from the
    seed, any dtype); ``rows_of_step(i)`` the rows [n, T+1] of step ``i``
    that this process holds. The loss is the mean over the tokens of
    every process of ``group`` (None: this one alone), whose gradients
    are summed, unless ``exchange`` is False: then each process steps on
    its own rows alone. ``row_block`` rows go through the model at a time
    (0: all)."""
    exact_matmuls()
    world = 1
    if group is not None:
        from torch import distributed as dist
        world = dist.get_world_size(group)
    names = list(_leaf_names())
    params = {n: init_leaf(n).float().requires_grad_() for n in names}
    state = {"count": 0, "m": {}, "v": {}}
    out = {"loss": []}
    for i in range(steps):
        rows = rows_of_step(i)
        tokens = rows.shape[0] * (rows.shape[1] - 1)
        share = world if (group is not None and exchange) else 1
        scale = 1.0 / (tokens * share)
        total = torch.zeros((), device=rows.device)
        blk = row_block or rows.shape[0]
        for s in range(0, rows.shape[0], blk):
            part = loss_sum(params, rows[s:s + blk], run, matmul) * scale
            part.backward()
            total += part.detach()
        grads = {n: params[n].grad for n in names}
        if share > 1:
            from torch import distributed as dist
            for g in grads.values():
                dist.all_reduce(g, group=group)
            dist.all_reduce(total, group=group)
        out["loss"].append(float(total))
        if i == 0:
            out["grad"] = _norms(grads)
        _adamw_({n: params[n].data for n in names}, grads, state, opt)
        for p in params.values():
            p.grad = None
    del state
    with torch.no_grad():
        out["change"] = {n: float(torch.linalg.vector_norm(
            params[n] - init_leaf(n).float())) for n in names}
    return out


def _leaf_names():
    return ["embed", *(f"layers.{k}" for k in LAYER_KEYS), "ln_f"]
