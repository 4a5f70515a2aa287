"""Head dims wider than one tile of the fused flash kernels, on the CPU:
the wide kernels' route against the reference.

Over head dim 256 in bf16 and over 128 in f32, q, k, v launch
``csrc/flash_attn_wide.cu``: the head dim is split into 64-column
slices, S = Q K^T summed over the slices, and every output (o, dq, dk,
dv) made one 64-column block at a time, the forward's softmax online
over 64-key tiles. The kernels run only on the card
(``tests/test_torch_cuda.py``); here the Python route to them (width,
padding, scale, scratch, slicing back, the counters) runs on CPU tensors
against stand-ins for the four C entry points that compute that
split-across-tiles arithmetic on the CPU, in each dtype's parts: bf16
with P rounded once in the forward and P, dS as bf16 hi + lo in the
backward; f32 as ``perf/moe_f32_routing.py``'s kernel route (fp16 hi +
lo under a power-of-2 scale, three products).

Tolerances, each against the reference's f32 ``reference_attention``
and ``jax.grad`` of it: f32 1e-5 (22-bit operands, as
``tests/test_torch_attn_f32.py``); bf16 on bf16 inputs (the reference
given the same bf16 values in f32), o within 4e-3 (P rounded once to
bf16, 2^-9 relative, over O(1) values), the gradients within 2e-2 (the
backward takes o rounded to bf16, as every bf16 caller's o is, which
moves delta = rowsum(dO o) by 2^-9 relative) and within 1e-4 of the
plain backward from that same o (P and dS in two bf16 parts, ~2^-17
relative), lse within 1e-5. The f32
LM at head dim 256 through the wide route within 1e-4 of the
reference's f32 LM, as the f32 LM of ``tests/test_torch_attn_f32.py``.
"""
import ctypes
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.workloads import lm as jlm
from kubernetes_tpu.workloads import ring_attention as jax_ra
from kubernetes_tpu.workloads.sharding import make_mesh
from kubernetes_tpu_torch.entry import dryrun_config
from kubernetes_tpu_torch.kernels import build
from kubernetes_tpu_torch.perf import moe_f32_routing as routes
from kubernetes_tpu_torch.workloads import flash_attention as fa
from kubernetes_tpu_torch.workloads import lm as tlm

#: Head-dim columns of a tile of the wide kernels, and rows (queries or
#: keys) of a tile.
SLICE = 64
ROWS = 64
#: bf16 head dims over one tile: 264 (the narrowest, 8 past 256), 272
#: (the graft entry's dryrun at 17 devices), 512.
BF16_WIDE = (264, 272, 512)
#: f32 head dims over one tile: 136 (8 past 128) and 256 (GPT-J-6B).
F32_WIDE = (136, 256)
ROUTE = routes.ROUTES[routes.KERNEL_ROUTE]
#: The LM at head dim 256, narrow and shallow.
LM256 = dict(vocab=128, d_model=512, n_layers=2, n_heads=2, d_ff=512)


def _at(ptr: int, shape, dtype) -> torch.Tensor:
    """The tensor of ``shape`` and ``dtype`` at address ``ptr``, sharing
    its memory: what a launch reads and writes."""
    n = math.prod(shape)
    size = torch.tensor([], dtype=dtype).element_size()
    raw = (ctypes.c_uint8 * (n * size)).from_address(ptr)
    return torch.frombuffer(raw, dtype=dtype).view(shape)


class _Arith:
    """One dtype's parts and products: ``parts(x)`` of an operand,
    ``a_parts(x, n, dims)`` of P or dS in ``n`` parts, ``product`` of two
    lists of parts over the pairs the kernels take."""

    def __init__(self, f32: bool):
        self.f32 = f32

    def parts(self, x):
        return routes.parts_of(x, ROUTE) if self.f32 else [x.float()]

    def a_parts(self, x, n, dims=(-1,)):
        """P (dims None: the fixed scale) or dS (a scale per row of the
        product, over ``dims``) as the A operand of a product."""
        if self.f32:
            fixed = routes.P_SCALE if dims is None else None
            return routes.parts_of(x, ROUTE, dims or (-1,), fixed)
        hi = x.to(torch.bfloat16).float()
        return [hi] if n == 1 else [hi, (x - hi).to(torch.bfloat16).float()]

    def product(self, eq, a, b):
        if self.f32:
            return routes.product(eq, a, b, ROUTE)
        return sum(torch.einsum(eq, a[i], b[j])
                   for i in range(len(a)) for j in range(len(b)))


def _tiles(t):
    return range(0, t, ROWS)


def _slice_scores(ar, qp, kp, m0, n0, d):
    """S of query tile m0 and key tile n0, summed over 64-column slices."""
    return sum(ar.product("bhqd,bhkd->bhqk",
                          [x[:, :, m0:m0 + ROWS, c:c + SLICE] for x in qp],
                          [x[:, :, n0:n0 + ROWS, c:c + SLICE] for x in kp])
               for c in range(0, d, SLICE))


def _mask(s, m0, n0, t, causal):
    q = torch.arange(m0, m0 + s.shape[-2])[:, None]
    k = torch.arange(n0, n0 + s.shape[-1])[None, :]
    return s.masked_fill(k > q if causal else k >= t, -math.inf)


def wide_forward(q, k, v, causal, scale, f32):
    """o (f32) and lse as the wide forward computes them: per query tile
    and 64-column block of o, the key tiles from the last taken to the
    first, S summed over slices, the softmax online, P in the dtype's
    parts."""
    ar = _Arith(f32)
    b, h, t, d = q.shape
    qp, kp, vp = (ar.parts(x) for x in (q, k, v))
    o = torch.zeros((b, h, t, d))
    lse = torch.zeros((b, h, t))
    for m0 in _tiles(t):
        keys = [n0 for n0 in _tiles(t) if not causal or n0 <= m0][::-1]
        rows = min(ROWS, t - m0)
        for c0 in range(0, d, SLICE):
            acc = torch.zeros((b, h, rows, min(SLICE, d - c0)))
            m = torch.full((b, h, rows, 1), -math.inf)
            l = torch.zeros((b, h, rows, 1))
            for n0 in keys:
                s = _mask(_slice_scores(ar, qp, kp, m0, n0, d) * scale, m0,
                          n0, t, causal)
                new = torch.maximum(m, s.amax(-1, keepdim=True))
                corr = torch.exp(m - new)
                p = torch.exp(s - new)
                l = l * corr + p.sum(-1, keepdim=True)
                acc = acc * corr + ar.product(
                    "bhqk,bhkd->bhqd", ar.a_parts(p, 2 if f32 else 1, None),
                    [x[:, :, n0:n0 + ROWS, c0:c0 + SLICE] for x in vp])
                m = new
            o[:, :, m0:m0 + rows, c0:c0 + SLICE] = acc / l
            lse[:, :, m0:m0 + rows] = (m + torch.log(l))[..., 0]
    return o, lse


def wide_backward(q, k, v, o, do, lse, causal, scale, f32):
    """dq, dk, dv (f32) as the wide backward computes them: per 64-row
    tile and 64-column block of the output, S and dP summed over slices
    for every tile pair, P and dS in the dtype's parts (dS under a scale
    per row of the product it feeds)."""
    ar = _Arith(f32)
    b, h, t, d = q.shape
    qp, kp, vp, dop = (ar.parts(x) for x in (q, k, v, do))
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    dq, dk, dv = (torch.zeros((b, h, t, d)) for _ in range(3))
    for m0 in _tiles(t):
        for n0 in _tiles(t):
            if causal and n0 > m0:
                continue
            p = torch.exp(_mask(_slice_scores(ar, qp, kp, m0, n0, d) * scale,
                                m0, n0, t, causal)
                          - lse[:, :, m0:m0 + ROWS, None])
            ds = p * (_slice_scores(ar, dop, vp, m0, n0, d)
                      - delta[:, :, m0:m0 + ROWS])
            pp = ar.a_parts(p, 2, None)
            for c0 in range(0, d, SLICE):
                cols = slice(c0, c0 + SLICE)
                dv[:, :, n0:n0 + ROWS, cols] += ar.product(
                    "bhqk,bhqd->bhkd", pp,
                    [x[:, :, m0:m0 + ROWS, cols] for x in dop])
                dk[:, :, n0:n0 + ROWS, cols] += ar.product(
                    "bhqk,bhqd->bhkd", ar.a_parts(ds, 2, (-2,)),
                    [x[:, :, m0:m0 + ROWS, cols] for x in qp]) * scale
                dq[:, :, m0:m0 + ROWS, cols] += ar.product(
                    "bhqk,bhkd->bhqd", ar.a_parts(ds, 2, (-1,)),
                    [x[:, :, n0:n0 + ROWS, cols] for x in kp]) * scale
    return dq, dk, dv


class _WideLaunches:
    """Stand-ins for the wide kernels' four C entry points, computing on
    the CPU, from the pointers and sizes a wrapper passes, what the
    kernels compute (:func:`wide_forward`, :func:`wide_backward`); the
    f32 ones also fill the pre-pass's scratch. Each call's name, width,
    scale and q pointer are kept."""

    def __init__(self):
        self.calls = []

    @staticmethod
    def _split(ptrs, partsp, amaxp, shape):
        n = len(ptrs)
        scratch = _at(partsp, (n, 2) + shape, torch.float16)
        amax = _at(amaxp, (n, shape[0] * shape[1]), torch.int32)
        out = []
        for i, p in enumerate(ptrs):
            x = _at(p, shape, torch.float32)
            scratch[i, 0], scratch[i, 1] = routes.fp16_parts(x)
            amax[i] = routes.slice_amax_bits(x)
            out.append(x)
        return out

    def fwd(self, qp, kp, vp, op, lsep, b, h, t, w, causal, f32_out,
            scale_log2, device, stream):
        self.calls.append(("fwd_wide", w, scale_log2, qp))
        shape = (b, h, t, w)
        q, k, v = (_at(p, shape, torch.bfloat16) for p in (qp, kp, vp))
        o, lse = wide_forward(q, k, v, causal,
                              scale_log2 / math.log2(math.e), False)
        _at(op, shape, torch.float32 if f32_out else torch.bfloat16)[:] = o
        _at(lsep, (b, h, t), torch.float32)[:] = lse
        return 0

    def bwd(self, qp, kp, vp, op, dop, lsep, deltap, dqp, dkp, dvp, b, h, t,
            w, causal, f32_out, scale, device, stream):
        self.calls.append(("bwd_wide", w, scale, qp))
        shape = (b, h, t, w)
        q, k, v, o, do = (_at(p, shape, torch.bfloat16)
                          for p in (qp, kp, vp, op, dop))
        grads = wide_backward(q, k, v, o, do, _at(lsep, (b, h, t),
                                                  torch.float32),
                              causal, scale, False)
        out = torch.float32 if f32_out else torch.bfloat16
        for ptr, g in zip((dqp, dkp, dvp), grads):
            _at(ptr, shape, out)[:] = g
        return 0

    def fwd32(self, qp, kp, vp, op, lsep, partsp, amaxp, b, h, t, w, causal,
              scale_log2, device, stream):
        self.calls.append(("fwd_wide32", w, scale_log2, qp))
        shape = (b, h, t, w)
        q, k, v = self._split((qp, kp, vp), partsp, amaxp, shape)
        o, lse = wide_forward(q, k, v, causal,
                              scale_log2 / math.log2(math.e), True)
        _at(op, shape, torch.float32)[:] = o
        _at(lsep, (b, h, t), torch.float32)[:] = lse
        return 0

    def bwd32(self, qp, kp, vp, op, dop, lsep, deltap, partsp, amaxp, dqp,
              dkp, dvp, b, h, t, w, causal, scale, device, stream):
        self.calls.append(("bwd_wide32", w, scale, qp))
        shape = (b, h, t, w)
        q, k, v, do = self._split((qp, kp, vp, dop), partsp, amaxp, shape)
        grads = wide_backward(q, k, v, _at(op, shape, torch.float32), do,
                              _at(lsep, (b, h, t), torch.float32), causal,
                              scale, True)
        for ptr, g in zip((dqp, dkp, dvp), grads):
            _at(ptr, shape, torch.float32)[:] = g
        return 0


def _refuse(*args):
    raise AssertionError("a one-tile entry point took a wide head dim")


@pytest.fixture
def wide(monkeypatch):
    """The wrappers' kernel route (``_kernel_fwd``, ``_kernel_bwd``) on
    CPU tensors, the wide entry points :class:`_WideLaunches` and the
    fused ones refusing any call."""
    launches = _WideLaunches()
    monkeypatch.setattr(build, "current_stream", lambda device: 0)
    for kernel, fn in ((fa._FWDW, launches.fwd), (fa._BWDW, launches.bwd),
                       (fa._FWDW32, launches.fwd32),
                       (fa._BWDW32, launches.bwd32),
                       (fa._FWD, _refuse), (fa._BWD, _refuse),
                       (fa._FWD32, _refuse), (fa._BWD32, _refuse)):
        monkeypatch.setattr(kernel, "launch", fn)
    return launches


def _inputs(shape, n=4, seed=0):
    rng = np.random.default_rng(seed + sum(shape))
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _jax_reference(q, k, v, do, causal):
    """o and (dq, dk, dv) of the reference's f32 attention (its
    ``reference_attention`` causal, the same softmax unmasked otherwise)
    and ``jax.grad`` of it contracted with dO; lse in float64."""
    def attend(q, k, v):
        if causal:
            return jax_ra.reference_attention(q, k, v)
        s = jnp.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(q.shape[-1])
        return jnp.einsum("bhqk,bhkd->bhqd", jax.nn.softmax(s, axis=-1), v)
    o = attend(*map(jnp.asarray, (q, k, v)))
    grads = jax.grad(lambda *x: jnp.sum(attend(*x) * do), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64),
                  k.astype(np.float64)) / math.sqrt(q.shape[-1])
    if causal:
        t = q.shape[2]
        s = np.where(np.tril(np.ones((t, t), bool)), s, -np.inf)
    mx = s.max(-1, keepdims=True)
    lse = (mx + np.log(np.exp(s - mx).sum(-1, keepdims=True)))[..., 0]
    return np.asarray(o), lse, [np.asarray(g) for g in grads]


def _check(wide, dtype, d, causal, out_dtype, tol):
    shape = (1, 2, 70, d)
    x = _inputs(shape, seed=d)
    if dtype is torch.bfloat16:
        # The reference sees the same bf16 values, in f32.
        x = [torch.from_numpy(a).to(dtype).float().numpy() for a in x]
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in x)
    before = fa.counts()
    o, lse = fa._kernel_fwd(q, k, v, causal, out_dtype)
    grads = fa._kernel_bwd(q, k, v, o.to(dtype), lse, do, causal, out_dtype)
    f32 = "_f32" if dtype is torch.float32 else ""
    suffix = f32 + ("" if causal else "_non_causal")
    assert {n: c - before[n] for n, c in fa.counts().items()} == {
        **dict.fromkeys(before, 0), f"flash_attn_fwd_wide{suffix}": 1,
        f"flash_attn_bwd_wide{suffix}": 1}
    w = -(-d // 8) * 8
    assert [c[1:3] for c in wide.calls] == [
        (w, pytest.approx(math.log2(math.e) / math.sqrt(d))),
        (w, pytest.approx(1 / math.sqrt(d)))]
    for t in (o, *grads):
        assert t.shape == shape and t.dtype == out_dtype
        assert t.is_contiguous()
    want_o, want_lse, want_grads = _jax_reference(*x, causal)
    np.testing.assert_allclose(o.float().numpy(), want_o, atol=tol["o"],
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=1e-5, rtol=0)
    for name, g, want in zip(("dq", "dk", "dv"), grads, want_grads):
        np.testing.assert_allclose(g.float().numpy(), want, atol=tol["jax"],
                                   rtol=0, err_msg=name)
    # The same backward's plain version, from the o in the dtype it took.
    plain = fa.flash_attention_bwd_plain(q, k, v, o.to(dtype), lse, do,
                                         causal, torch.float32)
    for name, g, want in zip(("dq", "dk", "dv"), grads, plain):
        torch.testing.assert_close(g.float(), want, atol=tol["g"], rtol=0,
                                   msg=name)


@pytest.mark.parametrize("d", BF16_WIDE)
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_wide_route_matches_the_reference(wide, d, causal):
    """bf16 over head dim 256 takes the wide bf16 entry points at the
    width itself, the scale of the true D, once each, counted on the wide
    instances; against the reference on the same bf16 values, o (f32
    out) within 4e-3 and the gradients within 2e-2 (the backward takes o
    rounded to bf16, which moves delta); the gradients within 1e-4 of
    the plain backward from that same o."""
    _check(wide, torch.bfloat16, d, causal, torch.float32,
           {"o": 4e-3, "jax": 2e-2, "g": 1e-4})
    assert {c[0] for c in wide.calls} == {"fwd_wide", "bwd_wide"}


@pytest.mark.parametrize("d", F32_WIDE)
@pytest.mark.parametrize("causal", [True, False])
def test_f32_wide_route_matches_the_reference(wide, d, causal):
    """f32 over head dim 128 takes the wide f32 entry points (their
    pre-pass scratch allocated by the wrapper), counted on the wide f32
    instances; o, lse and the gradients within 1e-5 of the reference's
    f32 attention and ``jax.grad`` of it."""
    _check(wide, torch.float32, d, causal, torch.float32,
           {"o": 1e-5, "jax": 1e-5, "g": 1e-5})
    assert {c[0] for c in wide.calls} == {"fwd_wide32", "bwd_wide32"}


@pytest.mark.parametrize("d", [260, 300])
def test_wide_route_pads_a_head_dim_off_the_multiple_of_8(wide, d):
    """A wide head dim that is no multiple of 8 launches on a zero-padded
    copy at the next multiple, the scale of the true D, and comes back
    [B, H, T, D], equal to the plain version within the bf16 bounds
    above."""
    shape = (1, 2, 33, d)
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _inputs(shape, seed=3))
    o, lse = fa._kernel_fwd(q, k, v, True, torch.float32)
    grads = fa._kernel_bwd(q, k, v, o.to(q.dtype), lse, do, True,
                           torch.float32)
    w = -(-d // 8) * 8
    assert [c[:2] for c in wide.calls] == [("fwd_wide", w), ("bwd_wide", w)]
    assert wide.calls[0][3] != q.data_ptr()
    want_o, want_lse = fa.flash_attention_fwd(q.float(), k.float(),
                                              v.float())
    want = fa.flash_attention_bwd(q.float(), k.float(), v.float(),
                                  o.to(q.dtype).float(), lse, do.float())
    assert o.shape == shape
    torch.testing.assert_close(o, want_o, atol=4e-3, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=0)
    for g, wg in zip(grads, want):
        assert g.shape == shape and g.is_contiguous()
        torch.testing.assert_close(g, wg, atol=1e-4, rtol=0)


@pytest.mark.parametrize("d,dtype,wide_kernel", [
    (256, torch.bfloat16, False), (257, torch.bfloat16, True),
    (272, torch.bfloat16, True), (1024, torch.bfloat16, True),
    (128, torch.float32, False), (129, torch.float32, True),
    (256, torch.float32, True)])
def test_which_kernels_a_head_dim_takes(d, dtype, wide_kernel):
    """Every head dim from 1 launches a kernel in bf16 and f32: the fused
    ones up to one tile (256, 128), the wide ones over it."""
    assert fa.takes_head_dim(d, dtype)
    assert fa.one_tile(d, dtype) is not wide_kernel


def test_dryrun_at_17_devices_has_a_head_dim_the_kernels_take():
    """The graft entry's dense dryrun config at 17 devices (dp = 17, 2
    heads of a 544-wide model): head dim 272, the wide kernels'."""
    run = dryrun_config(17)
    assert run.cfg.head_dim == 272
    assert fa.takes_head_dim(run.cfg.head_dim)
    assert not fa.one_tile(run.cfg.head_dim)


def test_wide_counts_stay_apart_from_the_fused_ones(wide):
    """A wide launch counts on its wide instance alone: the fused
    kernels' counts do not move, and ``zero_counts`` clears both."""
    fa.zero_counts()
    q = torch.zeros((1, 1, 8, 264), dtype=torch.bfloat16)
    o, lse = fa._kernel_fwd(q, q, q, False, torch.bfloat16)
    fa._kernel_bwd(q, q, q, o, lse, q, False, torch.bfloat16)
    x = torch.zeros((1, 1, 8, 136))
    fa._kernel_fwd(x, x, x, True, torch.float32)
    got = {n: c for n, c in fa.counts().items() if c}
    assert got == {"flash_attn_fwd_wide_non_causal": 1,
                   "flash_attn_bwd_wide_non_causal": 1,
                   "flash_attn_fwd_wide_f32": 1}
    fa.zero_counts()
    assert set(fa.counts().values()) == {0}


# -- The f32 LM at head dim 256 through the wide route. --

def _route_fwd(q, k, v, causal=True, out_dtype=None):
    out_dtype = fa._out_dtype(q, out_dtype)
    fa._check_kernel_inputs("flash attention", q=q, k=k, v=v)
    return fa._kernel_fwd(q, k, v, causal, out_dtype)


def _route_bwd(q, k, v, o, lse, do, causal=True, out_dtype=None):
    out_dtype = fa._out_dtype(q, out_dtype)
    fa._check_kernel_inputs("flash attention backward", q=q, k=k, v=v, o=o,
                            do=do)
    return fa._kernel_bwd(q, k, v, o, lse, do, causal, out_dtype)


@pytest.fixture
def wide_lm(wide, monkeypatch):
    """The LM's attention through the kernel route on CPU tensors: the
    wrappers take their CUDA path (checks, the wide f32 entry points'
    stand-ins) in place of the plain versions."""
    monkeypatch.setattr(fa, "flash_attention_fwd", _route_fwd)
    monkeypatch.setattr(fa, "flash_attention_bwd", _route_bwd)
    return wide


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(jax.devices()[:1])


@pytest.mark.parametrize("attn", ["ring", "flash"])
def test_f32_lm_at_head_dim_256_through_the_wide_route_matches_jax(
        wide_lm, mesh, attn):
    """The port's LM at head dim 256 (GPT-J-6B's; 2 layers, d_model 512,
    2 heads) in f32 params and compute, its attention ``attn`` through
    the wide f32 route, against the reference's f32 LM (``"local"``) on
    the same params and tokens: logits, loss and every gradient within
    1e-4; the forward launches the wide f32 instance once a layer, the
    step twice (remat) and its backward once, and nothing else."""
    jcfg = jlm.LMConfig(**LM256, compute_dtype=jnp.float32,
                        attn_impl="local")
    tcfg = tlm.LMConfig(**LM256, compute_dtype=torch.float32,
                        param_dtype=torch.float32, attn_impl=attn)
    assert tcfg.head_dim == 256
    jp = jlm.init_params(jax.random.PRNGKey(5), jcfg)
    tp = tlm.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                             device="cpu")
    batch = np.random.default_rng(5).integers(0, LM256["vocab"], (2, 34)
                                              ).astype(np.int32)
    layers = tcfg.n_layers
    fa.zero_counts()
    got = tlm.make_forward(tcfg, "cpu")(tp, torch.from_numpy(batch[:, :-1]))
    assert fa.counts() == {**dict.fromkeys(fa.counts(), 0),
                           "flash_attn_fwd_wide_f32": layers}
    want = np.asarray(jlm.make_forward(jcfg, mesh)(jp, jnp.asarray(
        batch[:, :-1])))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    fa.zero_counts()
    loss, grads = tlm.loss_and_grads(tp, torch.from_numpy(batch), tcfg)
    assert fa.counts() == {**dict.fromkeys(fa.counts(), 0),
                           "flash_attn_fwd_wide_f32": 2 * layers,
                           "flash_attn_bwd_wide_f32": layers}
    want_loss, want_grads = jax.value_and_grad(jlm.loss_fn)(
        jp, jnp.asarray(batch), jcfg, mesh)
    assert abs(float(loss) - float(want_loss)) < 1e-4
    for path, w in jax.tree_util.tree_flatten_with_path(want_grads)[0]:
        node = grads
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(node.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=0, err_msg=str(path))
    assert {c[0] for c in wide_lm.calls} == {"fwd_wide32", "bwd_wide32"}
