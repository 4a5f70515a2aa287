"""The flash kernels' f32 instances on the CPU: the wrapper's f32 route
against the reference, its refusals, and the f32 LM through it.

On the card, f32 q, k, v (and o, dO) launch ``flash_attn_fwd_f32`` and
``flash_attn_bwd_f32``: a pre-pass splits each f32 operand into two fp16
parts under a power-of-2 scale per [batch, head] slice (hi, the rounding
of x s; lo, the rounding of the rest), and every product that takes Q,
K, V or dO is three fp16 products summed in f32, hi.hi + hi.lo + lo.hi;
P enters split under a fixed scale, dS under a scale per row of the
product it feeds (``perf/moe_f32_routing.py``'s route ``fp16x2``, whose
:func:`route_forward` and :func:`route_backward` write that arithmetic
out). The kernels run only on the card (``tests/test_torch_cuda.py``);
here the Python route to them (dtype dispatch, the parts scratch,
padding, scale, slicing, the counters) runs on CPU tensors against a
stand-in for the C entry points that computes that same arithmetic on
the CPU.

Tolerances: the f32 route within 1e-5 of the reference's f32
``reference_attention`` and of ``jax.grad`` of it (the parts keep ~22
significant bits of each operand; the former bf16 parts, ~16, were held
to 1e-4); its largest deviation from a float64 version at most
``gates.F32_RULE`` (1/256) of the bf16 route's (bf16 inputs, P rounded
once in the forward, f32 outputs) at T >= 512, the rule the card holds
the kernels to; the f32 LM through the route within 1e-4 of the
reference's f32 LM on logits, loss and gradients.
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
from kubernetes_tpu_torch.kernels import build
from kubernetes_tpu_torch.perf import gates, moe_f32_routing
from kubernetes_tpu_torch.workloads import flash_attention as fa
from kubernetes_tpu_torch.workloads import lm as tlm
from kubernetes_tpu_torch.workloads import moe as tmoe

#: Head dims of the f32 instances' tiles and between them (20 and 100
#: are no multiple of 8: the padded copy), up to the widest, 128.
F32_HEAD_DIMS = (16, 20, 24, 48, 96, 100, 128)
#: The LM at head dim 64, narrow and shallow.
LM64 = dict(vocab=128, d_model=128, n_layers=2, n_heads=2, d_ff=256)


def _at(ptr: int, shape, dtype) -> torch.Tensor:
    """The tensor of ``shape`` and ``dtype`` at address ``ptr``, sharing
    its memory: what a launch reads and writes."""
    n = math.prod(shape)
    size = torch.tensor([], dtype=dtype).element_size()
    raw = (ctypes.c_uint8 * (n * size)).from_address(ptr)
    return torch.frombuffer(raw, dtype=dtype).view(shape)


def _parts(x: torch.Tensor, n: int) -> list:
    """``x`` as ``n`` bf16 parts: [its rounding], or [hi, lo], lo the
    rounding of what hi left out."""
    hi = x.to(torch.bfloat16)
    return [hi] if n == 1 else [hi, (x.float() - hi.float()).to(
        torch.bfloat16)]


def _prod(eq: str, a: list, b: list) -> torch.Tensor:
    """The product of two operands given in parts, as the kernels take
    it: every pair of parts but lo.lo, summed in f32."""
    return sum(torch.einsum(eq, x.float(), y.float())
               for i, x in enumerate(a) for j, y in enumerate(b) if i + j < 2)


def _scores(qp, kp, scale, causal):
    s = _prod("bhqd,bhkd->bhqk", qp, kp) * scale
    if causal:
        t = s.shape[-1]
        s = s.masked_fill(~torch.ones(t, t, dtype=torch.bool).tril(),
                          -math.inf)
    return s


def _forward(qp, kp, vp, p_parts, scale, causal):
    """o and lse from operands in parts; P in ``p_parts`` parts."""
    s = _scores(qp, kp, scale, causal)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    return _prod("bhqk,bhkd->bhqd", _parts(p, p_parts), vp), lse


def _backward(qp, kp, vp, o, dop, do, lse, scale, causal):
    """dq, dk, dv from operands in parts, P and dS split in two."""
    p = torch.exp(_scores(qp, kp, scale, causal) - lse[..., None])
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    ds = p * (_prod("bhqd,bhkd->bhqk", dop, vp) - delta)
    pp, dsp = _parts(p, 2), _parts(ds, 2)
    return (_prod("bhqk,bhkd->bhqd", dsp, kp) * scale,
            _prod("bhkq,bhqd->bhkd", [x.transpose(-1, -2) for x in dsp],
                  qp) * scale,
            _prod("bhkq,bhqd->bhkd", [x.transpose(-1, -2) for x in pp], dop))


#: The f32 instances' arithmetic.
ROUTE = moe_f32_routing.ROUTES[moe_f32_routing.KERNEL_ROUTE]


class _Route:
    """Stand-ins for the four C entry points, computing on the CPU, from
    the pointers and sizes a wrapper passes, what the kernels compute:
    the bf16 instances (P rounded once in the forward) and the f32 ones
    (the pre-pass writing each operand's fp16 parts and its slices'
    largest |x| into the scratch, then the route's arithmetic). Each
    call's name, width, scale and q pointer are kept."""

    def __init__(self):
        self.calls = []

    def fwd(self, qp, kp, vp, op, lsep, b, h, t, w, causal, f32_out,
            scale_log2, device, stream):
        self.calls.append(("fwd", w, scale_log2, qp))
        shape = (b, h, t, w)
        q, k, v = (_parts(_at(p, shape, torch.bfloat16), 1)
                   for p in (qp, kp, vp))
        o, lse = _forward(q, k, v, 1, scale_log2 / math.log2(math.e),
                          causal)
        _at(op, shape, torch.float32 if f32_out else torch.bfloat16)[:] = o
        _at(lsep, (b, h, t), torch.float32)[:] = lse
        return 0

    def bwd(self, qp, kp, vp, op, dop, lsep, deltap, dqp, dkp, dvp, b, h, t,
            w, causal, f32_out, scale, device, stream):
        self.calls.append(("bwd", w, scale, qp))
        shape = (b, h, t, w)
        q, k, v, do = (_parts(_at(p, shape, torch.bfloat16), 1)
                       for p in (qp, kp, vp, dop))
        o = _at(op, shape, torch.bfloat16)
        grads = _backward(q, k, v, o, do, do[0], _at(lsep, (b, h, t),
                                                     torch.float32),
                          scale, causal)
        out = torch.float32 if f32_out else torch.bfloat16
        for ptr, g in zip((dqp, dkp, dvp), grads):
            _at(ptr, shape, out)[:] = g
        return 0

    def _split(self, ptrs, partsp, amaxp, shape):
        """The pre-pass: each f32 operand's fp16 [hi, lo] (times its
        slices' scales) into the scratch, its slices' largest |x| into
        amax; the operands themselves, which the route splits the same
        way."""
        n = len(ptrs)
        scratch = _at(partsp, (n, 2) + shape, torch.float16)
        amax = _at(amaxp, (n, shape[0] * shape[1]), torch.int32)
        out = []
        for i, p in enumerate(ptrs):
            x = _at(p, shape, torch.float32)
            scratch[i, 0], scratch[i, 1] = moe_f32_routing.fp16_parts(x)
            amax[i] = moe_f32_routing.slice_amax_bits(x)
            out.append(x)
        return out

    def fwd32(self, qp, kp, vp, op, lsep, partsp, amaxp, b, h, t, w, causal,
              scale_log2, device, stream):
        self.calls.append(("fwd32", w, scale_log2, qp))
        shape = (b, h, t, w)
        q, k, v = self._split((qp, kp, vp), partsp, amaxp, shape)
        o, lse = moe_f32_routing.route_forward(
            q, k, v, causal, ROUTE, scale_log2 / math.log2(math.e))
        _at(op, shape, torch.float32)[:] = o
        _at(lsep, (b, h, t), torch.float32)[:] = lse
        return 0

    def bwd32(self, qp, kp, vp, op, dop, lsep, deltap, partsp, amaxp, dqp,
              dkp, dvp, b, h, t, w, causal, scale, device, stream):
        self.calls.append(("bwd32", w, scale, qp))
        shape = (b, h, t, w)
        q, k, v, do = self._split((qp, kp, vp, dop), partsp, amaxp, shape)
        grads = moe_f32_routing.route_backward(
            q, k, v, _at(op, shape, torch.float32), do,
            _at(lsep, (b, h, t), torch.float32), causal, ROUTE, scale)
        for ptr, g in zip((dqp, dkp, dvp), grads):
            _at(ptr, shape, torch.float32)[:] = g
        return 0


@pytest.fixture
def route(monkeypatch):
    """The wrappers' kernel route (``_kernel_fwd``, ``_kernel_bwd``) on
    CPU tensors, the four entry points :class:`_Route`."""
    launches = _Route()
    monkeypatch.setattr(build, "current_stream", lambda device: 0)
    for kernel, fn in ((fa._FWD, launches.fwd), (fa._BWD, launches.bwd),
                       (fa._FWD32, launches.fwd32),
                       (fa._BWD32, launches.bwd32)):
        monkeypatch.setattr(kernel, "launch", fn)
    return launches


def _inputs(shape, n=4, seed=0):
    rng = np.random.default_rng(seed + sum(shape))
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _jax_reference(q, k, v, do, causal):
    """o and (dq, dk, dv) of the reference's f32 attention: its
    ``reference_attention`` (causal) or the same softmax unmasked, and
    ``jax.grad`` of it contracted with dO."""
    def attend(q, k, v):
        if causal:
            return jax_ra.reference_attention(q, k, v)
        s = jnp.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(q.shape[-1])
        return jnp.einsum("bhqk,bhkd->bhqd", jax.nn.softmax(s, axis=-1), v)
    o = attend(*map(jnp.asarray, (q, k, v)))
    grads = jax.grad(lambda *x: jnp.sum(attend(*x) * do), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    return np.asarray(o), [np.asarray(g) for g in grads]


def _lse64(q, k, causal):
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64),
                  k.astype(np.float64)) / math.sqrt(q.shape[-1])
    if causal:
        t = q.shape[2]
        s = np.where(np.tril(np.ones((t, t), bool)), s, -np.inf)
    m = s.max(-1, keepdims=True)
    return (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]


@pytest.mark.parametrize("d", F32_HEAD_DIMS)
@pytest.mark.parametrize("causal", [True, False])
def test_f32_route_matches_the_reference(route, d, causal):
    """f32 inputs take the f32 entry points at the head dim padded to a
    multiple of 8 (the tensors themselves where D is one), the scale of
    the true D, and come back [B, H, T, D] in f32; each call counts one
    launch of its f32 instance; o, LSE and the gradients within 1e-4 of
    the reference's f32 attention and ``jax.grad`` of it: 1e-5 for
    ~22-bit operands (the former 16-bit ones were held to 1e-4)."""
    shape = (2, 3, 33, d)
    q, k, v, do = _inputs(shape, seed=3)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    before = fa.counts()
    o, lse = fa._kernel_fwd(tq, tk, tv, causal, torch.float32)
    grads = fa._kernel_bwd(tq, tk, tv, o, lse, tdo, causal, torch.float32)
    suffix = "" if causal else "_non_causal"
    assert {n: c - before[n] for n, c in fa.counts().items()} == {
        **dict.fromkeys(before, 0), f"flash_attn_fwd_f32{suffix}": 1,
        f"flash_attn_bwd_f32{suffix}": 1}
    w = -(-d // 8) * 8
    assert [c[:3] for c in route.calls] == [
        ("fwd32", w, pytest.approx(math.log2(math.e) / math.sqrt(d))),
        ("bwd32", w, pytest.approx(1 / math.sqrt(d)))]
    assert (route.calls[0][3] == tq.data_ptr()) is (w == d)
    for x in (o, *grads):
        assert x.shape == shape and x.dtype == torch.float32
        assert x.is_contiguous()
    want_o, want_grads = _jax_reference(q, k, v, do, causal)
    np.testing.assert_allclose(o.numpy(), want_o, atol=1e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), _lse64(q, k, causal), atol=1e-5,
                               rtol=0)
    for name, g, want in zip(("dq", "dk", "dv"), grads, want_grads):
        np.testing.assert_allclose(g.numpy(), want, atol=1e-5, rtol=0,
                                   err_msg=name)


def _f64(q, k, v, do, causal):
    """o, lse, dq, dk, dv in float64."""
    q, k, v, do = (torch.from_numpy(x).double() for x in (q, k, v, do))
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(q.shape[-1])
    if causal:
        t = q.shape[2]
        s = s.masked_fill(~torch.ones(t, t, dtype=torch.bool).tril(),
                          -math.inf)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = p @ v
    ds = p * (do @ v.transpose(-1, -2) - (do * o).sum(-1, keepdim=True))
    scale = 1 / math.sqrt(q.shape[-1])
    return {"o": o, "lse": lse, "dq": ds @ k * scale,
            "dk": ds.transpose(-1, -2) @ q * scale,
            "dv": p.transpose(-1, -2) @ do}


def _route_outputs(q, k, v, do, causal):
    o, lse = fa._kernel_fwd(q, k, v, causal, torch.float32)
    grads = fa._kernel_bwd(q, k, v, o.to(q.dtype), lse, do, causal,
                           torch.float32)
    return {"o": o, "lse": lse, **dict(zip(("dq", "dk", "dv"), grads))}


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_f32_route_within_a_sixteenth_of_the_bf16_route(route, d, causal):
    """At T 512, each output of the f32 route deviates from float64 by at
    most ``gates.F32_RULE`` (1/256; 1/16 for the former 16-bit route) of
    the bf16 route's deviation on the bf16 rounding of the same inputs
    (both with f32 outputs)."""
    x = _inputs((1, 2, 512, d), seed=5)
    exact = _f64(*x, causal)
    t32 = [torch.from_numpy(a) for a in x]
    got = _route_outputs(*t32, causal)
    bf16 = _route_outputs(*(a.to(torch.bfloat16) for a in t32), causal)
    for name, want in exact.items():
        dev = float((got[name].double() - want).abs().max())
        ref = float((bf16[name].double() - want).abs().max())
        assert dev <= gates.F32_RULE * ref, (name, dev, ref)


def test_kernel_checks_take_f32_to_128_and_refuse_the_rest():
    """The checks a CUDA tensor passes before a launch: f32 at head dims
    1 to 128 (one tile) and over it (136, 264: the wide kernels), as
    bf16; head dim 0 ``ValueError``; f16, f64 and two dtypes
    ``TypeError``, the backward's dO too. Before the wide kernels, f32 at
    136 raised ``ValueError``."""
    for d in (8, 25, 128, 136, 264):
        x = torch.zeros((1, 1, 8, d))
        fa._check_kernel_inputs("flash attention", q=x, k=x, v=x)
        fa._check_kernel_inputs("flash attention", q=x.bfloat16(),
                                k=x.bfloat16(), v=x.bfloat16())
    empty = torch.zeros((1, 1, 8, 0))
    with pytest.raises(ValueError, match="head dims from 1, not 0"):
        fa._check_kernel_inputs("flash attention", q=empty, k=empty,
                                v=empty)
    x = torch.zeros((1, 1, 8, 32))
    for args in ((x.half(),) * 3, (x.double(),) * 3,
                 (x, x.bfloat16(), x.bfloat16()), (x.bfloat16(), x, x)):
        with pytest.raises(TypeError, match="bfloat16 or float32"):
            fa._check_kernel_inputs("flash attention",
                                    **dict(zip("qkv", args)))
    with pytest.raises(TypeError):
        fa._check_kernel_inputs("flash attention backward", q=x, k=x, v=x,
                                o=x, do=x.double())


@pytest.mark.parametrize("d,dtype,ok", [
    (1, torch.float32, True), (128, torch.float32, True),
    (129, torch.float32, False), (136, torch.float32, False),
    (136, torch.bfloat16, True), (256, torch.bfloat16, True),
    (32, torch.float16, False), (32, torch.float64, False)])
def test_the_head_dim_rule_by_dtype(d, dtype, ok):
    """``ok``: the head dim runs on one tile of the fused kernels. Every
    head dim from 1 in bf16 or f32 launches a kernel (over one tile, the
    wide ones); none in f16 or f64."""
    assert fa.one_tile(d, dtype) is ok
    assert fa.takes_head_dim(d, dtype) is (dtype in (torch.bfloat16,
                                                     torch.float32))


def test_counts_name_every_instance_and_zero():
    """``counts()`` keeps the bf16 and f32 instances apart, causal and
    non-causal, forward and backward, of the fused kernels and of the
    wide ones, one name each; ``zero_counts()`` sets each to 0."""
    names = {f"flash_attn_{d}{w}{s}" for d in ("fwd", "bwd")
             for w in ("", "_wide")
             for s in ("", "_non_causal", "_f32", "_f32_non_causal")}
    assert set(fa.counts()) == names
    instances = [fa._instance(d, w, c, f) for d in ("fwd", "bwd")
                 for w in (False, True) for c in (True, False)
                 for f in (False, True)]
    assert sorted(instances) == sorted(names)
    assert fa._instance("fwd", True, False, True) == \
        "flash_attn_fwd_wide_f32_non_causal"
    fa.zero_counts()
    # Three forward launches: one bf16 causal, two f32 (one non-causal).
    for causal, f32 in ((True, False), (True, True), (False, True)):
        fa._launches[fa._instance("fwd", False, causal, f32)] += 1
    assert fa.counts() == {**dict.fromkeys(names, 0), "flash_attn_fwd": 1,
                           "flash_attn_fwd_f32": 1,
                           "flash_attn_fwd_f32_non_causal": 1}
    # counts() is a copy: changing it changes no counter.
    fa.counts()["flash_attn_fwd"] = 7
    assert fa.counts()["flash_attn_fwd"] == 1
    fa.zero_counts()
    assert set(fa.counts().values()) == {0}


# -- The f32 LM through the kernel route against the reference's. --

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
def kernel_lm(route, monkeypatch):
    """The LM's attention through the kernel route on CPU tensors: the
    wrappers take their CUDA path (checks, padding, the f32 entry
    points' stand-ins) in place of the plain versions."""
    monkeypatch.setattr(fa, "flash_attention_fwd", _route_fwd)
    monkeypatch.setattr(fa, "flash_attention_bwd", _route_bwd)
    return route


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(jax.devices()[:1])


@pytest.mark.parametrize("attn", ["ring", "flash"])
def test_f32_lm_through_the_route_matches_jax(kernel_lm, mesh, attn):
    """The port's LM at head dim 64 in f32 (params and compute), its
    attention ``attn`` (the ring at sp = 1, or flash) through the f32
    instances' route, against the reference's f32 LM (``"local"``: its
    ring needs ``shard_map``'s ``check_rep``, which jax 0.9 lacks) on the
    same params and tokens: logits, loss and every gradient within 1e-4;
    the forward launches the f32 instance once a layer, the step twice
    (remat) and its backward once, and no bf16 instance."""
    jcfg = jlm.LMConfig(**LM64, compute_dtype=jnp.float32, attn_impl="local")
    tcfg = tlm.LMConfig(**LM64, compute_dtype=torch.float32,
                        param_dtype=torch.float32, attn_impl=attn)
    jp = jlm.init_params(jax.random.PRNGKey(4), jcfg)
    tp = tlm.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                             device="cpu")
    batch = np.random.default_rng(4).integers(0, LM64["vocab"], (2, 34)
                                              ).astype(np.int32)
    layers = tcfg.n_layers
    fa.zero_counts()
    got = tlm.make_forward(tcfg, "cpu")(tp, torch.from_numpy(batch[:, :-1]))
    assert fa.counts()["flash_attn_fwd_f32"] == layers
    want = np.asarray(jlm.make_forward(jcfg, mesh)(jp, jnp.asarray(
        batch[:, :-1])))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    fa.zero_counts()
    loss, grads = tlm.loss_and_grads(tp, torch.from_numpy(batch), tcfg)
    assert fa.counts() == {**dict.fromkeys(fa.counts(), 0),
                           "flash_attn_fwd_f32": 2 * layers,
                           "flash_attn_bwd_f32": layers}
    want_loss, want_grads = jax.value_and_grad(jlm.loss_fn)(
        jp, jnp.asarray(batch), jcfg, mesh)
    assert abs(float(loss) - float(want_loss)) < 1e-4
    for path, w in jax.tree_util.tree_flatten_with_path(want_grads)[0]:
        node = grads
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(node.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=0, err_msg=str(path))
    assert {c[0] for c in kernel_lm.calls} == {"fwd32", "bwd32"}


def test_f64_attention_of_the_step_reading_matches_the_reference():
    """``gates.attention_f64``, the more exact attention that the f32
    LM's train steps are read against on the card: the reference's f32
    ``reference_attention`` within 1e-5, output in the input's dtype."""
    q, k, v = _inputs((2, 3, 65, 32), n=3, seed=7)
    got = gates.attention_f64(*map(torch.from_numpy, (q, k, v)))
    want = np.asarray(jax_ra.reference_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_f64_attention_gradients_match_jax_grad(monkeypatch):
    """Its gradients (recomputed a head at a time) against ``jax.grad``
    of the reference's f32 attention, 1e-5."""
    q, k, v, do = _inputs((2, 3, 65, 32), seed=8)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    monkeypatch.setattr(gates, "_CHUNK_BYTES", 2 * 65 * 65 * 8)
    out = gates.attention_f64(tq, tk, tv)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    _, want = _jax_reference(q, k, v, do, True)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_plain64_matches_the_f64_version_here(causal):
    """``gates.plain64`` (the exact version the card's f32 rule reads
    against), a head at a time and whole, against this file's float64
    version."""
    x = _inputs((2, 3, 40, 24), seed=9)
    want = _f64(*x, causal)
    old = gates._CHUNK_BYTES
    for chunk in (2 * 40 * 40 * 8, old):
        gates._CHUNK_BYTES = chunk
        try:
            got = gates.plain64(*map(torch.from_numpy, x), causal)
        finally:
            gates._CHUNK_BYTES = old
        for name, w in want.items():
            assert got[name].dtype == torch.float64
            torch.testing.assert_close(got[name], w, atol=1e-12, rtol=0,
                                       msg=name)


def test_tf32_control_attention_matches_jax_here():
    """``gates.attention_tf32`` (the control of the f32 step rule) on the
    CPU, where no product takes TF32: the reference's f32 attention and
    ``jax.grad`` of it, 1e-5, and the TF32 switch left as it was."""
    q, k, v, do = _inputs((2, 3, 65, 32), seed=10)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    before = torch.backends.cuda.matmul.allow_tf32
    out = gates.attention_tf32(tq, tk, tv)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    assert torch.backends.cuda.matmul.allow_tf32 == before
    want_o, want = _jax_reference(q, k, v, do, True)
    np.testing.assert_allclose(out.detach().numpy(), want_o, atol=1e-5,
                               rtol=0)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=0,
                                   err_msg=name)


def test_split_operands_keep_sixteen_bits_and_pass_the_gradient():
    """``moe_f32_routing.split_operands``: each value within 2^-17
    relative of itself (hi + lo, the f32 kernels' operands), bf16 values
    unchanged, the gradient passed through as it is."""
    x = torch.from_numpy(_inputs((4, 64), seed=11)[0]).requires_grad_()
    got = moe_f32_routing.split_operands(x)
    assert bool(((got - x).abs() <= x.abs() * 2.0 ** -17).all())
    assert bool((got != x).any())
    even = x.detach().to(torch.bfloat16).float()
    assert torch.equal(moe_f32_routing.split_operands(even), even)
    (g,) = torch.autograd.grad(got, x, torch.full_like(x, 3.0))
    assert torch.equal(g, torch.full_like(x, 3.0))


def test_fp16_route_keeps_22_bits_on_inputs_spanning_2_to_the_20():
    """The f32 route's operand rounding (``moe_f32_routing.parts_of`` of
    the kernel route: fp16 hi + lo under a power-of-2 scale per [batch,
    head] slice) on slices whose largest |x| is 2^-20, 1 and 2^20: every
    value down to 2^-17 of its slice's largest within 2^-21 relative of
    itself, every smaller one (down to 2^-40) within 2^-38 of the slice's
    largest (lo turns subnormal: absolute, not relative, precision); the
    pre-pass's fp16 parts finite, the largest under 2^15."""
    rng = np.random.default_rng(12)
    shape = (1, 3, 64, 32)
    slice_max = np.array([2.0 ** -20, 1.0, 2.0 ** 20]).reshape(1, 3, 1, 1)

    def values(lo_exp, hi_exp):
        x = (2.0 ** rng.uniform(lo_exp, hi_exp, shape)
             * rng.choice([-1.0, 1.0], shape))
        x[..., 0, 0] = 1.0  # each slice's largest |x|
        return torch.from_numpy(x * slice_max).float()

    largest = torch.from_numpy(slice_max).float()
    for x, lo_exp in ((values(-17, 0), -17), (values(-40, -17), -40)):
        got = sum(moe_f32_routing.parts_of(x, ROUTE))
        err = (got - x).abs()
        if lo_exp == -17:
            assert bool((err <= 2.0 ** -21 * x.abs()).all())
        else:
            assert bool((err <= 2.0 ** -38 * largest).all())
        hi, lo = moe_f32_routing.fp16_parts(x)
        assert bool(torch.isfinite(hi.float()).all()
                    and torch.isfinite(lo.float()).all())
        assert float(hi.float().abs().max()) <= 2.0 ** 15


def test_moe_routing_readings_run_here():
    """``moe_f32_routing.readings`` on a small f32 MoE on the CPU, where
    the kernel path is the wrappers' plain version: every path's losses
    finite and within 1e-4 of plain f32's, and a count of differing
    routes for every other path, step and layer, no more than the
    tokens."""
    cfg = tmoe.MoEConfig(n_layers=2, compute_dtype=torch.float32)
    out = moe_f32_routing.readings(cfg, 2, 32, 2, device="cpu")
    assert set(out["losses"]) == set(moe_f32_routing.PATHS)
    for name, rel in out["rel_to_plain"].items():
        assert all(math.isfinite(x) for x in out["losses"][name])
        assert max(rel) <= 1e-4, name
    assert len(out["routing_differs_by_step"]) == 2
    for step in out["routing_differs_by_step"]:
        assert set(step) == set(moe_f32_routing.PATHS) - {"plain"}
        for counts in step.values():
            for key in ("top_k", "kept"):
                assert len(counts[key]) == cfg.n_layers
                assert all(0 <= n <= 2 * 32 for n in counts[key])
