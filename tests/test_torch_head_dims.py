"""Head dims on the CPU: the configs that send them, the wrapper at every
head dim up to 256 against the reference, and the LM and the MoE at head
dims that are not powers of 2, and the LM at head dim 256.

The fused flash kernels take any head dim from 1 to 256
(``flash_attention.one_tile``): a multiple of 8 launches as it is,
any other through a zero-padded copy, and over 256 the wide kernels
(``tests/test_torch_wide_heads.py``) take it. The reference's
TrainJob controller sets no ``LM_*`` env, so the trainer's default LM (2
heads of a 32-wide model, head dim 16) is what a plain ``MODEL=lm``
TrainJob trains; ``__graft_entry__.dryrun_multichip``'s dense config has
head dim ``32 * max(sizes) / (2 * tp)``: 16 at a power of 2, 48 at 3, 80
at 5, 24 at 6, 112 at 7, and 144 to 240 at 9, 11, 13 and 15. Each is a
head dim the kernels take. The
kernels themselves run only on the card (``tests/test_torch_cuda.py``);
here the wrapper's plain versions are held to the reference, and the
Python around a launch (the padded copy, the scale of the true head dim,
the slice back) to the plain version through a stand-in launch that
computes on the CPU what the kernel computes.

Tolerances: f32 throughout. The forward and its LSE within 1e-5 of the
reference's ``reference_attention`` (float64 for the LSE); the plain
backward within 1e-5 of ``jax.grad`` of it; the stand-in launches
within 1e-5 of the plain version (the same sums with zero columns
added); the LM at head dims 96 and 256 and the MoE at head dim 48 under
the bounds of ``tests/test_torch_train.py`` and ``tests/test_torch_moe.py``
(1e-4 on f32 logits, losses and gradients; an AdamW step within 2 * lr
and a mean of 1e-6).
"""
import ctypes
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.workloads import lm as jlm
from kubernetes_tpu.workloads import moe as jax_moe
from kubernetes_tpu.workloads import ring_attention as jax_ra
from kubernetes_tpu.workloads.sharding import default_axis_sizes, make_mesh
from kubernetes_tpu_torch.kernels import build
from kubernetes_tpu_torch.workloads import flash_attention as fa
from kubernetes_tpu_torch.workloads import lm as tlm
from kubernetes_tpu_torch.workloads import moe as tmoe
from kubernetes_tpu_torch.workloads import trainer
from kubernetes_tpu_torch.workloads.ring_attention import (
    reference_attention_with_lse)

#: Head dims that are not a kernel tile's width: 8 (half the narrowest),
#: 24 and 48 (dryrun at 6 and 3 devices), 25 (not a multiple of 8: the
#: padded copy), 40 (10 devices), 80 (Phi-2), 96 (Phi-3-mini), 112 (7
#: devices).
ODD_HEAD_DIMS = (8, 24, 25, 40, 48, 80, 96, 112)
#: Head dims of the kernels' W-256 tiles: 144 (dryrun at 9 devices), 250
#: (not a multiple of 8: the padded copy to 256), 256 (GPT-J-6B).
WIDE_HEAD_DIMS = (144, 250, 256)
#: The LM at head dim 96: Phi-3-mini's head dim, narrow and shallow.
LM96 = dict(vocab=128, d_model=192, n_layers=2, n_heads=2, d_ff=256)
#: The LM at head dim 256: GPT-J-6B's head dim, narrow and shallow.
LM256 = dict(vocab=128, d_model=512, n_layers=2, n_heads=2, d_ff=512)
LR = 3e-3


def test_trainer_default_lm_has_a_kernel_head_dim(monkeypatch):
    for name in ("LM_VOCAB", "LM_D_MODEL", "LM_LAYERS", "LM_HEADS",
                 "LM_D_FF", "LM_ATTN"):
        monkeypatch.delenv(name, raising=False)
    cfg = trainer.lm_config(torch.device("cuda"))
    assert cfg.attn_impl == "flash"
    assert cfg.head_dim == 16 and fa.takes_head_dim(cfg.head_dim)


@pytest.mark.parametrize("n_devices", range(1, 17))
def test_graft_entry_dense_config_has_a_kernel_head_dim(n_devices):
    """``__graft_entry__.dryrun_multichip``'s dense LM: d_model
    32 * max(sizes), 2 * tp heads, at every device count to 16: a head
    dim the kernels take. An odd n >= 9 is dp = n alone, so d_model =
    32 n over 2 heads: 144, 176, 208, 240, on the W-256 tiles."""
    sizes = default_axis_sizes(n_devices)
    head_dim = 32 * max(sizes.values()) // (2 * sizes["tp"])
    assert fa.takes_head_dim(head_dim), head_dim
    assert (head_dim > 128) is (n_devices in (9, 11, 13, 15)), head_dim


def test_graft_entry_moe_config_has_a_kernel_head_dim():
    mcfg = jax_moe.MoEConfig(vocab=64, d_model=32, n_layers=1, n_heads=2,
                             d_ff=64, n_experts=4, top_k=2)
    assert mcfg.head_dim == 16 and fa.takes_head_dim(mcfg.head_dim)


@pytest.mark.parametrize("d,ok", [(0, False), (1, True), (8, True),
                                  (25, True), (96, True), (128, True),
                                  (129, True), (136, True), (256, True),
                                  (257, False), (264, False)])
def test_the_head_dim_rule(d, ok):
    """``ok``: bf16 head dim ``d`` runs on one tile of the fused kernels
    (1 to 256); every head dim from 1 launches a kernel (the wide ones
    over 256), at a width padded to a multiple of 8."""
    assert fa.one_tile(d) is ok
    assert fa.takes_head_dim(d) is (d > 0)
    if d > 0:
        assert fa._padded(d) % 8 == 0 and d <= fa._padded(d) < d + 8


def _lse64(q, k, causal=True):
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64),
                  k.astype(np.float64)) / math.sqrt(q.shape[-1])
    if causal:
        t = q.shape[2]
        s = np.where(np.tril(np.ones((t, t), bool)), s, -np.inf)
    m = s.max(-1, keepdims=True)
    return (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]


@pytest.mark.parametrize("shape", [(4, 2, 16, 16), (1, 2, 129, 16),
                                   (2, 1, 257, 16)])
def test_d16_wrapper_cpu_path_matches_reference(shape):
    """The trainer's own shape (B4 H2 T16) and shapes over the tiles'
    edges: the forward wrapper on CPU tensors against the reference's
    ``reference_attention`` (f32, 1e-5), and its LSE against float64."""
    rng = np.random.default_rng(sum(shape))
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for _ in range(3))
    want = np.asarray(jax_ra.reference_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    before = fa.counts()
    o, lse = fa.flash_attention_fwd(*map(torch.from_numpy, (q, k, v)))
    assert fa.counts() == before
    np.testing.assert_allclose(o.numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), _lse64(q, k), atol=1e-5, rtol=0)


def _inputs(shape, n=3, seed=0):
    rng = np.random.default_rng(seed + sum(shape))
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("d", ODD_HEAD_DIMS + WIDE_HEAD_DIMS)
def test_wrapper_cpu_path_matches_reference_at_head_dim(d):
    """Forward and LSE of the wrapper's plain path at each head dim
    against ``reference_attention`` (f32, 1e-5) and float64."""
    q, k, v = _inputs((2, 3, 33, d))
    want = np.asarray(jax_ra.reference_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    o, lse = fa.flash_attention_fwd(*map(torch.from_numpy, (q, k, v)))
    assert o.shape == (2, 3, 33, d) and lse.shape == (2, 3, 33)
    np.testing.assert_allclose(o.numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), _lse64(q, k), atol=1e-5, rtol=0)


@pytest.mark.parametrize("d", ODD_HEAD_DIMS + WIDE_HEAD_DIMS)
def test_wrapper_cpu_backward_matches_jax_grad_at_head_dim(d):
    """The plain backward (``flash_attention_bwd`` on CPU tensors, from
    the forward's o and LSE) against ``jax.grad`` of the reference's
    ``reference_attention`` contracted with dO (f32, 1e-5)."""
    q, k, v, do = _inputs((2, 3, 33, d), n=4, seed=1)

    def contracted(q, k, v):
        return jnp.sum(jax_ra.reference_attention(q, k, v) * do)
    want = jax.grad(contracted, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = fa.flash_attention_fwd(tq, tk, tv)
    got = fa.flash_attention_bwd(tq, tk, tv, o, lse, tdo)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == (2, 3, 33, d), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0, err_msg=name)


# -- The Python around a launch, through a stand-in launch on the CPU. --

def _at(ptr: int, shape, dtype) -> torch.Tensor:
    """The tensor of ``shape`` and ``dtype`` at address ``ptr``, sharing
    its memory: what a launch reads and writes."""
    n = math.prod(shape)
    raw = (ctypes.c_uint8 * (n * torch.tensor([], dtype=dtype)
                             .element_size())).from_address(ptr)
    return torch.frombuffer(raw, dtype=dtype).view(shape)


def _scores(q, k, scale, causal):
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        t = q.shape[2]
        s = s.masked_fill(~torch.ones(t, t, dtype=torch.bool).tril(),
                          -math.inf)
    return s


class _Launches:
    """Stand-ins for the C entry points, computing on the CPU, from the
    pointers and sizes a wrapper passes, the functions the kernels
    compute at the head dim they are given and the scale they are
    passed; each call's arguments are kept."""

    def __init__(self):
        self.calls = []

    def fwd(self, qp, kp, vp, op, lsep, b, h, t, w, causal, f32_out,
            scale_log2, device, stream):
        self.calls.append(("fwd", w, scale_log2, qp))
        shape = (b, h, t, w)
        q, k, v = (_at(p, shape, torch.bfloat16) for p in (qp, kp, vp))
        s = _scores(q, k, scale_log2 / math.log2(math.e), causal)
        lse = torch.logsumexp(s, dim=-1)
        o = torch.einsum("bhqk,bhkd->bhqd", torch.exp(s - lse[..., None]),
                         v.float())
        _at(op, shape, torch.float32 if f32_out else torch.bfloat16)[:] = o
        _at(lsep, (b, h, t), torch.float32)[:] = lse
        return 0

    def bwd(self, qp, kp, vp, op, dop, lsep, deltap, dqp, dkp, dvp, b, h, t,
            w, causal, f32_out, scale, device, stream):
        self.calls.append(("bwd", w, scale, qp))
        shape = (b, h, t, w)
        q, k, v, o, do = (_at(p, shape, torch.bfloat16).float()
                          for p in (qp, kp, vp, op, dop))
        lse = _at(lsep, (b, h, t), torch.float32)
        p = torch.exp(_scores(q, k, scale, causal) - lse[..., None])
        delta = (do * o).sum(-1, keepdim=True)
        ds = p * (torch.einsum("bhqd,bhkd->bhqk", do, v) - delta)
        out = torch.float32 if f32_out else torch.bfloat16
        _at(dqp, shape, out)[:] = torch.einsum("bhqk,bhkd->bhqd", ds,
                                               k) * scale
        _at(dkp, shape, out)[:] = torch.einsum("bhqk,bhqd->bhkd", ds,
                                               q) * scale
        _at(dvp, shape, out)[:] = torch.einsum("bhqk,bhqd->bhkd", p, do)
        return 0


@pytest.fixture
def stand_in(monkeypatch):
    """The wrappers' kernel route (``_kernel_fwd``, ``_kernel_bwd``, what
    a CUDA tensor takes once checked) on CPU tensors, the launches
    :class:`_Launches`."""
    launches = _Launches()
    monkeypatch.setattr(build, "current_stream", lambda device: 0)
    monkeypatch.setattr(fa._FWD, "launch", launches.fwd)
    monkeypatch.setattr(fa._BWD, "launch", launches.bwd)
    return launches


@pytest.mark.parametrize("d", ODD_HEAD_DIMS + (250, 256))
@pytest.mark.parametrize("causal", [True, False])
def test_kernel_route_pads_and_slices_at_head_dim(stand_in, d, causal):
    """At each head dim the kernel route hands the kernels a width that
    is a multiple of 8 (the tensors themselves where D is one, a
    zero-padded copy where it is not), the scale of the true D, and
    gives back [B, H, T, D]: forward (o in f32 and bf16, LSE) and
    backward (dq, dk, dv in f32) within 1e-5 of the plain versions on the
    same bf16 inputs."""
    shape = (2, 3, 33, d)
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16)
                   for x in _inputs(shape, n=4, seed=2))
    f32 = torch.float32
    before = fa.counts()
    o, lse = fa._kernel_fwd(q, k, v, causal, f32)
    o_bf16, _ = fa._kernel_fwd(q, k, v, causal, torch.bfloat16)
    grads = fa._kernel_bwd(q, k, v, o_bf16, lse, do, causal, f32)
    suffix = "" if causal else "_non_causal"
    assert {n: c - before[n] for n, c in fa.counts().items()} == {
        **dict.fromkeys(before, 0), f"flash_attn_fwd{suffix}": 2,
        f"flash_attn_bwd{suffix}": 1}
    w = -(-d // 8) * 8
    assert [c[:3] for c in stand_in.calls] == [
        ("fwd", w, pytest.approx(math.log2(math.e) / math.sqrt(d))),
        ("fwd", w, pytest.approx(math.log2(math.e) / math.sqrt(d))),
        ("bwd", w, pytest.approx(1 / math.sqrt(d)))]
    # A head dim that is a multiple of 8 launches on the tensor itself.
    assert (stand_in.calls[0][3] == q.data_ptr()) is (w == d)
    o_want, lse_want = reference_attention_with_lse(q, k, v, causal, f32)
    assert o.shape == o_bf16.shape == shape and o.is_contiguous()
    assert o_bf16.dtype == torch.bfloat16
    torch.testing.assert_close(o, o_want, atol=1e-5, rtol=0)
    # Rounded once to bf16: one bf16 step of |o|, where the f32 sums
    # differ by an ulp on either side of a rounding boundary.
    torch.testing.assert_close(o_bf16, o_want.to(torch.bfloat16), atol=1e-5,
                               rtol=2 ** -7)
    torch.testing.assert_close(lse, lse_want, atol=1e-5, rtol=0)
    want = fa.flash_attention_bwd_plain(q, k, v, o_bf16, lse, do, causal,
                                        f32)
    for name, g, wnt in zip(("dq", "dk", "dv"), grads, want):
        assert g.shape == shape and g.is_contiguous(), name
        torch.testing.assert_close(g, wnt, atol=1e-5, rtol=0, msg=name)


def test_kernel_checks_refuse_a_head_dim_over_256():
    """The checks a CUDA tensor passes before a launch take D 25, 128,
    136, 256 and, since the wide kernels, 264 and 512 (they refused 264
    before), and refuse D 0; the plain version on the CPU takes any head
    dim."""
    for d in (25, 128, 136, 256, 264, 512):
        x = torch.zeros((1, 1, 8, d), dtype=torch.bfloat16)
        fa._check_kernel_inputs("flash attention", q=x, k=x, v=x)
    empty = torch.zeros((1, 1, 8, 0), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dims from 1, not 0"):
        fa._check_kernel_inputs("flash attention", q=empty, k=empty,
                                v=empty)
    x = torch.zeros((1, 1, 8, 264))
    o, _ = fa.flash_attention_fwd(x, x, x)
    assert o.shape == (1, 1, 8, 264)


# -- The LM at head dims 96 and 256 and the MoE at head dim 48 against
#    the reference, f32 compute. --

@pytest.fixture(scope="module")
def mesh():
    return make_mesh(jax.devices()[:1])


def _lm96():
    jcfg = jlm.LMConfig(**LM96, compute_dtype=jnp.float32, attn_impl="flash")
    tcfg = tlm.LMConfig(**LM96, compute_dtype=torch.float32,
                        attn_impl="flash")
    assert jcfg.head_dim == tcfg.head_dim == 96
    return jcfg, tcfg


def _lm256():
    """The reference's LM at head dim 256 with its plain attention
    (``attn_impl="local"``), and the port's through its flash route (the
    plain versions on the CPU), f32 compute."""
    jcfg = jlm.LMConfig(**LM256, compute_dtype=jnp.float32,
                        attn_impl="local")
    tcfg = tlm.LMConfig(**LM256, compute_dtype=torch.float32,
                        attn_impl="flash")
    assert jcfg.head_dim == tcfg.head_dim == 256
    return jcfg, tcfg


def _carry_lm(tree, tcfg):
    return tlm.params_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                               tcfg, device="cpu")


def _tokens(shape, seed, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _path_leaf(tree, path):
    for key in path:
        tree = tree[key.key]
    return tree


def _forward_and_loss_match(mesh, jcfg, tcfg, seed):
    """The forward's logits and the loss on the same params and tokens,
    port against reference (1e-4)."""
    jp = jlm.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = _carry_lm(jp, tcfg)
    toks = _tokens((2, 33), seed, jcfg.vocab)
    want = np.asarray(jlm.make_forward(jcfg, mesh)(jp, jnp.asarray(toks)))
    got = tlm.make_forward(tcfg, "cpu")(tp, torch.from_numpy(toks))
    assert got.shape == (2, 33, jcfg.vocab)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    batch = _tokens((2, 34), seed + 1, jcfg.vocab)
    want_loss = float(jlm.loss_fn(jp, jnp.asarray(batch), jcfg, mesh))
    assert abs(float(tlm.loss_fn(tp, torch.from_numpy(batch), tcfg))
               - want_loss) < 1e-4


def _grads_match(mesh, jcfg, tcfg, seed):
    """The loss and every gradient, port against ``jax.value_and_grad``
    of the reference's loss (1e-4)."""
    jp = jlm.init_params(jax.random.PRNGKey(seed), jcfg)
    batch = _tokens((2, 34), seed + 1, jcfg.vocab)
    want_loss, want = jax.value_and_grad(jlm.loss_fn)(
        jp, jnp.asarray(batch), jcfg, mesh)
    loss, grads = tlm.loss_and_grads(_carry_lm(jp, tcfg),
                                     torch.from_numpy(batch), tcfg)
    assert abs(float(loss) - float(want_loss)) < 1e-4
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat) == len(tlm._leaves(grads))
    for path, w in flat:
        g = _path_leaf(grads, path)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=0, err_msg=str(path))


def _adamw_step_matches(mesh, jcfg, tcfg, seed):
    """One AdamW train step from the same state: the loss within 1e-4,
    every param within 2 * lr and a mean of 1e-6."""
    jp, jst = jlm.init_sharded(jax.random.PRNGKey(seed), jcfg, mesh)
    tp = _carry_lm(jp, tcfg)
    tst = tlm.init_opt_state(tp, tcfg)
    batch = _tokens((4, 33), seed + 1, jcfg.vocab)
    jp, jst, jloss = jlm.make_train_step(jcfg, mesh)(jp, jst,
                                                     jnp.asarray(batch))
    tp, tst, tloss = tlm.make_train_step(tcfg, device="cpu")(
        tp, tst, torch.from_numpy(batch))
    assert abs(float(tloss) - float(jloss)) < 1e-4
    for path, w in jax.tree_util.tree_flatten_with_path(jp)[0]:
        diff = np.abs(_path_leaf(tp, path).detach().numpy() - np.asarray(w))
        assert diff.max() <= 2 * LR * 1.01 and diff.mean() <= 1e-6, path


def test_lm_at_head_dim_96_forward_and_loss_match_jax(mesh):
    _forward_and_loss_match(mesh, *_lm96(), seed=0)


def test_lm_at_head_dim_96_grads_match_jax(mesh):
    _grads_match(mesh, *_lm96(), seed=1)


def test_lm_at_head_dim_96_adamw_step_matches_jax(mesh):
    _adamw_step_matches(mesh, *_lm96(), seed=2)


def test_lm_at_head_dim_256_forward_and_loss_match_jax(mesh):
    _forward_and_loss_match(mesh, *_lm256(), seed=3)


def test_lm_at_head_dim_256_grads_match_jax(mesh):
    _grads_match(mesh, *_lm256(), seed=4)


def test_lm_at_head_dim_256_adamw_step_matches_jax(mesh):
    _adamw_step_matches(mesh, *_lm256(), seed=5)


@pytest.fixture
def plain_moe_reference(monkeypatch):
    """The reference's MoE with its own plain causal attention in place
    of its ring (whose ``check_rep`` fails under the installed jax), and
    its one-device mesh: the route of ``tests/test_torch_moe.py``."""
    monkeypatch.setattr(jax_moe, "ring_attention",
                        lambda q, k, v, mesh, **_: jax_ra.reference_attention(
                            q, k, v))
    return jax_moe.make_moe_mesh(jax.devices()[:1])


def test_moe_at_head_dim_48_matches_the_reference(plain_moe_reference):
    """The MoE with 2 heads of 48: forward, loss and every gradient in
    f32 against the reference's (1e-4)."""
    jcfg = jax_moe.MoEConfig(d_model=96, n_heads=2,
                             compute_dtype=jnp.float32)
    tcfg = tmoe.MoEConfig(d_model=96, n_heads=2, compute_dtype=torch.float32)
    assert jcfg.head_dim == tcfg.head_dim == 48
    jp = jax_moe.init_params(jax.random.PRNGKey(5), jcfg)
    tp = tmoe.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                              device="cpu")
    toks = _tokens((2, 32), 5, jcfg.vocab)
    want, want_aux = jax_moe.forward(jp, jnp.asarray(toks), jcfg,
                                     plain_moe_reference)
    got, aux = tmoe.make_forward(tcfg, "cpu")(tp, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    assert abs(float(aux) - float(want_aux)) <= 1e-5
    batch = _tokens((2, 33), 6, jcfg.vocab)
    want_loss, want = jax.value_and_grad(jax_moe.loss_fn)(
        jp, jnp.asarray(batch), jcfg, plain_moe_reference)
    loss, grads = tmoe.loss_and_grads(tp, torch.from_numpy(batch), tcfg)
    assert abs(float(loss) - float(want_loss)) <= 1e-4
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat) == len(tmoe._leaves(grads))
    for path, w in flat:
        np.testing.assert_allclose(_path_leaf(grads, path).numpy(),
                                   np.asarray(w), atol=1e-4, rtol=0,
                                   err_msg=str(path))
