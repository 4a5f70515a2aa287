"""The port's train step against the reference's, on the CPU.

Params come from the reference's ``init_params`` / ``init_sharded`` and
carry over through numpy, batches from a numpy seed, so both sides see
the same inputs. The reference runs on a one-device mesh with
``attn_impl="flash"`` (which off TPU substitutes its plain attention)
or ``"local"``; the port runs the plain versions of its kernels, the
flash pair through ``FlashAttention``. Tolerances:

- f32 compute, 1e-4: the same arithmetic, reductions in another order;
- bf16 compute, 5e-2 on the loss and the grads: bf16 rounds at other
  places in the two frameworks (the reference tests' bf16 bound);
- after one AdamW step, each weight within 2 * lr and the mean
  difference small (1e-6 at f32, lr / 10 with bf16 compute): the first
  step moves a weight by lr * g / (|g| + eps), about lr * sign(g), so a
  grad near 0 whose rounding differs between the two sides moves the
  weight up to lr one way on one side and lr the other way on the other;
  Adam's moments at 1e-4 (f32) like the grads;
- a 10-step mixed-precision loss trajectory within 0.05, the reference's
  own f32-vs-mixed bound (``tests/workloads/test_workloads.py:115``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubernetes_tpu.workloads import lm as jlm
from kubernetes_tpu.workloads.sharding import make_mesh
from kubernetes_tpu_torch.workloads import flash_attention as fa
from kubernetes_tpu_torch.workloads import lm as tlm
from kubernetes_tpu_torch.workloads import vector_add as va

SMALL = dict(vocab=128, d_model=64, n_layers=2, n_heads=2, d_ff=128)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
LR = 3e-3


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(jax.devices()[:1])


def _configs(compute="float32", attn="local", params="float32", **kw):
    jc, tc = DTYPES[compute]
    jp, tp = DTYPES[params]
    return (jlm.LMConfig(**SMALL, compute_dtype=jc, param_dtype=jp,
                         attn_impl=attn, **kw),
            tlm.LMConfig(**SMALL, compute_dtype=tc, param_dtype=tp,
                         attn_impl=attn, **kw))


def _carry(tree, tcfg):
    return tlm.params_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                               tcfg, device="cpu")


def _batch(shape, seed):
    return np.random.default_rng(seed).integers(
        0, SMALL["vocab"], shape).astype(np.int32)


def _np_leaves(tree):
    return [np.asarray(x.astype(jnp.float32))
            for x in jax.tree_util.tree_leaves(tree)]


def _sorted_leaves(tree):
    """Leaves in sorted key order, the order of ``jax.tree_util``."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree)
                for leaf in _sorted_leaves(tree[key])]
    return [tree]


def _t_leaves(tree):
    return [x.detach().float().numpy() for x in _sorted_leaves(tree)]


def _assert_stepped_alike(got, want, mean_atol):
    for g, w in zip(got, want):
        diff = np.abs(g - w)
        assert diff.max() <= 2 * LR * 1.01, diff.max()
        assert diff.mean() <= mean_atol, diff.mean()


@pytest.mark.parametrize("attn", ["flash", "local"])
@pytest.mark.parametrize("compute,atol", [("float32", 1e-4),
                                          ("bfloat16", 5e-2)])
def test_loss_and_grads_match_jax(mesh, attn, compute, atol):
    jcfg, tcfg = _configs(compute, attn)
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    batch = _batch((2, 34), seed=1)
    want_loss, want = jax.value_and_grad(jlm.loss_fn)(
        jp, jnp.asarray(batch), jcfg, mesh)
    loss, grads = tlm.loss_and_grads(_carry(jp, tcfg),
                                     torch.from_numpy(batch), tcfg)
    assert abs(float(loss) - float(want_loss)) < atol
    jflat = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    for path, w in jflat.items():
        node = grads
        for key in path:
            node = node[key.key]
        assert node.dtype == torch.float32, path
        np.testing.assert_allclose(node.numpy(), np.asarray(w), atol=atol,
                                   rtol=0, err_msg=str(path))


def test_grads_in_the_params_dtype(mesh):
    """bf16 params get bf16 grads, as ``jax.value_and_grad`` gives."""
    jcfg, tcfg = _configs("bfloat16", "flash", params="bfloat16")
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    batch = _batch((2, 17), seed=2)
    _, want = jax.value_and_grad(jlm.loss_fn)(jp, jnp.asarray(batch), jcfg,
                                              mesh)
    _, grads = tlm.loss_and_grads(_carry(jp, tcfg), torch.from_numpy(batch),
                                  tcfg)
    for g, w in zip(_sorted_leaves(grads), jax.tree_util.tree_leaves(want)):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w.astype(jnp.float32)),
                                   atol=5e-2, rtol=0)


@pytest.mark.parametrize("attn", ["flash", "local"])
def test_one_f32_step_matches_jax(mesh, attn):
    jcfg, tcfg = _configs("float32", attn)
    jp, jst = jlm.init_sharded(jax.random.PRNGKey(0), jcfg, mesh)
    tp = _carry(jp, tcfg)
    tst = tlm.init_opt_state(tp, tcfg)
    batch = _batch((4, 33), seed=3)
    jp, jst, jloss = jlm.make_train_step(jcfg, mesh)(jp, jst,
                                                     jnp.asarray(batch))
    tp, tst, tloss = tlm.make_train_step(tcfg, device="cpu")(
        tp, tst, torch.from_numpy(batch))
    assert abs(float(tloss) - float(jloss)) < 1e-4
    adam = jst[0]
    assert int(tst["count"]) == int(adam.count) == 1
    for want, got in ((adam.mu, tst["mu"]), (adam.nu, tst["nu"])):
        for w, g in zip(_np_leaves(want), _t_leaves(got)):
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)
    _assert_stepped_alike(_t_leaves(tp), _np_leaves(jp), 1e-6)


@pytest.mark.parametrize("attn", ["flash", "local"])
def test_one_mixed_step_matches_jax(mesh, attn):
    jcfg, tcfg = _configs("bfloat16", attn, params="bfloat16")
    jp, jst = jlm.init_sharded(jax.random.PRNGKey(0), jcfg, mesh)
    tp = _carry(jp, tcfg)
    tst = tlm.init_opt_state(tp, tcfg)
    batch = _batch((4, 33), seed=4)
    jp, jst, jloss = jlm.make_train_step(jcfg, mesh)(jp, jst,
                                                     jnp.asarray(batch))
    tp, tst, tloss = tlm.make_train_step(tcfg, device="cpu")(
        tp, tst, torch.from_numpy(batch))
    assert abs(float(tloss) - float(jloss)) < 5e-2
    _assert_stepped_alike(_t_leaves(tst[1]), _np_leaves(jst[1]), LR / 10)
    # The working params are the master cast down, on both sides.
    for p, m in zip(tlm._leaves(tp), tlm._leaves(tst[1])):
        assert p.dtype == torch.bfloat16
        assert torch.equal(p, m.to(torch.bfloat16))


def test_adamw_arithmetic_matches_optax():
    """Fed the same grads for three steps, the port's AdamW and
    ``optax.adamw`` (the reference's ``make_optimizer``) agree to f32
    rounding."""
    rng = np.random.default_rng(0)
    p0 = {"a": rng.standard_normal((5, 7)).astype(np.float32),
          "b": {"c": rng.standard_normal(11).astype(np.float32)}}
    opt = jlm.make_optimizer(LR)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    jst = opt.init(jp)
    tp = jax.tree_util.tree_map(torch.from_numpy, p0)
    tst = tlm.make_optimizer(LR).init(tp)
    for _ in range(3):
        g = jax.tree_util.tree_map(
            lambda x: rng.standard_normal(x.shape).astype(np.float32), p0)
        updates, jst = opt.update(jax.tree_util.tree_map(jnp.asarray, g),
                                  jst, jp)
        jp = optax.apply_updates(jp, updates)
        tlm.make_optimizer(LR).update_(
            tp, jax.tree_util.tree_map(torch.from_numpy, g), tst)
    for w, got in zip(jax.tree_util.tree_leaves(jp), _sorted_leaves(tp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=0)


def test_ten_step_mixed_trajectory_matches_jax(mesh):
    """The reference's own convergence check, fed the same numpy batches
    on both sides: every loss within 0.05."""
    cfg = dict(vocab=128, d_model=64, n_layers=2, n_heads=4, d_ff=128,
               param_dtype=jnp.bfloat16, attn_impl="flash")
    jcfg = jlm.LMConfig(**cfg)
    tcfg = tlm.LMConfig(**{**cfg, "param_dtype": torch.bfloat16})
    jp, jst = jlm.init_sharded(jax.random.PRNGKey(0), jcfg, mesh)
    tp = _carry(jp, tcfg)
    tst = tlm.init_opt_state(tp, tcfg)
    jstep = jlm.make_train_step(jcfg, mesh)
    tstep = tlm.make_train_step(tcfg, device="cpu")
    jl, tl = [], []
    for i in range(10):
        batch = _batch((4, 33), seed=100 + i)
        jp, jst, loss = jstep(jp, jst, jnp.asarray(batch))
        jl.append(float(loss))
        tp, tst, loss = tstep(tp, tst, torch.from_numpy(batch))
        tl.append(float(loss))
    assert tl[-1] < tl[0] and jl[-1] < jl[0], (tl, jl)
    np.testing.assert_allclose(tl, jl, atol=0.05, rtol=0)


@pytest.mark.parametrize("attn", ["flash", "local"])
def test_remat_policies_give_the_same_grads(attn):
    _, base = _configs("float32", attn)
    params = tlm.init_params(torch.Generator().manual_seed(0), base)
    batch = torch.from_numpy(_batch((2, 41), seed=5))
    _, want = tlm.loss_and_grads(params, batch,
                                 dataclasses.replace(base, remat=False))
    for policy in ("full", "dots"):
        cfg = dataclasses.replace(base, remat=True, remat_policy=policy)
        _, got = tlm.loss_and_grads(params, batch, cfg)
        for g, w in zip(tlm._leaves(got), tlm._leaves(want)):
            torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-5)


def test_remat_reruns_the_forward_attention(monkeypatch):
    """Under remat each layer's attention forward runs twice per step
    (forward, then the recompute in backward) and its backward once;
    without remat once each."""
    calls = {"fwd": 0, "bwd": 0}
    real_fwd, real_bwd = fa.flash_attention_fwd, fa.flash_attention_bwd

    def fwd(*args):
        calls["fwd"] += 1
        return real_fwd(*args)

    def bwd(*args):
        calls["bwd"] += 1
        return real_bwd(*args)

    monkeypatch.setattr(fa, "flash_attention_fwd", fwd)
    monkeypatch.setattr(fa, "flash_attention_bwd", bwd)
    _, base = _configs("float32", "flash")
    params = tlm.init_params(torch.Generator().manual_seed(0), base)
    batch = torch.from_numpy(_batch((2, 9), seed=6))
    for remat, policy, fwd_per_layer in ((True, "dots", 2),
                                         (True, "full", 2), (False, "dots", 1)):
        calls.update(fwd=0, bwd=0)
        tlm.loss_and_grads(params, batch, dataclasses.replace(
            base, remat=remat, remat_policy=policy))
        assert calls == {"fwd": fwd_per_layer * base.n_layers,
                         "bwd": base.n_layers}, (remat, policy, calls)


def test_chunked_loss_grads_match_unchunked():
    _, base = _configs("float32", "local")
    params = tlm.init_params(torch.Generator().manual_seed(1), base)
    batch = torch.from_numpy(_batch((4, 25), seed=7))  # 96 tokens
    loss, want = tlm.loss_and_grads(params, batch, base)
    got_loss, got = tlm.loss_and_grads(
        params, batch, dataclasses.replace(base, loss_chunk=40))
    assert abs(float(got_loss) - float(loss)) < 1e-5
    for g, w in zip(tlm._leaves(got), tlm._leaves(want)):
        torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-5)


def test_mixed_layout_bf16_params_f32_master():
    cfg = tlm.LMConfig(**SMALL, param_dtype=torch.bfloat16)
    params, (adam, master) = tlm.init_train_state(
        torch.Generator().manual_seed(0), cfg)
    assert tlm._is_mixed(cfg) and not tlm._is_mixed(
        tlm.LMConfig(**SMALL))
    for p, m, mu, nu in zip(tlm._leaves(params), tlm._leaves(master),
                            tlm._leaves(adam["mu"]), tlm._leaves(adam["nu"])):
        assert p.dtype == torch.bfloat16
        assert m.dtype == mu.dtype == nu.dtype == torch.float32
        assert torch.equal(m, p.float())
        assert m.data_ptr() != p.data_ptr()
    assert adam["count"].device.type == "cpu" and int(adam["count"]) == 0
    f32_params, f32_state = tlm.init_train_state(
        torch.Generator().manual_seed(0), tlm.LMConfig(**SMALL))
    assert set(f32_state) == {"count", "mu", "nu"}


def test_cpu_train_step_counts_no_launches():
    cfg = tlm.LMConfig(**SMALL, attn_impl="flash",
                       param_dtype=torch.bfloat16)
    params, opt_state = tlm.init_train_state(
        torch.Generator().manual_seed(0), cfg)
    before = (va.launches, fa.counts())
    batch = tlm.synthetic_batch(torch.Generator().manual_seed(0), cfg, 2, 16,
                                device="cpu")
    _, _, loss = tlm.make_train_step(cfg, device="cpu")(params, opt_state,
                                                       batch)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert (va.launches, fa.counts()) == before


def test_train_step_refuses_a_batch_on_another_device():
    cfg = tlm.LMConfig(**SMALL, attn_impl="local")
    step = tlm.make_train_step(cfg, device="cpu")
    params, opt_state = tlm.init_train_state(
        torch.Generator().manual_seed(0), cfg)
    with pytest.raises(ValueError, match="batch is on"):
        step(params, opt_state, torch.zeros((1, 5), dtype=torch.int32,
                                            device="meta"))


def test_train_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch,
                                                          tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tlm.LMConfig(**SMALL, attn_impl="local")
    for call in (lambda: tlm.make_train_step(cfg),
                 lambda: tlm.train(cfg, steps=1, batch=1, seq=4,
                                   ckpt_dir=str(tmp_path / "job"))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not (tmp_path / "job").exists()
