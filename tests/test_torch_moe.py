"""The port's MoE (``kubernetes_tpu_torch/workloads/moe.py``) against the
reference's (``kubernetes_tpu/workloads/moe.py``) on the CPU.

Inputs come from numpy seeds; params from the reference's
``init_params``, carried over by ``moe.params_from_jax``. The reference
runs as its own tests run it, on one CPU device. Its ``forward`` reaches
the ring's ``check_rep`` ``TypeError`` under the installed jax (ROADMAP
queue 3), so the forward, loss and step tests put the reference's own
``ring_attention.reference_attention`` in place of ``moe.ring_attention``
with ``monkeypatch``, inside the test only; the port, on CPU tensors,
takes its kernels' plain versions. Tolerances:

- ``_route``: ``dispatch`` equal (every slot, every capacity position);
  ``combine`` within 1e-6 and non-zero exactly where ``dispatch`` is: its
  gates come from a matmul and a softmax that XLA and torch round
  differently by an ulp (1e-7 to 4e-7 seen), which is all a gate can
  differ by once the slots agree; ``aux`` within 1e-6;
- ``_moe_ffn`` at f32 compute within 1e-5;
- ``forward``, loss and every gradient at ``MoEConfig()`` widths, f32
  compute, within 1e-4 (the reference's f32 bound for the dense LM);
- one AdamW step's params within 1e-5 wherever the reference's gradient
  is at least 1e-6 in size: there the first step moves a weight by lr *
  g / (|g| + eps), about lr * sign(g). Where |g| is within f32 rounding
  of 0, eps = 1e-8 turns a 1e-9 difference of g into up to 1e-4 of the
  step (3 of 262,144 weights of ``w1`` seen), so those are held by the
  rule of ``tests/test_torch_train.py`` for AdamW steps: each within 2 *
  lr, the mean difference of the leaf within 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.workloads import moe as jmoe
from kubernetes_tpu.workloads import ring_attention as jra
from kubernetes_tpu_torch.workloads import moe as tmoe

LR = 3e-3


def _route_pair(y, w, **kw):
    jcfg = jmoe.MoEConfig(**kw)
    tcfg = tmoe.MoEConfig(**kw)
    want = [np.asarray(a) for a in jmoe._route(jnp.asarray(y),
                                               jnp.asarray(w), jcfg)]
    got = [a.numpy() for a in tmoe._route(torch.from_numpy(y),
                                          torch.from_numpy(w), tcfg)]
    return got, want


def _assert_route_equal(got, want):
    (gd, gc, ga), (wd, wc, wa) = got, want
    assert gd.dtype == gc.dtype == np.float32
    assert gd.shape == wd.shape and gc.shape == wc.shape
    np.testing.assert_array_equal(gd, wd)
    np.testing.assert_array_equal(gc != 0, wc != 0)
    np.testing.assert_allclose(gc, wc, atol=1e-6, rtol=0)
    assert abs(float(ga) - float(wa)) <= 1e-6


def _random_route_inputs(n, d, e, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            (rng.standard_normal((d, e)) * d ** -0.5).astype(np.float32))


@pytest.mark.parametrize("n,d,e,k,cf", [
    (10, 16, 4, 2, 4.0),       # ample capacity: every pick kept
    (64, 128, 4, 2, 1.25),     # the defaults
    (4096, 128, 4, 2, 1.25),   # many tokens: capacity drops some
    (4096, 64, 8, 3, 1.0),     # three rounds over eight experts
    (64, 32, 4, 2, 1e-3),      # capacity 1: every expert takes one token
])
def test_route_matches_the_reference(n, d, e, k, cf):
    y, w = _random_route_inputs(n, d, e, seed=n + e)
    got, want = _route_pair(y, w, n_experts=e, top_k=k, capacity_factor=cf,
                            d_model=d, n_heads=1)
    _assert_route_equal(got, want)
    if cf == 1e-3:
        assert got[0].shape[2] == 1


def test_route_capacity_overflow_matches_the_reference():
    """The reference test's case (``test_moe.py:42-54``): six tokens all
    preferring expert 0 under capacity 1; one lands, the rest drop."""
    y = np.ones((6, 8), np.float32)
    w = np.zeros((8, 2), np.float32)
    w[:, 0] = 1.0
    got, want = _route_pair(y, w, n_experts=2, top_k=1,
                            capacity_factor=1e-9, d_model=8, d_ff=16)
    _assert_route_equal(got, want)
    assert got[0].shape == (6, 2, 1) and got[0].sum() == 1.0
    assert got[0][0, 0, 0] == 1.0  # the first token in order


@pytest.mark.parametrize("tie", ["all", "two"])
def test_route_breaks_ties_by_the_first_expert(tie):
    """argmax takes the first maximum on both sides. "all": a zero router
    (every logit equal) sends each token to experts 0 and 1; "two":
    experts 1 and 3 tie for the top, so 1 is round 0's pick and 3 round
    1's."""
    y = np.random.default_rng(3).standard_normal((12, 8)).astype(np.float32)
    w = np.zeros((8, 4), np.float32)
    if tie == "two":
        w[:, 1] = w[:, 3] = 0.5
        y = np.abs(y)
    got, want = _route_pair(y, w, n_experts=4, top_k=2, capacity_factor=4.0,
                            d_model=8, n_heads=1)
    _assert_route_equal(got, want)
    chosen = got[0].sum(axis=2) > 0
    expected = [0, 1] if tie == "all" else [1, 3]
    assert (np.nonzero(chosen)[1].reshape(12, 2) == expected).all()


def test_config_validation():
    with pytest.raises(ValueError):
        tmoe.MoEConfig(top_k=5, n_experts=4)
    with pytest.raises(ValueError):
        tmoe.MoEConfig(d_model=130, n_heads=4)
    with pytest.raises(ValueError):
        tmoe.MoEConfig(top_k=0)


def test_top2_combine_weights_normalized():
    """The reference test's properties (``test_moe.py:57-66``): top-2
    gates sum to 1 per token; at ample capacity every token reaches
    both of its experts."""
    cfg = tmoe.MoEConfig(n_experts=4, top_k=2, capacity_factor=4.0,
                         d_model=16, d_ff=16)
    y, w = _random_route_inputs(10, 16, 4, seed=1)
    dispatch, combine, aux = tmoe._route(torch.from_numpy(y),
                                         torch.from_numpy(w), cfg)
    torch.testing.assert_close(combine.sum(dim=(1, 2)), torch.ones(10),
                               atol=1e-5, rtol=0)
    assert float(dispatch.sum()) == 2 * 10
    assert float(aux) > 0


def _ffn_weights(d, ff, e, seed):
    rng = np.random.default_rng(seed)
    return {"router": rng.standard_normal((d, e)).astype(np.float32),
            "w1": (rng.standard_normal((e, d, ff)) * 0.1).astype(np.float32),
            "w3": (rng.standard_normal((e, d, ff)) * 0.1).astype(np.float32),
            "w2": (rng.standard_normal((e, ff, d)) * 0.1).astype(np.float32)}


@pytest.mark.parametrize("e,k,cf", [(4, 2, 1.25), (4, 2, 0.5), (8, 1, 2.0)])
def test_moe_ffn_matches_the_reference(e, k, cf):
    d, ff = 32, 64
    kw = dict(n_experts=e, top_k=k, capacity_factor=cf, d_model=d, d_ff=ff)
    lp = _ffn_weights(d, ff, e, seed=e + k)
    y = np.random.default_rng(7).standard_normal((2, 24, d)).astype(
        np.float32)
    mesh = jmoe.make_moe_mesh(jax.devices()[:1])
    want, want_aux = jmoe._moe_ffn(
        jnp.asarray(y), {n: jnp.asarray(v) for n, v in lp.items()},
        jmoe.MoEConfig(**kw, compute_dtype=jnp.float32), mesh)
    got, aux = tmoe._moe_ffn(
        torch.from_numpy(y), {n: torch.from_numpy(v) for n, v in lp.items()},
        tmoe.MoEConfig(**kw, compute_dtype=torch.float32))
    assert got.shape == (2, 24, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    assert abs(float(aux) - float(want_aux)) <= 1e-6


def test_single_expert_equals_dense_ffn():
    """The reference test's identity (``test_moe.py:19-39``): E=1, top-1
    at ample capacity routes every token with weight 1.0, so the layer is
    the dense SwiGLU FFN of the same weights, and aux is 1."""
    cfg = tmoe.MoEConfig(n_experts=1, top_k=1, capacity_factor=2.0,
                         d_model=32, d_ff=64, compute_dtype=torch.float32)
    lp = {k: torch.from_numpy(v) for k, v in _ffn_weights(32, 64, 1,
                                                          seed=0).items()}
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 8, 32)).astype(np.float32))
    got, aux = tmoe._moe_ffn(y, lp, cfg)
    dense = (torch.nn.functional.silu(y @ lp["w1"][0]) * (y @ lp["w3"][0])) \
        @ lp["w2"][0]
    torch.testing.assert_close(got, dense, atol=1e-5, rtol=0)
    assert float(aux) == pytest.approx(1.0)


# -- The model at MoEConfig() widths, f32 compute. --

def _f32_configs(**kw):
    return (jmoe.MoEConfig(compute_dtype=jnp.float32, **kw),
            tmoe.MoEConfig(compute_dtype=torch.float32, **kw))


def _params(jcfg, tcfg, seed=0):
    jp = jmoe.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, tmoe.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                    tcfg, device="cpu")


def _tokens(shape, seed, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


@pytest.fixture
def plain_reference(monkeypatch):
    """The reference's MoE with its own plain causal attention in place
    of its ring (whose ``check_rep`` fails under the installed jax), and
    its one-device mesh."""
    monkeypatch.setattr(jmoe, "ring_attention",
                        lambda q, k, v, mesh, **_: jra.reference_attention(
                            q, k, v))
    return jmoe.make_moe_mesh(jax.devices()[:1])


def _leaf(tree, path):
    for key in path:
        tree = tree[key.key]
    return tree


def test_init_params_has_the_reference_tree():
    jcfg, tcfg = _f32_configs()
    want = jmoe.init_params(jax.random.PRNGKey(0), jcfg)
    got = tmoe.init_params(torch.Generator().manual_seed(0), tcfg)
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat) == len(tmoe._leaves(got))
    for path, w in flat:
        g = _leaf(got, path)
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        # The same scale: the std of a random leaf (ones for the norms).
        np.testing.assert_allclose(float(g.std()), float(jnp.std(w)),
                                   rtol=0.1, atol=1e-6)


def test_forward_matches_the_reference(plain_reference):
    jcfg, tcfg = _f32_configs()
    jp, tp = _params(jcfg, tcfg)
    toks = _tokens((2, 32), seed=1)
    want, want_aux = jmoe.forward(jp, jnp.asarray(toks), jcfg,
                                  plain_reference)
    got, aux = tmoe.make_forward(tcfg, "cpu")(tp, torch.from_numpy(toks))
    assert got.shape == (2, 32, 256) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    assert abs(float(aux) - float(want_aux)) <= 1e-5


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_grads_match_the_reference(plain_reference, remat):
    jcfg, tcfg = _f32_configs(remat=remat)
    jp, tp = _params(jcfg, tcfg, seed=2)
    batch = _tokens((2, 33), seed=2)
    want_loss, want = jax.value_and_grad(jmoe.loss_fn)(
        jp, jnp.asarray(batch), jcfg, plain_reference)
    loss, grads = tmoe.loss_and_grads(tp, torch.from_numpy(batch), tcfg)
    assert abs(float(loss) - float(want_loss)) <= 1e-4
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat) == len(tmoe._leaves(grads))
    for path, w in flat:
        g = _leaf(grads, path)
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=0, err_msg=str(path))


def test_one_adamw_step_matches_the_reference(plain_reference):
    jcfg, tcfg = _f32_configs()
    jp, tp = _params(jcfg, tcfg, seed=3)
    batch = _tokens((2, 33), seed=3)
    params, opt_state = jmoe.init_sharded(jax.random.PRNGKey(3), jcfg,
                                          plain_reference, lr=LR)
    grads = jax.grad(jmoe.loss_fn)(params, jnp.asarray(batch), jcfg,
                                   plain_reference)
    step = jmoe.make_train_step(jcfg, plain_reference, lr=LR)
    want, _, want_loss = step(params, opt_state, jnp.asarray(batch))
    opt_state = tmoe.make_optimizer(LR).init(tp)
    got, _, loss = tmoe.make_train_step(tcfg, lr=LR, device="cpu")(
        tp, opt_state, torch.from_numpy(batch))
    assert abs(float(loss) - float(want_loss)) <= 1e-4
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        diff = np.abs(_leaf(got, path).numpy() - np.asarray(w))
        steady = np.abs(np.asarray(_leaf(grads, path))) >= 1e-6
        assert diff[steady].max(initial=0) <= 1e-5, path
        assert diff.max() <= 2 * LR * 1.01 and diff.mean() <= 1e-6, path


def test_bf16_forward_follows_the_reference(plain_reference):
    """bf16 compute (the config's default): the logits within the
    reference tests' bf16 bound, 5e-2, at the token positions whose
    routing agrees (bf16 may flip a near-tie)."""
    jcfg, tcfg = jmoe.MoEConfig(), tmoe.MoEConfig()
    jp, tp = _params(jcfg, tcfg, seed=4)
    toks = _tokens((2, 32), seed=4)
    want, _ = jmoe.forward(jp, jnp.asarray(toks), jcfg, plain_reference)
    got, aux = tmoe.make_forward(tcfg, "cpu")(tp, torch.from_numpy(toks))
    assert torch.isfinite(got).all() and torch.isfinite(aux)
    diff = np.abs(got.numpy() - np.asarray(want)).max(axis=-1)
    assert (diff <= 5e-2).mean() >= 0.95, diff


def test_remat_is_the_same_step():
    """``remat`` recomputes each layer in the backward; the gradients are
    the same as without it."""
    cfg = tmoe.MoEConfig(compute_dtype=torch.float32)
    params = tmoe.init_params(torch.Generator().manual_seed(5), cfg)
    batch = tmoe.synthetic_batch(torch.Generator().manual_seed(6), cfg, 2,
                                 16, "cpu")
    assert batch.shape == (2, 17) and batch.dtype == torch.int32
    loss_a, a = tmoe.loss_and_grads(params, batch, cfg)
    loss_b, b = tmoe.loss_and_grads(
        params, batch, dataclasses.replace(cfg, remat=False))
    assert torch.equal(loss_a, loss_b)
    for x, y in zip(tmoe._leaves(a), tmoe._leaves(b)):
        torch.testing.assert_close(x, y, atol=1e-6, rtol=1e-6)


def test_train_steps_lower_the_loss():
    """Five steps on one batch, as the reference's mesh test runs them
    (``test_moe.py:69-83``), on the CPU: finite and falling."""
    cfg = tmoe.MoEConfig(vocab=64, d_model=32, n_layers=2, n_heads=2,
                         d_ff=64)
    params, opt_state = tmoe.init_train_state(
        torch.Generator().manual_seed(0), cfg)
    batch = tmoe.synthetic_batch(torch.Generator().manual_seed(1), cfg, 4,
                                 16, "cpu")
    step = tmoe.make_train_step(cfg, device="cpu")
    losses = []
    for _ in range(5):
        params, opt_state, loss = step(params, opt_state, batch)
        losses.append(float(loss))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_entry_points_refuse_a_batch_on_another_device():
    cfg = tmoe.MoEConfig()
    params = tmoe.init_params(torch.Generator().manual_seed(0), cfg)
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    fn = tmoe.make_forward(cfg, "cpu")
    fn(params, tokens)
    with pytest.raises(ValueError, match="made for"):
        fn(params, tokens.to("meta"))
    step = tmoe.make_train_step(cfg, device="cpu")
    with pytest.raises(ValueError, match="made for"):
        step(params, {}, tokens.to("meta"))


@pytest.mark.parametrize("compute,shares,groups", [
    (torch.bfloat16, 1, 1), (torch.float32, 1, 1), (torch.float32, 2, 1),
    (torch.float32, 2, 2)])
def test_rank_rounding_step_is_the_train_step(compute, shares, groups):
    """``perf/moe_rounding.make_step``, the one-device witness of how an
    ep mesh rounds, is the train step it stands for: to the bit with one
    share (the same operations in the same order), and within 1e-6 with
    two shares, the experts whole or in two groups, in f32 compute,
    where a share rounds no more than the sum does. Four steps on one
    batch."""
    from kubernetes_tpu_torch.perf import moe_rounding
    cfg = tmoe.MoEConfig(compute_dtype=compute)
    got = moe_rounding.losses(cfg, 4, 32, 4, shares, "cpu", groups)
    want = moe_rounding.losses(cfg, 4, 32, 4, None, "cpu")
    if shares == 1:
        assert got == want
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6)
