"""The port's LM forward and loss against the reference's, on the CPU.

Params come from the reference's ``init_params`` and carry over through
numpy (``params_from_jax``), so both sides see the same weights. The
reference runs ``attn_impl="flash"`` (which off TPU substitutes its plain
``reference_attention``) or ``"local"``; the port runs the plain versions
of its kernels. Tolerances:

- f32 compute, 1e-4: the same arithmetic, reductions in another order;
- bf16 compute, 5e-2 on the loss and on the logits: bf16 rounds at other
  places in the two frameworks; the reference's own bound for bf16
  comparisons (tests/workloads/test_lm.py, test_workloads.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.workloads import lm as jlm
from kubernetes_tpu.workloads.sharding import make_mesh
from kubernetes_tpu_torch import entry as torch_entry
from kubernetes_tpu_torch.workloads import lm as tlm

SMALL = dict(vocab=128, d_model=64, n_layers=2, n_heads=2, d_ff=128)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(jax.devices()[:1])


def _configs(compute, attn, **kw):
    jdt, tdt = DTYPES[compute]
    return (jlm.LMConfig(**SMALL, compute_dtype=jdt, attn_impl=attn, **kw),
            tlm.LMConfig(**SMALL, compute_dtype=tdt, attn_impl=attn, **kw))


def _params(jcfg, tcfg, seed=0):
    jp = jlm.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, tlm.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                   tcfg, device="cpu")


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, SMALL["vocab"], shape).astype(np.int32)


@pytest.mark.parametrize("attn", ["flash", "local"])
@pytest.mark.parametrize("compute,atol", [("float32", 1e-4),
                                          ("bfloat16", 5e-2)])
def test_forward_matches_jax(mesh, attn, compute, atol):
    jcfg, tcfg = _configs(compute, attn)
    jp, tp = _params(jcfg, tcfg)
    toks = _tokens((2, 33))
    want = np.asarray(jlm.make_forward(jcfg, mesh)(jp, jnp.asarray(toks)))
    got = tlm.make_forward(tcfg, "cpu")(tp, torch.from_numpy(toks))
    assert got.dtype == torch.float32 and got.shape == (2, 33, SMALL["vocab"])
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)


@pytest.mark.parametrize("attn", ["flash", "local"])
@pytest.mark.parametrize("compute,atol", [("float32", 1e-4),
                                          ("bfloat16", 5e-2)])
def test_loss_matches_jax(mesh, attn, compute, atol):
    jcfg, tcfg = _configs(compute, attn)
    jp, tp = _params(jcfg, tcfg, seed=1)
    batch = _tokens((2, 34), seed=1)
    want = float(jlm.loss_fn(jp, jnp.asarray(batch), jcfg, mesh))
    got = float(tlm.loss_fn(tp, torch.from_numpy(batch), tcfg))
    assert abs(got - want) < atol, (got, want)


@pytest.mark.parametrize("chunk", [64, 100])
def test_chunked_loss_matches_unchunked(mesh, chunk):
    """4*96 = 384 tokens; chunk 100 leaves a ragged tail of 84."""
    jcfg, tcfg = _configs("bfloat16", "local")
    _, tp = _params(jcfg, tcfg, seed=2)
    batch = torch.from_numpy(_tokens((4, 97), seed=2))
    ref = float(tlm.loss_fn(tp, batch, tcfg))
    got = float(tlm.loss_fn(tp, batch,
                            dataclasses.replace(tcfg, loss_chunk=chunk)))
    assert abs(got - ref) < 1e-4, (chunk, got, ref)


def test_chunked_loss_matches_jax_chunked(mesh):
    jcfg, tcfg = _configs("float32", "local", loss_chunk=100)
    jp, tp = _params(jcfg, tcfg, seed=3)
    batch = _tokens((4, 97), seed=3)
    want = float(jlm.loss_fn(jp, jnp.asarray(batch), jcfg, mesh))
    got = float(tlm.loss_fn(tp, torch.from_numpy(batch), tcfg))
    assert abs(got - want) < 1e-4, (got, want)


def test_rope_and_rms_norm_match_jax():
    """The two places a port most easily drifts: RoPE rotates
    INTERLEAVED pairs; RMSNorm scales after the cast back."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 9, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    jcfg, tcfg = _configs("float32", "local")
    np.testing.assert_allclose(
        tlm._rope(torch.from_numpy(x), tcfg).numpy(),
        np.asarray(jlm._rope(jnp.asarray(x), jcfg)), atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        tlm._rms_norm(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
        np.asarray(jlm._rms_norm(jnp.asarray(x), jnp.asarray(scale))),
        atol=1e-5, rtol=0)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_init_params_tree_matches_jax(param_dtype):
    jdt, tdt = DTYPES[param_dtype]
    jp = jlm.init_params(jax.random.PRNGKey(0),
                         jlm.LMConfig(**SMALL, param_dtype=jdt))
    tcfg = tlm.LMConfig(**SMALL, param_dtype=tdt)
    tp = tlm.init_params(torch.Generator().manual_seed(0), tcfg)
    carried = tlm.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                  tcfg, device="cpu")
    jflat = dict(jax.tree_util.tree_flatten_with_path(jp)[0])
    for path, jleaf in jflat.items():
        keys = [p.key for p in path]
        node, moved = tp, carried
        for key in keys:
            node, moved = node[key], moved[key]
        assert tuple(node.shape) == jleaf.shape, keys
        assert node.dtype == tdt and moved.dtype == tdt, keys
        np.testing.assert_array_equal(
            moved.float().numpy(), np.asarray(jleaf.astype(jnp.float32)))
        # Same scale as the reference's initialiser, to sampling error.
        assert abs(float(node.float().std())
                   - float(jnp.std(jleaf.astype(jnp.float32)))) \
            < 0.2 * float(jnp.std(jleaf.astype(jnp.float32))) + 1e-6, keys


@pytest.mark.parametrize("kwargs", [dict(attn_impl="fash"),
                                    dict(remat_policy="dot"),
                                    dict(loss_chunk=-1)])
def test_config_validation_matches_jax(kwargs):
    with pytest.raises(ValueError) as jerr:
        jlm.LMConfig(**kwargs)
    with pytest.raises(ValueError) as terr:
        tlm.LMConfig(**kwargs)
    assert str(terr.value) == str(jerr.value)


def test_config_defaults_match_jax():
    j, t = jlm.LMConfig(), tlm.LMConfig()
    for field in ("vocab", "d_model", "n_layers", "n_heads", "d_ff",
                  "rope_base", "remat", "remat_policy", "loss_chunk",
                  "attn_impl"):
        assert getattr(t, field) == getattr(j, field), field
    assert t.head_dim == j.head_dim


def test_ring_attention_is_not_ported_yet():
    """The reference's default attention, once refused, now runs: on one
    device the ring is one causal block, the flash path's forward bit
    for bit (its sequence-parallel runs: tests/test_torch_lm_sp.py)."""
    cfg = tlm.LMConfig(**SMALL)
    assert cfg.attn_impl == "ring"
    params = tlm.init_params(torch.Generator().manual_seed(0), cfg)
    tokens = torch.from_numpy(_tokens((2, 33)))
    got = tlm.make_forward(cfg, "cpu")(params, tokens)
    want = tlm.make_forward(dataclasses.replace(cfg, attn_impl="flash"),
                            "cpu")(params, tokens)
    assert torch.equal(got, want)


def test_synthetic_batch_follows_the_stream():
    cfg = tlm.LMConfig(**SMALL)
    batch = tlm.synthetic_batch(torch.Generator().manual_seed(0), cfg, 8, 63,
                                device="cpu")
    assert batch.shape == (8, 64) and batch.dtype == torch.int32
    b = batch.long().numpy()
    assert b.min() >= 0 and b.max() < cfg.vocab
    pow3 = [pow(3, n, cfg.vocab) for n in range(64)]
    ideal = (b[:, :1] * np.asarray(pow3) + 7 * np.arange(64)) % cfg.vocab
    # 2% of tokens are noise; a noisy tok_0 derails its whole row.
    agree = (ideal == b).mean()
    assert agree > 0.8, agree


def test_entry_matches_reference_shape(mesh):
    fn, (params, tokens) = torch_entry.entry(device="cpu")
    out = fn(params, tokens)
    jcfg = jlm.LMConfig(vocab=256, d_model=128, n_layers=2, n_heads=4,
                        d_ff=512, attn_impl="flash")
    want = jax.eval_shape(
        jlm.make_forward(jcfg, mesh),
        jlm.init_params(jax.random.PRNGKey(0), jcfg),
        jnp.zeros((2, 64), jnp.int32))
    assert tuple(out.shape) == want.shape == (2, 64, 256)
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tlm.LMConfig(**SMALL, attn_impl="local")
    for call in (lambda: torch_entry.entry(),
                 lambda: tlm.make_forward(cfg),
                 lambda: tlm.params_from_jax({}, cfg),
                 lambda: tlm.synthetic_batch(torch.Generator(), cfg, 1, 4)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
