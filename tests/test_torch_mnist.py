"""The port's MNIST payload against the reference's, on the CPU.

The same params (the reference's ``init_params``, carried across by
``params_from_jax``) and the same numpy batches go through both: the
logits within 1e-5, and the loss of each of 3 Adam steps (the
reference's step composed of its ``forward``, ``optax.adam`` and
``optax.softmax_cross_entropy_with_integer_labels``) within 1e-5
relative, f32 on both sides. Then the port learns: over 0.85 held-out
accuracy at 40 steps (the reference's own training test is marked slow;
this one takes about a second).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubernetes_tpu.workloads import mnist as jmnist
from kubernetes_tpu_torch.workloads import mnist as tmnist

LR = 1e-2
STEPS = 3


def _batches(n: int, rows: int = 64):
    rng = np.random.default_rng(0)
    return [(rng.standard_normal((rows, tmnist.DIM)).astype(np.float32),
             rng.integers(0, tmnist.N_CLASSES, rows).astype(np.int32))
            for _ in range(n)]


def _jax_params(hidden: int = 128):
    return jax.tree_util.tree_map(
        np.asarray, jmnist.init_params(jax.random.PRNGKey(0), hidden))


def test_constants_match_the_reference():
    assert (tmnist.N_CLASSES, tmnist.DIM) == (jmnist.N_CLASSES, jmnist.DIM)


@pytest.mark.parametrize("hidden", [16, 128])
def test_logits_match_the_reference(hidden):
    jp = _jax_params(hidden)
    x, _ = _batches(1)[0]
    want = np.asarray(jmnist.forward(jp, jnp.asarray(x)))
    got = tmnist.forward(tmnist.params_from_jax(jp, "cpu"),
                         torch.from_numpy(x))
    assert got.shape == (64, tmnist.N_CLASSES)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_adam_steps_match_the_reference():
    jp = jmnist.init_params(jax.random.PRNGKey(0))
    opt = optax.adam(LR)
    state = opt.init(jp)

    def loss_fn(p, x, y):
        logits = jmnist.forward(p, x)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean()

    params = tmnist.params_from_jax(_jax_params(), "cpu")
    opt_state = tmnist.make_optimizer(LR).init(params)
    step = tmnist.make_train_step(LR)
    for x, y in _batches(STEPS):
        want, grads = jax.value_and_grad(loss_fn)(jp, jnp.asarray(x),
                                                  jnp.asarray(y))
        updates, state = opt.update(grads, state)
        jp = optax.apply_updates(jp, updates)
        got = step(params, opt_state, torch.from_numpy(x),
                   torch.from_numpy(y).long())
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    for key, val in params.items():
        np.testing.assert_allclose(val.numpy(), np.asarray(jp[key]),
                                   atol=1e-5, rtol=0, err_msg=key)


def test_synthetic_prototypes_are_the_seeds_alone():
    """Two batches of one seed share the class prototypes: the mean of a
    class's samples is its prototype within the noise, whichever the
    batch."""
    gen = torch.Generator().manual_seed(1)
    means = []
    for _ in range(2):
        x, labels = tmnist._synthetic(gen, 2000, seed=3)
        assert x.shape == (2000, tmnist.DIM) and x.dtype == torch.float32
        assert int(labels.min()) >= 0 and int(labels.max()) < 10
        means.append(x[labels == 0].mean(0))
    assert float((means[0] - means[1]).abs().mean()) < 0.1
    other, _ = tmnist._synthetic(torch.Generator().manual_seed(1), 4, seed=4)
    assert not torch.equal(other, tmnist._synthetic(
        torch.Generator().manual_seed(1), 4, seed=3)[0])


def test_the_port_learns_on_the_cpu():
    assert tmnist.train(steps=40, device="cpu") > 0.85
