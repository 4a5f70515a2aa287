"""The port's plain attention against the reference's, on the CPU.

``reference_attention`` is the numerics reference for the
flash-attention kernel, and the kernel wrapper takes it for CPU
tensors, so it must agree with the reference's to f32 rounding (1e-5).
The kernel itself runs only on the card (``tests/test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.workloads import ring_attention as jax_ra
from kubernetes_tpu_torch.workloads import flash_attention as fa
from kubernetes_tpu_torch.workloads import ring_attention as torch_ra


def _qkv(b, h, t, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, t, d)).astype(np.float32)
            for _ in range(3)]


def _lse64(q, k):
    """Natural-log row sums of the causal scaled scores, in float64."""
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64),
                  k.astype(np.float64)) / np.sqrt(q.shape[-1])
    t = q.shape[2]
    s = np.where(np.tril(np.ones((t, t), bool)), s, -np.inf)
    m = s.max(-1, keepdims=True)
    return (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]


#: T at the edges of the CUDA kernels' 64- and 128-row tiles, at every
#: head dim they take: the plain version is their oracle on the card.
EDGE_T = [127, 128, 129, 255]


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("t", [1, 17, 33] + EDGE_T)
def test_reference_attention_matches_jax(d, t):
    q, k, v = _qkv(2, 3, t, d, seed=t * 100 + d)
    want = np.asarray(jax_ra.reference_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = torch_ra.reference_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("t", [1, 33] + EDGE_T)
def test_reference_lse_variant(d, t):
    q, k, v = _qkv(1, 2, t, d, seed=7 + t + d)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    o, lse = torch_ra.reference_attention_with_lse(tq, tk, tv)
    torch.testing.assert_close(o, torch_ra.reference_attention(tq, tk, tv),
                               atol=0, rtol=0)
    assert lse.dtype == torch.float32 and lse.shape == (1, 2, t)
    np.testing.assert_allclose(lse.numpy(), _lse64(q, k), atol=1e-5, rtol=0)


def test_reference_attention_bf16_matches_jax():
    """bf16 inputs: both sides upcast to f32, so only the final cast to
    bf16 may differ, by at most one bf16 step (2^-8 relative)."""
    q, k, v = _qkv(1, 2, 33, 32, seed=3)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(jax_ra.reference_attention(jq, jk, jv)
                      .astype(jnp.float32))
    tq, tk, tv = (torch.tensor(np.asarray(a.astype(jnp.float32)))
                  .bfloat16() for a in (jq, jk, jv))
    got = torch_ra.reference_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=1e-5, rtol=2 ** -8)


def test_flash_wrapper_takes_plain_version_on_cpu():
    q, k, v = map(torch.from_numpy, _qkv(2, 2, 65, 32, seed=11))
    before = fa.launches
    o, lse = fa.flash_attention_fwd(q, k, v)
    assert fa.launches == before
    want_o, want_lse = torch_ra.reference_attention_with_lse(q, k, v)
    torch.testing.assert_close(o, want_o, atol=0, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=0, rtol=0)
    torch.testing.assert_close(fa.flash_attention(q, k, v), want_o,
                               atol=0, rtol=0)


@pytest.mark.parametrize("shapes", [
    ((1, 2, 8, 32), (1, 2, 9, 32), (1, 2, 8, 32)),
    ((2, 8, 32), (2, 8, 32), (2, 8, 32)),
])
def test_flash_wrapper_rejects_bad_shapes(shapes):
    q, k, v = (torch.zeros(s) for s in shapes)
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(q, k, v)
