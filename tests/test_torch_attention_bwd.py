"""The port's plain attention backward against the reference's, on the CPU.

``flash_attention_bwd_plain`` is the written-out math the CUDA backward
kernel follows, and the wrapper takes it for CPU tensors. In f32 it must
match ``jax.vjp`` of the reference's ``reference_attention`` and torch
autograd through the port's, to f32 rounding (1e-5). The kernel itself
runs only on the card (``tests/test_torch_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.workloads import ring_attention as jax_ra
from kubernetes_tpu_torch.workloads import flash_attention as fa
from kubernetes_tpu_torch.workloads import ring_attention as torch_ra


def _inputs(b, h, t, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, t, d)).astype(np.float32)
            for _ in range(4)]


def _plain_grads(q, k, v, do):
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = torch_ra.reference_attention_with_lse(tq, tk, tv)
    return fa.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo)


#: T at the edges of the CUDA kernels' 64- and 128-row tiles, at every
#: head dim they take: the plain backward is their oracle on the card.
EDGE_T = [127, 128, 129, 255]


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("t", [1, 17, 65] + EDGE_T)
def test_plain_bwd_matches_jax_vjp(t, d):
    q, k, v, do = _inputs(2, 3, t, d, seed=t * 10 + d)
    _, vjp = jax.vjp(jax_ra.reference_attention,
                     *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(do))
    got = _plain_grads(q, k, v, do)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32 and g.shape == q.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("t", [1, 17, 65] + EDGE_T)
def test_plain_bwd_matches_torch_autograd(t):
    q, k, v, do = _inputs(1, 2, t, 32, seed=t)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    torch_ra.reference_attention(*leaves).backward(torch.from_numpy(do))
    got = _plain_grads(q, k, v, do)
    for name, g, leaf in zip(("dq", "dk", "dv"), got, leaves):
        torch.testing.assert_close(g, leaf.grad, atol=1e-5, rtol=0,
                                   msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_function_on_cpu_is_the_plain_pair(dtype):
    """On CPU tensors both halves of FlashAttention are the plain
    versions: the grads equal the plain backward's on the forward's own
    ``o`` and ``lse``, and no kernel launch is counted."""
    q, k, v, do = (torch.from_numpy(x).to(dtype)
                   for x in _inputs(2, 2, 33, 16, seed=5))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    fwd, bwd = fa.launches, fa.bwd_launches
    out = fa.FlashAttention.apply(*leaves)
    out.backward(do)
    assert (fa.launches, fa.bwd_launches) == (fwd, bwd)
    o, lse = torch_ra.reference_attention_with_lse(q, k, v)
    torch.testing.assert_close(out.detach(), o, atol=0, rtol=0)
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do)
    for name, leaf, w in zip(("dq", "dk", "dv"), leaves, want):
        assert leaf.grad.dtype == dtype, name
        torch.testing.assert_close(leaf.grad, w, atol=0, rtol=0, msg=name)


def test_flash_function_takes_a_strided_output_grad():
    """The LM hands the backward ``dO`` as a transposed view; the
    Function makes it contiguous and the grads do not change."""
    q, k, v, w = (torch.from_numpy(x) for x in _inputs(1, 3, 9, 16, seed=2))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = fa.FlashAttention.apply(*leaves)
    (out.transpose(1, 2) * w.transpose(1, 2)).sum().backward()
    refs = [x.clone().requires_grad_() for x in (q, k, v)]
    (torch_ra.reference_attention(*refs) * w).sum().backward()
    for leaf, ref in zip(leaves, refs):
        torch.testing.assert_close(leaf.grad, ref.grad, atol=1e-5, rtol=0)


@pytest.mark.parametrize("bad", ["shape", "lse"])
def test_bwd_wrapper_rejects_mismatched_inputs(bad):
    x = torch.zeros((1, 2, 8, 16))
    lse = torch.zeros((1, 2, 8))
    with pytest.raises(ValueError):
        if bad == "shape":
            fa.flash_attention_bwd(x, x, x, x, lse, torch.zeros((1, 2, 9, 16)))
        else:
            fa.flash_attention_bwd(x, x, x, x, lse[:, :1], x)
