"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: each test skips without a CUDA device (decided inside
the fixture, never at import). This file imports no JAX, so it runs on a
GPU machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: vector add is exact (both add in f32 and round once); the
flash kernel's ``o`` within 1e-2 + 2^-6 |o| (both round ``o`` to bf16,
the kernel also rounds P to bf16), its ``lse`` within 1e-3 (f32 in
both, sums in another order).
"""
import dataclasses

import pytest
import torch

from kubernetes_tpu_torch.workloads import flash_attention as fa
from kubernetes_tpu_torch.workloads import lm
from kubernetes_tpu_torch.workloads import vector_add as va
from kubernetes_tpu_torch.workloads.ring_attention import (
    reference_attention_with_lse)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("n", [1, 255, 257, 100_003])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vector_add_kernel_is_exact(gen, n, dtype):
    x = torch.randn(n, generator=gen, device="cuda").to(dtype)
    y = torch.randn(n, generator=gen, device="cuda").to(dtype)
    before = va.launches
    out = va.vector_add(x, y)
    assert va.launches == before + 1
    assert torch.equal(out, x + y)


def test_vector_add_kernel_rejects_what_it_does_not_take(gen):
    with pytest.raises(TypeError):
        va.vector_add(torch.ones(4, device="cuda", dtype=torch.float64),
                      torch.ones(4, device="cuda", dtype=torch.float64))
    x = torch.ones(4, 4, device="cuda")
    with pytest.raises(ValueError):
        va.vector_add(x.T, x.T)


@pytest.mark.parametrize("shape", [
    (1, 1, 1, 32), (1, 2, 63, 32), (2, 1, 64, 64), (1, 3, 129, 128),
    (2, 2, 200, 64), (1, 1, 1000, 128)])
def test_flash_kernel_matches_plain(gen, shape):
    q, k, v = (torch.randn(shape, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    before = fa.launches
    o, lse = fa.flash_attention_fwd(q, k, v)
    assert fa.launches == before + 1
    o_ref, lse_ref = reference_attention_with_lse(q, k, v)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    torch.testing.assert_close(o.float(), o_ref.float(), atol=1e-2,
                               rtol=2 ** -6)
    torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=0)


def test_flash_kernel_rejects_what_it_does_not_take(gen):
    q = torch.zeros((1, 1, 8, 32), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        fa.flash_attention_fwd(q.float(), q.float(), q.float())
    bad_d = torch.zeros((1, 1, 8, 48), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_fwd(bad_d, bad_d, bad_d)
    t = torch.zeros((1, 8, 2, 32), device="cuda",
                    dtype=torch.bfloat16).transpose(1, 2)
    assert not t.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_fwd(t, t, t)


def test_lm_flash_forward_matches_local(gen):
    """Small LM on the card: the kernel path against plain attention,
    at the reference tests' bf16 bound (5e-2)."""
    cfg = lm.LMConfig(vocab=128, d_model=128, n_layers=2, n_heads=4,
                      d_ff=256, attn_impl="flash")
    params = lm.init_params(gen, cfg)
    tokens = lm.synthetic_batch(gen, cfg, 2, 97)[:, :-1]
    before = fa.launches
    got = lm.make_forward(cfg)(params, tokens)
    assert fa.launches == before + cfg.n_layers
    want = lm.make_forward(dataclasses.replace(cfg, attn_impl="local"))(
        params, tokens)
    torch.testing.assert_close(got, want, atol=5e-2, rtol=0)
