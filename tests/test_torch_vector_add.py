"""The port's vector-add payload against the reference's Pallas kernel.

The reference runs its Pallas kernel in interpret mode off TPU; the
port runs its plain version on CPU tensors. Addition is exact in both,
so the results must be equal bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.workloads import vector_add as jax_va
from kubernetes_tpu_torch.workloads import vector_add as torch_va


@pytest.mark.parametrize("n", [1, 7, 4096, 65537])
def test_vector_add_matches_pallas(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(n).astype(np.float32)
    want = np.asarray(jax_va.vector_add(jnp.asarray(x), jnp.asarray(y)))
    got = torch_va.vector_add(torch.from_numpy(x), torch.from_numpy(y))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_vector_add_bf16_matches_pallas():
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal(1000), jnp.bfloat16)
    y = jnp.asarray(rng.standard_normal(1000), jnp.bfloat16)
    want = np.asarray(jax_va.vector_add(x, y).astype(jnp.float32))
    got = torch_va.vector_add(
        torch.tensor(np.asarray(x.astype(jnp.float32))).bfloat16(),
        torch.tensor(np.asarray(y.astype(jnp.float32))).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("n", [1 << 12, 1 << 16])
def test_smoke_test_matches_reference_report(n):
    want = jax_va.smoke_test(n)
    got = torch_va.smoke_test(n, device="cpu")
    assert set(got) == set(want)
    for key in ("ok", "n", "platform"):
        assert got[key] == want[key], key
    assert got["device"] == "cpu"


def test_cpu_tensors_do_not_count_as_launches():
    before = torch_va.launches
    torch_va.vector_add(torch.ones(8), torch.ones(8))
    assert torch_va.launches == before


@pytest.mark.parametrize("y", [torch.ones(9), torch.ones(8, dtype=torch.float64)])
def test_vector_add_rejects_mismatched_inputs(y):
    with pytest.raises(ValueError):
        torch_va.vector_add(torch.ones(8), y)


def test_smoke_test_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_va.smoke_test(16)
    assert torch_va.smoke_test(16, device="cpu")["platform"] == "cpu"
