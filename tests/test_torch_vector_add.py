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


@pytest.mark.parametrize("n", [1, 7, 4097, 65537])
def test_vector_add_bf16_ragged_matches_pallas(n):
    """bf16 at lengths that leave a ragged tail behind the kernel's 8-wide
    vectors (and a single element): both sides add in f32 and round once."""
    rng = np.random.default_rng(100 + n)
    x = jnp.asarray(rng.standard_normal(n), jnp.bfloat16)
    y = jnp.asarray(rng.standard_normal(n), jnp.bfloat16)
    want = np.asarray(jax_va.vector_add(x, y).astype(jnp.float32))
    got = torch_va.vector_add(
        torch.tensor(np.asarray(x.astype(jnp.float32))).bfloat16(),
        torch.tensor(np.asarray(y.astype(jnp.float32))).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("x_off,y_off", [(1, 1), (1, 2)])
def test_vector_add_offset_views_match_pallas(dtype, x_off, y_off):
    """Contiguous views at an odd offset (``x[1:]``), also at two
    different offsets, which the kernel takes on its unaligned path."""
    n = 4099
    rng = np.random.default_rng(7)
    xs, ys = (torch.from_numpy(rng.standard_normal(n + off)
                               .astype(np.float32)).to(dtype)
              for off in (x_off, y_off))
    x, y = xs[x_off:], ys[y_off:]
    assert x.is_contiguous() and y.is_contiguous()
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = np.asarray(jax_va.vector_add(
        jnp.asarray(x.float().numpy(), jdt),
        jnp.asarray(y.float().numpy(), jdt)).astype(jnp.float32))
    got = torch_va.vector_add(x, y)
    assert got.dtype == dtype and got.shape == (n,)
    np.testing.assert_array_equal(got.float().numpy(), want)


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


@pytest.mark.parametrize("x,y,match", [
    (torch.ones(8), torch.ones(8, device="meta"), "matching tensors"),
    (torch.ones(8, device="meta"), torch.ones(8, device="meta"),
     "cuda or cpu"),
    (torch.ones(2, 4), torch.ones(8), "matching tensors"),
    (torch.ones(8, dtype=torch.bfloat16), torch.ones(8), "matching tensors"),
], ids=["cpu-meta", "meta", "shape", "dtype"])
def test_vector_add_still_rejects_what_it_rejected(x, y, match):
    """The checks that run before any launch, reached without a card:
    mismatched tensors and a device that is neither cuda nor cpu."""
    before = torch_va.launches
    with pytest.raises(ValueError, match=match):
        torch_va.vector_add(x, y)
    assert torch_va.launches == before


def test_vector_add_kernels_are_bound_launchers():
    """Each dtype the kernel takes has one launcher of the vector_add
    library, the f32 and bf16 entry points of ``csrc/vector_add.cu``."""
    from kubernetes_tpu_torch.kernels import build
    assert set(torch_va.KERNELS) == {torch.float32, torch.bfloat16}
    for dtype, symbol in ((torch.float32, "vector_add_f32"),
                          (torch.bfloat16, "vector_add_bf16")):
        kernel = torch_va.KERNELS[dtype]
        assert isinstance(kernel, build.Kernel)
        assert (kernel.library, kernel.symbol) == ("vector_add", symbol)


def test_smoke_test_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_va.smoke_test(16)
    assert torch_va.smoke_test(16, device="cpu")["platform"] == "cpu"
