"""Head dim 16 on the CPU: the configs that send it, and the wrapper's
plain path at it against the reference.

The reference's TrainJob controller sets no ``LM_*`` env, so the
trainer's default LM (2 heads of a 32-wide model) is what a plain
``MODEL=lm`` TrainJob trains, with the flash kernels on the card; the
dense and MoE configs of ``__graft_entry__.dryrun_multichip`` have head
dim 16 too. Each must be a head dim the kernels take. The kernels
themselves run only on the card (``tests/test_torch_cuda.py``, D 16 at
the tile and TMA edges).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.workloads import moe as jax_moe
from kubernetes_tpu.workloads import ring_attention as jax_ra
from kubernetes_tpu.workloads.sharding import default_axis_sizes
from kubernetes_tpu_torch.workloads import flash_attention as fa
from kubernetes_tpu_torch.workloads import trainer


def test_trainer_default_lm_has_a_kernel_head_dim(monkeypatch):
    for name in ("LM_VOCAB", "LM_D_MODEL", "LM_LAYERS", "LM_HEADS",
                 "LM_D_FF", "LM_ATTN"):
        monkeypatch.delenv(name, raising=False)
    cfg = trainer.lm_config(torch.device("cuda"))
    assert cfg.attn_impl == "flash"
    assert cfg.head_dim == 16 and cfg.head_dim in fa.HEAD_DIMS


@pytest.mark.parametrize("n_devices", [1, 2, 4, 8, 16])
def test_graft_entry_dense_config_has_a_kernel_head_dim(n_devices):
    """``__graft_entry__.dryrun_multichip``'s dense LM: d_model
    32 * max(sizes), 2 * tp heads."""
    sizes = default_axis_sizes(n_devices)
    head_dim = 32 * max(sizes.values()) // (2 * sizes["tp"])
    assert head_dim in fa.HEAD_DIMS


def test_graft_entry_moe_config_has_a_kernel_head_dim():
    mcfg = jax_moe.MoEConfig(vocab=64, d_model=32, n_layers=1, n_heads=2,
                             d_ff=64, n_experts=4, top_k=2)
    assert mcfg.head_dim == 16 and mcfg.head_dim in fa.HEAD_DIMS


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
    before = fa.launches
    o, lse = fa.flash_attention_fwd(*map(torch.from_numpy, (q, k, v)))
    assert fa.launches == before
    np.testing.assert_allclose(o.numpy(), want, atol=1e-5, rtol=0)
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64),
                  k.astype(np.float64)) / 4.0
    t = shape[2]
    s = np.where(np.tril(np.ones((t, t), bool)), s, -np.inf)
    m = s.max(-1, keepdims=True)
    lse64 = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), lse64, atol=1e-5, rtol=0)

