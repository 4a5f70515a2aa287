"""``kubernetes_tpu_torch.entry.dryrun_multichip`` on the CPU, over gloo,
against the reference.

``dryrun_multichip(n, device="cpu")`` at n = 3 (dense ``dp 3`` at head
dim 48; MoE ``dp 3``), n = 4 (dense ``tp 2 x sp 2``; MoE ``ep 2 x sp
2``) and n = 8 (dense ``fsdp 2 x sp 2 x tp 2``; MoE ``dp 2 x ep 2 x sp
2``), each rank a process of its own: both losses
finite, positive and the same on every rank, every mesh coordinate
taken once, and each loss against the reference's one-device
``loss_fn`` on the same params and batch (``entry.dryrun_inputs``
carried across through numpy): the dense LM with ``attn_impl="local"``,
the MoE with its ring attention replaced by its plain attention (the
reference's ring fails under the installed jax; ROADMAP queue 3), both
in the configs' bf16 compute, within 1e-2 (the gaps measured on the CPU are at
most 1.4e-3, rounding at the ranks' shapes). The
configs are the reference's (``__graft_entry__.dryrun_multichip``),
and without ``n`` CUDA devices the default device raises.
"""
import math

import jax
import jax.numpy as jnp
import pytest

from kubernetes_tpu.workloads import lm as jlm
from kubernetes_tpu.workloads import moe as jmoe
from kubernetes_tpu.workloads import ring_attention as jra
from kubernetes_tpu.workloads.sharding import (default_axis_sizes,
                                               make_mesh)
from kubernetes_tpu_torch import entry
from kubernetes_tpu_torch.workloads import lm as tlm

COUNTS = (3, 4, 8)
#: Losses in bf16 compute against the reference's, absolute.
BF16_ATOL = 1e-2


@pytest.fixture(scope="module")
def runs():
    """{n: the ranks' results of dryrun_multichip(n, device="cpu")}."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        return {n: entry.dryrun_multichip(n, device="cpu", timeout=300)
                for n in COUNTS}


def _numpy(tree):
    return tlm._tree_map(lambda x: x.numpy(), tree)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 16])
def test_configs_are_the_reference(n):
    run = entry.dryrun_config(n)
    sizes = default_axis_sizes(n)
    width = max(sizes.values())
    assert run.sizes == sizes
    cfg = run.cfg
    assert (cfg.vocab, cfg.d_model, cfg.n_layers, cfg.n_heads, cfg.d_ff) \
        == (64, 32 * width, 2, 2 * sizes["tp"], 64 * width)
    assert cfg.attn_impl == "ring"
    if n & (n - 1) == 0:  # up to 16 devices: every axis 1 or 2
        assert cfg.head_dim == 16
    else:  # an odd factor: 48 at 3, 24 at 6
        assert cfg.head_dim == {3: 48, 6: 24}[n]
    assert (run.batch, run.seq) == (2 * sizes["dp"] * sizes["fsdp"],
                                    16 * sizes["sp"])
    ep = 2 if n % 2 == 0 else 1
    sp = 2 if n % 4 == 0 else 1
    assert run.moe_sizes == dict(dp=n // (ep * sp), ep=ep, sp=sp, tp=1)
    m = run.moe_cfg
    assert (m.vocab, m.d_model, m.n_layers, m.n_heads, m.d_ff, m.n_experts,
            m.top_k) == (64, 32, 1, 2, 64, 2 * ep, 2)
    assert (run.moe_batch, run.moe_seq) == (2 * (n // sp), 8 * sp)


@pytest.mark.parametrize("n", COUNTS)
def test_every_rank_steps_with_one_loss(runs, n):
    ranks = runs[n]
    assert [r["rank"] for r in ranks] == list(range(n))
    for key in ("loss", "moe_loss"):
        values = {r[key] for r in ranks}
        assert len(values) == 1, (key, values)
        value = values.pop()
        assert math.isfinite(value) and value > 0
    for key in ("coordinate", "moe_coordinate"):
        assert len({tuple(r[key].values()) for r in ranks}) == n
    # The plain versions on the CPU launch no kernel.
    assert all(not any(r["launches"].values()) for r in ranks)


@pytest.mark.parametrize("n", COUNTS)
def test_dense_loss_is_the_reference_on_one_device(runs, n):
    run = entry.dryrun_config(n)
    inputs = entry.dryrun_inputs(run, "cpu")
    cfg = run.cfg
    jcfg = jlm.LMConfig(vocab=cfg.vocab, d_model=cfg.d_model,
                        n_layers=cfg.n_layers, n_heads=cfg.n_heads,
                        d_ff=cfg.d_ff, attn_impl="local")
    want = jlm.loss_fn(_numpy(inputs["params"]),
                       jnp.asarray(inputs["batch"].numpy()), jcfg,
                       make_mesh(jax.devices()[:1]))
    assert abs(runs[n][0]["loss"] - float(want)) < BF16_ATOL


@pytest.mark.parametrize("n", COUNTS)
def test_moe_loss_is_the_reference_on_one_device(runs, n, monkeypatch):
    monkeypatch.setattr(jmoe, "ring_attention",
                        lambda q, k, v, mesh, **_: jra.reference_attention(
                            q, k, v))
    run = entry.dryrun_config(n)
    inputs = entry.dryrun_inputs(run, "cpu")
    m = run.moe_cfg
    jcfg = jmoe.MoEConfig(vocab=m.vocab, d_model=m.d_model,
                          n_layers=m.n_layers, n_heads=m.n_heads,
                          d_ff=m.d_ff, n_experts=m.n_experts, top_k=m.top_k)
    want = jmoe.loss_fn(_numpy(inputs["moe_params"]),
                        jnp.asarray(inputs["moe_batch"].numpy()), jcfg,
                        jmoe.make_moe_mesh(jax.devices()[:1]))
    assert abs(runs[n][0]["moe_loss"] - float(want)) < BF16_ATOL


def test_without_the_cards_the_default_device_raises():
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.dryrun_multichip(64)
