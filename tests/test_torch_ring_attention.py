"""The port's ring attention against the reference's plain attention, on
the CPU.

- The ring over gloo, four ranks: at ``sp = 4``, and on a ``dp = 2 x
  sp = 2`` mesh (two rings of two, whose peers' global ranks are not
  their ranks on the ring), on [2, 2, 32, 8] f32 inputs made with numpy
  (the reference test's shape, ``tests/workloads/test_workloads.py``),
  against JAX ``reference_attention`` of the whole sequence, and its
  gradients against ``jax.vjp`` of the same: 1e-5, the reference test's
  bound (f32, sums in another order). The reference ``ring_attention``
  itself cannot run on this host (ROADMAP queue 3).
- The loopback, one process computing every rank's share from
  all blocks, equal bit for bit to the gloo ring (both run in the rank
  processes, on the same thread count).
- The non-causal plain forward and backward, which the ring runs for a
  block before its queries, against a plain unmasked softmax (JAX), and
  the causal ones unchanged by the flag; 1e-5.

The four ranks are one gloo group of subprocesses, started once for the
module and waited on with a timeout; their port comes from the OS.
"""
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.workloads import ring_attention as jax_ra
from kubernetes_tpu_torch.workloads import flash_attention as fa
from kubernetes_tpu_torch.workloads import ring_attention as torch_ra
from kubernetes_tpu_torch.workloads import sharding

from tests.test_torch_rendezvous import ROOT, free_port, run_gang

SHAPE = (2, 2, 32, 8)
#: [B, H, T, D]: batch over (dp, fsdp), sequence over sp.
QKV_SPEC = (("dp", "fsdp"), None, "sp", None)
MESHES = {"sp4": dict(sp=4), "dp2sp2": dict(dp=2, sp=2)}

#: One rank: for each mesh, the ring forward and backward of its blocks
#: under autograd, and every rank's share by the loopback; all
#: saved to OUT<rank>.npz, the mesh coordinates to OUT<rank>.json.
_RANK = r"""
import json, os
import numpy as np
import torch
from torch import distributed as dist
from kubernetes_tpu_torch.workloads import rendezvous, sharding
from kubernetes_tpu_torch.workloads import ring_attention as ra
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD"])
rendezvous.init_process_group("127.0.0.1", int(os.environ["PORT"]), rank,
                              world, "gloo", 60.0, "127.0.0.1")
data = np.load(os.environ["IN"])
spec = tuple(tuple(a) if isinstance(a, list) else a
             for a in json.loads(os.environ["SPEC"]))
out, coords = {}, {}
for name, sizes in json.loads(os.environ["MESHES"]).items():
    mesh = sharding.make_mesh(device_type="cpu", **sizes)
    coords[name] = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    q, k, v, do = (sharding.shard(mesh, torch.from_numpy(data[n]), spec)
                   for n in ("q", "k", "v", "do"))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o = ra.ring_attention(*leaves, mesh)
    o.backward(do)
    out[f"{name}:o"] = o.detach().numpy()
    for n, x in zip(("dq", "dk", "dv"), leaves):
        out[f"{name}:{n}"] = x.grad.numpy()
    # Every rank's share of this rank's ring, by the loopback.
    sp, i = sizes["sp"], coords[name]["sp"]
    blocks = [list(x.chunk(sp, dim=2)) for x in
              (sharding.shard(mesh, torch.from_numpy(data[n]),
                              (spec[0], None, None, None))
               for n in ("q", "k", "v", "do"))]
    fwd = ra.loopback_forward(*blocks[:3])
    bwd = ra.loopback_backward(*blocks[:3], [f[0] for f in fwd],
                               [f[1] for f in fwd], blocks[3])
    out[f"{name}:loop_o"] = fwd[i][0].numpy()
    for n, g in zip(("dq", "dk", "dv"), bwd[i]):
        out[f"{name}:loop_{n}"] = g.numpy()
np.savez(os.environ["OUT"] + f"{rank}.npz", **out)
with open(os.environ["OUT"] + f"{rank}.json", "w") as f:
    json.dump(coords, f)
dist.destroy_process_group()
"""


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return {n: rng.standard_normal(SHAPE).astype(np.float32)
            for n in ("q", "k", "v", "do")}


@pytest.fixture(scope="module")
def ring_run(tmp_path_factory):
    """The four ranks' results: ``[(npz, coords)]`` by rank, and the
    inputs."""
    tmp = tmp_path_factory.mktemp("ring")
    data = _inputs()
    np.savez(tmp / "in.npz", **data)
    port = free_port()
    base = {k: v for k, v in os.environ.items()
            if not k.startswith(("TPU_", "KTPU_", "POD_"))}
    envs = [{**base, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1",
             "RANK": str(r), "WORLD": "4", "PORT": str(port),
             "IN": str(tmp / "in.npz"), "OUT": str(tmp / "out"),
             "SPEC": json.dumps(QKV_SPEC), "MESHES": json.dumps(MESHES)}
            for r in range(4)]
    for rc, out in run_gang([sys.executable, "-c", _RANK], envs):
        assert rc == 0, out
    ranks = []
    for r in range(4):
        with open(tmp / f"out{r}.json") as f:
            ranks.append((dict(np.load(tmp / f"out{r}.npz")), json.load(f)))
    return ranks, data


def _jax_attention_and_grads(data):
    q, k, v, do = (jnp.asarray(data[n]) for n in ("q", "k", "v", "do"))
    o, vjp = jax.vjp(jax_ra.reference_attention, q, k, v)
    return {"o": np.asarray(o),
            **{n: np.asarray(g) for n, g in zip(("dq", "dk", "dv"), vjp(do))}}


def _block(x, name, coord):
    sizes = {**dict.fromkeys(sharding.AXES, 1), **MESHES[name]}
    return sharding.block(torch.from_numpy(np.array(x)), QKV_SPEC, sizes,
                          coord).numpy()


@pytest.mark.parametrize("name", list(MESHES))
@pytest.mark.parametrize("what", ["o", "dq", "dk", "dv"])
def test_ring_matches_jax_reference_attention(ring_run, name, what):
    ranks, data = ring_run
    want = _jax_attention_and_grads(data)[what]
    for out, coords in ranks:
        got = out[f"{name}:{what}"]
        assert got.shape == (SHAPE[0] // MESHES[name].get("dp", 1), SHAPE[1],
                             SHAPE[2] // MESHES[name]["sp"], SHAPE[3])
        np.testing.assert_allclose(got, _block(want, name, coords[name]),
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", list(MESHES))
@pytest.mark.parametrize("what", ["o", "dq", "dk", "dv"])
def test_loopback_equals_the_gloo_ring(ring_run, name, what):
    ranks, _ = ring_run
    for out, _ in ranks:
        np.testing.assert_array_equal(out[f"{name}:loop_{what}"],
                                      out[f"{name}:{what}"])


def test_ring_meshes_cover_every_block(ring_run):
    """Each mesh puts every (dp, sp) coordinate on exactly one rank, so
    the comparisons above cover the whole sequence and batch."""
    ranks, _ = ring_run
    for name, sizes in MESHES.items():
        seen = sorted((c[name]["dp"], c[name]["sp"]) for _, c in ranks)
        assert seen == sorted((d, s) for d in range(sizes.get("dp", 1))
                              for s in range(sizes["sp"])), name


def _unmasked(q, k, v):
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k) / (q.shape[-1] ** 0.5)
    return jnp.einsum("bhqk,bhkd->bhqd", jax.nn.softmax(s, axis=-1), v)


@pytest.mark.parametrize("t", [1, 17, 129])
def test_non_causal_plain_matches_an_unmasked_softmax(t):
    rng = np.random.default_rng(t)
    q, k, v, do = (rng.standard_normal((2, 3, t, 16)).astype(np.float32)
                   for _ in range(4))
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    want_o, vjp = jax.vjp(_unmasked, jq, jk, jv)
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64),
                  k.astype(np.float64)) / 4.0
    m = s.max(-1, keepdims=True)
    want_lse = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = fa.flash_attention_fwd(tq, tk, tv, causal=False)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=1e-5, rtol=0)
    got = fa.flash_attention_bwd(tq, tk, tv, o, lse, tdo, causal=False)
    for g, w in zip(got, vjp(jdo)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0)


def test_f32_output_is_the_unrounded_output():
    """``out_dtype=torch.float32`` on bf16 inputs: the same f32 arithmetic,
    not rounded at the end; rounding it gives the bf16 output."""
    rng = np.random.default_rng(4)
    q, k, v, do = (torch.from_numpy(
        rng.standard_normal((1, 2, 24, 16)).astype(np.float32)).to(
            torch.bfloat16) for _ in range(4))
    for causal in (True, False):
        o, lse = fa.flash_attention_fwd(q, k, v, causal)
        o32, lse32 = fa.flash_attention_fwd(q, k, v, causal, torch.float32)
        assert o32.dtype == torch.float32 and torch.equal(lse, lse32)
        assert torch.equal(o32.to(torch.bfloat16), o)
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal,
                                     torch.float32)
        for g, g16 in zip(got, fa.flash_attention_bwd(q, k, v, o, lse, do,
                                                      causal)):
            assert g.dtype == torch.float32
            assert torch.equal(g.to(torch.bfloat16), g16)
    with pytest.raises(ValueError, match="out_dtype"):
        fa.flash_attention_fwd(q, k, v, out_dtype=torch.float16)


def test_causal_flag_default_is_the_causal_path():
    rng = np.random.default_rng(3)
    q, k, v, do = (torch.from_numpy(
        rng.standard_normal((1, 2, 40, 16)).astype(np.float32))
        for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v)
    o_c, lse_c = fa.flash_attention_fwd(q, k, v, causal=True)
    assert torch.equal(o, o_c) and torch.equal(lse, lse_c)
    assert torch.equal(o, torch_ra.reference_attention(q, k, v))
    for g, g_c in zip(fa.flash_attention_bwd(q, k, v, o, lse, do),
                      fa.flash_attention_bwd(q, k, v, o, lse, do, True)):
        assert torch.equal(g, g_c)


def test_one_member_ring_is_one_causal_block():
    """Without a mesh the ring is the causal flash path: the same output
    and, through autograd, the same gradients as ``FlashAttention``."""
    data = _inputs(seed=1)
    leaves = [torch.from_numpy(data[n]).requires_grad_()
              for n in ("q", "k", "v")]
    o = torch_ra.ring_attention(*leaves, None)
    o.backward(torch.from_numpy(data["do"]))
    ref = [torch.from_numpy(data[n]).requires_grad_() for n in ("q", "k", "v")]
    o_ref = fa.FlashAttention.apply(*ref)
    o_ref.backward(torch.from_numpy(data["do"]))
    assert torch.equal(o, o_ref)
    for a, b in zip(leaves, ref):
        assert torch.equal(a.grad, b.grad)


@pytest.mark.parametrize("sp", [2, 4])
def test_loopback_launches_by_block(sp, monkeypatch):
    """Rank i launches i + 1 forward and i + 1 backward blocks (its
    diagonal and those before it): sp(sp+1)/2 of each over the ring,
    one causal per rank, every one with f32 outputs."""
    calls = []
    real_fwd, real_bwd = fa.flash_attention_fwd, fa.flash_attention_bwd

    def fwd(*args, causal=True, **kwargs):
        calls.append(("fwd", causal, kwargs.get("out_dtype")))
        return real_fwd(*args, causal=causal, **kwargs)

    def bwd(*args, causal=True, **kwargs):
        calls.append(("bwd", causal, kwargs.get("out_dtype")))
        return real_bwd(*args, causal=causal, **kwargs)
    monkeypatch.setattr(fa, "flash_attention_fwd", fwd)
    monkeypatch.setattr(fa, "flash_attention_bwd", bwd)
    data = _inputs(seed=2)
    blocks = [list(torch.from_numpy(data[n]).chunk(sp, dim=2))
              for n in ("q", "k", "v", "do")]
    out = torch_ra.loopback_forward(*blocks[:3])
    torch_ra.loopback_backward(*blocks[:3], [o for o, _ in out],
                               [lse for _, lse in out], blocks[3])
    for kind in ("fwd", "bwd"):
        assert calls.count((kind, True, torch.float32)) == sp
        assert calls.count((kind, False, torch.float32)) == sp * (sp - 1) // 2
    assert len(calls) == sp * (sp + 1)
    o = torch.cat([o for o, _ in out], dim=2)
    want = _jax_attention_and_grads(data)["o"]
    np.testing.assert_allclose(o.numpy(), want, atol=1e-5, rtol=0)
