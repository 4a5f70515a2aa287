"""The port's LM with params sharded over fsdp and heads/FFN columns over
tp, over gloo, against the reference on one device and against itself in
one process, on the CPU.

Meshes: ``fsdp 2`` and ``tp 2`` (two ranks), ``fsdp 2 x tp 2``, ``sp 2 x
tp 2`` and ``dp 2 x tp 2`` (four ranks), at the small widths of
``tests/test_torch_lm_sp.py`` (2 heads: one a rank under tp), params
carried from the reference's ``init_params`` by ``params_from_jax`` and
sharded by ``lm.param_specs``. At each:

- every rank's block of the logits against the reference's one-device
  ``lm.forward`` with ``attn_impl="local"``: f32 compute at 1e-4, bf16
  at 5e-2;
- two f32 train steps on the global batches against one process: the
  losses within rtol 1e-5 (also with ``attention=`` the ring's plain
  version, the f32 witness's step on the card), each rank's block of
  every first-step
  gradient within 1e-5 of that leaf's largest (a gradient summed over a
  wrong set of ranks is off by a factor of 2 or more), the blocks of the
  params after both steps by the AdamW rule of
  ``tests/test_torch_train.py``;
- ``init_sharded`` (bf16 params): each block the one ``sharding.block``
  takes of the whole ``init_params`` of the same seed, the f32 master
  equal to it, the moments zero; and ``gather_params`` of
  ``shard_params`` the whole tree, bit for bit.

Besides: ``param_specs`` is the reference's, and its blocks are what the
reference's ``init_sharded`` puts on each device of a mesh of 4 and 8
JAX CPU devices; at ``sp 2 x tp 2`` each tp coordinate has its own sp
ring, and ``ring_attention.gathered_attention`` (the ring's plain
version) is the ring's output and gradients; an ``lm.train`` save at
``fsdp 2 x tp 2`` holds the whole state in the one-device format, and a
gang at ``dp 2`` resumes it, its loss after 4 steps the unbroken
one-process run's.

The five meshes run as two waves of eight processes, then the resume
gang; each rank is a subprocess waited on with a timeout, its port from
the OS.
"""
import json
import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from kubernetes_tpu.workloads import lm as jlm
from kubernetes_tpu.workloads import sharding as jsharding
from kubernetes_tpu_torch.workloads import checkpoint as ckpt
from kubernetes_tpu_torch.workloads import lm as tlm
from kubernetes_tpu_torch.workloads import sharding

from tests.test_torch_lm_sp import (SMALL, STEPS, _PRELUDE, _flat_torch,
                                    _gangs, _one_process_steps,
                                    reference_logits)
from tests.test_torch_train import LR, _assert_stepped_alike

MESHES = {"fsdp2": dict(fsdp=2), "tp2": dict(tp=2),
          "fsdp2tp2": dict(fsdp=2, tp=2), "sp2tp2": dict(sp=2, tp=2),
          "dp2tp2": dict(dp=2, tp=2)}
WAVES = (("fsdp2", "tp2", "fsdp2tp2"), ("sp2tp2", "dp2tp2"))
#: Steps of the lm.train run saved at fsdp 2 x tp 2, and of the one
#: resumed from it at dp 2.
SAVED, RESUMED = 2, 4

#: A rank of one mesh: the forwards, init_sharded, the round trip, the
#: gradients and STEPS steps; at sp 2 x tp 2 its ring and the plain ring;
#: at fsdp 2 x tp 2 an lm.train run that saves.
_RANK = _PRELUDE + r"""
from kubernetes_tpu_torch.workloads import ring_attention as ra
name, sizes = os.environ["NAME"], json.loads(os.environ["SIZES"])
mesh = sharding.make_mesh(device_type="cpu", **sizes)
forwards(name, mesh)
lr = float(os.environ["LR"])
cfg = config("float32")
specs = lm.param_specs(cfg)
whole = lm.params_from_jax(tree, cfg, device="cpu")
params = sharding.shard_params(mesh, whole, specs)
meta["round_trip"] = all(torch.equal(a, b) for a, b in zip(
    lm._leaves(sharding.gather_params(mesh, params, specs)),
    lm._leaves(whole)))
mixed = config("float32", param_dtype=torch.bfloat16)
blocks, (adam, master) = lm.init_sharded(torch.Generator().manual_seed(5),
                                         mixed, mesh)
meta["moments_zero"] = all(not bool(x.any()) for x in
                           lm._leaves(adam["mu"]) + lm._leaves(adam["nu"]))
meta["master_is_params"] = all(
    m.dtype == torch.float32 and torch.equal(m, p.float())
    for m, p in zip(lm._leaves(master), lm._leaves(blocks)))
def put(prefix, node, path=""):
    if isinstance(node, dict):
        for k, v in node.items():
            put(prefix, v, f"{path}/{k}" if path else k)
    else:
        out[f"{prefix}:{path}"] = node.detach().float().numpy()
put("init", blocks)
_, grads = lm.loss_and_grads(params, torch.from_numpy(data["batch0"]), cfg,
                             mesh=mesh)
put("grad", grads)
opt_state = lm.init_opt_state(params, cfg, lr)
step = lm.make_train_step(cfg, lr, "cpu", mesh=mesh)
meta["losses"] = [float(step(params, opt_state,
                             torch.from_numpy(data[f"batch{n}"]))[2])
                  for n in range(int(os.environ["STEPS"]))]
put("param", params)
# The f32 witness's step: the ring's plain version in place of the ring.
ring = ra.ring_of(mesh)
params = sharding.shard_params(mesh, whole, specs)
witness = lm.make_train_step(
    cfg, lr, "cpu", mesh=mesh,
    attention=lambda q, k, v: ra.gathered_attention(q, k, v, ring))
opt_state = lm.init_opt_state(params, cfg, lr)
meta["witness_losses"] = [
    float(witness(params, opt_state, torch.from_numpy(data[f"batch{n}"]))[2])
    for n in range(int(os.environ["STEPS"]))]
if name == "sp2tp2":
    ring = ra.ring_of(mesh)
    meta["ring"] = [ring.index, ring.next, ring.prev]
    gen = torch.Generator().manual_seed(7)
    q, k, v, do = (sharding.shard(mesh, torch.randn((2, 2, 32, 16),
                                                    generator=gen),
                                  (("dp", "fsdp"), "tp", "sp", None))
                   for _ in range(4))
    got = {}
    for way, fn in (("gathered", ra.gathered_attention),
                    ("ring", ra.ring_apply)):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        o = fn(*leaves, ring)
        o.backward(do)
        got[way] = [o.detach()] + [x.grad for x in leaves]
    meta["gathered_vs_ring"] = max(float((a - b).abs().max()) for a, b in
                                   zip(got["gathered"], got["ring"]))
if name == "fsdp2tp2":
    meta["train"] = lm.train(cfg, steps=int(os.environ["SAVED"]), batch=2,
                             seq=32, lr=lr, ckpt_dir=os.environ["CKPT"],
                             checkpoint_every=int(os.environ["SAVED"]),
                             device="cpu", mesh=mesh)
save()
"""

#: Two ranks at dp 2: lm.train resumed from the fsdp 2 x tp 2 checkpoint.
_RESUME = _PRELUDE + r"""
mesh = sharding.make_mesh(device_type="cpu", dp=2)
meta["train"] = lm.train(config("float32"), steps=int(os.environ["RESUMED"]),
                         batch=2, seq=32, lr=float(os.environ["LR"]),
                         ckpt_dir=os.environ["CKPT"], checkpoint_every=0,
                         device="cpu", mesh=mesh)
save()
"""


def _world(sizes):
    return math.prod(sizes.values())


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    """{mesh name: [(npz, json)] by rank}, and ``"resume"``: two waves of
    eight ranks, then the two resume ranks."""
    tmp = tmp_path_factory.mktemp("lm_fsdp_tp")
    env = dict(LR=str(LR), STEPS=str(STEPS), SAVED=str(SAVED),
               RESUMED=str(RESUMED), CKPT=str(tmp / "ckpt"))
    results = {}
    for wave in WAVES:
        results.update(_gangs(tmp, {
            name: (_RANK, _world(MESHES[name]),
                   dict(env, NAME=name, SIZES=json.dumps(MESHES[name])))
            for name in wave}))
    results.update(_gangs(tmp, {"resume": (_RESUME, 2, env)}))
    results["ckpt"] = tmp / "ckpt"
    return results


def _sizes(name):
    return {**dict.fromkeys(sharding.AXES, 1), **MESHES[name]}


def _spec(specs, path):
    node = specs
    for key in path.split("/"):
        node = node[key]
    return node


def test_param_specs_are_the_reference():
    want = jlm.param_specs(jlm.LMConfig())
    got = tlm.param_specs(tlm.LMConfig())
    assert jax.tree_util.tree_map(tuple, want) == got


@pytest.mark.parametrize("sizes", [dict(fsdp=2, tp=2),
                                   dict(dp=2, fsdp=2, sp=2),
                                   dict(fsdp=2, sp=2, tp=2)])
def test_blocks_are_the_reference_init_sharded_shards(sizes):
    """Each device's shard of every leaf of the reference's
    ``init_sharded`` params (a mesh of JAX CPU devices) is the block
    ``shard_params`` keeps for that coordinate of the same params."""
    full = {**dict.fromkeys(sharding.AXES, 1), **sizes}
    mesh = jsharding.make_mesh(jax.devices()[:_world(full)], **full)
    jcfg = jlm.LMConfig(**SMALL)
    params, _ = jlm.init_sharded(jax.random.PRNGKey(0), jcfg, mesh)
    coords = {dev: dict(zip(sharding.AXES, map(int, idx)))
              for idx, dev in np.ndenumerate(mesh.devices)}
    specs = tlm.param_specs(tlm.LMConfig(**SMALL))
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    for path, leaf in leaves:
        path = "/".join(k.key for k in path)
        whole = torch.from_numpy(np.array(leaf))
        for piece in leaf.addressable_shards:
            got = sharding.block(whole, _spec(specs, path), full,
                                 coords[piece.device])
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(piece.data), path)
    # The blocks do split: a leaf sharded over both axes is a quarter.
    assert NamedSharding(mesh, jlm.param_specs(jcfg)["layers"]["wq"]
                         ).shard_shape((2, 64, 64))[1:] == (
        64 // full["fsdp"], 64 // full["tp"])


@pytest.mark.parametrize("compute,atol", [("float32", 1e-4),
                                          ("bfloat16", 5e-2)])
@pytest.mark.parametrize("name", list(MESHES))
def test_forward_matches_the_reference_on_one_device(gangs, reference_logits,
                                                     name, compute, atol):
    sizes = _sizes(name)
    want = torch.from_numpy(np.array(reference_logits[compute]))
    seen = set()
    for out, meta in gangs[name]:
        coord = meta[name]
        block = sharding.block(want, sharding.ACT_SPEC, sizes, coord)
        assert out[f"{name}:{compute}"].shape == tuple(block.shape)
        np.testing.assert_allclose(out[f"{name}:{compute}"], block.numpy(),
                                   atol=atol, rtol=0)
        seen.add(tuple(coord[a] for a in sharding.AXES))
    assert len(seen) == _world(MESHES[name])  # every block compared


@pytest.fixture(scope="module")
def one_process():
    return _one_process_steps()


@pytest.mark.parametrize("name", list(MESHES))
def test_train_steps_match_one_process(gangs, one_process, name):
    losses, grads, params = one_process
    sizes = _sizes(name)
    specs = tlm.param_specs(tlm.LMConfig(**SMALL))
    for out, meta in gangs[name]:
        np.testing.assert_allclose(meta["losses"], losses, rtol=1e-5)
        coord = meta[name]
        for prefix, whole in (("grad", grads), ("param", params)):
            want = {path: sharding.block(torch.from_numpy(w),
                                         _spec(specs, path), sizes,
                                         coord).numpy()
                    for path, w in _flat_torch(whole).items()}
            got = {k.split(":", 1)[1]: v for k, v in out.items()
                   if k.startswith(prefix + ":")}
            assert got.keys() == want.keys()
            if prefix == "grad":
                for path, w in want.items():
                    np.testing.assert_allclose(
                        got[path], w, rtol=1e-5,
                        atol=1e-5 * np.abs(w).max(), err_msg=path)
            else:
                _assert_stepped_alike([got[p] for p in want],
                                      list(want.values()), 1e-6)


@pytest.mark.parametrize("name", list(MESHES))
def test_steps_with_the_plain_ring_match_one_process(gangs, one_process,
                                                      name):
    """``make_train_step(attention=gathered_attention)``, the card's f32
    witness, steps as one process does."""
    losses = one_process[0]
    for _, meta in gangs[name]:
        np.testing.assert_allclose(meta["witness_losses"], losses, rtol=1e-5)


@pytest.mark.parametrize("name", list(MESHES))
def test_init_sharded_keeps_each_rank_its_blocks(gangs, name):
    cfg = tlm.LMConfig(**SMALL, param_dtype=torch.bfloat16)
    whole = _flat_torch(tlm._tree_map(lambda p: p.float(), tlm.init_params(
        torch.Generator().manual_seed(5), cfg)))
    specs = tlm.param_specs(cfg)
    for out, meta in gangs[name]:
        assert meta["round_trip"] and meta["moments_zero"]
        assert meta["master_is_params"]
        for path, w in whole.items():
            want = sharding.block(torch.from_numpy(w), _spec(specs, path),
                                  _sizes(name), meta[name])
            np.testing.assert_array_equal(out[f"init:{path}"], want.numpy(),
                                          path)


def test_each_tp_coordinate_has_its_own_sp_ring(gangs):
    ranks = gangs["sp2tp2"]
    coord = [meta["sp2tp2"] for _, meta in ranks]
    for r, (_, meta) in enumerate(ranks):
        index, nxt, prev = meta["ring"]
        assert index == coord[r]["sp"]
        for peer in (nxt, prev):
            assert coord[peer]["tp"] == coord[r]["tp"]
            assert coord[peer]["sp"] != coord[r]["sp"]
        assert meta["gathered_vs_ring"] < 1e-5


def test_a_save_at_fsdp2_tp2_resumes_at_dp2(gangs, tmp_path):
    for _, meta in gangs["fsdp2tp2"]:
        got = meta["train"]
        assert (got["final_step"], got["resumed_from"]) == (SAVED, 0)
    # The checkpoint is the whole state, as one device writes it.
    cfg = tlm.LMConfig(**SMALL, compute_dtype=torch.float32)
    state = torch.load(gangs["ckpt"] / str(SAVED - 1) / ckpt.STATE_FILE,
                       weights_only=True)
    whole = tlm.init_params(torch.Generator().manual_seed(0), cfg)
    for got, want in zip(tlm._leaves(state["params"]), tlm._leaves(whole)):
        assert got.shape == want.shape
    for got, want in zip(tlm._leaves(state["opt_state"]["mu"]),
                         tlm._leaves(whole)):
        assert got.shape == want.shape
    unbroken = tlm.train(cfg, steps=RESUMED, batch=2, seq=32, lr=LR,
                         ckpt_dir=str(tmp_path), checkpoint_every=0,
                         device="cpu")
    for _, meta in gangs["resume"]:
        got = meta["train"]
        assert (got["final_step"], got["resumed_from"]) == (RESUMED, SAVED)
        np.testing.assert_allclose(got["loss"], unbroken["loss"], rtol=1e-5)
