"""The port's MoE expert-parallel over gloo, against itself in one
process, on the CPU.

The invariant: at any ``(dp, ep, sp, tp)`` mesh the forward logits (each
rank's block), the aux and the loss, and every gradient (each rank's
block of each leaf, under ``param_specs``, against the matching block of
the one-process gradient) equal the one-process forward and step on the
global batch, within 1e-5 (relative to each leaf's largest gradient: the
ranks sum in another order). Meshes: ``ep 2`` (two ranks), ``dp 2 x ep
2``, ``ep 2 x sp 2`` and ``ep 2 x tp 2`` (four ranks each), at
``MoEConfig()`` widths with f32 compute, params from the reference's
``init_params``. At ``ep 2 x tp 2`` each rank holds half the heads and
half of each expert's FFN columns.

Three cases at every mesh:

- ``default``: the reference's ``init_params``;
- ``lopsided``: the same params with one direction ``u`` added to every
  embedding row and to expert 0's router column, so that most tokens
  pick expert 0 first and it overflows. Per-rank capacity (``N / ranks``
  tokens in place of ``N``) or a mean of per-rank aux losses would give
  another answer here; the test shows that they do, on the one-process
  model at ep 2's row blocks, so the mesh's agreement is not luck;
- ``tight``: capacity factor 0.25 (``C = N / 8``): every expert's buffer
  fills before the last ranks' tokens reach it, so the tokens that drop
  lie across rank boundaries, at ep 2 x sp 2 between sp segments of one
  row too; a fill counted per rank, or in rank order rather than global
  token order (row, then position), keeps other tokens. The test shows
  that at layer 0 some experts are full within ep 2's first row block
  while the second block's tokens still land in the others.

Then two AdamW steps at ``ep 2`` against one process (losses within
1e-5; params by the AdamW rule of ``tests/test_torch_train.py``); three
in bf16 against one process that rounds each rank's share of the dense
gradients as the mesh does (``perf/moe_rounding.py``); and the
refusals: experts that do not split over ep raise ``ValueError``; ``tp =
2``, once refused, runs and matches. The ep 2 x tp 2 mesh's logits are
also held against the reference's forward (its ring attention replaced
by its plain attention, as ``tests/test_torch_moe.py`` does).

The four gangs run one after another, as subprocesses waited on with a
timeout; their ports come from the OS.
"""
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from kubernetes_tpu.workloads import moe as jmoe
from kubernetes_tpu_torch.perf import moe_rounding
from kubernetes_tpu_torch.workloads import moe as tmoe
from kubernetes_tpu_torch.workloads import sharding
from kubernetes_tpu_torch.workloads.ring_attention import reference_attention

from tests.test_torch_rendezvous import ROOT, free_port, run_gang
from tests.test_torch_train import LR, _assert_stepped_alike

B, T = 4, 32
STEPS = 2
#: bf16 train steps of the ep 2 gang on one batch, as the card's moe_ep
#: phase takes them.
BF16_STEPS = 3
MESHES = {"ep2": dict(ep=2), "dp2ep2": dict(dp=2, ep=2),
          "ep2sp2": dict(ep=2, sp=2), "ep2tp2": dict(ep=2, tp=2)}
CASES = {"default": ("default", {}), "lopsided": ("lopsided", {}),
         "tight": ("default", {"capacity_factor": 0.25})}

#: A rank of a gloo gang: params by case (IN.npz, "<params>:<path>"),
#: tokens and batches; results to OUT<rank>.npz and OUT<rank>.json.
_RANK = r"""
import json, os
import numpy as np
import torch
from torch import distributed as dist
from kubernetes_tpu_torch.workloads import moe, rendezvous
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD"])
rendezvous.init_process_group("127.0.0.1", int(os.environ["PORT"]), rank,
                              world, "gloo", 60.0, "127.0.0.1")
data = np.load(os.environ["IN"])
def tree(prefix):
    out = {}
    for key in data.files:
        if key.startswith(prefix + ":"):
            *parents, leaf = key.split(":", 1)[1].split("/")
            node = out
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    return out
def config(**kw):
    return moe.MoEConfig(compute_dtype=torch.float32, **kw)
sizes = json.loads(os.environ["SIZES"])
mesh = moe.make_moe_mesh(device_type="cpu", **sizes)
out = {}
meta = {"coord": dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))}
tokens, batch = (torch.from_numpy(data[k]) for k in ("tokens", "batch0"))
for case, (prefix, kw) in json.loads(os.environ["CASES"]).items():
    cfg = config(**kw)
    params = moe.shard_params(moe.params_from_jax(tree(prefix), cfg, "cpu"),
                              cfg, mesh)
    logits, aux = moe.make_forward(cfg, "cpu", mesh)(params, tokens)
    out[f"{case}:logits"] = logits.numpy()
    meta[f"{case}:aux"] = float(aux)
    loss, grads = moe.loss_and_grads(params, batch, cfg, mesh)
    meta[f"{case}:loss"] = float(loss)
    for path, g in zip(moe._paths(grads), moe._leaves(grads)):
        out[f"{case}:grad:{path}"] = g.numpy()
if os.environ.get("STEPS"):
    cfg = config()
    params = moe.shard_params(
        moe.params_from_jax(tree("default"), cfg, "cpu"), cfg, mesh)
    opt_state = moe.make_optimizer(float(os.environ["LR"])).init(params)
    step = moe.make_train_step(cfg, mesh, float(os.environ["LR"]), "cpu")
    losses = []
    for n in range(int(os.environ["STEPS"])):
        params, opt_state, loss = step(params, opt_state,
                                       torch.from_numpy(data[f"batch{n}"]))
        losses.append(float(loss))
    meta["losses"] = losses
    for path, p in zip(moe._paths(params), moe._leaves(params)):
        out[f"param:{path}"] = p.numpy()
    cfg = moe.MoEConfig()  # bf16 compute
    params = moe.shard_params(
        moe.params_from_jax(tree("default"), cfg, "cpu"), cfg, mesh)
    opt_state = moe.make_optimizer(float(os.environ["LR"])).init(params)
    step = moe.make_train_step(cfg, mesh, float(os.environ["LR"]), "cpu")
    batch = torch.from_numpy(data["batch0"])
    meta["bf16_losses"] = [float(step(params, opt_state, batch)[2])
                           for _ in range(int(os.environ["BF16_STEPS"]))]
refusals = {}
def refused(name, fn):
    try:
        fn()
        refusals[name] = None
    except (ValueError, NotImplementedError) as exc:
        refusals[name] = [type(exc).__name__, str(exc)]
if sizes.get("ep") == 2:
    refused("experts_3_ep2", lambda: moe.make_forward(
        config(n_experts=3), "cpu", mesh)(
        moe.init_params(torch.Generator().manual_seed(0),
                        config(n_experts=3)), tokens))
if world == 4 and sizes.get("dp") == 2:
    # The same mesh over the ranks in another order: mesh position 0 is
    # rank 2, so the pick counts arrive out of mesh order.
    permuted = moe.make_moe_mesh([2, 3, 0, 1], device_type="cpu", **sizes)
    cfg = config()
    params = moe.shard_params(moe.params_from_jax(tree("default"), cfg,
                                                  "cpu"), cfg, permuted)
    out["permuted:logits"] = moe.make_forward(cfg, "cpu", permuted)(
        params, tokens)[0].numpy()
    meta["permuted_coord"] = dict(zip(permuted.mesh_dim_names,
                                      permuted.get_coordinate()))
    tp_mesh = moe.make_moe_mesh(device_type="cpu", ep=2, tp=2)
    refused("tp2", lambda: out.__setitem__("tp2:logits", moe.make_forward(
        config(), "cpu", tp_mesh)(moe.shard_params(moe.params_from_jax(
            tree("default"), config(), "cpu"), config(), tp_mesh),
            tokens)[0].numpy()))
    meta["tp2_coord"] = dict(zip(tp_mesh.mesh_dim_names,
                                 tp_mesh.get_coordinate()))
meta["refusals"] = refusals
np.savez(os.environ["OUT"] + f"{rank}.npz", **out)
with open(os.environ["OUT"] + f"{rank}.json", "w") as f:
    json.dump(meta, f)
dist.destroy_process_group()
"""


def _flat(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        out.update(_flat(val, path) if isinstance(val, dict)
                   else {path: np.asarray(val)})
    return out


def _tree(flat):
    out = {}
    for path, val in flat.items():
        *parents, leaf = path.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = val
    return out


def _params():
    """{case params: the reference's tree, flat by path}: ``default``
    from ``init_params``, ``lopsided`` with a shared direction added to
    every embedding row and to expert 0's router column."""
    cfg = jmoe.MoEConfig()
    default = _flat(jax.tree_util.tree_map(
        np.asarray, jmoe.init_params(jax.random.PRNGKey(0), cfg)))
    u = np.random.default_rng(9).standard_normal(cfg.d_model).astype(
        np.float32)
    u /= np.linalg.norm(u)
    lopsided = dict(default)
    lopsided["embed"] = default["embed"] + 0.5 * u
    router = default["layers/router"].copy()
    router[:, :, 0] += 4.0 * u
    lopsided["layers/router"] = router
    return {"default": default, "lopsided": lopsided}


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.int32)


def _inputs():
    flat = {f"{case}:{path}": val for case, tree in _params().items()
            for path, val in tree.items()}
    return {**flat, "tokens": _tokens((B, T), 0),
            **{f"batch{n}": _tokens((B, T + 1), 10 + n)
               for n in range(STEPS)}}


def _config(**kw):
    return tmoe.MoEConfig(compute_dtype=torch.float32, **kw)


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    """{mesh name: [(npz, json)] by rank}, the three gangs run one after
    another (at most four processes at a time)."""
    tmp = tmp_path_factory.mktemp("moe_ep")
    np.savez(tmp / "in.npz", **_inputs())
    base = {k: v for k, v in os.environ.items()
            if not k.startswith(("TPU_", "KTPU_", "POD_"))}
    cmd = [sys.executable, "-c", "import os; exec(os.environ['SCRIPT'])"]
    for name, sizes in MESHES.items():
        world, port = int(np.prod(list(sizes.values()))), free_port()
        extra = (dict(STEPS=str(STEPS), LR=str(LR),
                      BF16_STEPS=str(BF16_STEPS)) if name == "ep2" else {})
        envs = [{**base, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1",
                 "RANK": str(r), "WORLD": str(world), "PORT": str(port),
                 "IN": str(tmp / "in.npz"), "OUT": str(tmp / f"{name}-"),
                 "SIZES": json.dumps(sizes), "CASES": json.dumps(CASES),
                 "SCRIPT": _RANK, **extra}
                for r in range(world)]
        for rc, out in run_gang(cmd, envs):
            assert rc == 0, out
    results = {}
    for name, sizes in MESHES.items():
        results[name] = []
        for r in range(int(np.prod(list(sizes.values())))):
            with open(tmp / f"{name}-{r}.json") as f:
                results[name].append((dict(np.load(tmp / f"{name}-{r}.npz")),
                                      json.load(f)))
    return results


@pytest.fixture(scope="module")
def one_process():
    """{case: (logits, aux, loss, grads by path)} of the one-process
    forward and step on the global batch."""
    data = _inputs()
    params = _params()
    out = {}
    for case, (prefix, kw) in CASES.items():
        cfg = _config(**kw)
        p = tmoe.params_from_jax(_tree(params[prefix]), cfg, device="cpu")
        logits, aux = tmoe.make_forward(cfg, "cpu")(
            p, torch.from_numpy(data["tokens"]))
        loss, grads = tmoe.loss_and_grads(
            p, torch.from_numpy(data["batch0"]), cfg)
        out[case] = (logits, float(aux), float(loss), dict(zip(
            tmoe._paths(grads), (g.numpy() for g in tmoe._leaves(grads)))))
    return out


def _sizes(name):
    return {**dict.fromkeys(tmoe.MOE_AXES, 1), **MESHES[name]}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("name", list(MESHES))
def test_mesh_forward_equals_one_process(gangs, one_process, name, case):
    sizes = _sizes(name)
    want, want_aux, _, _ = one_process[case]
    seen = set()
    for out, meta in gangs[name]:
        coord = meta["coord"]
        got = out[f"{case}:logits"]
        block = sharding.block(want, tmoe.MOE_ACT_SPEC, sizes, coord)
        assert got.shape == tuple(block.shape)
        np.testing.assert_allclose(got, block.numpy(), atol=1e-5, rtol=0)
        assert abs(meta[f"{case}:aux"] - want_aux) <= 1e-5 * want_aux
        seen.add(tuple(coord[a] for a in tmoe.MOE_AXES))
    assert len(seen) == len(gangs[name])  # every block compared


def test_a_mesh_in_another_rank_order_is_the_same_forward(gangs,
                                                         one_process):
    """dp 2 x ep 2 over ranks [2, 3, 0, 1]: each rank's block is the one
    its mesh coordinate names, not its rank's."""
    want = one_process["default"][0]
    coords = set()
    for out, meta in gangs["dp2ep2"]:
        coord = meta["permuted_coord"]
        block = sharding.block(want, tmoe.MOE_ACT_SPEC, _sizes("dp2ep2"),
                               coord)
        np.testing.assert_allclose(out["permuted:logits"], block.numpy(),
                                   atol=1e-5, rtol=0)
        coords.add((coord["dp"], coord["ep"]))
    assert coords == {(0, 0), (0, 1), (1, 0), (1, 1)}
    assert gangs["dp2ep2"][0][1]["permuted_coord"]["dp"] == 1


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("name", list(MESHES))
def test_mesh_loss_and_grads_equal_one_process(gangs, one_process, name,
                                               case):
    sizes = _sizes(name)
    specs = tmoe.param_specs(_config())
    _, _, want_loss, want = one_process[case]
    for out, meta in gangs[name]:
        np.testing.assert_allclose(meta[f"{case}:loss"], want_loss,
                                   rtol=1e-5)
        got = {k.split(":", 2)[2]: v for k, v in out.items()
               if k.startswith(f"{case}:grad:")}
        assert got.keys() == want.keys()
        for path, w in want.items():
            spec = specs["layers"][path.split("/")[1]] \
                if path.startswith("layers/") else (None,) * w.ndim
            w = sharding.block(torch.from_numpy(w), spec, sizes,
                               meta["coord"]).numpy()
            assert got[path].shape == w.shape, path
            if tmoe.is_expert(path):
                assert w.shape[1] == 4 // sizes["ep"]
            np.testing.assert_allclose(got[path], w, rtol=1e-5,
                                       atol=1e-5 * np.abs(w).max(),
                                       err_msg=f"{name} {case} {path}")


def _row_block_forward(case, rows):
    """The one-process forward on ``rows`` of the batch alone: what a
    rank would compute with per-rank capacity and per-rank aux."""
    prefix, kw = CASES[case]
    cfg = _config(**kw)
    p = tmoe.params_from_jax(_tree(_params()[prefix]), cfg, device="cpu")
    tokens = torch.from_numpy(_inputs()["tokens"][rows])
    return tmoe.make_forward(cfg, "cpu")(p, tokens)


@pytest.mark.parametrize("case", ["lopsided", "tight"])
def test_per_rank_routing_would_differ(one_process, case):
    """The cases discriminate: at ep 2's row blocks, routing each block
    on its own (its own capacity and aux) moves the logits by far more
    than the 1e-5 the mesh is held to, and moves the aux."""
    want, want_aux, _, _ = one_process[case]
    moved, auxes = 0.0, []
    for j in range(2):
        rows = slice(j * B // 2, (j + 1) * B // 2)
        logits, aux = _row_block_forward(case, rows)
        moved = max(moved, float((logits - want[rows]).abs().max()))
        auxes.append(float(aux))
    assert moved > 1e-2, moved
    assert abs(sum(auxes) / 2 - want_aux) > 1e-4, (auxes, want_aux)


def test_tight_capacity_drops_across_rank_boundaries():
    """Layer 0 of the ``tight`` case on the global batch: row 0, first in
    order, keeps every token's first pick (round 0 fills the buffers
    before round 1 takes a slot); some experts are full within ep 2's
    first row block, which drops tokens, while tokens of the second
    block still land in the others. Which tokens land depends on every
    earlier rank's fill."""
    prefix, kw = CASES["tight"]
    cfg = _config(**kw)
    p = tmoe.params_from_jax(_tree(_params()[prefix]), cfg, device="cpu")
    lp = {k: v[0] for k, v in p["layers"].items()}
    x = p["embed"][torch.from_numpy(_inputs()["tokens"]).long()]
    x = tmoe._attention_block(x, lp, cfg, reference_attention, 0)
    y = tmoe._rms_norm(x, lp["ln2"]).reshape(B * T, -1)
    dispatch, _, _ = tmoe._route(y, lp["router"], cfg, rows=B)
    kept = dispatch.sum(dim=(1, 2)).reshape(B, T)
    first, last = kept[:B // 2], kept[B // 2:]
    assert bool((kept[0] == 1).all())
    assert bool((first == 0).any()) and bool((last > 0).any())


def test_ep2_train_steps_equal_one_process(gangs):
    cfg = _config()
    data = _inputs()
    params = tmoe.params_from_jax(_tree(_params()["default"]), cfg,
                                  device="cpu")
    opt_state = tmoe.make_optimizer(LR).init(params)
    step = tmoe.make_train_step(cfg, lr=LR, device="cpu")
    losses = []
    for n in range(STEPS):
        params, opt_state, loss = step(params, opt_state,
                                       torch.from_numpy(data[f"batch{n}"]))
        losses.append(float(loss))
    want = dict(zip(tmoe._paths(params), tmoe._leaves(params)))
    specs = tmoe.param_specs(cfg)
    for out, meta in gangs["ep2"]:
        np.testing.assert_allclose(meta["losses"], losses, rtol=1e-5)
        got, ref = [], []
        for path, w in want.items():
            spec = specs["layers"][path.split("/")[1]] \
                if path.startswith("layers/") else (None,) * w.dim()
            got.append(out[f"param:{path}"])
            ref.append(sharding.block(w, spec, _sizes("ep2"),
                                      meta["coord"]).numpy())
        _assert_stepped_alike(got, ref, 1e-6)


def test_ep2_bf16_steps_are_one_process_with_rank_rounding(gangs):
    """In bf16 the ep 2 mesh's losses are not one process's: each rank's
    matmuls round its rows' share of every dense weight gradient to bf16
    before the all-reduce sums the shares in f32, where one process
    rounds the whole sum once, and AdamW's steps carry the difference
    on. With that rounding done in one process (``moe_rounding``'s
    step, two shares, the experts in two groups), the losses are the
    mesh's within 1e-5 at every step. A fault in the mesh (routing, the
    exchange, the gradient sums) would move them apart; the plain
    one-process step lies further off than that, so the agreement is
    not luck."""
    cfg = tmoe.MoEConfig()
    batch = torch.from_numpy(_inputs()["batch0"])

    def run(step):
        params = tmoe.params_from_jax(_tree(_params()["default"]), cfg,
                                      device="cpu")
        opt_state = tmoe.make_optimizer(LR).init(params)
        return [float(step(params, opt_state, batch)[2])
                for _ in range(BF16_STEPS)]

    shares = run(moe_rounding.make_step(cfg, 2, LR, groups=2))
    plain = run(tmoe.make_train_step(cfg, lr=LR, device="cpu"))
    for _, meta in gangs["ep2"]:
        np.testing.assert_allclose(meta["bf16_losses"], shares, rtol=1e-5)
    off = max(abs(p - s) / abs(s) for p, s in zip(plain, shares))
    assert off > 1e-4, (plain, shares)


def test_refusals(gangs, one_process):
    for name in MESHES:
        for _, meta in gangs[name]:
            kind, msg = meta["refusals"]["experts_3_ep2"]
            assert kind == "ValueError" and "split over ep=2" in msg
    # tp is sharded now: ep 2 x tp 2 runs, and each rank's block of the
    # logits is the one-process forward's.
    want = one_process["default"][0]
    for out, meta in gangs["dp2ep2"]:
        assert meta["refusals"]["tp2"] is None, meta["refusals"]["tp2"]
        block = sharding.block(want, tmoe.MOE_ACT_SPEC, _sizes("ep2tp2"),
                               meta["tp2_coord"])
        np.testing.assert_allclose(out["tp2:logits"], block.numpy(),
                                   atol=1e-5, rtol=0)


def test_ep2tp2_forward_matches_the_reference(gangs, monkeypatch):
    """The ep 2 x tp 2 mesh's logits against the reference's MoE forward
    on one device, its ring attention replaced by its plain attention
    (the reference's ring fails under the installed jax; ROADMAP queue
    3): f32 at 1e-4, as the dense LM's forward is held."""
    from kubernetes_tpu.workloads import ring_attention as jra

    monkeypatch.setattr(jmoe, "ring_attention",
                        lambda q, k, v, mesh, **_: jra.reference_attention(
                            q, k, v))
    cfg = jmoe.MoEConfig(compute_dtype=jax.numpy.float32)
    mesh = jmoe.make_moe_mesh(jax.devices()[:1])
    jp = jmoe.init_params(jax.random.PRNGKey(0), cfg)
    want, _ = jmoe.forward(jp, jax.numpy.asarray(_inputs()["tokens"]), cfg,
                           mesh)
    want = torch.from_numpy(np.array(want))
    for out, meta in gangs["ep2tp2"]:
        block = sharding.block(want, tmoe.MOE_ACT_SPEC, _sizes("ep2tp2"),
                               meta["coord"])
        np.testing.assert_allclose(out["default:logits"], block.numpy(),
                                   atol=1e-4, rtol=0)
