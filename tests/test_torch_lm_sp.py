"""The port's LM sequence-parallel over gloo, against the reference on
one device and against itself in one process, on the CPU.

- ``forward`` over a mesh of ``sp = 2`` (two ranks) and of ``dp = 2 x
  sp = 2`` (four ranks), params carried from the reference's
  ``init_params`` by ``params_from_jax``, each rank's block of logits
  against the reference ``lm.forward`` with ``attn_impl="local"`` on one
  device: f32 compute at 1e-4 (the same arithmetic, sums in another
  order), bf16 compute at the reference tests' 5e-2. Every rank is
  compared, so positions past the first block (where RoPE counting from
  0 on every rank would differ) are held too.
- Two train steps at ``sp = 2`` against one process on the same global
  batch, f32: both losses within rtol 1e-5; the first step's gradients
  within 1e-5 of each leaf's largest (the two ranks sum in another
  order, and the ring's f32 merge rounds at other places than one
  causal block); every param after the two steps by the rule of
  ``tests/test_torch_train.py`` for AdamW steps (each within 2 * lr, the
  mean difference within 1e-6). AdamW, not the ring, sets that rule: it
  moves a weight by about lr * g / (|g| + eps), eps = 1e-8, so a
  gradient within f32 rounding of 0 turns a 1e-11 difference in g into
  up to lr / eps * 1e-11 = 3e-6, past rtol 1e-5 of a weight. Then two
  steps of ``lm.train`` over the mesh against ``lm.train`` in one
  process.
- The refusals: "flash" on a multi-device mesh and "local" with sp > 1
  raise ``ValueError`` as the reference does. The ring at ``fsdp = 2 x
  sp = 2`` and ``sp = 2 x tp = 2``, which the port once refused, runs
  and its logits match the reference's as the others do
  (``tests/test_torch_lm_fsdp_tp.py`` holds those axes further).

Each group of ranks is started once for the module, as subprocesses
waited on with a timeout; their ports come from the OS.
"""
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.workloads import lm as jlm
from kubernetes_tpu.workloads.sharding import make_mesh
from kubernetes_tpu_torch.workloads import lm as tlm
from kubernetes_tpu_torch.workloads import sharding

from tests.test_torch_rendezvous import ROOT, free_port, run_gang
from tests.test_torch_train import LR, _assert_stepped_alike

SMALL = dict(vocab=128, d_model=64, n_layers=2, n_heads=2, d_ff=128)
B, T = 2, 32
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
STEPS = 2

#: A rank of a gloo group on the CPU: the params (IN.npz, the
#: reference's tree by key path) and the tokens; results to
#: OUT<rank>.npz and OUT<rank>.json.
_PRELUDE = r"""
import json, os
import numpy as np
import torch
from torch import distributed as dist
from kubernetes_tpu_torch.workloads import lm, rendezvous, sharding
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD"])
rendezvous.init_process_group("127.0.0.1", int(os.environ["PORT"]), rank,
                              world, "gloo", 60.0, "127.0.0.1")
small = json.loads(os.environ["SMALL"])
data = np.load(os.environ["IN"])
tree = {}
for key in data.files:
    if "/" in key or key == "embed" or key == "ln_f":
        *parents, leaf = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = data[key]
def config(compute, **kw):
    return lm.LMConfig(**small, compute_dtype=getattr(torch, compute), **kw)
out, meta = {}, {}
def forwards(name, mesh):
    meta[name] = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    tokens = torch.from_numpy(data["tokens"])
    for compute in ("float32", "bfloat16"):
        cfg = config(compute)
        params = sharding.shard_params(
            mesh, lm.params_from_jax(tree, cfg, device="cpu"),
            lm.param_specs(cfg))
        out[f"{name}:{compute}"] = lm.make_forward(cfg, "cpu", mesh)(
            params, tokens).numpy()
def save():
    np.savez(os.environ["OUT"] + f"{rank}.npz", **out)
    with open(os.environ["OUT"] + f"{rank}.json", "w") as f:
        json.dump(meta, f)
    dist.destroy_process_group()
"""

#: Two ranks, sp = 2: the forwards, then STEPS train steps on the global
#: batches, then ``lm.train`` over the mesh.
_SP2 = _PRELUDE + r"""
mesh = sharding.make_mesh(device_type="cpu", sp=2)
forwards("sp2", mesh)
cfg = config("float32")
params = lm.params_from_jax(tree, cfg, device="cpu")
_, grads = lm.loss_and_grads(params, torch.from_numpy(data["batch0"]), cfg,
                             mesh=mesh)
opt_state = lm.init_opt_state(params, cfg, float(os.environ["LR"]))
step = lm.make_train_step(cfg, float(os.environ["LR"]), "cpu", mesh=mesh)
losses = []
for n in range(int(os.environ["STEPS"])):
    params, opt_state, loss = step(params, opt_state,
                                   torch.from_numpy(data[f"batch{n}"]))
    losses.append(float(loss))
meta["losses"] = losses
def put(node, path=""):
    if isinstance(node, dict):
        for k, v in node.items():
            put(v, f"{path}/{k}" if path else k)
    else:
        out[f"{prefix}:{path}"] = node.detach().numpy()
prefix = "grad"
put(grads)
prefix = "param"
put(params)
meta["train"] = lm.train(cfg, steps=int(os.environ["STEPS"]), batch=2,
                         seq=32, ckpt_dir=os.environ["CKPT"],
                         checkpoint_every=0, device="cpu", mesh=mesh)
save()
"""

#: Four ranks, dp = 2 x sp = 2: the forwards, then those at fsdp = 2 x
#: sp = 2 and sp = 2 x tp = 2, then each refusal's type and message
#: (None where the forward runs).
_DP2SP2 = _PRELUDE + r"""
forwards("dp2sp2", sharding.make_mesh(device_type="cpu", dp=2, sp=2))
forwards("fsdp2sp2", sharding.make_mesh(device_type="cpu", fsdp=2, sp=2))
forwards("sp2tp2", sharding.make_mesh(device_type="cpu", sp=2, tp=2))
tokens = torch.from_numpy(data["tokens"])
refusals = {}
for name, sizes, attn in (("flash_dp2sp2", dict(dp=2, sp=2), "flash"),
                          ("flash_dp4", dict(dp=4), "flash"),
                          ("local_sp2", dict(dp=2, sp=2), "local"),
                          ("ring_fsdp2", dict(fsdp=2, sp=2), "ring"),
                          ("ring_tp2", dict(sp=2, tp=2), "ring")):
    mesh = sharding.make_mesh(device_type="cpu", **sizes)
    cfg = config("float32", attn_impl=attn)
    params = sharding.shard_params(
        mesh, lm.params_from_jax(tree, cfg, device="cpu"),
        lm.param_specs(cfg))
    try:
        lm.forward(params, tokens, cfg, mesh)
        refusals[name] = None
    except (ValueError, NotImplementedError) as exc:
        refusals[name] = [type(exc).__name__, str(exc)]
meta["refusals"] = refusals
save()
"""


def _gangs(tmp, gangs: dict) -> dict:
    """Runs each gang ``{name: (script, world, env)}`` as ``world`` ranks
    of a gloo group of its own, all at once; returns ``{name: [(npz,
    json)] by rank}``."""
    np.savez(tmp / "in.npz", **_inputs())
    base = {k: v for k, v in os.environ.items()
            if not k.startswith(("TPU_", "KTPU_", "POD_"))}
    envs, scripts = [], []
    for name, (script, world, env) in gangs.items():
        port = free_port()
        envs += [{**base, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1",
                  "RANK": str(r), "WORLD": str(world), "PORT": str(port),
                  "IN": str(tmp / "in.npz"), "OUT": str(tmp / f"{name}-"),
                  "SMALL": json.dumps(SMALL), "SCRIPT": script, **env}
                 for r in range(world)]
    cmd = [sys.executable, "-c", "import os; exec(os.environ['SCRIPT'])"]
    for rc, out in run_gang(cmd, envs):
        assert rc == 0, out
    results = {}
    for name, (_, world, _) in gangs.items():
        results[name] = []
        for r in range(world):
            with open(tmp / f"{name}-{r}.json") as f:
                results[name].append((dict(np.load(tmp / f"{name}-{r}.npz")),
                                      json.load(f)))
    return results


def _jax_params():
    cfg = jlm.LMConfig(**SMALL, compute_dtype=jnp.float32)
    return jlm.init_params(jax.random.PRNGKey(0), cfg)


def _flat(tree):
    return {"/".join(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(
        0, SMALL["vocab"], shape).astype(np.int32)


def _inputs():
    return {**_flat(_jax_params()), "tokens": _tokens((B, T), 0),
            **{f"batch{n}": _tokens((B, T + 1), 10 + n)
               for n in range(STEPS)}}


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    """Both gangs, started together: two ranks at sp = 2, four at dp = 2
    x sp = 2."""
    tmp = tmp_path_factory.mktemp("lm_sp")
    return _gangs(tmp, {
        "sp2": (_SP2, 2, dict(LR=str(LR), STEPS=str(STEPS),
                              CKPT=str(tmp / "ckpt"))),
        "dp2sp2": (_DP2SP2, 4, {})})


@pytest.fixture(scope="module")
def sp2(gangs):
    return gangs["sp2"]


@pytest.fixture(scope="module")
def dp2sp2(gangs):
    return gangs["dp2sp2"]


@pytest.fixture(scope="module")
def reference_logits():
    """{compute dtype: the reference's logits, local attention, one
    device}."""
    mesh = make_mesh(jax.devices()[:1])
    jp = _jax_params()
    tokens = jnp.asarray(_inputs()["tokens"])
    out = {}
    for compute, (jdt, _) in DTYPES.items():
        cfg = jlm.LMConfig(**SMALL, compute_dtype=jdt, attn_impl="local")
        out[compute] = np.asarray(jlm.make_forward(cfg, mesh)(jp, tokens))
    return out


@pytest.mark.parametrize("compute,atol", [("float32", 1e-4),
                                          ("bfloat16", 5e-2)])
@pytest.mark.parametrize("name", ["sp2", "dp2sp2"])
def test_sp_forward_matches_the_reference_on_one_device(
        request, reference_logits, name, compute, atol):
    ranks = request.getfixturevalue(name)
    sizes = {**dict.fromkeys(sharding.AXES, 1), "sp": 2,
             "dp": 2 if name == "dp2sp2" else 1}
    want = torch.from_numpy(np.array(reference_logits[compute]))
    seen = set()
    for out, meta in ranks:
        coord = meta[name]
        got = out[f"{name}:{compute}"]
        assert got.shape == (B // sizes["dp"], T // 2, SMALL["vocab"])
        block = sharding.block(want, sharding.ACT_SPEC, sizes, coord)
        np.testing.assert_allclose(got, block.numpy(), atol=atol, rtol=0)
        seen.add((coord["dp"], coord["sp"]))
    # Every block was compared, the second half of the sequence too.
    assert seen == {(d, s) for d in range(sizes["dp"]) for s in range(2)}


@pytest.mark.parametrize("compute,atol", [("float32", 1e-4),
                                          ("bfloat16", 5e-2)])
@pytest.mark.parametrize("name,sizes", [("fsdp2sp2", dict(fsdp=2, sp=2)),
                                        ("sp2tp2", dict(sp=2, tp=2))])
def test_fsdp_and_tp_forward_match_the_reference_on_one_device(
        dp2sp2, reference_logits, name, sizes, compute, atol):
    """The meshes the port once refused: every rank's block of logits
    (rows by fsdp, positions by sp, whole over tp) against the
    reference's one-device forward."""
    sizes = {**dict.fromkeys(sharding.AXES, 1), **sizes}
    want = torch.from_numpy(np.array(reference_logits[compute]))
    seen = set()
    for out, meta in dp2sp2:
        coord = meta[name]
        block = sharding.block(want, sharding.ACT_SPEC, sizes, coord)
        np.testing.assert_allclose(out[f"{name}:{compute}"], block.numpy(),
                                   atol=atol, rtol=0)
        seen.add(tuple(coord[a] for a in sharding.AXES))
    assert len(seen) == 4


def _one_process_steps():
    cfg = tlm.LMConfig(**SMALL, compute_dtype=torch.float32)
    data = _inputs()
    params = tlm.params_from_jax(_np_tree(_jax_params()), cfg,
                             device="cpu")
    _, grads = tlm.loss_and_grads(params, torch.from_numpy(data["batch0"]),
                                  cfg)
    opt_state = tlm.init_opt_state(params, cfg, LR)
    step = tlm.make_train_step(cfg, LR, "cpu")
    losses = []
    for n in range(STEPS):
        params, opt_state, loss = step(params, opt_state,
                                       torch.from_numpy(data[f"batch{n}"]))
        losses.append(float(loss))
    return losses, grads, params


def _flat_torch(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        out.update(_flat_torch(val, path) if isinstance(val, dict)
                   else {path: val.detach().numpy()})
    return out


def test_sp2_train_steps_match_one_process(sp2):
    losses, grads, params = _one_process_steps()
    for out, meta in sp2:
        np.testing.assert_allclose(meta["losses"], losses, rtol=1e-5)
        got = {prefix: {k.split(":", 1)[1]: v for k, v in out.items()
                        if k.startswith(prefix + ":")}
               for prefix in ("grad", "param")}
        want = _flat_torch(grads)
        assert got["grad"].keys() == want.keys()
        for path, w in want.items():
            np.testing.assert_allclose(got["grad"][path], w, rtol=1e-5,
                                       atol=1e-5 * np.abs(w).max(),
                                       err_msg=path)
        want = _flat_torch(params)
        assert got["param"].keys() == want.keys()
        _assert_stepped_alike([got["param"][p] for p in want],
                              list(want.values()), 1e-6)


def test_sp2_train_loop_matches_one_process(sp2, tmp_path):
    cfg = tlm.LMConfig(**SMALL, compute_dtype=torch.float32)
    want = tlm.train(cfg, steps=STEPS, batch=2, seq=32,
                     ckpt_dir=str(tmp_path), checkpoint_every=0,
                     device="cpu")
    for _, meta in sp2:
        got = meta["train"]
        assert (got["final_step"], got["resumed_from"], got["preempted"]) \
            == (STEPS, 0, False)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)


def test_refusals_match_the_reference(dp2sp2):
    for _, meta in dp2sp2:
        refusals = meta["refusals"]
        for name in ("flash_dp2sp2", "flash_dp4"):
            kind, msg = refusals[name]
            assert kind == "ValueError" and "single-device" in msg, name
        kind, msg = refusals["local_sp2"]
        assert kind == "ValueError" and "batch-parallel only" in msg
        # fsdp and tp are sharded now: the ring runs there, and
        # test_fsdp_and_tp_forward_match_the_reference_on_one_device
        # holds what it computes.
        for name in ("ring_fsdp2", "ring_tp2"):
            assert refusals[name] is None, (name, refusals[name])


def test_no_mesh_and_a_mesh_of_one_are_the_same_forward():
    """A mesh of one device is the single-device path, bit for bit."""
    from torch import distributed as dist
    cfg = tlm.LMConfig(**SMALL, compute_dtype=torch.float32)
    params = tlm.params_from_jax(_np_tree(_jax_params()), cfg,
                             device="cpu")
    tokens = torch.from_numpy(_tokens((B, T), 3))
    batch = torch.from_numpy(_tokens((B, T + 1), 4))
    want = tlm.make_forward(cfg, "cpu")(params, tokens)
    want_loss, want_grads = tlm.loss_and_grads(params, batch, cfg)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = sharding.make_mesh(device_type="cpu")
        got = tlm.make_forward(cfg, "cpu", mesh)(params, tokens)
        loss, grads = tlm.loss_and_grads(params, batch, cfg, mesh=mesh)
    finally:
        dist.destroy_process_group()
    assert torch.equal(got, want) and torch.equal(loss, want_loss)
    for g, w in zip(tlm._leaves(grads), tlm._leaves(want_grads)):
        assert torch.equal(g, w)


def test_group_and_mesh_together_are_refused():
    cfg = tlm.LMConfig(**SMALL)
    with pytest.raises(ValueError, match="not both"):
        tlm.make_train_step(cfg, device="cpu", group=object(),
                            mesh=object())


def test_the_trainer_takes_lm_attn_ring(monkeypatch, tmp_path):
    """``LM_ATTN=ring`` runs the trainer (a gang of one on the CPU, its
    mesh dp alone, as the reference trainer's): its loss follows plain
    attention's within 1e-3 relative (the same attention; the ring's
    backward is written out, plain attention's differentiated)."""
    from kubernetes_tpu_torch.workloads import trainer
    losses = {}
    for attn in ("ring", "local"):
        for name in ("TPU_", "KTPU_", "POD_", "LM_"):
            for key in [k for k in os.environ if k.startswith(name)]:
                monkeypatch.delenv(key)
        ckpt_dir = tmp_path / attn
        for key, val in dict(TPU_WORKER_ID="0",
                             TPU_WORKER_HOSTNAMES="t-0.t.default",
                             KTPU_TRAINER_PLATFORM="cpu", MODEL="lm",
                             LM_ATTN=attn, TOTAL_STEPS="3",
                             CHECKPOINT_EVERY="0",
                             CKPT_DIR=str(ckpt_dir)).items():
            monkeypatch.setenv(key, val)
        assert trainer.lm_config(torch.device("cpu")).attn_impl == attn
        assert trainer.main() == 0
        with open(ckpt_dir / "attempt-rank0-start0.json") as f:
            record = json.load(f)
        assert record["final_step"] == 3
        losses[attn] = record["loss"]
    np.testing.assert_allclose(losses["ring"], losses["local"], rtol=1e-3)
