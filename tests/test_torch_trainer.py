"""The port's multi-process trainer against the reference, over gloo on
the CPU.

- One data-parallel step of 2 ranks (``lm.loss_and_grads`` and
  ``lm.make_train_step`` under a process group, each rank on its half of
  the batch, params carried across by ``lm.params_from_jax``) against
  the reference's ``make_train_step`` on a ``dp=2`` mesh of the CPU
  devices that ``tests/conftest.py`` gives JAX, attention "local", f32:
  loss and grads within 1e-4 (f32, sums in another order), the stepped
  params by ``tests/test_torch_train.py``'s rule.
- A 4-step ``lm.train`` trajectory of 2 ranks equals a 1-rank run of the
  same global batch: per-step losses within 1e-4, resuming each step
  from the group's checkpoint.
- A preemption flag set on one rank only stops both ranks at the same
  step, with one save and one marker.
- The demo's final value is exact at world 2, and a resume continues it.
- The env that the reference ``TrainJobController`` writes into its
  worker pods runs the port's trainer to ``TRAINER DONE``.

Each rank is a subprocess waited on with a timeout; every port comes
from the OS.
"""
import asyncio
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from kubernetes_tpu.api import training as tr
from kubernetes_tpu.client.local import LocalClient
from kubernetes_tpu.controllers.train import group_name
from kubernetes_tpu.preemption import read_marker as ref_read_marker
from kubernetes_tpu.workloads import lm as jlm
from kubernetes_tpu.workloads.sharding import make_mesh
from kubernetes_tpu_torch.preemption import read_marker
from kubernetes_tpu_torch.workloads import checkpoint as ckpt
from kubernetes_tpu_torch.workloads import lm as tlm

from tests.integration.test_trainjob import (  # noqa: F401 (fixture)
    _controller, _member_pods, _registry, _tj, _wait, gate_on)
from tests.test_torch_rendezvous import (
    ROOT, StubDNS, free_port, rank_env, run_gang)
from tests.test_torch_train import SMALL, _assert_stepped_alike

TRAINER = [sys.executable, "-m", "kubernetes_tpu_torch.workloads.trainer"]
DEMO = [sys.executable, "-m", "kubernetes_tpu_torch.workloads.distributed_demo"]

#: A rank of a gloo group on the CPU at the test's f32 config (``CFG``,
#: JSON), made without DNS: rank 0 serves the store on 127.0.0.1.
_PRELUDE = r"""
import json, os, sys
import numpy as np
import torch
from torch import distributed as dist
from kubernetes_tpu_torch.workloads import lm, rendezvous
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD"])
rendezvous.init_process_group("127.0.0.1", int(os.environ["PORT"]), rank,
                              world, "gloo", 60.0, "127.0.0.1")
group = dist.group.WORLD
cfg = lm.LMConfig(**json.loads(os.environ["CFG"]), param_dtype=torch.float32,
                  compute_dtype=torch.float32, attn_impl="local")
"""

#: One dp step: the group's loss and grads, then one train step, on this
#: rank's rows of the batch; everything saved to OUT<rank>.npz.
_DP_STEP = _PRELUDE + r"""
data = np.load(os.environ["IN"])
tree = {}
for key in data.files:
    if key != "batch":
        *parents, leaf = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = data[key]
params = lm.params_from_jax(tree, cfg, device="cpu")
batch = torch.from_numpy(data["batch"])
rows = batch.shape[0] // world
mine = batch[rank * rows:(rank + 1) * rows]
loss, grads = lm.loss_and_grads(params, mine, cfg, group)
opt_state = lm.init_opt_state(params, cfg)
params, opt_state, step_loss = lm.make_train_step(cfg, device="cpu",
                                                  group=group)(
    params, opt_state, mine)
out = {"loss": loss.numpy(), "step_loss": step_loss.numpy()}
def put(prefix, node, path=""):
    if isinstance(node, dict):
        for k, v in node.items():
            put(prefix, v, f"{path}/{k}" if path else k)
    else:
        out[f"{prefix}:{path}"] = node.detach().numpy()
put("grad", grads)
put("param", params)
put("mu", opt_state["mu"])
put("nu", opt_state["nu"])
np.savez(os.environ["OUT"] + f"{rank}.npz", **out)
dist.destroy_process_group()
"""

#: ``lm.train`` to steps 1, 2, .., STEPS in turn, each call resuming from
#: the group's checkpoint of the step before; the losses to OUT<rank>.
_TRAJECTORY = _PRELUDE + r"""
losses = []
for steps in range(1, int(os.environ["STEPS"]) + 1):
    out = lm.train(cfg, steps=steps, batch=int(os.environ["BATCH"]), seq=16,
                   ckpt_dir=os.environ["CKPT"], checkpoint_every=1,
                   device="cpu", group=group)
    assert out["resumed_from"] == steps - 1, out
    losses.append(out["loss"])
with open(os.environ["OUT"] + str(rank), "w") as f:
    json.dump(losses, f)
dist.destroy_process_group()
"""

#: ``lm.train`` with a preemption flag that only rank 1 raises, after
#: its step 2; the loop's result to OUT<rank>.
_PREEMPT = _PRELUDE + r"""
flag = os.environ["KTPU_PREEMPT_FILE"]
def raise_flag(step):
    if rank == 1 and step == 2:
        open(flag, "w").close()
out = lm.train(cfg, steps=8, batch=4, seq=16, ckpt_dir=os.environ["CKPT"],
               checkpoint_every=0, publish_marker=True,
               step_callback=raise_flag, device="cpu", group=group)
with open(os.environ["OUT"] + str(rank), "w") as f:
    json.dump(out, f)
dist.destroy_process_group()
"""


def _ranks(script: str, world: int, **env) -> None:
    """Runs ``script`` as ``world`` ranks of one gloo group, one thread
    each; each must exit 0."""
    port = free_port()
    base = {k: v for k, v in os.environ.items()
            if not k.startswith(("TPU_", "KTPU_", "POD_"))}
    envs = [{**base, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1",
             "RANK": str(r),
             "WORLD": str(world), "PORT": str(port),
             "CFG": json.dumps(SMALL), **env} for r in range(world)]
    for rc, out in run_gang([sys.executable, "-c", script], envs):
        assert rc == 0, out


def _flat(tree, prefix=""):
    """{"a/b": leaf} of a nested dict."""
    out = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        out.update(_flat(val, path) if isinstance(val, dict) else {path: val})
    return out


def _jax_flat(tree):
    return {"/".join(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_dp2_step_matches_the_reference_on_a_dp2_mesh(tmp_path):
    jcfg = jlm.LMConfig(**SMALL, compute_dtype=jnp.float32,
                        param_dtype=jnp.float32, attn_impl="local")
    mesh = make_mesh(jax.devices()[:2], dp=2)
    jp, jst = jlm.init_sharded(jax.random.PRNGKey(0), jcfg, mesh)
    batch = np.random.default_rng(5).integers(
        0, SMALL["vocab"], (4, 33)).astype(np.int32)
    np.savez(tmp_path / "in.npz", batch=batch, **_jax_flat(jp))

    data = jax.device_put(jnp.asarray(batch),
                          NamedSharding(mesh, P(("dp", "fsdp"), None)))
    want_loss, want_grads = jax.value_and_grad(jlm.loss_fn)(jp, data, jcfg,
                                                            mesh)
    want_grads = _jax_flat(want_grads)
    jp, jst, jloss = jlm.make_train_step(jcfg, mesh)(jp, jst, data)
    want_params, adam = _jax_flat(jp), jst[0]
    want_mu, want_nu = _jax_flat(adam.mu), _jax_flat(adam.nu)

    _ranks(_DP_STEP, 2, IN=str(tmp_path / "in.npz"),
           OUT=str(tmp_path / "out"))
    got = [np.load(tmp_path / f"out{r}.npz") for r in range(2)]
    for res in got:
        assert abs(float(res["loss"]) - float(want_loss)) < 1e-4
        assert abs(float(res["step_loss"]) - float(jloss)) < 1e-4
        for path, w in want_grads.items():
            np.testing.assert_allclose(res[f"grad:{path}"], w, atol=1e-4,
                                       rtol=0, err_msg=path)
        for want, name in ((want_mu, "mu"), (want_nu, "nu")):
            for path, w in want.items():
                np.testing.assert_allclose(res[f"{name}:{path}"], w,
                                           atol=1e-4, rtol=0, err_msg=path)
        paths = sorted(want_params)
        _assert_stepped_alike([res[f"param:{p}"] for p in paths],
                              [want_params[p] for p in paths], 1e-6)
    # Every rank applied the same averaged gradients: identical params.
    for key in got[0].files:
        if key.startswith("param:"):
            np.testing.assert_array_equal(got[0][key], got[1][key])


def test_dp2_trajectory_equals_one_rank_on_the_global_batch(tmp_path):
    steps, batch = 4, 4
    _ranks(_TRAJECTORY, 2, STEPS=str(steps), BATCH=str(batch),
           CKPT=str(tmp_path / "dp2"), OUT=str(tmp_path / "losses"))
    cfg = tlm.LMConfig(**SMALL, param_dtype=torch.float32,
                       compute_dtype=torch.float32, attn_impl="local")
    want = [tlm.train(cfg, steps=s, batch=batch, seq=16,
                      ckpt_dir=str(tmp_path / "one"), checkpoint_every=1,
                      device="cpu")["loss"] for s in range(1, steps + 1)]
    for r in range(2):
        got = json.loads((tmp_path / f"losses{r}").read_text())
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    # The group's last checkpoint (rank 0's) against the single run's.
    like = ckpt.as_template(_template(cfg))
    mine = ckpt.restore(str(tmp_path / "dp2"), like)["params"]
    theirs = ckpt.restore(str(tmp_path / "one"), like)["params"]
    got, want = _flat(mine), _flat(theirs)
    _assert_stepped_alike([got[p].numpy() for p in sorted(got)],
                          [want[p].numpy() for p in sorted(want)], 1e-6)


def _template(cfg):
    params, opt_state = tlm.init_train_state(
        torch.Generator().manual_seed(0), cfg)
    return {"params": params, "opt_state": opt_state}


def test_a_preempt_flag_on_one_rank_stops_both_at_one_step(tmp_path):
    ckpt_dir = tmp_path / "ckpt"
    _ranks(_PREEMPT, 2, CKPT=str(ckpt_dir), OUT=str(tmp_path / "out"),
           KTPU_PREEMPT_FILE=str(tmp_path / "flag"))
    outs = [json.loads((tmp_path / f"out{r}").read_text()) for r in range(2)]
    for out in outs:
        assert out["preempted"] is True and out["final_step"] == 4, out
        assert out["resumed_from"] == 0
    assert outs[0]["loss"] == outs[1]["loss"]
    # One save (the preemption's, at step 3) and one marker.
    assert sorted(os.listdir(ckpt_dir)) == ["3", "ktpu-preempt-complete.json"]
    assert read_marker(str(ckpt_dir)) == ref_read_marker(str(ckpt_dir)) == 3


def _expected_final(n: int, total: int) -> float:
    # Step s adds mean_over_ranks(rank + 1 + s) = (n-1)/2 + 1 + s.
    return sum((n - 1) / 2 + 1 + s for s in range(total))


def _gang_envs(dns: StubDNS, world: int, **extra) -> list:
    """Env of each rank of a ``world``-rank gang, rank 0's hostname
    resolving to its pod IP through ``dns``."""
    port = free_port()
    hosts = [f"demo-{r}.demo-workers.default" for r in range(world)]
    ips = [f"127.0.2.{10 + r}" for r in range(world)]
    dns.records[f"{hosts[0]}.svc.cluster.local"] = ips[0]
    return [rank_env(r, hosts, port, dns, ips[r], **extra)
            for r in range(world)]


def _done_lines(results) -> list:
    lines = []
    for rc, out in results:
        assert rc == 0, out
        lines += [ln for ln in out.splitlines() if ln.startswith("DONE ")]
    return lines


def test_demo_final_value_is_exact_at_world_two(tmp_path):
    ckpt_dir = str(tmp_path / "ckpt")
    dns = StubDNS({})
    try:
        first = _done_lines(run_gang(DEMO, _gang_envs(
            dns, 2, TOTAL_STEPS="6", CKPT_DIR=ckpt_dir)))
        second = _done_lines(run_gang(DEMO, _gang_envs(
            dns, 2, TOTAL_STEPS="8", CKPT_DIR=ckpt_dir)))
    finally:
        dns.close()
    six, eight = _expected_final(2, 6), _expected_final(2, 8)
    assert six == 24.0 and eight == 40.0
    assert first == [f"DONE rank={r} start=0 final={six}" for r in range(2)]
    assert second == [f"DONE rank={r} start=6 final={eight}"
                      for r in range(2)]
    for r in range(2):
        path = os.path.join(ckpt_dir, f"done-rank{r}-attempt0")
        assert float(open(path).read()) == six
        rec = json.load(open(os.path.join(
            ckpt_dir, f"attempt-rank{r}-start6.json")))
        assert (rec["resumed_from"], rec["final_step"], rec["steps_run"],
                rec["final"]) == (6, 8, 2, eight)
    assert read_marker(ckpt_dir) == 8


async def test_trainjob_worker_env_runs_the_port_trainer(gate_on, tmp_path):
    """The env that the reference controller writes into each worker pod
    (framework rank env, model, steps, checkpoint cadence, the
    coordinator port), plus what the node agent adds at container start
    (POD_IP, KTPU_DNS_SERVER, KTPU_JOB_NAME, the checkpoint base), runs
    the port's trainer: the port's module takes the place of the
    reference's in the pod command."""
    reg = _registry()
    ctl, factory = await _controller(reg)
    try:
        await LocalClient(reg).create(_tj(
            coord_port=free_port(), total_steps=4,
            checkpoint=tr.TrainCheckpointSpec(every_steps=2),
            args={"SEQ": "16"}))
        await _wait(lambda: len(_member_pods(reg)) == 2, "worker pods")
        pods = sorted(_member_pods(reg),
                      key=lambda p: p.metadata.labels[tr.RANK_LABEL])
        gang = group_name(reg.get("trainjobs", "default", "tj"))
    finally:
        await ctl.stop()
        await factory.stop_all()
    assert pods[0].spec.containers[0].command[1:] == [
        "-m", "kubernetes_tpu.workloads.trainer"]
    pod_envs = [{e.name: e.value for e in p.spec.containers[0].env}
                for p in pods]
    hosts = pod_envs[0]["TPU_WORKER_HOSTNAMES"].split(",")
    dns = StubDNS({f"{hosts[0]}.svc.cluster.local": "127.0.3.10"})
    try:
        envs = [rank_env(0, hosts, 0, dns, f"127.0.3.{10 + r}")
                for r in range(2)]
        for env, pod_env in zip(envs, pod_envs):
            env.update(pod_env, KTPU_CHECKPOINT_DIR=str(tmp_path),
                       KTPU_JOB_NAME=f"default/{gang}")
        results = await asyncio.to_thread(run_gang, TRAINER, envs)
    finally:
        dns.close()
    for rank, (rc, out) in enumerate(results):
        assert rc == 0, out
        done = [ln for ln in out.splitlines() if ln.startswith("TRAINER DONE")]
        assert len(done) == 1 and done[0].startswith(
            f"TRAINER DONE rank={rank} start=0 final=4 "), out
    ckpt_dir = os.path.join(str(tmp_path), "default", gang)
    for rank in range(2):
        rec = json.load(open(os.path.join(
            ckpt_dir, f"attempt-rank{rank}-start0.json")))
        assert (rec["resumed_from"], rec["final_step"],
                rec["steps_run"]) == (0, 4, 4)
    assert ckpt.latest_step(ckpt_dir) == 3
    assert read_marker(ckpt_dir) == 3
