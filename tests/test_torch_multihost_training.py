"""The port's multi-process trainer THROUGH the framework, on the CPU.

The port of ``tests/e2e/test_multihost_training.py``: a gang Job's N pods
are N real OS processes of ``kubernetes_tpu_torch.workloads.
distributed_demo`` (``KTPU_TRAINER_PLATFORM=cpu``) that rendezvous using
only framework-provided machinery — Job-controller rank env
(TPU_WORKER_ID/TPU_WORKER_HOSTNAMES), agent-injected POD_IP and
KTPU_DNS_SERVER, cluster DNS rank-hostname records over real loopback
pod IPs — into a ``torch.distributed`` gloo group, run the counting loop
with cross-process all-reduces, and exit 0.

A SIGKILL of one member mid-run tears the whole gang down and recreates
it, and the recreated gang resumes from the last committed step: the
exact final value proves no step was lost or repeated. The same gang
with ``MODEL=lm`` resumes past step 0 and re-runs fewer steps than a
restart from scratch (``hack/train_smoke.sh``'s assertions).

Each gang takes its coordinator port from the OS.
"""
import glob
import json
import os
import signal
import sys

import pytest

pytest.importorskip(
    "cryptography",
    reason="tls=True LocalCluster / PKI paths are environmental without it")

from kubernetes_tpu.api import types as t  # noqa: E402
from kubernetes_tpu.api import workloads as w  # noqa: E402
from kubernetes_tpu.api.meta import ObjectMeta  # noqa: E402
from kubernetes_tpu.cluster.local import NodeSpec  # noqa: E402
from kubernetes_tpu_torch.workloads import checkpoint as ckpt  # noqa: E402

from tests.e2e.test_local_cluster import fast_cluster, wait_for  # noqa: E402
from tests.test_torch_rendezvous import free_port  # noqa: E402

N_WORKERS = 2


def _headless_service(name: str) -> t.Service:
    return t.Service(
        metadata=ObjectMeta(name=name, namespace="default"),
        spec=t.ServiceSpec(cluster_ip="None",
                           selector={"job.tpu/name": "train"},
                           ports=[t.ServicePort(port=8476)]))


def _train_job(ckpt_dir: str, total_steps: int, step_delay: float = 0.0,
               backoff_limit: int = 6,
               module: str = "kubernetes_tpu_torch.workloads.distributed_demo",
               **extra) -> w.Job:
    env = [t.EnvVar(name=k, value=str(v)) for k, v in {
        "TOTAL_STEPS": total_steps, "STEP_DELAY": step_delay,
        "CKPT_DIR": ckpt_dir, "KTPU_TRAINER_PLATFORM": "cpu",
        "KTPU_COORD_PORT": free_port(), "OMP_NUM_THREADS": 1,
        **extra}.items()]
    template = w.PodTemplateSpec(spec=t.PodSpec(
        restart_policy="Never",
        subdomain="train-svc",
        termination_grace_period_seconds=1,
        containers=[t.Container(
            name="worker", image="inline",
            command=[sys.executable, "-m", module],
            env=env)]))
    return w.Job(
        metadata=ObjectMeta(name="train", namespace="default"),
        spec=w.JobSpec(parallelism=N_WORKERS, completions=N_WORKERS,
                       completion_mode="Indexed",
                       backoff_limit=backoff_limit,
                       template=template,
                       gang=w.GangPolicy(min_member=N_WORKERS)))


def _expected_final(n: int, total: int) -> float:
    # Step s adds mean_over_ranks(rank + 1 + s) = (n-1)/2 + 1 + s.
    return sum((n - 1) / 2 + 1 + s for s in range(total))


async def _job_finished(client):
    job = await client.get("jobs", "default", "train")
    for c in job.status.conditions:
        if c.type in ("Complete", "Failed") and c.status == "True":
            return job
    return None


async def _started(tmp_path, job: w.Job):
    cluster = fast_cluster(tmp_path / "cluster",
                           [NodeSpec(name=f"w-{i}") for i in range(N_WORKERS)])
    await cluster.start()
    client = cluster.make_client()
    await cluster.wait_for_nodes_ready(timeout=20)
    await client.create(_headless_service("train-svc"))
    await client.create(job)
    return cluster, client


async def _kill_one_member(cluster, client, ckpt_dir: str, step: int):
    """Once a checkpoint at ``step`` or later landed, SIGKILL the real OS
    process of one running member."""
    async def progressed():
        s = ckpt.latest_step(ckpt_dir)
        return s if s is not None and s >= step else None
    await wait_for(progressed, timeout=90, interval=0.2)
    pods, _ = await client.list("pods", "default",
                                label_selector="job.tpu/name=train")
    running = [p for p in pods if p.status.phase == t.POD_RUNNING]
    assert running, [p.status.phase for p in pods]
    victim, victim_pid = running[-1], None
    for node in cluster.nodes:
        if node.name != victim.spec.node_name:
            continue
        for st in await node.runtime.list_containers():
            if st.pod_uid == victim.metadata.uid and st.pid:
                victim_pid = st.pid
    assert victim_pid, "victim pid not found"
    os.kill(victim_pid, signal.SIGKILL)


async def _completed(client, ckpt_dir: str):
    job = await wait_for(lambda: _job_finished(client), timeout=180,
                         interval=0.5)
    conds = {c.type: c.status for c in job.status.conditions}
    assert conds.get("Complete") == "True", (job.status, os.listdir(ckpt_dir))
    return job


async def test_gang_job_multiprocess_torch_distributed(tmp_path):
    """N pods = N OS processes; rendezvous via framework env + cluster
    DNS; all-reduced steps over gloo; all exit 0 with the exact value."""
    total = 6
    ckpt_dir = str(tmp_path / "ckpt")
    cluster, client = await _started(tmp_path, _train_job(ckpt_dir, total))
    try:
        job = await _completed(client, ckpt_dir)
        assert job.status.succeeded == N_WORKERS
        expect = _expected_final(N_WORKERS, total)
        for r in range(N_WORKERS):
            path = os.path.join(ckpt_dir, f"done-rank{r}-attempt0")
            assert os.path.exists(path), os.listdir(ckpt_dir)
            assert float(open(path).read()) == expect
    finally:
        await client.close()
        await cluster.stop()


async def test_gang_kill_midrun_recovers_and_resumes(tmp_path):
    """SIGKILL one member mid-run: the gang is torn down and recreated
    as a unit, and resume continues from the last committed step —
    proven by the exact final value and a nonzero resume step."""
    total = 60
    ckpt_dir = str(tmp_path / "ckpt")
    cluster, client = await _started(
        tmp_path, _train_job(ckpt_dir, total, step_delay=0.25))
    try:
        await _kill_one_member(cluster, client, ckpt_dir, 3)
        await _completed(client, ckpt_dir)
        expect = _expected_final(N_WORKERS, total)
        markers = [f for f in os.listdir(ckpt_dir) if f.startswith("done-")]
        finals = {}
        for m in markers:
            rank = int(m.split("-rank")[1].split("-")[0])
            attempt = int(m.split("-attempt")[1])
            finals.setdefault(rank, []).append(
                (attempt, float(open(os.path.join(ckpt_dir, m)).read())))
        assert set(finals) == set(range(N_WORKERS)), markers
        resumed = [a for r in finals.values() for a, _ in r if a > 0]
        assert resumed, f"no resumed attempt in {markers}"
        for r, attempts in finals.items():
            assert max(attempts)[1] == expect, (r, attempts, expect)
    finally:
        await client.close()
        await cluster.stop()


async def test_lm_gang_kill_midrun_resumes_from_its_checkpoint(tmp_path):
    """The LM under the same gang: SIGKILL one member after a checkpoint
    landed; the recreated gang resumes past step 0 and re-runs strictly
    fewer steps than a restart from scratch."""
    total = 16
    ckpt_dir = str(tmp_path / "ckpt")
    cluster, client = await _started(tmp_path, _train_job(
        ckpt_dir, total, step_delay=0.4,
        module="kubernetes_tpu_torch.workloads.trainer", MODEL="lm",
        CHECKPOINT_EVERY=2))
    try:
        await _kill_one_member(cluster, client, ckpt_dir, 3)
        await _completed(client, ckpt_dir)
        records = []
        for path in glob.glob(os.path.join(ckpt_dir, "attempt-*.json")):
            with open(path) as f:
                records.append(json.load(f))
        resumed = [r for r in records if r["resumed_from"] > 0]
        assert resumed, f"no resumed attempt: {records}"
        assert {r["rank"] for r in resumed} == set(range(N_WORKERS))
        for r in resumed:
            assert r["steps_run"] < total and r["final_step"] == total, r
            assert not r["preempted"], r
    finally:
        await client.close()
        await cluster.stop()
