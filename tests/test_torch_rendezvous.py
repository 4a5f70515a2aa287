"""The port's ``workloads/rendezvous.py`` against the reference's.

The resolver half (``dns_query`` .. ``resolve_coordinator``) is a copy of
``kubernetes_tpu/workloads/rendezvous.py``; the reference's own cases
(``tests/unit/test_rendezvous.py``) run here against the port's copy,
over the reference's real cluster-DNS responder, and the pure helpers
agree with the reference's on the same inputs.

The process-group half runs in subprocesses over gloo on the CPU: each
waits with a timeout, and every port comes from the OS. Two world-2
gangs on one host, with different ``POD_IP``s and the same coordinator
port, both initialise: rank 0's store listens on its own pod IP only.

:class:`StubDNS` and :func:`free_port` serve the trainer tests too.
"""
import asyncio
import os
import random
import socket
import struct
import subprocess
import sys
import threading
from pathlib import Path

import pytest

from kubernetes_tpu.api import types as t
from kubernetes_tpu.api.meta import ObjectMeta
from kubernetes_tpu.net.dns import ClusterDNS
from kubernetes_tpu.workloads import rendezvous as ref
from kubernetes_tpu_torch.workloads import rendezvous as rdz

from tests.controllers.util import make_plane

ROOT = Path(__file__).resolve().parent.parent
#: Seconds a subprocess of these tests may take before it counts as hung.
PROC_TIMEOUT = 120


def free_port() -> int:
    """A TCP port the OS reports free on every address."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("", 0))
        return s.getsockname()[1]


class StubDNS:
    """A cluster-DNS stand-in for processes outside a cluster: answers
    A/IN queries for a fixed ``{fqdn: ip}`` map over UDP on localhost,
    NXDOMAIN for anything else."""

    def __init__(self, records: dict):
        self.records = dict(records)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind(("127.0.0.1", 0))
        self._sock.settimeout(0.1)
        self.address = "127.0.0.1:%d" % self._sock.getsockname()[1]
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self) -> None:
        while not self._stop.is_set():
            try:
                data, peer = self._sock.recvfrom(512)
            except socket.timeout:
                continue
            pos, labels = 12, []
            while data[pos]:
                labels.append(data[pos + 1:pos + 1 + data[pos]].decode())
                pos += 1 + data[pos]
            ip = self.records.get(".".join(labels))
            flags, answers = (0x8180, 1) if ip else (0x8183, 0)
            reply = (data[:2] + struct.pack("!HHHHH", flags, 1, answers, 0, 0)
                     + data[12:pos + 5])
            if ip:
                reply += struct.pack("!HHHIH", 0xC00C, 1, 1, 5, 4) \
                    + socket.inet_aton(ip)
            self._sock.sendto(reply, peer)

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)
        self._sock.close()


@pytest.fixture
def stub_dns():
    dns = StubDNS({})
    yield dns
    dns.close()


def rank_env(rank: int, hostnames: list, port: int, dns: StubDNS,
             pod_ip: str, **extra) -> dict:
    """The env a gang member gets from the framework, for a process run
    on the CPU from the repository root, on one thread (the suite runs
    many such processes beside other tests)."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPU_", "KTPU_", "POD_"))}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               TPU_WORKER_ID=str(rank),
               TPU_WORKER_HOSTNAMES=",".join(hostnames),
               KTPU_COORD_PORT=str(port), POD_IP=pod_ip,
               KTPU_DNS_SERVER=dns.address, KTPU_TRAINER_PLATFORM="cpu",
               **extra)
    return env


def run_gang(cmd: list, envs: list, timeout: float = PROC_TIMEOUT) -> list:
    """Starts one process per env, all at once, and waits for each with
    a timeout; a process still running then is killed and the test
    fails. Returns ``[(returncode, stdout + stderr)]``."""
    procs = [subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for env in envs]
    results = []
    try:
        for proc in procs:
            out, _ = proc.communicate(timeout=timeout)
            results.append((proc.returncode, out))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return results


# -- the reference's cases, against the port's copy ------------------------

def _service(name="tj-workers", ns="default"):
    return t.Service(metadata=ObjectMeta(name=name, namespace=ns),
                     spec=t.ServiceSpec(cluster_ip="None",
                                        ports=[t.ServicePort(port=8476)]))


def _endpoints(addrs, name="tj-workers", ns="default"):
    return t.Endpoints(
        metadata=ObjectMeta(name=name, namespace=ns),
        subsets=[t.EndpointSubset(addresses=[
            t.EndpointAddress(ip=ip, hostname=host)
            for host, ip in addrs])])


async def _dns(objs):
    _reg, client, _ = make_plane()
    for obj in objs:
        await client.create(obj)
    dns = ClusterDNS(client)
    await dns.start()
    return dns, client


def _rank_env(monkeypatch, dns):
    monkeypatch.setenv("TPU_WORKER_HOSTNAMES",
                       "tj-0.tj-workers.default,tj-1.tj-workers.default")
    monkeypatch.setenv("KTPU_DNS_SERVER", dns.address)


async def test_resolve_rank0_over_the_wire(monkeypatch):
    dns, _ = await _dns([
        _service(),
        _endpoints([("tj-0", "127.0.0.2"), ("tj-1", "127.0.0.3")])])
    try:
        _rank_env(monkeypatch, dns)
        assert await asyncio.to_thread(rdz.resolve_rank0, 5.0) == "127.0.0.2"
        assert await asyncio.to_thread(
            rdz.dns_query, "tj-0.tj-workers.default.svc.cluster.local",
            dns.address) == "127.0.0.2"
    finally:
        await dns.stop()


async def test_retry_until_registered(monkeypatch):
    dns, client = await _dns([_service()])  # no endpoints yet
    try:
        _rank_env(monkeypatch, dns)
        resolver = asyncio.create_task(
            asyncio.to_thread(rdz.resolve_rank0, 10.0))
        await asyncio.sleep(0.4)  # several NXDOMAIN rounds
        assert not resolver.done()
        await client.create(_endpoints([("tj-0", "127.0.0.4")]))
        assert await resolver == "127.0.0.4"
    finally:
        await dns.stop()


async def test_re_resolve_after_coordinator_restart(monkeypatch):
    dns, client = await _dns([
        _service(), _endpoints([("tj-0", "127.0.0.2")])])
    lsn = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    lsn.bind(("127.0.0.1", 0))
    lsn.listen(1)
    port = lsn.getsockname()[1]
    try:
        _rank_env(monkeypatch, dns)
        resolver = asyncio.create_task(
            asyncio.to_thread(rdz.resolve_coordinator, port, 15.0))
        await asyncio.sleep(0.4)  # dials of the dead IP fail + retry
        assert not resolver.done()
        ep = await client.get("endpoints", "default", "tj-workers")
        ep.subsets = _endpoints([("tj-0", "127.0.0.1")]).subsets
        await client.update(ep)
        assert await resolver == "127.0.0.1"
    finally:
        lsn.close()
        await dns.stop()


async def test_resolve_rank0_times_out(monkeypatch):
    dns, _ = await _dns([_service()])
    try:
        _rank_env(monkeypatch, dns)
        with pytest.raises(TimeoutError, match="did not resolve"):
            await asyncio.to_thread(rdz.resolve_rank0, 0.6)
    finally:
        await dns.stop()


def test_backoff_is_capped_exponential_with_jitter():
    rng = random.Random(7)
    delays = [rdz._backoff(a, rng) for a in range(12)]
    for a, d in enumerate(delays):
        assert 0.0 <= d <= min(rdz.BACKOFF_CAP, rdz.BACKOFF_BASE * (2 ** a))
    assert len({round(d, 6) for d in delays}) > 3


def test_coordinator_reachable_probe():
    lsn = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    lsn.bind(("127.0.0.1", 0))
    lsn.listen(1)
    port = lsn.getsockname()[1]
    try:
        assert rdz.coordinator_reachable("127.0.0.1", port)
    finally:
        lsn.close()
    assert not rdz.coordinator_reachable("127.0.0.1", port, timeout=0.2)


# -- parity of the copied helpers with the reference's ---------------------

async def test_dns_query_matches_the_reference():
    dns, _ = await _dns([
        _service(),
        _endpoints([("tj-0", "127.0.0.2"), ("tj-1", "127.0.0.3")])])
    names = ["tj-0.tj-workers.default.svc.cluster.local",
             "tj-1.tj-workers.default.svc.cluster.local.",
             "tj-2.tj-workers.default.svc.cluster.local",
             "tj-workers.default.svc.cluster.local", "nothing.example"]
    try:
        for name in names:
            got = await asyncio.to_thread(rdz.dns_query, name, dns.address)
            want = await asyncio.to_thread(ref.dns_query, name, dns.address)
            assert got == want, name
        assert got is None
    finally:
        await dns.stop()


@pytest.mark.parametrize("name", [
    "tj-0.tj-workers.default", "tj-0.tj-workers.default.",
    ".a.b.c", "tj-0.tj-workers.default.svc.cluster.local",
    "x.svc.cluster.local.", "plain"])
def test_fqdn_matches_the_reference(name):
    assert rdz._fqdn(name) == ref._fqdn(name)
    assert rdz._fqdn(name, "corp.example") == ref._fqdn(name, "corp.example")


def test_backoff_matches_the_reference():
    assert (rdz.BACKOFF_BASE, rdz.BACKOFF_CAP, rdz.DEFAULT_COORD_PORT) == (
        ref.BACKOFF_BASE, ref.BACKOFF_CAP, ref.DEFAULT_COORD_PORT)
    mine, theirs = random.Random(11), random.Random(11)
    for attempt in range(40):
        assert rdz._backoff(attempt, mine) == ref._backoff(attempt, theirs)


def test_stub_dns_speaks_the_reference_wire_format():
    dns = StubDNS({"a.b.svc.cluster.local": "127.0.0.9"})
    try:
        for query in (rdz.dns_query, ref.dns_query):
            assert query("a.b.svc.cluster.local", dns.address) == "127.0.0.9"
            assert query("c.b.svc.cluster.local", dns.address) is None
    finally:
        dns.close()


# -- the process group -----------------------------------------------------

#: One gang member: rendezvous from env, one all-reduce, the checks of
#: rank 0's listening address, then a clean teardown.
_MEMBER = r"""
import json, os, sys
import torch
from torch import distributed as dist
from kubernetes_tpu_torch.workloads import rendezvous
rank = rendezvous.initialize_from_env(timeout=30.0, device="cpu")
port = int(os.environ["KTPU_COORD_PORT"])
x = torch.tensor([float(rank + 1)])
dist.all_reduce(x)
probe = {}
if rank == 0:
    other = os.environ.get("PROBE_OTHER_IP")
    probe["own"] = rendezvous.coordinator_reachable(os.environ["POD_IP"], port)
    if other:
        probe["other"] = rendezvous.coordinator_reachable(other, port)
dist.barrier()
print(json.dumps({"rank": rank, "sum": x.item(), "world": dist.get_world_size(),
                  "backend": dist.get_backend(), "probe": probe}))
dist.destroy_process_group()
"""


def _member_reports(results):
    import json
    reports = []
    for rc, out in results:
        assert rc == 0, out
        reports.append(json.loads(out.strip().splitlines()[-1]))
    return reports


def test_two_gangs_share_a_port_on_one_host(stub_dns):
    """Two world-2 gangs whose rank-0 pods have different IPs on one
    host and the same coordinator port: both rendezvous, each sums its
    own ranks, and rank 0's store accepts on its own pod IP only."""
    port = free_port()
    gangs = {"a": "127.0.0.21", "b": "127.0.0.22"}
    envs = []
    for gang, ip in gangs.items():
        hosts = [f"{gang}-{r}.{gang}-workers.default" for r in range(2)]
        stub_dns.records[f"{hosts[0]}.svc.cluster.local"] = ip
        for rank in range(2):
            envs.append(rank_env(rank, hosts, port, stub_dns,
                                 ip if rank == 0 else f"127.0.1.{rank}",
                                 PROBE_OTHER_IP="127.0.0.23"))
    reports = _member_reports(run_gang(
        [sys.executable, "-c", _MEMBER], envs))
    assert [r["rank"] for r in reports] == [0, 1, 0, 1]
    assert all(r["sum"] == 3.0 and r["world"] == 2 and r["backend"] == "gloo"
               for r in reports)
    for r in reports[::2]:
        assert r["probe"] == {"own": True, "other": False}


def test_world_of_one_makes_no_process_group(monkeypatch):
    monkeypatch.setenv("TPU_WORKER_ID", "0")
    monkeypatch.setenv("TPU_WORKER_HOSTNAMES", "solo-0.solo.default")
    monkeypatch.delenv("KTPU_DNS_SERVER", raising=False)
    from torch import distributed as dist
    assert rdz.initialize_from_env(timeout=1.0, device="cpu") == 0
    assert not dist.is_initialized()


def test_backend_follows_the_device():
    assert rdz.BACKENDS == {"cuda": "nccl", "cpu": "gloo"}


def test_a_member_whose_coordinator_never_comes_raises(stub_dns):
    """Rank 1 of a gang whose rank 0 never starts: the rendezvous fails
    within its timeout and the process exits non-zero."""
    port = free_port()
    hosts = ["lone-0.lone.default", "lone-1.lone.default"]
    stub_dns.records[f"{hosts[0]}.svc.cluster.local"] = "127.0.0.31"
    env = rank_env(1, hosts, port, stub_dns, "127.0.0.32")
    code = ("from kubernetes_tpu_torch.workloads import rendezvous as r\n"
            "r.initialize_from_env(timeout=2.0, device='cpu')\n")
    [(rc, out)] = run_gang([sys.executable, "-c", code], [env])
    assert rc != 0 and "TimeoutError" in out, out


def test_a_coordinator_whose_peers_never_come_raises(stub_dns):
    """Rank 0 of a world-2 gang alone: the store's wait for its peer
    ends at the timeout, and the process exits non-zero."""
    port = free_port()
    env = rank_env(0, ["alone-0.x.default", "alone-1.x.default"], port,
                   stub_dns, "127.0.0.41")
    code = ("from kubernetes_tpu_torch.workloads import rendezvous as r\n"
            "r.initialize_from_env(timeout=2.0, device='cpu')\n")
    [(rc, out)] = run_gang([sys.executable, "-c", code], [env])
    assert rc != 0, out
