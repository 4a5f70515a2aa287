"""Multi-process rendezvous from framework-injected env + cluster DNS.

Counterpart of ``kubernetes_tpu/workloads/rendezvous.py``: a gang's N
pods find each other with no external coordinator, using only what the
framework provides, and then call ``torch.distributed.init_process_group``
where the reference calls ``jax.distributed.initialize``:

- ``TPU_WORKER_ID``         this pod's rank (Indexed Job / StatefulSet),
- ``TPU_WORKER_HOSTNAMES``  comma list of rank hostnames (rank order),
- ``KTPU_DNS_SERVER``       the cluster DNS address,
- ``KTPU_COORD_PORT``       coordinator port (optional, default 8476),
- ``POD_IP``                this pod's IP (agent-injected).

Rank 0's hostname is resolved through the cluster DNS (a plain A/IN
query against the UDP responder), and every other rank dials
``<rank0-ip>:<port>``. The resolver half (:func:`dns_query` to
:func:`resolve_coordinator`) is the reference's, copied unchanged: the
port imports nothing of the reference package.

Rank 0 holds the rendezvous store (``torch.distributed.TCPStore``) on a
socket it binds to its own ``POD_IP`` and hands to the store, so two
gangs on one host (pods with loopback IPs, or two jobs on one node) can
share a coordinator port without colliding.
"""
from __future__ import annotations

import datetime
import os
import random
import socket
import struct
import time
from typing import Optional

import torch

DEFAULT_COORD_PORT = 8476

#: The collective backend for each device type of the trainer.
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def dns_query(name: str, server: str, timeout: float = 2.0) -> Optional[str]:
    """One A/IN query against the cluster DNS; first IP or None."""
    host, _, port = server.partition(":")
    txn = random.randrange(1 << 16)
    q = struct.pack("!HHHHHH", txn, 0x0100, 1, 0, 0, 0)
    for label in name.strip(".").split("."):
        q += bytes([len(label)]) + label.encode()
    q += b"\x00" + struct.pack("!HH", 1, 1)  # QTYPE=A, QCLASS=IN
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.settimeout(timeout)
        s.sendto(q, (host, int(port or 53)))
        try:
            data, _ = s.recvfrom(512)
        except socket.timeout:
            return None
    if len(data) < 12 or struct.unpack("!H", data[:2])[0] != txn:
        return None
    flags, _qd, an = struct.unpack("!HHH", data[2:8])
    if flags & 0x000F or an == 0:  # RCODE != NOERROR, or no answers
        return None
    # Skip the question section, then parse the first A answer.
    pos = 12
    while pos < len(data) and data[pos] != 0:
        pos += 1 + data[pos]
    pos += 5  # root label + qtype + qclass
    for _ in range(an):
        if pos + 12 > len(data):
            return None
        if data[pos] & 0xC0:  # compressed name pointer
            pos += 2
        else:
            while pos < len(data) and data[pos] != 0:
                pos += 1 + data[pos]
            pos += 1
        if pos + 10 > len(data):
            return None  # truncated/malformed RR header: treat as NXDOMAIN
        rtype, _rclass, _ttl, rdlen = struct.unpack(
            "!HHIH", data[pos: pos + 10])
        pos += 10
        if rtype == 1 and rdlen == 4:
            return ".".join(str(b) for b in data[pos: pos + 4])
        pos += rdlen
    return None


def _fqdn(hostname: str, domain: str = "cluster.local") -> str:
    """Short rank hostnames (``<pod>.<svc>.<ns>``) -> DNS FQDN."""
    name = hostname.strip(".")
    return name if name.endswith(f".svc.{domain}") else f"{name}.svc.{domain}"


#: Capped-exponential retry shape for DNS resolution and coordinator
#: dial probes: base doubles per attempt up to the cap, with full jitter
#: so N ranks restarting together don't probe in lockstep.
BACKOFF_BASE = 0.1
BACKOFF_CAP = 2.0


def _backoff(attempt: int, rng: Optional[random.Random] = None) -> float:
    """Full-jitter capped-exponential delay for ``attempt`` (0-based).
    The exponent is clamped — a long-timeout resolver loops thousands
    of attempts, and 2**attempt would overflow float long before the
    deadline."""
    cap = min(BACKOFF_CAP, BACKOFF_BASE * (2 ** min(attempt, 16)))
    return (rng or random).uniform(0.0, cap)


def resolve_rank0(timeout: float = 60.0) -> str:
    """Resolve rank 0's pod IP via the cluster DNS, retrying until the
    coordinator pod is scheduled, running, and in Endpoints (the
    rendezvous race every multi-host bootstrap has). Every attempt is
    a FRESH query — nothing here may cache: after a gang recovery
    round the replacement rank-0 pod has a new IP, and a cached answer
    would wedge the whole gang until its init timeout."""
    hostnames = os.environ["TPU_WORKER_HOSTNAMES"].split(",")
    dns = os.environ["KTPU_DNS_SERVER"]
    name = _fqdn(hostnames[0])
    deadline = time.monotonic() + timeout
    attempt = 0
    while True:
        ip = dns_query(name, dns)
        if ip:
            return ip
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"rank-0 hostname {name!r} did not resolve via {dns} "
                f"within {timeout}s")
        time.sleep(min(_backoff(attempt),
                       max(deadline - time.monotonic(), 0.0)))
        attempt += 1


def coordinator_reachable(ip: str, port: int,
                          timeout: float = 1.0) -> bool:
    """One bounded TCP dial of the coordinator address. True only when
    something ACCEPTS on the port — rank 0 binds it in
    :func:`initialize_from_env`, so a refused/timed-out dial means the
    coordinator is not up (yet, or anymore)."""
    try:
        with socket.create_connection((ip, int(port)), timeout=timeout):
            return True
    except OSError:
        return False


def resolve_coordinator(port: int, timeout: float = 60.0) -> str:
    """Resolve AND dial: rank 0's current IP, verified accepting on the
    coordinator port.

    The re-resolve-after-recovery contract: each attempt re-queries the
    cluster DNS from scratch, so when a gang recovery round replaces
    the rank-0 pod (new IP), a non-zero rank that resolved the OLD pod
    keeps probing, sees the dial fail, and picks up the fresh record on
    the next loop instead of handing the process group a dead address
    and wedging until its own timeout."""
    deadline = time.monotonic() + timeout
    attempt = 0
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise TimeoutError(
                f"coordinator did not accept on port {port} within "
                f"{timeout}s")
        try:
            ip = resolve_rank0(timeout=max(remaining, 0.1))
        except TimeoutError:
            raise TimeoutError(
                f"rank-0 did not resolve within {timeout}s") from None
        if coordinator_reachable(ip, port,
                                 timeout=min(1.0, max(remaining, 0.1))):
            return ip
        time.sleep(min(_backoff(attempt),
                       max(deadline - time.monotonic(), 0.0)))
        attempt += 1


def _listening_fd(bind_ip: str, port: int) -> int:
    """A socket bound to ``bind_ip:port`` and listening, as a bare file
    descriptor for ``TCPStore(master_listen_fd=...)``. Detached from its
    Python object, so the store's own thread is the only owner and
    nothing closes the socket under it at interpreter exit."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind((bind_ip, port))
        sock.listen(128)
    except OSError:
        sock.close()
        raise
    return sock.detach()


def init_process_group(coord_ip: str, port: int, rank: int, world: int,
                       backend: str, timeout: float = 60.0,
                       bind_ip: Optional[str] = None) -> None:
    """The default process group of ``world`` ranks over a ``TCPStore``
    at ``coord_ip:port``. Rank 0 serves the store on its own socket,
    bound to ``bind_ip`` (all addresses when it is empty or None); the
    other ranks connect to it. Raises when the rendezvous does not
    complete within ``timeout`` seconds."""
    from torch import distributed as dist
    wait = datetime.timedelta(seconds=timeout)
    if rank == 0:
        store = dist.TCPStore(
            coord_ip, port, world, True, timeout=wait,
            wait_for_workers=False, use_libuv=False,
            master_listen_fd=_listening_fd(bind_ip or "", port))
    else:
        store = dist.TCPStore(coord_ip, port, world, False, timeout=wait,
                              use_libuv=False)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world, timeout=wait)


def barrier(group, device: torch.device) -> None:
    """Wait for every rank of ``group``; on NCCL, on ``device``'s card."""
    from torch import distributed as dist
    dist.barrier(group=group, device_ids=(
        [device.index] if device.type == "cuda" else None))


def initialize_from_env(timeout: float = 60.0, device=None) -> int:
    """``torch.distributed.init_process_group`` from framework env;
    returns the rank.

    The backend follows ``device`` (``nccl`` on ``cuda``, the default;
    ``gloo`` on ``cpu``). With one hostname there is nothing to
    rendezvous: returns 0 and makes no process group. Rank 0 serves the
    store on its own ``POD_IP`` (all addresses when it has none, as the
    reference's coordinator does); the others resolve and dial it first.
    Call :func:`torch.distributed.destroy_process_group` before exit."""
    rank = int(os.environ["TPU_WORKER_ID"])
    n = len(os.environ["TPU_WORKER_HOSTNAMES"].split(","))
    port = int(os.environ.get("KTPU_COORD_PORT", DEFAULT_COORD_PORT))
    backend = BACKENDS[torch.device(device or "cuda").type]
    if n == 1:
        return 0  # single-process: nothing to rendezvous
    pod_ip = os.environ.get("POD_IP", "")
    coord_ip = pod_ip if rank == 0 else resolve_coordinator(port, timeout)
    if not coord_ip:
        coord_ip = resolve_rank0(timeout)
    # Rank 0 binds its OWN pod IP, not the wildcard: pod IPs are unique
    # (loopback-range locally, CNI-assigned on real hosts), so a stale
    # coordinator from a torn-down gang incarnation — or another job on
    # the same host — can never collide on the port and crash-loop the
    # fresh gang into its backoff limit.
    init_process_group(coord_ip, port, rank, n, backend, timeout,
                       bind_ip=pod_ip if rank == 0 else None)
    return rank
