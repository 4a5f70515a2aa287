"""The device plugin's service, on a plain topology.

Counterpart of ``kubernetes_tpu/deviceplugin/stub.py``: the gRPC
service of the device-plugin API (``GetPluginInfo``, ``ListAndWatch``,
``AdmitPod``, ``InitContainer``) over the one topology the plugin
holds for its life. The reference's node agent
(``kubernetes_tpu/node/devicemanager.py``) talks to it unchanged: the
method paths, messages and socket are the same.

The topology is a plain dataclass, turned into a ``TopologyUpdate``
message only at the gRPC edge; ``grpc`` and the generated messages are
imported only by the RPC methods and :meth:`StubGpuPlugin.serve`. So
the topology, the admission rule and the container env need neither
``grpc`` nor ``protobuf`` (:meth:`admit`, :meth:`container_env`).
"""
from __future__ import annotations

import dataclasses
import os
import threading
from typing import Iterator, Optional


@dataclasses.dataclass
class Chip:
    """One device: its id, health ("Healthy" or "Unhealthy"), coords in
    the mesh and string attributes."""
    id: str
    health: str = "Healthy"
    coords: list = dataclasses.field(default_factory=list)
    attributes: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Topology:
    """What ``ListAndWatch`` streams: the ``TopologyUpdate`` message of
    ``api.proto`` as a plain dataclass."""
    chip_type: str
    slice_id: str
    mesh_shape: list
    worker_index: int = 0
    chips: list = dataclasses.field(default_factory=list)


def to_update(topology: Topology):
    """``topology`` as the ``TopologyUpdate`` message."""
    from . import api_pb2 as pb
    update = pb.TopologyUpdate(chip_type=topology.chip_type,
                               slice_id=topology.slice_id,
                               mesh_shape=list(topology.mesh_shape),
                               worker_index=topology.worker_index)
    for chip in topology.chips:
        update.chips.add(id=chip.id, health=chip.health,
                         coords=list(chip.coords),
                         attributes=dict(chip.attributes))
    return update


class StubGpuPlugin:
    """The servicer: serves one topology under one resource name."""

    def __init__(self, topology: Topology, resource: str):
        self.resource = resource
        self._topology = topology
        self._stopped = threading.Event()
        self._server = None
        self.socket_path: Optional[str] = None

    # -- plain rules, no grpc -------------------------------------------

    def admit(self, chip_ids) -> tuple[bool, str]:
        """``(allowed, reason)``: every chip must be one of this plugin's."""
        known = {c.id for c in self._topology.chips}
        missing = [c for c in chip_ids if c not in known]
        if missing:
            return False, f"unknown chips {missing}"
        return True, ""

    def container_env(self, chip_ids) -> dict:
        """The env a container of ``chip_ids`` starts with: the chips,
        the chip type, the slice, the worker index, the mesh and the
        chips' coords, as the reference's plugin sets them."""
        topo = self._topology
        coords = {c.id: c.coords for c in topo.chips}
        return {
            "TPU_VISIBLE_CHIPS": ",".join(chip_ids),
            "TPU_CHIP_TYPE": topo.chip_type,
            "TPU_SLICE_ID": topo.slice_id,
            "TPU_WORKER_ID": str(topo.worker_index),
            "TPU_MESH_SHAPE": "x".join(str(d) for d in topo.mesh_shape),
            "TPU_CHIP_COORDS": ";".join(
                ",".join(map(str, coords[cid])) for cid in chip_ids
                if cid in coords),
        }

    # -- the service: messages only here ----------------------------------

    def GetPluginInfo(self, request, context):
        from . import api_pb2 as pb
        return pb.PluginInfo(resource=self.resource, version="v1")

    def ListAndWatch(self, request, context) -> Iterator:
        """The topology, then an open stream until the plugin stops or
        the watcher leaves: nothing here changes it."""
        yield to_update(self._topology)
        while context.is_active() and not self._stopped.wait(0.5):
            pass

    def AdmitPod(self, request, context):
        from . import api_pb2 as pb
        allowed, reason = self.admit(list(request.chip_ids))
        return pb.AdmitPodResponse(allowed=allowed, reason=reason)

    def InitContainer(self, request, context):
        from . import api_pb2 as pb
        ids = list(request.chip_ids)
        resp = pb.InitContainerResponse(envs=self.container_env(ids))
        resp.annotations["tpu.dev/chips"] = ",".join(ids)
        return resp

    # -- lifecycle --------------------------------------------------------

    def serve(self, socket_path: str) -> None:
        """Serve on the unix socket ``socket_path``, where a node agent
        watching its plugin directory finds it."""
        from concurrent import futures

        import grpc

        from .service import add_servicer_to_server
        if os.path.exists(socket_path):
            os.unlink(socket_path)
        os.makedirs(os.path.dirname(socket_path), exist_ok=True)
        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=8))
        add_servicer_to_server(self, self._server)
        self._server.add_insecure_port(f"unix://{socket_path}")
        self._server.start()
        self._stopped.clear()
        self.socket_path = socket_path

    def stop(self) -> None:
        self._stopped.set()
        if self._server:
            self._server.stop(grace=0.2)
            self._server = None
        if self.socket_path and os.path.exists(self.socket_path):
            os.unlink(self.socket_path)
