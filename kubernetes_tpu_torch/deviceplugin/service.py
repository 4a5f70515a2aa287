"""The gRPC edge of the device-plugin API: the handlers that serve a
plugin and the client that reads one.

Counterpart of ``kubernetes_tpu/deviceplugin/service.py``, with the
same ``SERVICE`` path and messages (``api.proto``, ``api_pb2.py``), so
the reference's node agent and this client talk to either plugin. The
handlers are built with grpc's generic handler API, as generated
``*_pb2_grpc.py`` code would build them.
"""
from __future__ import annotations

from typing import Iterator

import grpc

from . import api_pb2 as pb

SERVICE = "tpudeviceplugin.v1.TpuDevicePlugin"


def add_servicer_to_server(servicer, server: grpc.Server) -> None:
    """Route the four RPCs of ``SERVICE`` to ``servicer``'s methods of
    the same names (``deviceplugin/stub.py``'s ``StubGpuPlugin``)."""
    handlers = {
        "GetPluginInfo": grpc.unary_unary_rpc_method_handler(
            servicer.GetPluginInfo,
            request_deserializer=pb.Empty.FromString,
            response_serializer=pb.PluginInfo.SerializeToString),
        "ListAndWatch": grpc.unary_stream_rpc_method_handler(
            servicer.ListAndWatch,
            request_deserializer=pb.Empty.FromString,
            response_serializer=pb.TopologyUpdate.SerializeToString),
        "AdmitPod": grpc.unary_unary_rpc_method_handler(
            servicer.AdmitPod,
            request_deserializer=pb.AdmitPodRequest.FromString,
            response_serializer=pb.AdmitPodResponse.SerializeToString),
        "InitContainer": grpc.unary_unary_rpc_method_handler(
            servicer.InitContainer,
            request_deserializer=pb.InitContainerRequest.FromString,
            response_serializer=pb.InitContainerResponse.SerializeToString),
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(SERVICE, handlers),))


class DevicePluginClient:
    """Blocking client of a plugin on a unix socket."""

    def __init__(self, socket_path: str):
        self.socket_path = socket_path
        self._channel = grpc.insecure_channel(f"unix://{socket_path}")
        p = f"/{SERVICE}/"
        self._get_info = self._channel.unary_unary(
            p + "GetPluginInfo", request_serializer=pb.Empty.SerializeToString,
            response_deserializer=pb.PluginInfo.FromString)
        self._law = self._channel.unary_stream(
            p + "ListAndWatch", request_serializer=pb.Empty.SerializeToString,
            response_deserializer=pb.TopologyUpdate.FromString)
        self._admit = self._channel.unary_unary(
            p + "AdmitPod",
            request_serializer=pb.AdmitPodRequest.SerializeToString,
            response_deserializer=pb.AdmitPodResponse.FromString)
        self._init = self._channel.unary_unary(
            p + "InitContainer",
            request_serializer=pb.InitContainerRequest.SerializeToString,
            response_deserializer=pb.InitContainerResponse.FromString)

    def get_plugin_info(self, timeout: float = 5.0) -> pb.PluginInfo:
        return self._get_info(pb.Empty(), timeout=timeout)

    def list_and_watch(self) -> Iterator[pb.TopologyUpdate]:
        return self._law(pb.Empty())

    def admit_pod(self, namespace: str, name: str, uid: str,
                  chip_ids: list[str],
                  timeout: float = 5.0) -> pb.AdmitPodResponse:
        return self._admit(pb.AdmitPodRequest(
            pod_namespace=namespace, pod_name=name, pod_uid=uid,
            chip_ids=chip_ids), timeout=timeout)

    def init_container(self, namespace: str, name: str, uid: str,
                       container: str, chip_ids: list[str],
                       timeout: float = 5.0) -> pb.InitContainerResponse:
        return self._init(pb.InitContainerRequest(
            pod_namespace=namespace, pod_name=name, pod_uid=uid,
            container_name=container, chip_ids=chip_ids), timeout=timeout)

    def close(self) -> None:
        self._channel.close()
