"""The device-plugin API and the GPU device plugin (``gpu_plugin``).

Nothing is imported here: ``gpu_plugin`` and ``stub`` work without
``grpc`` and ``protobuf``, which only ``service`` and the gRPC edge of
``stub`` import.
"""
