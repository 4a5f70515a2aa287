"""The node layer on the GPU side: the runtime hook and the per-chip
telemetry (``runtimehook``, ``telemetry``)."""
