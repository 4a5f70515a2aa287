"""The metrics primitive the node telemetry exports through."""
