"""Container runtime hook: hands a container the GPUs it was given.

Counterpart of ``kubernetes_tpu/node/runtimehook.py``, and of the
reference's docker hooks (``pkg/kubelet/dockershim/docker_hooks.go``):
JSON hook configs select containers by image prefix or pod annotation,
or by their chip requests, and the hook step, a native binary
(``native/gpu_hook.cpp``, the NVIDIA Container Runtime analog),
returns the device nodes and env that the node agent merges into the
container: each assigned GPU's node and the driver's control nodes.

A GPU's node is ``/dev/nvidia<minor>``, numbered by the driver's minor
number, which need not be NVML's index, the ``<N>`` of chip ``gpu-<N>``
(a host's only card may be ``/dev/nvidia3``). As the NVIDIA runtime
does, the hook asks NVML for each chip's minor number
(:func:`device_minors`, through the device plugin's NVML probe) and
hands the binary the chip with its minor number.

The node agent calls ``await hook.run(pod, container, chips) -> (env,
devices)`` (``kubernetes_tpu/node/agent.py``). Pods and containers are
duck-typed: ``container.tpu_requests``, ``container.image`` and
``pod.metadata.annotations`` are all the hook reads.

:func:`discover` is the same discovery in Python, the semantic source
of truth that the tests hold the binary to. The hook itself always runs
the binary: a missing g++ raises, nothing falls back.
"""
from __future__ import annotations

import asyncio
import glob
import json
import logging
import os
from dataclasses import dataclass, field
from typing import Optional

from .. import native
from ..deviceplugin import gpu_plugin

log = logging.getLogger("runtimehook")

#: The driver's control nodes a GPU container needs, where present.
CONTROL_NODES = ("nvidiactl", "nvidia-uvm", "nvidia-uvm-tools")


@dataclass
class HookConfig:
    """One hook selection rule (docker_hooks.go's JSON shape)."""
    name: str = "gpu"
    #: Match containers whose image starts with any of these.
    images: list[str] = field(default_factory=list)
    #: Match pods carrying any of these annotation keys.
    annotations: list[str] = field(default_factory=list)
    #: Always match containers that request chips.
    match_tpu_requests: bool = True

    def matches(self, pod, container) -> bool:
        if self.match_tpu_requests and getattr(container, "tpu_requests",
                                               None):
            return True
        image = getattr(container, "image", "") or ""
        if any(image.startswith(p) for p in self.images if p):
            return True
        return any(k in pod.metadata.annotations for k in self.annotations)


def load_hook_configs(hooks_dir: str) -> list[HookConfig]:
    """Every ``*.json`` hook config of ``hooks_dir`` (the reference's
    loadHooks over hooks.d); a malformed file is skipped with a log
    line."""
    configs = []
    for path in sorted(glob.glob(os.path.join(hooks_dir, "*.json"))):
        try:
            with open(path) as f:
                raw = json.load(f)
            configs.append(HookConfig(
                name=raw.get("name", os.path.basename(path)),
                images=list(raw.get("images", [])),
                annotations=list(raw.get("annotations", [])),
                match_tpu_requests=bool(raw.get("match_tpu_requests", False))))
        except (OSError, ValueError) as e:
            log.warning("skipping hook config %s: %s", path, e)
    return configs


def device_minors(library: Optional[str] = None) -> dict[str, int]:
    """``gpu-<index>`` -> the minor number of that GPU's device node,
    from the NVML probe of ``library`` (else ``libnvidia-ml.so.1``);
    empty when NVML answers no GPU."""
    probe = gpu_plugin.run_probe(gpu_plugin.nvml_probe_command(library),
                                 gpu_plugin.PROBE_TIMEOUT_S / 2)
    if not (probe and probe.get("gpu")):
        return {}
    return {f"gpu-{d['index']}": int(d["minor_number"])
            for d in probe["devices"] if "minor_number" in d}


def discover(chips: list[str], minors: dict[str, int], dev_root: str = "/dev",
             allow_missing: bool = True) -> list[str]:
    """The device nodes for a container of ``chips``: each assigned
    GPU's ``<dev_root>/nvidia<minor>`` (``minors`` as
    :func:`device_minors` gives them) in chip order, then the control
    nodes present. Raises ``RuntimeError`` when chips were assigned but
    one's node or ``nvidiactl`` is missing, unless ``allow_missing``."""
    devices, missing = [], []
    for chip in chips:
        node = (os.path.join(dev_root, f"nvidia{minors[chip]}")
                if chip in minors else "")
        if node and os.path.exists(node):
            if node not in devices:
                devices.append(node)
        else:
            missing.append(chip)
    have_ctl = os.path.exists(os.path.join(dev_root, "nvidiactl"))
    if chips and (missing or not have_ctl) and not allow_missing:
        what = (f"no device node for {missing[0]}" if missing
                else "no nvidiactl")
        raise RuntimeError(f"container assigned {len(chips)} chip(s) but "
                           f"{what} under {dev_root}")
    devices += [p for p in (os.path.join(dev_root, n) for n in CONTROL_NODES)
                if os.path.exists(p)]
    return devices


def request(chips: list[str], minors: dict[str, int], dev_root: str = "/dev",
            allow_missing: bool = True) -> str:
    """The binary's input for the same question :func:`discover`
    answers."""
    lines = [f"chip {c} {minors[c]}" if c in minors else f"chip {c}"
             for c in chips]
    if allow_missing:
        lines.append("allow-missing")
    if dev_root != "/dev":
        lines.append(f"dev-root {dev_root}")
    return "\n".join(lines) + "\n"


def parse(output: str) -> tuple[dict, list]:
    """``(env, devices)`` from the hook binary's output lines."""
    env: dict[str, str] = {}
    devices: list[str] = []
    for line in output.splitlines():
        if line.startswith("device "):
            devices.append(line[7:].strip())
        elif line.startswith("env ") and "=" in line[4:]:
            key, _, value = line[4:].partition("=")
            env[key] = value
    return env, devices


class GpuRuntimeHook:
    """Runs the hook step for matching containers. With
    ``allow_missing_devices`` (a dev box, or a host reached without its
    device nodes) a container starts without them; a strict node fails
    the start of a chip-assigned container that has no device access.
    ``library`` is the NVML library that resolves minor numbers."""

    def __init__(self, hooks_dir: str = "",
                 allow_missing_devices: bool = True,
                 dev_root: str = "/dev", library: Optional[str] = None):
        self.configs = (load_hook_configs(hooks_dir) if hooks_dir
                        else [HookConfig()])
        self.allow_missing_devices = allow_missing_devices
        self.dev_root = dev_root
        self.library = library
        self._minors: dict[str, int] = {}

    async def run(self, pod, container, assigned_chips: list[str]
                  ) -> tuple[dict[str, str], list[str]]:
        """``(env, devices)`` for the container; ``({}, [])`` when no
        config matches it. Raises ``RuntimeError`` when the binary
        refuses (strict mode without device access)."""
        if not any(c.matches(pod, container) for c in self.configs):
            return {}, []
        # The first call may compile the binary: off the event loop, so
        # a slow g++ stalls no heartbeat.
        binary = await asyncio.to_thread(native.build, "gpu_hook")
        # Minor numbers hold while the host runs; NVML is asked again
        # only for a chip it has not answered for.
        if any(c not in self._minors for c in assigned_chips):
            self._minors = await asyncio.to_thread(device_minors,
                                                   self.library)
        proc = await asyncio.create_subprocess_exec(
            binary, stdin=asyncio.subprocess.PIPE,
            stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.PIPE)
        out, err = await proc.communicate(request(
            assigned_chips, self._minors, self.dev_root,
            self.allow_missing_devices).encode())
        if proc.returncode != 0:
            raise RuntimeError(f"gpu_hook failed (exit {proc.returncode}): "
                               f"{err.decode().strip()}")
        return parse(out.decode())
