"""In-workload training metrics reporter: the live half of the
accelerator-metrics pipeline.

Counterpart of ``kubernetes_tpu/workloads/metrics_reporter.py`` with the
same file contract: the training loop publishes its step metrics to
``$KTPU_SANDBOX/training-metrics.json`` (atomic rename per write) and the
node agent's stats collector reads it (:func:`read_report`); a report
older than :data:`STALE_AFTER_SECONDS` is a dead or hung workload's.
Device memory comes from ``torch.cuda`` on a CUDA device; on the CPU a
report carries none. Wired into :func:`..lm.train`.
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional

import torch

#: A report older than this is a dead/hung workload's leftover.
STALE_AFTER_SECONDS = 120.0

REPORT_BASENAME = "training-metrics.json"


def _device_memory_stats(device) -> dict:
    """Device memory in use by this process's tensors and the card's
    total, on a CUDA device; {} elsewhere."""
    try:
        dev = torch.device(device) if device is not None else None
        if dev is None or dev.type != "cuda":
            return {}
        _, total = torch.cuda.mem_get_info(dev)
        return {"hbm_used_bytes": int(torch.cuda.memory_allocated(dev)),
                "hbm_total_bytes": int(total)}
    except Exception:  # noqa: BLE001 -- metrics must never kill training
        return {}


class TrainingMetricsReporter:
    """Publish per-step training metrics for the node agent to scrape.

    ``flops_per_token``: analytic train FLOPs per token
    (``perf.chip_bench.train_flops_per_token``); with it and a known peak
    for the card of ``device``, reports include MFU."""

    def __init__(self, path: str = "",
                 flops_per_token: Optional[float] = None,
                 peak_flops: Optional[float] = None, device=None):
        sandbox = os.environ.get("KTPU_SANDBOX", "")
        self.path = path or (os.path.join(sandbox, REPORT_BASENAME)
                             if sandbox else "")
        self.flops_per_token = flops_per_token
        self.device = device
        if peak_flops is None and flops_per_token is not None:
            try:
                from ..perf.chip_bench import peak_flops_for
                dev = torch.device(device) if device is not None else None
                if dev is not None and dev.type == "cuda":
                    peak_flops, known = peak_flops_for(
                        torch.cuda.get_device_name(dev))
                    if not known:
                        peak_flops = None  # a guessed peak makes MFU noise
            except Exception:  # noqa: BLE001
                peak_flops = None
        self.peak_flops = peak_flops

    @property
    def enabled(self) -> bool:
        return bool(self.path)

    def report(self, step: int, step_time_s: float, tokens: int,
               loss: Optional[float] = None,
               hbm_used_bytes: Optional[int] = None,
               hbm_total_bytes: Optional[int] = None) -> Optional[dict]:
        """Write one report (atomic); returns the dict, or None when
        disabled. Never raises: metrics must not kill training."""
        if not self.path or step_time_s <= 0:
            return None
        try:
            rec = {
                "step": step,
                "step_time_ms": round(step_time_s * 1e3, 2),
                "tokens_per_sec": round(tokens / step_time_s, 1),
                "timestamp": time.time(),
            }
            if loss is not None:
                rec["loss"] = round(float(loss), 4)
            if self.flops_per_token and self.peak_flops:
                rec["mfu"] = round(
                    tokens / step_time_s * self.flops_per_token
                    / self.peak_flops, 4)
            rec.update(_device_memory_stats(self.device))
            if hbm_used_bytes is not None:
                rec["hbm_used_bytes"] = int(hbm_used_bytes)
            if hbm_total_bytes is not None:
                rec["hbm_total_bytes"] = int(hbm_total_bytes)
            tmp = f"{self.path}.tmp"
            with open(tmp, "w") as f:
                json.dump(rec, f)
            os.replace(tmp, self.path)  # readers never see a torn file
            return rec
        except Exception:  # noqa: BLE001
            return None


def read_report(sandbox_dir: str,
                now: Optional[float] = None) -> Optional[dict]:
    """Node-agent side: the pod's latest report, with ``stale`` set when
    the workload stopped publishing."""
    path = os.path.join(sandbox_dir, REPORT_BASENAME)
    try:
        with open(path) as f:
            rec = json.load(f)
    except (OSError, ValueError):
        return None
    age = (now or time.time()) - rec.get("timestamp", 0)
    rec["age_seconds"] = round(age, 1)
    rec["stale"] = age > STALE_AFTER_SECONDS
    return rec
