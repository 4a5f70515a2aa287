"""The card's peak rates, for MFU and roofline shares.

Frozen copy, taken on 2026-10-18, of ``PEAKS`` and ``DEFAULT_PEAK`` in
``kubernetes_tpu_torch/perf/chip_bench.py``: NVIDIA's data sheets, dense
bf16 FLOP/s and device-memory bytes/s; the first match of a lower-cased
substring of ``torch.cuda.get_device_name()`` wins, so the PCIe part
precedes the SXM default.
"""
from __future__ import annotations

PEAKS = [
    ("h100 pcie", 756e12, 2.0e12),
    ("h100", 989e12, 3.35e12),
]
DEFAULT_PEAK = (989e12, 3.35e12)


def peaks_for(device_name: str) -> tuple:
    """``(bf16 FLOP/s, bytes/s, known)``; ``known`` False where the H100
    SXM figures were assumed for a card the table lacks."""
    name = device_name.lower()
    for sub, flops, bytes_s in PEAKS:
        if sub in name:
            return flops, bytes_s, True
    return (*DEFAULT_PEAK, False)
