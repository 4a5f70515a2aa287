"""Where the flagship's device time goes, by kernel, on one GPU.

    python -m kubernetes_tpu_torch.perf.profile_forward           # forward
    python -m kubernetes_tpu_torch.perf.profile_forward --train   # train step

Builds the 600M config of ``chip_bench`` (bf16 params, random weights
from seed 0), warms one forward (or one train step) per case, then
traces one more under ``torch.profiler`` and prints one JSON line per
case: the host-clock time of the traced call, the device-busy time (the
union of kernel intervals), the idle share, the time per kernel group
(the attention kernels, matrix products, the optimizer's multi-tensor
kernels, everything else) and the heaviest kernels by name. A trace
that shows no kernel on the device fails the run.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..workloads import lm
from . import chip_bench

CASES = ("lm-600m-t2k-flash", "lm-600m-t8k-flash")
TOP = 12  # heaviest kernels listed per case
_GEMM_MARKS = ("gemm", "Gemm", "xmma", "cutlass", "nvjet")


def _group(name: str) -> str:
    if "flash_fwd_kernel" in name:
        return "flash_attn_fwd"
    if "flash_bwd_" in name:
        return "flash_attn_bwd"
    if any(m in name for m in _GEMM_MARKS):
        return "matmul"
    if "multi_tensor_apply" in name:
        return "optimizer"
    return "other"


def _busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def _config(case: chip_bench.BenchCase) -> lm.LMConfig:
    return lm.LMConfig(vocab=case.vocab, d_model=case.d_model,
                       n_layers=case.n_layers, n_heads=case.n_heads,
                       d_ff=case.d_ff, param_dtype=torch.bfloat16,
                       attn_impl=case.attn_impl)


def _forward_call(case: chip_bench.BenchCase):
    cfg = _config(case)
    params = lm.init_params(torch.Generator("cuda").manual_seed(0), cfg)
    tokens = lm.synthetic_batch(torch.Generator("cuda").manual_seed(1), cfg,
                                case.batch, case.seq)[:, :-1]
    forward = lm.make_forward(cfg)
    return lambda: forward(params, tokens)


def _train_call(case: chip_bench.BenchCase):
    cfg = _config(case)
    state = list(lm.init_train_state(torch.Generator("cuda").manual_seed(0),
                                     cfg))
    batch = lm.synthetic_batch(torch.Generator("cuda").manual_seed(1), cfg,
                               case.batch, case.seq)
    step = lm.make_train_step(cfg)

    def call():
        state[0], state[1], _ = step(state[0], state[1], batch)
    return call


def profile_case(case: chip_bench.BenchCase, train: bool = False) -> dict:
    call = (_train_call if train else _forward_call)(case)
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the trace shows no kernel on the device")
    by_name, by_group = defaultdict(float), defaultdict(float)
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_name[e.name] += us
        by_group[_group(e.name)] += us
    busy = _busy_us((e.time_range.start, e.time_range.end) for e in kernels)
    heavy = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "case": case.name, "mode": "train_step" if train else "forward",
        "batch": case.batch, "seq": case.seq,
        "wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
        "idle_share": 1.0 - busy / wall_us, "kernels": len(kernels),
        "group_ms": {g: us / 1e3 for g, us in sorted(by_group.items())},
        "top": [{"name": n[:120], "ms": us / 1e3} for n, us in heavy],
    }


def main() -> int:
    train = "--train" in sys.argv[1:]
    if not torch.cuda.is_available():
        raise SystemExit("profile_forward: torch sees no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps({"device": smi}), flush=True)
    for name in CASES:
        print(json.dumps(profile_case(chip_bench.case(name), train)),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
