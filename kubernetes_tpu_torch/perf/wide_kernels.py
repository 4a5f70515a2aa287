"""Device time of the wide attention kernels (``csrc/flash_attn_wide.cu``)
at the shapes ``chip_smoke.py`` times them, whole calls and kernel by
kernel.

    python -m kubernetes_tpu_torch.perf.wide_kernels [--profile]

For B4 H16 T2048 causal at head dim 272 and 512 in bf16 and 256 in f32:
the forward and the backward wrappers' mean time per call by CUDA events
(20 and 10 calls after 2 warm-up calls) and, with ``--profile``, each
kernel's device time per call from ``torch.profiler`` over 5 forward and
backward calls (the f32 pre-pass's amax and split kernels are counted
once per operand: 3 in a forward, 4 in a backward); with each shape's
``wide_plan``. Prints one JSON line headed by the card's name and power
limit. It calls only the wrappers' public functions and the build, so it
times another tree of the port as well: run it from that tree's root
with ``python -c "import runpy; runpy.run_path('<this file>',
run_name='__main__')"``; compare trees only within one call, in turns.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys

import torch
from torch.profiler import ProfilerActivity, profile

from kubernetes_tpu_torch.kernels import build
from kubernetes_tpu_torch.workloads import flash_attention as fa

SHAPES = (((4, 16, 2048, 272), torch.bfloat16),
          ((4, 16, 2048, 512), torch.bfloat16),
          ((4, 16, 2048, 256), torch.float32))
PROFILED_CALLS = 5
#: Kernel names as the profiler reports them, cut to the function's.
_KERNEL = re.compile(r"^.*?(wide_\w+?_kernel|split_parts_kernel|"
                     r"slice_amax_kernel|Memset).*$")


def time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_us(fns) -> dict:
    """Device us per round of ``fns`` (each called once a round) by
    kernel, over PROFILED_CALLS rounds."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_CALLS):
            for fn in fns:
                fn()
        torch.cuda.synchronize()
    out = {}
    for event in prof.key_averages():
        total = getattr(event, "device_time_total", None) or getattr(
            event, "cuda_time_total", 0)
        if total:
            name = _KERNEL.sub(r"\1", event.key)
            out[name] = out.get(name, 0.0) + total / PROFILED_CALLS
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("wide_kernels: torch sees no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    build.build(("flash_attn_wide",))
    gen = torch.Generator("cuda").manual_seed(0)
    rows = {"device": smi, "tree": fa.__file__}
    for shape, dtype in SHAPES:
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                       .to(dtype) for _ in range(4))
        o, lse = fa.flash_attention_fwd(q, k, v)

        def fwd():
            return fa.flash_attention_fwd(q, k, v)

        def bwd():
            return fa.flash_attention_bwd(q, k, v, o, lse, do)
        key = "D{}{}".format(shape[3], "_f32" if dtype is torch.float32
                             else "")
        rows[key] = {"forward_ms": time_ms(fwd, 20),
                     "backward_ms": time_ms(bwd, 10)}
        if "--profile" in sys.argv:
            rows[key]["device_us_per_forward_and_backward"] = kernel_us(
                (fwd, bwd))
        if hasattr(fa, "wide_plan"):
            rows[key]["wide_plan"] = {
                name: plan.get("group_boxes", plan["executed_over_useful"])
                for name, plan in fa.wide_plan(shape[3], dtype).items()}
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    print(json.dumps(rows), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
