"""Host time per call of the port's kernel wrappers, beside ``torch.add``.

    python -m kubernetes_tpu_torch.perf.launch_cost

Times each wrapper on the card by the host clock over back-to-back
calls, read before the closing synchronize, so the number is what a
call costs the host (checks, allocation, the ctypes call, the launch),
not the kernel's device time: the vector add and ``torch.add`` at the
payload's 2^16 f32 over 10^4 calls, the attention forward and backward
at the t2k shape (B4 H16 T2048 D128 bf16) over few enough calls that
their queued work never fills the queue of launches, and the attention
kernels' C entry points alone (``*_launch``: the ctypes call of
``flash_attention._FWD`` / ``_BWD`` on outputs allocated once), which
splits a wrapper's time between its Python and its library. Every
function is timed in turns (in order, then reversed, RUNS times) and
each run is printed. It calls only the wrappers' public functions and
those two launch objects, which every tree of the port since its launch
path was unified has, so it can time another tree as well: run it from
that tree's root with ``python -c "import runpy;
runpy.run_path('<this file>', run_name='__main__')"``.
"""
from __future__ import annotations

import json
import math
import subprocess
import time

import torch

from kubernetes_tpu_torch.kernels import build
from kubernetes_tpu_torch.workloads import flash_attention as fa
from kubernetes_tpu_torch.workloads import vector_add as va

RUNS = 2
VECTOR_CALLS = 10_000
ATTENTION_CALLS = {"flash_attention_fwd": 100, "flash_attention_bwd": 50}
ATTENTION_CALLS.update({f"{n}_launch": c for n, c in ATTENTION_CALLS.items()})
ATTENTION_SHAPE = (4, 16, 2048, 128)


def host_us(fn, calls: int) -> float:
    """Host wall time per call of ``calls`` back-to-back calls of ``fn``,
    read before the closing synchronize (one warm-up call first)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("launch_cost: torch sees no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    x, y = (torch.randn(1 << 16, generator=gen, device="cuda")
            for _ in range(2))
    q, k, v, do = (torch.randn(ATTENTION_SHAPE, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v)
    b, h, t, d = ATTENTION_SHAPE
    o_out, lse_out, delta = (torch.empty_like(o), torch.empty_like(lse),
                             torch.empty_like(lse))
    grads = [torch.empty_like(q) for _ in range(3)]
    stream = build.current_stream(0)

    def fwd_launch():
        rc = fa._FWD.launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o_out.data_ptr(),
            lse_out.data_ptr(), b, h, t, d, 1, 0,
            math.log2(math.e) / math.sqrt(d), 0, stream)
        if rc:
            raise fa._FWD.error(rc)

    def bwd_launch():
        rc = fa._BWD.launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            *(g.data_ptr() for g in grads), b, h, t, d, 1, 0,
            1 / math.sqrt(d), 0, stream)
        if rc:
            raise fa._BWD.error(rc)
    fns = {
        "torch.add": (lambda: torch.add(x, y), VECTOR_CALLS),
        "vector_add": (lambda: va.vector_add(x, y), VECTOR_CALLS),
        "flash_attention_fwd": (lambda: fa.flash_attention_fwd(q, k, v),
                                ATTENTION_CALLS["flash_attention_fwd"]),
        "flash_attention_bwd": (
            lambda: fa.flash_attention_bwd(q, k, v, o, lse, do),
            ATTENTION_CALLS["flash_attention_bwd"]),
        "flash_attention_fwd_launch": (
            fwd_launch, ATTENTION_CALLS["flash_attention_fwd_launch"]),
        "flash_attention_bwd_launch": (
            bwd_launch, ATTENTION_CALLS["flash_attention_bwd_launch"]),
    }
    runs = {name: [] for name in fns}
    for r in range(2 * RUNS):
        order = list(fns.items())
        for name, (fn, calls) in (order if r % 2 == 0 else reversed(order)):
            runs[name].append(host_us(fn, calls))
    print(json.dumps({
        "device": smi, "host_us": {n: sum(u) / len(u) for n, u in runs.items()},
        "host_us_runs": runs,
        "calls": {n: calls for n, (_, calls) in fns.items()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
