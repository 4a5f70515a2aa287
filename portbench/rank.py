"""One rank of a cell on several cards, started by ``run.py``: its card is
the one ``CUDA_VISIBLE_DEVICES`` shows it, its group the NCCL group of
the port's ``rendezvous.init_process_group`` over a store on
127.0.0.1; its result goes, as JSON, to the file PORTBENCH_OUT names.

    PORTBENCH_JOB=<json> PORTBENCH_RANK=<r> PORTBENCH_OUT=<file> \
        python3 -m portbench.rank
"""
from __future__ import annotations

import json
import os
import sys
import time

START = time.time()


def main() -> int:
    import torch
    from torch import distributed as dist

    from kubernetes_tpu_torch.workloads import rendezvous

    from . import cell as cells
    from .run import banned_modules

    from . import calibrate

    job = json.loads(os.environ["PORTBENCH_JOB"])
    rank = int(os.environ["PORTBENCH_RANK"])
    cuda = job["device_type"] == "cuda"
    if cuda:
        torch.cuda.set_device(0)
    rendezvous.init_process_group("127.0.0.1", job["port"], rank,
                                  job["world"], "nccl" if cuda else "gloo",
                                  timeout=600.0, bind_ip="127.0.0.1")
    grouped = time.time()
    device = "cuda:0" if cuda else "cpu"
    cell = job["cell"]
    try:
        if job["mode"] == "calibrate":
            out = calibrate.rank_readings(cell, job["seeds"],
                                          job["control_seeds"], device,
                                          dist.group.WORLD)
        else:
            out = cells.run_rank(cell, job["seed"], job["seconds"],
                                 bool(job["trace"]), device, dist.group.WORLD)
    finally:
        dist.destroy_process_group()
    if "marks" in out:
        out["marks"] = {"rank_start": START, "group": grouped, **out["marks"]}
    loaded = banned_modules()
    if loaded:
        print(f"portbench rank {rank}: loaded {loaded}", file=sys.stderr)
        return 4
    with open(os.environ["PORTBENCH_OUT"], "w") as f:
        json.dump(out, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
