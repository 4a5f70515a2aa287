"""The readings that a cell's limits are set from, at the cell's own
size: the port's numbers on many seeds (the lower readings), and on a
few of them the control's and each planted fault's (the upper ones).

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,... \\
        --control-seeds 1,2,3

Per seed, in one process per rank: the port's checked steps from the
seed (the run's set-up, without its window), its state freed, the plain
reference's steps on the same inputs, and the numbers of
``check.numbers``. On a control seed, besides, the reference put in the
port's place three ways: computed as fp8 training computes
(``matmul="fp8"``, the control), with half of each batch left out
(``half``), and on several cards with each rank's gradient kept to
itself (``exchange``). A step that returns its state unchanged reads 1
on ``change`` by the measure and needs no run. Prints one JSON line per
seed, then the summary: each number's largest sound reading and the
least reading of the control and of each fault.

The benchmark's runs do not run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from . import cell as cells
from . import check, spec, trace


def rank_readings(cell: dict, seeds: list, control_seeds: list, device,
                  group=None) -> list:
    """This rank's rows of readings, one per seed."""
    wl, config, traffic = cell["workload"], cell["config"], cell["traffic"]
    entries = spec.module("entries", wl["entry"])
    sync = trace.sync_for(device)
    checked = wl["check_steps"]
    rows = []
    for seed in seeds:
        entry = entries.Entry(config, traffic, seed, device, group)
        ours, took = cells.checked_steps(entry, checked, sync)
        entry.free()
        del entry
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()

        def ref(**kw):
            return entries.reference_readings(config, traffic, seed, checked,
                                              device, group, **kw)

        t = time.perf_counter()
        base = ref()
        row = {"seed": seed, "step_s": took, "port": check.numbers(ours, base),
               "reference_s": time.perf_counter() - t, "ours": ours,
               "reference": base}
        if seed in control_seeds:
            row["control"] = check.numbers(ref(matmul="fp8"), base)
            row["half"] = check.numbers(ref(fault="half"), base)
            if group is not None:
                row["exchange"] = check.numbers(ref(fault="exchange"), base)
        rows.append(row)
    return rows


def summary(rows: list) -> dict:
    out = {"lower": check.worst([r["port"] for r in rows]), "seeds": len(rows)}
    for kind in ("control", "half", "exchange"):
        found = [r[kind] for r in rows if kind in r]
        if found:
            out[kind] = {k: min(f[k] for f in found) for k in found[0]}
    out["unchanged"] = {"change": 1.0}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    cell = spec.load(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    control = [int(s) for s in args.control_seeds.split(",") if s]
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print("calibrate: not enough CUDA cards", file=sys.stderr)
        return 3
    from kubernetes_tpu_torch.kernels import build

    from . import run
    build.build(spec.module("entries", cell["workload"]["entry"])
                .kernel_sources(cell["config"]["run"]))
    if cell["chips"] == 1:
        per_rank = [rank_readings(cell, seeds, control, "cuda:0")]
    else:
        per_rank = run.run_ranks(cell, {"mode": "calibrate", "seeds": seeds,
                                        "control_seeds": control},
                                 cell["chips"])
    rows = []
    for i, seed in enumerate(seeds):
        mine = [r[i] for r in per_rank]
        row = {"seed": seed, "step_s": mine[0]["step_s"],
               "reference_s": mine[0]["reference_s"],
               "port": check.worst([m["port"] for m in mine])}
        for kind in ("control", "half", "exchange"):
            if kind in mine[0]:
                row[kind] = check.worst([m[kind] for m in mine])
        row["ours0"], row["reference0"] = mine[0]["ours"], mine[0]["reference"]
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({"summary": summary(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
