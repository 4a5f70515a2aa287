"""Run one cell of the port's benchmark and print its result.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds ``kubernetes_tpu_torch``. One
process loads, warms up, measures and prints one JSON line as the last
line of its standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics; with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``compared``: each number of the comparison with the reference beside
its limit, which also end its standard error.

A cell on one card runs in this process. A cell on more cards starts
one rank process per card (``rank.py``), each seeing its card alone, as
the node layer hands a pod its card, in one NCCL group made by the
port's ``rendezvous.init_process_group``; this process uses no card.

Exits non-zero, printing no result, without as many CUDA cards as the
cell asks for, when a rank fails, and when ``jax``, ``jaxlib``, ``flax``
or ``kubernetes_tpu`` is loaded in this process once the window has
closed.
"""
from __future__ import annotations

import time

T_START = time.time()  # noqa: E402 -- set-up counts from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

from . import spec  # noqa: E402

#: Top-level module names that may not be loaded (compared whole).
BANNED = ("jax", "jaxlib", "flax", "kubernetes_tpu")
#: Seconds a rank process may take.
RANK_TIMEOUT = 1100


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def bytecode_cache() -> None:
    """Python's bytecode of the port and of the libraries it imports, kept
    at a fixed path inside the checkout: the checkout's first run compiles
    it, every later run and rank reads it (an environment that forbids
    writing bytecode would otherwise compile torch's sources anew in each
    process)."""
    path = str(spec.ROOT / ".portbench_pycache")
    sys.dont_write_bytecode = False
    sys.pycache_prefix = path
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = path


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _transports(text: str) -> list:
    """NCCL's channel transports, from its INFO lines."""
    found = set()
    for line in text.splitlines():
        if "NCCL INFO" in line and " via " in line:
            found.add(line.split(" via ", 1)[1].strip())
    return sorted(found)


def run_ranks(cell: dict, job: dict, world: int,
              device_type: str = "cuda") -> list:
    """``world`` rank processes (``rank.py``) doing ``job``, one card
    each (``device_type`` "cpu": gloo ranks on the CPU, for tests); each
    one's result, which it writes to a file under ``TMPDIR`` (NCCL's log
    shares its standard output). When one rank fails, the others are
    stopped; each is waited for."""
    port = _free_port()
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    cards = visible.split(",") if visible else [str(r) for r in range(world)]
    job = json.dumps({**job, "cell": cell, "port": port, "world": world,
                      "device_type": device_type})
    procs, files = [], []
    results = tempfile.mkdtemp(prefix="portbench-")
    try:
        for r in range(world):
            env = {**os.environ, "PORTBENCH_JOB": job,
                   "PORTBENCH_RANK": str(r), "NCCL_DEBUG": "INFO",
                   "PORTBENCH_OUT": os.path.join(results, f"rank{r}.json")}
            if device_type == "cuda":
                env["CUDA_VISIBLE_DEVICES"] = cards[r]
            out, err = tempfile.TemporaryFile(), tempfile.TemporaryFile()
            files.append((out, err))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "portbench.rank"], cwd=spec.ROOT,
                env=env, stdout=out, stderr=err))
        deadline = time.monotonic() + RANK_TIMEOUT
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) \
                    or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    outs, logs, bad = [], [], []
    for r, (p, (out, err)) in enumerate(zip(procs, files)):
        texts = []
        for f in (out, err):
            f.seek(0)
            texts.append(f.read().decode(errors="replace"))
            f.close()
        logs.append("\n".join(texts))
        path = os.path.join(results, f"rank{r}.json")
        if p.returncode != 0 or not os.path.exists(path):
            bad.append(f"rank {r}: exit {p.returncode}\n{texts[1][-4000:]}")
            continue
        with open(path) as f:
            outs.append(json.load(f))
    shutil.rmtree(results, ignore_errors=True)
    print(f"nccl transports: {_transports(''.join(logs))}", file=sys.stderr)
    if bad:
        sys.stderr.write("\n".join(bad) + "\n")
        raise SystemExit(1)
    return outs


def _power_limits() -> str:
    """The cards' power limits, beside the MFU that assumes the full one."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return ", ".join(sorted(set(out.split("\n")) - {""}))


def merge(results: list) -> dict:
    """The ranks' results as one: the gang's tokens over the slowest
    rank's window, the fullest card, the worst number."""
    from . import check
    first = results[0]
    return {
        "world": len(results),
        "tokens": sum(r["tokens"] for r in results),
        "window_s": max(r["window_s"] for r in results),
        "peak_bytes": max(r["peak_bytes"] for r in results),
        "setup_s": max(r["window_start_wall"] for r in results) - T_START,
        "steps": first["steps"],
        "failed": sum(r["failed"] for r in results),
        "numbers": check.worst([r["numbers"] for r in results]),
        "launches": {k: min(r["launches"][k] for r in results)
                     for k in ("fwd", "bwd")}
        | {"least": first["launches"]["least"]},
        "device_kind": first["device_kind"],
        "rank0": first,
        "ranks": [{k: r.get(k) for k in ("window_s", "step_s_checked",
                                         "reference_s", "returns_s")}
                  | {"marks_s": {k: v - T_START
                                 for k, v in r["marks"].items()}}
                  for r in results],
        "busy_s": (sum(r["busy_s"] for r in results) / len(results)
                   if "busy_s" in first else None),
        "traced_window_s": (sum(r["window_s"] for r in results)
                            / len(results)),
    }


def result_line(cell: dict, res: dict, traced: bool) -> tuple:
    """``(line, correct, compared)`` of a merged result."""
    from . import check
    limits = cell["workload"]["limits"]
    correct, compared = check.verdict(res["numbers"], limits,
                                      res["launches"])
    correct = correct and res["failed"] == 0
    metrics = {}
    if traced:
        for m in cell["per_layer"]:
            value = res["rank0"]["per_layer"].get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell["end_to_end"]:
            value = spec.module("end_to_end", m["name"]).read(res)
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": res["device_kind"],
              "count": res["world"], "memory_peak_bytes": res["peak_bytes"]}
    if traced:
        device["busy_s"] = res["busy_s"]
        device["window_s"] = res["traced_window_s"]
        device["power_limit"] = _power_limits()
    line = {"correct": correct, "attempted": res["steps"],
            "failed": res["failed"], "metrics": metrics, "device": device}
    if traced:
        line["breakdown"] = res["rank0"]["breakdown"]
    line["compared"] = compared
    return line, correct, compared


def run_cell(cell: dict, seed: int, seconds: float, traced: bool,
             device_type: str = "cuda") -> dict:
    """The merged result of a run of ``cell``: in this process on one
    card, else in one rank process per card."""
    if cell["chips"] == 1:
        from . import cell as cells
        return merge([cells.run_rank(cell, seed, seconds, traced,
                                     f"{device_type}:0" if device_type
                                     == "cuda" else device_type)])
    return merge(run_ranks(cell, {"mode": "run", "seed": seed,
                                  "seconds": seconds, "trace": traced},
                           cell["chips"], device_type))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.load(args.workload)
    bytecode_cache()
    import torch
    walls = {"torch": time.time()}
    chips = cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    from kubernetes_tpu_torch.kernels import build
    build.build(spec.module("entries", cell["workload"]["entry"])
                .kernel_sources(cell["config"]["run"]))
    walls["build"] = time.time()
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    loaded = banned_modules()
    if loaded:
        print(f"portbench: loaded in the process that reports: {loaded}",
              file=sys.stderr)
        return 4
    line, _, compared = result_line(cell, res, bool(args.trace))
    print(json.dumps({"ours": res["rank0"]["ours"],
                      "reference": res["rank0"]["reference"]}),
          file=sys.stderr)
    # Where set-up went: seconds from the process's start to the end of
    # each phase, here and in each rank (``marks_s``).
    print(json.dumps({"setup_marks_s": {k: v - T_START
                                        for k, v in walls.items()},
                      "ranks": res["ranks"]}), file=sys.stderr)
    for name, c in compared.items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
