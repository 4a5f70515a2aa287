"""The benchmark's files: every cell's files found by name, every name
and unit within the allowed characters, every per-layer metric moving an
end-to-end metric its cells report, and the window within the budget."""
import json
import re

import pytest

from portbench import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def _one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert BENCH["paths"] == ["portbench"]
    assert all(_one_line(w) for w in BENCH["command"])
    assert 1 <= BENCH["run_seconds"] <= 51
    # A full check of 24 cells, 14 runs each, fits in 43200 seconds.
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = spec.load(cell)
    wl = c["workload"]
    assert wl["config"] == [w for w in BENCH["workloads"]
                            if w["name"] == cell][0]["config"]
    assert spec.module("entries", wl["entry"]).Entry
    assert spec.module("accounting", wl["accounting"]).train_flops_per_token
    for m in c["per_layer"]:
        assert callable(spec.module("metrics", m["name"]).read)
    for m in c["end_to_end"]:
        assert callable(spec.module("end_to_end", m["name"]).read)
    assert wl["limits"] and set(wl["limits"]) <= {"loss", "grad", "change"}
    assert c["traffic"]["global_batch"] % c["chips"] == 0


def test_names_units_and_entries():
    allowed = {
        "configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source",
                       "workloads"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"},
    }
    for group, keys in allowed.items():
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names)), group
        for e in BENCH[group]:
            assert set(e) <= keys, e
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for k in ("why", "layer", "source"):
                if k in e:
                    assert _one_line(e[k]), (e["name"], k)
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        data = json.loads((spec.ROOT / c["file"]).read_text())
        for k in c["reduced"]:
            assert k in data and k in data["published"], k
            assert not (k.endswith("_dim") or k.endswith("_rank")), k


def test_end_to_end_and_per_layer_rules():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            reported = [x["name"] for x in spec.load(cell)["end_to_end"]]
            assert m["moves"] in reported, (m["name"], cell)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    # One spelling per layer.
    assert all(len(v) == 1 for v in layers.values())
    for cell in CELLS:
        c = spec.load(cell)
        names = [m["name"] for m in c["end_to_end"]]
        assert "setup_s" in names and len(names) >= 2
        assert c["per_layer"]


@pytest.mark.parametrize("cell", CELLS)
def test_config_run_matches_its_keys(cell):
    c = spec.load(cell)["config"]
    run = c["run"]
    pairs = {"phi3": [("hidden_size", "d_model"), ("intermediate_size", "d_ff"),
                      ("num_attention_heads", "n_heads"),
                      ("num_hidden_layers", "n_layers"), ("vocab_size", "vocab"),
                      ("rms_norm_eps", "norm_eps"), ("rope_theta", "rope_base")],
             "gptj": [("n_embd", "d_model"), ("n_head", "n_heads"),
                      ("n_layer", "n_layers"), ("vocab_size", "vocab"),
                      ("layer_norm_epsilon", "norm_eps")]}[c["model_type"]]
    # A key the port runs otherwise keeps its published value, and the
    # file says why under ``departures``.
    for key, name in pairs:
        assert c[key] == run[name] or key in c["departures"], key
    assert set(c["published"]) == set(c["reduced_why"])
    if c["model_type"] == "gptj":
        assert c["n_inner"] is None and run["d_ff"] == 4 * run["d_model"]


def test_elementwise_leaves_out_every_other_readers_kernels():
    from portbench.metrics import elementwise_ms
    readers = [p.stem for p in (spec.HERE / "metrics").glob("*.py")
               if not p.stem.startswith("_") and p.stem != "elementwise_ms"]
    named = [(r, k) for r in readers
             for k in getattr(spec.module("metrics", r), "KERNELS", ())]
    assert {r for r, _ in named} >= {"matmul_ms", "optimizer_ms",
                                     "allreduce_ms", "attn_fwd_roofline",
                                     "attn_bwd_roofline"}
    # One kernel a mark, 1 ms each (times in us), and one of 3 ms that no
    # reader names.
    kernels = [(f"void {k}_x<1>", 0, 1000) for _, k in named] \
        + [("vectorized_elementwise_kernel", 0, 3000)]
    assert elementwise_ms.read({"kernels": kernels, "steps": 1}) == 3.0
