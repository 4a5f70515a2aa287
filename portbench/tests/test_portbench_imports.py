"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's),
the reference imports nothing of the port, nothing reads the JAX
package's old benchmark files, and a run keeps the bytecode it compiles
inside the checkout."""
import ast
import json
import os
import re
import subprocess
import sys

from portbench import spec

BANNED = {"jax", "jaxlib", "flax", "kubernetes_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def _sources():
    return sorted(spec.HERE.rglob("*.py"))


def test_no_jax_anywhere():
    for path in _sources():
        found = set(_imports(path)) & BANNED
        assert not found, (path, found)


def test_reference_imports_nothing_of_the_port():
    for path in (spec.HERE / "reference").rglob("*.py"):
        assert "kubernetes_tpu_torch" not in set(_imports(path)), path


def test_old_benchmark_files_unread():
    for path in _sources():
        if path.name == "test_portbench_imports.py":
            continue
        text = path.read_text()
        assert not re.search(r"(^|[^\w])bench\.py|BENCH_(r\d|\*)|MULTICHIP_r", text), path


def test_a_run_loads_no_jax():
    """A run on the CPU at a tiny size, in a fresh process, leaves none of
    the banned modules loaded."""
    script = (
        "import json, sys\n"
        "from portbench.tests import rehearsal\n"
        "from portbench import run\n"
        "rehearsal.count_cpu_launches()\n"
        "cell = rehearsal.tiny_cell('phi3-mini-train-t16k')\n"
        "res = run.run_cell(cell, 3, 0.2, False, 'cpu')\n"
        "print(json.dumps(run.banned_modules()))\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_bytecode_cached_inside_the_checkout():
    """Where the environment forbids writing bytecode, a run still keeps
    what it compiles, at a fixed path inside the checkout."""
    script = ("import sys\n"
              "from portbench import run\n"
              "run.bytecode_cache()\n"
              "import portbench.peaks\n"
              "print(sys.pycache_prefix)\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=spec.ROOT,
                         env={**os.environ, "PYTHONDONTWRITEBYTECODE": "1"},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    prefix = out.stdout.strip().splitlines()[-1]
    assert prefix == str(spec.ROOT / ".portbench_pycache")
    assert list((spec.ROOT / ".portbench_pycache").rglob(
        "portbench/peaks.cpython-*.pyc"))
