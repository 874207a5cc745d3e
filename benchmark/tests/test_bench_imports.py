"""Nothing of the benchmark imports JAX or the JAX package zk_tpu
(top-level module names compared whole: zk_tpu_torch begins with
zk_tpu), and the plain reference imports nothing of the program."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

from benchmark import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "zk_tpu"}
SOURCES = sorted(p for p in (harness.ROOT / "benchmark").rglob("*.py") if "tests" not in p.parts)


def _imports(path) -> set[str]:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_source_imports_jax_or_the_jax_package():
    for path in SOURCES:
        assert not _imports(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (harness.ROOT / "benchmark" / "reference").glob("*.py"):
        assert _imports(path) <= {"__future__", "functools", "numpy", "torch", "benchmark"}, path


def test_loaded_modules_in_a_fresh_process():
    code = (
        "import json, sys, time\n"
        f"sys.path.insert(0, {str(harness.ROOT)!r})\n"
        "from benchmark.reference import field, gkr, keccak, sumcheck\n"
        "ref = sorted({m.split('.')[0] for m in sys.modules})\n"
        "from benchmark import harness, trace, yardstick, inputs\n"
        "from benchmark.tests.conftest import cells, small_cell\n"
        "for name in cells():\n"
        "    harness.run(small_cell(name), 3, 0.05, False, 'cpu', time.perf_counter())\n"
        "print(json.dumps([ref, sorted({m.split('.')[0] for m in sys.modules})]))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref, run = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "zk_tpu_torch" not in ref
    assert "zk_tpu_torch" in run and not set(run) & FORBIDDEN
