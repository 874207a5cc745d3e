"""The ranks of a cell on several cards (benchmark/mesh.py), on the CPU over
gloo: a rank that raises, is killed or hangs ends the whole run with no
result line within the group's timeout, and leaves no process behind; and
the reader of the mesh's collectives."""

from __future__ import annotations

import shutil
import subprocess
import sys
import time

import pytest

from benchmark import harness

CELL = "sumcheck-bls381-n29-mesh4-prod2"
TIMEOUT_S = 15  # the group's and each command's timeout in these runs

# appended to the kind's file in a copy of the benchmark: rank 2's second
# prove of the window (its third, after set-up's warm job) goes wrong
FAULT = '''
_rank_prove = rank_prove
_proves = []


def rank_prove(ctx, i):
    _proves.append(i)
    if ctx.rank == 2 and len(_proves) == 3:
        import os, signal, time  # noqa: E401
        print("rank 2 goes wrong", file=sys.stderr, flush=True)
        {fault}
    return _rank_prove(ctx, i)
'''

RUN = '''
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(1)
from benchmark import harness
from benchmark.tests.conftest import small_cell
line, _ = harness.run(small_cell(sys.argv[2]), 2**32 + 9, 3.0, False, "cpu", time.perf_counter())
print(json.dumps(line))
'''


# appended to the kind's file in a copy of the benchmark: rank 2 loads a
# module named jax in the check, after the window has closed
JAX_ON_RANK_2 = '''
_rank_replay = rank_replay


def rank_replay(ctx, i, bits):
    if ctx.rank == 2:
        import types
        sys.modules["jax"] = types.ModuleType("jax")
    return _rank_replay(ctx, i, bits)
'''


def _run_copy(tmp_path, patch: str):
    """A CPU run of the cell in a copy of the benchmark whose kind has patch
    appended and whose mesh times out after TIMEOUT_S: (process, seconds)."""
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(harness.ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "zk_tpu_torch").symlink_to(harness.ROOT / "zk_tpu_torch")  # every rank imports the program from here
    kind = tmp_path / "benchmark/jobs/sumcheck_mesh.py"
    kind.write_text(kind.read_text() + patch)
    mesh = tmp_path / "benchmark/mesh.py"
    text = mesh.read_text()
    assert text.count("\nTIMEOUT_S = ") == 1
    mesh.write_text(text.replace("\nTIMEOUT_S = ", f"\nTIMEOUT_S = {TIMEOUT_S}  # "))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", RUN, str(tmp_path), CELL], capture_output=True, text=True,
                          timeout=300, env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1", "HOME": str(tmp_path)})
    return proc, time.perf_counter() - t0


def _left(tmp_path) -> list[str]:
    return subprocess.run(["pgrep", "-f", str(tmp_path)], capture_output=True, text=True).stdout.split()


@pytest.mark.parametrize("fault, why", [
    ("raise RuntimeError('a rank fails')", "rank 2 exited with code 1"),
    ("os.kill(os.getpid(), signal.SIGKILL)", "rank 2 exited with code -9"),
    ("time.sleep(3600)", ""),  # the watchdog's deadline or the group's timeout, whichever comes first
], ids=["raises", "killed", "hangs"])
def test_a_failing_rank_ends_the_run_with_no_result(tmp_path, fault, why):
    proc, took = _run_copy(tmp_path, FAULT.format(fault=fault))
    assert proc.returncode == 3, proc.stderr[-3000:]
    assert proc.stdout.strip() == "" and "rank 2 goes wrong" in proc.stderr, proc.stderr[-3000:]
    assert f"{why}; ending the run" in proc.stderr, proc.stderr[-3000:]
    assert took < 60 + TIMEOUT_S  # set-up, two jobs and the timeout, not a hang
    assert _left(tmp_path) == []


def test_jax_on_another_rank_leaves_no_result(tmp_path):
    """The harness's JAX guard asks every rank, whatever the kind."""
    proc, _ = _run_copy(tmp_path, JAX_ON_RANK_2)
    assert proc.returncode == 1, proc.stderr[-3000:]
    assert proc.stdout.strip() == "" and "rank 2: jax" in proc.stderr
    assert _left(tmp_path) == []


def test_nccl_reader_reads_collectives_in_prove_steps():
    from benchmark import trace as T
    from benchmark.tests.conftest import small_cell

    ops = [(5, 9, "ncclDevKernel_AllReduce_Sum_i64_RING_LL(ncclDevComm*, unsigned long, ncclWork*)"),
           (10, 20, "fold_kernel"), (30, 36, "ncclDevKernel_AllGather_RING_LL"), (60, 70, "ncclDevKernel_x")]
    trace = T.Trace((0, 100), ops, T._merge([(s, e) for s, e, _ in ops]),
                    {"prove": [(0, 40), (50, 55)], "verify": [(55, 100)]}, [])
    run = harness.Run(small_cell(CELL), 0.0, (0.0, 1.0), [], None, trace)
    reader = harness.load_module("metrics", "mesh_nccl_ms")
    assert reader.read(run) == (4 + 6) / 2 / 1e6  # the last one starts in a verify step
    trace.ops = ops[1:2]
    assert reader.read(run) is None
