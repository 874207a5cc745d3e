"""The harness on the CPU: files found by name, the contract's shape of
BENCHMARK.json and of the result line, extension by files alone."""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import time
import types

import pytest
import torch

from benchmark import harness
from benchmark.tests.conftest import cells, kind_tests, small_cell

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_shape():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"] and b["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= b["run_seconds"] <= 51
    assert 2 + 14 * 24 * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("benchmark/") and c["reduced"] == json.loads((ROOT / c["file"]).read_text())["reduced"]
    names = [w["name"] for w in b["workloads"]]
    assert len(set(names)) == len(names)
    files = {c["name"]: json.loads((ROOT / c["file"]).read_text()) for c in b["configs"]}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert files[w["config"]].get("ranks", 1) == w["chips"]  # a kind runs one rank a card
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and len(w["why"]) <= 200
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, len(names) // 4)
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", names)) <= set(names)
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("name", cells())
def test_cell_files_load_by_name(name):
    cell = harness.load_cell(name)
    assert harness.load_module("jobs", cell.config["job"]).check
    for m in cell.end_to_end + cell.per_layer:
        assert callable(harness.load_module("metrics", m["name"]).read)


@pytest.mark.parametrize("name", cells())
def test_result_line_has_the_contract_keys(name):
    line, checks = harness.run(small_cell(name), 3 * 2**31 + 5, 0.2, False, "cpu", time.perf_counter())
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["checks"]) == {n for n, _, _ in checks}
    assert "setup_s" in line["metrics"] and "prove_s" in line["metrics"]


def test_traced_line_has_busy_window_and_breakdown():
    line, _ = harness.run(small_cell("sumcheck-bls381-n24-deg1"), 11, 0.2, True, "cpu", time.perf_counter())
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "verify_s.deg1" in line["metrics"] and "prove_s" not in line["metrics"]


def test_seed_fixes_the_inputs():
    cell = small_cell("sumcheck-bls381-n24-deg1")
    kind = harness.load_module("jobs", "sumcheck")
    a = kind.setup(cell.config, cell.traffic, 2**40 + 3, "cpu")
    b = kind.setup(cell.config, cell.traffic, 2**40 + 3, "cpu")
    c = kind.setup(cell.config, cell.traffic, 2**40 + 4, "cpu")
    assert a.claims == b.claims and a.claims != c.claims
    order = harness.statement_order(cell.traffic, 9)
    first = [next(order) for _ in range(8)]
    assert sorted(first) == [0, 0, 1, 1, 2, 2, 3, 3]


def test_a_cell_config_and_metric_are_added_by_files_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "benchmark/configs/sumcheck-bls381-n24.json").read_text())
    cfg.update(name="sumcheck-bls381-n7", n_vars=7)
    (tmp_path / "benchmark/configs/sumcheck-bls381-n7.json").write_text(json.dumps(cfg))
    b["configs"].append({"name": "sumcheck-bls381-n7", "source": "https://example.org/x", "reduced": [],
                         "file": "benchmark/configs/sumcheck-bls381-n7.json", "why": "a dummy"})
    wl = json.loads((ROOT / "benchmark/workloads/sumcheck-bls381-n24-prod2.json").read_text())
    wl.update(config="sumcheck-bls381-n7")
    (tmp_path / "benchmark/workloads/dummy-cell.json").write_text(json.dumps(wl))
    b["workloads"].append({"name": "dummy-cell", "config": "sumcheck-bls381-n7", "traffic": wl["traffic"]["name"],
                           "chips": 1, "why": "a dummy"})
    (tmp_path / "benchmark/metrics/jobs_done.py").write_text("def read(run):\n    return len(run.jobs)\n")
    b["end_to_end"].append({"name": "jobs_done", "unit": "jobs", "better": "higher", "bound": 0.1,
                            "source": "host_clock", "workloads": ["dummy-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))

    cell = harness.load_cell("dummy-cell", tmp_path)
    line, _ = harness.run(cell, 5, 0.2, False, "cpu", time.perf_counter())
    assert line["correct"] is True
    assert line["metrics"]["jobs_done"]["value"] == line["attempted"]
    assert "jobs_done" not in harness.run(small_cell("sumcheck-bls381-n24-deg1", tmp_path), 5, 0.1, False, "cpu",
                                          time.perf_counter())[0]["metrics"]


TOY_JOB = '''"""A throwaway job kind: sum a row of integers."""
import torch


def setup(config, traffic, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, 1000, (traffic["pool"], config["size"]), generator=gen, device=device)


def total(row):
    return int(row.sum())


def job(state, i, clock):
    s = total(state[i])
    clock.step("verify")
    return s


def check(state, records):
    return [("sums_wrong", sum(s != sum(state[i].tolist()) for i, s in records), 0)]


def control(state, statements):
    return [("sums_wrong", len(statements), 0)]
'''

TOY_TESTS = '''SMALL = {"size": 64}
SPANS_EXACT = {}
SPANS_CARD_ONLY = ()


def faults(job):
    yield "answer altered", [(job, "total", lambda row: int(row.sum()) + 1)]
'''


def test_a_job_kind_is_added_by_files_alone(tmp_path, monkeypatch):
    """A new kind brings its job, its configuration, its cell and its test
    file (size and faults), and the harness and the shared test fixtures
    take it as they are."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "benchmark/jobs/toy.py").write_text(TOY_JOB)
    (tmp_path / "benchmark/tests/kinds/toy.py").write_text(TOY_TESTS)
    (tmp_path / "benchmark/configs/toy-sum.json").write_text(json.dumps({"job": "toy", "size": 1 << 20, "reduced": []}))
    (tmp_path / "benchmark/workloads/toy-cell.json").write_text(json.dumps(
        {"config": "toy-sum", "why": "a dummy", "traffic": {"name": "closed1-toy", "pool": 3, "trace_jobs": 2}}))
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "toy-sum", "source": "https://example.org/x", "reduced": [],
                         "file": "benchmark/configs/toy-sum.json", "why": "a dummy"})
    b["workloads"].append({"name": "toy-cell", "config": "toy-sum", "traffic": "closed1-toy", "chips": 1, "why": "a dummy"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))

    cell = small_cell("toy-cell", tmp_path)
    assert cell.config["size"] == 64
    line, checks = harness.run(cell, 2**34 + 1, 0.1, False, "cpu", time.perf_counter())
    assert line["correct"] is True and checks == [("sums_wrong", 0, 0)]
    assert "setup_s" in line["metrics"] and "prove_s" in line["metrics"]
    kind = harness.load_module("jobs", "toy", tmp_path)
    for _, patches in kind_tests("toy", tmp_path).faults(kind):
        with monkeypatch.context() as m:
            for obj, attr, value in patches:
                m.setattr(obj, attr, value)
            assert harness.run(cell, 2**34 + 1, 0.1, False, "cpu", time.perf_counter())[0]["correct"] is False


def test_run_without_a_card_fails_and_prints_no_result():
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "sumcheck-bls381-n24-deg1", "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                          env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"}, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card(card):
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "sumcheck-bls381-n24-deg1", "--seed",
                           str(2**31 + 77), "--seconds", "2", "--trace", "0"], cwd=ROOT, capture_output=True,
                          text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"


def test_a_job_that_raises_makes_the_run_incorrect(monkeypatch):
    cell = small_cell("sumcheck-bls381-n24-deg1")
    kind = harness.load_module("jobs", "sumcheck")
    state = kind.setup(cell.config, cell.traffic, 21, "cpu")
    monkeypatch.setattr(kind, "setup", lambda *a: state)

    calls = []
    job = kind.job

    def broken(*a):  # the warm-up job answers, the window's raise
        calls.append(1)
        if len(calls) > 1:
            raise RuntimeError("no answer")
        return job(*a)

    monkeypatch.setattr(kind, "job", broken)
    line, _ = harness.run(cell, 21, 0.1, False, "cpu", time.perf_counter())
    assert line["correct"] is False and line["failed"] == line["attempted"] >= 1


def test_a_jax_import_after_the_window_leaves_no_result(monkeypatch):
    """A forbidden module that the program loads in the check, after the
    window has closed, still ends the run with no result line."""
    cell = small_cell("sumcheck-bls381-n24-deg1")
    kind = harness.load_module("jobs", "sumcheck")
    check = kind.check

    def importing_check(state, records):
        sys.modules["jax"] = types.ModuleType("jax")  # as a verifier's error path importing JAX would
        return check(state, records)

    monkeypatch.setattr(kind, "check", importing_check)
    had = sys.modules.pop("jax", None)
    try:
        with pytest.raises(SystemExit, match="jax"):
            harness.run(cell, 31, 0.1, False, "cpu", time.perf_counter())
    finally:
        sys.modules.pop("jax", None)
        if had is not None:
            sys.modules["jax"] = had


def test_every_job_wraps_its_statement_afresh():
    cell = small_cell("sumcheck-bls381-n24-prod2")
    kind = harness.load_module("jobs", "sumcheck")
    state = kind.setup(cell.config, cell.traffic, 41, "cpu")
    a, b = kind.statement(state, 1), kind.statement(state, 1)
    assert a is not b and all(x is not y for x, y in zip(a.polynomials, b.polynomials))
    assert all(torch.equal(x.data, y.data) for x, y in zip(a.polynomials, b.polynomials))
