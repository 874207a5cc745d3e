"""The benchmark's driver-independent core: find a cell's files by name,
run its closed loop, reduce the trace, check the outputs, and build the
result line.

A cell is an entry of BENCHMARK.json's ``workloads``.  Everything that
belongs to one configuration, one cell or one metric sits in files of its
own, found by name:

  benchmark/configs/<config>.json    sizes, source, and ``job``: the kind
  benchmark/workloads/<cell>.json    config, traffic name and parameters, why
  benchmark/jobs/<kind>.py           setup / job / check / control of a kind
  benchmark/metrics/<metric>.py      read(run) -> the metric, or None

The traffic is a closed loop of one caller: the next job starts when the
last one has answered, on the statement the order drawn from the seed
names next.  A job's steps are host-clock spans that tile the window.
"""

from __future__ import annotations

import importlib.util
import json
import random
import statistics
import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent  # the checkout
FORBIDDEN = ("jax", "jaxlib", "flax", "zk_tpu")  # top-level module names, compared whole


@dataclass
class Cell:
    name: str
    config: dict
    workload: dict
    chips: int = 1
    root: Path = ROOT
    end_to_end: list = field(default_factory=list)  # BENCHMARK.json entries that apply here
    per_layer: list = field(default_factory=list)

    @property
    def traffic(self) -> dict:
        return self.workload["traffic"]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of root/BENCHMARK.json with its files."""
    bench = _json(root / "BENCHMARK.json")
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[0]
    workload = _json(root / "benchmark" / "workloads" / f"{name}.json")
    if (workload["config"], workload["traffic"]["name"]) != (entry["config"], entry["traffic"]):
        raise SystemExit(f"benchmark/workloads/{name}.json disagrees with BENCHMARK.json on config or traffic")
    configs = [c for c in bench["configs"] if c["name"] == entry["config"]]
    config = _json(root / configs[0]["file"])
    return Cell(
        name=name, config=config, workload=workload, chips=entry["chips"], root=root,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


def load_module(kind: str, name: str, root: Path = ROOT):
    """benchmark/<kind>/<name>.py, loaded by path (names may hold dots)."""
    path = root / "benchmark" / kind / f"{name}.py"
    key = f"benchmark.{kind}.{name.replace('.', '_').replace('-', '_')}@{root}"
    if key in sys.modules:
        return sys.modules[key]
    if not path.exists():
        raise SystemExit(f"missing {path.relative_to(root)}")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def statement_order(traffic: dict, seed: int):
    """The statements the jobs use, in turn: the pool in an order drawn from
    the seed, again and again, so every seed sends the same work."""
    rng = random.Random(seed)
    pool = list(range(traffic["pool"]))
    while True:
        rng.shuffle(pool)
        yield from pool


class Clock:
    """Host-clock steps of one job: ``step(name)`` ends the open step and
    starts the next at the same instant, so the steps tile the job; ``sub``
    times a part of a step.  With a profiler on, each is also a
    ``record_function`` range named bench.<name>."""

    def __init__(self, traced: bool):
        self.traced = traced
        self.spans: dict[str, list[tuple[float, float]]] = {}
        self._open = None  # (name, start, record_function)

    def _range(self, name: str):
        if not self.traced:
            return None
        import torch

        rf = torch.profiler.record_function(f"bench.{name}")
        rf.__enter__()
        return rf

    def step(self, name: str | None, now: float | None = None) -> float:
        now = time.perf_counter() if now is None else now
        if self._open is not None:
            prev, start, rf = self._open
            self.spans.setdefault(prev, []).append((start, now))
            if rf is not None:
                rf.__exit__(None, None, None)
        self._open = None if name is None else (name, now, self._range(name))
        return now

    @contextmanager
    def sub(self, name: str):
        rf = self._range(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans.setdefault(name, []).append((t0, time.perf_counter()))
            if rf is not None:
                rf.__exit__(None, None, None)


@dataclass
class Run:
    """What a metric reader sees."""

    cell: Cell
    setup_s: float
    window: tuple[float, float]
    jobs: list[dict]  # per job: statement, spans {step: [(start, end)]}, error
    memory_peak_bytes: int | None
    trace: object = None  # benchmark.trace.Trace of a --trace 1 run

    def spans(self, step: str) -> list[tuple[float, float]]:
        return [s for j in self.jobs for s in j["spans"].get(step, [])]


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: str, started: float) -> tuple[dict, list]:
    """One run of a cell: set-up, the window, the check.  Returns the
    result line (a dict) and the compared numbers [(name, value, limit)].
    A job that raises has no answer: the run is then not correct."""
    import torch

    from benchmark import mesh as M
    from benchmark import trace as T

    kind = load_module("jobs", cell.config["job"], cell.root)
    on_cuda = device.startswith("cuda")
    if on_cuda:
        torch.cuda.reset_peak_memory_stats()
    state = kind.setup(cell.config, cell.traffic, seed, device)
    warm = Clock(traced=False)  # one job on the cell's shapes: builds the kernels, fills the caches
    warm.step("prove")
    kind.job(state, 0, warm)
    warm.step(None)
    order = statement_order(cell.traffic, seed)
    limit_jobs = cell.traffic["trace_jobs"] if trace else None

    records, jobs = [], []
    prof = T.start() if trace else None
    clock = Clock(traced=trace)
    start = clock.step(None)
    setup_s = start - started
    end = start + seconds
    now = start
    while now < end and (limit_jobs is None or len(jobs) < limit_jobs):
        statement = next(order)
        clock.spans = {}
        clock.step("prove", now)
        try:
            record, error = kind.job(state, statement, clock), None
        except Exception as exc:  # a failed job is counted, and the loop goes on
            record, error = None, f"{type(exc).__name__}: {exc}"
        now = clock.step(None)
        records.append(record)
        jobs.append({"statement": statement, "spans": clock.spans, "error": error})
    traced = T.stop(prof) if trace else None
    peak = None
    if on_cuda:
        ranks = M.active()  # on several cards, the fullest card's peak (and every card's blocks freed)
        peak = ranks.peak() if ranks is not None else torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()  # the window's blocks go back before the reference runs

    result = Run(cell, setup_s, (start, now), jobs, peak, traced)
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = load_module("metrics", m["name"], cell.root).read(result)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    for step in ("prove", "verify"):
        spans = sorted(e - s for s, e in result.spans(step))
        if len(spans) >= 2:
            q = statistics.quantiles(spans, n=4)
            print(f"{step} spans over {len(spans)} jobs: min {spans[0]:.6f} q1 {q[0]:.6f} median {q[1]:.6f} "
                  f"q3 {q[2]:.6f} max {spans[-1]:.6f} s", file=sys.stderr)
    errors = [j for j in jobs if j["error"] is not None]
    if errors:
        print(f"{len(errors)} jobs failed; the first, on statement {errors[0]['statement']}: {errors[0]['error']}",
              file=sys.stderr)
    t0 = time.perf_counter()
    answered = [(j["statement"], r) for j, r in zip(jobs, records) if r is not None]
    checks = kind.check(state, answered)
    print(f"the check of {len(answered)} jobs took {time.perf_counter() - t0:.3f} s; {len(errors)} of "
          f"{len(jobs)} jobs failed", file=sys.stderr)
    found = forbidden_modules()  # last, after every call into the program, the check's too
    if M.active() is not None:  # and in the ranks on the other cards
        found += M.active().forbidden()
    if found:
        raise SystemExit(f"modules of JAX or the JAX package were loaded: {found}")
    device_info = T.device_info(device, peak, cell.chips)
    if traced is not None:
        device_info.update(busy_s=traced.busy_s, window_s=traced.window_s)
    line = {
        "correct": bool(jobs) and not errors and all(v <= lim for _, v, lim in checks),
        "attempted": len(jobs),
        "failed": len(errors),
        "metrics": metrics,
        "device": device_info,
    }
    if traced is not None:
        line["breakdown"] = traced.breakdown()
    line["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    return line, checks
