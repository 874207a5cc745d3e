"""Predict which tier-1 xdist worker runs out of memory mappings.

XLA:CPU keeps each compiled executable's code in memory mappings of its own,
and a process that compiles enough of zk_tpu's large limb graphs passes the
kernel's ``vm.max_map_count`` (65530 by default): it dies inside a compile,
and xdist reports the test it was running as failed.  One xdist worker of the
tier-1 run (``-n 6 --dist load``) compiles what the scheduler hands it: first
a chunk of ``(N // 6) // 4`` consecutive tests, N the number collected, then
batches from the front of the queue.  N alone moves the chunk boundaries, so
a PR that adds tests anywhere can move a crash from one zk_tpu test to
another.

Record once (one full tier-1 run; every worker appends one line a test):

    PYTHONPATH=scripts TIER1_MAPS_OUT=DIR python -m pytest tests/ -m 'not slow' \\
        -p xdist -n 6 --dist load -p no:randomly -p tier1_partition --junitxml=RUN.xml

Predict for the tests collected now, with k tests added or taken away:

    python scripts/tier1_partition.py DIR RUN.xml [--span 12]

It replays xdist's LoadScheduling with each test's recorded duration (over
40 trials: the whole run slowed 0.8x to 1.6x, each test a further 0.75x to
1.33x) and adds up each worker's recorded map increments.  A worker whose
sum passes MARGIN is counted as a crash: a compile needs maps of its own
while it runs, and a worker at 64,308 maps has been seen to die on its
next compile.  A test recorded nowhere counts as 0 maps and 0.05 s, and the
k tests are placed after the port's test files.  The sums are an upper
bound: a test that reuses a function compiled earlier in its worker costs
less.
"""

from __future__ import annotations

import argparse
import csv
import glob
import os
import random
import subprocess
import sys
import time
import xml.etree.ElementTree as ET

MARGIN = 64000  # of vm.max_map_count's default 65530
START = 640  # a worker's maps after collection, before its first test
WORKERS = 6

_started: list = [None]


def _maps() -> int:
    with open("/proc/self/maps") as f:
        return sum(1 for _ in f)


def pytest_runtest_logstart(nodeid, location):
    _started[0] = (time.time(), _maps())


def pytest_runtest_logfinish(nodeid, location):
    out, worker = os.environ.get("TIER1_MAPS_OUT"), os.environ.get("PYTEST_XDIST_WORKER")
    if not out or not worker:
        return  # the controller sees every report too; only workers compile
    t0, before = _started[0]
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"maps_{os.getpid()}.tsv"), "a") as f:
        f.write(f"{worker}\t{nodeid}\t{before}\t{_maps()}\t{time.time() - t0:.2f}\n")


def _increments(folder: str) -> dict[str, int]:
    inc = {}
    for path in glob.glob(os.path.join(folder, "maps_*.tsv")):
        for _worker, nodeid, before, after, _secs in csv.reader(open(path), delimiter="\t"):
            inc[nodeid] = max(0, int(after) - int(before))
    return inc


def _durations(junit: str) -> dict[str, float]:
    out = {}
    for case in ET.parse(junit).getroot().iter("testcase"):
        out[case.get("classname").replace(".", "/") + ".py::" + case.get("name")] = float(case.get("time"))
    return out


def _collect(repo: str) -> list[str]:
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "tests/", "-q", "-m", "not slow", "--collect-only",
         "-p", "no:cacheprovider", "-n", "0"],
        cwd=repo, capture_output=True, text=True, check=True,
    )
    return [line.strip() for line in r.stdout.splitlines() if "::" in line]


def schedule(items: list[str], secs: dict[str, float]) -> list[list[str]]:
    """Each worker's tests in the order it runs them (xdist LoadScheduling)."""
    n = len(items)
    pending = list(range(n))
    chunk = max(min(n // WORKERS // 4, n), 2)
    queue = [pending[k * chunk:(k + 1) * chunk] for k in range(WORKERS)]
    del pending[:WORKERS * chunk]
    clock = [0.0] * WORKERS
    ran: list[list[str]] = [[] for _ in range(WORKERS)]
    while any(queue):
        k = min((w for w in range(WORKERS) if queue[w]), key=lambda w: clock[w])
        item = items[queue[k].pop(0)]
        took = secs.get(item, 0.05)
        clock[k] += took
        ran[k].append(item)
        if not pending:
            continue
        least = max(2, len(pending) // WORKERS // 4)
        most = max(2, len(pending) // WORKERS // 2)
        if len(queue[k]) < least and not (took >= 0.1 and len(queue[k]) >= 2):
            send = most - len(queue[k])
            queue[k] += pending[:send]
            del pending[:send]
    return ran


def _with_count(items: list[str], k: int) -> list[str]:
    last = max(i for i, item in enumerate(items) if item.startswith("tests/test_torch_"))
    if k < 0:
        return items[:last + 1 + k] + items[last + 1:]
    return items[:last + 1] + [f"tests/test_torch_pad.py::t{i}" for i in range(k)] + items[last + 1:]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("maps", help="folder of maps_*.tsv from a recorded run")
    ap.add_argument("junit", help="junit XML of the same run (durations)")
    ap.add_argument("--span", type=int, default=12, help="also predict N-span..N+span tests")
    ap.add_argument("--trials", type=int, default=40)
    args = ap.parse_args()
    inc, secs = _increments(args.maps), _durations(args.junit)
    items = _collect(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    print(f"collected {len(items)}; {len(inc)} tests recorded")
    for k in range(-args.span, args.span + 1):
        coll = _with_count(items, k)
        peaks, over = [], {}
        for trial in range(args.trials):
            rng = random.Random(trial)
            load = rng.uniform(0.8, 1.6)
            ran = schedule(coll, {t: s * load * rng.uniform(0.75, 1.33) for t, s in secs.items()})
            peak = 0
            for tests in ran:
                total = START
                for t in tests:
                    total += inc.get(t, 0)
                    if total > MARGIN and inc.get(t, 0):
                        over[t] = over.get(t, 0) + 1
                        break
                    peak = max(peak, total)
            peaks.append(peak)
        peaks.sort()
        worst = ", ".join(f"{t.split('::')[-1]} x{c}" for t, c in sorted(over.items(), key=lambda x: -x[1])[:3])
        print(f"N={len(coll)} chunk={len(coll) // WORKERS // 4} peak median {peaks[len(peaks) // 2]} "
              f"max {peaks[-1]}; past {MARGIN} (trials): {worst or 'none'}")


if __name__ == "__main__":
    main()
