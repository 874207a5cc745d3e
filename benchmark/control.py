"""The control of a cell's ``correct``: the plain reference whose challenges
keep only their low 128 bits (a broken guarantee of the configuration:
challenges that are full field elements) put in the program's place, at
the cell's own sizes, judged by the cell's own check.

Run from the root of a checkout on a card, once per seed:

    python3 benchmark/control.py --workload <cell> --seed <n> [--seed <n> ...]

It prints, per seed, one JSON line with the numbers the check compares,
each beside its limit, and whether the check would call the control
correct (it must not).  The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark import harness

    cell = harness.load_cell(args.workload)
    kind = harness.load_module("jobs", cell.config["job"])
    for seed in args.seed:
        state = kind.setup(cell.config, cell.traffic, seed, args.device)
        order = harness.statement_order(cell.traffic, seed)
        statements = [next(order) for _ in range(cell.traffic["pool"])]
        t0 = time.perf_counter()
        numbers = kind.control(state, statements)
        print(json.dumps({
            "workload": cell.name, "seed": seed, "control_s": time.perf_counter() - t0,
            "correct": all(v <= lim for _, v, lim in numbers),
            "checks": {n: {"value": v, "limit": lim} for n, v, lim in numbers},
        }), flush=True)
        del state
    return 0


if __name__ == "__main__":
    sys.exit(main())
