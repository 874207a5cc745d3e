"""The benchmark of zk_tpu_torch on NVIDIA GPUs.

Run from the root of a checkout:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One process is one run of one cell of BENCHMARK.json: load the program,
build or load its kernels, make the cell's statements on the card from the
seed, warm up on them, run the closed loop for --seconds (with --trace 1 a
profiled window of the cell's ``trace_jobs`` jobs), check every output
against the plain reference in benchmark/reference, and print one JSON
line last on standard output; the numbers compared, each beside its limit,
are the last lines on standard error.  Without a CUDA card it exits with
code 2 and prints no result.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # kernel caches at fixed paths inside the checkout
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, ".bench_cache", "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, ".bench_cache", "torch_extensions")
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    try:
        import zk_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"benchmark: the program is missing from this checkout: {exc}", file=sys.stderr)
        return 2
    line, checks = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", STARTED)
    for name, value, limit in checks:
        print(f"check {name}: {value} (limit {limit})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
