"""Where the 2^20 NTT roundtrip's time goes, on one NVIDIA GPU.

Run from the repository root on a card:

    python3 scripts/profile_ntt.py [--log 20] [--reps 5] [--mle] [--prove] [--sharded]

For chip_smoke.py's phase 6 inputs (bench.py bench_ntt's Goldilocks
values (i * 0x12345 + 7) mod p, and random BLS12-381 Fr limbs from a
seeded generator), it prints, per field:

  * the warm wall time of ntt + intt ending in a readback (median, min,
    max of --reps);
  * for one warm roundtrip under torch.profiler: the device ops launched,
    the device busy time (the sum of kernel times) against the wall time,
    and the kernels that took the most device time (the ntt_ladder passes,
    and anything else the transform launches).

With ``--mle`` it does the same for chip_smoke.py's warm 2^24 BLS12-381
``MLE.evaluate`` (the fold_multi chain), and splits one evaluation's host
time into encoding the point, enqueueing the folds, waiting for the card
and decoding the value.  With ``--prove`` it does the same for
chip_smoke.py's warm 2^24 BLS12-381 ``prove_partial`` (degree 1, the
device transcript): its walls, and under the profiler its device ops,
busy share and kernels.  With ``--sharded`` it does the same for
``ShardedSumcheckProver.prove_partial`` of that table on a world-size-1
NCCL mesh, with the single-device prove's walls taken in the same turns,
and prints the profile's largest host-side ops (the collectives' cost is
host time).

The card's name and power limit come first, as nvidia-smi reports them.
"""

from __future__ import annotations

import argparse
import importlib
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import main_table, rand_limbs  # noqa: E402
from zk_tpu_torch import ProductPoly, SumcheckProver  # noqa: E402
from scripts.profile_gkr import profiled, synced  # noqa: E402
from zk_tpu_torch.fields import BLS12_381_FR, GOLDILOCKS  # noqa: E402
from zk_tpu_torch.fields import device as dev  # noqa: E402
from zk_tpu_torch.poly.mle import fold_var0  # noqa: E402

NTT = importlib.import_module("zk_tpu_torch.ntt")


def profile_mle(reps: int, n: int = 24) -> None:
    """chip_smoke.py's 2^24 BLS12-381 evaluation: warm walls, a profile,
    and one evaluation's host time by step."""
    poly = main_table(n)
    field = poly.field
    point = [(0x1234567 + i * 0xDEADBEEF) % field.p for i in range(n)]
    poly.evaluate(point)
    runs = [synced(lambda: poly.evaluate(point))[1] for _ in range(reps)]
    print(f"MLE.evaluate 2^{n}: median {statistics.median(runs):.6f} s, min {min(runs):.6f} s, "
          f"max {max(runs):.6f} s over {reps}", flush=True)
    profiled(lambda: poly.evaluate(point), f"profile, MLE.evaluate 2^{n}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rs = dev.encode_ints(field, point, device=poly.data.device)
    t1 = time.perf_counter()
    out = fold_var0(field, poly.data, rs)
    t2 = time.perf_counter()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    dev.decode_ints(field, out)
    t4 = time.perf_counter()
    print(f"one MLE.evaluate 2^{n} by step: encode + upload {1e3 * (t1 - t0):.3f} ms, enqueue the folds "
          f"{1e3 * (t2 - t1):.3f} ms, wait for the card {1e3 * (t3 - t2):.3f} ms, decode {1e3 * (t4 - t3):.3f} ms",
          flush=True)


def profile_prove(reps: int, n: int = 24) -> None:
    """chip_smoke.py's warm 2^24 BLS12-381 prove_partial: walls and a profile."""
    poly = main_table(n)
    field = poly.field
    total = dev.decode_ints(field, dev.sum_mod(field, poly.data).reshape(-1, 1))[0]
    pp = ProductPoly([poly])
    prove = lambda: SumcheckProver.prove_partial(pp, total, max_var_degree=1)  # noqa: E731
    prove()
    runs = [synced(prove)[1] for _ in range(reps)]
    print(f"prove_partial 2^{n}: median {statistics.median(runs):.6f} s, min {min(runs):.6f} s, "
          f"max {max(runs):.6f} s over {reps}", flush=True)
    profiled(prove, f"profile, prove_partial 2^{n}")


def profile_sharded(reps: int, n: int = 24) -> None:
    """The warm 2^24 BLS12-381 prove_partial on a world-size-1 NCCL mesh:
    walls in turns with the single-device prove, a profile, and its
    largest host ops."""
    import tempfile

    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from zk_tpu_torch.parallel import ShardedSumcheckProver, make_mesh

    poly = main_table(n)
    field = poly.field
    total = dev.decode_ints(field, dev.sum_mod(field, poly.data).reshape(-1, 1))[0]
    pp = ProductPoly([poly])
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/init", rank=0, world_size=1)
        try:
            mesh = make_mesh()
            fns = {
                "single": lambda: SumcheckProver.prove_partial(pp, total, max_var_degree=1),
                "sharded": lambda: ShardedSumcheckProver.prove_partial(mesh, pp, total, max_var_degree=1),
            }
            runs = {k: [] for k in fns}
            for i in range(reps):
                for k in (list(fns) if i % 2 == 0 else list(fns)[::-1]):
                    runs[k].append(synced(fns[k])[1])
            for k, v in runs.items():
                print(f"{k} prove_partial 2^{n}: median {statistics.median(v):.6f} s, min {min(v):.6f} s, "
                      f"max {max(v):.6f} s over {reps} (in turns)", flush=True)
            profiled(fns["sharded"], f"profile, sharded prove_partial 2^{n}")
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fns["sharded"]()
                torch.cuda.synchronize()
            host = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CPU]
            for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:10]:
                print(f"    host {e.self_cpu_time_total / 1e3:10.3f} ms  x{e.count:<6d} {e.key[:80]}", flush=True)
        finally:
            dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log", type=int, default=20, help="log2 of the transform length")
    ap.add_argument("--reps", type=int, default=5, help="warm roundtrips per field")
    ap.add_argument("--mle", action="store_true", help="also profile the warm 2^24 MLE.evaluate")
    ap.add_argument("--prove", action="store_true", help="also profile the warm 2^24 prove_partial")
    ap.add_argument("--sharded", action="store_true",
                    help="also profile the warm 2^24 prove_partial on a world-size-1 NCCL mesh")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this profile runs only on a GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    n = 1 << args.log
    g = GOLDILOCKS
    inputs = {
        "Goldilocks": (g, dev.encode_ints(g, [(i * 0x12345 + 7) % g.p for i in range(n)], device="cuda")),
        "BLS12-381 Fr": (BLS12_381_FR, rand_limbs(BLS12_381_FR, (BLS12_381_FR.n_limbs, n),
                                                  torch.Generator(device="cuda").manual_seed(13))),
    }
    for name, (field, data) in inputs.items():
        def roundtrip(field=field, data=data):
            return NTT.intt_device(field, NTT.ntt_device(field, data))[:1, :1].cpu()

        roundtrip()
        runs = [synced(roundtrip)[1] for _ in range(args.reps)]
        print(f"ntt+intt 2^{args.log} {name}: median {statistics.median(runs):.6f} s, "
              f"min {min(runs):.6f} s, max {max(runs):.6f} s over {args.reps}", flush=True)
        profiled(roundtrip, f"profile, ntt+intt 2^{args.log} {name}")
    if args.mle:
        profile_mle(args.reps)
    if args.prove:
        profile_prove(args.reps)
    if args.sharded:
        profile_sharded(args.reps)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,temperature.gpu",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"after the runs: {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
