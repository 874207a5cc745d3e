"""Where the 2^20 NTT roundtrip's time goes, on one NVIDIA GPU.

Run from the repository root on a card:

    python3 scripts/profile_ntt.py [--log 20] [--reps 5]

For chip_smoke.py's phase 6 inputs (bench.py bench_ntt's Goldilocks
values (i * 0x12345 + 7) mod p, and random BLS12-381 Fr limbs from a
seeded generator), it prints, per field:

  * the warm wall time of ntt + intt ending in a readback (median, min,
    max of --reps);
  * for one warm roundtrip under torch.profiler: the device ops launched,
    the device busy time (the sum of kernel times) against the wall time,
    and the kernels that took the most device time (ntt_ladder, mont_mul
    and the transposes' copies).

The card's name and power limit come first, as nvidia-smi reports them.
"""

from __future__ import annotations

import argparse
import importlib
import os
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import rand_limbs  # noqa: E402
from scripts.profile_gkr import profiled, synced  # noqa: E402
from zk_tpu_torch.fields import BLS12_381_FR, GOLDILOCKS  # noqa: E402
from zk_tpu_torch.fields import device as dev  # noqa: E402

NTT = importlib.import_module("zk_tpu_torch.ntt")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log", type=int, default=20, help="log2 of the transform length")
    ap.add_argument("--reps", type=int, default=5, help="warm roundtrips per field")
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
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,temperature.gpu",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"after the runs: {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
