"""Compare checkouts of this repository on one NVIDIA GPU, in turns.

Run from any directory on a card, naming the checkouts in the order to
run them (for example a parent commit unpacked with ``git archive``
beside the working tree):

    python3 scripts/compare_trees.py ../parent . . ../parent [--gkr] [--ntt]

Each checkout runs in a fresh process from its own root: the kernel build
(``chip_smoke.phase_device``), then the sumcheck main path
(``chip_smoke.phase_main_path``: MLE.evaluate and prove_partial at 2^24
BLS12-381, host-clock medians of 5 warm runs), with ``--gkr`` the GKR
main path (``phase_gkr_main``) and with ``--ntt`` the NTT main path
(``phase_ntt_main``: the 2^20 ntt+intt roundtrips, Goldilocks and
BLS12-381). Only the timing lines are printed, under a ``=== <checkout>``
header.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

KEEP = ("kernel build", "MLE.evaluate", "prove_partial", "GKR 2 x", "GKR synced", "ntt+intt", "Error", "error")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="+", help="checkout roots, in the order to run them")
    ap.add_argument("--gkr", action="store_true", help="also run the GKR main path")
    ap.add_argument("--ntt", action="store_true", help="also run the NTT main path")
    args = ap.parse_args()
    code = "import chip_smoke as S\nS.phase_device()\nS.phase_main_path()\n"
    if args.gkr:
        code += "S.phase_gkr_main()\n"
    if args.ntt:
        code += "S.phase_ntt_main()\n"
    rc = 0
    for tree in args.trees:
        print(f"=== {tree}", flush=True)
        r = subprocess.run([sys.executable, "-c", code], cwd=tree, capture_output=True, text=True)
        for line in (r.stdout + r.stderr).splitlines():
            if any(k in line for k in KEEP):
                print(line, flush=True)
        rc = rc or r.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
