"""Where the GKR prove's time goes, on one NVIDIA GPU.

Run from the repository root on a card:

    python3 scripts/profile_gkr.py [--log 19] [--reps 5]

For bench.py's 2 x 2^log-gate BLS12-381 circuit on inputs made on the card
(chip_smoke.py's phase 5), it prints:

  * the warm wall time of the device-chain prove and of the synced
    per-phase prove (median, min, max of --reps);
  * the chain's stages, replayed one by one in prove_chain's order with a
    device synchronise around each (host clock), and the mean time of one
    device transcript round;
  * for one warm prove of each prover, under torch.profiler: the device
    ops launched, the device busy time (the sum of kernel times) against
    the wall time, and the kernels that took the most device time.

The card's name and power limit come first, as nvidia-smi reports them.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import bench_gkr_circuit  # noqa: E402
from zk_tpu_torch.fields import BLS12_381_FR as FR  # noqa: E402
from zk_tpu_torch.fields import device as dev  # noqa: E402
from zk_tpu_torch.gkr import GKRProver  # noqa: E402
from zk_tpu_torch.gkr import chain as ch  # noqa: E402
from zk_tpu_torch.gkr import device as gdev  # noqa: E402
from zk_tpu_torch.poly.mle import fold_var0  # noqa: E402
from zk_tpu_torch.sumcheck import kernels as K  # noqa: E402
from zk_tpu_torch.transcript import Transcript  # noqa: E402
from zk_tpu_torch.transcript import device as tdev  # noqa: E402


def synced(fn):
    """(result, host seconds) of fn() between two device synchronises."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def stages(c, inputs) -> dict[str, float]:
    """prove_chain's steps, one at a time, each timed on its own."""
    t: dict[str, float] = {}

    def step(name, fn):
        out, s = synced(fn)
        t[name] = t.get(name, 0.0) + s
        return out

    levels = step("witness (evaluate_device)", lambda: gdev.evaluate_device(c, FR, inputs))
    n_out = len(c.layers[0])
    out_bytes = step("output fetch (decode_bytes_be)", lambda: dev.decode_bytes_be(FR, levels[0])[: n_out * FR.n_bytes])

    def bind_outputs():
        tr = Transcript()
        tr.append(out_bytes)
        r = tr.sample_n_field_elements(FR, c.layer_k(0))
        m = gdev.mle_eval_points(FR, levels[0], [r])
        return r, m, tdev.state_to_device(*tr.export_state(), levels[0].device)

    r, m, (lo, hi, buf, pos) = step("host absorb of the outputs + r0 + claim", bind_outputs)
    r_kl = gdev._mont_rs(FR, r, levels[0].device)
    for i in range(c.depth):
        w = levels[i + 1]
        eq_r = step("eq tables", lambda: gdev._eq_expand(FR, r_kl))
        g1, a2 = step("phase tables", lambda: gdev.phase1_tables(FR, c, i, eq_r, w))
        lo, hi, buf, pos = step("bind claim", lambda: ch._bind(FR, pos, lo, hi, buf, m))
        _, u, lo, hi, buf = step("phase rounds", lambda: ch._run_phase(FR, (2, 1), [g1, w, a2], pos, lo, hi, buf))
        eq_u = step("eq tables", lambda: gdev._eq_expand(FR, u.t()))
        wu = step("W(u) (fold_multi)", lambda: fold_var0(FR, w, u))
        p2 = step("phase tables", lambda: gdev.phase2_tables(FR, c, i, eq_r, eq_u, w, wu))
        _, v, lo, hi, buf = step("phase rounds", lambda: ch._run_phase(FR, (2, 2), [p2[0], p2[2], p2[1], w], 32, lo, hi, buf))
        lo, hi, buf, _, r_kl, m = step("line step", lambda: ch._line_step(FR, 32, lo, hi, buf, w, u, v))
        pos = 32
    return t


def transcript_round_s(reps: int = 20) -> float:
    """Mean wall time of one device transcript round (3 points)."""
    partials = torch.randint(0, 1 << 30, (3, FR.n_limbs, 1024), device="cuda", dtype=torch.int64)
    z = torch.zeros(25, dtype=torch.int64, device="cuda")
    state = (z, z, torch.zeros(tdev.RATE, dtype=torch.int64, device="cuda"))
    K.transcript_round(FR, 32, *state, partials)
    _, s = synced(lambda: [K.transcript_round(FR, 32, *state, partials) for _ in range(reps)])
    return s / reps


def profiled(fn, label: str) -> None:
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm inside the run, outside the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e3  # ms
    ops = sum(e.count for e in kern)
    print(f"{label}: wall {wall * 1e3:.3f} ms, device busy {busy:.3f} ms ({100 * busy / (wall * 1e3):.2f}%), "
          f"{ops} device ops", flush=True)
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"    {e.self_device_time_total / 1e3:10.3f} ms  x{e.count:<6d} {e.key[:90]}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log", type=int, default=19, help="log2 of the gates per layer")
    ap.add_argument("--reps", type=int, default=5, help="warm proves per prover")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this profile runs only on a GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)

    c = bench_gkr_circuit(args.log)
    gen = torch.Generator(device="cuda").manual_seed(11)
    inputs = torch.randint(0, 1 << 16, (FR.n_limbs, 1 << args.log), generator=gen, device="cuda", dtype=torch.int32)
    inputs[FR.n_limbs - 1] &= 0x1FFF
    chain = lambda: GKRProver.prove(FR, c, inputs)  # noqa: E731
    per_phase = lambda: GKRProver.prove(FR, c, inputs, device_transcript=False)  # noqa: E731
    chain()
    for label, fn in (("chain", chain), ("synced per-phase", per_phase)):
        runs = [synced(fn)[1] for _ in range(args.reps)]
        print(f"{label} prove 2 x 2^{args.log}: median {statistics.median(runs):.6f} s, "
              f"min {min(runs):.6f} s, max {max(runs):.6f} s over {args.reps}", flush=True)

    t = stages(c, inputs)
    print(f"chain stages, one warm prove replayed step by step (total {sum(t.values()):.6f} s):", flush=True)
    for name, s in sorted(t.items(), key=lambda kv: -kv[1]):
        print(f"    {s:10.6f} s  {name}", flush=True)
    print(f"one device transcript round (3 points): {transcript_round_s() * 1e3:.3f} ms", flush=True)

    profiled(chain, "profile, chain prove")
    profiled(per_phase, "profile, synced per-phase prove")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,temperature.gpu",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"after the runs: {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
