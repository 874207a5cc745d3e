"""Smoke test of zk_tpu_torch on one NVIDIA GPU: build, check, drive.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and fails (non-zero exit, no result line) without
one.  Phases, each an uncaught exception on failure:

  1. device: card name, CUDA version, ``nvidia-smi`` name and power limit;
     build every kernel from zk_tpu_torch/csrc with nvcc (timed);
  2. kernels against their plain torch versions on the card, exact
     equality: fold_multi (f = 1..4), round_sums ((D, k) in (1,1), (2,2),
     (3,1)), fold_halfsums on Goldilocks and BLS12-381 Fr at 2^4, 2^12,
     2^18 and the main path's 2^24 (BLS12-381), and Keccak-f[1600] on 64
     random states plus the Keccak-256("") known answer;
  3. tier differential at n = 14 (BLS12-381): the device-transcript prove
     equals the synced-kernel prove and the exact host-int prove;
  4. main path at n = 24 (BLS12-381 Fr): MLE.evaluate, prove_partial
     (cold and warm), verify_partial and the oracle check, the
     host-transcript prove equal to the device-transcript prove, all four
     kernels launched; then prove + verify in full at n = 20.

Before the last line it prints the per-kernel JSON line
``{"kernels": [...]}``; the last line is the result object.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

from zk_tpu_torch import MLE, ProductPoly, SumcheckProver, SumcheckVerifier, _cuda
from zk_tpu_torch.fields import BLS12_381_FR, GOLDILOCKS
from zk_tpu_torch.fields import device as dev
from zk_tpu_torch.sumcheck import capacity as C
from zk_tpu_torch.sumcheck import proof_to_bytes
from zk_tpu_torch.transcript import HAS_NATIVE
from zk_tpu_torch.transcript import device as tdev
from zk_tpu_torch.utils import mle_eval_mults, sumcheck_prover_mults

FR = BLS12_381_FR
KECCAK256_EMPTY = "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470"
SIZES = (1 << 4, 1 << 12, 1 << 18)
MAIN_N = 24
DEVICE = "cuda"

KERNEL_INFO = {
    "fold_multi": ("zk_tpu_torch/csrc/capacity.cu", "zk_tpu/sumcheck/capacity.py:310"),
    "round_sums": ("zk_tpu_torch/csrc/capacity.cu", "zk_tpu/sumcheck/capacity.py:115"),
    "fold_halfsums": ("zk_tpu_torch/csrc/capacity.cu", "zk_tpu/sumcheck/capacity.py:250"),
    "keccak_f1600": ("zk_tpu_torch/csrc/keccak.cu", "zk_tpu/transcript/device.py:108"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def rand_limbs(field, shape, gen) -> torch.Tensor:
    """Random valid Montgomery limbs (< p) of shape (..., L, n) on the card."""
    L = field.n_limbs
    t = torch.randint(0, 1 << 16, shape, generator=gen, device=DEVICE, dtype=torch.int32)
    top = (field.p >> (16 * (L - 1))).bit_length() - 1
    t[..., L - 1, :] &= (1 << top) - 1
    return t


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean device time of fn() over reps launches after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.long() - b.long()).abs().max().item())


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs only on a GPU")
    name = torch.cuda.get_device_name(0)
    log(f"device: {name}; torch {torch.__version__}; CUDA {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(smi)
    t0 = time.perf_counter()
    _cuda.lib()
    log(f"kernel build + load: {time.perf_counter() - t0:.2f} s (nvcc {_cuda.last_build_seconds} s)")
    log(f"host transcript backend: {'native C' if HAS_NATIVE else 'pure Python'}")
    return name


def check_fold_multi(field, size, f, gen, timed=False):
    L = field.n_limbs
    stack = rand_limbs(field, (1, L, size), gen)
    rs = rand_limbs(field, (L, f), gen)
    want = C.fold_multi_plain(field, stack, size, rs, stack.new_zeros((1, L, size >> f)))
    out = C.fold_multi(field, stack, size, rs, out=stack.new_empty((1, L, size >> f)))
    inplace = stack.clone()
    C.fold_multi(field, inplace, size, rs, out=inplace)
    torch.cuda.synchronize()
    n = size >> f
    if not (torch.equal(out, want) and torch.equal(inplace[:, :, :n], want)):
        raise AssertionError(f"fold_multi {field.name} size={size} f={f}: kernel != plain")
    res = {"err": max(max_err(out, want), max_err(inplace[:, :, :n], want))}
    if timed:
        buf = stack.new_empty((1, L, n))
        res["ms"] = cuda_ms(lambda: C.fold_multi(field, stack, size, rs, out=buf))
        res["plain_ms"] = cuda_ms(lambda: C.fold_multi_plain(field, stack, size, rs, buf), 2)
    return res


def check_round_sums(field, size, degree, k, gen, timed=False):
    stack = rand_limbs(field, (k, field.n_limbs, size), gen)
    want = C.round_sums_plain(field, degree, stack, size)
    got = C.round_sums(field, degree, stack, size)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"round_sums {field.name} size={size} D={degree} k={k}: kernel != plain")
    res = {"err": max_err(got, want)}
    if timed:
        res["ms"] = cuda_ms(lambda: C.round_sums(field, degree, stack, size))
        res["plain_ms"] = cuda_ms(lambda: C.round_sums_plain(field, degree, stack, size), 2)
    return res


def check_fold_halfsums(field, size, gen, timed=False):
    L = field.n_limbs
    stack = rand_limbs(field, (1, L, size), gen)
    r = rand_limbs(field, (L, 1), gen)
    want, want_acc = C.fold_halfsums_plain(field, stack, size, r, stack.new_zeros((1, L, size // 2)))
    out, acc = C.fold_halfsums(field, stack, size, r, out=stack.new_empty((1, L, size // 2)))
    inplace = stack.clone()
    _, acc2 = C.fold_halfsums(field, inplace, size, r, out=inplace)
    torch.cuda.synchronize()
    h = size // 2
    ok = torch.equal(out, want) and torch.equal(inplace[:, :, :h], want)
    if not (ok and torch.equal(acc, want_acc) and torch.equal(acc2, want_acc)):
        raise AssertionError(f"fold_halfsums {field.name} size={size}: kernel != plain")
    res = {"err": max(max_err(out, want), max_err(acc, want_acc))}
    if timed:
        buf = stack.new_empty((1, L, h))
        res["ms"] = cuda_ms(lambda: C.fold_halfsums(field, stack, size, r, out=buf))
        res["plain_ms"] = cuda_ms(lambda: C.fold_halfsums_plain(field, stack, size, r, buf), 2)
    return res


def check_keccak(gen):
    lo = torch.randint(0, 1 << 32, (64, 25), generator=gen, device=DEVICE, dtype=torch.int64)
    hi = torch.randint(0, 1 << 32, (64, 25), generator=gen, device=DEVICE, dtype=torch.int64)
    wlo, whi = tdev.keccak_f1600_plain(lo, hi)
    glo, ghi = tdev.keccak_f1600_device(lo, hi)
    torch.cuda.synchronize()
    if not (torch.equal(glo, wlo) and torch.equal(ghi, whi)):
        raise AssertionError("keccak_f1600: kernel != plain on 64 random states")
    z = torch.zeros(25, dtype=torch.int64, device=DEVICE)
    digest = tdev.squeeze(z, z, torch.zeros(tdev.RATE, dtype=torch.int64, device=DEVICE), 0)
    if bytes(digest.tolist()) != bytes.fromhex(KECCAK256_EMPTY):
        raise AssertionError("Keccak-256('') known answer mismatch on the card")
    one_lo, one_hi = lo[0].contiguous(), hi[0].contiguous()
    return {
        "err": max(max_err(glo, wlo), max_err(ghi, whi)),
        "ms": cuda_ms(lambda: tdev.keccak_f1600_device(one_lo, one_hi), 50),
        "plain_ms": cuda_ms(lambda: tdev.keccak_f1600_plain(one_lo, one_hi), 5),
    }


def phase_kernels() -> dict:
    """Every kernel against its plain version; returns the main-path-shape
    timings and the largest error per kernel."""
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    errs = {k: 0 for k in KERNEL_INFO}
    for field in (GOLDILOCKS, FR):
        for size in SIZES:
            for f in range(1, 5):
                errs["fold_multi"] = max(errs["fold_multi"], check_fold_multi(field, size, f, gen)["err"])
            for degree, k in ((1, 1), (2, 2), (3, 1)):
                errs["round_sums"] = max(errs["round_sums"], check_round_sums(field, size, degree, k, gen)["err"])
            errs["fold_halfsums"] = max(errs["fold_halfsums"], check_fold_halfsums(field, size, gen)["err"])
        log(f"kernels == plain versions: {field.name} at sizes {SIZES}")
    for size in (SIZES[-1], 1 << MAIN_N):
        timed = {
            "fold_multi": check_fold_multi(FR, size, 4, gen, timed=True),
            "round_sums": check_round_sums(FR, size, 1, 1, gen, timed=True),
            "fold_halfsums": check_fold_halfsums(FR, size, gen, timed=True),
        }
        for name, res in timed.items():
            log(f"  {name} BLS12-381 size=2^{size.bit_length() - 1}: kernel {res['ms']:.4f} ms, "
                f"plain {res['plain_ms']:.4f} ms, max_abs_err {res['err']}")
            errs[name] = max(errs[name], res["err"])
    torch.cuda.empty_cache()
    timed["keccak_f1600"] = check_keccak(gen)
    errs["keccak_f1600"] = timed["keccak_f1600"]["err"]
    log(f"  keccak_f1600 one state: kernel {timed['keccak_f1600']['ms']:.4f} ms, "
        f"plain {timed['keccak_f1600']['plain_ms']:.4f} ms")
    for name in timed:
        timed[name]["err"] = errs[name]
    return timed


def phase_tier_differential() -> None:
    gen = torch.Generator(device=DEVICE).manual_seed(14)
    poly = ProductPoly([MLE(FR, 14, rand_limbs(FR, (FR.n_limbs, 1 << 14), gen))])
    total = dev.decode_ints(FR, dev.sum_mod(FR, poly.polynomials[0].data).reshape(-1, 1))[0]
    device_tr = SumcheckProver.prove_partial(poly, total, max_var_degree=1)
    synced = SumcheckProver.prove_partial(poly, total, max_var_degree=1, device_transcript=False)
    host = SumcheckProver.prove_partial(
        poly, total, max_var_degree=1, tail_size=1 << 30, device_transcript=False
    )
    if not device_tr == synced == host:
        raise AssertionError("tier differential FAILED at n=14")
    log("tier differential n=14: device-transcript == synced-kernel == host-int proofs")


def main_table(n: int) -> MLE:
    """bench.py's table: random 16-bit limbs, top limb masked to 0x1FFF."""
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    data = torch.randint(0, 1 << 16, (FR.n_limbs, 1 << n), generator=gen, device=DEVICE, dtype=torch.int32)
    data[FR.n_limbs - 1] &= 0x1FFF
    return MLE(FR, n, data)


def timed_runs(fn, reps: int) -> list[float]:
    """Wall seconds of reps calls of fn (each ends in a host readback)."""
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out.append(time.perf_counter() - t0)
    return out


def spread(samples: list[float]) -> str:
    return (f"median {statistics.median(samples):.6f} s, min {min(samples):.6f} s, "
            f"max {max(samples):.6f} s over {len(samples)} warm runs")


def phase_main_path(reps: int = 5) -> dict:
    n = MAIN_N
    poly = main_table(n)
    point = [(0x1234567 + i * 0xDEADBEEF) % FR.p for i in range(n)]
    total = dev.decode_ints(FR, dev.sum_mod(FR, poly.data).reshape(-1, 1))[0]
    pp = ProductPoly([poly])
    torch.cuda.synchronize()

    _cuda.reset_launches()
    t0 = time.perf_counter()
    value = poly.evaluate(point)
    eval_cold = time.perf_counter() - t0
    values = []
    evals = timed_runs(lambda: values.append(poly.evaluate(point)), reps)
    if any(v != value for v in values):
        raise AssertionError("MLE.evaluate is not deterministic")
    rate = mle_eval_mults(n) / statistics.median(evals)
    log(f"MLE.evaluate 2^{n}: cold {eval_cold:.6f} s; warm {spread(evals)} "
        f"-> {rate:.6e} field-mults/s at the median")

    t0 = time.perf_counter()
    proof, challenges = SumcheckProver.prove_partial(pp, total, max_var_degree=1)
    prove_cold = time.perf_counter() - t0
    proofs = []
    proves = timed_runs(lambda: proofs.append(SumcheckProver.prove_partial(pp, total, max_var_degree=1)), reps)
    if any(p != (proof, challenges) for p in proofs):
        raise AssertionError("prove_partial is not deterministic")
    log(f"prove_partial 2^{n}: cold {prove_cold:.6f} s; warm {spread(proves)} "
        f"({sumcheck_prover_mults(n, 1, 1) / statistics.median(proves):.6e} field-mults/s at the median)")

    t0 = time.perf_counter()
    sub = SumcheckVerifier.verify_partial(FR, proof)
    if sub.challenges != challenges:
        raise AssertionError("verifier challenges differ from the prover's")
    if poly.evaluate(sub.challenges) != sub.sum:
        raise AssertionError("oracle check failed: MLE(challenges) != subclaim sum")
    log(f"verify_partial + oracle check: OK ({time.perf_counter() - t0:.4f} s)")

    host_proofs = []
    host_runs = timed_runs(lambda: host_proofs.append(
        SumcheckProver.prove_partial(pp, total, max_var_degree=1, device_transcript=False)), reps)
    if any(p != (proof, challenges) for p in host_proofs):
        raise AssertionError("host-transcript prove differs from the device-transcript prove")
    log(f"host-transcript prove_partial 2^{n} identical; {spread(host_runs)}")
    counts = _cuda.launches()
    log(f"main-path kernel launches: {counts}")
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
    del poly, pp
    torch.cuda.empty_cache()

    small = main_table(20)
    small_pp = ProductPoly([small])
    small_total = dev.decode_ints(FR, dev.sum_mod(FR, small.data).reshape(-1, 1))[0]
    t0 = time.perf_counter()
    full = SumcheckProver.prove(small_pp, small_total, max_var_degree=1)
    t1 = time.perf_counter()
    if not SumcheckVerifier.verify(small_pp, full):
        raise AssertionError("full verify at n=20 rejected an honest proof")
    log(f"prove + verify 2^20 (absorb_poly): prove {t1 - t0:.4f} s, verify "
        f"{time.perf_counter() - t1:.4f} s, proof {len(proof_to_bytes(FR, full))} bytes")
    return counts


def main() -> int:
    name = phase_device()
    timed = phase_kernels()
    phase_tier_differential()
    counts = phase_main_path()
    kernels = []
    for kname, (source, replaces) in KERNEL_INFO.items():
        res = timed[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": counts[kname], "max_abs_err": res["err"],
            "ms": res["ms"], "plain_ms": res["plain_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
