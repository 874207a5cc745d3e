"""Smoke test of zk_tpu_torch on one NVIDIA GPU: build, check, drive.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and fails (non-zero exit, no result line) without
one.  Phases, each an uncaught exception on failure:

  1. device: card name, CUDA version, ``nvidia-smi`` name and power limit;
     build every kernel from zk_tpu_torch/csrc (one nvcc per source, in
     parallel; timed), and the registers, spills and SASS sizes of the
     redesigned kernels (fold_multi, ntt_ladder, round_sums_terms,
     transcript_round);
  2. kernels against their plain torch versions on the card, exact
     equality: fold_multi (f = 1..4, fresh and in place) on Goldilocks,
     BLS12-381 Fr and BLS12-377 Fr at 2^4, 2^12, 2^18 and 2^24;
     round_sums ((D, k) in (1,1), (2,2), (3,1)) and fold_halfsums on
     Goldilocks and BLS12-381 Fr at 2^4, 2^12, 2^18 and the main path's
     2^24 (BLS12-381); Keccak-f[1600] on 64 random states plus the
     Keccak-256("") known answer; transcript_round (the sumcheck prover's
     whole Fiat-Shamir round) on Goldilocks, BLS12-381 Fr and BLS12-377 Fr
     at D = 1, 2, 3, pos = 0, 32, 100, 135 and G = 1, 7, 1024 partials,
     every output tensor equal;
  2b. the GKR kernels against their plain versions, exact: fold (K = 1..5)
     on Goldilocks and BLS12-381 Fr at 2^4, 2^12, 2^18, and at GKR's 2^19
     (BLS12-381); round_sums_terms (term sizes (2,1), (2,2), (2,3)) at
     every power of two from 2^4 to 2^19 in both fields;
  2c. the NTT path's kernels against their plain versions, exact:
     ntt_ladder (one level of the radix recursion along axis -2) forward
     and inverse on Goldilocks, BLS12-381 Fr and BLS12-377 Fr at lengths
     2, 16 and 1024: the last level on 1, 3, 37 (a ragged tile) and 1024
     columns, an upper level (fused twiddles, transposed store) at
     batches 1, 3 and 1024 of 4 columns each; mont_mul and lerp at 2^4,
     2^12 and 2^20, lerp at 2^23 (BLS12-381); each timed at its main-path
     shape (ntt_ladder: the upper level of the 2^20 transform);
  2d. the HBM roofline reading: chained lerp folds of 2^23 BLS12-381
     pairs through fields.kernels.lerp (benches/roofline.py's shape), the
     share of 3.35 TB/s they reach, lerp's launches;
  3. tier differential at n = 14 (BLS12-381): the device-transcript prove
     equals the synced-kernel prove and the exact host-int prove; a device
     round is one transcript_round launch and no keccak_f1600;
  3b. GKR tier differential (BLS12-381): on a seeded random circuit of
     depth 3 and width 256 the device-resident chain, the per-phase synced
     prover and the dense O(4^k) prover give the same proof; the
     depth-3 width-8 circuit's proof equals tests/goldens/gkr_d3w8_prove.bin;
  4. sumcheck main path at n = 24 (BLS12-381 Fr): MLE.evaluate,
     prove_partial (cold and warm), verify_partial and the oracle check,
     the host-transcript prove equal to the device-transcript prove, its
     four kernels launched, a warm prove's launches exactly one
     round_sums, 24 transcript_round and 23 fold_halfsums; the product of
     two 2^24 factors at degree 2 (the benchmark's prod2 shape) proved by
     both tiers, equal, its launches exactly 24 round_sums, 23 fold and
     24 transcript_round; then prove + verify in full at n = 20;
  5. GKR main path: bench.py's 2 x 2^19-gate BLS12-381 circuit on inputs
     made on the card, a cold and 5 warm proves, the synced prove
     identical, verify (cold and warm) accepts, a flipped w_b is rejected,
     its five kernels (fold, round_sums_terms, fold_multi, transcript_round,
     keccak_f1600) launched, one transcript_round a phase round;
  6. NTT main path: bench.py bench_ntt's Goldilocks 2^20 roundtrip on its
     inputs (i * 0x12345 + 7) mod p, cold and 5 warm, and the same at 2^20
     in BLS12-381 Fr on random limbs: intt(ntt(x)) == x, forward outputs at
     k = 0, 1, 5, n - 1 against the DFT definition in host ints, the
     kernel route's forward output equal to the plain route's; the
     UnivariatePolynomial product of two degree-2^15 - 1 BLS12-381
     polynomials (the NTT route) checked at a random point, and one of 300
     coefficients equal to the schoolbook product; a warm 2^20 transform
     launches exactly two ntt_ladder passes and nothing else counted;
     ntt_ladder and mont_mul launched;
  7. the sharded paths (``zk_tpu_torch.parallel``): at world size 1 on
     NCCL (a ``file://`` rendezvous), the 2^24 table's sharded
     prove_partial equal to SumcheckProver's (round polys, challenges,
     bytes) with one transcript_round and one all_reduce a device round
     and one table kernel a sharded round (asserted), the GKR prove of
     phase 5's circuit with a mesh equal to the device chain's bytes and
     verified, the sharded 2^20 NTT in Goldilocks and BLS12-381 equal to
     ntt_device and inverted, each timed in turns against its
     single-device path; every kernel of these paths launched; one 2^26
     BLS12-381 sharded prove (a 4 GiB table) equal to the single-device
     one, its subclaim checked; then world size 2 over gloo on the one
     card: two ranks (this script with ``--sharded-rank``) prove the 2^24
     table and the GKR circuit, both exit 0 with the single-device
     bytes.

Before the last line it prints the per-kernel JSON line
``{"kernels": [...]}`` (time, plain time and bound at the timed shape, the
launches on each kernel's path and, as ``sharded_launches``, in phase 7's
world-size-1 run; for ntt_ladder also the last level's time and bound);
the last line is the result object.  Kernel times (``ms``) are
CUDA-event means of back-to-back calls.  For the two launches shorter than
their host wrappers (transcript_round, keccak_f1600) that is the wrapper's
rate, and the profiler's device time of the kernel alone stands beside it
as ``device_ms``.
"""

from __future__ import annotations

import contextlib
import hashlib
import importlib
import json
import os
import random
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from zk_tpu_torch import MLE, ProductPoly, SumcheckProver, SumcheckVerifier, UnivariatePolynomial, _cuda
from zk_tpu_torch import parallel as par
from zk_tpu_torch import transcript
from zk_tpu_torch.fields import BLS12_377_FR, BLS12_381_FR, GOLDILOCKS
from zk_tpu_torch.fields import device as dev
from zk_tpu_torch.fields import kernels as FK
from zk_tpu_torch.gkr import GKRError, GKRProof, GKRProver, GKRVerifier, gkr_proof_to_bytes
from zk_tpu_torch.gkr.chain import prove_chain
from zk_tpu_torch.gkr.circuit import Circuit, Gate
from zk_tpu_torch.sumcheck import SumcheckError, chain_rounds
from zk_tpu_torch.sumcheck import capacity as C
from zk_tpu_torch.sumcheck import kernels as K
from zk_tpu_torch.sumcheck import proof_to_bytes
from zk_tpu_torch.transcript import device as tdev

NTT = importlib.import_module("zk_tpu_torch.ntt")  # the package's own `ntt` attribute is the function

FR = BLS12_381_FR
KECCAK256_EMPTY = "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470"
SIZES = (1 << 4, 1 << 12, 1 << 18)
MAIN_N = 24
GKR_LOG = 19  # bench.py bench_gkr: 2 layers of 2^19 gates over 2^19 inputs
NTT_LOG = 20  # bench.py bench_ntt: the 2^20 roundtrip (BASELINE.json config 2)
LERP_LOG = 23  # benches/roofline.py measure_lerp_rate: 2^23 pairs
DEVICE = "cuda"
GOLDEN_GKR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "goldens", "gkr_d3w8_prove.bin")

KERNEL_INFO = {
    "fold_multi": ("zk_tpu_torch/csrc/capacity.cu", "zk_tpu/sumcheck/capacity.py:310"),
    "round_sums": ("zk_tpu_torch/csrc/capacity.cu", "zk_tpu/sumcheck/capacity.py:115"),
    "fold_halfsums": ("zk_tpu_torch/csrc/capacity.cu", "zk_tpu/sumcheck/capacity.py:250"),
    "keccak_f1600": ("zk_tpu_torch/csrc/keccak.cu", "zk_tpu/transcript/device.py:108"),
    "fold": ("zk_tpu_torch/csrc/capacity.cu", "zk_tpu/sumcheck/capacity.py:208"),
    "round_sums_terms": ("zk_tpu_torch/csrc/capacity.cu", "zk_tpu/sumcheck/capacity.py:149"),
    "ntt_ladder": ("zk_tpu_torch/csrc/ntt.cu", "zk_tpu/ntt/__init__.py:215"),
    "mont_mul": ("zk_tpu_torch/csrc/elementwise.cu", "zk_tpu/fields/pallas_kernels.py:68"),
    "lerp": ("zk_tpu_torch/csrc/elementwise.cu", "zk_tpu/fields/pallas_kernels.py:87"),
    # the round JAX jits around _rounds_kernel_pallas (capacity.py:379, 388, 422)
    "transcript_round": ("zk_tpu_torch/csrc/transcript.cu", "zk_tpu/transcript/device.py:108"),
}
# the sumcheck rounds' Fiat-Shamir steps are transcript_round launches and
# never keccak_f1600; GKR's claim binds and line steps still permute
SUMCHECK_KERNELS = ("fold_multi", "round_sums", "fold_halfsums", "transcript_round")
GKR_KERNELS = ("fold", "round_sums_terms", "fold_multi", "transcript_round", "keccak_f1600")
NTT_KERNELS = ("ntt_ladder", "mont_mul")
# the sharded sumcheck, GKR-with-a-mesh and sharded NTT paths
SHARDED_KERNELS = ("fold_multi", "round_sums", "fold_halfsums", "transcript_round", "fold", "round_sums_terms",
                   "ntt_ladder", "mont_mul")
ROOFLINE_KERNELS = ("lerp",)

# --------------------------------------------------------------------------
# bounds: the least time the card could take for a call's work
# --------------------------------------------------------------------------

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
# 32-bit integer multiply-adds: 64 per clock per SM on compute capability
# 9.0 (CUDA C++ Programming Guide, arithmetic instruction throughput),
# 132 SMs at the 1.98 GHz boost clock
IMAD_PER_S = 64 * 132 * 1.98e9
INT_OPS_PER_S = IMAD_PER_S  # 32-bit integer logic, also 64 per clock per SM


def mont_imads(field) -> int:
    """32-bit multiply-adds of one CIOS Montgomery product (csrc/field.cuh):
    2 NW^2 word products (product and reduction), each a 32x32->64
    multiply-add = 2 IMADs (low and high halves)."""
    nw = field.n_limbs // 2
    return 4 * nw * nw


def bound(nbytes: float, mont_products: float = 0.0, int_ops: float = 0.0, field=FR):
    """(bound_ms, bound_by): the larger of the bytes over the HBM rate and
    the integer operations over their peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = mont_products * mont_imads(field) / IMAD_PER_S + int_ops / INT_OPS_PER_S
    return (t_bytes * 1e3, "bytes") if t_bytes >= t_ops else (t_ops * 1e3, "operations")


def elem_bytes(field) -> int:
    return 4 * field.n_limbs  # one 16-bit limb per int32 word


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


def device_ms(fn, kernel: str, reps: int = 50) -> float:
    """Mean device time of the CUDA kernel whose name holds ``kernel`` over
    the calls of fn, from torch.profiler's trace of reps + 1 calls.  For a
    launch shorter than its host wrapper, where CUDA events around
    back-to-back calls time the wrapper instead (the first launch of a
    window may be missing from the trace, so the mean is over those seen)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps + 1):
            fn()
        torch.cuda.synchronize()
    seen = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.key]
    count = sum(e.count for e in seen)
    if count < reps:
        raise AssertionError(f"the profiler saw {count} launches of {kernel} in {reps + 1} calls")
    return sum(e.self_device_time_total for e in seen) / 1e3 / count


def max_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.long() - b.long()).abs().max().item())


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def _kernel_name(mangled: str) -> str:
    """``_ZN<len><ns>...<len>name_kernelILi8ELi4EE...`` -> ``name_kernel<8,4>``
    (the nested names of an Itanium-mangled kernel, template ints kept)."""
    if not mangled.startswith("_ZN"):
        return mangled
    pos, name = 3, mangled
    while pos < len(mangled) and mangled[pos].isdigit():
        m = re.match(r"\d+", mangled[pos:])
        n = int(m.group(0))
        pos += len(m.group(0))
        name = mangled[pos : pos + n]
        pos += n
    args = re.match(r"I((?:Li\d+E)+)E", mangled[pos:])
    return f"{name}<{','.join(re.findall(r'Li(\d+)E', args.group(1)))}>" if args else name


def kernel_resources(report: str | None = None) -> dict[str, tuple[int, int, int]]:
    """{kernel instance: (registers, spill store bytes, spill load bytes)}
    from a ptxas report (``-Xptxas -v``), by default the one kept beside
    the built library."""
    if report is None:
        path = _cuda.build().with_suffix(".ptxas.txt")
        report = path.read_text() if path.exists() else ""
    res, name, spills = {}, None, (0, 0)
    for line in report.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if m:
            name = _kernel_name(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            res[name] = (int(m.group(1)), *spills)
            spills = (0, 0)
    return res


def sass_counts(library=None) -> dict[str, int]:
    """{kernel instance: SASS instructions} of a shared library (by default
    the built one), from ``cuobjdump -sass`` beside nvcc ({} where
    cuobjdump is missing)."""
    nvcc = _cuda.find_nvcc()
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump") if nvcc else None
    if tool is None or not os.path.isfile(tool):
        return {}
    library = _cuda.build() if library is None else library
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True, text=True).stdout
    return {
        _kernel_name(fn.split()[0]): len(re.findall(r"/\*[0-9a-f]{4,}\*/\s+\S", fn))
        for fn in re.split(r"\n\s*Function : ", sass)[1:]
    }


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
    log(f"kernel build + load: {time.perf_counter() - t0:.2f} s")
    res, sass = kernel_resources(), sass_counts()
    log("redesigned kernels (ptxas registers, spill store / load bytes; SASS instructions): " + "; ".join(
        f"{k} {v[0]} regs, spills {v[1]}/{v[2]}, {sass.get(k, 'n/a')} instructions" for k, v in sorted(res.items())
        if k.startswith(("fold_multi_kernel", "ntt_ladder_kernel", "round_sums_terms_kernel",
                         "transcript_round_kernel"))))
    if not transcript.HAS_NATIVE:
        raise RuntimeError("no C compiler for the host Keccak: the GKR proofs' 16 MiB absorbs need it")
    log("host transcript backend: native C")
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


def check_fold(field, size, k, gen, timed=False):
    L = field.n_limbs
    stack = rand_limbs(field, (k, L, size), gen)
    r = rand_limbs(field, (L, 1), gen)
    h = size // 2
    want = C.fold_plain(field, stack, size, r, stack.new_zeros((k, L, h)))
    out = C.fold(field, stack, size, r, out=stack.new_empty((k, L, h)))
    inplace = stack.clone()
    C.fold(field, inplace, size, r, out=inplace)
    torch.cuda.synchronize()
    if not (torch.equal(out, want) and torch.equal(inplace[:, :, :h], want)):
        raise AssertionError(f"fold {field.name} size={size} K={k}: kernel != plain")
    res = {"err": max(max_err(out, want), max_err(inplace[:, :, :h], want))}
    if timed:
        buf = stack.new_empty((k, L, h))
        res["ms"] = cuda_ms(lambda: C.fold(field, stack, size, r, out=buf))
        res["plain_ms"] = cuda_ms(lambda: C.fold_plain(field, stack, size, r, buf), 2)
        res["bound"] = bound(k * size * elem_bytes(field) + k * h * elem_bytes(field), k * h, field=field)
    return res


def check_round_sums_terms(field, size, term_ks, gen, timed=False):
    stack = rand_limbs(field, (sum(term_ks), field.n_limbs, size), gen)
    want = C.round_sums_terms_plain(field, 2, term_ks, stack, size)
    got = C.round_sums_terms(field, 2, term_ks, stack, size)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"round_sums_terms {field.name} size={size} {term_ks}: kernel != plain")
    res = {"err": max_err(got, want)}
    if timed:
        res["ms"] = cuda_ms(lambda: C.round_sums_terms(field, 2, term_ks, stack, size))
        res["plain_ms"] = cuda_ms(lambda: C.round_sums_terms_plain(field, 2, term_ks, stack, size), 2)
        # per pair and term: (k - 1)(D + 1) products; the points >= 2 are
        # reached by adding differences
        per_pair = sum((k - 1) * 3 for k in term_ks)
        res["bound"] = bound(sum(term_ks) * size * elem_bytes(field), per_pair * size // 2, field=field)
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
    # one permutation: 24 rounds of ~213 64-bit logic ops (theta 65, rho 72,
    # chi 75, iota 1), two 32-bit ops each; 2 x 25 lanes in and out
    return {
        "err": max(max_err(glo, wlo), max_err(ghi, whi)),
        "ms": cuda_ms(lambda: tdev.keccak_f1600_device(one_lo, one_hi), 50),
        "device_ms": device_ms(lambda: tdev.keccak_f1600_device(one_lo, one_hi), "keccak_f1600_kernel"),
        "plain_ms": cuda_ms(lambda: tdev.keccak_f1600_plain(one_lo, one_hi), 5),
        "bound": bound(4 * 25 * 8, int_ops=24 * 213 * 2),
    }


TRANSCRIPT_GRID = ((1, 2, 3), (0, 32, 100, 135), (1, 7, 1024))  # D, pos, G


def check_transcript_round(field, D, pos, G, gen, timed=False):
    """transcript_round against transcript_round_plain from a random sponge
    with pos pending bytes and random (D+1, L, G) partials whose column
    sums stay below 2^56: every output tensor equal."""
    L = field.n_limbs
    partials = torch.randint(0, 1 << 40, (D + 1, L, G), generator=gen, device=DEVICE, dtype=torch.int64)
    lo = torch.randint(0, 1 << 32, (25,), generator=gen, device=DEVICE, dtype=torch.int64)
    hi = torch.randint(0, 1 << 32, (25,), generator=gen, device=DEVICE, dtype=torch.int64)
    buf = torch.zeros(tdev.RATE, dtype=torch.int64, device=DEVICE)
    buf[:pos] = torch.randint(0, 256, (pos,), generator=gen, device=DEVICE, dtype=torch.int64)
    want = K.transcript_round_plain(field, pos, lo, hi, buf, partials)
    got = K.transcript_round(field, pos, lo, hi, buf, partials)
    torch.cuda.synchronize()
    for name, w, g in zip(("lo", "hi", "buf", "total", "challenge", "challenge (Montgomery)"), want, got):
        if w.dtype != g.dtype or not torch.equal(w, g):
            raise AssertionError(f"transcript_round {field.name} D={D} pos={pos} G={G}: {name} kernel != plain")
    res = {"err": max(max_err(w, g) for w, g in zip(want, got))}
    if timed:
        run = lambda: K.transcript_round(field, pos, lo, hi, buf, partials)  # noqa: E731
        res["ms"] = cuda_ms(run, 50)  # back to back: the host wrapper's rate
        res["device_ms"] = device_ms(run, "transcript_round_kernel")
        res["plain_ms"] = cuda_ms(lambda: K.transcript_round_plain(field, pos, lo, hi, buf, partials), 3)
        # the partials read once, the sponge read and written, the outputs
        # written; a permutation of ~213 64-bit logic ops a round (two 32-bit
        # ops each) for every block the absorb fills, and one for the digest
        nbytes = partials.numel() * 8 + 2 * (2 * 25 + tdev.RATE) * 8 + (D + 3) * L * 4
        perms = (pos + (D + 1) * field.n_bytes) // tdev.RATE + 1
        res["bound"] = bound(nbytes, int_ops=perms * 24 * 213 * 2)
    return res


def phase_kernels() -> dict:
    """Every kernel against its plain version; returns the main-path-shape
    timings and the largest error per kernel."""
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    errs = {k: 0 for k in KERNEL_INFO}
    for field in (GOLDILOCKS, FR, BLS12_377_FR):
        for size in SIZES + (1 << MAIN_N,):
            for f in range(1, 5):
                errs["fold_multi"] = max(errs["fold_multi"], check_fold_multi(field, size, f, gen)["err"])
            torch.cuda.empty_cache()
        log(f"fold_multi == plain version (f = 1..4, fresh and in place): {field.name} at sizes "
            f"{SIZES + (1 << MAIN_N,)}")
    for field in (GOLDILOCKS, FR):
        for size in SIZES:
            for degree, k in ((1, 1), (2, 2), (3, 1)):
                errs["round_sums"] = max(errs["round_sums"], check_round_sums(field, size, degree, k, gen)["err"])
            errs["fold_halfsums"] = max(errs["fold_halfsums"], check_fold_halfsums(field, size, gen)["err"])
        log(f"kernels == plain versions: {field.name} at sizes {SIZES}")
    eb = elem_bytes(FR)
    for size in (SIZES[-1], 1 << MAIN_N):
        timed = {
            "fold_multi": check_fold_multi(FR, size, 4, gen, timed=True),
            "round_sums": check_round_sums(FR, size, 1, 1, gen, timed=True),
            "fold_halfsums": check_fold_halfsums(FR, size, gen, timed=True),
        }
        timed["fold_multi"]["bound"] = bound(size * eb + size // 16 * eb, size - size // 16)
        timed["round_sums"]["bound"] = bound(size * eb)
        timed["fold_halfsums"]["bound"] = bound(size * eb + size // 2 * eb, size // 2)
        for name, res in timed.items():
            log(f"  {name} BLS12-381 size=2^{size.bit_length() - 1}: kernel {res['ms']:.4f} ms, "
                f"plain {res['plain_ms']:.4f} ms, bound {res['bound'][0]:.4f} ms ({res['bound'][1]}), "
                f"max_abs_err {res['err']}")
            errs[name] = max(errs[name], res["err"])
    torch.cuda.empty_cache()
    timed["keccak_f1600"] = check_keccak(gen)
    errs["keccak_f1600"] = timed["keccak_f1600"]["err"]
    log(f"  keccak_f1600 one state: back-to-back calls {timed['keccak_f1600']['ms']:.4f} ms, kernel "
        f"{timed['keccak_f1600']['device_ms']:.4f} ms (profiler), plain {timed['keccak_f1600']['plain_ms']:.4f} ms")
    Ds, poss, Gs = TRANSCRIPT_GRID
    for field in (GOLDILOCKS, FR, BLS12_377_FR):
        for D in Ds:
            for pos in poss:
                for G in Gs:
                    res = check_transcript_round(field, D, pos, G, gen)
                    errs["transcript_round"] = max(errs["transcript_round"], res["err"])
        log(f"transcript_round == plain version (every output): {field.name} at D {Ds} x pos {poss} x G {Gs}")
    # the main path's first round: 2^24 BLS12-381, degree 1, pos 32 after
    # the claimed sum, round_sums' 1024 partials
    timed["transcript_round"] = res = check_transcript_round(FR, 1, 32, C.MAX_PARTIALS, gen, timed=True)
    log(f"  transcript_round BLS12-381 D=1 pos=32 G={C.MAX_PARTIALS}: back-to-back calls {res['ms']:.4f} ms, "
        f"kernel {res['device_ms']:.4f} ms (profiler), plain {res['plain_ms']:.4f} ms, "
        f"bound {res['bound'][0]:.6f} ms ({res['bound'][1]})")
    for name in timed:
        timed[name]["err"] = errs[name]
    return timed


def phase_gkr_kernels() -> dict:
    """fold and round_sums_terms against their plain versions at every
    listed size (exact); timed at GKR's first-round shape, 2^19 BLS12-381:
    fold of phase 2's K = 4 tables, round_sums_terms of (2, 2)."""
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    errs = {"fold": 0, "round_sums_terms": 0}
    for field in (GOLDILOCKS, FR):
        sizes = SIZES + ((1 << GKR_LOG,) if field is FR else ())
        for size in sizes:
            for k in range(1, C.FOLD_MAX_FACTORS + 1):
                errs["fold"] = max(errs["fold"], check_fold(field, size, k, gen)["err"])
        for log_n in range(4, GKR_LOG + 1):
            for _, ks in C.ROUND_SUMS_TERMS_SHAPES:
                res = check_round_sums_terms(field, 1 << log_n, ks, gen)
                errs["round_sums_terms"] = max(errs["round_sums_terms"], res["err"])
        log(f"GKR kernels == plain versions: {field.name}, fold at sizes {sizes}, round_sums_terms "
            f"{C.ROUND_SUMS_TERMS_SHAPES} at 2^4..2^{GKR_LOG}")
        torch.cuda.empty_cache()
    timed = {
        "fold": check_fold(FR, 1 << GKR_LOG, 4, gen, timed=True),
        "round_sums_terms": check_round_sums_terms(FR, 1 << GKR_LOG, (2, 2), gen, timed=True),
    }
    for name, res in timed.items():
        res["err"] = max(errs[name], res["err"])
        log(f"  {name} BLS12-381 size=2^{GKR_LOG}: kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, "
            f"bound {res['bound'][0]:.4f} ms ({res['bound'][1]}), max_abs_err {res['err']}")
    torch.cuda.empty_cache()
    return timed


def check_ntt_ladder(field, n_t, cols, batch, inverse, gen, timed=False):
    """One ntt_ladder pass on (L, n_t, cols) limbs: the last level (batch
    None) or an upper level of cols // batch twiddle rows."""
    x = rand_limbs(field, (field.n_limbs, n_t * cols), gen).reshape(field.n_limbs, n_t, cols)
    want = NTT.ntt_ladder_plain(field, x, inverse, batch=batch)
    got = NTT.ntt_ladder(field, x, inverse, batch=batch)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"ntt_ladder {field.name} n_t={n_t} cols={cols} batch={batch} inverse={inverse}: "
                             "kernel != plain")
    res = {"err": max_err(got, want)}
    if timed:
        res["ms"] = cuda_ms(lambda: NTT.ntt_ladder(field, x, inverse, batch=batch))
        res["plain_ms"] = cuda_ms(lambda: NTT.ntt_ladder_plain(field, x, inverse, batch=batch), 2)
        # columns in and out, the packed ladder twiddles, and at an upper
        # level the element-major twiddles (NW words an element); products:
        # every butterfly whose twiddle is not 1 (n_t - 1 of a column's
        # n_t/2 log2 n_t have twiddle 1), and one per element for the level
        # twiddle or the inverse's n_t^-1
        nbytes = (2 * cols + 1) * n_t * elem_bytes(field) + (n_t * cols * 2 * field.n_limbs if batch else 0)
        products = cols * ((n_t // 2) * (n_t.bit_length() - 1) - (n_t - 1))
        products += cols * n_t if batch or inverse else 0
        res["bound"] = bound(nbytes, products, field=field)
    return res


def check_elementwise(field, n, gen, timed=False, names=("mont_mul", "lerp")):
    """mont_mul and lerp at n elements; returns {name: result}."""
    L = field.n_limbs
    a, b = rand_limbs(field, (L, n), gen), rand_limbs(field, (L, n), gen)
    r = rand_limbs(field, (L, 1), gen)
    out = {}
    for name, kern, plain, args in (("mont_mul", FK.mont_mul, FK.mont_mul_plain, (a, b)),
                                     ("lerp", FK.lerp, FK.lerp_plain, (a, b, r))):
        if name not in names:
            continue
        want = plain(field, *args)
        got = kern(field, *args)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{name} {field.name} n={n}: kernel != plain")
        res = {"err": max_err(got, want)}
        if timed:
            res["ms"] = cuda_ms(lambda: kern(field, *args))
            res["plain_ms"] = cuda_ms(lambda: plain(field, *args), 2)
            res["bound"] = bound(3 * n * elem_bytes(field), n, field=field)
        out[name] = res
        del want, got
    return out


def phase_ntt_kernels() -> dict:
    """ntt_ladder, mont_mul and lerp against their plain versions at every
    listed shape (exact); timed at the NTT path's shapes: one ladder pass
    of the 2^20 transform (1024 rows of 1024), the 2^20 twiddle multiply,
    and lerp at the roofline's 2^23 (all BLS12-381 in the JSON line)."""
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    errs = {"ntt_ladder": 0, "mont_mul": 0, "lerp": 0}
    shapes = [(cols, None) for cols in (1, 3, 37, 1024)] + [(4 * b, b) for b in (1, 3, 1024)]
    for field in (GOLDILOCKS, FR, BLS12_377_FR):
        for n_t in (2, 16, NTT.LADDER_MAX):
            for cols, batch in shapes:
                for inverse in (False, True):
                    res = check_ntt_ladder(field, n_t, cols, batch, inverse, gen)
                    errs["ntt_ladder"] = max(errs["ntt_ladder"], res["err"])
        for log_n in (4, 12, NTT_LOG):
            for name, res in check_elementwise(field, 1 << log_n, gen).items():
                errs[name] = max(errs[name], res["err"])
        log(f"NTT kernels == plain versions: {field.name} (ntt_ladder n_t 2/16/{NTT.LADDER_MAX} x last level on "
            f"1/3/37/1024 columns, upper level at batches 1/3/1024, fwd+inv; mont_mul, lerp at 2^4/2^12/2^{NTT_LOG})")
    cols = (1 << NTT_LOG) // NTT.LADDER_MAX
    timed = {}
    for field in (GOLDILOCKS, FR):
        last = check_ntt_ladder(field, NTT.LADDER_MAX, cols, None, False, gen, timed=True)
        ladder = check_ntt_ladder(field, NTT.LADDER_MAX, cols, 1, False, gen, timed=True)
        elem = check_elementwise(field, 1 << NTT_LOG, gen, timed=True)
        for name, res in (("ntt_ladder upper level", ladder), ("ntt_ladder last level", last),
                          ("mont_mul", elem["mont_mul"])):
            log(f"  {name} {field.name} 2^{NTT_LOG} elements: kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, "
                f"bound {res['bound'][0]:.4f} ms ({res['bound'][1]}), max_abs_err {res['err']}")
        ladder["last_level"] = {"last_level_ms": last["ms"], "last_level_bound_ms": last["bound"][0]}
        timed["ntt_ladder"], timed["mont_mul"] = ladder, elem["mont_mul"]
    timed["lerp"] = check_elementwise(FR, 1 << LERP_LOG, gen, timed=True, names=("lerp",))["lerp"]
    res = timed["lerp"]
    log(f"  lerp BLS12-381 2^{LERP_LOG}: kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, "
        f"bound {res['bound'][0]:.4f} ms ({res['bound'][1]}), max_abs_err {res['err']}")
    for name in timed:
        timed[name]["err"] = max(errs[name], timed[name]["err"])
    torch.cuda.empty_cache()
    return timed


def phase_roofline(reps: int = 12) -> dict:
    """benches/roofline.py's HBM reading on the card: chained lerp folds of
    2^23 BLS12-381 pairs through fields.kernels.lerp, one kernel each;
    returns lerp's launches."""
    gen = torch.Generator(device=DEVICE).manual_seed(23)
    L, n = FR.n_limbs, 1 << LERP_LOG
    right = rand_limbs(FR, (L, n), gen)
    state = [rand_limbs(FR, (L, n), gen)]
    r = dev.scalar(FR, 123456789, device=DEVICE)

    def fold():
        state[0] = FK.lerp(FR, state[0], right, r)

    torch.cuda.synchronize()
    _cuda.reset_launches()
    ms = cuda_ms(fold, reps)
    counts = _cuda.launches()
    nbytes = 3 * n * elem_bytes(FR)
    log(f"lerp roofline 2^{LERP_LOG} BLS12-381 (chained folds): {ms:.4f} ms per fold, "
        f"{nbytes / ms / 1e9:.4f} TB/s = {nbytes / ms / 1e-3 / HBM_BYTES_PER_S:.2%} of 3.35 TB/s; "
        f"lerp launches {counts['lerp']}")
    if counts["lerp"] == 0:
        raise AssertionError("the roofline phase never launched lerp")
    del state, right
    torch.cuda.empty_cache()
    return counts


def random_circuit(rng, depth, width, n_inputs) -> Circuit:
    """tests/test_gkr.py's seeded layered circuit."""
    layers, below = [], n_inputs
    for d in range(depth):
        size = width if d < depth - 1 else max(1, width // 2)
        layers.append([
            Gate("add" if rng.random() < 0.5 else "mul", rng.randrange(below), rng.randrange(below))
            for _ in range(size)
        ])
        below = size
    layers.reverse()
    return Circuit(layers=layers, n_inputs=n_inputs)


def phase_gkr_differential() -> None:
    rng = random.Random(5)
    c = random_circuit(rng, 3, 256, 256)
    inputs = [rng.randrange(FR.p) for _ in range(256)]
    chain, _ = GKRProver.prove(FR, c, inputs)
    synced, _ = GKRProver.prove(FR, c, inputs, device_transcript=False)
    dense, _ = GKRProver.prove_dense(FR, c, inputs)
    if not chain == synced == dense:
        raise AssertionError("GKR tier differential FAILED (depth 3, width 256)")
    if not GKRVerifier.verify(FR, c, inputs, chain):
        raise AssertionError("GKR verifier rejected an honest proof (depth 3, width 256)")
    log("GKR tier differential depth 3 width 256: chain == synced per-phase == dense proofs; verified")
    rng = random.Random(7)
    c = random_circuit(rng, 3, 8, 8)
    inputs = [rng.randrange(FR.p) for _ in range(8)]
    with open(GOLDEN_GKR, "rb") as f:
        golden = f.read()
    if gkr_proof_to_bytes(FR, prove_chain(FR, c, inputs)[0]) != golden:
        raise AssertionError("GKR d3w8 proof on the card != tests/goldens/gkr_d3w8_prove.bin")
    log("GKR d3w8 proof on the card == tests/goldens/gkr_d3w8_prove.bin")


def bench_gkr_circuit(width_log: int, depth: int = 2) -> Circuit:
    """bench.py bench_gkr's circuit: per layer left = a, right = (5a + 3 + i)
    mod 2^w, odd gates add."""
    W = 1 << width_log
    a = np.arange(W, dtype=np.int32)
    layers = [(a, (a * 5 + 3 + i) % W, (a & 1).astype(bool)) for i in range(depth)]
    return Circuit.from_arrays(layers, W)


def phase_gkr_main(reps: int = 5) -> dict:
    """The GKR main path at full width; returns its launch counts."""
    c = bench_gkr_circuit(GKR_LOG)
    W = 1 << GKR_LOG
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    inputs = torch.randint(0, 1 << 16, (FR.n_limbs, W), generator=gen, device=DEVICE, dtype=torch.int32)
    inputs[FR.n_limbs - 1] &= 0x1FFF
    rounds = sum(2 * c.layer_k(i + 1) for i in range(c.depth))
    torch.cuda.synchronize()

    _cuda.reset_launches()
    t0 = time.perf_counter()
    proof, _ = GKRProver.prove(FR, c, inputs)
    cold = time.perf_counter() - t0
    counts = _cuda.launches()
    proofs = []
    warm = timed_runs(lambda: proofs.append(GKRProver.prove(FR, c, inputs)[0]), reps)
    if any(p != proof for p in proofs):
        raise AssertionError("GKR prove is not deterministic")
    one = launches_of(lambda: GKRProver.prove(FR, c, inputs))
    assert_one_transcript_round(one, rounds, "a warm GKR chain prove", keccak=True)
    log(f"GKR {c.depth} x 2^{GKR_LOG} BLS12-381 prove (device chain, {rounds} transcript rounds): "
        f"cold {cold:.6f} s; warm {spread(warm)}")
    log(f"GKR path kernel launches (cold prove): {counts}; one warm prove: {one}")
    missing = [k for k in GKR_KERNELS if counts[k] == 0]
    if missing:
        raise AssertionError(f"GKR path never launched {missing}")

    synced_runs = []
    synced = timed_runs(lambda: synced_runs.append(GKRProver.prove(FR, c, inputs, device_transcript=False)[0]), 2)
    if any(p != proof for p in synced_runs):
        raise AssertionError("GKR synced per-phase prove differs from the device chain")
    log(f"GKR synced per-phase prove identical; {spread(synced)}")

    def verify():
        if not GKRVerifier.verify(FR, c, inputs, proof):
            raise AssertionError("GKR verifier rejected the honest 2 x 2^19 proof")

    vcold = timed_runs(verify, 1)[0]
    vwarm = timed_runs(verify, 3)
    log(f"GKR verify: cold {vcold:.6f} s; warm {spread(vwarm)}")
    lp = proof.layer_proofs[0]
    bad_lp = type(lp)(sumcheck=lp.sumcheck, w_b=(lp.w_b + 1) % FR.p, w_c=lp.w_c, q_evals=lp.q_evals)
    bad = GKRProof(outputs=proof.outputs, layer_proofs=[bad_lp] + proof.layer_proofs[1:])
    try:
        accepted = GKRVerifier.verify(FR, c, inputs, bad)
    except (GKRError, SumcheckError):
        accepted = False
    if accepted:
        raise AssertionError("GKR verifier accepted a proof with a flipped w_b")
    log(f"GKR proof with a flipped w_b rejected; proof {len(gkr_proof_to_bytes(FR, proof))} bytes")
    torch.cuda.empty_cache()
    return counts


@contextlib.contextmanager
def plain_route():
    """The NTT's recursion with the plain versions in place of its two
    kernels (on CUDA tensors the wrappers would launch them)."""
    saved = NTT.ntt_ladder, NTT.mont_mul
    NTT.ntt_ladder, NTT.mont_mul = NTT.ntt_ladder_plain, FK.mont_mul_plain
    try:
        yield
    finally:
        NTT.ntt_ladder, NTT.mont_mul = saved


def dft_at(field, vals: list[int], k: int) -> int:
    """Output k of the DFT of vals, from its definition (Horner in w^k)."""
    w = pow(field.get_root_of_unity(len(vals)), k, field.p)
    acc = 0
    for v in reversed(vals):
        acc = (acc * w + v) % field.p
    return acc


def ntt_roundtrip(field, data, name: str, reps: int) -> None:
    """Cold and warm roundtrips (each ending in a readback), exact
    roundtrip, forward spot checks, kernel route == plain route."""
    n = data.shape[1]

    def roundtrip():
        return NTT.intt_device(field, NTT.ntt_device(field, data))[:1, :1].cpu()

    cold = timed_runs(roundtrip, 1)[0]
    warm = timed_runs(roundtrip, reps)
    log(f"ntt+intt roundtrip 2^{n.bit_length() - 1} {name}: cold {cold:.6f} s; warm {spread(warm)}")
    before = _cuda.launches()
    NTT.ntt_device(field, data)
    one = {k: v - before[k] for k, v in _cuda.launches().items() if v != before[k]}
    if one != {"ntt_ladder": 2}:
        raise AssertionError(f"{name}: a warm 2^{n.bit_length() - 1} transform launched {one}, not two ntt_ladder passes")
    fwd = NTT.ntt_device(field, data)
    if not torch.equal(NTT.intt_device(field, fwd), data):
        raise AssertionError(f"{name}: intt(ntt(x)) != x at 2^{n.bit_length() - 1}")
    vals = dev.decode_ints(field, data)
    ks = (0, 1, 5, n - 1)
    got = dev.decode_ints(field, fwd[:, list(ks)])
    if got != [dft_at(field, vals, k) for k in ks]:
        raise AssertionError(f"{name}: forward outputs at k = {ks} differ from the DFT definition")
    with plain_route():
        plain = NTT.ntt_device(field, data)
    if not torch.equal(plain, fwd):
        raise AssertionError(f"{name}: kernel route != plain route at 2^{n.bit_length() - 1}")
    log(f"  {name}: a warm transform is two ntt_ladder launches; intt(ntt(x)) == x; outputs at k = {ks} == "
        "DFT definition; kernel route == plain route")


def phase_ntt_main(reps: int = 5) -> dict:
    """The NTT path at BASELINE config 2's size; returns its launch counts."""
    n = 1 << NTT_LOG
    g = GOLDILOCKS
    gold = dev.encode_ints(g, [(i * 0x12345 + 7) % g.p for i in range(n)], device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(13)
    bls = rand_limbs(FR, (FR.n_limbs, n), gen)
    torch.cuda.synchronize()

    _cuda.reset_launches()
    ntt_roundtrip(g, gold, "Goldilocks (bench_ntt inputs)", reps)
    ntt_roundtrip(FR, bls, "BLS12-381 Fr (random limbs)", reps)
    rng = random.Random(17)
    a = UnivariatePolynomial(FR, [rng.randrange(FR.p) for _ in range(1 << 15)])
    b = UnivariatePolynomial(FR, [rng.randrange(FR.p) for _ in range(1 << 15)])
    t0 = time.perf_counter()
    prod = a * b
    t_mul = time.perf_counter() - t0
    x = rng.randrange(FR.p)
    if prod.degree() != (1 << 16) - 2 or prod.evaluate(x) != a.evaluate(x) * b.evaluate(x) % FR.p:
        raise AssertionError("UnivariatePolynomial NTT product of degree-2^15 - 1 polynomials is wrong at a random point")
    small_a = UnivariatePolynomial(FR, [rng.randrange(FR.p) for _ in range(150)])
    small_b = UnivariatePolynomial(FR, [rng.randrange(FR.p) for _ in range(151)])
    if small_a * small_b != small_a._mul_schoolbook(small_b):
        raise AssertionError("UnivariatePolynomial NTT product of 300 coefficients != schoolbook")
    counts = _cuda.launches()
    log(f"UnivariatePolynomial BLS12-381 2^15 x 2^15 coefficients (NTT route, 2^16 transforms): {t_mul:.6f} s; "
        f"== a(x) b(x) at a random point; 300-coefficient product == schoolbook")
    log(f"NTT path kernel launches: {counts}")
    missing = [k for k in NTT_KERNELS if counts[k] == 0]
    if missing:
        raise AssertionError(f"NTT path never launched {missing}")
    torch.cuda.empty_cache()
    return counts


def launches_of(fn) -> dict[str, int]:
    """The kernel launches fn() makes (kernels it launches at least once)."""
    before = _cuda.launches()
    fn()
    return {k: v - before[k] for k, v in _cuda.launches().items() if v != before[k]}


def assert_one_transcript_round(one: dict[str, int], rounds: int, what: str, keccak: bool) -> None:
    """A device round is one transcript_round launch; the sumcheck rounds'
    Fiat-Shamir steps never launch keccak_f1600 (``keccak``: whether the
    path permutes outside its rounds, as GKR's claim binds and line steps do)."""
    if one.get("transcript_round", 0) != rounds:
        raise AssertionError(f"{what} launched {one}: want exactly one transcript_round a device round ({rounds})")
    if bool(one.get("keccak_f1600", 0)) != keccak:
        raise AssertionError(f"{what} launched {one}: the sumcheck rounds run their Fiat-Shamir step in "
                             "transcript_round and may no longer launch keccak_f1600"
                             + ("; GKR's binds and line steps must" if keccak else ""))


def phase_tier_differential() -> None:
    gen = torch.Generator(device=DEVICE).manual_seed(14)
    poly = ProductPoly([MLE(FR, 14, rand_limbs(FR, (FR.n_limbs, 1 << 14), gen))])
    total = dev.decode_ints(FR, dev.sum_mod(FR, poly.polynomials[0].data).reshape(-1, 1))[0]
    out = []
    one = launches_of(lambda: out.append(SumcheckProver.prove_partial(poly, total, max_var_degree=1)))
    assert_one_transcript_round(one, 14, "a 2^14 device-transcript prove", keccak=False)
    device_tr = out[0]
    synced = SumcheckProver.prove_partial(poly, total, max_var_degree=1, device_transcript=False)
    host = SumcheckProver.prove_partial(
        poly, total, max_var_degree=1, tail_size=1 << 30, device_transcript=False
    )
    if not device_tr == synced == host:
        raise AssertionError("tier differential FAILED at n=14")
    log("tier differential n=14: device-transcript == synced-kernel == host-int proofs")


def main_table(n: int, seed: int = 7) -> MLE:
    """bench.py's table: random 16-bit limbs, top limb masked to 0x1FFF."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
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
    rate = ((1 << n) - 1) / statistics.median(evals)  # one product an index pair of the shrinking fold
    log(f"MLE.evaluate 2^{n}: cold {eval_cold:.6f} s; warm {spread(evals)} "
        f"-> {rate:.6e} field-mults/s at the median")

    t0 = time.perf_counter()
    proof, challenges = SumcheckProver.prove_partial(pp, total, max_var_degree=1)
    prove_cold = time.perf_counter() - t0
    proofs = []
    proves = timed_runs(lambda: proofs.append(SumcheckProver.prove_partial(pp, total, max_var_degree=1)), reps)
    if any(p != (proof, challenges) for p in proofs):
        raise AssertionError("prove_partial is not deterministic")
    log(f"prove_partial 2^{n}: cold {prove_cold:.6f} s; warm {spread(proves)}")
    one = launches_of(lambda: SumcheckProver.prove_partial(pp, total, max_var_degree=1))
    assert_one_transcript_round(one, n, f"a warm 2^{n} prove_partial", keccak=False)
    if one != {"round_sums": 1, "transcript_round": n, "fold_halfsums": n - 1}:
        raise AssertionError(f"a warm 2^{n} prove_partial launched {one}: want 1 round_sums, {n} transcript_round "
                             f"and {n - 1} fold_halfsums")
    log(f"one warm prove_partial 2^{n} launched {one}")

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

    other = main_table(n, seed=8)
    pp2 = ProductPoly([poly, other])
    total2 = dev.decode_ints(FR, dev.sum_mod(FR, FK.mont_mul(FR, poly.data, other.data)))[0]
    got = []
    one = launches_of(lambda: got.append(SumcheckProver.prove_partial(pp2, total2, max_var_degree=2)))
    if one != {"round_sums": n, "fold": n - 1, "transcript_round": n}:
        raise AssertionError(f"a 2^{n} two-factor degree-2 prove launched {one}: want {n} round_sums, {n - 1} fold "
                             f"and {n} transcript_round")
    if SumcheckProver.prove_partial(pp2, total2, max_var_degree=2, device_transcript=False) != got[0]:
        raise AssertionError(f"two-factor degree-2 prove at 2^{n}: the synced tier differs from the device transcript")
    log(f"two-factor degree-2 prove_partial 2^{n}: device transcript == synced tier; launched {one}")
    del other, pp2
    counts = _cuda.launches()
    log(f"main-path kernel launches: {counts}")
    missing = [k for k in SUMCHECK_KERNELS if counts[k] == 0]
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


# --------------------------------------------------------------------------
# the sharded paths (zk_tpu_torch.parallel, GKRProver.prove(mesh=))
# --------------------------------------------------------------------------


def gkr_inputs(seed: int = 11) -> torch.Tensor:
    """phase_gkr_main's witness: random limbs, top limb masked to 0x1FFF."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    inputs = torch.randint(0, 1 << 16, (FR.n_limbs, 1 << GKR_LOG), generator=gen, device=DEVICE, dtype=torch.int32)
    inputs[FR.n_limbs - 1] &= 0x1FFF
    return inputs


def collectives_of(fn) -> tuple[dict[str, int], dict[str, int]]:
    """(kernel launches, collectives) that fn() makes."""
    before = par.collectives()
    one = launches_of(fn)
    return one, {k: v - before[k] for k, v in par.collectives().items()}


def in_turns(fns: dict, reps: int) -> dict[str, list[float]]:
    """Wall seconds of each fn, called in turns (order reversed every rep)."""
    out = {k: [] for k in fns}
    for i in range(reps):
        for k in (list(fns) if i % 2 == 0 else list(fns)[::-1]):
            out[k] += timed_runs(fns[k], 1)
    return out


def sharded_sumcheck(mesh, n: int, reps: int):
    """The 2^n BLS12-381 table (seed 7) through ShardedSumcheckProver: the
    round polys, challenges and proof bytes equal SumcheckProver's; warm
    medians in turns; a device round's launches and collectives.  Returns
    (proof bytes, {"sharded": [s], "single": [s]}, one sharded prove's
    launches)."""
    poly = main_table(n)
    pp = ProductPoly([poly])
    total = dev.decode_ints(FR, dev.sum_mod(FR, poly.data).reshape(-1, 1))[0]

    def sharded():
        return par.ShardedSumcheckProver.prove_partial(mesh, pp, total, max_var_degree=1)

    single = SumcheckProver.prove_partial(pp, total, max_var_degree=1)
    got = sharded()
    if got != single or proof_to_bytes(FR, got[0]) != proof_to_bytes(FR, single[0]):
        raise AssertionError(f"sharded 2^{n} prove_partial on {par.MeshGroup(mesh).size} rank(s) != SumcheckProver's")
    one, coll = collectives_of(sharded)
    D = par.MeshGroup(mesh).size
    s = chain_rounds((1 << n) // D, 2, n)  # rounds on the shards (the card's tail rule), then one gather
    # the shards' rounds end in one fold_multi; the gathered table's rounds end unfolded
    want_one = {"transcript_round": n, "round_sums": 2, "fold_halfsums": n - 2, "fold_multi": 1}
    want_coll = {"all_reduce": s, "all_gather": 1, "all_to_all": 0}
    if one != want_one or coll != want_coll:
        raise AssertionError(f"a sharded 2^{n} prove launched {one} and {coll}: want one transcript_round a "
                             f"device round, one all_reduce and one table kernel a sharded round ({want_one}, {want_coll})")
    fns = {"sharded": sharded}
    if D == 1:
        fns["single"] = lambda: SumcheckProver.prove_partial(pp, total, max_var_degree=1)
    times = in_turns(fns, reps)
    log(f"sharded prove_partial 2^{n} on {D} rank(s) == SumcheckProver's (round polys, challenges, bytes); "
        + "; ".join(f"{k} {spread(v)}" for k, v in times.items()))
    log(f"  one sharded prove: {one}; collectives {coll} ({s} rounds on the shards, {n - s} after the gather)")
    return proof_to_bytes(FR, got[0]), times, one


def sharded_gkr(mesh, reps: int):
    """bench_gkr's 2 x 2^19 BLS12-381 circuit with a mesh: the bytes of the
    device chain's proof; verified; warm medians in turns.  Returns (proof
    bytes, times, one prove's launches)."""
    c = bench_gkr_circuit(GKR_LOG)
    inputs = gkr_inputs()
    chain_bytes = gkr_proof_to_bytes(FR, GKRProver.prove(FR, c, inputs)[0])
    proof, _ = GKRProver.prove(FR, c, inputs, mesh=mesh)
    if gkr_proof_to_bytes(FR, proof) != chain_bytes:
        raise AssertionError("GKR prove with a mesh != the device chain's proof")
    D = par.MeshGroup(mesh).size
    one, coll = collectives_of(lambda: GKRProver.prove(FR, c, inputs, mesh=mesh))
    rounds = sum(2 * c.layer_k(i + 1) for i in range(c.depth))
    shard_rounds = sum(2 * chain_rounds((1 << c.layer_k(i + 1)) // D, 2, c.layer_k(i + 1)) for i in range(c.depth))
    want = {"all_reduce": shard_rounds, "all_gather": 2 * c.depth + c.depth, "all_to_all": 0}
    if one.get("transcript_round") != rounds or one.get("keccak_f1600", 0) or coll != want:
        raise AssertionError(f"a GKR prove with a mesh launched {one}, {coll}: want {rounds} transcript_round, "
                             f"no keccak_f1600, {want}")
    fns = {"mesh": lambda: GKRProver.prove(FR, c, inputs, mesh=mesh)}
    if D == 1:
        fns["chain"] = lambda: GKRProver.prove(FR, c, inputs)
    times = in_turns(fns, reps)
    if not GKRVerifier.verify(FR, c, inputs, proof):
        raise AssertionError("GKR verifier rejected the proof made with a mesh")
    log(f"GKR {c.depth} x 2^{GKR_LOG} BLS12-381 prove with a mesh of {D} == the device chain's bytes; verified; "
        + "; ".join(f"{k} {spread(v)}" for k, v in times.items()))
    log(f"  one GKR prove with a mesh: {one}; collectives {coll}")
    return chain_bytes, times, one


def sharded_ntt(mesh, reps: int) -> list[dict[str, int]]:
    """The sharded 2^20 NTT in Goldilocks (bench_ntt's inputs) and
    BLS12-381: equal to ntt_device, inverted, timed in turns.  Returns one
    forward transform's launches per field."""
    n = 1 << NTT_LOG
    ones = []
    g = GOLDILOCKS
    gen = torch.Generator(device=DEVICE).manual_seed(13)
    for field, data in ((g, dev.encode_ints(g, [(i * 0x12345 + 7) % g.p for i in range(n)], device=DEVICE)),
                        (FR, rand_limbs(FR, (FR.n_limbs, n), gen))):
        fwd = par.gather_natural(mesh, field, par.ntt_sharded(mesh, field, data))
        if not torch.equal(fwd, NTT.ntt_device(field, data)):
            raise AssertionError(f"{field.name}: sharded 2^{NTT_LOG} NTT != ntt_device")
        back = par.gather_natural(mesh, field, par.ntt_sharded(mesh, field, fwd, inverse=True))
        if not torch.equal(back, data):
            raise AssertionError(f"{field.name}: sharded inverse NTT does not return the input")
        one, coll = collectives_of(lambda: par.ntt_sharded(mesh, field, data))
        times = in_turns({"sharded": lambda: par.ntt_sharded(mesh, field, data)[:1, :1, :1].cpu(),
                          "ntt_device": lambda: NTT.ntt_device(field, data)[:1, :1].cpu()}, reps)
        log(f"sharded NTT 2^{NTT_LOG} {field.name} == ntt_device; inverse returns the input; "
            + "; ".join(f"{k} {spread(v)}" for k, v in times.items()) + f"; one transform {one}, {coll}")
        ones.append(one)
    return ones


def sharded_2pow26(mesh) -> None:
    """One 2^26 BLS12-381 prove (a 4 GiB table) on the mesh, equal to the
    single-device proof, its subclaim checked against the table."""
    n = 26
    poly = main_table(n)
    pp = ProductPoly([poly])
    total = dev.decode_ints(FR, dev.sum_mod(FR, poly.data).reshape(-1, 1))[0]
    t0 = time.perf_counter()
    proof, challenges = par.ShardedSumcheckProver.prove_partial(mesh, pp, total, max_var_degree=1)
    t_sharded = time.perf_counter() - t0
    t0 = time.perf_counter()
    single = SumcheckProver.prove_partial(pp, total, max_var_degree=1)
    t_single = time.perf_counter() - t0
    if (proof, challenges) != single:
        raise AssertionError("sharded 2^26 prove != SumcheckProver's")
    sub = SumcheckVerifier.verify_partial(FR, proof)
    if sub.challenges != challenges or poly.evaluate(challenges) != sub.sum:
        raise AssertionError("sharded 2^26 prove: the subclaim does not hold")
    log(f"sharded prove_partial 2^26 BLS12-381 (4 GiB table): first call {t_sharded:.6f} s, single-device "
        f"first call {t_single:.6f} s; == SumcheckProver's; subclaim checked; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del poly, pp
    torch.cuda.empty_cache()


def sharded_rank(rank: int, init_file: str, out_path: str) -> None:
    """One rank of the world-size-2 gloo run on the one card: the 2^24
    prove and the GKR prove with the mesh, each held against its
    single-device proof in the rank; the digests go to out_path."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=2)
    try:
        mesh = par.make_mesh()
        sc_bytes, sc_times, _ = sharded_sumcheck(mesh, MAIN_N, 3)
        torch.cuda.empty_cache()
        gkr_bytes, gkr_times, _ = sharded_gkr(mesh, 2)
        with open(out_path, "w") as f:
            json.dump({"sumcheck": hashlib.sha256(sc_bytes).hexdigest(), "sumcheck_times": sc_times,
                       "gkr": hashlib.sha256(gkr_bytes).hexdigest(), "gkr_times": gkr_times}, f)
    finally:
        dist.destroy_process_group()


def phase_sharded(reps: int = 3) -> dict:
    """The sharded paths at full width; returns their kernel launches at
    world size 1: one sharded prove, one GKR prove with the mesh and one
    forward sharded transform a field (the runs that compare them with
    the single-device paths and time them are not counted)."""
    import tempfile

    import torch.distributed as dist

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/init", rank=0, world_size=1)
        try:
            mesh = par.make_mesh()
            sc_bytes, _, sc_one = sharded_sumcheck(mesh, MAIN_N, reps)
            torch.cuda.empty_cache()
            gkr_bytes, _, gkr_one = sharded_gkr(mesh, reps)
            torch.cuda.empty_cache()
            counts = dict.fromkeys(_cuda.KERNELS, 0)
            for one in [sc_one, gkr_one] + sharded_ntt(mesh, reps):
                for k, v in one.items():
                    counts[k] += v
            log(f"sharded paths (world size 1, NCCL) kernel launches: {counts}")
            missing = [k for k in SHARDED_KERNELS if counts[k] == 0]
            if missing:
                raise AssertionError(f"the sharded paths never launched {missing}")
            torch.cuda.reset_peak_memory_stats()
            sharded_2pow26(mesh)
        finally:
            dist.destroy_process_group()
    phase_sharded_gloo(hashlib.sha256(sc_bytes).hexdigest(), hashlib.sha256(gkr_bytes).hexdigest())
    return counts


def phase_sharded_gloo(want_sc: str, want_gkr: str) -> None:
    """World size 2 over gloo on the one card: two ranks, each proving the
    2^24 table and the GKR circuit through the mesh; both exit 0 and give
    the single-device bytes, or the phase fails."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(2)]
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--sharded-rank", str(r),
                                   os.path.join(tmp, "init"), outs[r]], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True) for r in range(2)]
        try:
            logs = [p.communicate(timeout=600)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, out) in enumerate(zip(procs, logs)):
            log(f"  gloo rank {r} (exit {p.returncode}): " + " | ".join(out.strip().splitlines()[-6:]))
        if any(p.returncode != 0 for p in procs):
            raise AssertionError(f"the world-size-2 gloo run failed: exit codes {[p.returncode for p in procs]}")
        got = []
        for out in outs:
            with open(out) as f:
                got.append(json.load(f))
    if any((g["sumcheck"], g["gkr"]) != (want_sc, want_gkr) for g in got):
        raise AssertionError("world-size-2 gloo proofs differ from the single-device proofs")
    log(f"world size 2 over gloo on one card: both ranks' 2^{MAIN_N} sumcheck and GKR proofs == the single-device "
        f"proofs; rank 0 sumcheck {spread(got[0]['sumcheck_times']['sharded'])}; GKR "
        f"{spread(got[0]['gkr_times']['mesh'])}")


def main() -> int:
    if sys.argv[1:2] == ["--sharded-rank"]:
        sharded_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4])
        return 0
    name = phase_device()
    timed = phase_kernels()
    timed.update(phase_gkr_kernels())
    timed.update(phase_ntt_kernels())
    roofline_counts = phase_roofline()
    phase_tier_differential()
    phase_gkr_differential()
    counts = phase_main_path()
    gkr_counts = phase_gkr_main()
    ntt_counts = phase_ntt_main()
    sharded_counts = phase_sharded()
    kernels = []
    for kname, (source, replaces) in KERNEL_INFO.items():
        res = timed[kname]
        path_counts = (counts if kname in SUMCHECK_KERNELS else gkr_counts if kname in GKR_KERNELS
                       else ntt_counts if kname in NTT_KERNELS else roofline_counts)
        kernels.append({
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": path_counts[kname], "sharded_launches": sharded_counts[kname], "max_abs_err": res["err"],
            "ms": res["ms"], "plain_ms": res["plain_ms"],
            "bound_ms": res["bound"][0], "bound_by": res["bound"][1],
            # no single PyTorch call folds, sums or multiplies Montgomery limbs,
            # and torch.fft is complex floating point, not a finite-field DFT
            "library_ms": None,
            **res.get("last_level", {}),  # ntt_ladder: the 2^20 transform's other level
            # transcript_round, keccak_f1600: the profiler's device time of
            # the kernel alone, shorter than its wrapper's ms
            **({"device_ms": res["device_ms"]} if "device_ms" in res else {}),
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
