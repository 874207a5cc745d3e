"""What holds ntt_ladder back, on one NVIDIA GPU.

Run from the repository root on a card:

    python3 scripts/probe_ntt_ladder.py [--parent DIR]

For both levels of the 2^20 BLS12-381 transform (the upper level, 1024
columns with the twiddles and the transposed store, and the last level,
1024 columns in natural order), it times csrc/ntt.cu built four ways from
copies of the source, each with CUDA events in turns on one card:

  * ``shipped``: the kernel as it is;
  * ``memory``: the ladder and the products taken out, so only the loads,
    the shared-memory round trip and the stores are left;
  * ``compute``: the global loads replaced by values made from the slot
    index and the stores kept behind a test the data never passes, so
    only the ladder and the level's products are left;
  * ``2blk``: two 256-thread blocks per SM on tiles of 2 columns instead
    of one 512-thread block on 4 columns.

Beside each it prints the kernel's registers and its blocks per SM from
the CUDA runtime (cudaFuncGetAttributes, the occupancy API), and the
Montgomery products and bytes of the level.  Then a fixed-products
microbenchmark gives the card's Montgomery product rate (field.cuh's
``mont_mul`` at BLS12-381's 8 words) at 8, 16 and 32 warps per SM with 1,
2 and 4 independent products in flight per thread.  With ``--parent`` it
also times that checkout's ``ntt_ladder`` on (L, 1024, 1024) limbs in the
same call (PR 3's kernel, one row of 1024 a block along the last axis).

Variant sources are built under zk_tpu_torch/_build/probe/ (gitignored)
by scripts/_probe.py, one nvcc process each, all started together.  The card's name and power
limit come first, as nvidia-smi reports them.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from _probe import build, card_line, patch  # noqa: E402
from chip_smoke import bound, cuda_ms, elem_bytes, rand_limbs  # noqa: E402
from zk_tpu_torch import _cuda  # noqa: E402
from zk_tpu_torch.fields import BLS12_381_FR as FR  # noqa: E402
from zk_tpu_torch.fields.kernels import field_params  # noqa: E402

NTT = importlib.import_module("zk_tpu_torch.ntt")
PROBE_DIR = _cuda.BUILD_DIR / "probe"

LADDER = (
    "    if (log_t1 & 1) {\n"
    "      radix2_first<NW>(sm, plane, t1, log_cols, fp);\n"
    "      __syncthreads();\n"
    "    }\n"
    "    // one call site: the radix-4 body is inlined once\n"
    "    for (int st = (log_t1 & 1) + 1; st < log_t1; st += 2) {\n"
    "      radix4<NW>(sm, plane, tws, t1, log_cols, st - 1, fp);\n"
    "      __syncthreads();\n"
    "    }\n"
)
LEVEL_PRODUCT = "        mont_mul<NW>(x, x, w, fp);\n"
LOAD = "        for (int w = 0; w < NW; ++w) x[w] = src[(2 * w) * limb_stride] | (src[(2 * w + 1) * limb_stride] << 16);\n"
COL_TW = "          load_words<NW>(w, col_tw + (i2 * t1 + k1) * NW);\n"
STORE = "      uint32_t* dst = out + (i2 * t1 + k1) * B + b;\n"
THREADS = "  return NW >= 8 ? 512 : 1024;\n"

# appended to every variant: the kernel's registers and blocks per SM
REPORT = r"""
extern "C" int probe_report(int L, size_t smem, int* regs, int* per_sm, int* threads) {
  cudaFuncAttributes a;
  int err;
  if (L == 16) {
    *threads = ntt_threads<8>();
    err = (int)cudaFuncGetAttributes(&a, ntt_ladder_kernel<8>);
    if (!err) err = (int)cudaFuncSetAttribute(ntt_ladder_kernel<8>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (!err) err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, ntt_ladder_kernel<8>, *threads, smem);
  } else {
    *threads = ntt_threads<2>();
    err = (int)cudaFuncGetAttributes(&a, ntt_ladder_kernel<2>);
    if (!err) err = (int)cudaFuncSetAttribute(ntt_ladder_kernel<2>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (!err) err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, ntt_ladder_kernel<2>, *threads, smem);
  }
  *regs = a.numRegs;
  return err;
}
"""

# the fixed-products microbenchmark: CHAINS independent products a thread
RATE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#include "field.cuh"

template <int NW, int CHAINS>
__global__ void __launch_bounds__(256) rate_kernel(uint32_t* out, int iters, FieldParams<NW> fp) {
  uint32_t a[CHAINS][NW], b[NW];
  const uint32_t seed = blockIdx.x * blockDim.x + threadIdx.x;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    b[w] = (seed * 0x9E3779B9u + w) & 0x0FFFFFFFu;
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) a[c][w] = (seed * 0x85EBCA6Bu + 31 * c + w) & 0x0FFFFFFFu;
  }
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) mont_mul<NW>(a[c], a[c], b, fp);
  }
  uint32_t x = 0;
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) x ^= a[c][0];
  if (x == 0x12345678u) out[seed] = x;  // keeps the products; never taken
}

template <int CHAINS>
int rate_launch(int blocks_per_sm, int iters, const uint32_t* params, uint32_t* out, int* per_sm, int* regs) {
  int sms = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaFuncAttributes a;
  cudaFuncGetAttributes(&a, rate_kernel<8, CHAINS>);
  *regs = a.numRegs;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, rate_kernel<8, CHAINS>, 256, 0);
  rate_kernel<8, CHAINS><<<sms * blocks_per_sm, 256>>>(out, iters, load_params<8>(params));
  return (int)cudaGetLastError();
}

extern "C" int probe_rate(int chains, int blocks_per_sm, int iters, const uint32_t* params, uint32_t* out,
                          int* per_sm, int* regs) {
  if (chains == 1) return rate_launch<1>(blocks_per_sm, iters, params, out, per_sm, regs);
  if (chains == 2) return rate_launch<2>(blocks_per_sm, iters, params, out, per_sm, regs);
  if (chains == 4) return rate_launch<4>(blocks_per_sm, iters, params, out, per_sm, regs);
  return -1;
}
"""


def _patch(src: str, old: str, new: str) -> str:
    return patch(src, old, new, "csrc/ntt.cu")


def variant_sources() -> dict[str, str]:
    src = (_cuda.CSRC / "ntt.cu").read_text()
    memory = _patch(_patch(src, LADDER, ""), LEVEL_PRODUCT, "        for (int q = 0; q < NW; ++q) x[q] ^= w[q];\n")
    compute = _patch(src, LOAD, "        for (int w = 0; w < NW; ++w) x[w] = (uint32_t)(s * 0x9E3779B9u + w) & 0x0FFFFFFFu;\n")
    compute = _patch(compute, COL_TW, "          for (int q = 0; q < NW; ++q) w[q] = scale.w[q] ^ (uint32_t)k1;\n")
    compute = _patch(compute, STORE, "      if (x[0] != 0x12345678u || x[1] != 0x9ABCDEF0u) continue;  // never stored\n" + STORE)
    two = _patch(_patch(src, THREADS, "  return NW >= 8 ? 256 : 1024;\n"),
                 "__launch_bounds__(ntt_threads<NW>(), 1)", "__launch_bounds__(ntt_threads<NW>(), NW >= 8 ? 2 : 1)")
    return {name: s + REPORT for name, s in
            (("shipped", src), ("memory", memory), ("compute", compute), ("2blk", two))}


def build_all() -> dict[str, ctypes.CDLL]:
    """The variants and the microbenchmark, built together."""
    sources = {name: (text, _cuda.CSRC) for name, text in {**variant_sources(), "rate": RATE}.items()}
    libs = {}
    for name, (lib, _, _) in build(sources, PROBE_DIR).items():
        P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        if name == "rate":
            lib.probe_rate.argtypes = [I, I, I, P, P, P, P]
        else:
            lib.zk_ntt_ladder.argtypes = [I, P, P, I, I64, I64, I, P, P, P, P, P]
            lib.probe_report.argtypes = [I, ctypes.c_size_t, P, P, P]
        libs[name] = lib
    return libs


def level_args(field, batch):
    """(x, products, bytes) of one level of the 2^20 transform."""
    n_t = NTT.LADDER_MAX
    cols = (1 << 20) // n_t
    gen = torch.Generator(device="cuda").manual_seed(41)
    x = rand_limbs(field, (field.n_limbs, n_t * cols), gen).reshape(field.n_limbs, n_t, cols)
    products = cols * ((n_t // 2) * (n_t.bit_length() - 1) - (n_t - 1)) + (cols * n_t if batch else 0)
    nbytes = (2 * cols + 1) * n_t * elem_bytes(field) + (n_t * cols * 2 * field.n_limbs if batch else 0)
    return x, products, nbytes


def report(lib, field, tile_bytes: int) -> tuple[int, int, int]:
    log_cols = (tile_bytes // (NTT.LADDER_MAX * 2 * field.n_limbs)).bit_length() - 1
    S = NTT.LADDER_MAX << log_cols
    nw = field.n_limbs // 2
    smem = 4 * nw * ((S + (S >> 5) + 1) + NTT.LADDER_MAX)
    regs, per_sm, threads = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = lib.probe_report(field.n_limbs, smem, ctypes.byref(regs), ctypes.byref(per_sm), ctypes.byref(threads))
    if err:
        raise RuntimeError(f"probe_report: CUDA error {err}")
    return regs.value, per_sm.value, threads.value


def time_levels(libs) -> None:
    field = FR
    tiles = {"2blk": 64 << 10}
    levels = {name: level_args(field, batch) for name, batch in (("upper", 1), ("last", None))}
    batches = {"upper": 1, "last": None}
    want = {name: NTT.ntt_ladder(field, levels[name][0], False, batch=batches[name]) for name in levels}
    saved_lib, saved_tiles = _cuda._LIB, dict(NTT.TILE_BYTES)
    rows = []
    try:
        for turn in ("shipped", "memory", "compute", "2blk", "2blk", "compute", "memory", "shipped"):
            lib = libs[turn]
            _cuda._LIB = lib
            NTT.TILE_BYTES[field.n_limbs] = tiles.get(turn, saved_tiles[field.n_limbs])
            regs, per_sm, threads = report(lib, field, NTT.TILE_BYTES[field.n_limbs])
            for name, (x, products, nbytes) in levels.items():
                run = lambda: NTT.ntt_ladder(field, x, False, batch=batches[name])  # noqa: E731
                if turn in ("shipped", "2blk") and not torch.equal(run(), want[name]):
                    raise AssertionError(f"{turn} {name} level differs from the shipped kernel")
                ms = cuda_ms(run, 20)
                rows.append((turn, name, ms, products, nbytes, regs, per_sm, threads))
    finally:
        _cuda._LIB, NTT.TILE_BYTES[field.n_limbs] = saved_lib, saved_tiles[field.n_limbs]
    print("ntt_ladder, 2^20 BLS12-381, one level (CUDA-event mean of 20 launches; turns as listed):")
    print("variant | level | ms | products/ms (level's count) | GB/s (level's bytes) | bound ms | regs | blocks/SM x threads")
    for turn, name, ms, products, nbytes, regs, per_sm, threads in rows:
        b = bound(nbytes, products, field=field)
        print(f"{turn} | {name} | {ms:.4f} | {products / ms / 1e6:.2f}M | {nbytes / ms / 1e6:.1f} | "
              f"{b[0]:.4f} ({b[1]}) | {regs} | {per_sm} x {threads}", flush=True)


def time_rate(lib) -> None:
    params = field_params(FR)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.zeros(sms * 8 * 256, dtype=torch.int32, device="cuda")
    iters = 512
    print(f"Montgomery products (field.cuh mont_mul, NW = 8), {iters} a chain, 256-thread blocks on {sms} SMs:")
    print("warps/SM | chains a thread | ms | products/ms | share of the 256-IMAD product peak | regs | resident blocks/SM")
    peak = 64 * sms * 1.98e9 / 256 / 1e3  # products a ms at 64 IMADs a clock an SM, 1.98 GHz
    for blocks in (2, 4, 8):
        for chains in (1, 2, 4):
            per_sm, regs = ctypes.c_int(), ctypes.c_int()

            def run():
                err = lib.probe_rate(chains, blocks, iters, params.ctypes.data, out.data_ptr(),
                                     ctypes.byref(per_sm), ctypes.byref(regs))
                if err:
                    raise RuntimeError(f"probe_rate: CUDA error {err}")

            ms = cuda_ms(run, 10)
            products = sms * blocks * 256 * chains * iters
            # where fewer blocks are resident than launched, the grid runs in waves
            print(f"{min(blocks, per_sm.value) * 8} | {chains} | {ms:.4f} | {products / ms / 1e6:.2f}M | {products / ms / peak:.1%} | "
                  f"{regs.value} | {per_sm.value}", flush=True)


PARENT_SNIPPET = r"""
import importlib, sys, torch
sys.path.insert(0, ".")
from chip_smoke import cuda_ms, rand_limbs
from zk_tpu_torch import _cuda
from zk_tpu_torch.fields import BLS12_381_FR as FR
N = importlib.import_module("zk_tpu_torch.ntt")
_cuda.lib()
gen = torch.Generator(device="cuda").manual_seed(41)
x = rand_limbs(FR, (FR.n_limbs, 1 << 20), gen).reshape(FR.n_limbs, 1024, 1024)
ms = cuda_ms(lambda: N.ntt_ladder(FR, x, False), 20)
print(f"parent ntt_ladder (L, 1024 rows, 1024) BLS12-381: {ms:.4f} ms", flush=True)
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="another checkout whose ntt_ladder to time on (L, 1024, 1024) rows")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this probe runs only on a GPU")
    print(card_line(), flush=True)
    parent = None
    if args.parent:  # its build runs beside ours
        parent = subprocess.Popen([sys.executable, "-c", PARENT_SNIPPET], cwd=args.parent, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
    _cuda.lib()
    libs = build_all()
    if parent is not None:
        out, _ = parent.communicate()
        print(out.strip().splitlines()[-1] if parent.returncode == 0 else f"parent failed:\n{out}", flush=True)
    time_levels(libs)
    time_rate(libs["rate"])
    if parent is not None:
        parent = subprocess.run([sys.executable, "-c", PARENT_SNIPPET], cwd=args.parent, capture_output=True,
                                text=True)
        print(parent.stdout.strip() if parent.returncode == 0 else f"parent failed:\n{parent.stderr}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
