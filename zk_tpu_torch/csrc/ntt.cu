// ntt_ladder: the length-n DFT of every row of a batch, n <= 1024.
//
// Replaces zk_tpu/ntt/__init__.py::_ladder_pallas (the whole log2(n)-stage
// decimation-in-time ladder on one VMEM block, batch on the 128 lanes,
// butterflies along axis -2 of bit-reversed (L, n, B) limbs).  Here the
// transformed axis is the contiguous last one, (L, rows, n) limbs in
// natural order in and out: a TPU-style column read would touch one
// 4-byte word per 32-byte sector, so the NTT's radix recursion
// (zk_tpu_torch/ntt) transposes between its ladder passes instead.
//
// Design: one block per row.  The block reads the row's n elements with
// coalesced loads (neighbouring threads on neighbouring words of each limb
// row), applies the bit reversal as it stores them into shared memory
// (word w of element j at sm[w * n + j], so a warp's accesses to one word
// hit 32 banks when the butterfly stride is at least 32), runs log2(n)
// stages of n/2 butterflies split over the threads with __syncthreads()
// between stages, scales by n^-1 (the inverse) as it reads the row back,
// and writes it with coalesced stores.  The per-stage twiddles come from
// the packed (L, n) Montgomery table of the TPU kernel: stage s (butterfly
// span m = 2^s) reads columns [m/2 - 1, m - 1) from global memory, where
// they stay in L1/L2 (8 KiB at L = 4, 32 KiB at L = 16 for n = 1024).
// A row of n = 1024 is 8 KiB of shared memory at L = 4 and 32 KiB at
// L = 16, under the 48 KiB a block may take without opting in.
//
// What bounds it on an H100: at L = 16 the integer multiplies.  One pass
// over 2^20 elements at n = 1024 is 2^19 * 10 Montgomery products of 256
// 32-bit multiply-add issue slots (0.080 ms on 132 SMs) against 128 MiB of
// limbs in and out (0.040 ms at 3.35 TB/s).  At L = 4 it is the bytes
// (32 MiB, 0.010 ms, against 2^19 * 10 * 16 IMADs, 0.005 ms).  The design
// keeps every product in registers and touches global memory once per
// element each way; the first things to try for speed are several rows
// per block (the 1024-element rows leave half the threads idle at the
// small stages) and twiddles in shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "field.cuh"

namespace {

constexpr int MAX_LOG_N = 10;
constexpr int MAX_THREADS = 256;

template <int NW>
struct Elem {
  uint32_t w[NW];
};

template <int NW>
__global__ void __launch_bounds__(MAX_THREADS)
ntt_ladder_kernel(const uint32_t* in, uint32_t* out, int64_t limb_stride, int log_n,
                  const uint32_t* tw, Elem<NW> scale, int scaled, FieldParams<NW> fp) {
  extern __shared__ uint32_t sm[];
  const int n = 1 << log_n;
  const int64_t base = (int64_t)blockIdx.x * n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const int rj = (int)(__brev((unsigned)j) >> (32 - log_n));
#pragma unroll
    for (int w = 0; w < NW; ++w)
      sm[w * n + rj] = in[(2 * w) * limb_stride + base + j] |
                       (in[(2 * w + 1) * limb_stride + base + j] << 16);
  }
  __syncthreads();
  for (int s = 1; s <= log_n; ++s) {
    const int half = 1 << (s - 1);
    for (int t = threadIdx.x; t < n / 2; t += blockDim.x) {
      const int j = t & (half - 1);
      const int e = ((t >> (s - 1)) << s) + j;
      uint32_t a[NW], b[NW], w[NW];
#pragma unroll
      for (int k = 0; k < NW; ++k) {
        a[k] = sm[k * n + e];
        b[k] = sm[k * n + e + half];
      }
      load_scalar<NW>(w, tw, n, half - 1 + j);
      mont_mul<NW>(b, b, w, fp);
      add_mod<NW>(w, a, b, fp);
      sub_mod<NW>(a, a, b, fp);
#pragma unroll
      for (int k = 0; k < NW; ++k) {
        sm[k * n + e] = w[k];
        sm[k * n + e + half] = a[k];
      }
    }
    __syncthreads();
  }
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    uint32_t x[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) x[w] = sm[w * n + j];
    if (scaled) mont_mul<NW>(x, x, scale.w, fp);
    store_elem<NW>(out + base, limb_stride, j, x);
  }
}

template <int NW>
int ntt_ladder_nw(const uint32_t* in, uint32_t* out, int64_t rows, int log_n, const uint32_t* tw,
                  const uint32_t* scale, const uint32_t* params, cudaStream_t s) {
  const int n = 1 << log_n;
  const int threads = n / 2 < 32 ? 32 : (n / 2 > MAX_THREADS ? MAX_THREADS : n / 2);
  Elem<NW> sc{};
  if (scale != nullptr)
    for (int w = 0; w < NW; ++w) sc.w[w] = scale[w];
  ntt_ladder_kernel<NW><<<(unsigned)rows, threads, NW * n * sizeof(uint32_t), s>>>(
      in, out, rows * n, log_n, tw, sc, scale != nullptr, load_params<NW>(params));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The length-2^log_n DFT along the last axis of (L, rows, 2^log_n) limbs,
// natural order in and out; out may be in.  tw: the packed (L, 2^log_n)
// Montgomery twiddles on the device; scale: NW host words of the
// Montgomery form of the factor applied to every output (the inverse's
// n^-1), or NULL.  Returns cudaGetLastError(), or -1 for an unsupported
// L, log_n or row count.
int zk_ntt_ladder(int L, const void* in, void* out, int64_t rows, int log_n, const void* tw,
                  const void* scale, const void* params, void* stream) {
  auto s = (cudaStream_t)stream;
  auto i = (const uint32_t*)in;
  auto o = (uint32_t*)out;
  auto t = (const uint32_t*)tw;
  auto sc = (const uint32_t*)scale;
  auto p = (const uint32_t*)params;
  if (log_n < 1 || log_n > MAX_LOG_N || rows < 1 || rows > 0x7FFFFFFF) return -1;
  if (L == 4) return ntt_ladder_nw<2>(i, o, rows, log_n, t, sc, p, s);
  if (L == 16) return ntt_ladder_nw<8>(i, o, rows, log_n, t, sc, p, s);
  return -1;
}

}  // extern "C"
