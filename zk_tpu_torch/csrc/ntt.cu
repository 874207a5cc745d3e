// ntt_ladder: one level of the NTT's radix recursion, DFTs along axis -2.
//
// Replaces zk_tpu/ntt/__init__.py::_ladder_pallas (the whole log2(n)-stage
// decimation-in-time ladder on one VMEM block, batch on the 128 lanes,
// butterflies along axis -2 of bit-reversed (L, n, B) limbs) and, on a
// level of the recursion zk_tpu/ntt/__init__.py::_rec_axis2, the
// mont_mul_pallas twiddle multiply and the transpose that follow it.
//
// Layout: the input is (L, t1, M) 16-bit limbs in 32-bit words, limb axis
// first, the TPU kernel's layout: M columns, each transformed along the
// t1 rows (t1 <= 1024).  Without twiddles (the recursion's last level) the
// output is (L, t1, M), natural order.  With twiddles (an upper level,
// M = t2 * B, column c = i2 * B + b) the output element (k1, c) is
// multiplied by w_T^(k1 i2) (T = t1 t2) and stored at (i2, k1, b) of an
// (L, t2, t1, B) tensor, the order the next level reads: a 2^20 transform
// is two launches and no copy.
//
// What bounds it on an H100: at L = 16 the integer multiplies.  A 2^20
// level is 2^19 * 10 ladder products plus 2^20 twiddle products, of 256
// 32-bit multiply-add issue slots each (0.096 ms on 132 SMs), against
// 64 MiB in, 64 MiB out and 32 MiB of twiddles (0.050 ms at 3.35 TB/s).
// At L = 4 it is the bytes (16 + 16 + 8 MiB, 0.013 ms).
//
// Design.  A persistent block (one per SM: 512 threads at L = 16, 1024 at
// L = 4) owns a tile of `cols` adjacent columns (128 KiB of elements: 4
// columns of 1024 at L = 16, 64 KiB and 8 columns at L = 4; wider tiles
// cover more of each 32-byte sector of a row read) and loops over tiles.
// The block reads the ladder's packed per-stage twiddles into shared
// memory once.  Per tile it reads the t1 x cols elements with the bit
// reversal applied to the source row (so the shared-memory stores run over
// consecutive slots), runs the ladder two stages at a time as radix-4
// butterflies in registers (5 barriers at t1 = 1024 instead of 10; stage
// 1's twiddle and stage 2's first are 1 and are skipped), then reads each
// element back, multiplies it by its level twiddle (element-major table,
// 32 contiguous bytes per element, t1^-1 folded in for the inverse) or by
// the last level's t1^-1, and stores it.  Shared memory keeps word w of
// slot s (row-major over the tile, columns fastest) at plane w, index
// s + s / 32: consecutive slots and stride-`cols` walks hit distinct
// banks.  When the output is transposed (B = 1) the store walks rows
// fastest so the global writes are contiguous.  The radix-4 body has one
// call site (4 products inlined once, ~4.3K SASS instructions in all):
// code that overflows the instruction cache stalls on fetch.
//
// What still holds it back, measured (scripts/probe_ntt_ladder.py builds
// this file with the arithmetic or the global traffic taken out):
//  * one block per SM runs a tile's loads, its ladder and its stores one
//    after the other, so a level takes about the sum of its data movement
//    and its arithmetic (2^20 at L = 16: 0.28 ms against 0.10 + 0.21 ms for
//    the upper level, 0.33 ms against 0.16 + 0.18 ms for the last);
//  * the arithmetic alone runs at ~60% of the rate at which the card
//    issues field.cuh's product by itself (the rest: butterflies'
//    add/sub, shared-memory round trips, barriers);
//  * the last level's natural-order store writes 16 bytes of each 32-byte
//    sector (4 columns of one limb), which makes its data movement slower
//    than the upper level's though it moves less.
// Two 256-thread blocks per SM on 2-column tiles, to overlap the phases,
// measured slower (narrower rows); a PTX carry-chain product (mad.lo.cc /
// madc.hi.cc) compiled to more instructions than the C product, not fewer.

#include <cuda_runtime.h>
#include <stdint.h>

#include "field.cuh"

namespace {

constexpr int MAX_LOG_N = 10;

// 512 threads at L = 16 (~112 registers each fill the register file), 1024
// at L = 4; one block per SM
template <int NW>
constexpr int ntt_threads() {
  return NW >= 8 ? 512 : 1024;
}

template <int NW>
struct Elem {
  uint32_t w[NW];
};

__device__ __forceinline__ int pad(int slot) { return slot + (slot >> 5); }

template <int NW>
__device__ __forceinline__ void sm_get(uint32_t x[NW], const uint32_t* sm, int plane, int slot) {
  const int s = pad(slot);
#pragma unroll
  for (int w = 0; w < NW; ++w) x[w] = sm[w * plane + s];
}

template <int NW>
__device__ __forceinline__ void sm_put(uint32_t* sm, int plane, int slot, const uint32_t x[NW]) {
  const int s = pad(slot);
#pragma unroll
  for (int w = 0; w < NW; ++w) sm[w * plane + s] = x[w];
}

template <int NW>
__device__ __forceinline__ void tw_get(uint32_t x[NW], const uint32_t* tws, int t1, int k) {
#pragma unroll
  for (int w = 0; w < NW; ++w) x[w] = tws[w * t1 + k];
}

// (a, b) -> (a + b, a - b)
template <int NW>
__device__ __forceinline__ void butterfly(uint32_t a[NW], uint32_t b[NW], const FieldParams<NW>& fp) {
  uint32_t s[NW];
  add_mod<NW>(s, a, b, fp);
  sub_mod<NW>(b, a, b, fp);
#pragma unroll
  for (int w = 0; w < NW; ++w) a[w] = s[w];
}

// Stage 1 alone (odd log2 t1): pairs (2g, 2g + 1), twiddle 1.
template <int NW>
__device__ __forceinline__ void radix2_first(uint32_t* sm, int plane, int t1, int log_cols,
                                             const FieldParams<NW>& fp) {
  const int units = (t1 >> 1) << log_cols, cols = 1 << log_cols;
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    const int c = u & (cols - 1), g = u >> log_cols;
    uint32_t x0[NW], x1[NW];
    sm_get<NW>(x0, sm, plane, ((2 * g) << log_cols) | c);
    sm_get<NW>(x1, sm, plane, ((2 * g + 1) << log_cols) | c);
    butterfly<NW>(x0, x1, fp);
    sm_put<NW>(sm, plane, ((2 * g) << log_cols) | c, x0);
    sm_put<NW>(sm, plane, ((2 * g + 1) << log_cols) | c, x1);
  }
}

// Stages s and s + 1 (span h = 2^(s-1)) as radix-4 units over the rows
// e, e + h, e + 2h, e + 3h (e = blk * 4h + j): stage s pairs (e, e + h) and
// (e + 2h, e + 3h) at w_2h^j, stage s + 1 pairs (e, e + 2h) at w_4h^j and
// (e + h, e + 3h) at w_4h^(j + h); the packed table holds w_2h^j at
// h - 1 + j.  FIRST (s = 1, j = 0): the first two twiddles are 1.
template <int NW>
__device__ __forceinline__ void radix4(uint32_t* sm, int plane, const uint32_t* tws, int t1,
                                       int log_cols, int log_h, const FieldParams<NW>& fp) {
  const bool FIRST = log_h == 0;
  const int units = (t1 >> 2) << log_cols, cols = 1 << log_cols, h = 1 << log_h;
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    const int c = u & (cols - 1), g = u >> log_cols;
    const int j = g & (h - 1);
    const int e = ((g >> log_h) << (log_h + 2)) + j;
    uint32_t x0[NW], x1[NW], x2[NW], x3[NW], w[NW];
    sm_get<NW>(x0, sm, plane, (e << log_cols) | c);
    sm_get<NW>(x1, sm, plane, ((e + h) << log_cols) | c);
    sm_get<NW>(x2, sm, plane, ((e + 2 * h) << log_cols) | c);
    sm_get<NW>(x3, sm, plane, ((e + 3 * h) << log_cols) | c);
    if (!FIRST) {
      tw_get<NW>(w, tws, t1, h - 1 + j);
      mont_mul<NW>(x1, x1, w, fp);
      mont_mul<NW>(x3, x3, w, fp);
    }
    butterfly<NW>(x0, x1, fp);
    butterfly<NW>(x2, x3, fp);
    if (!FIRST) {
      tw_get<NW>(w, tws, t1, 2 * h - 1 + j);
      mont_mul<NW>(x2, x2, w, fp);
    }
    tw_get<NW>(w, tws, t1, 3 * h - 1 + j);
    mont_mul<NW>(x3, x3, w, fp);
    butterfly<NW>(x0, x2, fp);
    butterfly<NW>(x1, x3, fp);
    sm_put<NW>(sm, plane, (e << log_cols) | c, x0);
    sm_put<NW>(sm, plane, ((e + h) << log_cols) | c, x1);
    sm_put<NW>(sm, plane, ((e + 2 * h) << log_cols) | c, x2);
    sm_put<NW>(sm, plane, ((e + 3 * h) << log_cols) | c, x3);
  }
}

// NW contiguous words of an element-major table (32-byte aligned rows at
// NW = 8, 8-byte at NW = 2).
template <int NW>
__device__ __forceinline__ void load_words(uint32_t x[NW], const uint32_t* src) {
  if constexpr (NW % 4 == 0) {
#pragma unroll
    for (int q = 0; q < NW / 4; ++q) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(src) + q);
      x[4 * q] = v.x;
      x[4 * q + 1] = v.y;
      x[4 * q + 2] = v.z;
      x[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < NW / 2; ++q) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(src) + q);
      x[2 * q] = v.x;
      x[2 * q + 1] = v.y;
    }
  }
}

template <int NW>
__global__ void __launch_bounds__(ntt_threads<NW>(), 1)
ntt_ladder_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out, int log_t1,
                  int64_t M, int64_t B, int log_cols, const uint32_t* __restrict__ tw,
                  const uint32_t* __restrict__ col_tw, Elem<NW> scale, int scaled,
                  FieldParams<NW> fp) {
  extern __shared__ uint32_t sm[];
  const int t1 = 1 << log_t1, cols = 1 << log_cols;
  const int S = t1 << log_cols;
  const int plane = S + (S >> 5) + 1;
  uint32_t* tws = sm + NW * plane;
  const int64_t limb_stride = (int64_t)t1 * M;
  for (int k = threadIdx.x; k < t1 - 1; k += blockDim.x) {
#pragma unroll
    for (int w = 0; w < NW; ++w) tws[w * t1 + k] = tw[(2 * w) * t1 + k] | (tw[(2 * w + 1) * t1 + k] << 16);
  }
  const int64_t tiles = (M + cols - 1) >> log_cols;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t c0 = tile << log_cols;
    // rows in bit-reversed order: slot (r, c) takes source row brev(r)
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      const int r = s >> log_cols, c = s & (cols - 1);
      uint32_t x[NW];
      if (c0 + c < M) {
        const int64_t row = __brev((unsigned)r) >> (32 - log_t1);
        const uint32_t* src = in + row * M + c0 + c;
#pragma unroll
        for (int w = 0; w < NW; ++w) x[w] = src[(2 * w) * limb_stride] | (src[(2 * w + 1) * limb_stride] << 16);
      } else {
#pragma unroll
        for (int w = 0; w < NW; ++w) x[w] = 0;
      }
      sm_put<NW>(sm, plane, s, x);
    }
    __syncthreads();
    if (log_t1 & 1) {
      radix2_first<NW>(sm, plane, t1, log_cols, fp);
      __syncthreads();
    }
    // one call site: the radix-4 body is inlined once
    for (int st = (log_t1 & 1) + 1; st < log_t1; st += 2) {
      radix4<NW>(sm, plane, tws, t1, log_cols, st - 1, fp);
      __syncthreads();
    }
    const bool rows_fastest = B == 1;
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      const int k1 = rows_fastest ? (s & (t1 - 1)) : (s >> log_cols);
      const int c = rows_fastest ? (s >> log_t1) : (s & (cols - 1));
      const int64_t col = c0 + c;
      if (col >= M) continue;
      uint32_t x[NW];
      sm_get<NW>(x, sm, plane, (k1 << log_cols) | c);
      const int64_t i2 = col / B, b = col - i2 * B;
      if (col_tw != nullptr || scaled) {
        uint32_t w[NW];
        if (col_tw != nullptr) {
          load_words<NW>(w, col_tw + (i2 * t1 + k1) * NW);
        } else {
#pragma unroll
          for (int q = 0; q < NW; ++q) w[q] = scale.w[q];
        }
        mont_mul<NW>(x, x, w, fp);
      }
      uint32_t* dst = out + (i2 * t1 + k1) * B + b;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        dst[(2 * w) * limb_stride] = x[w] & 0xFFFFu;
        dst[(2 * w + 1) * limb_stride] = x[w] >> 16;
      }
    }
    __syncthreads();
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

template <int NW>
int ntt_ladder_nw(const uint32_t* in, uint32_t* out, int log_t1, int64_t M, int64_t B,
                  int log_cols, const uint32_t* tw, const uint32_t* col_tw, const uint32_t* scale,
                  const uint32_t* params, cudaStream_t s) {
  const int S = (1 << log_t1) << log_cols;
  const size_t smem = sizeof(uint32_t) * NW * ((S + (S >> 5) + 1) + (1 << log_t1));
  static size_t smem_set = 48 << 10;
  if (smem > smem_set) {
    const int err = (int)cudaFuncSetAttribute(ntt_ladder_kernel<NW>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != 0) return err;
    smem_set = smem;
  }
  int per_sm = 0;
  const int occ = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ntt_ladder_kernel<NW>,
                                                                    ntt_threads<NW>(), smem);
  if (occ != 0) return occ;
  if (per_sm < 1) return -1;
  const int64_t tiles = (M + (1 << log_cols) - 1) >> log_cols;
  const int64_t cap = (int64_t)per_sm * sm_count();
  const int grid = (int)(tiles < cap ? tiles : cap);
  Elem<NW> sc{};
  if (scale != nullptr)
    for (int w = 0; w < NW; ++w) sc.w[w] = scale[w];
  ntt_ladder_kernel<NW><<<grid, ntt_threads<NW>(), smem, s>>>(in, out, log_t1, M, B, log_cols, tw, col_tw, sc,
                                                    scale != nullptr, load_params<NW>(params));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One level of the radix recursion: the length-2^log_t1 DFT along axis -2
// of (L, 2^log_t1, M) limbs, natural order in.  col_tw NULL: the output is
// (L, 2^log_t1, M), times the Montgomery words `scale` (host, NW words,
// the inverse's t1^-1) when scale is not NULL.  col_tw not NULL: the
// element-major (M / B, 2^log_t1, NW) Montgomery words w_T^(k1 i2), the
// output is (L, M / B, 2^log_t1, B) with out[i2, k1, b] = col_tw[i2, k1] *
// DFT(in[:, i2 * B + b])[k1].  tw: the ladder's packed (L, 2^log_t1)
// per-stage twiddles.  Tiles of 2^log_cols columns.  out must not overlap
// in.  Returns cudaGetLastError(), or -1 for an unsupported shape.
int zk_ntt_ladder(int L, const void* in, void* out, int log_t1, int64_t M, int64_t B, int log_cols,
                  const void* tw, const void* col_tw, const void* scale, const void* params,
                  void* stream) {
  auto s = (cudaStream_t)stream;
  auto i = (const uint32_t*)in;
  auto o = (uint32_t*)out;
  auto t = (const uint32_t*)tw;
  auto ct = (const uint32_t*)col_tw;
  auto sc = (const uint32_t*)scale;
  auto p = (const uint32_t*)params;
  if (log_t1 < 1 || log_t1 > MAX_LOG_N || M < 1 || B < 1 || M % B != 0) return -1;
  if (log_cols < 0 || log_t1 + log_cols > 15) return -1;
  if (L == 4) return ntt_ladder_nw<2>(i, o, log_t1, M, B, log_cols, t, ct, sc, p, s);
  if (L == 16) return ntt_ladder_nw<8>(i, o, log_t1, M, B, log_cols, t, ct, sc, p, s);
  return -1;
}

}  // extern "C"
