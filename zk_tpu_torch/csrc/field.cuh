// Montgomery field arithmetic for the Hopper kernels.
//
// Counterpart of zk_tpu/fields/limb_math.py (the in-kernel limb math of the
// TPU's Pallas kernels).  Tables keep the reference layout: an (L, N)
// array of 16-bit limbs in 32-bit words, limb axis first.  Inside a kernel
// an element is NW = L/2 32-bit words (word w = limb 2w | limb 2w+1 << 16):
// the TPU had no 64-bit multiply and split 16x16 products, the GPU does
// 32x32->64 products natively, so the product is word-serial CIOS
// Montgomery multiplication.  R = 2^(32 NW) = 2^(16 L) is the reference's
// radix, so every result (the unique representative in [0, p)) has the
// same limbs as the reference and as the torch tier.
//
// Bound on this card: integer multiply issue.  A BLS12-381 Fr product is
// 2 * 8 * 8 = 128 32x32->64 multiply-adds; the loops are fully unrolled
// on compile-time NW so every word lives in registers.
#pragma once

#include <stdint.h>

template <int NW>
struct FieldParams {
  uint32_t p[NW];
  uint32_t pinv;          // -p^-1 mod 2^32
  uint32_t pts[4][NW];    // Montgomery form of the sample points 0, 1, 2, 3
};

// Host-side parameter block layout (uint32 words), as written by
// zk_tpu_torch/fields/kernels.py::field_params: p[NW], pinv, pts[4][NW].
template <int NW>
inline FieldParams<NW> load_params(const uint32_t* host) {
  FieldParams<NW> fp;
  for (int w = 0; w < NW; ++w) fp.p[w] = host[w];
  fp.pinv = host[NW];
  for (int i = 0; i < 4; ++i)
    for (int w = 0; w < NW; ++w) fp.pts[i][w] = host[NW + 1 + i * NW + w];
  return fp;
}

// Blocks of a grid-stride loop over n elements, `threads` per block: one
// block per `threads` elements, at most 16 resident waves on 132 SMs.
inline int grid_for(int64_t n, int threads) {
  const int64_t blocks = (n + threads - 1) / threads;
  const int64_t cap = 132 * 16;
  return (int)(blocks < 1 ? 1 : (blocks > cap ? cap : blocks));
}

// Load element e of a limb-major table (row stride `stride` words).
template <int NW>
__device__ __forceinline__ void load_elem(uint32_t x[NW], const uint32_t* base,
                                          int64_t stride, int64_t e) {
#pragma unroll
  for (int w = 0; w < NW; ++w)
    x[w] = base[(2 * w) * stride + e] | (base[(2 * w + 1) * stride + e] << 16);
}

template <int NW>
__device__ __forceinline__ void store_elem(uint32_t* base, int64_t stride, int64_t e,
                                           const uint32_t x[NW]) {
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    base[(2 * w) * stride + e] = x[w] & 0xFFFFu;
    base[(2 * w + 1) * stride + e] = x[w] >> 16;
  }
}

// A scalar stored as (L, cols) limbs; column `col`.
template <int NW>
__device__ __forceinline__ void load_scalar(uint32_t x[NW], const uint32_t* s, int cols,
                                            int col) {
#pragma unroll
  for (int w = 0; w < NW; ++w)
    x[w] = s[(2 * w) * cols + col] | (s[(2 * w + 1) * cols + col] << 16);
}

// r = a + b mod p (a, b < p)
template <int NW>
__device__ __forceinline__ void add_mod(uint32_t r[NW], const uint32_t a[NW],
                                        const uint32_t b[NW], const FieldParams<NW>& fp) {
  uint32_t s[NW], d[NW];
  uint64_t c = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    c += (uint64_t)a[w] + b[w];
    s[w] = (uint32_t)c;
    c >>= 32;
  }
  uint32_t borrow = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    uint64_t t = (uint64_t)s[w] - fp.p[w] - borrow;
    d[w] = (uint32_t)t;
    borrow = (uint32_t)(t >> 63);
  }
  const bool ge = c != 0 || borrow == 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) r[w] = ge ? d[w] : s[w];
}

// r = a - b mod p (a, b < p)
template <int NW>
__device__ __forceinline__ void sub_mod(uint32_t r[NW], const uint32_t a[NW],
                                        const uint32_t b[NW], const FieldParams<NW>& fp) {
  uint32_t d[NW];
  uint32_t borrow = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    uint64_t t = (uint64_t)a[w] - b[w] - borrow;
    d[w] = (uint32_t)t;
    borrow = (uint32_t)(t >> 63);
  }
  const uint32_t mask = 0u - borrow;  // add p back iff a < b
  uint64_t c = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    c += (uint64_t)d[w] + (fp.p[w] & mask);
    r[w] = (uint32_t)c;
    c >>= 32;
  }
}

// r = a * b * R^-1 mod p (a, b < p), CIOS.  r may alias a or b.
template <int NW>
__device__ __forceinline__ void mont_mul(uint32_t r[NW], const uint32_t a[NW],
                                         const uint32_t b[NW], const FieldParams<NW>& fp) {
  uint32_t t[NW + 2];
#pragma unroll
  for (int w = 0; w < NW + 2; ++w) t[w] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      c += (uint64_t)a[j] * b[i] + t[j];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    c += t[NW];
    t[NW] = (uint32_t)c;
    t[NW + 1] = (uint32_t)(c >> 32);
    const uint32_t m = t[0] * fp.pinv;
    c = ((uint64_t)m * fp.p[0] + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < NW; ++j) {
      c += (uint64_t)m * fp.p[j] + t[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += t[NW];
    t[NW - 1] = (uint32_t)c;
    t[NW] = t[NW + 1] + (uint32_t)(c >> 32);
  }
  // t < 2p: one conditional subtract
  uint32_t d[NW];
  uint32_t borrow = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    uint64_t s = (uint64_t)t[w] - fp.p[w] - borrow;
    d[w] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  const bool ge = t[NW] != 0 || borrow == 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) r[w] = ge ? d[w] : t[w];
}

// out = left - r * (left - right): the fold step (limb_math.py::lerp).
// out may alias left or right.
template <int NW>
__device__ __forceinline__ void lerp(uint32_t out[NW], const uint32_t left[NW],
                                     const uint32_t right[NW], const uint32_t r[NW],
                                     const FieldParams<NW>& fp) {
  uint32_t d[NW];
  sub_mod<NW>(d, left, right, fp);
  mont_mul<NW>(d, d, r, fp);
  sub_mod<NW>(out, left, d, fp);
}

// Add an element's 16-bit limbs into per-thread u32 limb accumulators.
template <int NW>
__device__ __forceinline__ void acc_limbs(uint32_t acc[2 * NW], const uint32_t x[NW]) {
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    acc[2 * w] += x[w] & 0xFFFFu;
    acc[2 * w + 1] += x[w] >> 16;
  }
}

// Sum N per-thread u32 accumulators over the block (as u64) and write
// total k to dst[k * G + col] (col: the block's partial, by default its
// index).  Every thread of the block must call this.  blockDim.x must be a
// multiple of 32 and at most 1024.
template <int N>
__device__ __forceinline__ void block_reduce_store(const uint32_t acc[N],
                                                   unsigned long long* dst, int G,
                                                   int64_t col = -1) {
  if (col < 0) col = blockIdx.x;
  __shared__ unsigned long long red[32][N];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    unsigned long long v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, off);
    if (lane == 0) red[warp][k] = v;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < N; k += blockDim.x) {
    unsigned long long s = 0;
    for (int w = 0; w < warps; ++w) s += red[w][k];
    dst[(int64_t)k * G + col] = s;
  }
}
