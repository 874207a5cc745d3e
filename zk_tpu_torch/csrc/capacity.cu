// The sumcheck table kernels: fold_multi, round_sums, fold_halfsums, fold,
// round_sums_terms.
//
// Replace the Pallas kernels of zk_tpu/sumcheck/capacity.py:
//   fold_multi       <- _fold_multi_cap       (MLE evaluation, up to 4 variables per pass)
//   round_sums       <- _round_sums_cap       (all D+1 round-polynomial sums)
//   fold_halfsums    <- _fold_halfsums_cap    (fused degree-1 round: fold + next sums)
//   fold             <- _fold_cap             (fold all K factors of a stack at r)
//   round_sums_terms <- _round_sums_terms_cap (round sums of a sum of products)
//
// Layout: a stack is (k, L, cap) 16-bit limbs in 32-bit words; the live
// prefix [0, size) of each row holds the table.  Folds are in place
// (out == in) or write a fresh buffer (the first pass of an evaluation or
// a prove, so the caller's table survives).
//
// What bounds them on an H100: at L = 16 each table element is 64 bytes
// and a fold costs one Montgomery product (~128 32-bit multiply-adds) plus
// two modular subtractions, i.e. ~6 integer ops per byte; the card issues
// far more than that per byte of HBM, so the folds are close to the
// memory-bound side and fold_multi's 2^f-input tree (one HBM pass for f
// variables) matters more than the multiply count.  Design: one thread per
// output element, limb-major addressing so that neighbouring threads read
// neighbouring words of each limb row (coalesced), all limb math unrolled
// in registers.  Nothing carries between blocks: a sums kernel's block b
// owns the contiguous chunk [b*chunk, (b+1)*chunk) of pair indices, keeps
// per-thread u32 limb accumulators, and writes its own u64 partial sums
// (P, L, G); the transcript round adds the G partials in int64.
//
// fold_multi at f = 4, L = 16 does 15 lerps per output against 16
// elements read (2^24 elements: 0.24 ms of multiply-adds, 0.34 ms of
// bytes), so it sits where both bounds meet and issue efficiency decides.
// Design: a depth-first walk of the tree in a runtime loop (one copy of
// each lerp, ~1.6K SASS instructions, inside the instruction cache; the
// fully unrolled tree was ~10.7K and stalled on instruction fetch), the
// pending nodes and the scalars in shared memory, 62 registers and four
// 256-thread blocks per SM, so 32 warps hide each other's load and
// carry-chain latency.  Loads are not prefetched a leaf ahead: the
// registers that takes cost a block per SM (measured slower).
//
// Accumulator bound (replaces the TPU's 2^15-grid-steps argument,
// capacity.py:33-38): a thread adds at most ceil(chunk / blockDim) pairs,
// each adding n_terms limbs < 2^16 (n_terms = 1 but for round_sums_terms),
// to a u32 — safe for up to 2^16 limbs, which the wrapper enforces
// (ceil(chunk / THREADS) * n_terms <= 2^16, sumcheck/capacity.py
// partition).  The block sum is u64: at most chunk * n_terms * 2^16.
// Integer sums are exact in any order, so the partials are bit-identical
// to the plain torch version's.
//
// fold and round_sums_terms (the GKR layer rounds, K = 3 or 4 factors of
// 2^19 elements at the first round): fold is one thread per output
// element e < size/2 over all K rows, ~1.5 Montgomery products per
// element and factor against 3 * 64 bytes moved per element and factor
// at L = 16, so it sits near the memory bound like fold_multi; in place
// is safe because the thread writing e is the only reader of e and never
// writes e + size/2.  round_sums_terms reads 2 * K elements per pair and
// does (K - n_terms) * (D + 1) Montgomery products (the points t >= 2 by
// adding differences), 6 a pair at GKR's (2, (2, 2)), so its memory bound
// is the larger; its design is beside the kernel.

#include <cuda_runtime.h>
#include <stdint.h>

#include "field.cuh"

namespace {

constexpr int THREADS = 256;

// fold_multi: one thread per output element walks the 2^F-input lerp tree
// depth first.  Leaf k (k < 2^(F-1), in bit-reversed order j = brev(k))
// lerps the inputs j and j + 2^(F-1) at r_0; then, for each trailing one
// bit of k, the running node is the right operand of a lerp at the next
// scalar against the left node pending at that level, and the result is
// pushed at the first zero bit.  The leaves run in a runtime loop, so the
// kernel holds one copy of the leaf lerp and one of the combine lerp.  The
// pending nodes (at most F - 1) and the scalars live in shared memory, so
// a thread keeps two elements in registers.
constexpr int FOLD_MULTI_MIN_BLOCKS = 4;

template <int NW, int F>
__global__ void __launch_bounds__(THREADS, FOLD_MULTI_MIN_BLOCKS)
fold_multi_kernel(const uint32_t* in, int64_t in_stride, uint32_t* out, int64_t out_stride,
                  int64_t out_n, const uint32_t* rs, FieldParams<NW> fp) {
  constexpr int H = 1 << (F - 1);  // leaves (level-0 lerps) per output
  __shared__ uint32_t r_sh[F][NW];
  __shared__ uint32_t stack[(F > 1 ? F - 1 : 1) * NW][THREADS];  // word w of level l: row l * NW + w
  for (int k = threadIdx.x; k < F * NW; k += blockDim.x) {
    const int l = k / NW, w = k % NW;
    r_sh[l][w] = rs[(2 * w) * F + l] | (rs[(2 * w + 1) * F + l] << 16);
  }
  __syncthreads();
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < out_n;
       e += (int64_t)gridDim.x * blockDim.x) {
    uint32_t a[NW], b[NW];
    // leaf 0 reads in[e] first: the in-place rule (the only reader of
    // in[e] writes out[e], after its last read)
#pragma unroll 1
    for (int k = 0; k < H; ++k) {
      const int64_t j = F > 1 ? (int64_t)(__brev((unsigned)k) >> (33 - (F > 1 ? F : 2))) : 0;
      load_elem<NW>(a, in, in_stride, e + j * out_n);
      load_elem<NW>(b, in, in_stride, e + (j + H) * out_n);
      lerp<NW>(a, a, b, r_sh[0], fp);
      const int t = __ffs(~k) - 1;  // trailing one bits of k
#pragma unroll 1
      for (int l = 1; l <= t; ++l) {
#pragma unroll
        for (int w = 0; w < NW; ++w) b[w] = stack[(l - 1) * NW + w][threadIdx.x];
        lerp<NW>(a, b, a, r_sh[l], fp);
      }
      if (t < F - 1) {
#pragma unroll
        for (int w = 0; w < NW; ++w) stack[t * NW + w][threadIdx.x] = a[w];
      }
    }
    store_elem<NW>(out, out_stride, e, a);
  }
}

template <int NW>
__global__ void __launch_bounds__(THREADS)
fold_halfsums_kernel(const uint32_t* in, int64_t in_stride, uint32_t* out, int64_t out_stride,
                     int64_t half, int64_t chunk, const uint32_t* rp, FieldParams<NW> fp,
                     unsigned long long* partials, int G) {
  constexpr int L = 2 * NW;
  uint32_t r[NW];
  load_scalar<NW>(r, rp, 1, 0);
  uint32_t acc[2 * L];
#pragma unroll
  for (int k = 0; k < 2 * L; ++k) acc[k] = 0;
  const int64_t quarter = half / 2;
  const int64_t beg = (int64_t)blockIdx.x * chunk;
  const int64_t end = beg + chunk < half ? beg + chunk : half;
  for (int64_t e = beg + threadIdx.x; e < end; e += blockDim.x) {
    uint32_t a[NW], b[NW];
    load_elem<NW>(a, in, in_stride, e);
    load_elem<NW>(b, in, in_stride, e + half);
    lerp<NW>(a, a, b, r, fp);
    store_elem<NW>(out, out_stride, e, a);
    // the folded table's halves are the next round's p(0) and p(1)
    const uint32_t hi = e >= quarter ? 0xFFFFFFFFu : 0u;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const uint32_t l0 = a[w] & 0xFFFFu, l1 = a[w] >> 16;
      acc[2 * w] += l0 & ~hi;
      acc[2 * w + 1] += l1 & ~hi;
      acc[L + 2 * w] += l0 & hi;
      acc[L + 2 * w + 1] += l1 & hi;
    }
  }
  block_reduce_store<2 * L>(acc, partials, G);
}

template <int NW, int D, int K>
__global__ void __launch_bounds__(THREADS)
round_sums_kernel(const uint32_t* stack, int64_t fac_stride, int64_t row_stride, int64_t half,
                  int64_t chunk, FieldParams<NW> fp, unsigned long long* partials, int G) {
  constexpr int L = 2 * NW;
  uint32_t acc[(D + 1) * L];
#pragma unroll
  for (int k = 0; k < (D + 1) * L; ++k) acc[k] = 0;
  const int64_t beg = (int64_t)blockIdx.x * chunk;
  const int64_t end = beg + chunk < half ? beg + chunk : half;
  for (int64_t e = beg + threadIdx.x; e < end; e += blockDim.x) {
    uint32_t left[K][NW], right[K][NW];
#pragma unroll
    for (int t = 0; t < K; ++t) {
      load_elem<NW>(left[t], stack + t * fac_stride, row_stride, e);
      load_elem<NW>(right[t], stack + t * fac_stride, row_stride, e + half);
    }
    // point 0 takes the left halves, point 1 the right (no multiply),
    // point i >= 2 lerps at the constant i; factors multiply across
#pragma unroll
    for (int pt = 0; pt <= D; ++pt) {
      uint32_t prod[NW], ev[NW];
#pragma unroll
      for (int t = 0; t < K; ++t) {
        if (pt == 0) {
#pragma unroll
          for (int w = 0; w < NW; ++w) ev[w] = left[t][w];
        } else if (pt == 1) {
#pragma unroll
          for (int w = 0; w < NW; ++w) ev[w] = right[t][w];
        } else {
          lerp<NW>(ev, left[t], right[t], fp.pts[pt], fp);
        }
        if (t == 0) {
#pragma unroll
          for (int w = 0; w < NW; ++w) prod[w] = ev[w];
        } else {
          mont_mul<NW>(prod, prod, ev, fp);
        }
      }
      acc_limbs<NW>(acc + pt * L, prod);
    }
  }
  block_reduce_store<(D + 1) * L>(acc, partials, G);
}

template <int NW, int K>
__global__ void __launch_bounds__(THREADS)
fold_kernel(const uint32_t* in, int64_t in_fac, int64_t in_stride, uint32_t* out, int64_t out_fac,
            int64_t out_stride, int64_t half, const uint32_t* rp, FieldParams<NW> fp) {
  uint32_t r[NW];
  load_scalar<NW>(r, rp, 1, 0);
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < half;
       e += (int64_t)gridDim.x * blockDim.x) {
#pragma unroll
    for (int t = 0; t < K; ++t) {
      uint32_t a[NW], b[NW];
      load_elem<NW>(a, in + t * in_fac, in_stride, e);
      load_elem<NW>(b, in + t * in_fac, in_stride, e + half);
      lerp<NW>(a, a, b, r, fp);
      store_elem<NW>(out + t * out_fac, out_stride, e, a);
    }
  }
}

// Two product terms of K0 and K1 factors (rows [0, K0) and [K0, K0 + K1)
// of the stack): per pair, sum over the terms of the product of their
// factors at each point 0..D, into the same accumulators.
//
// Design (measured: PERF.md, scripts/probe_round_sums_terms.py): block
// (g, t) sums chunk g of the pairs at point t alone, so a thread keeps
// only its point's L limb accumulators (the unrolled all-points kernel
// held (D + 1) L of them and every factor of a pair: 183 registers, one
// block an SM), and 256-thread blocks of several chunks and points share
// an SM and hide each other's loads and barriers.  Point 0 reads the left
// halves, point 1 the right ones, a point t >= 2 both, and reaches its
// value by adding the difference, right + (t - 1) (right - left) mod p:
// the fully reduced representative of the lerp at t, with no product.
// So a pair costs (K - 2) (D + 1) products, 6 at (2, (2, 2)) against the
// 10 of a lerp per point.  The factors are a runtime loop (one inlined
// Montgomery product).  The D + 1 blocks of a chunk are neighbours and
// read the same elements: the repeats hit L2, HBM moves each element
// once.  Thread s adds the pairs s, s + THREADS, ... of its chunk, as the
// wrapper's accumulator bound (partition) assumes.
constexpr int RST_MIN_BLOCKS = 3;

template <int NW, int D, int K0, int K1>
__global__ void __launch_bounds__(THREADS, RST_MIN_BLOCKS)
round_sums_terms_kernel(const uint32_t* stack, int64_t fac_stride, int64_t row_stride,
                        int64_t half, int64_t chunk, FieldParams<NW> fp,
                        unsigned long long* partials, int G) {
  constexpr int L = 2 * NW;
  constexpr int K = K0 + K1;
  const int pt = blockIdx.x % (D + 1);
  const int64_t g = blockIdx.x / (D + 1);
  uint32_t acc[L];
#pragma unroll
  for (int k = 0; k < L; ++k) acc[k] = 0;
  const int64_t beg = g * chunk;
  const int64_t end = beg + chunk < half ? beg + chunk : half;
  for (int64_t e = beg + threadIdx.x; e < end; e += THREADS) {
    uint32_t prod[NW];
#pragma unroll 1
    for (int j = 0; j < K; ++j) {
      const uint32_t* f = stack + j * fac_stride;
      uint32_t left[NW], ev[NW];
      if (pt != 1) load_elem<NW>(left, f, row_stride, e);
      if (pt != 0) load_elem<NW>(ev, f, row_stride, e + half);
      if (pt == 0) {
#pragma unroll
        for (int w = 0; w < NW; ++w) ev[w] = left[w];
      } else if (pt >= 2) {
        sub_mod<NW>(left, ev, left, fp);  // right - left
#pragma unroll 1
        for (int t = 1; t < pt; ++t) add_mod<NW>(ev, ev, left, fp);
      }
      if (j == 0 || j == K0) {
#pragma unroll
        for (int w = 0; w < NW; ++w) prod[w] = ev[w];
      } else {
        mont_mul<NW>(prod, prod, ev, fp);
      }
      if (j == K0 - 1 || j == K - 1) acc_limbs<NW>(acc, prod);  // a term is complete
    }
  }
  block_reduce_store<L>(acc, partials + (int64_t)pt * L * G, G, g);
}

template <int NW>
int fold_multi_nw(int f, const uint32_t* in, int64_t in_stride, uint32_t* out,
                  int64_t out_stride, int64_t out_n, const uint32_t* rs, const uint32_t* params,
                  cudaStream_t s) {
  const FieldParams<NW> fp = load_params<NW>(params);
  const int grid = grid_for(out_n, THREADS);
  switch (f) {
    case 1: fold_multi_kernel<NW, 1><<<grid, THREADS, 0, s>>>(in, in_stride, out, out_stride, out_n, rs, fp); break;
    case 2: fold_multi_kernel<NW, 2><<<grid, THREADS, 0, s>>>(in, in_stride, out, out_stride, out_n, rs, fp); break;
    case 3: fold_multi_kernel<NW, 3><<<grid, THREADS, 0, s>>>(in, in_stride, out, out_stride, out_n, rs, fp); break;
    case 4: fold_multi_kernel<NW, 4><<<grid, THREADS, 0, s>>>(in, in_stride, out, out_stride, out_n, rs, fp); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}

template <int NW, int D, int K>
int round_sums_launch(const uint32_t* stack, int64_t fac_stride, int64_t row_stride,
                      int64_t half, int64_t chunk, int G, const FieldParams<NW>& fp,
                      unsigned long long* partials, cudaStream_t s) {
  round_sums_kernel<NW, D, K><<<G, THREADS, 0, s>>>(stack, fac_stride, row_stride, half, chunk,
                                                     fp, partials, G);
  return (int)cudaGetLastError();
}

template <int NW>
int round_sums_nw(int D, int K, const uint32_t* stack, int64_t fac_stride, int64_t row_stride,
                  int64_t half, int64_t chunk, int G, const uint32_t* params,
                  unsigned long long* partials, cudaStream_t s) {
  const FieldParams<NW> fp = load_params<NW>(params);
#define ZK_RS(d, k)                                                                      \
  if (D == d && K == k)                                                                  \
    return round_sums_launch<NW, d, k>(stack, fac_stride, row_stride, half, chunk, G, fp, \
                                       partials, s);
  ZK_RS(1, 1) ZK_RS(2, 1) ZK_RS(2, 2) ZK_RS(3, 1) ZK_RS(3, 2) ZK_RS(3, 3)
#undef ZK_RS
  return -1;
}

template <int NW>
int fold_nw(int K, const uint32_t* in, int64_t in_fac, int64_t in_stride, uint32_t* out,
            int64_t out_fac, int64_t out_stride, int64_t half, const uint32_t* r,
            const uint32_t* params, cudaStream_t s) {
  const FieldParams<NW> fp = load_params<NW>(params);
  const int grid = grid_for(half, THREADS);
#define ZK_FOLD(k)                                                                           \
  case k:                                                                                    \
    fold_kernel<NW, k><<<grid, THREADS, 0, s>>>(in, in_fac, in_stride, out, out_fac, out_stride, \
                                               half, r, fp);                                 \
    break;
  switch (K) {
    ZK_FOLD(1) ZK_FOLD(2) ZK_FOLD(3) ZK_FOLD(4) ZK_FOLD(5)
    default: return -1;
  }
#undef ZK_FOLD
  return (int)cudaGetLastError();
}

template <int NW>
int round_sums_terms_nw(int D, int K0, int K1, const uint32_t* stack, int64_t fac_stride,
                        int64_t row_stride, int64_t half, int64_t chunk, int G,
                        const uint32_t* params, unsigned long long* partials, cudaStream_t s) {
  const FieldParams<NW> fp = load_params<NW>(params);
#define ZK_RST(d, a, b)                                                                     \
  if (D == d && K0 == a && K1 == b) {                                                       \
    round_sums_terms_kernel<NW, d, a, b><<<G * (d + 1), THREADS, 0, s>>>(stack, fac_stride, row_stride, \
                                                               half, chunk, fp, partials, G); \
    return (int)cudaGetLastError();                                                         \
  }
  ZK_RST(2, 2, 1) ZK_RST(2, 2, 2) ZK_RST(2, 2, 3)
#undef ZK_RST
  return -1;
}

}  // namespace

extern "C" {

// Fold f MSB variables: out[e] = tree-lerp of in[e + j * out_n], j < 2^f.
// rs: (L, f) Montgomery limbs on the device.  Returns cudaGetLastError(),
// or -1 for an unsupported (L, f).
int zk_fold_multi(int L, int f, const void* in, int64_t in_stride, void* out, int64_t out_stride,
                  int64_t out_n, const void* rs, const void* params, void* stream) {
  auto s = (cudaStream_t)stream;
  auto i = (const uint32_t*)in;
  auto o = (uint32_t*)out;
  auto r = (const uint32_t*)rs;
  auto p = (const uint32_t*)params;
  if (L == 4) return fold_multi_nw<2>(f, i, in_stride, o, out_stride, out_n, r, p, s);
  if (L == 16) return fold_multi_nw<8>(f, i, in_stride, o, out_stride, out_n, r, p, s);
  return -1;
}

// Fused degree-1 round: out[e] = lerp(in[e], in[e + half], r) for e < half,
// and the (2, L, G) u64 partial limb sums of out[0, half/2) and
// out[half/2, half).  Block b owns e in [b * chunk, (b + 1) * chunk).
int zk_fold_halfsums(int L, const void* in, int64_t in_stride, void* out, int64_t out_stride,
                     int64_t half, int64_t chunk, int G, const void* r, const void* params,
                     void* partials, void* stream) {
  auto s = (cudaStream_t)stream;
  auto i = (const uint32_t*)in;
  auto o = (uint32_t*)out;
  auto rp = (const uint32_t*)r;
  auto acc = (unsigned long long*)partials;
  if (L == 4) {
    fold_halfsums_kernel<2><<<G, THREADS, 0, s>>>(i, in_stride, o, out_stride, half, chunk, rp,
                                                  load_params<2>((const uint32_t*)params), acc, G);
  } else if (L == 16) {
    fold_halfsums_kernel<8><<<G, THREADS, 0, s>>>(i, in_stride, o, out_stride, half, chunk, rp,
                                                  load_params<8>((const uint32_t*)params), acc, G);
  } else {
    return -1;
  }
  return (int)cudaGetLastError();
}

// Round-polynomial sums of a K-factor product at the points 0..D over the
// pairs (e, e + half): (D+1, L, G) u64 partial limb sums.
int zk_round_sums(int L, int D, int K, const void* stack, int64_t fac_stride,
                  int64_t row_stride, int64_t half, int64_t chunk, int G, const void* params,
                  void* partials, void* stream) {
  auto s = (cudaStream_t)stream;
  auto st = (const uint32_t*)stack;
  auto p = (const uint32_t*)params;
  auto acc = (unsigned long long*)partials;
  if (L == 4) return round_sums_nw<2>(D, K, st, fac_stride, row_stride, half, chunk, G, p, acc, s);
  if (L == 16) return round_sums_nw<8>(D, K, st, fac_stride, row_stride, half, chunk, G, p, acc, s);
  return -1;
}

// Fold all K factors of a stack at r: out[t][e] = lerp(in[t][e], in[t][e + half], r)
// for e < half.  in_fac / out_fac: words between factors; out may be in.
int zk_fold(int L, int K, const void* in, int64_t in_fac, int64_t in_stride, void* out,
            int64_t out_fac, int64_t out_stride, int64_t half, const void* r, const void* params,
            void* stream) {
  auto s = (cudaStream_t)stream;
  auto i = (const uint32_t*)in;
  auto o = (uint32_t*)out;
  auto rp = (const uint32_t*)r;
  auto p = (const uint32_t*)params;
  if (L == 4) return fold_nw<2>(K, i, in_fac, in_stride, o, out_fac, out_stride, half, rp, p, s);
  if (L == 16) return fold_nw<8>(K, i, in_fac, in_stride, o, out_fac, out_stride, half, rp, p, s);
  return -1;
}

// Round-polynomial sums of a two-term sum of products (K0 + K1 factor
// rows) at the points 0..D: (D+1, L, G) u64 partial limb sums.
int zk_round_sums_terms(int L, int D, int K0, int K1, const void* stack, int64_t fac_stride,
                        int64_t row_stride, int64_t half, int64_t chunk, int G, const void* params,
                        void* partials, void* stream) {
  auto s = (cudaStream_t)stream;
  auto st = (const uint32_t*)stack;
  auto p = (const uint32_t*)params;
  auto acc = (unsigned long long*)partials;
  if (L == 4)
    return round_sums_terms_nw<2>(D, K0, K1, st, fac_stride, row_stride, half, chunk, G, p, acc, s);
  if (L == 16)
    return round_sums_terms_nw<8>(D, K0, K1, st, fac_stride, row_stride, half, chunk, G, p, acc, s);
  return -1;
}

}  // extern "C"
