// Elementwise field kernels: mont_mul and lerp.
//
// Replace the Pallas kernels of zk_tpu/fields/pallas_kernels.py:
//   mont_mul <- mont_mul_pallas (the NTT's twiddle multiply, and the
//               pointwise product of UnivariatePolynomial's NTT route)
//   lerp     <- lerp_pallas     (the fold step left - r (left - right) at
//               one scalar r)
//
// Layout: (L, n) 16-bit limbs in 32-bit words, limb axis first; an element
// is NW = L/2 words in registers (csrc/field.cuh).  Any n: the TPU's
// 1024-lane blocks (n % 1024 == 0) are gone, a grid-stride loop covers the
// ragged end.
//
// What bounds them on an H100: memory.  mont_mul reads two elements and
// writes one (3 * 64 bytes at L = 16) for one Montgomery product (256
// 32-bit multiply-adds counted as IMAD issue slots: 0.0153 ns per element
// on 132 SMs against 0.057 ns for the bytes at 3.35 TB/s); lerp moves the
// same bytes for one product and two modular subtractions.  Design: one
// thread per element and a grid-stride loop, neighbouring threads on
// neighbouring words of each limb row (coalesced 128-byte lines), all limb
// math unrolled in registers; nothing is shared between threads.

#include <cuda_runtime.h>
#include <stdint.h>

#include "field.cuh"

namespace {

constexpr int THREADS = 256;

template <int NW>
__global__ void __launch_bounds__(THREADS)
mont_mul_kernel(const uint32_t* a, const uint32_t* b, uint32_t* out, int64_t n,
                FieldParams<NW> fp) {
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (int64_t)gridDim.x * blockDim.x) {
    uint32_t x[NW], y[NW];
    load_elem<NW>(x, a, n, e);
    load_elem<NW>(y, b, n, e);
    mont_mul<NW>(x, x, y, fp);
    store_elem<NW>(out, n, e, x);
  }
}

template <int NW>
__global__ void __launch_bounds__(THREADS)
lerp_kernel(const uint32_t* left, const uint32_t* right, const uint32_t* rp, uint32_t* out,
            int64_t n, FieldParams<NW> fp) {
  uint32_t r[NW];
  load_scalar<NW>(r, rp, 1, 0);
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (int64_t)gridDim.x * blockDim.x) {
    uint32_t x[NW], y[NW];
    load_elem<NW>(x, left, n, e);
    load_elem<NW>(y, right, n, e);
    lerp<NW>(x, x, y, r, fp);
    store_elem<NW>(out, n, e, x);
  }
}

template <int NW>
int mont_mul_nw(const uint32_t* a, const uint32_t* b, uint32_t* out, int64_t n,
                const uint32_t* params, cudaStream_t s) {
  mont_mul_kernel<NW><<<grid_for(n, THREADS), THREADS, 0, s>>>(a, b, out, n, load_params<NW>(params));
  return (int)cudaGetLastError();
}

template <int NW>
int lerp_nw(const uint32_t* left, const uint32_t* right, const uint32_t* r, uint32_t* out,
            int64_t n, const uint32_t* params, cudaStream_t s) {
  lerp_kernel<NW><<<grid_for(n, THREADS), THREADS, 0, s>>>(left, right, r, out, n,
                                                           load_params<NW>(params));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out = a * b * R^-1 mod p elementwise over (L, n) limbs; out may be a or b.
// Returns cudaGetLastError(), or -1 for an unsupported L.
int zk_mont_mul(int L, const void* a, const void* b, void* out, int64_t n, const void* params,
                void* stream) {
  auto s = (cudaStream_t)stream;
  auto x = (const uint32_t*)a;
  auto y = (const uint32_t*)b;
  auto o = (uint32_t*)out;
  auto p = (const uint32_t*)params;
  if (L == 4) return mont_mul_nw<2>(x, y, o, n, p, s);
  if (L == 16) return mont_mul_nw<8>(x, y, o, n, p, s);
  return -1;
}

// out = left - r * (left - right) elementwise over (L, n) limbs; r is an
// (L, 1) Montgomery scalar on the device; out may be left or right.
int zk_lerp(int L, const void* left, const void* right, const void* r, void* out, int64_t n,
            const void* params, void* stream) {
  auto s = (cudaStream_t)stream;
  auto x = (const uint32_t*)left;
  auto y = (const uint32_t*)right;
  auto rp = (const uint32_t*)r;
  auto o = (uint32_t*)out;
  auto p = (const uint32_t*)params;
  if (L == 4) return lerp_nw<2>(x, y, rp, o, n, p, s);
  if (L == 16) return lerp_nw<8>(x, y, rp, o, n, p, s);
  return -1;
}

}  // extern "C"
