// Keccak-f[1600] for the on-device Fiat-Shamir transcript.
//
// Replaces zk_tpu/transcript/device.py::_rounds_kernel_pallas (all 24
// rounds unrolled on 25 (lo, hi) 32-bit lane halves in SMEM).  Here one
// thread holds the 25 lanes as uint64_t in registers: Hopper has native
// 64-bit XOR/AND and funnel-shift rotates, so the (lo, hi) split is only
// the storage format at the boundary (int64 tensors holding values < 2^32,
// the layout of the reference's public functions).
//
// What bounds it on this card: launch latency.  The sumcheck prover runs
// one permutation per round, on the critical path between two table
// kernels; the permutation itself is ~2k integer ops in one thread
// (~microseconds).  The design keeps it to a single launch per
// permutation; batching several states (one thread each) is supported for
// testing.  Removing the launch cost (CUDA graphs) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__constant__ uint64_t kRC[24] = {
    0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808Aull, 0x8000000080008000ull,
    0x000000000000808Bull, 0x0000000080000001ull, 0x8000000080008081ull, 0x8000000000008009ull,
    0x000000000000008Aull, 0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000Aull,
    0x000000008000808Bull, 0x800000000000008Bull, 0x8000000000008089ull, 0x8000000000008003ull,
    0x8000000000008002ull, 0x8000000000000080ull, 0x000000000000800Aull, 0x800000008000000Aull,
    0x8000000080008081ull, 0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull,
};

__device__ __forceinline__ uint64_t rotl(uint64_t v, int n) {
  return n == 0 ? v : (v << n) | (v >> (64 - n));
}

__global__ void keccak_f1600_kernel(const int64_t* lo, const int64_t* hi, int64_t* olo,
                                    int64_t* ohi, int n) {
  // rho offsets r[x][y] for lane A[x + 5y] (zk_tpu/transcript/keccak.py::_ROT)
  constexpr int kRot[5][5] = {
      {0, 36, 3, 41, 18}, {1, 44, 10, 45, 2}, {62, 6, 43, 15, 61},
      {28, 55, 25, 21, 56}, {27, 20, 39, 8, 14},
  };
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n) return;
  uint64_t a[25];
#pragma unroll
  for (int i = 0; i < 25; ++i)
    a[i] = (uint64_t)(uint32_t)lo[s * 25 + i] | ((uint64_t)(uint32_t)hi[s * 25 + i] << 32);
#pragma unroll 1
  for (int round = 0; round < 24; ++round) {
    uint64_t c[5], b[25];
#pragma unroll
    for (int x = 0; x < 5; ++x) c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
#pragma unroll
    for (int x = 0; x < 5; ++x) {
      const uint64_t d = c[(x + 4) % 5] ^ rotl(c[(x + 1) % 5], 1);
#pragma unroll
      for (int y = 0; y < 5; ++y) a[x + 5 * y] ^= d;
    }
#pragma unroll
    for (int x = 0; x < 5; ++x)
#pragma unroll
      for (int y = 0; y < 5; ++y) b[y + 5 * ((2 * x + 3 * y) % 5)] = rotl(a[x + 5 * y], kRot[x][y]);
#pragma unroll
    for (int y = 0; y < 5; ++y)
#pragma unroll
      for (int x = 0; x < 5; ++x)
        a[x + 5 * y] = b[x + 5 * y] ^ (~b[(x + 1) % 5 + 5 * y] & b[(x + 2) % 5 + 5 * y]);
    a[0] ^= kRC[round];
  }
#pragma unroll
  for (int i = 0; i < 25; ++i) {
    olo[s * 25 + i] = (int64_t)(a[i] & 0xFFFFFFFFull);
    ohi[s * 25 + i] = (int64_t)(a[i] >> 32);
  }
}

}  // namespace

extern "C" {

// n states of 25 lanes: lo/hi (n, 25) int64 holding the 32-bit halves.
int zk_keccak_f1600(const void* lo, const void* hi, void* olo, void* ohi, int n, void* stream) {
  const int threads = 32;
  const int blocks = (n + threads - 1) / threads;
  keccak_f1600_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)lo, (const int64_t*)hi, (int64_t*)olo, (int64_t*)ohi, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
