// Keccak-f[1600] for the on-device Fiat-Shamir transcript.
//
// Replaces zk_tpu/transcript/device.py::_rounds_kernel_pallas (all 24
// rounds unrolled on 25 (lo, hi) 32-bit lane halves in SMEM).  Here one
// warp runs a state, one 64-bit sponge lane a thread (keccak.cuh).
//
// What bounds it on this card: launch latency; the permutation itself is
// 24 rounds of ~10 shuffles (~microseconds).  The sumcheck rounds no
// longer launch it: transcript.cu runs their whole Fiat-Shamir round in
// one launch.  The GKR chain's claim binds and line steps still absorb
// and squeeze through it, one launch a permutation; batching several
// states (one warp each) is supported for testing.

#include <cuda_runtime.h>
#include <stdint.h>

#include "keccak.cuh"

namespace {

constexpr int WARPS = 4;  // states a block

__global__ void keccak_f1600_kernel(const int64_t* lo, const int64_t* hi, int64_t* olo,
                                    int64_t* ohi, int n) {
  const int lane = threadIdx.x % 32;
  const int s = blockIdx.x * WARPS + threadIdx.x / 32;
  if (s >= n) return;  // the whole warp: the shuffles need all 32 lanes
  const int i = s * 25 + lane;
  uint64_t a = lane < 25 ? (uint64_t)(uint32_t)lo[i] | ((uint64_t)(uint32_t)hi[i] << 32) : 0;
  a = keccak_f1600_warp(a, keccak_lane(lane), lane);
  if (lane < 25) {
    olo[i] = (int64_t)(a & 0xFFFFFFFFull);
    ohi[i] = (int64_t)(a >> 32);
  }
}

}  // namespace

extern "C" {

// n states of 25 lanes: lo/hi (n, 25) int64 holding the 32-bit halves.
int zk_keccak_f1600(const void* lo, const void* hi, void* olo, void* ohi, int n, void* stream) {
  const int blocks = (n + WARPS - 1) / WARPS;
  keccak_f1600_kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const int64_t*)lo, (const int64_t*)hi, (int64_t*)olo, (int64_t*)ohi, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
