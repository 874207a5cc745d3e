// Keccak-f[1600] on one warp: lane i < 25 holds the 64-bit sponge lane i.
//
// Shared by keccak.cu (the permutation kernel) and transcript.cu (the
// whole Fiat-Shamir round of the sumcheck prover).  Hopper has native
// 64-bit XOR/AND and funnel-shift rotates, so the reference's (lo, hi)
// 32-bit split is only the storage format at the tensor boundary.
#pragma once

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

// One warp runs one permutation: lane i < 25 holds lane A[i] (i = x + 5y),
// lanes 25..31 ride along; every step that mixes lanes is a shuffle
// (theta's column parities 5 and 2, rho-pi 1, chi 2 a round).  A
// permutation held by one thread would be a chain of ~6k dependent 32-bit
// ops; the warp's is 24 rounds of ~10 shuffles and ~10 ops.
struct KeccakLane {
  int col[5];    // the lanes of this lane's column x: x + 5y'
  int cm1, cp1;  // (x - 1) mod 5 and (x + 1) mod 5: the parities theta reads
  int rot, src;  // this lane's rho offset; the lane pi moves here
  int row1, row2;  // (x + 1) mod 5 + 5y and (x + 2) mod 5 + 5y: chi's operands
};

__device__ __forceinline__ KeccakLane keccak_lane(int lane) {
  constexpr int kRot[25] = {0, 1, 62, 28, 27, 36, 44, 6, 55, 20, 3, 10, 43,
                            25, 39, 41, 45, 15, 21, 8, 18, 2, 61, 56, 14};  // by x + 5y
  KeccakLane k;
  const int x = lane % 5, y = lane / 5;
  for (int j = 0; j < 5; ++j) k.col[j] = x + 5 * j;
  k.cm1 = (x + 4) % 5;
  k.cp1 = (x + 1) % 5;
  k.rot = lane < 25 ? kRot[lane] : 0;
  k.src = 0;
  for (int i = 0; i < 25; ++i)  // pi: A[x' + 5y'] goes to lane y' + 5 ((2x' + 3y') mod 5)
    if ((i / 5) + 5 * ((2 * (i % 5) + 3 * (i / 5)) % 5) == lane) k.src = i;
  k.row1 = (x + 1) % 5 + 5 * y;
  k.row2 = (x + 2) % 5 + 5 * y;
  return k;
}

// Every lane of the warp must call this (full-mask shuffles).
__device__ __forceinline__ uint64_t keccak_f1600_warp(uint64_t a, const KeccakLane& k, int lane) {
  constexpr unsigned FULL = 0xFFFFFFFFu;
#pragma unroll 1
  for (int round = 0; round < 24; ++round) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 5; ++j) c ^= __shfl_sync(FULL, a, k.col[j]);
    a ^= __shfl_sync(FULL, c, k.cm1) ^ rotl(__shfl_sync(FULL, c, k.cp1), 1);
    const uint64_t b = __shfl_sync(FULL, rotl(a, k.rot), k.src);
    a = b ^ (~__shfl_sync(FULL, b, k.row1) & __shfl_sync(FULL, b, k.row2));
    if (lane == 0) a ^= kRC[round];
  }
  return a;
}

}  // namespace
