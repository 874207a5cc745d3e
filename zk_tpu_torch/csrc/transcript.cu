// The sumcheck prover's Fiat-Shamir round in one launch.
//
// Redesigns, for this card, what zk_tpu/transcript/device.py's
// _rounds_kernel_pallas (Keccak-f[1600]) is part of on the TPU: JAX jits
// the whole round (zk_tpu/sumcheck/capacity.py _transcript_round_cap,
// _deg1_round_cap, _fused_round_cap) into one program around the Pallas
// permutation.  The port ran the round as ~5.5k torch ops a round (canon
// sums, renorm, serialization, absorb, squeeze, challenge); here it is one
// kernel, so a device round of the prover is two launches: this one and
// the table kernel that folds at the challenge it writes.
//
// One block of 512 threads:
//   1. the block adds the G <= 1024 u64 partials that the table kernels
//      wrote ((P, L, G), P = D + 1 <= 4), eight (point, limb) columns at a
//      time, each thread loading its one or two partials of each of the
//      eight at once;
//   2. thread pt carries point pt's 16-bit-weighted columns into a wide
//      integer V (a sum of Montgomery representatives), Montgomery-reduces
//      it (V R^-1 mod p, the canonical round sum, as
//      fields.device.renorm_wide) and writes its limbs and its big-endian
//      bytes behind the sponge's pending bytes in shared memory;
//   3. warp 0, one sponge lane a thread (keccak.cuh keccak_f1600_warp),
//      absorbs the bytes (at most one full block: pos < 136 and
//      P * n_bytes <= 128), pads and permutes for the digest (0x01 ... 0x80,
//      or 0x81 alone at pos = 135, as transcript.device.squeeze);
//   4. thread 0 maps the digest to the challenge (from_be_bytes_mod_order,
//      in Montgomery and canonical form), and the block writes the reset
//      sponge that holds only the digest (transcript.device.sample_challenge:
//      pos becomes 32).
//
// What bounds it: latency, not bytes or operations.  The partials are at
// most 4 * 16 * 1024 * 8 = 512 KiB; then come one or two permutations
// (two when the absorb fills a block) and a few Montgomery products on one
// warp.  A permutation held by one thread would be a chain of ~6k
// dependent 32-bit ops; in a warp it is 24 rounds of ~10 shuffles.

#include <cuda_runtime.h>
#include <stdint.h>

#include "field.cuh"
#include "keccak.cuh"

namespace {

constexpr int RATE = 136;
constexpr int DIGEST = 32;
constexpr int MAX_POINTS = 4;  // D + 1, D <= 3
constexpr int THREADS = 512;
constexpr int GROUP = 8;  // columns summed together
constexpr int MAX_G = 1024;

template <int NW>
struct RoundParams {
  FieldParams<NW> fp;
  uint32_t r2[NW];  // R^2 mod p
};

// Host layout: field.cuh's parameter block, then R^2 mod p (NW words).
template <int NW>
inline RoundParams<NW> load_round_params(const uint32_t* host) {
  RoundParams<NW> rp;
  rp.fp = load_params<NW>(host);
  for (int w = 0; w < NW; ++w) rp.r2[w] = host[NW + 1 + 4 * NW + w];
  return rp;
}

// V (2 NW + 1 words, V < p R) -> V R^-1 mod p, fully reduced (REDC).
template <int NW>
__device__ __forceinline__ void redc_wide(uint32_t out[NW], uint32_t t[2 * NW + 1],
                                          const FieldParams<NW>& fp) {
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint32_t m = t[i] * fp.pinv;
    unsigned long long c = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      c += (unsigned long long)m * fp.p[j] + t[i + j];
      t[i + j] = (uint32_t)c;
      c >>= 32;
    }
#pragma unroll
    for (int j = i + NW; j < 2 * NW + 1; ++j) {
      c += t[j];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
  }
  // t[NW..2NW] < 2p: one conditional subtract
  uint32_t d[NW];
  uint32_t borrow = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const unsigned long long s = (unsigned long long)t[NW + w] - fp.p[w] - borrow;
    d[w] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  const bool ge = t[2 * NW] != 0 || borrow == 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) out[w] = ge ? d[w] : t[NW + w];
}

// Eight bytes as a little-endian word (a sponge lane's share of a block).
__device__ __forceinline__ uint64_t le_word(const uint8_t* b) {
  uint64_t v = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) v |= (uint64_t)b[i] << (8 * i);
  return v;
}

template <int NW>
__global__ void __launch_bounds__(THREADS, 1)
transcript_round_kernel(const unsigned long long* partials, int P, int G, const int64_t* lo,
                        const int64_t* hi, const int64_t* buf, int pos, RoundParams<NW> rp,
                        int64_t* out_lo, int64_t* out_hi, int64_t* out_buf, int32_t* total,
                        int32_t* ch_canon, int32_t* ch_mont) {
  constexpr int L = 2 * NW;
  constexpr int NB = 4 * NW;  // bytes of one canonical element
  __shared__ unsigned long long cols[MAX_POINTS * L];
  __shared__ unsigned long long red[THREADS / 32][GROUP];
  __shared__ uint8_t msg[RATE + MAX_POINTS * NB];
  __shared__ uint8_t digest[DIGEST];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // 1. column c = (pt, j): the sum over g of partials[pt][j][g]
  for (int i = threadIdx.x; i < pos; i += THREADS) msg[i] = (uint8_t)buf[i];
  for (int c0 = 0; c0 < P * L; c0 += GROUP) {
    unsigned long long v[GROUP];
#pragma unroll
    for (int q = 0; q < GROUP; ++q) {
      v[q] = 0;
#pragma unroll
      for (int i = 0; i < MAX_G / THREADS; ++i) {
        const int g = threadIdx.x + i * THREADS;
        if (c0 + q < P * L && g < G) v[q] += partials[(int64_t)(c0 + q) * G + g];
      }
    }
#pragma unroll
    for (int q = 0; q < GROUP; ++q) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v[q] += __shfl_down_sync(0xFFFFFFFFu, v[q], off);
      if (lane == 0) red[warp][q] = v[q];
    }
    __syncthreads();
    if (threadIdx.x < GROUP && c0 + threadIdx.x < P * L) {
      unsigned long long s = 0;
      for (int w = 0; w < THREADS / 32; ++w) s += red[w][threadIdx.x];
      cols[c0 + threadIdx.x] = s;
    }
    __syncthreads();
  }

  // 2. point pt: V = sum_j cols[pt][j] 2^(16 j), canonical V R^-1 mod p
  if (threadIdx.x < P) {
    const int pt = threadIdx.x;
    uint32_t t[2 * NW + 1], v[NW];
    unsigned long long carry = 0;  // columns < 2^56: the carry stays < 2^57
#pragma unroll
    for (int w = 0; w < 2 * NW + 1; ++w) {
      uint32_t word = 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (2 * w + h < L) carry += cols[pt * L + 2 * w + h];
        word |= (uint32_t)(carry & 0xFFFFu) << (16 * h);
        carry >>= 16;
      }
      t[w] = word;
    }
    redc_wide<NW>(v, t, rp.fp);
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      total[(2 * w) * P + pt] = (int32_t)(v[w] & 0xFFFFu);
      total[(2 * w + 1) * P + pt] = (int32_t)(v[w] >> 16);
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const int q = NB - 1 - b;  // byte significance: big-endian
      msg[pos + pt * NB + b] = (uint8_t)(v[q / 4] >> (8 * (q % 4)));
    }
  }
  __syncthreads();

  // 3. absorb and squeeze: warp 0, lane i holding sponge lane i
  if (warp == 0) {
    const KeccakLane kl = keccak_lane(lane);
    uint64_t a = lane < 25 ? (uint64_t)(uint32_t)lo[lane] | ((uint64_t)(uint32_t)hi[lane] << 32) : 0;
    const int len = pos + P * NB;
    int off = 0;
    for (; off + RATE <= len; off += RATE) {
      if (lane < RATE / 8) a ^= le_word(msg + off + 8 * lane);
      a = keccak_f1600_warp(a, kl, lane);
    }
    // the padded copy for the digest: 0x01 at rem, 0x80 at RATE - 1 (at
    // rem = RATE - 1 the two meet: 0x81)
    const int rem = len - off;
    if (lane < RATE / 8) {
      uint64_t v = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int b = 8 * lane + i;
        uint32_t byte = b < rem ? msg[off + b] : 0;
        byte ^= (b == rem ? 0x01u : 0u) ^ (b == RATE - 1 ? 0x80u : 0u);
        v |= (uint64_t)byte << (8 * i);
      }
      a ^= v;
    }
    a = keccak_f1600_warp(a, kl, lane);
    if (lane < DIGEST / 8) {
#pragma unroll
      for (int i = 0; i < 8; ++i) digest[8 * lane + i] = (uint8_t)(a >> (8 * i));
    }
  }
  __syncthreads();

  // the challenge
  if (threadIdx.x == 0) {
    // X = the digest as a big-endian integer, X R mod p by Horner over
    // NW-word chunks: acc <- acc R + chunk, in Montgomery form
    uint32_t acc[NW], x[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) acc[w] = 0;
#pragma unroll 1
    for (int c = 0; c < DIGEST / (4 * NW); ++c) {
#pragma unroll
      for (int w = 0; w < NW; ++w) {  // word w of the chunk, least significant first
        const int b = 4 * NW * (c + 1) - 4 * (w + 1);
        x[w] = ((uint32_t)digest[b] << 24) | ((uint32_t)digest[b + 1] << 16) |
               ((uint32_t)digest[b + 2] << 8) | digest[b + 3];
      }
      if (c > 0) mont_mul<NW>(acc, acc, rp.r2, rp.fp);  // (A R) R^2 R^-1 = (A R) R
      mont_mul<NW>(x, rp.r2, x, rp.fp);      // chunk R mod p (chunk < R, R^2 mod p < p)
      add_mod<NW>(acc, acc, x, rp.fp);
    }
    uint32_t one[NW], canon[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) one[w] = w == 0;
    mont_mul<NW>(canon, acc, one, rp.fp);
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      ch_mont[2 * w] = (int32_t)(acc[w] & 0xFFFFu);
      ch_mont[2 * w + 1] = (int32_t)(acc[w] >> 16);
      ch_canon[2 * w] = (int32_t)(canon[w] & 0xFFFFu);
      ch_canon[2 * w + 1] = (int32_t)(canon[w] >> 16);
    }
  }
  __syncthreads();

  // the reset sponge holding the digest (pos 32)
  for (int i = threadIdx.x; i < RATE; i += THREADS) out_buf[i] = i < DIGEST ? digest[i] : 0;
  if (threadIdx.x < 25) {
    out_lo[threadIdx.x] = 0;
    out_hi[threadIdx.x] = 0;
  }
}

}  // namespace

extern "C" {

// One Fiat-Shamir round: partials (P, L, G) u64, sponge lo/hi (25,) and
// buf (136,) int64 with pos pending bytes; writes the reset sponge, the
// canonical round sums (L, P), the challenge (L, 1) canonical and
// Montgomery (int32 limbs).  params: field.cuh's block then R^2 mod p.
int zk_transcript_round(int L, const void* partials, int P, int G, const void* lo, const void* hi,
                        const void* buf, int pos, const void* params, void* out_lo, void* out_hi,
                        void* out_buf, void* total, void* ch_canon, void* ch_mont, void* stream) {
  if (P < 1 || P > MAX_POINTS || G < 1 || G > MAX_G || pos < 0 || pos >= RATE) return -1;
  auto s = (cudaStream_t)stream;
  auto pa = (const unsigned long long*)partials;
  auto l = (const int64_t*)lo;
  auto h = (const int64_t*)hi;
  auto b = (const int64_t*)buf;
  auto hp = (const uint32_t*)params;
  if (L == 4) {
    transcript_round_kernel<2><<<1, THREADS, 0, s>>>(pa, P, G, l, h, b, pos, load_round_params<2>(hp),
        (int64_t*)out_lo, (int64_t*)out_hi, (int64_t*)out_buf, (int32_t*)total, (int32_t*)ch_canon,
        (int32_t*)ch_mont);
  } else if (L == 16) {
    transcript_round_kernel<8><<<1, THREADS, 0, s>>>(pa, P, G, l, h, b, pos, load_round_params<8>(hp),
        (int64_t*)out_lo, (int64_t*)out_hi, (int64_t*)out_buf, (int32_t*)total, (int32_t*)ch_canon,
        (int32_t*)ch_mont);
  } else {
    return -1;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
