/* Keccak-256 (original Keccak padding 0x01, rate 136) — native backend.
 *
 * Streaming hasher with the finalize_reset semantics the Fiat-Shamir
 * transcript needs (transcript/src/lib.rs:20-25: digest everything
 * absorbed so far, reset, caller re-absorbs the digest).  The Python
 * tier (zk_tpu_torch/transcript/keccak.py) is the reference
 * implementation; this one exists for the O(2^n)-byte absorptions
 * (SumcheckProver.prove binds the full table, prover.rs:17; the GKR
 * prover and verifier bind the whole output layer) where pure Python
 * would bottleneck.  A copy of zk_tpu/native/keccak.c.
 *
 * Host code: built with the system C compiler at first use
 * (zk_tpu_torch/transcript/native.py), apart from the CUDA kernels, and
 * exposed as a plain C ABI consumed via ctypes.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define RATE 136
#define ROUNDS 24

static const uint64_t RC[ROUNDS] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
    0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};

/* rotation offsets r[x][y] for lane A[x, y] (same table as the Python tier) */
static const unsigned ROT[5][5] = {{0, 36, 3, 41, 18},
                                   {1, 44, 10, 45, 2},
                                   {62, 6, 43, 15, 61},
                                   {28, 55, 25, 21, 56},
                                   {27, 20, 39, 8, 14}};

static inline uint64_t rol64(uint64_t v, unsigned n) {
  n &= 63u;
  return n ? (v << n) | (v >> (64 - n)) : v;
}

typedef struct {
  uint64_t lanes[25]; /* A[x + 5*y] */
  uint8_t buf[RATE];
  size_t buf_len;
} keccak_ctx;

static void keccak_f1600(uint64_t *a) {
  uint64_t b[25], c[5], d[5];
  for (int round = 0; round < ROUNDS; round++) {
    /* theta */
    for (int x = 0; x < 5; x++)
      c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
    for (int x = 0; x < 5; x++)
      d[x] = c[(x + 4) % 5] ^ rol64(c[(x + 1) % 5], 1);
    for (int i = 0; i < 25; i++) a[i] ^= d[i % 5];
    /* rho + pi: B[y, 2x+3y] = rol(A[x, y], r[x][y]) */
    for (int x = 0; x < 5; x++)
      for (int y = 0; y < 5; y++)
        b[y + 5 * ((2 * x + 3 * y) % 5)] = rol64(a[x + 5 * y], ROT[x][y]);
    /* chi */
    for (int y = 0; y < 5; y++)
      for (int x = 0; x < 5; x++)
        a[x + 5 * y] =
            b[x + 5 * y] ^ ((~b[(x + 1) % 5 + 5 * y]) & b[(x + 2) % 5 + 5 * y]);
    /* iota */
    a[0] ^= RC[round];
  }
}

static void absorb_block(keccak_ctx *ctx, const uint8_t *block) {
  for (int i = 0; i < RATE / 8; i++) {
    uint64_t lane;
    memcpy(&lane, block + 8 * i, 8); /* little-endian hosts only (x86/arm) */
    ctx->lanes[i] ^= lane;
  }
  keccak_f1600(ctx->lanes);
}

void *zk_keccak_new(void) {
  keccak_ctx *ctx = (keccak_ctx *)calloc(1, sizeof(keccak_ctx));
  return ctx;
}

void zk_keccak_free(void *p) { free(p); }

void zk_keccak_reset(void *p) {
  keccak_ctx *ctx = (keccak_ctx *)p;
  memset(ctx, 0, sizeof(*ctx));
}

void zk_keccak_update(void *p, const uint8_t *data, size_t len) {
  keccak_ctx *ctx = (keccak_ctx *)p;
  if (ctx->buf_len) {
    size_t take = RATE - ctx->buf_len;
    if (take > len) take = len;
    memcpy(ctx->buf + ctx->buf_len, data, take);
    ctx->buf_len += take;
    data += take;
    len -= take;
    if (ctx->buf_len == RATE) {
      absorb_block(ctx, ctx->buf);
      ctx->buf_len = 0;
    }
  }
  while (len >= RATE) {
    absorb_block(ctx, data);
    data += RATE;
    len -= RATE;
  }
  if (len) {
    memcpy(ctx->buf, data, len);
    ctx->buf_len = len;
  }
}

/* digest without mutating the running state */
void zk_keccak_digest(const void *p, uint8_t *out32) {
  const keccak_ctx *ctx = (const keccak_ctx *)p;
  uint64_t lanes[25];
  uint8_t block[RATE];
  memcpy(lanes, ctx->lanes, sizeof(lanes));
  memset(block, 0, RATE);
  memcpy(block, ctx->buf, ctx->buf_len);
  block[ctx->buf_len] = 0x01; /* Keccak multi-rate padding (not SHA3's 0x06) */
  block[RATE - 1] |= 0x80;
  for (int i = 0; i < RATE / 8; i++) {
    uint64_t lane;
    memcpy(&lane, block + 8 * i, 8);
    lanes[i] ^= lane;
  }
  keccak_f1600(lanes);
  memcpy(out32, lanes, 32);
}

/* sha3::finalize_reset: emit digest, reset to a fresh state */
void zk_keccak_finalize_reset(void *p, uint8_t *out32) {
  zk_keccak_digest(p, out32);
  zk_keccak_reset(p);
}

/* State export/import: lets the Fiat-Shamir transcript migrate between
 * the host hasher and the device-resident (XLA) sponge mid-proof.
 * lanes200: 25 lanes as little-endian u64s; buf136 + len: pending bytes. */
void zk_keccak_export(const void *p, uint8_t *lanes200, uint8_t *buf136,
                      size_t *len) {
  const keccak_ctx *ctx = (const keccak_ctx *)p;
  memcpy(lanes200, ctx->lanes, 200);
  memcpy(buf136, ctx->buf, ctx->buf_len);
  *len = ctx->buf_len;
}

void zk_keccak_import(void *p, const uint8_t *lanes200, const uint8_t *buf,
                      size_t len) {
  keccak_ctx *ctx = (keccak_ctx *)p;
  memcpy(ctx->lanes, lanes200, 200);
  if (len > RATE) len = RATE;
  memcpy(ctx->buf, buf, len);
  ctx->buf_len = len;
}
