// SHA-512 (FIPS 180-4) constants and the scalar arithmetic mod L shared
// by the front-half kernels (K1 sha512_mod_l.cu, frontend_rlc.cu and
// sha512_batch.cu, which hash on the warp-staged core of sha512_warp.cuh:
// the round constants, the IV, the rotate and the digest) and by
// sc_reduce.cu: the Barrett reduction sc_reduce512 and the 256-bit
// product muladd256 / mul256, the one copy of each, and the 32-byte byte
// loads and stores of the hash core's unaligned scalars.
//
// The scalar arithmetic runs in radix 2^32 on PTX carry chains
// (mad.lo.cc, madc.hi.cc, addc, sub.cc): a half of a 32 x 32-bit
// product with its carries is one instruction a step, so no carry is
// written out in compares and adds. tests/test_torch_sc_grid.py
// transcribes every chain step in Python.
#pragma once

#include "fe25519.cuh"

__device__ __constant__ u64 K512[80] = {
    0x428a2f98d728ae22ULL, 0x7137449123ef65cdULL, 0xb5c0fbcfec4d3b2fULL,
    0xe9b5dba58189dbbcULL, 0x3956c25bf348b538ULL, 0x59f111f1b605d019ULL,
    0x923f82a4af194f9bULL, 0xab1c5ed5da6d8118ULL, 0xd807aa98a3030242ULL,
    0x12835b0145706fbeULL, 0x243185be4ee4b28cULL, 0x550c7dc3d5ffb4e2ULL,
    0x72be5d74f27b896fULL, 0x80deb1fe3b1696b1ULL, 0x9bdc06a725c71235ULL,
    0xc19bf174cf692694ULL, 0xe49b69c19ef14ad2ULL, 0xefbe4786384f25e3ULL,
    0x0fc19dc68b8cd5b5ULL, 0x240ca1cc77ac9c65ULL, 0x2de92c6f592b0275ULL,
    0x4a7484aa6ea6e483ULL, 0x5cb0a9dcbd41fbd4ULL, 0x76f988da831153b5ULL,
    0x983e5152ee66dfabULL, 0xa831c66d2db43210ULL, 0xb00327c898fb213fULL,
    0xbf597fc7beef0ee4ULL, 0xc6e00bf33da88fc2ULL, 0xd5a79147930aa725ULL,
    0x06ca6351e003826fULL, 0x142929670a0e6e70ULL, 0x27b70a8546d22ffcULL,
    0x2e1b21385c26c926ULL, 0x4d2c6dfc5ac42aedULL, 0x53380d139d95b3dfULL,
    0x650a73548baf63deULL, 0x766a0abb3c77b2a8ULL, 0x81c2c92e47edaee6ULL,
    0x92722c851482353bULL, 0xa2bfe8a14cf10364ULL, 0xa81a664bbc423001ULL,
    0xc24b8b70d0f89791ULL, 0xc76c51a30654be30ULL, 0xd192e819d6ef5218ULL,
    0xd69906245565a910ULL, 0xf40e35855771202aULL, 0x106aa07032bbd1b8ULL,
    0x19a4c116b8d2d0c8ULL, 0x1e376c085141ab53ULL, 0x2748774cdf8eeb99ULL,
    0x34b0bcb5e19b48a8ULL, 0x391c0cb3c5c95a63ULL, 0x4ed8aa4ae3418acbULL,
    0x5b9cca4f7763e373ULL, 0x682e6ff3d6b2b8a3ULL, 0x748f82ee5defb2fcULL,
    0x78a5636f43172f60ULL, 0x84c87814a1f0ab72ULL, 0x8cc702081a6439ecULL,
    0x90befffa23631e28ULL, 0xa4506cebde82bde9ULL, 0xbef9a3f7b2c67915ULL,
    0xc67178f2e372532bULL, 0xca273eceea26619cULL, 0xd186b8c721c0c207ULL,
    0xeada7dd6cde0eb1eULL, 0xf57d4f7fee6ed178ULL, 0x06f067aa72176fbaULL,
    0x0a637dc5a2c898a6ULL, 0x113f9804bef90daeULL, 0x1b710b35131c471bULL,
    0x28db77f523047d84ULL, 0x32caab7b40c72493ULL, 0x3c9ebe0a15c9bebcULL,
    0x431d67c49c100d4cULL, 0x4cc5d4becb3e42b6ULL, 0x597f299cfc657e2aULL,
    0x5fcb6fab3ad6faecULL, 0x6c44198c4a475817ULL};

__device__ __constant__ u64 SHA512_IV[8] = {
    0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL, 0x3c6ef372fe94f82bULL,
    0xa54ff53a5f1d36f1ULL, 0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
    0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL};

__device__ __forceinline__ u64 rotr64(u64 x, int n) {
  return (x >> n) | (x << (64 - n));
}

// ---- Scalar arithmetic mod L in radix 2^32 on PTX carry chains.
//
// L = 2^252 + 27742317777372353535851937790883648493 as eight 32-bit
// words (words 4-6 are zero, word 7 is 2^28) and mu = floor(2^512 / L)
// as nine, little-endian: Barrett with b = 2^32, k = 8 (HAC 14.42).
__device__ __constant__ uint32_t SC_L[8] = {
    0x5cf5d3edu, 0x5812631au, 0xa2f79cd6u, 0x14def9deu,
    0x00000000u, 0x00000000u, 0x00000000u, 0x10000000u};
__device__ __constant__ uint32_t SC_MU[9] = {
    0x0a2c131bu, 0xed9ce5a3u, 0x086329a7u, 0x2106215du, 0xffffffebu,
    0xffffffffu, 0xffffffffu, 0xffffffffu, 0x0000000fu};

// Step k of an m-step carry chain on the word d: d += the low (hi false)
// or high half of a b, or 0 for the chain's carry word (carry), plus the
// carry in (none at step 0); the carry out is set at step 0 and every
// later step but the chain's last, whose carry is either zero (sc_mac
// says why) or beyond the words kept. One PTX instruction a step; after
// unrolling, k, m, hi and carry are constants, so only that instruction
// is left.
__device__ __forceinline__ void sc_step(uint32_t &d, uint32_t a, uint32_t b,
                                        bool hi, bool carry, int k, int m) {
  const bool last = k == m - 1;
  if (carry) {
    asm volatile("addc.u32 %0, %0, 0;" : "+r"(d));
  } else if (k == 0) {
    asm volatile("mad.lo.cc.u32 %0, %1, %2, %0;" : "+r"(d) : "r"(a), "r"(b));
  } else if (hi) {
    if (last)
      asm volatile("madc.hi.u32 %0, %1, %2, %0;" : "+r"(d) : "r"(a), "r"(b));
    else
      asm volatile("madc.hi.cc.u32 %0, %1, %2, %0;"
                   : "+r"(d) : "r"(a), "r"(b));
  } else {
    if (last)
      asm volatile("madc.lo.u32 %0, %1, %2, %0;" : "+r"(d) : "r"(a), "r"(b));
    else
      asm volatile("madc.lo.cc.u32 %0, %1, %2, %0;"
                   : "+r"(d) : "r"(a), "r"(b));
  }
}

// p[0, NO) = (p + a b) mod 2^(32 NO) for a of NA words and b of NB words,
// with p < 2^(32 NB) on entry (its words NB and up zero). Row by row
// (HAC 14.12): row i adds a_i b at word i as two chains, one over b's
// even words and one over its odd words. The low and high halves of one
// parity's products fill consecutive words without overlapping, so each
// chain's steps write words i + par, i + par + 1, ...; the chain that
// ends below word i + NB carries into it (zero before row i, since p
// was below 2^(32 (i + NB))). No carry leaves word i + NB: after row i
// the sum is below 2^(32 (i + 1 + NB)). Steps at word NO and up are
// dropped.
template <int NA, int NB, int NO>
__device__ __forceinline__ void sc_mac(const uint32_t *a, const uint32_t *b,
                                       uint32_t *p) {
#pragma unroll
  for (int i = 0; i < NA; i++) {
#pragma unroll
    for (int par = 0; par < 2; par++) {
      const int w0 = i + par;
      const int prods = (NB - par + 1) / 2;
      const int full = 2 * prods + (par + 2 * prods == NB ? 1 : 0);
      const int m = full < NO - w0 ? full : NO - w0;
#pragma unroll
      for (int k = 0; k < m; k++)
        sc_step(p[w0 + k], a[i], k < 2 * prods ? b[par + 2 * (k >> 1)] : 0u,
                k & 1, k >= 2 * prods, k, m);
    }
  }
}

// d = a - b over eight words; returns 0xffffffff when a < b, else 0.
__device__ __forceinline__ uint32_t sc_sub8(const uint32_t a[8],
                                            const uint32_t b[8],
                                            uint32_t d[8]) {
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(d[0]) : "r"(a[0]), "r"(b[0]));
#pragma unroll
  for (int k = 1; k < 8; k++)
    asm volatile("subc.cc.u32 %0, %1, %2;"
                 : "=r"(d[k]) : "r"(a[k]), "r"(b[k]));
  uint32_t bw;
  asm volatile("subc.u32 %0, 0, 0;" : "=r"(bw));
  return bw;
}

// x (eight 64-bit limbs, < 2^512) mod L -> four limbs, canonical.
__device__ __forceinline__ void sc_reduce512(const u64 x64[8],
                                             u64 r_out[4]) {
  uint32_t x[16];
#pragma unroll
  for (int k = 0; k < 8; k++) {
    x[2 * k] = (uint32_t)x64[k];
    x[2 * k + 1] = (uint32_t)(x64[k] >> 32);
  }
  // q2 = q1 mu with q1 = floor(x / 2^224), words 7-15 of x; q3 =
  // floor(q2 / 2^288), words 9-17 of q2.
  uint32_t q2[18];
#pragma unroll
  for (int k = 0; k < 18; k++) q2[k] = 0;
  sc_mac<9, 9, 18>(x + 7, SC_MU, q2);
  const uint32_t *q3 = q2 + 9;
  // r2 = q3 L mod 2^256: L's words 0-3 by the chains, its word 7 (2^28)
  // by a shift.
  uint32_t r2[8];
#pragma unroll
  for (int k = 0; k < 8; k++) r2[k] = 0;
  sc_mac<4, 9, 8>(SC_L, q3, r2);
  r2[7] += q3[0] << 28;
  // r = x - q3 L lies in [0, 3L), and 3L < 2^256: x - r2 mod 2^256 is
  // r. Then at most two subtractions of L.
  uint32_t r[8], d[8];
  sc_sub8(x, r2, r);
#pragma unroll
  for (int it = 0; it < 2; it++) {
    const uint32_t bw = sc_sub8(r, SC_L, d);
#pragma unroll
    for (int k = 0; k < 8; k++) r[k] = bw ? r[k] : d[k];
  }
#pragma unroll
  for (int k = 0; k < 4; k++)
    r_out[k] = (u64)r[2 * k] | ((u64)r[2 * k + 1] << 32);
}

// a b + c for 256-bit a, b, c: eight 64-bit limbs (< 2^512), the addend
// entering as the product's initial words.
__device__ __forceinline__ void muladd256(const u64 a[4], const u64 b[4],
                                          const u64 c[4], u64 p[8]) {
  uint32_t aw[8], bw[8], pw[16];
#pragma unroll
  for (int k = 0; k < 4; k++) {
    aw[2 * k] = (uint32_t)a[k];
    aw[2 * k + 1] = (uint32_t)(a[k] >> 32);
    bw[2 * k] = (uint32_t)b[k];
    bw[2 * k + 1] = (uint32_t)(b[k] >> 32);
    pw[2 * k] = (uint32_t)c[k];
    pw[2 * k + 1] = (uint32_t)(c[k] >> 32);
    pw[8 + 2 * k] = pw[9 + 2 * k] = 0;
  }
  sc_mac<8, 8, 16>(aw, bw, pw);
#pragma unroll
  for (int k = 0; k < 8; k++)
    p[k] = (u64)pw[2 * k] | ((u64)pw[2 * k + 1] << 32);
}

// a b for 256-bit a, b: eight 64-bit limbs.
__device__ __forceinline__ void mul256(const u64 a[4], const u64 b[4],
                                       u64 p[8]) {
  const u64 zero[4] = {0, 0, 0, 0};
  muladd256(a, b, zero, p);
}

// Digest bytes are the state words big-endian; as a little-endian
// integer, limb k is the byte-swapped word k.
__device__ __forceinline__ void sha512_digest_le(const u64 st[8], u64 x[8]) {
#pragma unroll
  for (int k = 0; k < 8; k++) {
    u64 v = st[k], sw = 0;
#pragma unroll
    for (int b = 0; b < 8; b++) sw |= ((v >> (8 * b)) & 0xFF) << (8 * (7 - b));
    x[k] = sw;
  }
}

// 32 little-endian bytes <-> four 64-bit limbs.
__device__ __forceinline__ void sc_load(const uint8_t *s, u64 r[4]) {
#pragma unroll
  for (int k = 0; k < 4; k++) {
    u64 x = 0;
#pragma unroll
    for (int b = 0; b < 8; b++) x |= (u64)s[8 * k + b] << (8 * b);
    r[k] = x;
  }
}

__device__ __forceinline__ void sc_store(uint8_t *o, const u64 r[4]) {
#pragma unroll
  for (int k = 0; k < 4; k++)
#pragma unroll
    for (int b = 0; b < 8; b++) o[8 * k + b] = (uint8_t)(r[k] >> (8 * b));
}
