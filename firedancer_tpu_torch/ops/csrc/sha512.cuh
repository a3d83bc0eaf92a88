// SHA-512 (FIPS 180-4) and the scalar arithmetic mod L shared by the
// front-half kernels (K1 sha512_mod_l.cu, frontend_rlc.cu and
// sha512_batch.cu, one copy of the rounds for all three) and by
// sc_reduce.cu (the Barrett reduction and the 256-bit product).
//
// sha512_row hashes one lane's row m[0:len], building the padding (0x80,
// zeros, the 128-bit big-endian bit length) in the kernel, so no
// host-side packing pass exists (the TPU kernels read words packed by
// firedancer_tpu/ops/sha512_pallas.py:141 _pack_schedule); native uint64
// words, 80 rounds per 128-byte block over a 16-word schedule ring.
// sc_reduce512 reduces a 512-bit little-endian integer mod L by Barrett
// with b = 2^64, k = 4 (HAC 14.42): mu = floor(2^512 / L) has five limbs,
// r < 3L before the final two conditional subtractions.
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

// L = 2^252 + 27742317777372353535851937790883648493 and
// mu = floor(2^512 / L), little-endian 64-bit limbs.
__device__ __constant__ u64 SC_L[4] = {0x5812631a5cf5d3edULL,
                                       0x14def9dea2f79cd6ULL,
                                       0x0000000000000000ULL,
                                       0x1000000000000000ULL};
__device__ __constant__ u64 SC_MU[5] = {0xed9ce5a30a2c131bULL,
                                        0x2106215d086329a7ULL,
                                        0xffffffffffffffebULL,
                                        0xffffffffffffffffULL,
                                        0x000000000000000fULL};

__device__ __forceinline__ u64 rotr64(u64 x, int n) {
  return (x >> n) | (x << (64 - n));
}

__device__ __forceinline__ void sha512_block(u64 st[8], u64 w[16]) {
  u64 a = st[0], b = st[1], c = st[2], d = st[3];
  u64 e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll 16
  for (int t = 0; t < 80; t++) {
    u64 wt;
    if (t < 16) {
      wt = w[t];
    } else {
      u64 w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
      u64 s0 = rotr64(w15, 1) ^ rotr64(w15, 8) ^ (w15 >> 7);
      u64 s1 = rotr64(w2, 19) ^ rotr64(w2, 61) ^ (w2 >> 6);
      wt = w[t & 15] + s0 + w[(t - 7) & 15] + s1;
      w[t & 15] = wt;
    }
    u64 S1 = rotr64(e, 14) ^ rotr64(e, 18) ^ rotr64(e, 41);
    u64 ch = (e & f) ^ (~e & g);
    u64 t1 = h + S1 + ch + K512[t] + wt;
    u64 S0 = rotr64(a, 28) ^ rotr64(a, 34) ^ rotr64(a, 39);
    u64 maj = (a & b) ^ (a & c) ^ (b & c);
    u64 t2 = S0 + maj;
    h = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + t2;
  }
  st[0] += a; st[1] += b; st[2] += c; st[3] += d;
  st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

// x (8 limbs, < 2^512) mod L -> 4 limbs.
__device__ __forceinline__ void sc_reduce512(const u64 x[8], u64 r_out[4]) {
  // q2 = floor(x / 2^192) * mu; q3 = floor(q2 / 2^320).
  u64 q2[10];
#pragma unroll
  for (int k = 0; k < 10; k++) q2[k] = 0;
#pragma unroll
  for (int i = 0; i < 5; i++) {
    u128 carry = 0;
#pragma unroll
    for (int j = 0; j < 5; j++) {
      u128 t = (u128)x[i + 3] * SC_MU[j] + q2[i + j] + carry;
      q2[i + j] = (u64)t;
      carry = t >> 64;
    }
    q2[i + 5] = (u64)carry;
  }
  // r2 = q3 * L mod 2^320.
  u64 r2[5] = {0, 0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 5; i++) {
    u128 carry = 0;
#pragma unroll
    for (int j = 0; j < 4; j++) {
      if (i + j < 5) {
        u128 t = (u128)q2[5 + i] * SC_L[j] + r2[i + j] + carry;
        r2[i + j] = (u64)t;
        carry = t >> 64;
      }
    }
    if (i + 4 < 5) r2[i + 4] += (u64)carry;
  }
  // r = x - r2 mod 2^320, in [0, 3L).
  u64 r[5];
  u64 borrow = 0;
#pragma unroll
  for (int k = 0; k < 5; k++) {
    u64 d1 = x[k] - r2[k];
    u64 b1 = x[k] < r2[k];
    r[k] = d1 - borrow;
    borrow = b1 | (d1 < borrow);
  }
#pragma unroll
  for (int it = 0; it < 2; it++) {
    u64 d[5];
    u64 bw = 0;
#pragma unroll
    for (int k = 0; k < 5; k++) {
      u64 lk = k < 4 ? SC_L[k] : 0;
      u64 d1 = r[k] - lk;
      u64 b1 = r[k] < lk;
      d[k] = d1 - bw;
      bw = b1 | (d1 < bw);
    }
    if (!bw) {
#pragma unroll
      for (int k = 0; k < 5; k++) r[k] = d[k];
    }
  }
#pragma unroll
  for (int k = 0; k < 4; k++) r_out[k] = r[k];
}

// a * b for 256-bit a, b: eight 64-bit limbs.
__device__ __forceinline__ void mul256(const u64 a[4], const u64 b[4],
                                       u64 p[8]) {
#pragma unroll
  for (int k = 0; k < 8; k++) p[k] = 0;
#pragma unroll
  for (int i = 0; i < 4; i++) {
    u128 carry = 0;
#pragma unroll
    for (int j = 0; j < 4; j++) {
      u128 t = (u128)a[i] * b[j] + p[i + j] + carry;
      p[i + j] = (u64)t;
      carry = t >> 64;
    }
    p[i + 4] = (u64)carry;
  }
}

// The state words of SHA-512(m[0:len]); len is clamped to [0, stride].
__device__ __forceinline__ void sha512_row(const uint8_t *m, long long len,
                                           long long stride, u64 st[8]) {
  len = len < 0 ? 0 : (len > stride ? stride : len);
  const long long nblocks = (len + 17 + 127) / 128;
#pragma unroll
  for (int k = 0; k < 8; k++) st[k] = SHA512_IV[k];
  for (long long blk = 0; blk < nblocks; blk++) {
    u64 w[16];
    const long long base = blk * 128;
    if (base + 128 <= len) {
      for (int j = 0; j < 16; j++) {
        u64 x = 0;
        const uint8_t *p = m + base + 8 * j;
#pragma unroll
        for (int k = 0; k < 8; k++) x = (x << 8) | p[k];
        w[j] = x;
      }
    } else {
      for (int j = 0; j < 16; j++) {
        u64 x = 0;
        for (int k = 0; k < 8; k++) {
          long long pos = base + 8 * j + k;
          u64 byte = pos < len ? m[pos] : (pos == len ? 0x80 : 0);
          x = (x << 8) | byte;
        }
        w[j] = x;
      }
      if (blk == nblocks - 1) w[15] = (u64)len << 3;
    }
    sha512_block(st, w);
  }
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
