// Field arithmetic over GF(2^255 - 19) for the port's Hopper kernels.
//
// Radix 2^51, five uint64 limbs; products through unsigned __int128
// (the compiler lowers each 64x64->128 product to IMAD.WIDE partial
// products). This is a GPU layout, not the JAX package's: the TPU
// kernels use lazy signed radix-2^8 int32 limbs because the TPU's
// vector unit has no wide multiply (firedancer_tpu/ops/fe25519.py:1-28).
// Arithmetic after native/ed25519_cpu.cc (the repository's readable
// radix-2^51 reference).
//
// Invariant: every fe a function returns has limbs < 2^52 (fe_add and
// fe_sub carry), so every product term stays < 2^110 and every carry
// fits 64 bits. Tensors cross the kernel boundary as int64 (B, k, 5)
// limbs, written canonical (value < p, limbs < 2^51).
#pragma once

#include <stdint.h>

typedef unsigned long long u64;
typedef unsigned __int128 u128;

#define FD_MASK51 ((1ULL << 51) - 1)

struct fe {
  u64 v[5];
};

// d, 2d and sqrt(-1) in radix 2^51 (held against the oracle's values by
// tests/test_torch_fe.py, which parses them out of this file).
__device__ __constant__ u64 FE_D[5] = {929955233495203ULL, 466365720129213ULL,
                                       1662059464998953ULL, 2033849074728123ULL,
                                       1442794654840575ULL};
__device__ __constant__ u64 FE_D2[5] = {1859910466990425ULL, 932731440258426ULL,
                                        1072319116312658ULL, 1815898335770999ULL,
                                        633789495995903ULL};
__device__ __constant__ u64 FE_SQRTM1[5] = {1718705420411056ULL, 234908883556509ULL,
                                            2233514472574048ULL, 2117202627021982ULL,
                                            765476049583133ULL};

__device__ __forceinline__ fe fe_load_const(const u64 *c) {
  fe r;
#pragma unroll
  for (int i = 0; i < 5; i++) r.v[i] = c[i];
  return r;
}

__device__ __forceinline__ fe fe_zero() { return {{0, 0, 0, 0, 0}}; }
__device__ __forceinline__ fe fe_one() { return {{1, 0, 0, 0, 0}}; }

// Weak reduce: limbs < 2^51 + 2^13 (the value may still exceed p).
// Inputs: limbs < 2^63.
__device__ __forceinline__ fe fe_carry(fe a) {
  u64 c;
  c = a.v[0] >> 51; a.v[0] &= FD_MASK51; a.v[1] += c;
  c = a.v[1] >> 51; a.v[1] &= FD_MASK51; a.v[2] += c;
  c = a.v[2] >> 51; a.v[2] &= FD_MASK51; a.v[3] += c;
  c = a.v[3] >> 51; a.v[3] &= FD_MASK51; a.v[4] += c;
  c = a.v[4] >> 51; a.v[4] &= FD_MASK51; a.v[0] += 19 * c;
  c = a.v[0] >> 51; a.v[0] &= FD_MASK51; a.v[1] += c;
  return a;
}

__device__ __forceinline__ fe fe_add(const fe &a, const fe &b) {
  fe r;
#pragma unroll
  for (int i = 0; i < 5; i++) r.v[i] = a.v[i] + b.v[i];
  return fe_carry(r);
}

// a - b + 4p limb-wise (4p = 2^53 - 76, 2^53 - 4, ...), so no limb
// underflows for b limbs < 2^53 - 76.
__device__ __forceinline__ fe fe_sub(const fe &a, const fe &b) {
  const u64 l0 = (1ULL << 53) - 76, li = (1ULL << 53) - 4;
  fe r;
  r.v[0] = a.v[0] + l0 - b.v[0];
#pragma unroll
  for (int i = 1; i < 5; i++) r.v[i] = a.v[i] + li - b.v[i];
  return fe_carry(r);
}

__device__ __forceinline__ fe fe_neg(const fe &a) { return fe_sub(fe_zero(), a); }

// Fold five 128-bit column sums into limbs < 2^52.
__device__ __forceinline__ fe fe_reduce_wide(u128 t0, u128 t1, u128 t2,
                                             u128 t3, u128 t4) {
  fe r;
  t1 += (u64)(t0 >> 51); r.v[0] = (u64)t0 & FD_MASK51;
  t2 += (u64)(t1 >> 51); r.v[1] = (u64)t1 & FD_MASK51;
  t3 += (u64)(t2 >> 51); r.v[2] = (u64)t2 & FD_MASK51;
  t4 += (u64)(t3 >> 51); r.v[3] = (u64)t3 & FD_MASK51;
  u64 c = (u64)(t4 >> 51); r.v[4] = (u64)t4 & FD_MASK51;
  u128 w = (u128)r.v[0] + (u128)c * 19;
  r.v[0] = (u64)w & FD_MASK51;
  r.v[1] += (u64)(w >> 51);
  return r;
}

__device__ __forceinline__ fe fe_mul(const fe &a, const fe &b) {
  const u64 a0 = a.v[0], a1 = a.v[1], a2 = a.v[2], a3 = a.v[3], a4 = a.v[4];
  const u64 b0 = b.v[0], b1 = b.v[1], b2 = b.v[2], b3 = b.v[3], b4 = b.v[4];
  const u64 b1_19 = b1 * 19, b2_19 = b2 * 19, b3_19 = b3 * 19, b4_19 = b4 * 19;
  u128 t0 = (u128)a0 * b0 + (u128)a1 * b4_19 + (u128)a2 * b3_19 +
            (u128)a3 * b2_19 + (u128)a4 * b1_19;
  u128 t1 = (u128)a0 * b1 + (u128)a1 * b0 + (u128)a2 * b4_19 +
            (u128)a3 * b3_19 + (u128)a4 * b2_19;
  u128 t2 = (u128)a0 * b2 + (u128)a1 * b1 + (u128)a2 * b0 +
            (u128)a3 * b4_19 + (u128)a4 * b3_19;
  u128 t3 = (u128)a0 * b3 + (u128)a1 * b2 + (u128)a2 * b1 + (u128)a3 * b0 +
            (u128)a4 * b4_19;
  u128 t4 = (u128)a0 * b4 + (u128)a1 * b3 + (u128)a2 * b2 + (u128)a3 * b1 +
            (u128)a4 * b0;
  return fe_reduce_wide(t0, t1, t2, t3, t4);
}

// 15 products instead of 25.
__device__ __forceinline__ fe fe_sq(const fe &a) {
  const u64 a0 = a.v[0], a1 = a.v[1], a2 = a.v[2], a3 = a.v[3], a4 = a.v[4];
  const u64 d0 = 2 * a0, d1 = 2 * a1, d2 = 2 * a2;
  const u64 a3_19 = 19 * a3, a4_19 = 19 * a4;
  u128 t0 = (u128)a0 * a0 + (u128)d1 * a4_19 + (u128)d2 * a3_19;
  u128 t1 = (u128)d0 * a1 + (u128)d2 * a4_19 + (u128)a3 * a3_19;
  u128 t2 = (u128)d0 * a2 + (u128)a1 * a1 + (u128)(2 * a3) * a4_19;
  u128 t3 = (u128)d0 * a3 + (u128)d1 * a2 + (u128)a4 * a4_19;
  u128 t4 = (u128)d0 * a4 + (u128)d1 * a3 + (u128)a2 * a2;
  return fe_reduce_wide(t0, t1, t2, t3, t4);
}

// Canonical representative: value < p, limbs < 2^51.
__device__ __forceinline__ fe fe_canonical(const fe &a) {
  fe t = fe_carry(fe_carry(a));
  u64 q = (t.v[0] + 19) >> 51;
  q = (t.v[1] + q) >> 51;
  q = (t.v[2] + q) >> 51;
  q = (t.v[3] + q) >> 51;
  q = (t.v[4] + q) >> 51;  // q = (t >= p)
  t.v[0] += 19 * q;
  u64 c;
  c = t.v[0] >> 51; t.v[0] &= FD_MASK51; t.v[1] += c;
  c = t.v[1] >> 51; t.v[1] &= FD_MASK51; t.v[2] += c;
  c = t.v[2] >> 51; t.v[2] &= FD_MASK51; t.v[3] += c;
  c = t.v[3] >> 51; t.v[3] &= FD_MASK51; t.v[4] += c;
  t.v[4] &= FD_MASK51;
  return t;
}

__device__ __forceinline__ int fe_is_zero(const fe &a) {
  fe c = fe_canonical(a);
  return (c.v[0] | c.v[1] | c.v[2] | c.v[3] | c.v[4]) == 0;
}

__device__ __forceinline__ int fe_is_negative(const fe &a) {
  return (int)(fe_canonical(a).v[0] & 1);
}

// Little-endian 32 bytes, bit 255 dropped (a point encoding's x sign).
__device__ __forceinline__ fe fe_from_bytes(const uint8_t *s) {
  u64 w[4];
#pragma unroll
  for (int k = 0; k < 4; k++) {
    u64 x = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) x |= (u64)s[8 * k + j] << (8 * j);
    w[k] = x;
  }
  fe r;
  r.v[0] = w[0] & FD_MASK51;
  r.v[1] = ((w[0] >> 51) | (w[1] << 13)) & FD_MASK51;
  r.v[2] = ((w[1] >> 38) | (w[2] << 26)) & FD_MASK51;
  r.v[3] = ((w[2] >> 25) | (w[3] << 39)) & FD_MASK51;
  r.v[4] = (w[3] >> 12) & FD_MASK51;
  return r;
}

// Limbs as stored in an int64 tensor row.
__device__ __forceinline__ fe fe_load(const int64_t *p) {
  fe r;
#pragma unroll
  for (int i = 0; i < 5; i++) r.v[i] = (u64)p[i];
  return r;
}

__device__ __forceinline__ void fe_store_canonical(int64_t *p, const fe &a) {
  fe c = fe_canonical(a);
#pragma unroll
  for (int i = 0; i < 5; i++) p[i] = (int64_t)c.v[i];
}

// A warp's field elements, moved by shuffles (every thread of the warp
// must take part: full mask). The MSM kernels and K3 share this one set.
#define FD_FULL_MASK 0xffffffffu

__device__ __forceinline__ fe fe_shfl_xor(const fe &a, int o) {
  fe r;
#pragma unroll
  for (int i = 0; i < 5; i++) r.v[i] = __shfl_xor_sync(FD_FULL_MASK, a.v[i], o);
  return r;
}

__device__ __forceinline__ fe fe_shfl_down(const fe &a, int o) {
  fe r;
#pragma unroll
  for (int i = 0; i < 5; i++) r.v[i] = __shfl_down_sync(FD_FULL_MASK, a.v[i], o);
  return r;
}

// The element of lane src of this thread's group of `width` lanes (a
// power of two <= 32; K3's quads use width 4).
__device__ __forceinline__ fe fe_shfl_idx(const fe &a, int src,
                                          int width = 32) {
  fe r;
#pragma unroll
  for (int i = 0; i < 5; i++)
    r.v[i] = __shfl_sync(FD_FULL_MASK, a.v[i], src, width);
  return r;
}

// ------------------------------------------------------------------ points
// Extended twisted Edwards coordinates (X:Y:Z:T), a = -1.
struct ge {
  fe X, Y, Z, T;
};

// dbl-2008-hwcd; the input T is never read, T is produced when need_t.
__device__ __forceinline__ ge ge_double(const ge &p, bool need_t) {
  fe a = fe_sq(p.X);
  fe b = fe_sq(p.Y);
  fe zz = fe_sq(p.Z);
  fe c = fe_add(zz, zz);
  fe d = fe_neg(a);
  fe e = fe_sub(fe_sub(fe_sq(fe_add(p.X, p.Y)), a), b);
  fe g = fe_add(d, b);
  fe f = fe_sub(g, c);
  fe h = fe_sub(d, b);
  ge r;
  r.X = fe_mul(e, f);
  r.Y = fe_mul(g, h);
  r.Z = fe_mul(f, g);
  r.T = need_t ? fe_mul(e, h) : fe_zero();
  return r;
}
