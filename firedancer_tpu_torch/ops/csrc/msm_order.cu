// [L] P for each torsion-trial aggregate, L the prime group order: from
// the leading 1 of L, per remaining bit a doubling and, where the bit is
// set, a unified add of P. Identity iff P has no torsion component (the
// certification of verify_rlc.py:18-33). The ladder role of
// msm_tails.cu, which includes this file and builds it.
//
// Replaces firedancer_tpu/ops/msm_pallas.py:164 mul_by_group_order_pallas
// (pallas_call at :218), which selects between the sum and the doubled
// point arithmetically so that every lane runs one op stream. L is
// public, so the branch here leaks nothing, and every thread takes the
// same branch.
//
// Bound on this card: latency. 252 doublings and 72 adds per point (L
// has 73 set bits), one dependent chain; the main path has K = 64
// trials. On one thread a trial is 252 x (4 S + 4 M) + 72 x 9 M =
// 2,664 field operations in sequence.
//
// Design: a quad (ge_quad.cuh) a trial, thread q holding coordinate q of
// the accumulator, eight trials a warp: 252 quad_doubles and 72
// quad_adds, 648 dependent field operations plus the exchanges. P's
// cached form (Y - X, Y + X, 2dT, 2Z) is formed once and kept in
// registers, thread q holding coordinate q. Same bit order, same
// formulas as msm_cuda.mul_by_group_order_ref, outputs stored canonical:
// equal to the plain version limb for limb. The bits of L are a
// compile-time constant (little-endian 64-bit words, held against
// sc25519.L by tests/test_torch_msm.py).
#pragma once

#include "ge_quad.cuh"

__device__ __constant__ u64 L_WORDS[4] = {0x5812631a5cf5d3edULL,
                                          0x14def9dea2f79cd6ULL, 0x0ULL,
                                          0x1000000000000000ULL};
#define L_TOP_BIT 252

// Coordinate q of [L] P, P's (4, 5) limbs at p (limbs up to 2^52).
// Every thread of the warp calls it.
__device__ __forceinline__ fe order_quad(int q,
                                         const int64_t *__restrict__ p) {
  const fe pt = fe_load(p + 5 * q);
  const fe pc = quad_cached(q, pt);
  fe r = pt;
#pragma unroll 1
  for (int bit = L_TOP_BIT - 1; bit >= 0; bit--) {
    r = quad_double(q, r);
    if ((L_WORDS[bit >> 6] >> (bit & 63)) & 1) r = quad_add(q, r, pc);
  }
  return r;
}
