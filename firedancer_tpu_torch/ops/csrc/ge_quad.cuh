// Point formulas on a quad: four threads of a warp (threads 4k .. 4k+3)
// hold one extended point (X, Y, Z, T), thread q coordinate q as one fe.
// Each step runs the one-thread formulas (dbl-2008-hwcd as fe25519.cuh
// ge_double, add-2008-hwcd-3 on the cached form) with their operands in
// their order; only which thread computes what changes:
//   doubling   stage 1: q0 X^2, q1 Y^2, q2 2 Z^2, q3 (X + Y)^2 (X, Y
//              reach q3 by width-4 shuffles);
//   add        stage 1: q0 a = (Y - X) YmX, q1 b = (Y + X) YpX,
//              q2 c = T T2d, q3 d = Z Z2 (one xor-1 shuffle hands q0 Y,
//              q1 X, q2 T, q3 Z);
//   both       exchange the four stage-1 values in the quad; every thread
//              forms d/e/f/g/h with the same calls in the same order;
//              stage 2: q0 X' = e f, q1 Y' = g h, q2 Z' = f g, q3 T' = e h.
// So a doubling or an add is two dependent field operations plus the
// exchanges. T is always computed (q3 would idle otherwise); no doubling
// reads it. The add takes the point added in cached form (Y - X, Y + X,
// 2dT, 2Z), thread q holding the coordinate it consumes: T1 (2d T2) and
// Z1 (2 Z2) are the field elements (T1 T2) 2d and Z1 Z2 + Z1 Z2 of
// msm.cuh ge_add_ext_with, so outputs stored canonical equal the
// one-thread formulas' limb for limb.
//
// Every shuffle has a full mask: every thread of the warp must call each
// helper, so a kernel's spare quads rerun a live quad's work and skip the
// store. Used by K3 (double_scalarmult.cu) and the MSM tails
// (msm_tails.cu).
#pragma once

#include "fe25519.cuh"

// The q-th of four field elements, by selects (no local memory).
__device__ __forceinline__ fe fe_pick(int q, const fe &a, const fe &b,
                                      const fe &c, const fe &d) {
  fe r;
#pragma unroll
  for (int i = 0; i < 5; i++)
    r.v[i] = q == 0 ? a.v[i] : q == 1 ? b.v[i] : q == 2 ? c.v[i] : d.v[i];
  return r;
}

// Stage 2 of both formulas: coordinate q of (e f, g h, f g, e h).
__device__ __forceinline__ fe quad_stage2(int q, const fe &e, const fe &f,
                                          const fe &g, const fe &h) {
  return fe_mul(fe_pick(q, e, g, f, e), fe_pick(q, f, h, g, h));
}

// dbl-2008-hwcd (fe25519.cuh ge_double) on a quad: thread q holds and
// returns coordinate q.
__device__ __forceinline__ fe quad_double(int q, const fe &p) {
  const fe x = fe_shfl_idx(p, 0, 4), y = fe_shfl_idx(p, 1, 4);
  fe t = fe_sq(fe_pick(q, p, p, p, fe_add(x, y)));
  t = fe_pick(q, t, t, fe_add(t, t), t);
  const fe a = fe_shfl_idx(t, 0, 4), b = fe_shfl_idx(t, 1, 4);
  const fe c = fe_shfl_idx(t, 2, 4), sq = fe_shfl_idx(t, 3, 4);
  const fe d = fe_neg(a);
  const fe e = fe_sub(fe_sub(sq, a), b);
  const fe g = fe_add(d, b);
  const fe f = fe_sub(g, c);
  const fe h = fe_sub(d, b);
  return quad_stage2(q, e, f, g, h);
}

// add-2008-hwcd-3 on a quad: p + an entry of which thread q holds the
// coordinate it consumes, tq (q0 Y - X, q1 Y + X, q2 2dT, q3 2Z).
__device__ __forceinline__ fe quad_add(int q, const fe &p, const fe &tq) {
  const fe o = fe_shfl_xor(p, 1);  // q0 Y, q1 X, q2 T, q3 Z
  const fe t = fe_mul(fe_pick(q, fe_sub(o, p), fe_add(p, o), o, o), tq);
  const fe a = fe_shfl_idx(t, 0, 4), b = fe_shfl_idx(t, 1, 4);
  const fe c = fe_shfl_idx(t, 2, 4), d = fe_shfl_idx(t, 3, 4);
  const fe e = fe_sub(b, a), f = fe_sub(d, c), g = fe_add(d, c),
           h = fe_add(b, a);
  return quad_stage2(q, e, f, g, h);
}

// Coordinate q of p's cached form (Y - X, Y + X, 2dT, 2Z).
__device__ __forceinline__ fe quad_cached(int q, const fe &p) {
  const fe o = fe_shfl_xor(p, 1);
  return fe_pick(q, fe_sub(o, p), fe_add(p, o),
                 fe_mul(o, fe_load_const(FE_D2)), fe_add(o, o));
}
