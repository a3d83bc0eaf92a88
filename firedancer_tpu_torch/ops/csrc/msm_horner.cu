// Cross-window Horner of the Pippenger MSM: sum_t 2^(w t) W_t, from the
// top window down, w doublings and one unified add per window. The
// Horner role of msm_tails.cu, which includes this file and builds it.
//
// Replaces firedancer_tpu/ops/msm_pallas.py:248 window_horner_pallas
// (pallas_call at :295), which runs the chain in VMEM on window columns
// broadcast to (nw * 32, 128) row blocks.
//
// Bound on this card: latency. The chain is serial by nature: 17 x 7
// doublings and 17 adds for the z MSM, 36 x 7 and 36 for the 253-bit
// MSM. On one thread a window is 7 x (4 S + 4 M) + 9 M = 65 field
// operations in sequence, 1,105 and 2,340 a chain.
//
// Design: a quad (ge_quad.cuh), thread q holding coordinate q of the
// accumulator: a window is w quad_doubles and one quad_add, 2 (w + 1)
// dependent field operations plus the exchanges (16 at w = 7, 272 and
// 576 a chain). The add reads W_t's cached form (Y - X, Y + X, 2dT, 2Z);
// the warp's eight quads form those of up to HORNER_CHUNK windows into
// shared memory before the chain runs over them, so neither the 2d T
// products nor the loads sit on the chain. Then every quad of the warp
// runs the chain (full-mask shuffles) and quad 0 stores. Same windows,
// same top-down order, same formulas as msm_cuda.window_horner_ref, and
// the output is stored canonical, so it equals the plain version limb
// for limb. Any nw >= 1 (past HORNER_CHUNK + 1 windows the forms are
// made chunk by chunk) and any w (the plans take 6, 7 and 8).
#pragma once

#include "ge_quad.cuh"

#define HORNER_CHUNK 64  // windows whose cached forms a warp holds at once

// sum_t 2^(w_bits t) W_t of the (nw, 4, 5) window sums w, window t in
// row t, stored canonical to out (4, 5) by quad 0. cache holds
// HORNER_CHUNK * 20 words as [window][limb][q]. Every thread of the warp
// calls it.
__device__ __forceinline__ void horner_quad(const int64_t *__restrict__ w,
                                            int nw, int w_bits,
                                            int64_t *__restrict__ out,
                                            u64 *cache) {
  const int lane = threadIdx.x & 31, q = lane & 3, quad = lane >> 2;
  fe r = fe_load(w + 20LL * (nw - 1) + 5 * q);
#pragma unroll 1
  for (int hi = nw - 2; hi >= 0; hi -= HORNER_CHUNK) {
    const int lo = max(hi - HORNER_CHUNK + 1, 0);
#pragma unroll 1
    for (int t0 = lo; t0 <= hi; t0 += 8) {
      const int t = min(t0 + quad, hi);
      const fe c = quad_cached(q, fe_load(w + 20LL * t + 5 * q));
      if (t0 + quad <= hi) {
#pragma unroll
        for (int l = 0; l < 5; l++) cache[((t - lo) * 5 + l) * 4 + q] = c.v[l];
      }
    }
    __syncwarp();
#pragma unroll 1
    for (int t = hi; t >= lo; t--) {
#pragma unroll 1
      for (int k = 0; k < w_bits; k++) r = quad_double(q, r);
      fe c;
#pragma unroll
      for (int l = 0; l < 5; l++) c.v[l] = cache[((t - lo) * 5 + l) * 4 + q];
      r = quad_add(q, r, c);
    }
    __syncwarp();
  }
  if (quad == 0) fe_store_canonical(out + 5 * q, r);
}
