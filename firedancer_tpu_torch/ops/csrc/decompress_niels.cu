// Point decompression with niels forms and the small-order mask, for the
// RLC pass's stacked A || R.
//
// Replaces the Pallas body firedancer_tpu/ops/curve_pallas.py:94
// _decompress_niels_kernel (-> _decompress_body:120 ->
// decompress_pallas._decompress_batched_body:414, _mont_inv_tree_k:393),
// launched at curve_pallas.py:234; the small-order mask the JAX package
// computes after the kernel (verify_rlc.py:279) is computed here on the
// point while it sits in registers, as K2 does.
//
// K2's per-lane chain (decompress_core.cuh: five threads a lane, one
// radix-2^51 limb each, no inversion), then the niels forms of P,
// (y + x, y - x, 2d t), and of -P, (y - x, y + x, -2d t). The TPU kernel
// and the plain version (ops/decompress.py) share one inversion among a
// group of lanes (Montgomery's trick); on this card a grouped inversion
// only adds a second chain to the lane's 252-squaring ladder, and the
// square root after the root checks is unique, so the outputs are the
// same bit for bit.
#include "decompress_core.cuh"

__global__ void __launch_bounds__(DC_THREADS)
    decompress_niels_kernel(const uint8_t *__restrict__ enc,
                            int64_t *__restrict__ pt,
                            int64_t *__restrict__ niels,
                            int64_t *__restrict__ niels_neg,
                            uint8_t *__restrict__ ok_out,
                            uint8_t *__restrict__ so_out, long long n) {
  const limb_group g = lg_make(n);
  const dc_point p = dc_decompress(g, enc);
  const int so = dc_small_order(g, p);
  dc_store_point(g, pt + 20 * g.lane, p);
  const u64 yp = lg_add(g, p.Y, p.X), ym = lg_sub(g, p.Y, p.X);
  const u64 t2d = lg_mul_const(g, p.T, FE_D2);
  const u64 t2d_neg = lg_neg(g, t2d);
  int64_t *q = niels + 15 * g.lane;
  lg_store_canonical(g, q + 0, yp);
  lg_store_canonical(g, q + 5, ym);
  lg_store_canonical(g, q + 10, t2d);
  q = niels_neg + 15 * g.lane;
  lg_store_canonical(g, q + 0, ym);
  lg_store_canonical(g, q + 5, yp);
  lg_store_canonical(g, q + 10, t2d_neg);
  if (g.live && g.j == 0) {
    ok_out[g.lane] = (uint8_t)p.ok;
    so_out[g.lane] = (uint8_t)so;
  }
}

// enc: (n, 32) uint8; pt: (n, 4, 5) int64; niels, niels_neg: (n, 3, 5)
// int64; ok, so: (n,) bool.
extern "C" int fd_decompress_niels(const void *enc, void *pt, void *niels,
                                   void *niels_neg, void *ok, void *so,
                                   long long n, void *stream) {
  if (n <= 0) return 0;
  decompress_niels_kernel<<<dc_blocks(n), DC_THREADS, 0,
                            (cudaStream_t)stream>>>(
      (const uint8_t *)enc, (int64_t *)pt, (int64_t *)niels,
      (int64_t *)niels_neg, (uint8_t *)ok, (uint8_t *)so, n);
  return (int)cudaGetLastError();
}
