// Batched point decompression with niels forms and the small-order mask,
// for the RLC pass's stacked A || R.
//
// Replaces the Pallas body firedancer_tpu/ops/curve_pallas.py:94
// _decompress_niels_kernel (-> _decompress_body:120 ->
// decompress_pallas._decompress_batched_body:414, _mont_inv_tree_k:393),
// launched at curve_pallas.py:234; the small-order mask the JAX package
// computes after the kernel (verify_rlc.py:279) is computed here on the
// point while it sits in registers, as K2 decompress_so.cu does.
//
// Per lane (one thread each), the math of firedancer_tpu_torch/ops/
// decompress.py: u = y^2 - 1, v = d y^2 + 1, w = u v, m = w^2 v (m := 1 on
// lanes with y = +-1, whose u = 0 would poison the group), x = w^(2^252)
// inv(m), the root checks v x^2 == +-u, the sign fix-up, T = x y, the
// identity on failed lanes; then the niels forms (y + x, y - x, 2d t) and
// those of -P, (y - x, y + x, -2d t), and 8 P == O.
//
// The inversion is shared by the 32 lanes of a warp (Montgomery's trick):
// inclusive prefix and suffix products by shuffles (Kogge-Stone, 5 steps
// each), one z^(p-2) chain on the warp's product, then inv(m_i) =
// inv(prod) * prefix_(i-1) * suffix_(i+1). Lanes past the batch enter as
// 1, so a batch that is not a multiple of 32 is padded with 1. The
// inverse is unique, so the outputs do not depend on the grouping.
//
// Bound on this card: the instruction issue of one warp per SM sub-
// partition (at 2B = 16384 lanes the card holds 4 warps per SM), which
// one field multiply's 25 independent 64-bit products already fill. Per
// lane 267 squarings and ~19 multiplies, plus the group's inversion
// (254 S + 11 M). In SIMT the warp issues that inversion once for its 32
// lanes, as K2 issues its per-lane pow22523 chain once for 32 lanes: a
// group inside one warp saves no instructions, and the warp runs the
// ladder and the inversion, two chains to K2's one. Measured 0.20 ms to
// K2's 0.11 ms on an H100 (PERF.md). The ladder alone is as long as
// K2's chain, so no grouping beats K2 at this occupancy; K2's per-lane
// candidate, bit-exact through the same root checks, would match it.
#include "fe25519.cuh"

#define DN_THREADS 128
#define FULL_MASK 0xffffffffu

__device__ __forceinline__ fe fe_shfl_up(const fe &a, int d) {
  fe r;
#pragma unroll
  for (int k = 0; k < 5; k++) r.v[k] = __shfl_up_sync(FULL_MASK, a.v[k], d);
  return r;
}

__device__ __forceinline__ fe fe_shfl_down(const fe &a, int d) {
  fe r;
#pragma unroll
  for (int k = 0; k < 5; k++)
    r.v[k] = __shfl_down_sync(FULL_MASK, a.v[k], d);
  return r;
}

__device__ __forceinline__ fe fe_shfl(const fe &a, int src) {
  fe r;
#pragma unroll
  for (int k = 0; k < 5; k++) r.v[k] = __shfl_sync(FULL_MASK, a.v[k], src);
  return r;
}

__global__ void __launch_bounds__(DN_THREADS)
    decompress_niels_kernel(const uint8_t *__restrict__ enc,
                            int64_t *__restrict__ pt,
                            int64_t *__restrict__ niels,
                            int64_t *__restrict__ niels_neg,
                            uint8_t *__restrict__ ok_out,
                            uint8_t *__restrict__ so_out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool live = i < n;  // lanes past the batch still join the shuffles
  const fe one = fe_one();
  fe y = one;
  int sign = 0;
  if (live) {
    y = fe_from_bytes(enc + 32 * i);
    sign = enc[32 * i + 31] >> 7;
  }
  fe yy = fe_sq(y);
  fe u = fe_sub(yy, one);
  fe v = fe_add(fe_mul(yy, fe_load_const(FE_D)), one);
  fe w = fe_mul(u, v);
  fe m = fe_mul(fe_sq(w), v);
  if (!live || fe_is_zero(u)) m = one;

  // Montgomery's trick over the warp.
  fe pre = m, suf = m;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    fe o = fe_shfl_up(pre, d);
    if (lane >= d) pre = fe_mul(o, pre);
    o = fe_shfl_down(suf, d);
    if (lane + d < 32) suf = fe_mul(suf, o);
  }
  const fe prod = fe_shfl(pre, 31);
  fe pre_ex = fe_shfl_up(pre, 1);
  fe suf_ex = fe_shfl_down(suf, 1);
  if (lane == 0) pre_ex = one;
  if (lane == 31) suf_ex = one;
  if (!live) return;
  const fe inv_m = fe_mul(fe_mul(fe_invert(prod), pre_ex), suf_ex);

  fe x = fe_mul(fe_sqn(w, 252), inv_m);
  fe vxx = fe_mul(fe_sq(x), v);
  const int root_ok = fe_eq(vxx, u);
  const int neg_ok = fe_eq(vxx, fe_neg(u));
  if (!root_ok) x = fe_mul(x, fe_load_const(FE_SQRTM1));
  const int ok = root_ok | neg_ok;
  if (fe_is_negative(x) != sign) x = fe_neg(x);

  ge p;
  if (ok) {
    p.X = x;
    p.Y = y;
    p.T = fe_mul(x, y);
  } else {
    p.X = fe_zero();
    p.Y = one;
    p.T = fe_zero();
  }
  p.Z = one;
  int64_t *o = pt + 20 * i;
  fe_store_canonical(o + 0, p.X);
  fe_store_canonical(o + 5, p.Y);
  fe_store_canonical(o + 10, p.Z);
  fe_store_canonical(o + 15, p.T);
  const fe yp = fe_add(p.Y, p.X), ym = fe_sub(p.Y, p.X);
  const fe t2d = fe_mul(p.T, fe_load_const(FE_D2));
  int64_t *q = niels + 15 * i;
  fe_store_canonical(q + 0, yp);
  fe_store_canonical(q + 5, ym);
  fe_store_canonical(q + 10, t2d);
  q = niels_neg + 15 * i;
  fe_store_canonical(q + 0, ym);
  fe_store_canonical(q + 5, yp);
  fe_store_canonical(q + 10, fe_neg(t2d));
  ok_out[i] = (uint8_t)ok;
  so_out[i] = (uint8_t)ge_is_small_order(p);
}

// enc: (n, 32) uint8; pt: (n, 4, 5) int64; niels, niels_neg: (n, 3, 5)
// int64; ok, so: (n,) bool.
extern "C" int fd_decompress_niels(const void *enc, void *pt, void *niels,
                                   void *niels_neg, void *ok, void *so,
                                   long long n, void *stream) {
  if (n <= 0) return 0;
  const unsigned blocks = (unsigned)((n + DN_THREADS - 1) / DN_THREADS);
  decompress_niels_kernel<<<blocks, DN_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t *)enc, (int64_t *)pt, (int64_t *)niels,
      (int64_t *)niels_neg, (uint8_t *)ok, (uint8_t *)so, n);
  return (int)cudaGetLastError();
}
