// K2 decompress_so: donna point decompression plus the small-order mask.
//
// Replaces the Pallas body firedancer_tpu/ops/curve_pallas.py:84
// _decompress_so_kernel (-> _decompress_body:120 ->
// decompress_pallas._decompress_batched_body:414, _mont_inv_tree_k:393,
// _small_order_k:76), launched at curve_pallas.py:234.
//
// Per lane (one thread each): y from the encoding with bit 255 masked,
// u = y^2 - 1, v = d y^2 + 1, x = u v^3 (u v^7)^((p-5)/8), the root checks
// v x^2 == +-u, the sign fix-up, T = x y; lanes whose root check fails
// carry the identity with ok = 0. Then 8*P == O (three doublings) gives
// the small-order mask, which reads 1 on failed lanes (the identity):
// callers test ok first.
//
// Bound on this card: integer multiply issue. Per lane the pow22523
// chain is 252 squarings + 11 multiplies of 15/25 64x64->128 products;
// the bytes (32 in, 4*40 + 2 out) are negligible. Design: one thread per
// lane, everything in registers, no shared memory, so the whole
// 252-squaring chain runs without touching memory. The TPU kernel
// batches the inversion across 64 lanes (Montgomery tree); here each lane
// runs its own chain — the batched inversion through shared memory is
// later work.
#include "fe25519.cuh"

__global__ void decompress_so_kernel(const uint8_t *__restrict__ enc,
                                     int64_t *__restrict__ pt,
                                     uint8_t *__restrict__ ok_out,
                                     uint8_t *__restrict__ so_out,
                                     long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint8_t *s = enc + 32 * i;
  const int sign = s[31] >> 7;
  const fe one = fe_one();
  fe y = fe_from_bytes(s);
  fe yy = fe_sq(y);
  fe u = fe_sub(yy, one);
  fe v = fe_add(fe_mul(yy, fe_load_const(FE_D)), one);
  fe v3 = fe_mul(fe_sq(v), v);
  fe uv7 = fe_mul(fe_mul(fe_sq(v3), v), u);
  fe x = fe_mul(fe_mul(fe_pow22523(uv7), v3), u);
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
    p.Z = one;
    p.T = fe_mul(x, y);
  } else {
    p.X = fe_zero();
    p.Y = one;
    p.Z = one;
    p.T = fe_zero();
  }
  int64_t *o = pt + 20 * i;
  fe_store_canonical(o + 0, p.X);
  fe_store_canonical(o + 5, p.Y);
  fe_store_canonical(o + 10, p.Z);
  fe_store_canonical(o + 15, p.T);
  ok_out[i] = (uint8_t)ok;
  so_out[i] = (uint8_t)ge_is_small_order(p);
}

// enc: (n, 32) uint8; pt: (n, 4, 5) int64; ok, so: (n,) bool.
extern "C" int fd_decompress_so(const void *enc, void *pt, void *ok, void *so,
                                long long n, void *stream) {
  if (n <= 0) return 0;
  decompress_so_kernel<<<fd_blocks(n), FD_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t *)enc, (int64_t *)pt, (uint8_t *)ok, (uint8_t *)so, n);
  return (int)cudaGetLastError();
}
