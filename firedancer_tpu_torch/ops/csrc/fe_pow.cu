// The GF(2^255 - 19) power chains per lane: z^(p - 2), the inverse
// (0 for z = 0), and z^((p - 5)/8), one kernel templated on the chain,
// canonical radix-2^51 limbs out.
//
// Replaces the Pallas body firedancer_tpu/ops/pow_pallas.py:113
// _pow_kernel (chains invert_chain:101 and pow22523_chain:107 on
// _ladder:85), launched at pow_pallas.py:148. The TPU kernel keeps a
// 512-lane tile in VMEM so that the ~265 sequential multiplies never
// stream through HBM; here the chain runs in registers.
//
// Bound on this card: integer multiply issue (254 or 251 squarings and
// 11 multiplies a lane) against 80 bytes a lane. Design:
// decompress_core.cuh's group of five threads a lane (thread j owns
// radix-2^51 limb j; six lanes a warp, threads 30-31 rerunning limbs 0-1
// of the sixth), the chains lg_invert and lg_pow22523 that compress, K2
// and decompress_niels run: thread j loads limb j of its lane's row (a
// warp's loads are runs of 40 contiguous bytes), the group runs the
// chain, and lg_store_canonical stores limb j. Groups past the batch run
// the chain on zeros and store nothing; no thread returns early, since
// every shuffle has a full mask. Input limbs in [0, 2^52).
#include "decompress_core.cuh"

template <bool INVERT>
__global__ void __launch_bounds__(DC_THREADS)
    fe_pow_kernel(const int64_t *__restrict__ z, int64_t *__restrict__ out,
                  long long n) {
  const limb_group g = lg_make(n);
  const u64 x = g.live ? (u64)z[5 * g.lane + g.j] : 0;
  u64 r;
  if constexpr (INVERT)
    r = lg_invert(g, x);
  else
    r = lg_pow22523(g, x);
  lg_store_canonical(g, out + 5 * g.lane, r);
}

// invert: 1 for z^(p - 2), 0 for z^((p - 5)/8); z: (n, 5) int64 limbs in
// [0, 2^52); out: (n, 5) int64 canonical limbs.
extern "C" int fd_fe_pow(int invert, const void *z, void *out, long long n,
                         void *stream) {
  if (n <= 0) return 0;
  if (invert)
    fe_pow_kernel<true><<<dc_blocks(n), DC_THREADS, 0, (cudaStream_t)stream>>>(
        (const int64_t *)z, (int64_t *)out, n);
  else
    fe_pow_kernel<false><<<dc_blocks(n), DC_THREADS, 0,
                           (cudaStream_t)stream>>>((const int64_t *)z,
                                                   (int64_t *)out, n);
  return (int)cudaGetLastError();
}
