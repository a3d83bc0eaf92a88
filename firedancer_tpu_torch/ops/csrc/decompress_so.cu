// K2 decompress_so: donna point decompression plus the small-order mask.
//
// Replaces the Pallas body firedancer_tpu/ops/curve_pallas.py:84
// _decompress_so_kernel (-> _decompress_body:120 ->
// decompress_pallas._decompress_batched_body:414, _mont_inv_tree_k:393,
// _small_order_k:76), launched at curve_pallas.py:234.
//
// A thin entry around decompress_core.cuh, which holds the math, the
// bound and the design (five threads a lane, one radix-2^51 limb each):
// per lane the point (X, Y, 1, T), ok and 8 P == O. The TPU kernel
// batches the inversion across 64 lanes (Montgomery tree); here each
// lane runs donna's inversion-free chain, which decompress_niels.cu
// shares.
#include "decompress_core.cuh"

__global__ void __launch_bounds__(DC_THREADS)
    decompress_so_kernel(const uint8_t *__restrict__ enc,
                         int64_t *__restrict__ pt,
                         uint8_t *__restrict__ ok_out,
                         uint8_t *__restrict__ so_out, long long n) {
  const limb_group g = lg_make(n);
  const dc_point p = dc_decompress(g, enc);
  const int so = dc_small_order(g, p);
  dc_store_point(g, pt + 20 * g.lane, p);
  if (g.live && g.j == 0) {
    ok_out[g.lane] = (uint8_t)p.ok;
    so_out[g.lane] = (uint8_t)so;
  }
}

// enc: (n, 32) uint8; pt: (n, 4, 5) int64; ok, so: (n,) bool.
extern "C" int fd_decompress_so(const void *enc, void *pt, void *ok, void *so,
                                long long n, void *stream) {
  if (n <= 0) return 0;
  decompress_so_kernel<<<dc_blocks(n), DC_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t *)enc, (int64_t *)pt, (uint8_t *)ok, (uint8_t *)so, n);
  return (int)cudaGetLastError();
}
