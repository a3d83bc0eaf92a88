// K4 point_eq: affine (ax, ay) equals projective (X:Y:Z), ax*Z == X and
// ay*Z == Y, without an inversion.
//
// Replaces the Pallas body firedancer_tpu/ops/curve_pallas.py:265
// _point_eq_kernel, launched at curve_pallas.py:296.
//
// Bound on this card: bytes. Per lane it reads five field elements
// (200 B) and writes one byte, for two multiplies and two canonical zero
// tests. Design: decompress_core.cuh's group of five threads a lane
// (thread j owns radix-2^51 limb j; six lanes a warp, threads 30-31
// rerunning limbs 0-1 of the sixth), so a warp's loads are runs of 40
// contiguous bytes and the grid reaches every SM at the direct path's
// 8192 lanes (342 blocks): thread j loads limb j of ax, ay, X, Y and Z,
// the group gathers Z's halves once for both multiplies, tests
// ax Z - X and ay Z - Y for zero at canonical form (each thread gathers
// the difference), and thread 0 of a live group stores the lane's byte.
// Groups past the batch run on zeros and store nothing; no thread
// returns early, since every shuffle has a full mask. Input limbs in
// [0, 2^52) (lg_mul's 26-bit halves; the direct path's inputs are
// canonical).
#include "decompress_core.cuh"

__global__ void __launch_bounds__(DC_THREADS)
    point_eq_kernel(const int64_t *__restrict__ aff, int aff_coords,
                    const int64_t *__restrict__ proj, int proj_coords,
                    uint8_t *__restrict__ out, long long n) {
  const limb_group g = lg_make(n);
  u64 ax = 0, ay = 0, X = 0, Y = 0, Z = 0;
  if (g.live) {
    const int64_t *a = aff + 5LL * aff_coords * g.lane + g.j;
    const int64_t *q = proj + 5LL * proj_coords * g.lane + g.j;
    ax = (u64)a[0];
    ay = (u64)a[5];
    X = (u64)q[0];
    Y = (u64)q[5];
    Z = (u64)q[10];
  }
  const unsigned lo = (unsigned)Z & DC_MASK26, hi = (unsigned)(Z >> 26);
  unsigned zl[5], zh[5];
#pragma unroll
  for (int k = 0; k < 5; k++) {
    zl[k] = lg_shfl32(lo, g.base + k);
    zh[k] = lg_shfl32(hi, g.base + k);
  }
  const int eq_x = lg_is_zero(g, lg_sub(g, lg_mul_halves(g, ax, zl, zh), X));
  const int eq_y = lg_is_zero(g, lg_sub(g, lg_mul_halves(g, ay, zl, zh), Y));
  if (g.live && g.j == 0) out[g.lane] = (uint8_t)(eq_x & eq_y);
}

// aff: (n, aff_coords >= 2, 5) int64; proj: (n, proj_coords >= 3, 5)
// int64; limbs in [0, 2^52); out: (n,) bool.
extern "C" int fd_point_eq_affine(const void *aff, int aff_coords,
                                  const void *proj, int proj_coords, void *out,
                                  long long n, void *stream) {
  if (n <= 0) return 0;
  point_eq_kernel<<<dc_blocks(n), DC_THREADS, 0, (cudaStream_t)stream>>>(
      (const int64_t *)aff, aff_coords, (const int64_t *)proj, proj_coords,
      (uint8_t *)out, n);
  return (int)cudaGetLastError();
}
