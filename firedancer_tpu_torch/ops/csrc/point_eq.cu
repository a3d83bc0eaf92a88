// K4 point_eq: affine (ax, ay) equals projective (X:Y:Z), ax*Z == X and
// ay*Z == Y, without an inversion.
//
// Replaces the Pallas body firedancer_tpu/ops/curve_pallas.py:265
// _point_eq_kernel, launched at curve_pallas.py:296.
//
// Bound on this card: bytes. Per lane it reads five field elements
// (200 B) and writes one byte, for two multiplies and two canonical zero
// tests. Design: one thread per lane, strided row reads; the kernel is
// a single pass over its inputs.
#include "fe25519.cuh"

__global__ void point_eq_kernel(const int64_t *__restrict__ aff, int aff_coords,
                                const int64_t *__restrict__ proj,
                                int proj_coords, uint8_t *__restrict__ out,
                                long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t *a = aff + 5LL * aff_coords * i;
  const int64_t *q = proj + 5LL * proj_coords * i;
  fe ax = fe_load(a), ay = fe_load(a + 5);
  fe x = fe_load(q), y = fe_load(q + 5), z = fe_load(q + 10);
  out[i] = (uint8_t)(fe_eq(fe_mul(ax, z), x) && fe_eq(fe_mul(ay, z), y));
}

// aff: (n, aff_coords >= 2, 5) int64; proj: (n, proj_coords >= 3, 5)
// int64; out: (n,) bool.
extern "C" int fd_point_eq_affine(const void *aff, int aff_coords,
                                  const void *proj, int proj_coords, void *out,
                                  long long n, void *stream) {
  if (n <= 0) return 0;
  point_eq_kernel<<<fd_blocks(n), FD_THREADS, 0, (cudaStream_t)stream>>>(
      (const int64_t *)aff, aff_coords, (const int64_t *)proj, proj_coords,
      (uint8_t *)out, n);
  return (int)cudaGetLastError();
}
