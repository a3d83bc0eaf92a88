// Point compression: projective (X:Y:Z) -> the canonical 32-byte
// encoding, y = Y/Z little-endian with the parity of x = X/Z in bit 255.
//
// Replaces the Pallas body firedancer_tpu/ops/curve_pallas.py:307
// _compress_kernel, launched at curve_pallas.py:340 (compress_pallas:318,
// the drop-in for curve25519.compress:229). As there, each lane runs its
// own inversion chain (the XLA compress groups 64 lanes under one
// inversion, which the TPU kernel forgoes too): Z^(p - 2) by fe_invert of
// fe25519.cuh, two multiplies, the canonical y bytes, then the sign bit.
// Z = 0 (no group element) inverts to 0 and encodes as zero bytes, as
// the plain version does.
//
// Bound on this card: integer multiply issue (254 squarings and 13
// multiplies a lane) against 152 bytes a lane. Design: one thread per
// lane, everything in registers; the 32 output bytes are written by each
// thread in turn.
#include "fe25519.cuh"

// Canonical little-endian bytes of a (bit 255 is 0, since a < p).
__device__ __forceinline__ void fe_to_bytes(uint8_t *o, const fe &a) {
  const fe c = fe_canonical(a);
  const u64 w[4] = {c.v[0] | (c.v[1] << 51), (c.v[1] >> 13) | (c.v[2] << 38),
                    (c.v[2] >> 26) | (c.v[3] << 25),
                    (c.v[3] >> 39) | (c.v[4] << 12)};
#pragma unroll
  for (int k = 0; k < 4; k++)
#pragma unroll
    for (int b = 0; b < 8; b++) o[8 * k + b] = (uint8_t)(w[k] >> (8 * b));
}

__global__ void compress_kernel(const int64_t *__restrict__ pt, int coords,
                                uint8_t *__restrict__ out, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t *p = pt + 5LL * coords * i;
  const fe zinv = fe_invert(fe_load(p + 10));
  const fe ax = fe_mul(fe_load(p), zinv);
  const fe ay = fe_mul(fe_load(p + 5), zinv);
  uint8_t *o = out + 32 * i;
  fe_to_bytes(o, ay);
  o[31] |= (uint8_t)(fe_is_negative(ax) << 7);
}

// pt: (n, coords >= 3, 5) int64 X, Y, Z limbs in [0, 2^52); out: (n, 32)
// uint8 encodings.
extern "C" int fd_compress(const void *pt, int coords, void *out, long long n,
                           void *stream) {
  if (n <= 0) return 0;
  compress_kernel<<<fd_blocks(n), FD_THREADS, 0, (cudaStream_t)stream>>>(
      (const int64_t *)pt, coords, (uint8_t *)out, n);
  return (int)cudaGetLastError();
}
