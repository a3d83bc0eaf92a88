// Point compression: projective (X:Y:Z) -> the canonical 32-byte
// encoding, y = Y/Z little-endian with the parity of x = X/Z in bit 255.
//
// Replaces the Pallas body firedancer_tpu/ops/curve_pallas.py:307
// _compress_kernel, launched at curve_pallas.py:340 (compress_pallas:318,
// the drop-in for curve25519.compress:229). As there, each lane runs its
// own inversion chain (the XLA compress groups 64 lanes under one
// inversion, which the TPU kernel forgoes too): Z^(p - 2), two
// multiplies, the canonical y bytes, then the sign bit. Z = 0 (no group
// element) inverts to 0 and encodes as zero bytes, as the plain version
// does.
//
// Bound on this card: integer multiply issue (254 squarings and 13
// multiplies a lane) against 152 bytes a lane; the chain is 95 % of K2's.
// Design: decompress_core.cuh's group of five threads a lane (thread j
// owns radix-2^51 limb j; six lanes a warp, threads 30-31 rerunning
// limbs 0-1 of the sixth), which runs K2's chain in a fraction of the
// one-thread time at these lane counts: thread j loads limb j of X, Y
// and Z, the group runs lg_invert and the two multiplies, every thread
// gathers the canonical y and the parity of x, and threads 0-3 each store
// one 8-byte word of the encoding (thread 3 with the sign in bit 63).
// Groups past the batch run the chain on zeros and store nothing; no
// thread returns early, since every shuffle has a full mask.
#include "decompress_core.cuh"

__global__ void __launch_bounds__(DC_THREADS)
    compress_kernel(const int64_t *__restrict__ pt, int coords,
                    uint8_t *__restrict__ out, long long n) {
  const limb_group g = lg_make(n);
  u64 X = 0, Y = 0, Z = 0;
  if (g.live) {
    const int64_t *p = pt + 5LL * coords * g.lane + g.j;
    X = (u64)p[0];
    Y = (u64)p[5];
    Z = (u64)p[10];
  }
  const u64 zinv = lg_invert(g, Z);
  const u64 ax = lg_mul(g, X, zinv);
  const u64 ay = lg_mul(g, Y, zinv);
  const fe c = fe_canonical(lg_gather(g, ay));
  const int sign = lg_is_negative(g, ax);
  // Word j of the little-endian encoding of c, by selects.
  const u64 w = g.j == 0 ? c.v[0] | (c.v[1] << 51)
              : g.j == 1 ? (c.v[1] >> 13) | (c.v[2] << 38)
              : g.j == 2 ? (c.v[2] >> 26) | (c.v[3] << 25)
              : (c.v[3] >> 39) | (c.v[4] << 12) | ((u64)sign << 63);
  if (g.live && g.j < 4) ((u64 *)(out + 32 * g.lane))[g.j] = w;
}

// pt: (n, coords >= 3, 5) int64 X, Y, Z limbs in [0, 2^52); out: (n, 32)
// uint8 encodings, 8-byte aligned (a fresh allocation).
extern "C" int fd_compress(const void *pt, int coords, void *out, long long n,
                           void *stream) {
  if (n <= 0) return 0;
  compress_kernel<<<dc_blocks(n), DC_THREADS, 0, (cudaStream_t)stream>>>(
      (const int64_t *)pt, coords, (uint8_t *)out, n);
  return (int)cudaGetLastError();
}
