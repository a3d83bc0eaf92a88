// K1 sha512_mod_l: h = SHA-512(msg) mod L per lane, as canonical 32-byte
// little-endian scalars.
//
// Replaces the Pallas body firedancer_tpu/ops/frontend_pallas.py:245
// _sha_mod_l_kernel (with sha512_pallas._sha512_rounds:39 and the host
// packing _pack_schedule:141), launched at frontend_pallas.py:290.
//
// A thin entry over the warp-staged core (sha512_warp.cuh): a warp hashes
// 32 lanes, staging each 128-byte block of its rows through shared memory
// with coalesced loads; then per thread the digest, read as a 512-bit
// little-endian integer, reduced mod L by sc_reduce512 (sha512.cuh) and
// stored as four 8-byte words.
//
// Bound on this card: integer ALU issue (rotates, adds and logic of the
// 80 rounds a block); the message bytes are read once. At B = 8192 the
// grid is 256 warps, under one for each of the card's 528 schedulers, so
// each warp runs at its own scheduler's integer-pipe instruction rate,
// not the card's. Blocks of SW_WARPS (two) warps.
#include "sha512_warp.cuh"

__global__ void __launch_bounds__(32 * SW_WARPS)
    sha512_mod_l_kernel(const uint8_t *__restrict__ msgs, long long stride,
                        const int *__restrict__ lens,
                        uint8_t *__restrict__ out, long long n) {
  __shared__ __align__(16) uint32_t stage[SW_WARPS * SW_STAGE];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const long long row0 = ((long long)blockIdx.x * SW_WARPS + wid) * 32;
  if (row0 >= n) return;  // the whole warp: no lane of it is live
  u64 st[8], x[8], r[4];
  sw_hash(stage + wid * SW_STAGE, msgs, stride, lens, n, row0, lane, st);
  const long long i = row0 + lane;
  if (i >= n) return;
  sha512_digest_le(st, x);
  sc_reduce512(x, r);
  sw_store32(out + 32 * i, ((uintptr_t)out & 7) == 0, r);
}

// msgs: (n, stride) uint8; lens: (n,) int32, clamped to [0, stride];
// out: (n, 32) uint8.
extern "C" int fd_sha512_mod_l(const void *msgs, long long stride,
                               const void *lens, void *out, long long n,
                               void *stream) {
  if (n <= 0) return 0;
  sha512_mod_l_kernel<<<sw_blocks(n), 32 * SW_WARPS, 0,
                        (cudaStream_t)stream>>>(
      (const uint8_t *)msgs, stride, (const int *)lens, (uint8_t *)out, n);
  return (int)cudaGetLastError();
}
