// Batched SHA-512 digests: out[i] = SHA-512(msgs[i][0:lens[i]]), 64 bytes.
//
// Replaces the Pallas body firedancer_tpu/ops/sha512_pallas.py:128
// _sha512_kernel (rounds _sha512_rounds:39 over words packed by
// _pack_schedule:141), launched at sha512_pallas.py:220: the staged
// front half's hash (sha512.py:178-186), whose digest XLA then reduces
// mod L, and signing's three hashes.
//
// A thin entry over the warp-staged core (sha512_warp.cuh), as K1
// (sha512_mod_l.cu) without its reduction: a warp hashes 32 lanes,
// staging each 128-byte block of its rows through shared memory with
// coalesced loads; then each live lane stores its digest, the state
// words big-endian, as eight 8-byte stores of the byte-swapped words
// (sha512_digest_le).
//
// Bound on this card: integer ALU issue of the 80 rounds per block; the
// message bytes are read once and 64 bytes written. Blocks of SW_WARPS
// (two) warps.
#include "sha512_warp.cuh"

__global__ void __launch_bounds__(32 * SW_WARPS)
    sha512_batch_kernel(const uint8_t *__restrict__ msgs, long long stride,
                        const int *__restrict__ lens,
                        uint8_t *__restrict__ out, long long n) {
  __shared__ __align__(16) uint32_t stage[SW_WARPS * SW_STAGE];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const long long row0 = ((long long)blockIdx.x * SW_WARPS + wid) * 32;
  if (row0 >= n) return;  // the whole warp: no lane of it is live
  u64 st[8], x[8];
  sw_hash(stage + wid * SW_STAGE, msgs, stride, lens, n, row0, lane, st);
  const long long i = row0 + lane;
  if (i >= n) return;
  sha512_digest_le(st, x);
#pragma unroll
  for (int q = 0; q < 8; q++) ((u64 *)(out + 64 * i))[q] = x[q];
}

// msgs: (n, stride) uint8; lens: (n,) int32, clamped to [0, stride];
// out: (n, 64) uint8, 8-byte aligned (a fresh allocation).
extern "C" int fd_sha512_batch(const void *msgs, long long stride,
                               const void *lens, void *out, long long n,
                               void *stream) {
  if (n <= 0) return 0;
  sha512_batch_kernel<<<sw_blocks(n), 32 * SW_WARPS, 0,
                        (cudaStream_t)stream>>>(
      (const uint8_t *)msgs, stride, (const int *)lens, (uint8_t *)out, n);
  return (int)cudaGetLastError();
}
