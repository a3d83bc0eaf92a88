// Batched SHA-512 digests: out[i] = SHA-512(msgs[i][0:lens[i]]), 64 bytes.
//
// Replaces the Pallas body firedancer_tpu/ops/sha512_pallas.py:128
// _sha512_kernel (rounds _sha512_rounds:39 over words packed by
// _pack_schedule:141), launched at sha512_pallas.py:220: the staged
// front half's hash (sha512.py:178-186), whose digest XLA then reduces
// mod L. Per lane (one thread each): sha512_row (sha512.cuh), the state
// words written big-endian.
//
// Bound on this card: integer ALU issue of the 80 rounds per block; the
// message bytes are read once and 64 bytes written. Design: one thread
// per lane, state and schedule in registers, the rounds K1 runs.
#include "sha512.cuh"

__global__ void sha512_batch_kernel(const uint8_t *__restrict__ msgs,
                                    long long stride,
                                    const int *__restrict__ lens,
                                    uint8_t *__restrict__ out, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  u64 st[8];
  sha512_row(msgs + stride * i, lens[i], stride, st);
  uint8_t *o = out + 64 * i;
#pragma unroll
  for (int k = 0; k < 8; k++)
#pragma unroll
    for (int b = 0; b < 8; b++) o[8 * k + b] = (uint8_t)(st[k] >> (56 - 8 * b));
}

// msgs: (n, stride) uint8; lens: (n,) int32, clamped to [0, stride];
// out: (n, 64) uint8.
extern "C" int fd_sha512_batch(const void *msgs, long long stride,
                               const void *lens, void *out, long long n,
                               void *stream) {
  if (n <= 0) return 0;
  sha512_batch_kernel<<<fd_blocks(n), FD_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t *)msgs, stride, (const int *)lens, (uint8_t *)out, n);
  return (int)cudaGetLastError();
}
