// K1 sha512_mod_l: h = SHA-512(msg) mod L per lane, as canonical 32-byte
// little-endian scalars.
//
// Replaces the Pallas body firedancer_tpu/ops/frontend_pallas.py:245
// _sha_mod_l_kernel (with sha512_pallas._sha512_rounds:39 and the host
// packing _pack_schedule:141), launched at frontend_pallas.py:290.
//
// Per lane (one thread each): sha512_row, then the digest, read as a
// 512-bit little-endian integer, reduced mod L by sc_reduce512 (both in
// sha512.cuh).
//
// Bound on this card: integer ALU issue (rotates, adds and logic of the
// 80 rounds); the message bytes are read once. Design: one thread per
// lane with state and schedule in registers. Rows are read byte-wise with
// a stride of max_len, which is uncoalesced; the bytes are few next to
// the round arithmetic.
#include "sha512.cuh"

__global__ void sha512_mod_l_kernel(const uint8_t *__restrict__ msgs,
                                    long long stride,
                                    const int *__restrict__ lens,
                                    uint8_t *__restrict__ out, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  u64 st[8], x[8], r[4];
  sha512_row(msgs + stride * i, lens[i], stride, st);
  sha512_digest_le(st, x);
  sc_reduce512(x, r);
  sc_store(out + 32 * i, r);
}

// msgs: (n, stride) uint8; lens: (n,) int32, clamped to [0, stride];
// out: (n, 32) uint8.
extern "C" int fd_sha512_mod_l(const void *msgs, long long stride,
                               const void *lens, void *out, long long n,
                               void *stream) {
  if (n <= 0) return 0;
  sha512_mod_l_kernel<<<fd_blocks(n), FD_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t *)msgs, stride, (const int *)lens, (uint8_t *)out, n);
  return (int)cudaGetLastError();
}
