// The RLC pass's scalar front half in one launch: h = SHA-512(r || A ||
// msg) mod L, m = z h mod L and zs = z s mod L per lane, as canonical
// 32-byte little-endian scalars.
//
// Replaces the Pallas body firedancer_tpu/ops/frontend_pallas.py:251
// _frontend_rlc_kernel (sha512_pallas._sha512_rounds:39, _barrett_f:182,
// _mul_mod_l_f:210, _digest_limbs:224), launched at frontend_pallas.py:319.
// The TPU kernel keeps the digest and the scalars in VMEM in a folded
// (8, B/8) byte-limb layout so that its Barrett and 32x32 schoolbook
// convolutions are full-width vector ops; here each lane is one thread
// and the whole chain stays in registers: sha512_row and sc_reduce512,
// then z h and z s as 4x4 64-bit-limb products (mul256, HAC 14.12)
// reduced by the same Barrett (all three in sha512.cuh). z carries the caller's live-lane masking:
// a dead lane has z = 0, so m = zs = 0, as in the JAX kernel
// (frontend_pallas.py:304-306).
//
// Bound on this card: integer ALU issue of the SHA-512 rounds (the
// products and reductions add ~110 64-bit products per lane, under a
// tenth of a 3-block row's rounds); bytes are read once. Design: one
// thread per lane, as K1, which this kernel extends by the two products.
#include "sha512.cuh"

__global__ void frontend_rlc_kernel(const uint8_t *__restrict__ msgs,
                                    long long stride,
                                    const int *__restrict__ lens,
                                    const uint8_t *__restrict__ z_in,
                                    const uint8_t *__restrict__ s_in,
                                    uint8_t *__restrict__ h_out,
                                    uint8_t *__restrict__ m_out,
                                    uint8_t *__restrict__ zs_out,
                                    long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  u64 st[8], x[8], h[4], z[4], s[4], r[4];
  sha512_row(msgs + stride * i, lens[i], stride, st);
  sha512_digest_le(st, x);
  sc_reduce512(x, h);
  sc_store(h_out + 32 * i, h);
  sc_load(z_in + 32 * i, z);
  sc_load(s_in + 32 * i, s);
  mul256(z, h, x);
  sc_reduce512(x, r);
  sc_store(m_out + 32 * i, r);
  mul256(z, s, x);
  sc_reduce512(x, r);
  sc_store(zs_out + 32 * i, r);
}

// msgs: (n, stride) uint8; lens: (n,) int32, clamped to [0, stride];
// z, s: (n, 32) uint8; h, m, zs: (n, 32) uint8.
extern "C" int fd_frontend_rlc(const void *msgs, long long stride,
                               const void *lens, const void *z,
                               const void *s, void *h, void *m, void *zs,
                               long long n, void *stream) {
  if (n <= 0) return 0;
  frontend_rlc_kernel<<<fd_blocks(n), FD_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t *)msgs, stride, (const int *)lens, (const uint8_t *)z,
      (const uint8_t *)s, (uint8_t *)h, (uint8_t *)m, (uint8_t *)zs, n);
  return (int)cudaGetLastError();
}
