// The RLC pass's scalar front half in one launch: h = SHA-512(r || A ||
// msg) mod L, m = z h mod L and zs = z s mod L per lane, as canonical
// 32-byte little-endian scalars.
//
// Replaces the Pallas body firedancer_tpu/ops/frontend_pallas.py:251
// _frontend_rlc_kernel (sha512_pallas._sha512_rounds:39, _barrett_f:182,
// _mul_mod_l_f:210, _digest_limbs:224), launched at frontend_pallas.py:319.
// The TPU kernel keeps the digest and the scalars in VMEM in a folded
// (8, B/8) byte-limb layout so that its Barrett and 32x32 schoolbook
// convolutions are full-width vector ops. Here K1's warp-staged core
// (sha512_warp.cuh) hashes 32 lanes a warp; then each thread keeps its
// lane's chain in registers: sc_reduce512, then z h and z s as 8 x 8
// 32-bit-word products on PTX carry chains (mul256, HAC 14.12) reduced
// by the same Barrett (sha512.cuh), z and s read and h, m, zs written as
// 8-byte words. z
// carries the caller's live-lane masking: a dead lane has z = 0, so
// m = zs = 0, as in the JAX kernel (frontend_pallas.py:304-306).
//
// Bound on this card: integer ALU issue of the SHA-512 rounds (the
// products and reductions add ~110 64-bit products per lane, under a
// tenth of a 3-block row's rounds); bytes are read once. Geometry as K1's.
#include "sha512_warp.cuh"

__global__ void __launch_bounds__(32 * SW_WARPS)
    frontend_rlc_kernel(const uint8_t *__restrict__ msgs, long long stride,
                        const int *__restrict__ lens,
                        const uint8_t *__restrict__ z_in,
                        const uint8_t *__restrict__ s_in,
                        uint8_t *__restrict__ h_out,
                        uint8_t *__restrict__ m_out,
                        uint8_t *__restrict__ zs_out, long long n) {
  __shared__ __align__(16) uint32_t stage[SW_WARPS * SW_STAGE];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const long long row0 = ((long long)blockIdx.x * SW_WARPS + wid) * 32;
  if (row0 >= n) return;  // the whole warp: no lane of it is live
  u64 st[8], x[8], h[4], z[4], s[4], r[4];
  sw_hash(stage + wid * SW_STAGE, msgs, stride, lens, n, row0, lane, st);
  const long long i = row0 + lane;
  if (i >= n) return;
  const bool al8 = (((uintptr_t)z_in | (uintptr_t)s_in | (uintptr_t)h_out |
                     (uintptr_t)m_out | (uintptr_t)zs_out) & 7) == 0;
  sha512_digest_le(st, x);
  sc_reduce512(x, h);
  sw_store32(h_out + 32 * i, al8, h);
  sw_load32(z_in + 32 * i, al8, z);
  sw_load32(s_in + 32 * i, al8, s);
  mul256(z, h, x);
  sc_reduce512(x, r);
  sw_store32(m_out + 32 * i, al8, r);
  mul256(z, s, x);
  sc_reduce512(x, r);
  sw_store32(zs_out + 32 * i, al8, r);
}

// msgs: (n, stride) uint8; lens: (n,) int32, clamped to [0, stride];
// z, s: (n, 32) uint8; h, m, zs: (n, 32) uint8.
extern "C" int fd_frontend_rlc(const void *msgs, long long stride,
                               const void *lens, const void *z,
                               const void *s, void *h, void *m, void *zs,
                               long long n, void *stream) {
  if (n <= 0) return 0;
  frontend_rlc_kernel<<<sw_blocks(n), 32 * SW_WARPS, 0,
                        (cudaStream_t)stream>>>(
      (const uint8_t *)msgs, stride, (const int *)lens, (const uint8_t *)z,
      (const uint8_t *)s, (uint8_t *)h, (uint8_t *)m, (uint8_t *)zs, n);
  return (int)cudaGetLastError();
}
