// K3 double_scalarmult: R' = h*(-A) + s*B, the verify equation's left
// side, over 64 fixed 4-bit windows, most significant
// first: per window four doublings, one add from the lane's [0..15]*A
// table and one from the shared [0..15]*B table.
//
// Replaces the Pallas body firedancer_tpu/ops/dsm_pallas.py:138 _dsm_kernel
// with its B table _btab_const:200, launched at dsm_pallas.py:252.
//
// Bound on this card: integer multiply issue. Per lane: 14 table adds,
// then 64 x (4 doublings + 2 adds), about 1000 squarings and 1850
// multiplies of 15/25 64x64->128 products each; the bytes (64 B of
// scalars and 160 B of point in, 120 B out) are negligible. Design: one
// thread per lane. The accumulator lives in registers; the lane's A
// table (16 entries x 4 x 5 x 8 B = 2.5 KB, in the cached form
// Y+X, Y-X, 2Z, 2dT) is indexed by data and so sits in local memory,
// which L1 serves; the B table (niels form y+x, y-x, 2dxy with Z = 1)
// sits in __constant__ memory, loaded once from the host from the
// oracle's base point. Lanes of a warp read different B entries, so
// constant reads serialise; that is a cost for a later PR.
#include "fe25519.cuh"

struct ge_cached {
  fe YpX, YmX, Z2, T2d;
};

struct ge_niels {
  fe YpX, YmX, T2d;
};

__device__ __constant__ u64 DSM_BTAB[16][3][5];

__device__ __forceinline__ ge_cached ge_to_cached(const ge &p) {
  ge_cached c;
  c.YpX = fe_add(p.Y, p.X);
  c.YmX = fe_sub(p.Y, p.X);
  c.Z2 = fe_add(p.Z, p.Z);
  c.T2d = fe_mul(p.T, fe_load_const(FE_D2));
  return c;
}

// add-2008-hwcd-3 (a = -1), the same field values as the plain
// curve25519.point_add.
__device__ __forceinline__ ge ge_add_cached(const ge &p, const ge_cached &q,
                                            bool need_t) {
  fe a = fe_mul(fe_sub(p.Y, p.X), q.YmX);
  fe b = fe_mul(fe_add(p.Y, p.X), q.YpX);
  fe c = fe_mul(p.T, q.T2d);
  fe d = fe_mul(p.Z, q.Z2);
  fe e = fe_sub(b, a), f = fe_sub(d, c), g = fe_add(d, c), h = fe_add(b, a);
  ge r;
  r.X = fe_mul(e, f);
  r.Y = fe_mul(g, h);
  r.Z = fe_mul(f, g);
  r.T = need_t ? fe_mul(e, h) : fe_zero();
  return r;
}

__device__ __forceinline__ ge ge_add_niels(const ge &p, const ge_niels &q,
                                           bool need_t) {
  fe a = fe_mul(fe_sub(p.Y, p.X), q.YmX);
  fe b = fe_mul(fe_add(p.Y, p.X), q.YpX);
  fe c = fe_mul(p.T, q.T2d);
  fe d = fe_add(p.Z, p.Z);
  fe e = fe_sub(b, a), f = fe_sub(d, c), g = fe_add(d, c), h = fe_add(b, a);
  ge r;
  r.X = fe_mul(e, f);
  r.Y = fe_mul(g, h);
  r.Z = fe_mul(f, g);
  r.T = need_t ? fe_mul(e, h) : fe_zero();
  return r;
}

__device__ __forceinline__ int nibble(const uint8_t *s, int w) {
  return (s[w >> 1] >> (4 * (w & 1))) & 15;
}

__global__ void dsm_kernel(const uint8_t *__restrict__ h_bytes,
                           const int64_t *__restrict__ a_pt, int a_coords,
                           const uint8_t *__restrict__ s_bytes,
                           int64_t *__restrict__ out, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint8_t h[32], s[32];
#pragma unroll
  for (int k = 0; k < 32; k++) {
    h[k] = h_bytes[32 * i + k];
    s[k] = s_bytes[32 * i + k];
  }
  const int64_t *ap = a_pt + 5LL * a_coords * i;
  ge a;
  a.X = fe_load(ap);
  a.Y = fe_load(ap + 5);
  a.Z = fe_load(ap + 10);
  a.T = fe_load(ap + 15);
  a.X = fe_neg(a.X);  // -A
  a.T = fe_neg(a.T);

  ge_cached tab[16];
  tab[0].YpX = fe_one();
  tab[0].YmX = fe_one();
  tab[0].Z2 = fe_add(fe_one(), fe_one());
  tab[0].T2d = fe_zero();
  tab[1] = ge_to_cached(a);
  ge acc = a;
  for (int j = 2; j < 16; j++) {
    acc = ge_add_cached(acc, tab[1], true);
    tab[j] = ge_to_cached(acc);
  }

  ge r;
  r.X = fe_zero();
  r.Y = fe_one();
  r.Z = fe_one();
  r.T = fe_zero();
  for (int w = 63; w >= 0; w--) {
    r = ge_double(r, false);
    r = ge_double(r, false);
    r = ge_double(r, false);
    r = ge_double(r, true);
    r = ge_add_cached(r, tab[nibble(h, w)], true);
    const int sw = nibble(s, w);
    ge_niels bq;
    bq.YpX = fe_load_const(DSM_BTAB[sw][0]);
    bq.YmX = fe_load_const(DSM_BTAB[sw][1]);
    bq.T2d = fe_load_const(DSM_BTAB[sw][2]);
    r = ge_add_niels(r, bq, false);
  }
  int64_t *o = out + 15 * i;
  fe_store_canonical(o + 0, r.X);
  fe_store_canonical(o + 5, r.Y);
  fe_store_canonical(o + 10, r.Z);
}

// btab: host array of 16 x 3 x 5 uint64 (niels form of [0..15]*B).
extern "C" int fd_dsm_set_base_table(const void *btab) {
  return (int)cudaMemcpyToSymbol(DSM_BTAB, btab, sizeof(DSM_BTAB));
}

// h, s: (n, 32) uint8; a: (n, a_coords >= 4, 5) int64 A; out: (n, 3, 5)
// int64 canonical X, Y, Z of h*(-A) + s*B.
extern "C" int fd_double_scalarmult(const void *h, const void *a, int a_coords,
                                    const void *s, void *out, long long n,
                                    void *stream) {
  if (n <= 0) return 0;
  dsm_kernel<<<fd_blocks(n), FD_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t *)h, (const int64_t *)a, a_coords, (const uint8_t *)s,
      (int64_t *)out, n);
  return (int)cudaGetLastError();
}
