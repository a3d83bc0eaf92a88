// Point formulas of the Pippenger MSM kernels, after
// firedancer_tpu/ops/msm_pallas.py, so that a kernel and its plain
// version (firedancer_tpu_torch/ops/msm_cuda.py) that add in the same
// order give the same projective point:
//   ge_madd_niels  _madd_niels:52      extended + niels (Z = 1), 7 M
//   ge_add_ext     _point_add_ext:69   unified extended add, 9 M
//   ge_double      _point_double_ext:230 (fe25519.cuh; 4 S + 4 M)
// Points cross as int64 (n, 4, 5) radix-2^51 limbs X, Y, Z, T; inputs may
// carry limbs up to 2^52, outputs are stored canonical. A point moved
// between the threads of a warp (ge_add_ext_shfl_*) keeps its limbs as
// they are: every formula's output is fe_mul's (limbs < 2^52,
// fe25519.cuh), so a shuffled point is as valid an operand as one the
// thread made itself.
#pragma once

#include "fe25519.cuh"

struct msm_niels {
  fe YpX, YmX, T2d;
};

__device__ __forceinline__ ge ge_identity() {
  ge r;
  r.X = fe_zero();
  r.Y = fe_one();
  r.Z = fe_one();
  r.T = fe_zero();
  return r;
}

__device__ __forceinline__ ge ge_load(const int64_t *p) {
  ge r;
  r.X = fe_load(p);
  r.Y = fe_load(p + 5);
  r.Z = fe_load(p + 10);
  r.T = fe_load(p + 15);
  return r;
}

__device__ __forceinline__ void ge_store_canonical(int64_t *p, const ge &a) {
  fe_store_canonical(p, a.X);
  fe_store_canonical(p + 5, a.Y);
  fe_store_canonical(p + 10, a.Z);
  fe_store_canonical(p + 15, a.T);
}

__device__ __forceinline__ ge ge_madd_niels(const ge &p, const msm_niels &q) {
  fe a = fe_mul(fe_sub(p.Y, p.X), q.YmX);
  fe b = fe_mul(fe_add(p.Y, p.X), q.YpX);
  fe c = fe_mul(p.T, q.T2d);
  fe d = fe_add(p.Z, p.Z);
  fe e = fe_sub(b, a), f = fe_sub(d, c), g = fe_add(d, c), h = fe_add(b, a);
  ge r;
  r.X = fe_mul(e, f);
  r.Y = fe_mul(g, h);
  r.Z = fe_mul(f, g);
  r.T = fe_mul(e, h);
  return r;
}

__device__ __forceinline__ const fe &ge_coord(const ge &p, int k) {
  return k == 0 ? p.X : k == 1 ? p.Y : k == 2 ? p.Z : p.T;
}

// p + q, where other(k) gives q's coordinate k (0 X, 1 Y, 2 Z, 3 T) as
// the formula reaches it: a point in registers, or another thread's
// point fetched by shuffles one coordinate at a time, so that it never
// lives whole in registers (ge_add_ext_shfl_*).
template <typename Other>
__device__ __forceinline__ ge ge_add_ext_with(const ge &p, Other other) {
  const fe qx = other(0), qy = other(1);
  fe a = fe_mul(fe_sub(p.Y, p.X), fe_sub(qy, qx));
  fe b = fe_mul(fe_add(p.Y, p.X), fe_add(qy, qx));
  fe c = fe_mul(fe_mul(p.T, other(3)), fe_load_const(FE_D2));
  fe zz = fe_mul(p.Z, other(2));
  fe d = fe_add(zz, zz);
  fe e = fe_sub(b, a), f = fe_sub(d, c), g = fe_add(d, c), h = fe_add(b, a);
  ge r;
  r.X = fe_mul(e, f);
  r.Y = fe_mul(g, h);
  r.Z = fe_mul(f, g);
  r.T = fe_mul(e, h);
  return r;
}

__device__ __forceinline__ ge ge_add_ext(const ge &p, const ge &q) {
  return ge_add_ext_with(p, [&q](int k) { return ge_coord(q, k); });
}

// p plus the point of the thread o lanes away (xor) or o lanes up
// (down; past the warp's end a thread gets its own point). Every thread
// of the warp must call it.
__device__ __forceinline__ ge ge_add_ext_shfl_xor(const ge &p, int o) {
  return ge_add_ext_with(
      p, [&p, o](int k) { return fe_shfl_xor(ge_coord(p, k), o); });
}

__device__ __forceinline__ ge ge_add_ext_shfl_down(const ge &p, int o) {
  return ge_add_ext_with(
      p, [&p, o](int k) { return fe_shfl_down(ge_coord(p, k), o); });
}

// Sum over aligned groups of `width` threads (a power of two <= 32) by a
// butterfly: at offsets width/2, ..., 1 each thread adds its partner's
// point. Thread 0 of a group ends with the tree in which, at offset o,
// point i < o takes point i + o (msm_cuda._warp_tree).
__device__ __forceinline__ ge ge_warp_tree(ge acc, int width) {
  for (int o = width >> 1; o > 0; o >>= 1)
    acc = ge_add_ext_shfl_xor(acc, o);
  return acc;
}
