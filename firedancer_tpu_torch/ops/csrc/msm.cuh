// Point formulas of the Pippenger MSM kernels, after
// firedancer_tpu/ops/msm_pallas.py, in its order, so that a kernel, its
// plain version (firedancer_tpu_torch/ops/msm_cuda.py) and the JAX kernel
// give the same projective point:
//   ge_madd_niels  _madd_niels:52      extended + niels (Z = 1), 7 M
//   ge_add_ext     _point_add_ext:69   unified extended add, 9 M
//   ge_double      _point_double_ext:230 (fe25519.cuh; 4 S + 4 M)
// Points cross as int64 (n, 4, 5) radix-2^51 limbs X, Y, Z, T; inputs may
// carry limbs up to 2^52, outputs are stored canonical.
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

__device__ __forceinline__ ge ge_add_ext(const ge &p, const ge &q) {
  fe a = fe_mul(fe_sub(p.Y, p.X), fe_sub(q.Y, q.X));
  fe b = fe_mul(fe_add(p.Y, p.X), fe_add(q.Y, q.X));
  fe c = fe_mul(fe_mul(p.T, q.T), fe_load_const(FE_D2));
  fe zz = fe_mul(p.Z, q.Z);
  fe d = fe_add(zz, zz);
  fe e = fe_sub(b, a), f = fe_sub(d, c), g = fe_add(d, c), h = fe_add(b, a);
  ge r;
  r.X = fe_mul(e, f);
  r.Y = fe_mul(g, h);
  r.Z = fe_mul(f, g);
  r.T = fe_mul(e, h);
  return r;
}
