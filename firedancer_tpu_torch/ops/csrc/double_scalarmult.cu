// K3 double_scalarmult: R' = h*(-A) + s*B, the verify equation's left
// side, over 64 fixed 4-bit windows, most significant first: per window
// four doublings, one add from the lane's [0..15]*A table and one from
// the shared [0..15]*B table.
//
// Replaces the Pallas body firedancer_tpu/ops/dsm_pallas.py:138 _dsm_kernel
// with its B table _btab_const:200, launched at dsm_pallas.py:252.
//
// Bound on this card: integer multiply issue. Per lane: 14 table adds,
// then 64 x (4 doublings + 2 adds), about 1000 squarings and 1850
// multiplies of 15/25 64x64->128 products each; the bytes (64 B of
// scalars and 160 B of point in, 120 B out) are negligible. One thread
// a lane leaves the card latency-bound: each window is a chain of ~43
// dependent field operations, and at B = 8192 only 64 blocks of 128
// threads exist for 132 SMs.
//
// Design (the quad helpers live in ge_quad.cuh, shared with the MSM
// tails): a quad of four threads a lane (threads 4k .. 4k+3 of a warp),
// thread q holding coordinate q of the extended accumulator (X, Y, Z, T)
// as one fe. Each step runs the one-thread formulas (dbl-2008-hwcd,
// add-2008-hwcd-3) with their operands in their order; only which
// thread computes what changes:
//   doubling   stage 1: q0 X^2, q1 Y^2, q2 2 Z^2, q3 (X + Y)^2 (X, Y
//              reach q3 by width-4 shuffles);
//   add        stage 1: q0 a = (Y - X) YmX, q1 b = (Y + X) YpX,
//              q2 c = T T2d, q3 d = Z Z2 (one xor-1 shuffle hands q0 Y,
//              q1 X, q2 T, q3 Z);
//   both       exchange the four stage-1 values in the quad; every thread
//              forms d/e/f/g/h with the same calls in the same order;
//              stage 2: q0 X' = e f, q1 Y' = g h, q2 Z' = f g, q3 T' = e h.
// So the dependent chain of a window falls to 6 x 2 field operations
// plus the exchanges, and B = 8192 launches 32,768 threads. T is always
// computed (q3 would idle otherwise); no doubling reads it. The B add
// is the cached add with Z2 = 2: 2 Z equals Z + Z as a field element.
// The canonical X, Y, Z equal the plain version's limb for limb
// (dsm_cuda.double_scalarmult_ref): same formulas, same unsigned
// windows, same 14-add table build, same add order, tab[0] included.
//
// Tables: each thread keeps only the table coordinate it consumes (q0
// Y - X, q1 Y + X, q2 2dT, q3 2Z) and builds coordinate q of every
// entry. The A column, 16 entries x 5 limbs x 8 B = 640 B a thread,
// sits in dynamic shared memory as [entry][limb][thread], so that a
// warp's load hits consecutive words whatever entries its lanes index
// (80 KB a block of 128 threads). The B table comes in as a device
// tensor (dsm_cuda.base_table, (16, 3, 5) y + x, y - x, 2dxy) and each
// block copies it into static shared memory in quad order at its start.
//
// Launch: ceil(n / 32) blocks of 128 threads. A lane past n reruns lane
// n - 1 and skips the store, since a shuffle with a full mask needs
// every thread of the warp. ptxas -v (sm_90a, CUDA 12.8): 140 registers,
// 0 bytes of stack, 0 spills, 2,560 B of static shared memory; with the
// 81,920 B of dynamic shared memory the occupancy API gives 2 blocks an
// SM on an H100, so B = 8192 (256 blocks) runs in one wave. chip_smoke.py
// prints both reports (phases 2 and 3, fd_dsm_kernel_info).
#include "ge_quad.cuh"

#define DSM_LANES 32                 // lanes a block
#define DSM_THREADS (4 * DSM_LANES)  // a quad a lane
#define DSM_ATAB_BYTES (16 * 5 * DSM_THREADS * 8)

__device__ __forceinline__ u64 load_le64(const uint8_t *p) {
  u64 x = 0;
#pragma unroll
  for (int j = 0; j < 8; j++) x |= (u64)p[j] << (8 * j);
  return x;
}

__device__ __forceinline__ u64 pick_word(int k, u64 w0, u64 w1, u64 w2,
                                         u64 w3) {
  return k == 0 ? w0 : k == 1 ? w1 : k == 2 ? w2 : w3;
}

__global__ void __launch_bounds__(DSM_THREADS, 2)
    dsm_kernel(const uint8_t *__restrict__ h_bytes,
               const int64_t *__restrict__ a_pt, int a_coords,
               const uint8_t *__restrict__ s_bytes,
               const int64_t *__restrict__ btab_in,
               int64_t *__restrict__ out, long long n) {
  extern __shared__ u64 atab[];       // [entry][limb][thread]
  __shared__ u64 btab[16 * 4 * 5];    // [entry][q][limb]
  const int tid = threadIdx.x, q = tid & 3;
  const long long lane = (long long)blockIdx.x * DSM_LANES + (tid >> 2);
  const long long i = lane < n ? lane : n - 1;

  // B in quad order: q0 y - x, q1 y + x, q2 2dxy (input coordinates 1,
  // 0, 2), q3 the constant 2.
  for (int k = tid; k < 16 * 4 * 5; k += DSM_THREADS) {
    const int e = k / 20, c = (k / 5) & 3, l = k % 5;
    btab[k] = c == 3 ? (l == 0 ? 2 : 0)
                     : (u64)btab_in[(3 * e + (c == 2 ? 2 : 1 - c)) * 5 + l];
  }

  const uint8_t *hp = h_bytes + 32 * i, *sp = s_bytes + 32 * i;
  const u64 h0 = load_le64(hp), h1 = load_le64(hp + 8),
            h2 = load_le64(hp + 16), h3 = load_le64(hp + 24);
  const u64 s0 = load_le64(sp), s1 = load_le64(sp + 8),
            s2 = load_le64(sp + 16), s3 = load_le64(sp + 24);

  // Coordinate q of -A = (-X, Y, Z, -T).
  const fe a_in = fe_load(a_pt + 5LL * (a_coords * i + q));
  const fe a_neg = fe_neg(a_in);
  const fe a = fe_pick(q, a_neg, a_in, a_in, a_neg);

  // The A column: tab[0] the cached identity (1, 1, 0, 2), tab[1] -A,
  // tab[j] = tab[j - 1] + (-A) by 14 adds.
  u64 *col = atab + tid;
  const fe id_c = fe_pick(q, fe_one(), fe_one(), fe_zero(),
                          fe_add(fe_one(), fe_one()));
  const fe a_c = quad_cached(q, a);
#pragma unroll
  for (int l = 0; l < 5; l++) {
    col[l * DSM_THREADS] = id_c.v[l];
    col[(5 + l) * DSM_THREADS] = a_c.v[l];
  }
  fe acc = a;
#pragma unroll 1
  for (int j = 2; j < 16; j++) {
    acc = quad_add(q, acc, a_c);
    const fe c = quad_cached(q, acc);
#pragma unroll
    for (int l = 0; l < 5; l++) col[(5 * j + l) * DSM_THREADS] = c.v[l];
  }
  __syncthreads();  // btab

  fe r = fe_pick(q, fe_zero(), fe_one(), fe_one(), fe_zero());
#pragma unroll 1
  for (int k = 3; k >= 0; k--) {
    u64 hw = pick_word(k, h0, h1, h2, h3), sw = pick_word(k, s0, s1, s2, s3);
#pragma unroll 1
    for (int j = 0; j < 16; j++) {  // window 16 k + 15 - j
      const int hn = (int)(hw >> 60), sn = (int)(sw >> 60);
      hw <<= 4;
      sw <<= 4;
      r = quad_double(q, r);
      r = quad_double(q, r);
      r = quad_double(q, r);
      r = quad_double(q, r);
      fe ta, tb;
#pragma unroll
      for (int l = 0; l < 5; l++) {
        ta.v[l] = col[(5 * hn + l) * DSM_THREADS];
        tb.v[l] = btab[(4 * sn + q) * 5 + l];
      }
      r = quad_add(q, r, ta);
      r = quad_add(q, r, tb);
    }
  }
  if (lane < n && q < 3) fe_store_canonical(out + 15 * lane + 5 * q, r);
}

// 80 KB of dynamic shared memory needs the opt-in; the carveout asks for
// the most shared memory, so that two blocks fit an SM.
static cudaError_t dsm_opt_in() {
  const cudaError_t rc = cudaFuncSetAttribute(
      dsm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DSM_ATAB_BYTES);
  if (rc != cudaSuccess) return rc;
  return cudaFuncSetAttribute(dsm_kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// h, s: (n, 32) uint8; a: (n, a_coords >= 4, 5) int64 A; btab: (16, 3, 5)
// int64 niels form of [0..15]*B; out: (n, 3, 5) int64 canonical X, Y, Z
// of h*(-A) + s*B.
extern "C" int fd_double_scalarmult(const void *h, const void *a, int a_coords,
                                    const void *s, const void *btab, void *out,
                                    long long n, void *stream) {
  if (n <= 0) return 0;
  const cudaError_t rc = dsm_opt_in();
  if (rc != cudaSuccess) return (int)rc;
  const unsigned blocks = (unsigned)((n + DSM_LANES - 1) / DSM_LANES);
  dsm_kernel<<<blocks, DSM_THREADS, DSM_ATAB_BYTES, (cudaStream_t)stream>>>(
      (const uint8_t *)h, (const int64_t *)a, a_coords, (const uint8_t *)s,
      (const int64_t *)btab, (int64_t *)out, n);
  return (int)cudaGetLastError();
}

// info[0..5]: registers a thread, local (stack) bytes a thread, static
// shared bytes a block, dynamic shared bytes a block, threads a block,
// resident blocks an SM (the occupancy API) on the current device.
extern "C" int fd_dsm_kernel_info(int *info) {
  cudaError_t rc = dsm_opt_in();
  if (rc != cudaSuccess) return (int)rc;
  cudaFuncAttributes attr;
  rc = cudaFuncGetAttributes(&attr, dsm_kernel);
  if (rc != cudaSuccess) return (int)rc;
  int blocks = 0;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, dsm_kernel,
                                                     DSM_THREADS,
                                                     DSM_ATAB_BYTES);
  if (rc != cudaSuccess) return (int)rc;
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  info[2] = (int)attr.sharedSizeBytes;
  info[3] = DSM_ATAB_BYTES;
  info[4] = DSM_THREADS;
  info[5] = blocks;
  return 0;
}
