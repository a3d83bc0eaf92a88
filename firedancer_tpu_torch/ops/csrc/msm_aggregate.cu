// Bucket aggregation of the Pippenger MSM: per window column,
// W = sum_b b * S_b over the live buckets b = 1 .. nb - 1 (bucket 0 is
// never read).
//
// Replaces firedancer_tpu/ops/msm_pallas.py:305 aggregate_buckets_pallas
// (pallas_call at :353), whose sequential grid walks the buckets from
// the top with two running sums resident in VMEM across a tile of window
// columns: 2 (nb - 2) dependent unified adds a column.
//
// Thread mapping: one warp per column, four columns a block. Thread j
// takes the s consecutive buckets lo_j = 1 + j s .. min(lo_j + s - 1,
// nb - 1), s the least power of two with 32 s >= nb - 1
// (msm_cuda.aggregate_segment; a segment past nb - 1 is empty and a
// last one may be short). Over its segment, from the top, the thread
// runs the two running sums, S_j = sum S_b and T_j = sum (b - lo_j + 1)
// S_b. Since b = (b - lo_j + 1) + j s,
//   W = sum_j T_j + s * sum_j j S_j,
// and sum_j j S_j = sum_{j >= 1} U_j with U_j = sum_{i >= j} S_i, the
// warp's suffix sums: a shuffle scan of 5 levels. Each thread then
// doubles its U_j log2 s times (U_0 is replaced by the identity), adds
// T_j, and the 32 points meet in a butterfly of 5 unified adds
// (ge_warp_tree); thread 0 stores the canonical point. Empty segments
// hold the exact identity (0, 1, 1, 0).
//
// Bound on this card: latency of one thread's chain. For nb = 128
// (s = 4): 2 (s - 1) = 6 segment adds, 5 scan adds, 2 doublings, 1 add
// and 5 tree adds, 19 steps against 252 adds when one thread walked the
// column; for the torsion grid's nb = 32 (s = 1): 11 against 60. The
// work (about 17,700 adds at the main path's shapes) is far below the
// card's multiply rate, and the launch has (18 + 37 + 64) x 32 threads.
//
// Registers (ptxas -v, CUDA 12.8, printed by chip_smoke.py phase 2):
// 214, no stack, no spills; at most 119 warps run, so they cost no
// occupancy that matters.
#include "msm.cuh"

#define AGG_WARP 32
#define AGG_THREADS 128

__global__ void __launch_bounds__(AGG_THREADS)
    msm_aggregate_kernel(const int64_t *__restrict__ buckets,
                         int64_t *__restrict__ out, int ncols, int nb,
                         int log_seg) {
  const int col = (int)(((long long)blockIdx.x * blockDim.x + threadIdx.x) /
                        AGG_WARP);
  const int j = (int)(threadIdx.x % AGG_WARP);
  if (col >= ncols) return;  // the whole warp
  const int64_t *base = buckets + 20LL * nb * col;
  const int lo = 1 + (j << log_seg);
  const int hi = min(lo + (1 << log_seg) - 1, nb - 1);
  ge s = ge_identity(), t = ge_identity();
  if (lo <= hi) {
    s = ge_load(base + 20LL * hi);
    t = s;
    for (int b = hi - 1; b >= lo; b--) {
      s = ge_add_ext(s, ge_load(base + 20LL * b));
      t = ge_add_ext(t, s);
    }
  }
  // Suffix sums U_j = sum_{i >= j} S_i (Kogge-Stone over the warp).
  ge u = s;
  for (int o = 1; o < AGG_WARP; o <<= 1) {
    const ge v = ge_add_ext_shfl_down(u, o);
    if (j + o < AGG_WARP) u = v;
  }
  if (j == 0) u = ge_identity();
  for (int k = 0; k < log_seg; k++) u = ge_double(u, true);
  ge w = ge_warp_tree(ge_add_ext(t, u), AGG_WARP);
  if (j == 0) ge_store_canonical(out + 20LL * col, w);
}

// buckets: (ncols, nb, 4, 5) int64; out: (ncols, 4, 5) int64; seg:
// buckets per thread, a power of two with 32 seg >= nb - 1.
extern "C" int fd_msm_aggregate(const void *buckets, void *out, int ncols,
                                int nb, int seg, void *stream) {
  if (nb < 2 || seg < 1 || (seg & (seg - 1)) != 0 ||
      (long long)AGG_WARP * seg < nb - 1)
    return (int)cudaErrorInvalidValue;
  if (ncols <= 0) return 0;
  int log_seg = 0;
  while ((1 << log_seg) < seg) log_seg++;
  const long long threads = (long long)ncols * AGG_WARP;
  const unsigned blocks = (unsigned)((threads + AGG_THREADS - 1) / AGG_THREADS);
  msm_aggregate_kernel<<<blocks, AGG_THREADS, 0, (cudaStream_t)stream>>>(
      (const int64_t *)buckets, (int64_t *)out, ncols, nb, log_seg);
  return (int)cudaGetLastError();
}
