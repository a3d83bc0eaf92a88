// Bucket aggregation of the Pippenger MSM: per window column,
// sum_b b * S_b by the two running sums from the top bucket down to 1
// (S += bucket b, T += S); bucket 0 is never read.
//
// Replaces firedancer_tpu/ops/msm_pallas.py:305 aggregate_buckets_pallas
// (pallas_call at :353), whose sequential grid walks the buckets with the
// two sums resident in VMEM across a tile of window columns. Here the walk
// is a loop inside one thread per column.
//
// Bound on this card: latency. Each column is a chain of 2 (nb - 2)
// dependent unified adds (9 multiplies each): 252 adds for nb = 128, 60
// for the 32-bucket torsion grid. At the main path's shapes the launch has
// 18, 37 or 64 threads, so almost all of the card idles and the time is
// one thread's chain. Design: the simplest one, recorded with its time;
// a later PR can split the bucket range of a column over threads (each
// piece needs its own offset term) and combine the pieces in a tree.
#include "msm.cuh"

#define AGG_THREADS 32

__global__ void msm_aggregate_kernel(const int64_t *__restrict__ buckets,
                                     int64_t *__restrict__ out, int ncols,
                                     int nb) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= ncols) return;
  const int64_t *col = buckets + 20LL * nb * c;
  ge s = ge_load(col + 20LL * (nb - 1));
  ge t = s;
  for (int b = nb - 2; b >= 1; b--) {
    s = ge_add_ext(s, ge_load(col + 20LL * b));
    t = ge_add_ext(t, s);
  }
  ge_store_canonical(out + 20LL * c, t);
}

// buckets: (ncols, nb, 4, 5) int64; out: (ncols, 4, 5) int64.
extern "C" int fd_msm_aggregate(const void *buckets, void *out, int ncols,
                                int nb, void *stream) {
  if (ncols <= 0) return 0;
  const unsigned blocks = (unsigned)((ncols + AGG_THREADS - 1) / AGG_THREADS);
  msm_aggregate_kernel<<<blocks, AGG_THREADS, 0, (cudaStream_t)stream>>>(
      (const int64_t *)buckets, (int64_t *)out, ncols, nb);
  return (int)cudaGetLastError();
}
