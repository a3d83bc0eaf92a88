// Bucket fill of the Pippenger MSM: for every (window, bucket) lane, the
// sum of the points its slot table names, by unified mixed adds from the
// identity, one add per static round; an empty slot adds the identity
// niels (1, 1, 0), which scales the accumulator projectively and keeps
// every lane on the same op stream.
//
// Replaces firedancer_tpu/ops/msm_pallas.py:93 fill_buckets_pallas
// (pallas_call at :148). On the TPU a sequential grid axis walks the
// rounds with the lane tile resident in VMEM, and XLA first gathers every
// round's niels operands into (R, 32, lanes) int16 buffers in HBM
// (msm.py:618 _stage_niels). Here the round axis is a loop inside one
// thread per lane, and the thread gathers its point's niels form (y + x,
// y - x, 2d t), as the decompress kernel wrote it, through the slot
// table: at the main path's shapes the staged buffers would be some
// 450 MB written and read per pass.
//
// Bound on this card: latency of one dependent chain per thread. A round
// is the 7 multiplies of the madd, each 25 64x64->128-bit products; the
// bytes (120 B gathered per round, mostly from L2) do not bound it. At
// B = 8192 the torsion grid is 2048 lanes x 698 rounds: 2048 threads fill
// 64 warps, under one per SM, so no latency is hidden. Design: 32
// threads a block, so the warps spread over the SMs; the slot table and
// sign bits are round-major, so a warp reads neighbouring words each
// round. Splitting rounds over threads would change the order of the
// adds; that is work for a later PR.
#include "msm.cuh"

#define FILL_THREADS 32

__global__ void msm_fill_kernel(const int64_t *__restrict__ niels,
                                const int32_t *__restrict__ idx,
                                const uint8_t *__restrict__ neg,
                                int64_t *__restrict__ out, long long lanes,
                                int rounds) {
  long long l = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  ge acc = ge_identity();
  for (int r = 0; r < rounds; r++) {
    const long long slot = (long long)r * lanes + l;
    const int sel = idx[slot];
    msm_niels q;
    if (sel >= 0) {
      const int64_t *p = niels + 15LL * sel;
      q.YpX = fe_load(p);
      q.YmX = fe_load(p + 5);
      q.T2d = fe_load(p + 10);
      if (neg != nullptr && neg[slot]) {  // -P = (y - x, y + x, -2dt)
        const fe tmp = q.YpX;
        q.YpX = q.YmX;
        q.YmX = tmp;
        q.T2d = fe_neg(q.T2d);
      }
    } else {
      q.YpX = fe_one();
      q.YmX = fe_one();
      q.T2d = fe_zero();
    }
    acc = ge_madd_niels(acc, q);
  }
  ge_store_canonical(out + 20 * l, acc);
}

// niels: (n, 3, 5) int64, (y + x, y - x, 2d t) of Z = 1 points; idx:
// (rounds, lanes) int32 point index or -1; neg: (rounds, lanes) uint8 or
// null; out: (lanes, 4, 5) int64.
extern "C" int fd_msm_fill(const void *niels, const void *idx, const void *neg,
                           void *out, long long lanes, int rounds,
                           void *stream) {
  if (lanes <= 0) return 0;
  const unsigned blocks = (unsigned)((lanes + FILL_THREADS - 1) / FILL_THREADS);
  msm_fill_kernel<<<blocks, FILL_THREADS, 0, (cudaStream_t)stream>>>(
      (const int64_t *)niels, (const int32_t *)idx, (const uint8_t *)neg,
      (int64_t *)out, lanes, rounds);
  return (int)cudaGetLastError();
}
