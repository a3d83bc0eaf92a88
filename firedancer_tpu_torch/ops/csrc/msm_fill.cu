// Bucket fill of the Pippenger MSM: for every (window, bucket) lane, the
// sum of the points its slot table names.
//
// Replaces firedancer_tpu/ops/msm_pallas.py:93 fill_buckets_pallas
// (pallas_call at :148). On the TPU a sequential grid axis walks a
// static number of rounds R with the lane tile resident in VMEM, an
// empty slot adding the identity niels, and XLA first gathers every
// round's niels operands into (R, 32, lanes) int16 buffers in HBM
// (msm.py:618 _stage_niels). Here each lane gathers its points' niels
// forms (y + x, y - x, 2d t), as the decompress kernel wrote them,
// through the slot table, and only its live slots are added.
//
// Thread mapping: C threads per lane (C a power of two <= 32), the C
// threads of a lane neighbours in one warp, and the 32 / C lanes of a
// warp neighbouring buckets of one window, so their counts are alike.
// Thread c of a lane sums the slots r = c, c + C, c + 2C, ... by mixed
// niels adds (7 M) from the identity and stops at the first empty slot:
// the staging fills a bucket's slots as a prefix (msm.py
// _staging_from_digits, valid = r < counts), so none after it is live,
// and no identity niels is ever added. Dealt round-robin, a lane of n
// points gives each of its threads n / C points, give or take one,
// whatever the round budget R. The C partial sums then meet in a
// butterfly of log2 C unified adds (9 M) by warp shuffles
// (ge_warp_tree), and thread 0 of the lane stores the canonical point.
// The slot table and sign bits are lane-major, so a lane's threads read
// neighbouring words.
//
// C (msm_cuda.fill_chunks): the largest power of two <= 32 and <= R
// with lanes x C <= 33,792, one wave of blocks on an H100 SXM (at 130
// registers one 256-thread block fits an SM, and there are 132). Every
// thread of a lane runs all log2 C butterfly adds, so each doubling of C
// adds lanes x C x 9 M of work; past one wave it buys no parallelism,
// below one wave it leaves SMs idle. At B = 8192: C = 16 for the torsion
// grid (64 trials x 32 buckets, R = 698; 32,768 threads), 8 for the z
// grid (18 x 128, R = 129; 18,432), 4 for the 253-bit grid (37 x 128;
// 18,944). chip_smoke.py phase 3 times every C (H100 80GB HBM3, 700 W):
//   C =        4       8       16      32   ms
//   z       0.1450  0.0895  0.1119  0.1468
//   253     0.1455  0.1506  0.1644  0.2449
//   torsion 0.7929  0.4179  0.2414  0.2813
// The rule picks the fastest on each grid (253: C = 4 and 8 within 4 %).
//
// Bound on this card: the operations, a madd per filled slot and 9 M
// per tree add (the bytes, 120 B gathered per slot, mostly from L2, do
// not bound it). Each thread's dependent chain is ceil(n / C) madds and
// log2 C unified adds; longest at B = 8192: 37 madds + 4 adds on the
// torsion grid, 12 madds + 3 adds on the z grid, 25 madds + 2 adds on
// the 253-bit grid, against R madds a lane when one thread walked every
// round.
//
// Registers (ptxas -v, CUDA 12.8, printed by chip_smoke.py phase 2):
// 130, no stack, no spills. The partner's point in the butterfly is
// shuffled one coordinate at a time (ge_add_ext_shfl_xor); shuffled
// whole it took 136. A minimum of 2 blocks an SM caps it at 128 but
// spills 24-28 bytes.
#include "msm.cuh"

#define FILL_THREADS 256

__global__ void __launch_bounds__(FILL_THREADS)
    msm_fill_kernel(const int64_t *__restrict__ niels,
                    const int32_t *__restrict__ idx,
                    const uint8_t *__restrict__ neg,
                    int64_t *__restrict__ out, long long lanes, int rounds,
                    int log_chunks) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long l = t >> log_chunks;
  const int chunks = 1 << log_chunks;
  const int c = (int)(t & (chunks - 1));
  // Threads past the last lane keep the identity and stay for the
  // shuffles.
  ge acc = ge_identity();
  if (l < lanes) {
    const int32_t *row = idx + l * rounds;
    const uint8_t *nrow = neg == nullptr ? nullptr : neg + l * rounds;
    for (int r = c; r < rounds; r += chunks) {
      const int sel = row[r];
      if (sel < 0) break;
      const int64_t *p = niels + 15LL * sel;
      msm_niels q;
      q.YpX = fe_load(p);
      q.YmX = fe_load(p + 5);
      q.T2d = fe_load(p + 10);
      if (nrow != nullptr && nrow[r]) {  // -P = (y - x, y + x, -2dt)
        const fe tmp = q.YpX;
        q.YpX = q.YmX;
        q.YmX = tmp;
        q.T2d = fe_neg(q.T2d);
      }
      acc = ge_madd_niels(acc, q);
    }
  }
  acc = ge_warp_tree(acc, chunks);
  if (l < lanes && c == 0) ge_store_canonical(out + 20 * l, acc);
}

// niels: (n, 3, 5) int64, (y + x, y - x, 2d t) of Z = 1 points; idx:
// (lanes, rounds) int32 point index or -1, each lane's live slots a
// prefix; neg: (lanes, rounds) uint8 or null; out: (lanes, 4, 5) int64;
// chunks: threads per lane, a power of two <= 32.
extern "C" int fd_msm_fill(const void *niels, const void *idx, const void *neg,
                           void *out, long long lanes, int rounds, int chunks,
                           void *stream) {
  if (chunks < 1 || chunks > 32 || (chunks & (chunks - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  if (lanes <= 0) return 0;
  int log_chunks = 0;
  while ((1 << log_chunks) < chunks) log_chunks++;
  const long long threads = lanes * chunks;
  const unsigned blocks =
      (unsigned)((threads + FILL_THREADS - 1) / FILL_THREADS);
  msm_fill_kernel<<<blocks, FILL_THREADS, 0, (cudaStream_t)stream>>>(
      (const int64_t *)niels, (const int32_t *)idx, (const uint8_t *)neg,
      (int64_t *)out, lanes, rounds, log_chunks);
  return (int)cudaGetLastError();
}
