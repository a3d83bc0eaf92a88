// The tails of one RLC pass in one launch: the z MSM's Horner, the
// 253-bit MSM's Horner (msm_horner.cu) and the K torsion trials' [L]
// ladders (msm_order.cu), side by side. The three chains do not depend
// on one another, so in one launch the longest sets the time, where
// three launches in a row take the sum.
//
// Warps by role, one warp a block: block 0 .. n_horner - 1 a Horner each
// (its eight quads share the cached forms, then all run the chain),
// then ceil(K / 8) blocks of eight ladder quads. Each chain is
// latency-bound, so a block of one warp lets the blocks land on their own
// SMs and schedulers, where a second warp would only take issue slots
// from the first. A ladder quad past K reruns trial K - 1 and skips the
// store (full-mask shuffles need every thread of the warp).
//
// Entries: fd_msm_tails (the pass: both Horners and the ladders),
// fd_msm_horner (one Horner) and fd_msm_mul_by_order (the ladders
// alone), all launching msm_tails_kernel; fd_msm_tails_kernel_info.
#include "msm_horner.cu"
#include "msm_order.cu"

#define TAILS_THREADS 32                   // one warp a block
#define ORDER_TRIALS (TAILS_THREADS / 4)   // a quad a trial

struct tails_args {
  const int64_t *w0, *w1;  // the Horners' window sums, (nw0|nw1, 4, 5)
  int64_t *t0, *t1;        // their outputs, (1, 4, 5)
  int nw0, nw1;
  int n_horner;            // 0, 1 (w0 alone) or 2
  int w_bits;
  const int64_t *pts;      // (k, 4, 5) trial aggregates
  int64_t *la;             // (k, 4, 5) [L] P
  long long k;
};

__global__ void __launch_bounds__(TAILS_THREADS)
    msm_tails_kernel(const tails_args a) {
  __shared__ u64 cache[HORNER_CHUNK * 5 * 4];
  const int b = blockIdx.x;
  if (b < a.n_horner) {
    if (b == 0)
      horner_quad(a.w0, a.nw0, a.w_bits, a.t0, cache);
    else
      horner_quad(a.w1, a.nw1, a.w_bits, a.t1, cache);
    return;
  }
  const int q = threadIdx.x & 3;
  const long long trial =
      (long long)(b - a.n_horner) * ORDER_TRIALS + (threadIdx.x >> 2);
  const long long i = trial < a.k ? trial : a.k - 1;
  const fe r = order_quad(q, a.pts + 20 * i);
  if (trial < a.k) fe_store_canonical(a.la + 20 * trial + 5 * q, r);
}

static int tails_launch(const tails_args &a, void *stream) {
  const long long blocks =
      a.n_horner + (a.k + ORDER_TRIALS - 1) / ORDER_TRIALS;
  if (blocks == 0) return 0;
  msm_tails_kernel<<<(unsigned)blocks, TAILS_THREADS, 0,
                     (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// w_r: (nw_r, 4, 5), w_m: (nw_m, 4, 5) int64 window sums (nw >= 1),
// window t in row t; pts: (k, 4, 5) int64. t1, t2: (1, 4, 5); la:
// (k, 4, 5); all canonical.
extern "C" int fd_msm_tails(const void *w_r, int nw_r, const void *w_m,
                            int nw_m, int w_bits, const void *pts,
                            long long k, void *t1, void *t2, void *la,
                            void *stream) {
  const tails_args a = {(const int64_t *)w_r, (const int64_t *)w_m,
                        (int64_t *)t1, (int64_t *)t2, nw_r, nw_m, 2, w_bits,
                        (const int64_t *)pts, (int64_t *)la, k};
  return tails_launch(a, stream);
}

// w: (nw, 4, 5) int64 window sums (nw >= 1); out: (1, 4, 5).
extern "C" int fd_msm_horner(const void *w, void *out, int nw, int w_bits,
                             void *stream) {
  const tails_args a = {(const int64_t *)w, nullptr, (int64_t *)out, nullptr,
                        nw, 0, 1, w_bits, nullptr, nullptr, 0};
  return tails_launch(a, stream);
}

// pts: (k, 4, 5) int64; out: (k, 4, 5) int64.
extern "C" int fd_msm_mul_by_order(const void *pts, void *out, long long k,
                                   void *stream) {
  const tails_args a = {nullptr, nullptr, nullptr, nullptr, 0, 0, 0, 0,
                        (const int64_t *)pts, (int64_t *)out, k};
  return tails_launch(a, stream);
}

// info[0..3]: registers a thread, local (stack) bytes a thread, static
// shared bytes a block, threads a block.
extern "C" int fd_msm_tails_kernel_info(int *info) {
  cudaFuncAttributes attr;
  const cudaError_t rc = cudaFuncGetAttributes(&attr, msm_tails_kernel);
  if (rc != cudaSuccess) return (int)rc;
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  info[2] = (int)attr.sharedSizeBytes;
  info[3] = TAILS_THREADS;
  return 0;
}
