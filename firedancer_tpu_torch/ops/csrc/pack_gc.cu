// Account-lock graph coloring of one block of transactions: each
// transaction, in descending score order, takes the least of C colors
// (parallel waves) whose lock sets it does not conflict with and whose
// compute-unit total stays within the cap, or -1 when none is free.
//
// Replaces the XLA program firedancer_tpu/ops/pack_gc.py:64
// pack_schedule, a jnp.argsort and one lax.scan over the sorted block (it
// is not a pallas_call). The scan carries, per color, a write set and a
// read set of H hashed account buckets (bit-packed, C x H/32 words each)
// and the CU total; each step ANDs the transaction's dense (H/32)-word
// masks with every color's sets. The same booleans come from testing
// only the transaction's own buckets, which is what this kernel does.
//
// Bound on this card: neither bytes (a block's rows are read once, ~0.3
// MB at N = 1024) nor operations: the scan is a chain of N dependent
// steps, each at least one shared-memory round. The least such a step
// costs on one warp (a shared store, __syncwarp, a shared load and one
// REDUX) is what pack_chain_floor_kernel runs.
//
// State by bucket, not by color: for each bucket b < H' = 32 (H / 32),
// two masks of K = ceil(C / 64) 64-bit words side by side, W[b] (bit c:
// color c holds a write lock in b) then R[b] (a read lock), 16 K H' bytes
// of dynamic shared memory (64 KB at C = 64, H = 4096). A transaction's
// conflicts are the OR of W[b] | R[b] over its write buckets and of W[b]
// over its read buckets: one gather a bucket, whatever C is. Buckets with
// b < 0 or b / 32 >= H / 32 count for nothing, as in the dense masks.
//
// Two launches:
//   1. pack_compact_kernel, a warp a sorted position i: row order[i]'s
//      valid buckets, each as 2 b + (1 if a read), packed by a ballot
//      into a record of pg_record_words(AW + AR) words: slots 0..28 in
//      words 0..28, -1 past the count, the CUs in word 29, the input
//      index in word 30, the count in word 31, slots 29.. in words 32..
//      (rows of more than 29 valid buckets only; the record is 32 words
//      when AW + AR <= 29).
//   2. pack_scan_kernel, one warp in one block, no block barrier. Lane l
//      holds word l of the step's record and the CU totals of colors
//      l, l + 32, ... in registers. Per step: each lane with a bucket
//      loads its masks (one 16-byte load when K = 1) and ORs its
//      conflicts; __reduce_or_sync (REDUX) ORs them across the warp, two
//      32-bit halves a word; each lane tests its colors' CU sums against
//      the cap (int32 wrapping, as the reference) and __ballot_sync
//      gathers the verdicts; colors >= C are masked off; the least free
//      color is the first set bit (__ffs of each half), or -1; the lanes
//      OR its bit into W[b] or R[b] by a shared atomicOr on the 32-bit
//      half that holds it (a bucket may repeat within a row), lane m % 32
//      adds the CUs, lane 30 stores the color at the input index;
//      __syncwarp orders the scatter before the next step's gather.
// The records stream in order, PG_DEPTH steps ahead of the step that
// reads them, each lane one word a row, in registers: the step loop is
// unrolled PG_DEPTH times, and step i loads row i + PG_DEPTH into the
// register its own record leaves free. Depth 16: a step takes ~0.19 us
// on an H100 and an L2 hit ~0.3 us (a miss to HBM under ~1 us; launch 1
// wrote the records just before, so they are in L2), so 16 steps (~3 us)
// cover either; 8 measured 2-3 % slower (the loop's overhead over fewer
// steps), and a shared ring filled by cp.async 10-20 % slower.
//
// A step is bound by its chain of dependent instructions on one warp
// (~100 of them: the gather, two REDUX, two ballots, the first set bit,
// the CU update), not by memory.
#include <cstdint>
#include <cuda_runtime.h>

#define PG_DEPTH 16          // steps a record is loaded ahead
#define PG_FULL 0xffffffffu
#define PG_HEAD 29          // bucket slots in a record's first 32 words
#define PG_CU 29            // record word: the row's CUs
#define PG_INDEX 30         // record word: the row's input index
#define PG_COUNT 31         // record word: its valid bucket count
#define PG_PRE_ROWS 8       // rows (a warp each) of a compaction block
#define PG_MAX_K 16         // mask words a bucket set: C <= 1024

// Words of a record for a row of a = AW + AR bucket columns.
__host__ __device__ inline int pg_record_words(int a) {
  const int over = a > PG_HEAD ? a - PG_HEAD : 0;
  return 32 + (over + 31) / 32 * 32;
}

__global__ void __launch_bounds__(PG_PRE_ROWS * 32)
    pack_compact_kernel(const int32_t *__restrict__ w_idx,
                        const int32_t *__restrict__ r_idx,
                        const int64_t *__restrict__ order,
                        const int32_t *__restrict__ cus,
                        int32_t *__restrict__ rows, long long n, int aw,
                        int ar, int n_words, int stride) {
  const int lane = threadIdx.x & 31;
  const long long i = (long long)blockIdx.x * PG_PRE_ROWS + (threadIdx.x >> 5);
  if (i >= n) return;  // a whole warp
  const long long o = order[i];
  int32_t *rec = rows + i * stride;
  const int a = aw + ar;
  int cnt = 0;
  for (int base = 0; base < a; base += 32) {
    const int col = base + lane;
    int b = -1;
    if (col < aw)
      b = w_idx[o * aw + col];
    else if (col < a)
      b = r_idx[o * ar + col - aw];
    const bool valid = b >= 0 && (b >> 5) < n_words;
    const unsigned bal = __ballot_sync(PG_FULL, valid);
    if (valid) {
      const int t = cnt + __popc(bal & ((1u << lane) - 1u));
      rec[t < PG_HEAD ? t : t + 32 - PG_HEAD] = 2 * b + (col >= aw);
    }
    cnt += __popc(bal);
  }
  if (lane < PG_HEAD && lane >= cnt) rec[lane] = -1;
  if (lane == PG_CU) rec[PG_CU] = cus[o];
  if (lane == PG_INDEX) rec[PG_INDEX] = (int32_t)o;
  if (lane == PG_COUNT) rec[PG_COUNT] = cnt;
}

// The colors that bucket entry e (2 b + read) conflicts with, OR'd into
// conf: W[b] | R[b] for a write, W[b] for a read.
template <int KT>
__device__ __forceinline__ void pg_busy(const unsigned long long *masks,
                                        int kw, int e,
                                        unsigned long long (&conf)[KT]) {
  const unsigned long long *p = masks + (e >> 1) * 2 * kw;
  if constexpr (KT == 1) {
    const ulonglong2 wr = *(const ulonglong2 *)p;
    conf[0] |= (e & 1) ? wr.x : (wr.x | wr.y);
  } else {
#pragma unroll
    for (int k = 0; k < KT; ++k)
      if (k < kw) conf[k] |= (e & 1) ? p[k] : (p[k] | p[kw + k]);
  }
}

// Color m's bit into W[b] (a write) or R[b] (a read): a 32-bit atomicOr
// on the half of the 64-bit word that holds it.
__device__ __forceinline__ void pg_set(unsigned long long *masks, int kw,
                                       int e, int m) {
  unsigned *w =
      (unsigned *)(masks + (e >> 1) * 2 * kw + (e & 1) * kw + (m >> 6));
  atomicOr(w + ((m >> 5) & 1), 1u << (m & 31));
}

template <int KT>
__global__ void __launch_bounds__(32, 1)
    pack_scan_kernel(const int32_t *__restrict__ rows,
                     int32_t *__restrict__ colors, int n, int stride,
                     int n_buckets, int kw, int n_colors, int cu_cap) {
  extern __shared__ ulonglong2 pg_smem[];
  unsigned long long *masks = (unsigned long long *)pg_smem;
  const int lane = threadIdx.x;
  for (int j = lane; j < n_buckets * kw; j += 32)
    pg_smem[j] = make_ulonglong2(0ull, 0ull);
  uint32_t cu_used[2 * KT];
#pragma unroll
  for (int q = 0; q < 2 * KT; ++q) cu_used[q] = 0;
  // Word lane of row i + PG_DEPTH, the next record to load, and of the
  // last row, which a load past the end reads instead.
  const int32_t *next = rows + (long long)PG_DEPTH * stride + lane;
  const int32_t *last = rows + (long long)(n - 1) * stride + lane;

  int pre[PG_DEPTH];
#pragma unroll
  for (int d = 0; d < PG_DEPTH; ++d)
    pre[d] = __ldg(d < n ? rows + (long long)d * stride + lane : last);
  __syncwarp();

  for (int i0 = 0; i0 < n; i0 += PG_DEPTH) {
#pragma unroll
    for (int d = 0; d < PG_DEPTH; ++d) {
      const int i = i0 + d;
      if (i >= n) break;
      const int v = pre[d];
      const uint32_t cu = (uint32_t)__shfl_sync(PG_FULL, v, PG_CU);
      const int cnt = __shfl_sync(PG_FULL, v, PG_COUNT);
      // Lanes past the row's buckets gather bucket 0's masks and drop
      // them, so that the common path has no divergent branch.
      const bool mine = lane < PG_HEAD && v >= 0;
      const int e = mine ? v : 0;
      const int32_t *ext = rows + (long long)i * stride + 32;

      // The conflicts of the row's buckets, ORed across the warp.
      unsigned long long conf[KT], busy[KT];
#pragma unroll
      for (int k = 0; k < KT; ++k) busy[k] = 0;
      pg_busy<KT>(masks, kw, e, busy);
#pragma unroll
      for (int k = 0; k < KT; ++k) conf[k] = mine ? busy[k] : 0;
      if (cnt > PG_HEAD) {
#pragma unroll 1
        for (int t = lane; t < cnt - PG_HEAD; t += 32)
          pg_busy<KT>(masks, kw, __ldg(ext + t), conf);
      }
      // The least color free of conflicts and within the CU cap.
      int m = -1;
#pragma unroll
      for (int k = 0; k < KT; ++k) {
        if (KT > 1 && k >= kw) break;
        const unsigned lo = __reduce_or_sync(PG_FULL, (unsigned)conf[k]);
        const unsigned hi =
            __reduce_or_sync(PG_FULL, (unsigned)(conf[k] >> 32));
        const unsigned ok_lo = __ballot_sync(
            PG_FULL, 64 * k + lane < n_colors &&
                         (int)(cu_used[2 * k] + cu) <= cu_cap);
        const unsigned ok_hi = __ballot_sync(
            PG_FULL, 64 * k + 32 + lane < n_colors &&
                         (int)(cu_used[2 * k + 1] + cu) <= cu_cap);
        // __ffs is 0 when no bit is set: selects, not branches.
        const int f_lo = __ffs(~lo & ok_lo), f_hi = __ffs(~hi & ok_hi);
        const int f = f_lo ? f_lo - 1 : (f_hi ? f_hi + 31 : -1);
        m = m < 0 && f >= 0 ? 64 * k + f : m;
      }
      // It takes the row: its bits, its CUs, its color.
      if (m >= 0 && mine) pg_set(masks, kw, v, m);
      if (m >= 0 && cnt > PG_HEAD) {
#pragma unroll 1
        for (int t = lane; t < cnt - PG_HEAD; t += 32)
          pg_set(masks, kw, __ldg(ext + t), m);
      }
      const bool adds = m >= 0 && lane == (m & 31);
#pragma unroll
      for (int q = 0; q < 2 * KT; ++q)
        cu_used[q] += adds && q == (m >> 5) ? cu : 0u;
      if (lane == PG_INDEX) colors[v] = m;
      // Row i + PG_DEPTH's record, loaded after v's last use and without a
      // condition (past the end it reads the last row again), so that it
      // lands in v's register and nothing waits for it before step
      // i + PG_DEPTH.
      pre[d] = __ldg(i + PG_DEPTH < n ? next : last);
      next += stride;
      __syncwarp();
    }
  }
}

// The chain's floor: one warp, n steps of a shared store, __syncwarp, a
// shared load and one REDUX, the skeleton of a step of any one-warp scan.
// No transaction path launches it; it measures the least a step costs on
// this card.
__global__ void __launch_bounds__(32, 1)
    pack_chain_floor_kernel(int32_t *out, long long n) {
  __shared__ uint32_t s_val[32];
  const int lane = threadIdx.x;
  uint32_t acc = lane;
  for (long long i = 0; i < n; ++i) {
    s_val[lane] = acc;
    __syncwarp();
    acc = __reduce_add_sync(PG_FULL, s_val[lane ^ 1]) + (uint32_t)i;
  }
  if (lane == 0) out[0] = (int32_t)acc;
}

template <int KT>
static int pg_scan_launch(const int32_t *rows, int32_t *colors, int n,
                          int stride, int n_buckets, int kw, int n_colors,
                          int cu_cap, cudaStream_t stream) {
  const long long smem = 16LL * kw * n_buckets;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        pack_scan_kernel<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  pack_scan_kernel<KT><<<1, 32, (size_t)smem, stream>>>(
      rows, colors, n, stride, n_buckets, kw, n_colors, cu_cap);
  return (int)cudaGetLastError();
}

// w_idx: (n, aw), r_idx: (n, ar) int32 buckets, -1 padded; order: (n,)
// int64, a permutation (descending score, ties in input order); cus: (n,)
// int32; rows: (n, pg_record_words(aw + ar)) int32 scratch; colors: (n,)
// int32 out, in input order. 1 <= n_colors <= 64 PG_MAX_K.
extern "C" int fd_pack_schedule(const void *w_idx, const void *r_idx,
                                const void *order, const void *cus, void *rows,
                                void *colors, long long n, int aw, int ar,
                                int n_colors, int h_bits, int cu_cap,
                                void *stream) {
  if (n <= 0) return 0;
  const int kw = (n_colors + 63) / 64;
  if (n_colors < 1 || kw > PG_MAX_K || n >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int n_words = h_bits / 32;
  const int stride = pg_record_words(aw + ar);
  const cudaStream_t s = (cudaStream_t)stream;
  pack_compact_kernel<<<(unsigned)((n + PG_PRE_ROWS - 1) / PG_PRE_ROWS),
                        PG_PRE_ROWS * 32, 0, s>>>(
      (const int32_t *)w_idx, (const int32_t *)r_idx, (const int64_t *)order,
      (const int32_t *)cus, (int32_t *)rows, n, aw, ar, n_words, stride);
  const cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  const int32_t *r = (const int32_t *)rows;
  int32_t *c = (int32_t *)colors;
  // At least one bucket: lanes with no bucket gather bucket 0's masks.
  const int nb = n_words > 0 ? 32 * n_words : 1;
  const int ni = (int)n;
  if (kw == 1) return pg_scan_launch<1>(r, c, ni, stride, nb, kw, n_colors, cu_cap, s);
  if (kw == 2) return pg_scan_launch<2>(r, c, ni, stride, nb, kw, n_colors, cu_cap, s);
  if (kw <= 4) return pg_scan_launch<4>(r, c, ni, stride, nb, kw, n_colors, cu_cap, s);
  if (kw <= 8) return pg_scan_launch<8>(r, c, ni, stride, nb, kw, n_colors, cu_cap, s);
  return pg_scan_launch<16>(r, c, ni, stride, nb, kw, n_colors, cu_cap, s);
}

// n steps of pack_chain_floor_kernel on one warp.
extern "C" int fd_pack_chain_floor(void *out, long long n, void *stream) {
  pack_chain_floor_kernel<<<1, 32, 0, (cudaStream_t)stream>>>((int32_t *)out,
                                                               n);
  return (int)cudaGetLastError();
}
