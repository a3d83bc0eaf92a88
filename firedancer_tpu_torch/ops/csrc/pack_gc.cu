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
// only the transaction's own buckets (at most AW + AR of them) against
// each color, which is what this kernel does.
//
// Bound on this card: neither bytes (a block's rows are read once, ~0.3
// MB at N = 1024) nor operations (C x (2 AW + AR) bit tests a step): the
// scan is a chain of N dependent steps, each at least one shared-memory
// round and two barriers. Design: one block; the two sets (2 x C x H/32
// words with an odd pitch of H/32 + 1, so the colors of one bucket word
// lie in distinct banks; 66 KB at C = 64, H = 4096) and the C CU totals
// in dynamic shared memory. Thread t serves color t / G, bucket slots
// t % G, t % G + G, ... (G, a power of two up to 32, threads a color, so
// a color's threads are lanes of one warp); threads j < AW + AR load
// bucket j of the next transaction (thread AW + AR its CUs) into a
// double-buffered stage while the colors are tested, so the global loads
// of step i + 1 overlap step i. Per step:
//   1. every color's threads test their buckets (a write bucket against
//      the color's write and read sets, a read bucket against its write
//      set; only buckets b with 0 <= b and b / 32 < H / 32, as the dense
//      masks count them), thread 0 of the color the CU cap; the G
//      threads OR their verdicts by full-mask shuffles, and each free
//      color takes part in a shared-memory atomicMin;
//   2. barrier; the least free color's threads set its bits by
//      shared-memory atomicOr (a write and a read bucket may share a
//      word), its thread 0 adds the CUs; the loader threads store the
//      next transaction's row, thread AW + AR writes the color (input
//      order) and resets the other minimum;
//   3. barrier.
// Every thread runs every step (no early exit past a barrier); threads
// past the last color test nothing. CU sums wrap as the reference's
// int32 does.
#include <cstdint>
#include <cuda_runtime.h>

#define PG_MAX_THREADS 1024
#define PG_SET_PITCH_PAD 1

// Threads a color: the largest power of two up to 32 with G C <= 256.
__host__ __device__ inline int pg_group(int n_colors) {
  int g = 32;
  while (g > 1 && g * n_colors > 256) g >>= 1;
  return g;
}

// Threads of the block: G C, and at least AW + AR + 1 loaders, in warps.
__host__ __device__ inline int pg_threads(int n_colors, int a) {
  int t = pg_group(n_colors) * n_colors;
  if (t < a + 1) t = a + 1;
  return (t + 31) / 32 * 32;
}

// Dynamic shared memory: the two sets, the CU totals, the two stages.
__host__ __device__ inline long long pg_smem_bytes(int n_colors, int n_words,
                                                   int a) {
  return 4LL * (2LL * n_colors * (n_words + PG_SET_PITCH_PAD) + n_colors +
                2LL * a);
}

__global__ void __launch_bounds__(PG_MAX_THREADS)
    pack_schedule_kernel(const int32_t *__restrict__ w_idx,
                         const int32_t *__restrict__ r_idx,
                         const int64_t *__restrict__ order,
                         const int32_t *__restrict__ cus,
                         int32_t *__restrict__ colors, long long n, int aw,
                         int ar, int n_colors, int n_words, int cu_cap) {
  extern __shared__ uint32_t pg_smem[];
  __shared__ int s_cu[2];
  __shared__ int s_min[2];
  const int pitch = n_words + PG_SET_PITCH_PAD;
  uint32_t *used_w = pg_smem;
  uint32_t *used_r = used_w + n_colors * pitch;
  int *cu_used = (int *)(used_r + n_colors * pitch);
  int *s_idx = cu_used + n_colors;  // [2][a]
  const int a = aw + ar;
  const int tid = threadIdx.x;
  const int g = pg_group(n_colors);
  const int c = tid / g;     // this thread's color (none past n_colors)
  const int part = tid % g;  // its first bucket slot
  const bool loader = tid <= a;

  for (int k = tid; k < 2 * n_colors * pitch + n_colors; k += blockDim.x)
    pg_smem[k] = 0;
  // o_next: order[i + 1] at step i (loaders); o_cur: order[i] (thread a).
  long long o_cur = 0, o_next = 0;
  if (loader) {
    const long long o0 = order[0];
    if (tid < aw)
      s_idx[tid] = w_idx[o0 * aw + tid];
    else if (tid < a)
      s_idx[tid] = r_idx[o0 * ar + tid - aw];
    else
      s_cu[0] = cus[o0];
    o_cur = o0;
    if (n > 1) o_next = order[1];
  }
  if (tid == 0) {
    s_min[0] = n_colors;
    s_min[1] = n_colors;
  }
  __syncthreads();

  for (long long i = 0; i < n; ++i) {
    const int buf = (int)(i & 1);
    // Prefetch step i + 1's row and step i + 2's index into registers.
    int pre = 0;
    long long o_after = 0;
    if (loader && i + 1 < n) {
      if (tid < aw)
        pre = w_idx[o_next * aw + tid];
      else if (tid < a)
        pre = r_idx[o_next * ar + tid - aw];
      else
        pre = cus[o_next];
      if (i + 2 < n) o_after = order[i + 2];
    }
    const int *idx = s_idx + buf * a;
    const int cu = s_cu[buf];

    // 1. Test this thread's buckets against its color.
    uint32_t conflict = 0;
    if (c < n_colors) {
      const uint32_t *uw = used_w + c * pitch;
      const uint32_t *ur = used_r + c * pitch;
      for (int k = part; k < a; k += g) {
        const int b = idx[k];
        if (b >= 0 && (b >> 5) < n_words) {
          const uint32_t busy =
              k < aw ? (uw[b >> 5] | ur[b >> 5]) : uw[b >> 5];
          conflict |= busy & (1u << (b & 31));
        }
      }
      if (part == 0 &&
          (int)((uint32_t)cu_used[c] + (uint32_t)cu) > cu_cap)
        conflict = 1;
    }
    for (int off = 1; off < g; off <<= 1)
      conflict |= __shfl_xor_sync(0xffffffffu, conflict, off);
    if (c < n_colors && part == 0 && conflict == 0)
      atomicMin(&s_min[buf], c);
    __syncthreads();

    // 2. The least free color takes the transaction.
    const int m = s_min[buf];
    if (m < n_colors && c == m) {
      for (int k = part; k < a; k += g) {
        const int b = idx[k];
        if (b >= 0 && (b >> 5) < n_words)
          atomicOr((k < aw ? used_w : used_r) + m * pitch + (b >> 5),
                   1u << (b & 31));
      }
      if (part == 0) cu_used[m] = (int)((uint32_t)cu_used[m] + (uint32_t)cu);
    }
    if (tid == a) {
      colors[o_cur] = m < n_colors ? m : -1;
      o_cur = o_next;
    }
    if (loader && i + 1 < n) {
      if (tid < a)
        s_idx[(buf ^ 1) * a + tid] = pre;
      else
        s_cu[buf ^ 1] = pre;
      o_next = o_after;
    }
    if (tid == 0) s_min[buf ^ 1] = n_colors;
    // 3. The sets and the next stage are complete.
    __syncthreads();
  }
}

// The chain's floor: the same block shape and step skeleton with no
// work, n steps of one shared-memory round (thread 0 stores a word, every
// thread loads it) and two barriers. No transaction path launches it; it
// measures the least a step of the scan costs on this card.
__global__ void __launch_bounds__(PG_MAX_THREADS)
    pack_chain_floor_kernel(int32_t *out, long long n) {
  __shared__ int s_val[2];
  int acc = 0;
  for (long long i = 0; i < n; ++i) {
    const int buf = (int)(i & 1);
    if (threadIdx.x == 0) s_val[buf] = acc + (int)i;
    __syncthreads();
    acc += s_val[buf];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = acc;
}

// w_idx: (n, aw), r_idx: (n, ar) int32 buckets, -1 padded; order: (n,)
// int64, a permutation (descending score, ties in input order); cus: (n,)
// int32; colors: (n,) int32 out, in input order. n >= 1.
extern "C" int fd_pack_schedule(const void *w_idx, const void *r_idx,
                                const void *order, const void *cus,
                                void *colors, long long n, int aw, int ar,
                                int n_colors, int h_bits, int cu_cap,
                                void *stream) {
  if (n <= 0) return 0;
  const int n_words = h_bits / 32;
  const int a = aw + ar;
  const long long smem = pg_smem_bytes(n_colors, n_words, a);
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        pack_schedule_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  pack_schedule_kernel<<<1, pg_threads(n_colors, a), (size_t)smem,
                         (cudaStream_t)stream>>>(
      (const int32_t *)w_idx, (const int32_t *)r_idx,
      (const int64_t *)order, (const int32_t *)cus, (int32_t *)colors, n, aw,
      ar, n_colors, n_words, cu_cap);
  return (int)cudaGetLastError();
}

extern "C" int fd_pack_chain_floor(void *out, long long n, int threads,
                                   void *stream) {
  pack_chain_floor_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(
      (int32_t *)out, n);
  return (int)cudaGetLastError();
}
