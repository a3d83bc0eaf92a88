// The fd_drain dedup pre-filter: for each of n 64-bit tags (hi, lo), its
// bucket in the window, whether it is the first occurrence of its value in
// the batch, and "definitely novel" (a first occurrence whose bucket bit is
// clear in A | B); bank A with every first occurrence's bit set, and the
// novel count.
//
// Replaces the XLA graph firedancer_tpu/ops/dedup_filter.py:84 dedup_filter
// (jitted at :149; not a pallas_call). The graph finds first occurrences
// by a stable 3-key sort of (hi, lo, lane), invalid lanes keyed by the
// all-ones sentinel, and scatters the bank bits through a dense h_bits
// mask. This kernel finds them without a sort, by an insert-only hash
// table of lane indices, and ORs the bits into a copy of bank A.
//
// Bound on this card: bytes. Each lane reads 8 B of tags and 1 B of valid
// and writes 1 B of verdict; the banks are read once and bank A written
// once (3 x h_bits / 8 B). At n = 8192 and h_bits = 2^17 that is ~130 KB,
// well under a microsecond at 3.35 TB/s: latency and launches set the
// time. dedup_filter_cuda.geometry picks one of two launches by n, from
// what the card showed (PERF.md row 17):
//
// One block (fd_dedup_filter_block, up to dedup_filter_cuda.ONE_CTA_LANES
// lanes: the staged txns of a feed batch): one launch of one CTA of DF_THREADS
// threads whose shared memory holds the table, the window and each lane's
// slot. Nothing is cleared from the host and nothing but the inputs and
// the outputs touches global memory. Lane i belongs to thread i mod
// DF_THREADS.
//   Phase 0 (staging): fill the table with the empty marker, load A and B
//   by 16-byte loads into the window W = A | B and the new bank (a copy of
//   A), zero the count and the least-invalid word. __syncthreads().
//   Phase 1 (insert): every valid lane goes into the table (at least
//   2^ceil(log2 2n) slots, so at most half full, grown while it fits to
//   shorten the probes; linear probing from a splitmix64 hash of the key).
//   A slot holds a lane index, never a key: its key is read from the tag
//   arrays at that index, so the empty marker (0xFFFFFFFF) is not a key
//   value, and there is no window between claiming a slot and writing its
//   key. A lane claims an empty slot by atomicCAS; a lane that finds its
//   own key there takes the smaller index by atomicMin (the key of a slot
//   never changes once claimed). Slots are never freed, so two lanes of one
//   key probe the same sequence and meet at the same slot. Each lane leaves
//   its slot in shared memory. Invalid lanes are not inserted: their least
//   index goes into the least-invalid word by a warp-wide __reduce_min_sync
//   and one atomicMin a warp. __syncthreads().
//   Phase 2 (mark): lane i is a first occurrence when it is valid and its
//   slot holds i, and, when its tag is the all-ones sentinel, when i
//   precedes every invalid lane: exactly the lane that leads its key's run
//   in the graph's stable sort. A first occurrence reads its bucket's word
//   of the staged window, ORs its bit into the new bank, and is novel when
//   the window's bit was clear; every lane writes its verdict, and each
//   warp adds its novel lanes to the count by one atomicAdd.
//   __syncthreads(). Then the new bank and the count are stored.
//
// Grid (fd_dedup_filter_grid, more lanes, or a window too wide for one
// CTA's shared memory): the same table in a global scratch of the
// caller's, cleared by cudaMemsetAsync with the count, then two launches
// over a grid of DF_GRID_THREADS-thread blocks: dedup_insert_kernel copies
// bank A and runs phase 1 (each lane's slot and the least invalid lane in
// the scratch), dedup_mark_kernel runs phase 2 against A | B read from
// global memory. The second launch is the grid-wide barrier between them.
#include <cstdint>
#include <cuda_runtime.h>

#define DF_THREADS 1024       // one block's threads
#define DF_GRID_THREADS 256   // a grid block's threads
#define DF_SMEM_LIMIT 232448  // dynamic shared bytes a CTA may opt into
#define DF_EXTRA_WORDS 4      // the count, the least-invalid word, padding
#define DF_EMPTY 0xFFFFFFFFu
#define DF_SENTINEL 0xFFFFFFFFu  // each half of the invalid lanes' key
#define DF_MIX_A 0x9E3779B1u
#define DF_MIX_B 0x85EBCA77u

// The bucket hash of the JAX graph's _bucket (dedup_filter.py:73).
__device__ __forceinline__ uint32_t df_bucket(uint32_t hi, uint32_t lo,
                                              uint32_t mask) {
  uint32_t mix = lo ^ (hi * DF_MIX_A);
  mix = (mix ^ (mix >> 15)) * DF_MIX_B;
  mix ^= mix >> 13;
  return mix & mask;
}

// A table slot of a 64-bit key: the splitmix64 finalizer.
__device__ __forceinline__ uint32_t df_slot(uint64_t k, uint32_t mask) {
  k ^= k >> 30;
  k *= 0xBF58476D1CE4E5B9ull;
  k ^= k >> 27;
  k *= 0x94D049BB133111EBull;
  k ^= k >> 31;
  return (uint32_t)k & mask;
}

__device__ __forceinline__ uint64_t df_key(const uint32_t *__restrict__ hi,
                                           const uint32_t *__restrict__ lo,
                                           uint32_t i) {
  return ((uint64_t)hi[i] << 32) | lo[i];
}

__global__ void __launch_bounds__(DF_THREADS, 1)
    dedup_block_kernel(const uint32_t *__restrict__ hi,
                       const uint32_t *__restrict__ lo,
                       const uint8_t *__restrict__ valid,
                       const uint32_t *__restrict__ bits_a,
                       const uint32_t *__restrict__ bits_b,
                       uint8_t *__restrict__ novel,
                       uint32_t *__restrict__ bits_out,
                       int *__restrict__ novel_cnt, int n, int n_words,
                       int slots) {
  extern __shared__ __align__(16) uint32_t df_smem[];
  constexpr int nt = DF_THREADS;
  uint32_t *table = df_smem;
  uint32_t *win = table + slots;  // n_words words of A | B
  uint32_t *newb = win + n_words;  // n_words words of A, then the firsts'
  uint32_t *cnt = newb + n_words;
  uint32_t *least_inv = cnt + 1;
  uint32_t *slot_of = cnt + DF_EXTRA_WORDS;  // each lane's slot, or empty
  const int t = threadIdx.x;

  // Phase 0: staging.
  const uint4 empty4 = make_uint4(DF_EMPTY, DF_EMPTY, DF_EMPTY, DF_EMPTY);
  for (int q = t; q < slots / 4; q += nt)
    reinterpret_cast<uint4 *>(table)[q] = empty4;
  const bool vec = n_words % 4 == 0 && ((uintptr_t)bits_a |
                                        (uintptr_t)bits_b |
                                        (uintptr_t)bits_out) % 16 == 0;
  if (vec) {
    const uint4 *a4 = reinterpret_cast<const uint4 *>(bits_a);
    const uint4 *b4 = reinterpret_cast<const uint4 *>(bits_b);
    for (int q = t; q < n_words / 4; q += nt) {
      const uint4 a = a4[q], b = b4[q];
      reinterpret_cast<uint4 *>(newb)[q] = a;
      reinterpret_cast<uint4 *>(win)[q] =
          make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
    }
  } else {
    for (int q = t; q < n_words; q += nt) {
      const uint32_t a = bits_a[q];
      newb[q] = a;
      win[q] = a | bits_b[q];
    }
  }
  if (t == 0) {
    *cnt = 0;
    *least_inv = DF_EMPTY;
  }
  __syncthreads();

  // Phase 1: insert. The thread's lanes are i = t + k nt.
  const uint32_t slot_mask = (uint32_t)slots - 1;
  uint32_t inv = DF_EMPTY;
  int i = t;
#pragma unroll 1
  for (int k = 0; i < n; ++k, i += nt) {
    const uint32_t v = valid[i], h = hi[i], l = lo[i];
    uint32_t s = DF_EMPTY;
    if (v == 0) {
      inv = min(inv, (uint32_t)i);
    } else {
      const uint64_t key = ((uint64_t)h << 32) | l;
      s = df_slot(key, slot_mask);
      // The table is at most half full, so a probe ends within a cycle;
      // the bound only keeps a broken geometry from spinning forever.
      for (uint32_t step = 0; step <= slot_mask; ++step) {
        const uint32_t prev = atomicCAS(&table[s], DF_EMPTY, (uint32_t)i);
        if (prev == DF_EMPTY) break;
        if (df_key(hi, lo, prev) == key) {
          atomicMin(&table[s], (uint32_t)i);
          break;
        }
        s = (s + 1) & slot_mask;
      }
    }
    slot_of[k * nt + t] = s;
  }
  inv = __reduce_min_sync(0xFFFFFFFFu, inv);
  if ((t & 31) == 0 && inv != DF_EMPTY) atomicMin(least_inv, inv);
  __syncthreads();

  // Phase 2: mark.
  const uint32_t first_inv = *least_inv;
  const uint32_t h_mask = 32u * (uint32_t)n_words - 1;
  uint32_t mine = 0;
  i = t;
#pragma unroll 1
  for (int k = 0; i < n; ++k, i += nt) {
    const uint32_t s = slot_of[k * nt + t];
    bool nov = false;
    if (s != DF_EMPTY) {
      const uint32_t h = hi[i], l = lo[i];
      if (table[s] == (uint32_t)i &&
          (h != DF_SENTINEL || l != DF_SENTINEL || (uint32_t)i < first_inv)) {
        const uint32_t b = df_bucket(h, l, h_mask);
        const uint32_t bit = 1u << (b & 31);
        nov = (win[b >> 5] & bit) == 0;
        atomicOr(&newb[b >> 5], bit);
      }
    }
    novel[i] = nov ? 1 : 0;
    mine += nov ? 1u : 0u;
  }
  mine = __reduce_add_sync(0xFFFFFFFFu, mine);
  if ((t & 31) == 0 && mine) atomicAdd(cnt, mine);
  __syncthreads();

  // The new bank and the count.
  if (t == 0) *novel_cnt = (int)*cnt;
  if (vec) {
    uint4 *o4 = reinterpret_cast<uint4 *>(bits_out);
    for (int q = t; q < n_words / 4; q += nt)
      o4[q] = reinterpret_cast<const uint4 *>(newb)[q];
  } else {
    for (int q = t; q < n_words; q += nt) bits_out[q] = newb[q];
  }
}

__global__ void __launch_bounds__(DF_GRID_THREADS)
    dedup_insert_kernel(const uint32_t *__restrict__ hi,
                        const uint32_t *__restrict__ lo,
                        const uint8_t *__restrict__ valid,
                        const uint32_t *__restrict__ bits_a,
                        uint32_t *__restrict__ bits_out, int n, int n_words,
                        uint32_t *__restrict__ table, uint32_t slot_mask,
                        uint32_t *__restrict__ first_invalid,
                        uint32_t *__restrict__ slot_of) {
  const int stride = gridDim.x * blockDim.x;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  for (int w = tid; w < n_words; w += stride) bits_out[w] = bits_a[w];
  for (int base = blockIdx.x * blockDim.x; base < n; base += stride) {
    // Whole warps reach the reduction: the loop bound is a block's.
    const int i = base + threadIdx.x;
    const bool live = i < n;
    const bool ok = live && valid[i] != 0;
    const uint32_t inv =
        __reduce_min_sync(0xFFFFFFFFu, live && !ok ? (uint32_t)i : DF_EMPTY);
    if ((threadIdx.x & 31) == 0 && inv != DF_EMPTY)
      atomicMin(first_invalid, inv);
    if (!ok) continue;
    const uint64_t key = df_key(hi, lo, i);
    uint32_t s = df_slot(key, slot_mask);
    for (;;) {
      const uint32_t prev = atomicCAS(&table[s], DF_EMPTY, (uint32_t)i);
      if (prev == DF_EMPTY) break;
      if (df_key(hi, lo, prev) == key) {
        atomicMin(&table[s], (uint32_t)i);
        break;
      }
      s = (s + 1) & slot_mask;
    }
    slot_of[i] = s;
  }
}

__global__ void __launch_bounds__(DF_GRID_THREADS)
    dedup_mark_kernel(const uint32_t *__restrict__ hi,
                      const uint32_t *__restrict__ lo,
                      const uint8_t *__restrict__ valid,
                      const uint32_t *__restrict__ bits_a,
                      const uint32_t *__restrict__ bits_b, int n,
                      uint32_t h_mask, const uint32_t *__restrict__ table,
                      const uint32_t *__restrict__ first_invalid,
                      const uint32_t *__restrict__ slot_of,
                      uint8_t *__restrict__ novel,
                      uint32_t *__restrict__ bits_out,
                      int *__restrict__ novel_cnt) {
  const int stride = gridDim.x * blockDim.x;
  for (int base = blockIdx.x * blockDim.x; base < n; base += stride) {
    const int i = base + threadIdx.x;
    bool nov = false;
    if (i < n && valid[i] != 0) {
      const uint32_t h = hi[i], l = lo[i];
      const uint32_t b = df_bucket(h, l, h_mask);
      const uint32_t w = b >> 5, bit = 1u << (b & 31);
      const bool hit = ((bits_a[w] | bits_b[w]) & bit) != 0;
      bool first = table[slot_of[i]] == (uint32_t)i;
      if (h == DF_SENTINEL && l == DF_SENTINEL)
        first = first && (uint32_t)i < *first_invalid;
      if (first) {
        nov = !hit;
        atomicOr(&bits_out[w], bit);
      }
    }
    if (i < n) novel[i] = nov ? 1 : 0;
    const int cnt = __popc(__ballot_sync(0xFFFFFFFFu, nov));
    if ((threadIdx.x & 31) == 0 && cnt) atomicAdd(novel_cnt, cnt);
  }
}

static bool df_pow2(long long v) { return v > 0 && (v & (v - 1)) == 0; }

static int df_blocks(long long items) {
  const long long b = (items + DF_GRID_THREADS - 1) / DF_GRID_THREADS;
  return (int)(b < 1 ? 1 : b);
}

// The common arguments of both launches. hi, lo: (n,) uint32; valid: (n,)
// bytes 0/1; bits_a, bits_b: (n_words,) uint32, read only (n_words a power
// of two); novel: (n,) bytes out; bits_out: (n_words,) out, not aliasing
// either bank; novel_cnt: one int32 out; slots: the table's size, a power
// of two >= 2n and >= 32. Both return a cudaError_t
// (cudaErrorInvalidValue for arguments the kernels cannot run).

// One launch of dedup_block_kernel with smem dynamic shared bytes
// (dedup_filter_cuda.smem_bytes) on stream.
extern "C" int fd_dedup_filter_block(const void *hi, const void *lo,
                                     const void *valid, const void *bits_a,
                                     const void *bits_b, void *novel,
                                     void *bits_out, void *novel_cnt, int n,
                                     int n_words, int slots, int smem,
                                     void *stream) {
  const long long lpt = (n + DF_THREADS - 1) / DF_THREADS;
  const long long need = 4ll * ((long long)slots + 2ll * n_words +
                                DF_EXTRA_WORDS + lpt * DF_THREADS);
  if (n < 0 || !df_pow2(n_words) || !df_pow2(slots) || slots < 32 ||
      (long long)slots < 2ll * n || smem < need || smem > DF_SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  // Opt in to the shared memory once a device (the attribute is the
  // device's).
  static bool opted[64];
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return (int)rc;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!opted[dev]) {
    rc = cudaFuncSetAttribute(dedup_block_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              DF_SMEM_LIMIT);
    if (rc != cudaSuccess) return (int)rc;
    opted[dev] = true;
  }
  dedup_block_kernel<<<1, DF_THREADS, (size_t)smem, (cudaStream_t)stream>>>(
      (const uint32_t *)hi, (const uint32_t *)lo, (const uint8_t *)valid,
      (const uint32_t *)bits_a, (const uint32_t *)bits_b, (uint8_t *)novel,
      (uint32_t *)bits_out, (int *)novel_cnt, n, n_words, slots);
  return (int)cudaGetLastError();
}

// The grid's launches on stream; scratch: slots + 1 + n uint32 words,
// cleared here (the table and the least invalid lane) with the count.
extern "C" int fd_dedup_filter_grid(const void *hi, const void *lo,
                                    const void *valid, const void *bits_a,
                                    const void *bits_b, void *novel,
                                    void *bits_out, void *novel_cnt,
                                    void *scratch, int n, int n_words,
                                    int slots, void *stream) {
  if (n < 0 || !df_pow2(n_words) || !df_pow2(slots) || slots < 32 ||
      (long long)slots < 2ll * n)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  uint32_t *table = (uint32_t *)scratch;
  uint32_t *first_invalid = table + slots;
  uint32_t *slot_of = first_invalid + 1;
  cudaError_t rc =
      cudaMemsetAsync(table, 0xFF, sizeof(uint32_t) * ((size_t)slots + 1), st);
  if (rc != cudaSuccess) return (int)rc;
  rc = cudaMemsetAsync(novel_cnt, 0, sizeof(int), st);
  if (rc != cudaSuccess) return (int)rc;
  const int lane_blocks = df_blocks(n);
  const int word_blocks = df_blocks(n_words);
  dedup_insert_kernel<<<lane_blocks > word_blocks ? lane_blocks : word_blocks,
                        DF_GRID_THREADS, 0, st>>>(
      (const uint32_t *)hi, (const uint32_t *)lo, (const uint8_t *)valid,
      (const uint32_t *)bits_a, (uint32_t *)bits_out, n, n_words, table,
      (uint32_t)(slots - 1), first_invalid, slot_of);
  rc = cudaGetLastError();
  if (rc != cudaSuccess || n == 0) return (int)rc;
  dedup_mark_kernel<<<lane_blocks, DF_GRID_THREADS, 0, st>>>(
      (const uint32_t *)hi, (const uint32_t *)lo, (const uint8_t *)valid,
      (const uint32_t *)bits_a, (const uint32_t *)bits_b, n,
      32u * (uint32_t)n_words - 1u, table, first_invalid, slot_of,
      (uint8_t *)novel, (uint32_t *)bits_out, (int *)novel_cnt);
  return (int)cudaGetLastError();
}
