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
// table of lane indices in global scratch, and ORs the bits into a copy of
// bank A.
//
// Bound on this card: bytes. Each lane reads 8 B of tags and 1 B of valid
// and writes 1 B of verdict; the banks are read once and bank A written
// once (3 x h_bits / 8 B). At n = 8192 and h_bits = 2^17 that is ~130 KB,
// well under a microsecond at 3.35 TB/s, so the launches' fixed cost sets
// the time. Design: two passes of one source, blocks of DF_THREADS lanes,
// any n (the grid covers the lanes, the banks by a grid-stride loop).
//   Pass 1 (dedup_insert_kernel) copies bank A to the output bank and
//   inserts every valid lane into the table (2^ceil(log2 2n) slots, at
//   least 32, linear probing from a splitmix64 hash of the key). A slot
//   holds a lane index, never a key: its key is read from the tag arrays
//   at that index, so the empty marker (0xFFFFFFFF) is not a key value,
//   and there is no window between claiming a slot and writing its key. A
//   lane claims an empty slot by atomicCAS; a lane that finds its own key
//   there takes the smaller index by atomicMin (the key of a slot never
//   changes once claimed). Slots are never freed, so two lanes of one key
//   probe the same sequence and meet at the same slot. Invalid lanes are
//   not inserted: their least index goes into one word by a warp-wide
//   __reduce_min_sync and one atomicMin a warp.
//   Pass 2 (dedup_mark_kernel): lane i is a first occurrence when it is
//   valid and its slot holds i, and, when its tag is the all-ones sentinel,
//   when i precedes every invalid lane: exactly the lane that leads its
//   key's run in the graph's stable sort. It reads its bucket's words of A
//   and B (the window at batch entry), ORs its bit into the output bank by
//   atomicOr when it is a first occurrence, writes its verdict, and each
//   warp adds its popcount of novel lanes to the count by one atomicAdd.
// The host function clears the table, the invalid-lane word and the count
// (cudaMemsetAsync) before the passes, all on the caller's stream.
#include <cstdint>
#include <cuda_runtime.h>

#define DF_THREADS 256
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

__global__ void __launch_bounds__(DF_THREADS)
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

__global__ void __launch_bounds__(DF_THREADS)
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

static int df_blocks(long long items) {
  const long long b = (items + DF_THREADS - 1) / DF_THREADS;
  return (int)(b < 1 ? 1 : b);
}

// hi, lo: (n,) uint32; valid: (n,) bytes 0/1; bits_a, bits_b: (n_words,)
// uint32, read only; novel: (n,) bytes out; bits_out: (n_words,) out, not
// aliasing either bank; novel_cnt: one int32 out; scratch: slots + 1 + n
// uint32 words (slots a power of two >= 2n). Returns a cudaError_t.
extern "C" int fd_dedup_filter(const void *hi, const void *lo,
                               const void *valid, const void *bits_a,
                               const void *bits_b, void *novel,
                               void *bits_out, void *novel_cnt,
                               void *scratch, int n, int n_words, int slots,
                               void *stream) {
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
                        DF_THREADS, 0, st>>>(
      (const uint32_t *)hi, (const uint32_t *)lo, (const uint8_t *)valid,
      (const uint32_t *)bits_a, (uint32_t *)bits_out, n, n_words, table,
      (uint32_t)(slots - 1), first_invalid, slot_of);
  rc = cudaGetLastError();
  if (rc != cudaSuccess || n == 0) return (int)rc;
  dedup_mark_kernel<<<lane_blocks, DF_THREADS, 0, st>>>(
      (const uint32_t *)hi, (const uint32_t *)lo, (const uint8_t *)valid,
      (const uint32_t *)bits_a, (const uint32_t *)bits_b, n,
      (uint32_t)(32 * n_words - 1), table, first_invalid, slot_of,
      (uint8_t *)novel, (uint32_t *)bits_out, (int *)novel_cnt);
  return (int)cudaGetLastError();
}
