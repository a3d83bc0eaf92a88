// The warp-staged SHA-512 core of the port's three hash kernels (K1
// sha512_mod_l.cu, frontend_rlc.cu and sha512_batch.cu): one warp hashes
// 32 lanes, thread `lane` of a warp owning row row0 + lane.
//
// Staging. For each 128-byte block index k the warp copies block k of
// its 32 rows into shared memory (a stage of 32 rows x SW_PITCH words,
// 4,608 B a warp). A load starts below its row's clamped length and ends
// inside the row, so nothing at or past max_len (and nothing of a
// neighbouring row) is read. The loads are coalesced:
// - wide launches (the rows' base and stride both multiples of 16):
//   eight 16-byte loads a thread, threads 8q..8q+7 reading the eight
//   16-byte chunks of one row, four rows an instruction;
// - other launches: one row an instruction, thread t taking bytes
//   4t..4t+3 of the row's block. A row on a 4-byte boundary is read as
//   one 4-byte load a thread; a row s bytes past one as the two aligned
//   words that hold those bytes, joined by a funnel shift of 8s bits.
//   Only a word that reaches past either end of the row is read as its
//   bytes inside the row (at most two such words a row). Eight rows'
//   whole-word loads are issued before any of them is used.
// Then __syncwarp, and each thread takes its own row's 16 big-endian
// words from the stage (four 16-byte shared loads, byte swaps; the pitch
// of 36 words puts the eight threads of a quarter-warp on distinct banks)
// and masks them in registers: bytes at or past len are zero, 0x80 sits
// at len, and the last block's word 15 is the bit length.
//
// Lanes differ in block count (0-1296-byte rows take 1 to 11 blocks), so
// the warp loops to its largest count and a finished lane keeps its state
// by a select. No thread leaves the loop early, because the staging is
// warp-wide; lanes past n hash an empty row and store nothing (a warp
// wholly past n returns at once). The rounds run on registers with every
// index of the 16-word schedule ring static.
//
// It replaced a one-thread-a-lane hash, which read each row with byte
// loads strided by max_len across the warp and kept the ring in local
// memory.
#pragma once

#include "sha512.cuh"

#define SW_FULL 0xffffffffu
// u32 words a staged row: 128 bytes and 16 of padding, so the quarter-
// warp phases of the rows' 16-byte shared loads hit distinct banks.
#define SW_PITCH 36
// u32 words of one warp's stage (4,608 B).
#define SW_STAGE (32 * SW_PITCH)
// Warps a block: two. Of 1, 2 and 4 at B and 2B lanes, two were the
// fastest or within 3 % on every shape timed; one warp a block gets more
// registers and a slower schedule (firedancer_tpu_torch/tools/
// hash_times.py --sweep builds the others with -DSW_WARPS).
#ifndef SW_WARPS
#define SW_WARPS 2
#endif

__device__ __forceinline__ uint32_t sw_bswap(uint32_t x) {
  return __byte_perm(x, 0, 0x0123);
}

// Blocks of a row of len bytes: the message, 0x80 and the 16-byte length.
__device__ __forceinline__ int sw_nblocks(int len) { return (len + 144) >> 7; }

// True when every row starts on a 16-byte boundary.
__device__ __forceinline__ bool sw_wide(const uint8_t *msgs,
                                        long long stride) {
  return (((uintptr_t)msgs | (uintptr_t)stride) & 15) == 0;
}

// The bytes of the 4-byte-aligned word at row + o (o >= -3) that lie at
// or past the row's start and below lim, as a little-endian u32: the
// staging's fallback for a word reaching past either end of the row.
__device__ __forceinline__ uint32_t sw_bytes(const uint8_t *row, long long o,
                                             int lim) {
  uint32_t v = 0;
#pragma unroll
  for (int b = 0; b < 4; b++)
    if (o + b >= 0 && o + b < lim) v |= (uint32_t)row[o + b] << (8 * b);
  return v;
}

// Copy block k of the warp's rows (row r at rows + r * stride) into the
// stage: of row r only bytes below lim_r, this thread's lim read by
// thread r. Bytes of a stage word not read are left as they were.
__device__ __forceinline__ void sw_stage(uint32_t *stage, const uint8_t *rows,
                                         long long stride, bool wide, int lim,
                                         int k, int lane) {
  const long long base = 128LL * k;
  if (wide) {
    const int c = lane & 7;
#pragma unroll
    for (int q = 0; q < 8; q++) {
      const int r = 4 * q + (lane >> 3);
      const int lim_r = __shfl_sync(SW_FULL, lim, r);
      const long long pos = base + 16 * c;
      if (pos < lim_r)
        *(uint4 *)(stage + r * SW_PITCH + 4 * c) =
            *(const uint4 *)(rows + r * stride + pos);
    }
    return;
  }
  // Eight rows at a time: first every whole word inside its row, as
  // predicated loads with no use between them, so that their latencies
  // overlap; then the words that reach past a row's end as bytes, the
  // funnel shifts and the stores.
  const long long pos = base + 4 * lane;
#pragma unroll 1
  for (int r0 = 0; r0 < 32; r0 += 8) {
    uint32_t lo[8], hi[8];
    int lims[8];
#pragma unroll
    for (int j = 0; j < 8; j++) {
      lims[j] = __shfl_sync(SW_FULL, lim, r0 + j);
      const uint8_t *row = rows + (r0 + j) * stride;
      const long long o = pos - (long long)((uintptr_t)row & 3);
      const bool in = pos < lims[j];
      lo[j] = in && o >= 0 && o + 4 <= stride
                  ? *(const uint32_t *)(row + o) : 0;
      hi[j] = in && o != pos && o + 4 < lims[j] && o + 8 <= stride
                  ? *(const uint32_t *)(row + o + 4) : 0;
    }
#pragma unroll
    for (int j = 0; j < 8; j++) {
      const uint8_t *row = rows + (r0 + j) * stride;
      const int s = (int)((uintptr_t)row & 3);
      const long long o = pos - s;
      if (pos < lims[j]) {
        if (o < 0 || o + 4 > stride) lo[j] = sw_bytes(row, o, lims[j]);
        if (s && o + 4 < lims[j] && o + 8 > stride)
          hi[j] = sw_bytes(row, o + 4, lims[j]);
        stage[(r0 + j) * SW_PITCH + lane] = __funnelshift_r(lo[j], hi[j],
                                                            8 * s);
      }
    }
  }
}

// This thread's row of the stage as the 16 message words of block k,
// padded: bytes at or past len zero, 0x80 at len, and in the row's last
// block (last) word 15 the bit length (word 14, the high half of the
// 128-bit length, is zero: len < 2^61).
__device__ __forceinline__ void sw_words(const uint32_t *srow, int k, int len,
                                         bool last, u64 w[16]) {
#pragma unroll
  for (int q = 0; q < 8; q++) {
    const uint4 v = *(const uint4 *)(srow + 4 * q);
    w[2 * q] = ((u64)sw_bswap(v.x) << 32) | sw_bswap(v.y);
    w[2 * q + 1] = ((u64)sw_bswap(v.z) << 32) | sw_bswap(v.w);
  }
#pragma unroll
  for (int j = 0; j < 16; j++) {
    // Bytes of word j below len, and the word padded where it is < 8.
    const int off = len - (128 * k + 8 * j);
    const int o = off < 0 ? 0 : (off > 7 ? 7 : off);
    const u64 keep = o == 0 ? 0 : ~0ULL << (64 - 8 * o);
    const u64 pad = off >= 0 ? 0x80ULL << (56 - 8 * o) : 0;
    if (off < 8) w[j] = (w[j] & keep) | pad;
  }
  if (last) w[15] = (u64)len << 3;
}

__device__ __forceinline__ void sw_round(u64 &a, u64 &b, u64 &c, u64 &d,
                                         u64 &e, u64 &f, u64 &g, u64 &h,
                                         u64 k, u64 wt) {
  const u64 t1 = h + (rotr64(e, 14) ^ rotr64(e, 18) ^ rotr64(e, 41)) +
                 ((e & f) ^ (~e & g)) + k + wt;
  const u64 t2 = (rotr64(a, 28) ^ rotr64(a, 34) ^ rotr64(a, 39)) +
                 ((a & b) ^ (a & c) ^ (b & c));
  h = g; g = f; f = e; e = d + t1;
  d = c; c = b; b = a; a = t1 + t2;
}

// One compression of st by the block w (overwritten by the schedule):
// rounds 0-15, then four passes of 16 with the ring updated in place,
// unrolled within a pass so that every ring index is static.
__device__ __forceinline__ void sw_rounds(u64 st[8], u64 w[16]) {
  u64 a = st[0], b = st[1], c = st[2], d = st[3];
  u64 e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int j = 0; j < 16; j++) sw_round(a, b, c, d, e, f, g, h, K512[j], w[j]);
#pragma unroll 1
  for (int t = 16; t < 80; t += 16) {
#pragma unroll
    for (int j = 0; j < 16; j++) {
      const u64 w15 = w[(j + 1) & 15], w2 = w[(j + 14) & 15];
      w[j] += (rotr64(w15, 1) ^ rotr64(w15, 8) ^ (w15 >> 7)) +
              w[(j + 9) & 15] +
              (rotr64(w2, 19) ^ rotr64(w2, 61) ^ (w2 >> 6));
      sw_round(a, b, c, d, e, f, g, h, K512[t + j], w[j]);
    }
  }
  st[0] += a; st[1] += b; st[2] += c; st[3] += d;
  st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

// The state words of SHA-512(row[0:len]) for this thread's row row0 +
// lane; len = lens[row] clamped to [0, stride], 0 past n. Called by every
// thread of the warp (stage is the warp's own).
__device__ __forceinline__ void sw_hash(uint32_t *stage,
                                        const uint8_t *__restrict__ msgs,
                                        long long stride,
                                        const int *__restrict__ lens,
                                        long long n, long long row0, int lane,
                                        u64 st[8]) {
  const long long i = row0 + lane;
  int len = i < n ? lens[i] : 0;
  len = len < 0 ? 0 : (len > stride ? (int)stride : len);
  const int nb = sw_nblocks(len);
  const int nb_warp = __reduce_max_sync(SW_FULL, nb);
  const uint8_t *rows = msgs + stride * row0;
  const bool wide = sw_wide(msgs, stride);
#pragma unroll
  for (int q = 0; q < 8; q++) st[q] = SHA512_IV[q];
  for (int k = 0; k < nb_warp; k++) {
    sw_stage(stage, rows, stride, wide, len, k, lane);
    __syncwarp();
    u64 w[16], ns[8];
    sw_words(stage + lane * SW_PITCH, k, len, k == nb - 1, w);
    __syncwarp();
#pragma unroll
    for (int q = 0; q < 8; q++) ns[q] = st[q];
    sw_rounds(ns, w);
    const bool live = k < nb;
#pragma unroll
    for (int q = 0; q < 8; q++) st[q] = live ? ns[q] : st[q];
  }
}

// 32 little-endian bytes <-> four 64-bit limbs, as 8-byte accesses when
// al8 (every pointer of the launch 8-byte aligned), else bytes.
__device__ __forceinline__ void sw_load32(const uint8_t *p, bool al8,
                                          u64 r[4]) {
  if (al8) {
#pragma unroll
    for (int q = 0; q < 4; q++) r[q] = ((const u64 *)p)[q];
  } else {
    sc_load(p, r);
  }
}

__device__ __forceinline__ void sw_store32(uint8_t *o, bool al8,
                                           const u64 r[4]) {
  if (al8) {
#pragma unroll
    for (int q = 0; q < 4; q++) ((u64 *)o)[q] = r[q];
  } else {
    sc_store(o, r);
  }
}

// Blocks of a launch over n lanes, SW_WARPS warps a block.
static inline unsigned sw_blocks(long long n) {
  return (unsigned)((n + 32LL * SW_WARPS - 1) / (32LL * SW_WARPS));
}
