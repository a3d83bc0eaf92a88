// Scalar arithmetic mod L, the group order: sc_reduce64, x mod L of a
// 64-byte little-endian value, and sc_muladd, (a b + c) mod L of 32-byte
// scalars (c = 0 is a b mod L), each as canonical 32-byte scalars.
//
// Replaces the Pallas bodies firedancer_tpu/ops/sc_pallas.py:72
// _sc_reduce_kernel (launched at sc_pallas.py:141) and :76 _sc_mul_kernel
// (launched at :111), both on _barrett_body:47, and the XLA
// ops/sign.py:63 _sc_muladd, the same product with an addend. The TPU
// kernels hold byte limbs in int32 on (64, 2048)-lane tiles, because the
// vector unit has no wide multiply: a 32 x 32 convolution, sequential
// byte carries and a Barrett over b = 2^8. Here one thread owns a lane
// and keeps its value in registers: muladd256 (HAC 14.12) and
// sc_reduce512 (Barrett over b = 2^32, HAC 14.42) on PTX carry chains,
// the one copy in sha512.cuh that K1 and frontend_rlc use. The operands
// need not be reduced: a, b, c < 2^256 give a b + c < 2^512, Barrett's
// input range (signing's clamped a is above L, and h a + r reaches
// 2^508).
//
// Bound on this card: bytes (96 or 128 a lane) against the chains'
// products; at the main path's batches both are well under a
// microsecond, under the launch's own cost. Design:
// - Blocks of SC_THREADS threads, a thread a lane. A launch is bound by
//   one lane's latency, not by the SMs it reaches: of 32, 64, 128 and
//   256 threads at B and 2B lanes, 64 and 128 were the fastest, within
//   3 %, and 32, a block on every SM at B, 2-8 % slower
//   (firedancer_tpu_torch/tools/sc_times.py --sweep builds the others
//   with -DSC_THREADS).
// - A block's rows are one contiguous span of each input. The block
//   copies it into shared memory with coalesced accesses, access c of
//   the block (thread c mod SC_THREADS) taking bytes [w c, w (c + 1)) of
//   the span: w = 16 when every pointer of the launch is 16-byte aligned,
//   else 8 when all are 8-byte aligned, else 1. Rows start on 16-byte
//   boundaries of the span, so the base pointers decide, and no access
//   reaches past the block's last live row.
// - A staged row has SC_PAD 8-byte words of padding (a pitch of 9 words
//   for 64-byte rows, 5 for 32-byte rows: odd), so a half-warp's 8-byte
//   reads of word k of its 16 rows hit 16 distinct bank pairs.
// - Each live thread reads its row as 8-byte words, runs the chain and
//   writes its 32-byte result into a staged row; the block then stores
//   the results with the same coalesced accesses. Lanes past n compute
//   and store nothing.
#include "sha512.cuh"

// Threads (lanes) a block.
#ifndef SC_THREADS
#define SC_THREADS 64
#endif
// 8-byte words of padding after each staged row.
#define SC_PAD 1

// The launch's access width: 16 when every pointer is 16-byte aligned,
// 8 when every one is 8-byte aligned, else 1.
__device__ __forceinline__ int sc_width(uintptr_t ptrs) {
  return (ptrs & 15) == 0 ? 16 : ((ptrs & 7) == 0 ? 8 : 1);
}

// Copy the block's rows (rows of W 8-byte words, the span at src) into
// stage, row r at word r (W + SC_PAD), by accesses of width bytes.
template <int W>
__device__ __forceinline__ void sc_stage_in(u64 *stage,
                                            const uint8_t *__restrict__ src,
                                            int rows, int width) {
  const int t = threadIdx.x;
  if (width == 16) {
    constexpr int C = W / 2;  // 16-byte accesses a row
#pragma unroll
    for (int s = 0; s < C; s++) {
      const int c = t + s * SC_THREADS;
      if (c < rows * C) {
        const uint4 v = ((const uint4 *)src)[c];
        u64 *d = stage + (c / C) * (W + SC_PAD) + 2 * (c % C);
        d[0] = (u64)v.x | ((u64)v.y << 32);
        d[1] = (u64)v.z | ((u64)v.w << 32);
      }
    }
  } else if (width == 8) {
#pragma unroll
    for (int s = 0; s < W; s++) {
      const int c = t + s * SC_THREADS;
      if (c < rows * W)
        stage[(c / W) * (W + SC_PAD) + c % W] = ((const u64 *)src)[c];
    }
  } else {
    uint8_t *sb = (uint8_t *)stage;
#pragma unroll 8
    for (int s = 0; s < 8 * W; s++) {
      const int c = t + s * SC_THREADS;
      if (c < rows * 8 * W)
        sb[(c / (8 * W)) * 8 * (W + SC_PAD) + c % (8 * W)] = src[c];
    }
  }
}

// The block's 32-byte results from stage (row r at word r (4 + SC_PAD))
// to dst, by the accesses of sc_stage_in.
__device__ __forceinline__ void sc_stage_out(uint8_t *__restrict__ dst,
                                             const u64 *stage, int rows,
                                             int width) {
  const int t = threadIdx.x;
  constexpr int P = 4 + SC_PAD;
  if (width == 16) {
#pragma unroll
    for (int s = 0; s < 2; s++) {
      const int c = t + s * SC_THREADS;
      if (c < rows * 2) {
        const u64 *w = stage + (c / 2) * P + 2 * (c % 2);
        ((uint4 *)dst)[c] = make_uint4((uint32_t)w[0], (uint32_t)(w[0] >> 32),
                                       (uint32_t)w[1], (uint32_t)(w[1] >> 32));
      }
    }
  } else if (width == 8) {
#pragma unroll
    for (int s = 0; s < 4; s++) {
      const int c = t + s * SC_THREADS;
      if (c < rows * 4) ((u64 *)dst)[c] = stage[(c / 4) * P + c % 4];
    }
  } else {
    const uint8_t *sb = (const uint8_t *)stage;
#pragma unroll 8
    for (int s = 0; s < 32; s++) {
      const int c = t + s * SC_THREADS;
      if (c < rows * 32) dst[c] = sb[(c / 32) * 8 * P + c % 32];
    }
  }
}

// Live rows of block blockIdx.x: SC_THREADS, or fewer in the last block.
__device__ __forceinline__ int sc_rows(long long n) {
  const long long left = n - (long long)blockIdx.x * SC_THREADS;
  return left < SC_THREADS ? (int)left : SC_THREADS;
}

__global__ void __launch_bounds__(SC_THREADS)
    sc_reduce64_kernel(const uint8_t *__restrict__ in,
                       uint8_t *__restrict__ out, long long n) {
  __shared__ u64 xs[SC_THREADS * (8 + SC_PAD)];
  __shared__ u64 rs[SC_THREADS * (4 + SC_PAD)];
  const long long row0 = (long long)blockIdx.x * SC_THREADS;
  const int rows = sc_rows(n), t = threadIdx.x;
  const int width = sc_width((uintptr_t)in | (uintptr_t)out);
  sc_stage_in<8>(xs, in + 64 * row0, rows, width);
  __syncthreads();
  if (t < rows) {
    u64 x[8], r[4];
#pragma unroll
    for (int k = 0; k < 8; k++) x[k] = xs[t * (8 + SC_PAD) + k];
    sc_reduce512(x, r);
#pragma unroll
    for (int k = 0; k < 4; k++) rs[t * (4 + SC_PAD) + k] = r[k];
  }
  __syncthreads();
  sc_stage_out(out + 32 * row0, rs, rows, width);
}

// c may be null: the addend is then 0. The results overwrite a's stage,
// each thread its own row.
__global__ void __launch_bounds__(SC_THREADS)
    sc_muladd_kernel(const uint8_t *__restrict__ a_in,
                     const uint8_t *__restrict__ b_in,
                     const uint8_t *__restrict__ c_in,
                     uint8_t *__restrict__ out, long long n) {
  constexpr int P = 4 + SC_PAD;
  __shared__ u64 st[3][SC_THREADS * P];
  const long long row0 = (long long)blockIdx.x * SC_THREADS;
  const int rows = sc_rows(n), t = threadIdx.x;
  const int width = sc_width((uintptr_t)a_in | (uintptr_t)b_in |
                             (uintptr_t)c_in | (uintptr_t)out);
  sc_stage_in<4>(st[0], a_in + 32 * row0, rows, width);
  sc_stage_in<4>(st[1], b_in + 32 * row0, rows, width);
  if (c_in != nullptr) sc_stage_in<4>(st[2], c_in + 32 * row0, rows, width);
  __syncthreads();
  if (t < rows) {
    u64 a[4], b[4], c[4], x[8], r[4];
#pragma unroll
    for (int k = 0; k < 4; k++) {
      a[k] = st[0][t * P + k];
      b[k] = st[1][t * P + k];
      c[k] = c_in != nullptr ? st[2][t * P + k] : 0;
    }
    muladd256(a, b, c, x);
    sc_reduce512(x, r);
#pragma unroll
    for (int k = 0; k < 4; k++) st[0][t * P + k] = r[k];
  }
  __syncthreads();
  sc_stage_out(out + 32 * row0, st[0], rows, width);
}

static inline unsigned sc_blocks(long long n) {
  return (unsigned)((n + SC_THREADS - 1) / SC_THREADS);
}

// in: (n, 64) uint8; out: (n, 32) uint8.
extern "C" int fd_sc_reduce64(const void *in, void *out, long long n,
                              void *stream) {
  if (n <= 0) return 0;
  sc_reduce64_kernel<<<sc_blocks(n), SC_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t *)in, (uint8_t *)out, n);
  return (int)cudaGetLastError();
}

// a, b: (n, 32) uint8; c: (n, 32) uint8 or null; out: (n, 32) uint8.
extern "C" int fd_sc_muladd(const void *a, const void *b, const void *c,
                            void *out, long long n, void *stream) {
  if (n <= 0) return 0;
  sc_muladd_kernel<<<sc_blocks(n), SC_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t *)a, (const uint8_t *)b, (const uint8_t *)c,
      (uint8_t *)out, n);
  return (int)cudaGetLastError();
}
