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
// byte carries and a Barrett over b = 2^8. Here each lane is one thread
// and the value is eight 64-bit limbs in registers: mul256 (HAC 14.12)
// and sc_reduce512 (Barrett over b = 2^64, HAC 14.42), the one copy in
// sha512.cuh that K1 and frontend_rlc use. The operands need not be
// reduced: a, b, c < 2^256 give a b + c < 2^512, Barrett's input range
// (signing's clamped a is above L, and h a + r reaches 2^508).
//
// Bound on this card: bytes (96 or 128 a lane) against 39 or 55 64-bit
// products a lane; at the main path's batches both are a few
// microseconds, under the launch's own cost. Design: one thread per
// lane, nothing in shared memory.
#include "sha512.cuh"

__global__ void sc_reduce64_kernel(const uint8_t *__restrict__ in,
                                   uint8_t *__restrict__ out, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  u64 x[8], r[4];
  sc_load(in + 64 * i, x);
  sc_load(in + 64 * i + 32, x + 4);
  sc_reduce512(x, r);
  sc_store(out + 32 * i, r);
}

// c may be null: the addend is then 0.
__global__ void sc_muladd_kernel(const uint8_t *__restrict__ a_in,
                                 const uint8_t *__restrict__ b_in,
                                 const uint8_t *__restrict__ c_in,
                                 uint8_t *__restrict__ out, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  u64 a[4], b[4], x[8], r[4];
  sc_load(a_in + 32 * i, a);
  sc_load(b_in + 32 * i, b);
  mul256(a, b, x);
  if (c_in != nullptr) {
    u64 c[4];
    sc_load(c_in + 32 * i, c);
    u64 carry = 0;
#pragma unroll
    for (int k = 0; k < 8; k++) {
      u128 t = (u128)x[k] + (k < 4 ? c[k] : 0) + carry;
      x[k] = (u64)t;
      carry = (u64)(t >> 64);
    }
  }
  sc_reduce512(x, r);
  sc_store(out + 32 * i, r);
}

// in: (n, 64) uint8; out: (n, 32) uint8.
extern "C" int fd_sc_reduce64(const void *in, void *out, long long n,
                              void *stream) {
  if (n <= 0) return 0;
  sc_reduce64_kernel<<<fd_blocks(n), FD_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t *)in, (uint8_t *)out, n);
  return (int)cudaGetLastError();
}

// a, b: (n, 32) uint8; c: (n, 32) uint8 or null; out: (n, 32) uint8.
extern "C" int fd_sc_muladd(const void *a, const void *b, const void *c,
                            void *out, long long n, void *stream) {
  if (n <= 0) return 0;
  sc_muladd_kernel<<<fd_blocks(n), FD_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t *)a, (const uint8_t *)b, (const uint8_t *)c,
      (uint8_t *)out, n);
  return (int)cudaGetLastError();
}
