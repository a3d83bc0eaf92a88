// [L] P for each torsion-trial aggregate, L the prime group order: from
// the leading 1 of L, per remaining bit a doubling and, where the bit is
// set, a unified add of P. Identity iff P has no torsion component (the
// certification of verify_rlc.py:18-33).
//
// Replaces firedancer_tpu/ops/msm_pallas.py:164 mul_by_group_order_pallas
// (pallas_call at :218), which selects between the sum and the doubled
// point arithmetically so that every lane runs one op stream. L is
// public, so the branch here leaks nothing, and every thread takes the
// same branch.
//
// Bound on this card: latency. 252 doublings and 126 adds per point, one
// dependent chain; the main path has K = 64 trials, so 64 threads. Design:
// one thread per trial, 32 a block so the two warps land on two SMs; the
// bits of L are a compile-time constant (little-endian 64-bit words,
// held against sc25519.L by tests/test_torch_msm.py).
#include "msm.cuh"

#define ORDER_THREADS 32

__device__ __constant__ u64 L_WORDS[4] = {0x5812631a5cf5d3edULL,
                                          0x14def9dea2f79cd6ULL, 0x0ULL,
                                          0x1000000000000000ULL};
#define L_TOP_BIT 252

__global__ void msm_order_kernel(const int64_t *__restrict__ pts,
                                 int64_t *__restrict__ out, long long k) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= k) return;
  const ge p = ge_load(pts + 20 * i);
  ge r = p;
  for (int bit = L_TOP_BIT - 1; bit >= 0; bit--) {
    const bool set = (L_WORDS[bit >> 6] >> (bit & 63)) & 1;
    r = ge_double(r, set);
    if (set) r = ge_add_ext(r, p);
  }
  ge_store_canonical(out + 20 * i, r);
}

// pts: (k, 4, 5) int64; out: (k, 4, 5) int64.
extern "C" int fd_msm_mul_by_order(const void *pts, void *out, long long k,
                                   void *stream) {
  if (k <= 0) return 0;
  const unsigned blocks = (unsigned)((k + ORDER_THREADS - 1) / ORDER_THREADS);
  msm_order_kernel<<<blocks, ORDER_THREADS, 0, (cudaStream_t)stream>>>(
      (const int64_t *)pts, (int64_t *)out, k);
  return (int)cudaGetLastError();
}
