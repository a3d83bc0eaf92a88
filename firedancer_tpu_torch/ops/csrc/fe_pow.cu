// The GF(2^255 - 19) power chains per lane: z^(p - 2), the inverse
// (fe_invert; 0 for z = 0), and z^((p - 5)/8) (fe_pow22523), one kernel
// templated on the chain, canonical radix-2^51 limbs out.
//
// Replaces the Pallas body firedancer_tpu/ops/pow_pallas.py:113
// _pow_kernel (chains invert_chain:101 and pow22523_chain:107 on
// _ladder:85), launched at pow_pallas.py:148. The TPU kernel keeps a
// 512-lane tile in VMEM so that the ~265 sequential multiplies never
// stream through HBM; here each lane is one thread and the chain runs in
// registers: fe_invert and fe_pow22523 of fe25519.cuh, the device
// functions compress runs, called and not copied (K2 and
// decompress_niels run fe_pow22523's chain on five threads a lane,
// decompress_core.cuh lg_pow22523).
//
// Bound on this card: integer multiply issue (254 or 251 squarings and
// 11 multiplies a lane) against 80 bytes a lane. Design: one
// thread per lane; the chain is one dependent sequence per lane, so the
// card needs many lanes in flight to hide the multiply latency.
#include "fe25519.cuh"

template <bool INVERT>
__global__ void fe_pow_kernel(const int64_t *__restrict__ z,
                              int64_t *__restrict__ out, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const fe x = fe_load(z + 5 * i);
  fe_store_canonical(out + 5 * i, INVERT ? fe_invert(x) : fe_pow22523(x));
}

// invert: 1 for z^(p - 2), 0 for z^((p - 5)/8); z: (n, 5) int64 limbs in
// [0, 2^52); out: (n, 5) int64 canonical limbs.
extern "C" int fd_fe_pow(int invert, const void *z, void *out, long long n,
                         void *stream) {
  if (n <= 0) return 0;
  if (invert)
    fe_pow_kernel<true><<<fd_blocks(n), FD_THREADS, 0, (cudaStream_t)stream>>>(
        (const int64_t *)z, (int64_t *)out, n);
  else
    fe_pow_kernel<false><<<fd_blocks(n), FD_THREADS, 0,
                           (cudaStream_t)stream>>>((const int64_t *)z,
                                                   (int64_t *)out, n);
  return (int)cudaGetLastError();
}
