// Cross-window Horner of the Pippenger MSM: sum_t 2^(w t) W_t, from the
// top window down, w doublings and one unified add per window.
//
// Replaces firedancer_tpu/ops/msm_pallas.py:248 window_horner_pallas
// (pallas_call at :295), which runs the chain in VMEM on window columns
// broadcast to (nw * 32, 128) row blocks.
//
// Bound on this card: latency. The chain is serial by nature: 17 x 7
// doublings and 17 adds for the z MSM, 36 x 7 and 36 for the 253-bit
// MSM, about 1,100 and 2,300 dependent multiplies; at one thread an H100
// takes ~360 ns per multiply (0.40 and 0.84 ms). Design: one thread per
// MSM, the window sums read straight from device memory.
#include "msm.cuh"

__global__ void msm_horner_kernel(const int64_t *__restrict__ w,
                                  int64_t *__restrict__ out, int nw,
                                  int w_bits) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  ge r = ge_load(w + 20LL * (nw - 1));
  for (int t = nw - 2; t >= 0; t--) {
    for (int k = 0; k < w_bits; k++) r = ge_double(r, k == w_bits - 1);
    r = ge_add_ext(r, ge_load(w + 20LL * t));
  }
  ge_store_canonical(out, r);
}

// w: (nw, 4, 5) int64 window sums, window t in row t; out: (1, 4, 5).
extern "C" int fd_msm_horner(const void *w, void *out, int nw, int w_bits,
                             void *stream) {
  if (nw <= 0) return 0;
  msm_horner_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const int64_t *)w, (int64_t *)out, nw, w_bits);
  return (int)cudaGetLastError();
}
