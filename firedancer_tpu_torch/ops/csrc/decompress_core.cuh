// Point decompression on a group of five threads a lane, the core of K2
// (decompress_so.cu) and decompress_niels.cu; its field ops on the
// group are also those of compress.cu (the inversion lg_invert),
// fe_pow.cu (lg_invert and lg_pow22523) and point_eq.cu (lg_mul_halves,
// lg_sub, lg_is_zero).
//
// Per lane, donna's decompression as K2 always ran it: y from the
// encoding with bit 255 masked, u = y^2 - 1, v = d y^2 + 1,
// x = u v^3 (u v^7)^((p-5)/8), the root checks v x^2 == +-u, the sign
// fix-up, T = x y; a lane whose root check fails carries the identity
// with ok = 0. 8 P == O (three doublings) gives the small-order mask,
// which reads 1 on failed lanes (the identity): callers test ok first.
// No inversion: the square root after the root checks and the sign
// fix-up is unique and every output is stored canonical, so the outputs
// equal those of the Montgomery-batched plain version
// (ops/decompress.py) bit for bit.
//
// Bound on this card: the chain. A lane is ~295 dependent field
// operations (267 S + 28 M), nearly all the 252-squaring pow22523
// ladder; the bytes (32 in, 162 or 402 out) are negligible. On one
// thread a lane (what K2 was) a squaring is ~212 SASS instructions, and
// at 2B = 16384 lanes the card holds one warp a scheduler, waiting on
// its own IMADs; the kernel's long straight-line code also runs cold in
// the RLC pass, where that one warp has nothing to hide the misses.
// Design: the lane's chain runs on a group of G = 5 threads, thread j
// owning limb j (radix 2^51) of every field element, so the card holds
// five to six warps a scheduler and each squaring is short:
//   squaring  thread j gathers the five limbs by width-32 shuffles from
//             its group, in the order a_{(3j + k) mod 5}, k = 0..4, and
//             forms column j of fe_sq with three products
//             (a_{3j}^2, 2 a_{3j+1} a_{3j+4}, 2 a_{3j+2} a_{3j+3}, each
//             times 19 where the limb indices wrap past 5);
//   multiply  thread j gathers a_{(j - k) mod 5} and b_k and forms
//             column j of fe_mul with five products (b_k times 19 for
//             k > j);
//   products  on 26-bit halves of the limbs: each partial product is
//             one 32 x 32 -> 64-bit multiply-add into three 64-bit sums
//             (64 x 64 -> 128-bit products took 66 instructions a
//             squaring to these 56);
//   carry     two rounds: r_j = t_j mod 2^51, c_j = t_j >> 51, limb j
//             takes c_{j-1} from its neighbour (19 c_4 at j = 0), then
//             once more; limbs come back under 2^52, the invariant of
//             fe25519.cuh (column sums < 2^111, first carries < 2^60,
//             second < 2^10);
//   add, sub  limb-wise, then one such round (carries < 8).
// The column sums equal fe_sq's and fe_mul's; only where the carries
// land differs, which the canonical stores erase. Canonical forms and
// compares gather the element to every thread of the group and run the
// one-thread fe_canonical there; each thread stores its own limb.
// A squaring is 56 instructions a thread (13 shuffles, the loop's
// branch included), 280 a lane against ~212 on one thread: the group
// buys occupancy with instructions, so it is issue-bound where the
// one-thread chain is latency-bound, and faster only where one warp a
// scheduler cannot fill the card (fewer lanes, cold code), slower where
// two can (4B lanes).
//
// A warp holds six lanes (threads 0-29); threads 30-31 rerun limbs 0-1
// of the sixth, and groups past the batch run the chain on y = 0; none
// of them stores.
// Every shuffle has a full mask, so every thread calls every group
// function: no early return, and no group function under a condition
// (both sides of a select are computed first).
#pragma once

#include "fe25519.cuh"

#define DC_GROUP 5                        // threads a lane
#define DC_LANES_PER_WARP (32 / DC_GROUP)  // 6, on threads 0-29
#define DC_WARPS 4
#define DC_THREADS (32 * DC_WARPS)
#define DC_LANES (DC_LANES_PER_WARP * DC_WARPS)  // lanes a block

// One thread's place in its lane's group.
struct limb_group {
  long long lane;  // the batch lane of the group
  int live;        // lane < n, on one of threads 0-29
  int j;           // the limb this thread owns
  int base;        // warp lane of the group's limb 0
  int prev;        // warp lane of limb j - 1 (mod 5)
  int sq_src[5];   // warp lane of limb (3j + k) mod 5
  int mul_src[5];  // warp lane of limb (j - k) mod 5
  unsigned wrap;   // 19 on limb 0 (a carry out of limb 4), else 1
  unsigned sq_f[3];  // the squaring's factors: 1 or 19, then 2 or 38 twice
};

__device__ __forceinline__ limb_group lg_make(long long n) {
  limb_group g;
  const int lane = threadIdx.x & 31;
  // Threads 30-31 rerun limbs 0-1 of the warp's sixth lane.
  const int spare = lane >= DC_GROUP * DC_LANES_PER_WARP;
  const int grp = spare ? DC_LANES_PER_WARP - 1 : lane / DC_GROUP;
  g.j = spare ? lane - DC_GROUP * DC_LANES_PER_WARP : lane - DC_GROUP * grp;
  g.base = DC_GROUP * grp;
  g.lane = ((long long)blockIdx.x * DC_WARPS + (threadIdx.x >> 5)) *
               DC_LANES_PER_WARP + grp;
  g.live = !spare && g.lane < n;
  g.prev = g.base + (g.j + 4) % 5;
  const int s0 = 3 * g.j % 5;
#pragma unroll
  for (int k = 0; k < 5; k++) {
    g.sq_src[k] = g.base + (s0 + k) % 5;
    g.mul_src[k] = g.base + (g.j + 5 - k) % 5;
  }
  g.wrap = g.j == 0 ? 19 : 1;
  // A product of limbs a and b lands in column (a + b) mod 5 and is
  // folded by 19 where a + b >= 5.
  g.sq_f[0] = 2 * s0 >= 5 ? 19 : 1;
  g.sq_f[1] = (s0 + 1) % 5 + (s0 + 4) % 5 >= 5 ? 38 : 2;
  g.sq_f[2] = (s0 + 2) % 5 + (s0 + 3) % 5 >= 5 ? 38 : 2;
  return g;
}

__device__ __forceinline__ u64 lg_shfl(u64 v, int src) {
  return __shfl_sync(FD_FULL_MASK, v, src);
}

__device__ __forceinline__ unsigned lg_shfl32(unsigned v, int src) {
  return __shfl_sync(FD_FULL_MASK, v, src);
}

// Products run on 26-bit halves of the limbs (a limb < 2^52 is lo + hi
// 2^26), so each partial product is one 32 x 32 -> 64-bit multiply-add:
// a column is s0 + s1 2^26 + s2 2^52, each sum < 2^61.
struct lg_col {
  u64 s0, s1, s2;
};

// t += x y, x as 26-bit halves, y as halves times a factor of at most 38.
__device__ __forceinline__ void lg_acc(lg_col &t, unsigned xl, unsigned xh,
                                       unsigned yl, unsigned yh) {
  t.s0 += (u64)xl * yl;
  t.s1 += (u64)xl * yh;
  t.s1 += (u64)xh * yl;
  t.s2 += (u64)xh * yh;
}

// Column j (< 2^111) -> limb j < 2^52: two carry rounds.
__device__ __forceinline__ u64 lg_reduce(const limb_group &g,
                                         const lg_col &t) {
  const u64 m = t.s0 + ((t.s1 & ((1ULL << 25) - 1)) << 26);
  const u64 c = (m >> 51) + (t.s1 >> 25) + (t.s2 << 1);
  const u64 s = (m & FD_MASK51) + lg_shfl(c, g.prev) * (u64)g.wrap;
  const unsigned c2 = (unsigned)(s >> 51);
  return (s & FD_MASK51) + (u64)lg_shfl32(c2, g.prev) * g.wrap;
}

// A limb below 2^54 -> below 2^52: one carry round.
__device__ __forceinline__ u64 lg_carry(const limb_group &g, u64 s) {
  const unsigned c = (unsigned)(s >> 51);
  return (s & FD_MASK51) + (u64)lg_shfl32(c, g.prev) * g.wrap;
}

__device__ __forceinline__ u64 lg_add(const limb_group &g, u64 a, u64 b) {
  return lg_carry(g, a + b);
}

// a - b + 4p limb-wise, as fe_sub: b < 2^52.
__device__ __forceinline__ u64 lg_sub(const limb_group &g, u64 a, u64 b) {
  const u64 four_p = g.j == 0 ? (1ULL << 53) - 76 : (1ULL << 53) - 4;
  return lg_carry(g, a + four_p - b);
}

__device__ __forceinline__ u64 lg_neg(const limb_group &g, u64 a) {
  return lg_sub(g, 0, a);
}

#define DC_MASK26 ((1u << 26) - 1)

__device__ __forceinline__ u64 lg_sq(const limb_group &g, u64 a) {
  const unsigned lo = (unsigned)a & DC_MASK26, hi = (unsigned)(a >> 26);
  unsigned rl[5], rh[5];
#pragma unroll
  for (int k = 0; k < 5; k++) {
    rl[k] = lg_shfl32(lo, g.sq_src[k]);
    rh[k] = lg_shfl32(hi, g.sq_src[k]);
  }
  lg_col t = {0, 0, 0};
  lg_acc(t, rl[0], rh[0], rl[0] * g.sq_f[0], rh[0] * g.sq_f[0]);
  lg_acc(t, rl[1], rh[1], rl[4] * g.sq_f[1], rh[4] * g.sq_f[1]);
  lg_acc(t, rl[2], rh[2], rl[3] * g.sq_f[2], rh[3] * g.sq_f[2]);
  return lg_reduce(g, t);
}

__device__ __forceinline__ u64 lg_sqn(const limb_group &g, u64 a, int n) {
#pragma unroll 1
  for (int i = 0; i < n; i++) a = lg_sq(g, a);
  return a;
}

// a times b, b's five limbs given as 26-bit halves bl[k], bh[k].
__device__ __forceinline__ u64 lg_mul_halves(const limb_group &g, u64 a,
                                             const unsigned *bl,
                                             const unsigned *bh) {
  const unsigned lo = (unsigned)a & DC_MASK26, hi = (unsigned)(a >> 26);
  lg_col t = {0, 0, 0};
#pragma unroll
  for (int k = 0; k < 5; k++) {
    const unsigned f = k > g.j ? 19 : 1;
    lg_acc(t, lg_shfl32(lo, g.mul_src[k]), lg_shfl32(hi, g.mul_src[k]),
           bl[k] * f, bh[k] * f);
  }
  return lg_reduce(g, t);
}

__device__ __forceinline__ u64 lg_mul(const limb_group &g, u64 a, u64 b) {
  const unsigned lo = (unsigned)b & DC_MASK26, hi = (unsigned)(b >> 26);
  unsigned bl[5], bh[5];
#pragma unroll
  for (int k = 0; k < 5; k++) {
    bl[k] = lg_shfl32(lo, g.base + k);
    bh[k] = lg_shfl32(hi, g.base + k);
  }
  return lg_mul_halves(g, a, bl, bh);
}

// a times a constant held in radix 2^51 (FE_D, FE_D2, FE_SQRTM1).
__device__ __forceinline__ u64 lg_mul_const(const limb_group &g, u64 a,
                                            const u64 *c) {
  unsigned bl[5], bh[5];
#pragma unroll
  for (int k = 0; k < 5; k++) {
    bl[k] = (unsigned)c[k] & DC_MASK26;
    bh[k] = (unsigned)(c[k] >> 26);
  }
  return lg_mul_halves(g, a, bl, bh);
}

// The group's element on every thread of the group.
__device__ __forceinline__ fe lg_gather(const limb_group &g, u64 a) {
  fe r;
#pragma unroll
  for (int k = 0; k < 5; k++) r.v[k] = lg_shfl(a, g.base + k);
  return r;
}

// Limb j of a, by selects (no local memory).
__device__ __forceinline__ u64 lg_limb(const limb_group &g, const fe &a) {
  return g.j == 0 ? a.v[0] : g.j == 1 ? a.v[1] : g.j == 2 ? a.v[2]
       : g.j == 3 ? a.v[3] : a.v[4];
}

__device__ __forceinline__ int lg_is_zero(const limb_group &g, u64 a) {
  return fe_is_zero(lg_gather(g, a));
}

__device__ __forceinline__ int lg_is_negative(const limb_group &g, u64 a) {
  return fe_is_negative(lg_gather(g, a));
}

// Row p of an int64 (.., 5) tensor: each thread writes its own limb.
__device__ __forceinline__ void lg_store_canonical(const limb_group &g,
                                                   int64_t *p, u64 a) {
  const u64 c = lg_limb(g, fe_canonical(lg_gather(g, a)));
  if (g.live) p[g.j] = (int64_t)c;
}

// The curve25519 addition-chain prefix on the group: z^(2^250 - 1) and
// z^11 (firedancer_tpu/ops/pow_pallas.py _ladder:85).
__device__ __forceinline__ void lg_pow_ladder(const limb_group &g, u64 z,
                                              u64 *z250, u64 *z11) {
  const u64 z2 = lg_sq(g, z);
  const u64 z9 = lg_mul(g, lg_sqn(g, z2, 2), z);
  const u64 z11_ = lg_mul(g, z9, z2);
  const u64 z_5_0 = lg_mul(g, lg_sq(g, z11_), z9);
  const u64 z_10_0 = lg_mul(g, lg_sqn(g, z_5_0, 5), z_5_0);
  const u64 z_20_0 = lg_mul(g, lg_sqn(g, z_10_0, 10), z_10_0);
  const u64 z_40_0 = lg_mul(g, lg_sqn(g, z_20_0, 20), z_20_0);
  const u64 z_50_0 = lg_mul(g, lg_sqn(g, z_40_0, 10), z_10_0);
  const u64 z_100_0 = lg_mul(g, lg_sqn(g, z_50_0, 50), z_50_0);
  const u64 z_200_0 = lg_mul(g, lg_sqn(g, z_100_0, 100), z_100_0);
  *z250 = lg_mul(g, lg_sqn(g, z_200_0, 50), z_50_0);
  *z11 = z11_;
}

// z^((p-5)/8) = z^(2^252 - 3) (pow_pallas.py pow22523_chain:107).
__device__ __forceinline__ u64 lg_pow22523(const limb_group &g, u64 z) {
  u64 z250, z11;
  lg_pow_ladder(g, z, &z250, &z11);
  return lg_mul(g, lg_sqn(g, z250, 2), z);
}

// z^(p-2) = z^(2^255 - 21), the inverse of a nonzero z, and 0 for z = 0
// (pow_pallas.py invert_chain:101).
__device__ __forceinline__ u64 lg_invert(const limb_group &g, u64 z) {
  u64 z250, z11;
  lg_pow_ladder(g, z, &z250, &z11);
  return lg_mul(g, lg_sqn(g, z250, 5), z11);
}

// This thread's limb of a decoded lane's X, Y and T (Z = 1), and ok.
struct dc_point {
  u64 X, Y, T;
  int ok;
};

__device__ __forceinline__ dc_point dc_decompress(const limb_group &g,
                                                  const uint8_t *enc) {
  const u64 one = g.j == 0;
  u64 y = 0;
  int sign = 0;
  if (g.live) {
    const uint8_t *s = enc + 32 * g.lane;
    y = lg_limb(g, fe_from_bytes(s));
    sign = s[31] >> 7;
  }
  const u64 yy = lg_sq(g, y);
  const u64 u = lg_sub(g, yy, one);
  const u64 v = lg_add(g, lg_mul_const(g, yy, FE_D), one);
  const u64 v3 = lg_mul(g, lg_sq(g, v), v);
  const u64 uv7 = lg_mul(g, lg_mul(g, lg_sq(g, v3), v), u);
  u64 x = lg_mul(g, lg_mul(g, lg_pow22523(g, uv7), v3), u);
  const u64 vxx = lg_mul(g, lg_sq(g, x), v);
  const int root_ok = lg_is_zero(g, lg_sub(g, vxx, u));
  const int neg_ok = lg_is_zero(g, lg_add(g, vxx, u));
  const u64 xi = lg_mul_const(g, x, FE_SQRTM1);
  if (!root_ok) x = xi;
  const u64 xn = lg_neg(g, x);
  if (lg_is_negative(g, x) != sign) x = xn;
  const u64 t = lg_mul(g, x, y);
  dc_point p;
  p.ok = root_ok | neg_ok;
  p.X = p.ok ? x : 0;
  p.Y = p.ok ? y : one;
  p.T = p.ok ? t : 0;
  return p;
}

// 8 P == O for P = (X : Y : 1): three doublings (fe25519.cuh ge_double)
// and the identity test, on the group.
__device__ __forceinline__ int dc_small_order(const limb_group &g,
                                              const dc_point &p) {
  u64 X = p.X, Y = p.Y, Z = g.j == 0;
#pragma unroll 1
  for (int i = 0; i < 3; i++) {
    const u64 a = lg_sq(g, X), b = lg_sq(g, Y), zz = lg_sq(g, Z);
    const u64 c = lg_add(g, zz, zz);
    const u64 d = lg_neg(g, a);
    const u64 e = lg_sub(g, lg_sub(g, lg_sq(g, lg_add(g, X, Y)), a), b);
    const u64 gg = lg_add(g, d, b);
    const u64 f = lg_sub(g, gg, c);
    const u64 h = lg_sub(g, d, b);
    X = lg_mul(g, e, f);
    Y = lg_mul(g, gg, h);
    Z = lg_mul(g, f, gg);
  }
  const int x_zero = lg_is_zero(g, X);
  const int y_is_z = lg_is_zero(g, lg_sub(g, Y, Z));
  return x_zero & y_is_z;
}

// Stores X, Y, Z = 1, T of a decoded lane as row o of (n, 4, 5) limbs.
__device__ __forceinline__ void dc_store_point(const limb_group &g,
                                               int64_t *o,
                                               const dc_point &p) {
  lg_store_canonical(g, o + 0, p.X);
  lg_store_canonical(g, o + 5, p.Y);
  if (g.live) o[10 + g.j] = g.j == 0;
  lg_store_canonical(g, o + 15, p.T);
}

static inline unsigned dc_blocks(long long n) {
  return (unsigned)((n + DC_LANES - 1) / DC_LANES);
}
