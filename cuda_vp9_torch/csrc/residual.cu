// VP9 residual transforms (K2), hand-written for Hopper:
// `vp9_residual_frame`.
//
// Replaces the XLA stage of cuda_vp9_tpu/runtime/fused.py
// `_residual_pass` (:44) with the bucket loops that feed it (:533-602),
// in the single-frame step and in the batched step (its vmap written out
// as a stream axis).  One launch per frame (or batched round) runs every
// coefficient bucket with trips: the host passes a table of the buckets,
// and each block finds its bucket in the table's block ranges.  Each
// transform unit
//   * reads its coefficients: int16 at bd 8, (hi << 15) + lo above, both
//     words sign-extended;
//   * expands them to raster order: a scan-prefix bucket through the
//     [4, ncoef] scan table of its tx_type (cpos[3] & 3), the 32x32 coo
//     buckets from (raster index, value) pairs, where a (0, 0) pair is
//     padding and writes nothing;
//   * runs the row and the column 1-D passes (DCT or ADST by tx_type;
//     32x32 always DCT; the 4x4 WHT in a lossless frame) and the final
//     round shift;
//   * writes the n x n residual into R at (plane, y, x) = (cpos[0],
//     cpos[1] - 1, cpos[2]); cpos[1] == 0 is a padded record and writes
//     nothing.
// Buckets write disjoint units of R, so their blocks need no order.
//
// Arithmetic.  The kernel computes what the port's twin computes
// (cuda_vp9_torch/ops/transforms.py over the 1-D butterflies of
// ops/ref/transforms.py), the JAX step's domains: at bd 8 the WRAPLOW
// points wrap to 16 bits (the int16 domain: adds wrap in int16, products
// widen to int32, dct_const_round_shift truncates to int16), at bd 10
// and 12 each WRAPLOW point wraps to bd + 8 bits and products wrap in
// int32; the final round shift is int32.  Every add, subtract and
// multiply is done in uint32_t (type I below), so signed overflow, which
// the reference's int32 products reach at bd 12, is defined here and the
// compiler cannot assume it away.  The butterflies below are the
// reference's, call site for call site (D.w, D.n, D.rs).  Tensor cores
// do not apply: every butterfly stage rounds and wraps its sums, which a
// matrix product would carry unrounded.
//
// Layout.  128 threads a block, n threads a unit (128 / n units a
// block); a unit's n x n block lives in shared memory as int32 with a
// row stride of n + 1 words.  A thread expands its share of the
// coefficients, then runs the 1-D transform of row t in registers
// (reading b[t (n + 1) + q]) and writes it back, then that of column t
// (b[q (n + 1) + t]), and writes column t of the residual.  The padding
// is the choice over a swizzle: with stride n + 1 the 32 lanes of a warp
// hit 32 distinct banks in both passes at every n (the units of a warp
// sit n (n + 1) words apart, which shifts them onto the banks the others
// leave free), with one index formula; a row stride of n made the row
// pass a 16-way (n 16) or 32-way (n 32) conflict on every load.
//
// What bounds it.  A unit reads at most 2 n^2 int16 words and writes n^2
// int32 pixels; the butterflies cost about 2 n log2 n operations a pixel.
// A 1080p keyframe's buckets are a few MB, microseconds at the memory
// rate, so the design makes the frame one host call and one launch (the
// host's table is a kernel parameter); what remains is that call's host
// work and the launch.  One kernel holds every transform size; ptxas
// gives it 48 registers, no spills and 16,896 bytes of shared memory
// (the tx 3 branch's 4 units of 32 x 33 words).  Measured by
// chip_smoke.py on an NVIDIA H100 80GB HBM3 at its 700 W power limit:
// hd01's 1080p keyframe (10 buckets) 0.144 ms for the wrapper's call, of
// which 0.114 ms is its host work, and 0.025 ms a launch of its table
// back to back.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

// An int32 value with wrapping (modular) + - * and negation.
struct I {
  uint32_t v;
  __device__ __forceinline__ I() : v(0u) {}
  __device__ __forceinline__ I(int x) : v(static_cast<uint32_t>(x)) {}
  __device__ __forceinline__ int s() const { return static_cast<int32_t>(v); }
};

__device__ __forceinline__ I mk(uint32_t v) {
  I r;
  r.v = v;
  return r;
}
__device__ __forceinline__ I operator+(I a, I b) { return mk(a.v + b.v); }
__device__ __forceinline__ I operator-(I a, I b) { return mk(a.v - b.v); }
__device__ __forceinline__ I operator*(I a, I b) { return mk(a.v * b.v); }
__device__ __forceinline__ I operator-(I a) { return mk(0u - a.v); }

// The WRAPLOW domain: values wrap to 32 - sh bits (16 at bd 8, bd + 8
// above) at n() and rs(); w() widens, which changes nothing in int32.
struct Dom {
  int sh;
  __device__ __forceinline__ I w(I x) const { return x; }
  __device__ __forceinline__ I n(I x) const {
    return I(static_cast<int32_t>(x.v << sh) >> sh);
  }
  __device__ __forceinline__ I rs(I x) const {
    return n(I(static_cast<int32_t>(x.v + 8192u) >> 14));
  }
};

__device__ __forceinline__ int _c(int i) {
  constexpr int kCospi[32] = {
      16384, 16364, 16305, 16207, 16069, 15893, 15679, 15426,
      15137, 14811, 14449, 14053, 13623, 13160, 12665, 12140,
      11585, 11003, 10394, 9760,  9102,  8423,  7723,  7005,
      6270,  5520,  4756,  3981,  3196,  2404,  1606,  804};
  return kCospi[i];
}

__device__ __forceinline__ int SINPI(int i) {
  constexpr int kSinpi[5] = {0, 5283, 9929, 13377, 15212};
  return kSinpi[i];
}

// ------------------------------------------------------------------ 1-D

__device__ __forceinline__ void idct4(const I* inp, I* out, const Dom& D) {
  const I i0 = inp[0], i1 = inp[1], i2 = inp[2], i3 = inp[3];
  const I s0 = D.rs((D.w(i0) + D.w(i2)) * _c(16));
  const I s1 = D.rs((D.w(i0) - D.w(i2)) * _c(16));
  const I s2 = D.rs(D.w(i1) * _c(24) - D.w(i3) * _c(8));
  const I s3 = D.rs(D.w(i1) * _c(8) + D.w(i3) * _c(24));
  out[0] = D.n(s0 + s3);
  out[1] = D.n(s1 + s2);
  out[2] = D.n(s1 - s2);
  out[3] = D.n(s0 - s3);
}

__device__ __forceinline__ void iadst4(const I* inp, I* out, const Dom& D) {
  const I x0 = inp[0], x1 = inp[1], x2 = inp[2], x3 = inp[3];
  I s0 = SINPI(1) * D.w(x0);
  I s1 = SINPI(2) * D.w(x0);
  const I s2 = SINPI(3) * D.w(x1);
  const I s3 = SINPI(4) * D.w(x2);
  const I s4 = SINPI(1) * D.w(x2);
  const I s5 = SINPI(2) * D.w(x3);
  const I s6 = SINPI(4) * D.w(x3);
  const I s7 = D.n(x0 - x2 + x3);
  s0 = s0 + s3 + s5;
  s1 = s1 - s4 - s6;
  const I s3b = s2;
  const I s2b = SINPI(3) * D.w(s7);
  out[0] = D.rs(s0 + s3b);
  out[1] = D.rs(s1 + s3b);
  out[2] = D.rs(s2b);
  out[3] = D.rs(s0 + s1 - s3b);
}

__device__ __forceinline__ void idct8(const I* i, I* out, const Dom& D) {
  // stage 1
  const I s1_0 = i[0], s1_2 = i[4], s1_1 = i[2], s1_3 = i[6];
  const I s1_4 = D.rs(D.w(i[1]) * _c(28) - D.w(i[7]) * _c(4));
  const I s1_7 = D.rs(D.w(i[1]) * _c(4) + D.w(i[7]) * _c(28));
  const I s1_5 = D.rs(D.w(i[5]) * _c(12) - D.w(i[3]) * _c(20));
  const I s1_6 = D.rs(D.w(i[5]) * _c(20) + D.w(i[3]) * _c(12));
  // stage 2
  const I s2_0 = D.rs((D.w(s1_0) + D.w(s1_2)) * _c(16));
  const I s2_1 = D.rs((D.w(s1_0) - D.w(s1_2)) * _c(16));
  const I s2_2 = D.rs(D.w(s1_1) * _c(24) - D.w(s1_3) * _c(8));
  const I s2_3 = D.rs(D.w(s1_1) * _c(8) + D.w(s1_3) * _c(24));
  const I s2_4 = D.n(s1_4 + s1_5);
  const I s2_5 = D.n(s1_4 - s1_5);
  const I s2_6 = D.n(-s1_6 + s1_7);
  const I s2_7 = D.n(s1_6 + s1_7);
  // stage 3
  const I t0 = D.n(s2_0 + s2_3);
  const I t1 = D.n(s2_1 + s2_2);
  const I t2 = D.n(s2_1 - s2_2);
  const I t3 = D.n(s2_0 - s2_3);
  const I t4 = s2_4;
  const I t5 = D.rs((D.w(s2_6) - D.w(s2_5)) * _c(16));
  const I t6 = D.rs((D.w(s2_5) + D.w(s2_6)) * _c(16));
  const I t7 = s2_7;
  out[0] = D.n(t0 + t7);
  out[1] = D.n(t1 + t6);
  out[2] = D.n(t2 + t5);
  out[3] = D.n(t3 + t4);
  out[4] = D.n(t3 - t4);
  out[5] = D.n(t2 - t5);
  out[6] = D.n(t1 - t6);
  out[7] = D.n(t0 - t7);
}

__device__ __forceinline__ void iadst8(const I* inp, I* out, const Dom& D) {
  I x[8] = {inp[7], inp[0], inp[5], inp[2], inp[3], inp[4], inp[1], inp[6]};
  // stage 1
  I xw[8];
  for (int k = 0; k < 8; ++k) xw[k] = D.w(x[k]);
  I s0 = _c(2) * xw[0] + _c(30) * xw[1];
  I s1 = _c(30) * xw[0] - _c(2) * xw[1];
  I s2 = _c(10) * xw[2] + _c(22) * xw[3];
  I s3 = _c(22) * xw[2] - _c(10) * xw[3];
  I s4 = _c(18) * xw[4] + _c(14) * xw[5];
  I s5 = _c(14) * xw[4] - _c(18) * xw[5];
  I s6 = _c(26) * xw[6] + _c(6) * xw[7];
  I s7 = _c(6) * xw[6] - _c(26) * xw[7];
  I x0 = D.rs(s0 + s4);
  I x1 = D.rs(s1 + s5);
  I x2 = D.rs(s2 + s6);
  I x3 = D.rs(s3 + s7);
  I x4 = D.rs(s0 - s4);
  I x5 = D.rs(s1 - s5);
  I x6 = D.rs(s2 - s6);
  I x7 = D.rs(s3 - s7);
  // stage 2
  s0 = x0;
  s1 = x1;
  s2 = x2;
  s3 = x3;
  s4 = _c(8) * D.w(x4) + _c(24) * D.w(x5);
  s5 = _c(24) * D.w(x4) - _c(8) * D.w(x5);
  s6 = -_c(24) * D.w(x6) + _c(8) * D.w(x7);
  s7 = _c(8) * D.w(x6) + _c(24) * D.w(x7);
  x0 = D.n(s0 + s2);
  x1 = D.n(s1 + s3);
  x2 = D.n(s0 - s2);
  x3 = D.n(s1 - s3);
  x4 = D.rs(s4 + s6);
  x5 = D.rs(s5 + s7);
  x6 = D.rs(s4 - s6);
  x7 = D.rs(s5 - s7);
  // stage 3
  s2 = _c(16) * (D.w(x2) + D.w(x3));
  s3 = _c(16) * (D.w(x2) - D.w(x3));
  s6 = _c(16) * (D.w(x6) + D.w(x7));
  s7 = _c(16) * (D.w(x6) - D.w(x7));
  x2 = D.rs(s2);
  x3 = D.rs(s3);
  x6 = D.rs(s6);
  x7 = D.rs(s7);
  out[0] = D.n(x0);
  out[1] = D.n(-x4);
  out[2] = D.n(x6);
  out[3] = D.n(-x2);
  out[4] = D.n(x3);
  out[5] = D.n(-x7);
  out[6] = D.n(x5);
  out[7] = D.n(-x1);
}

__device__ __forceinline__ void idct16(const I* inp, I* out, const Dom& D) {
  constexpr int order[16] = {0, 8, 4, 12, 2, 10, 6, 14,
                             1, 9, 5, 13, 3, 11, 7, 15};
  I s1[16], s2[16], t[16], u[16], v[16], w[16];
  for (int k = 0; k < 16; ++k) s1[k] = inp[order[k]];
  // stage 2
  for (int k = 0; k < 8; ++k) s2[k] = s1[k];
  s2[8] = D.rs(D.w(s1[8]) * _c(30) - D.w(s1[15]) * _c(2));
  s2[15] = D.rs(D.w(s1[8]) * _c(2) + D.w(s1[15]) * _c(30));
  s2[9] = D.rs(D.w(s1[9]) * _c(14) - D.w(s1[14]) * _c(18));
  s2[14] = D.rs(D.w(s1[9]) * _c(18) + D.w(s1[14]) * _c(14));
  s2[10] = D.rs(D.w(s1[10]) * _c(22) - D.w(s1[13]) * _c(10));
  s2[13] = D.rs(D.w(s1[10]) * _c(10) + D.w(s1[13]) * _c(22));
  s2[11] = D.rs(D.w(s1[11]) * _c(6) - D.w(s1[12]) * _c(26));
  s2[12] = D.rs(D.w(s1[11]) * _c(26) + D.w(s1[12]) * _c(6));
  // stage 3
  for (int k = 0; k < 4; ++k) t[k] = s2[k];
  t[4] = D.rs(D.w(s2[4]) * _c(28) - D.w(s2[7]) * _c(4));
  t[7] = D.rs(D.w(s2[4]) * _c(4) + D.w(s2[7]) * _c(28));
  t[5] = D.rs(D.w(s2[5]) * _c(12) - D.w(s2[6]) * _c(20));
  t[6] = D.rs(D.w(s2[5]) * _c(20) + D.w(s2[6]) * _c(12));
  t[8] = D.n(s2[8] + s2[9]);
  t[9] = D.n(s2[8] - s2[9]);
  t[10] = D.n(-s2[10] + s2[11]);
  t[11] = D.n(s2[10] + s2[11]);
  t[12] = D.n(s2[12] + s2[13]);
  t[13] = D.n(s2[12] - s2[13]);
  t[14] = D.n(-s2[14] + s2[15]);
  t[15] = D.n(s2[14] + s2[15]);
  // stage 4
  u[0] = D.rs((D.w(t[0]) + D.w(t[1])) * _c(16));
  u[1] = D.rs((D.w(t[0]) - D.w(t[1])) * _c(16));
  u[2] = D.rs(D.w(t[2]) * _c(24) - D.w(t[3]) * _c(8));
  u[3] = D.rs(D.w(t[2]) * _c(8) + D.w(t[3]) * _c(24));
  u[4] = D.n(t[4] + t[5]);
  u[5] = D.n(t[4] - t[5]);
  u[6] = D.n(-t[6] + t[7]);
  u[7] = D.n(t[6] + t[7]);
  u[8] = t[8];
  u[15] = t[15];
  u[9] = D.rs(-D.w(t[9]) * _c(8) + D.w(t[14]) * _c(24));
  u[14] = D.rs(D.w(t[9]) * _c(24) + D.w(t[14]) * _c(8));
  u[10] = D.rs(-D.w(t[10]) * _c(24) - D.w(t[13]) * _c(8));
  u[13] = D.rs(-D.w(t[10]) * _c(8) + D.w(t[13]) * _c(24));
  u[11] = t[11];
  u[12] = t[12];
  // stage 5
  v[0] = D.n(u[0] + u[3]);
  v[1] = D.n(u[1] + u[2]);
  v[2] = D.n(u[1] - u[2]);
  v[3] = D.n(u[0] - u[3]);
  v[4] = u[4];
  v[5] = D.rs((D.w(u[6]) - D.w(u[5])) * _c(16));
  v[6] = D.rs((D.w(u[5]) + D.w(u[6])) * _c(16));
  v[7] = u[7];
  v[8] = D.n(u[8] + u[11]);
  v[9] = D.n(u[9] + u[10]);
  v[10] = D.n(u[9] - u[10]);
  v[11] = D.n(u[8] - u[11]);
  v[12] = D.n(-u[12] + u[15]);
  v[13] = D.n(-u[13] + u[14]);
  v[14] = D.n(u[13] + u[14]);
  v[15] = D.n(u[12] + u[15]);
  // stage 6
  w[0] = D.n(v[0] + v[7]);
  w[1] = D.n(v[1] + v[6]);
  w[2] = D.n(v[2] + v[5]);
  w[3] = D.n(v[3] + v[4]);
  w[4] = D.n(v[3] - v[4]);
  w[5] = D.n(v[2] - v[5]);
  w[6] = D.n(v[1] - v[6]);
  w[7] = D.n(v[0] - v[7]);
  w[8] = v[8];
  w[9] = v[9];
  w[10] = D.rs((-D.w(v[10]) + D.w(v[13])) * _c(16));
  w[13] = D.rs((D.w(v[10]) + D.w(v[13])) * _c(16));
  w[11] = D.rs((-D.w(v[11]) + D.w(v[12])) * _c(16));
  w[12] = D.rs((D.w(v[11]) + D.w(v[12])) * _c(16));
  w[14] = v[14];
  w[15] = v[15];
  // stage 7
  for (int k = 0; k < 8; ++k) out[k] = D.n(w[k] + w[15 - k]);
  for (int k = 8; k < 16; ++k) out[k] = D.n(w[15 - k] - w[k]);
}

__device__ __forceinline__ void iadst16(const I* inp, I* out, const Dom& D) {
  constexpr int order[16] = {15, 0, 13, 2, 11, 4, 9, 6,
                             7, 8, 5, 10, 3, 12, 1, 14};
  I x[16], s[16];
  for (int k = 0; k < 16; ++k) x[k] = inp[order[k]];
  // stage 1
  constexpr int cp[8][2] = {{1, 31}, {5, 27}, {9, 23}, {13, 19},
                            {17, 15}, {21, 11}, {25, 7}, {29, 3}};
  for (int k = 0; k < 8; ++k) {
    const int a = cp[k][0], b = cp[k][1];
    const I xa = D.w(x[2 * k]), xb = D.w(x[2 * k + 1]);
    s[2 * k] = xa * _c(a) + xb * _c(b);
    s[2 * k + 1] = xa * _c(b) - xb * _c(a);
  }
  for (int k = 0; k < 8; ++k) {
    x[k] = D.rs(s[k] + s[k + 8]);
    x[k + 8] = D.rs(s[k] - s[k + 8]);
  }
  // stage 2
  for (int k = 0; k < 8; ++k) s[k] = x[k];
  s[8] = D.w(x[8]) * _c(4) + D.w(x[9]) * _c(28);
  s[9] = D.w(x[8]) * _c(28) - D.w(x[9]) * _c(4);
  s[10] = D.w(x[10]) * _c(20) + D.w(x[11]) * _c(12);
  s[11] = D.w(x[10]) * _c(12) - D.w(x[11]) * _c(20);
  s[12] = -D.w(x[12]) * _c(28) + D.w(x[13]) * _c(4);
  s[13] = D.w(x[12]) * _c(4) + D.w(x[13]) * _c(28);
  s[14] = -D.w(x[14]) * _c(12) + D.w(x[15]) * _c(20);
  s[15] = D.w(x[14]) * _c(20) + D.w(x[15]) * _c(12);
  for (int k = 0; k < 4; ++k) {
    x[k] = D.n(s[k] + s[k + 4]);
    x[k + 4] = D.n(s[k] - s[k + 4]);
  }
  for (int k = 8; k < 12; ++k) {
    x[k] = D.rs(s[k] + s[k + 4]);
    x[k + 4] = D.rs(s[k] - s[k + 4]);
  }
  // stage 3
  for (int k = 0; k < 4; ++k) s[k] = x[k];
  s[4] = D.w(x[4]) * _c(8) + D.w(x[5]) * _c(24);
  s[5] = D.w(x[4]) * _c(24) - D.w(x[5]) * _c(8);
  s[6] = -D.w(x[6]) * _c(24) + D.w(x[7]) * _c(8);
  s[7] = D.w(x[6]) * _c(8) + D.w(x[7]) * _c(24);
  s[8] = x[8];
  s[9] = x[9];
  s[10] = x[10];
  s[11] = x[11];
  s[12] = D.w(x[12]) * _c(8) + D.w(x[13]) * _c(24);
  s[13] = D.w(x[12]) * _c(24) - D.w(x[13]) * _c(8);
  s[14] = -D.w(x[14]) * _c(24) + D.w(x[15]) * _c(8);
  s[15] = D.w(x[14]) * _c(8) + D.w(x[15]) * _c(24);
  x[0] = D.n(s[0] + s[2]);
  x[1] = D.n(s[1] + s[3]);
  x[2] = D.n(s[0] - s[2]);
  x[3] = D.n(s[1] - s[3]);
  x[4] = D.rs(s[4] + s[6]);
  x[5] = D.rs(s[5] + s[7]);
  x[6] = D.rs(s[4] - s[6]);
  x[7] = D.rs(s[5] - s[7]);
  x[8] = D.n(s[8] + s[10]);
  x[9] = D.n(s[9] + s[11]);
  x[10] = D.n(s[8] - s[10]);
  x[11] = D.n(s[9] - s[11]);
  x[12] = D.rs(s[12] + s[14]);
  x[13] = D.rs(s[13] + s[15]);
  x[14] = D.rs(s[12] - s[14]);
  x[15] = D.rs(s[13] - s[15]);
  // stage 4
  s[2] = (-_c(16)) * (D.w(x[2]) + D.w(x[3]));
  s[3] = _c(16) * (D.w(x[2]) - D.w(x[3]));
  s[6] = _c(16) * (D.w(x[6]) + D.w(x[7]));
  s[7] = _c(16) * (-D.w(x[6]) + D.w(x[7]));
  s[10] = _c(16) * (D.w(x[10]) + D.w(x[11]));
  s[11] = _c(16) * (-D.w(x[10]) + D.w(x[11]));
  s[14] = (-_c(16)) * (D.w(x[14]) + D.w(x[15]));
  s[15] = _c(16) * (D.w(x[14]) - D.w(x[15]));
  x[2] = D.rs(s[2]);
  x[3] = D.rs(s[3]);
  x[6] = D.rs(s[6]);
  x[7] = D.rs(s[7]);
  x[10] = D.rs(s[10]);
  x[11] = D.rs(s[11]);
  x[14] = D.rs(s[14]);
  x[15] = D.rs(s[15]);
  const I o[16] = {x[0], -x[8], x[12], -x[4], x[6],  x[14], x[10], x[2],
                   x[3], x[11], x[15], x[7],  x[5], -x[13], x[9], -x[1]};
  for (int k = 0; k < 16; ++k) out[k] = D.n(o[k]);
}

__device__ __forceinline__ void idct32(const I* inp, I* out, const Dom& D) {
  constexpr int order[16] = {0, 16, 8, 24, 4, 20, 12, 28,
                             2, 18, 10, 26, 6, 22, 14, 30};
  I s1[32], s2[32], t[32], u[32], v[32], w[32], p[32];
  for (int k = 0; k < 16; ++k) s1[k] = inp[order[k]];
  constexpr int pairs[8][4] = {{1, 31, 31, 1}, {17, 15, 15, 17},
                               {9, 23, 23, 9}, {25, 7, 7, 25},
                               {5, 27, 27, 5}, {21, 11, 11, 21},
                               {13, 19, 19, 13}, {29, 3, 3, 29}};
  for (int k = 0; k < 8; ++k) {
    const int ia = pairs[k][0], ib = pairs[k][1];
    const int ca = pairs[k][2], cb = pairs[k][3];
    const I a = inp[ia];
    const I b = inp[ib];
    s1[16 + k] = D.rs(D.w(a) * _c(ca) - D.w(b) * _c(cb));
    s1[31 - k] = D.rs(D.w(a) * _c(cb) + D.w(b) * _c(ca));
  }
  // stage 2
  for (int k = 0; k < 8; ++k) s2[k] = s1[k];
  s2[8] = D.rs(D.w(s1[8]) * _c(30) - D.w(s1[15]) * _c(2));
  s2[15] = D.rs(D.w(s1[8]) * _c(2) + D.w(s1[15]) * _c(30));
  s2[9] = D.rs(D.w(s1[9]) * _c(14) - D.w(s1[14]) * _c(18));
  s2[14] = D.rs(D.w(s1[9]) * _c(18) + D.w(s1[14]) * _c(14));
  s2[10] = D.rs(D.w(s1[10]) * _c(22) - D.w(s1[13]) * _c(10));
  s2[13] = D.rs(D.w(s1[10]) * _c(10) + D.w(s1[13]) * _c(22));
  s2[11] = D.rs(D.w(s1[11]) * _c(6) - D.w(s1[12]) * _c(26));
  s2[12] = D.rs(D.w(s1[11]) * _c(26) + D.w(s1[12]) * _c(6));
  for (int k = 16; k < 32; k += 2) {
    s2[k] = D.n(s1[k] + s1[k + 1]);
    s2[k + 1] = D.n(s1[k] - s1[k + 1]);
  }
  s2[18] = D.n(-s1[18] + s1[19]);
  s2[19] = D.n(s1[18] + s1[19]);
  s2[22] = D.n(-s1[22] + s1[23]);
  s2[23] = D.n(s1[22] + s1[23]);
  s2[26] = D.n(-s1[26] + s1[27]);
  s2[27] = D.n(s1[26] + s1[27]);
  s2[30] = D.n(-s1[30] + s1[31]);
  s2[31] = D.n(s1[30] + s1[31]);
  // stage 3
  for (int k = 0; k < 4; ++k) t[k] = s2[k];
  t[4] = D.rs(D.w(s2[4]) * _c(28) - D.w(s2[7]) * _c(4));
  t[7] = D.rs(D.w(s2[4]) * _c(4) + D.w(s2[7]) * _c(28));
  t[5] = D.rs(D.w(s2[5]) * _c(12) - D.w(s2[6]) * _c(20));
  t[6] = D.rs(D.w(s2[5]) * _c(20) + D.w(s2[6]) * _c(12));
  t[8] = D.n(s2[8] + s2[9]);
  t[9] = D.n(s2[8] - s2[9]);
  t[10] = D.n(-s2[10] + s2[11]);
  t[11] = D.n(s2[10] + s2[11]);
  t[12] = D.n(s2[12] + s2[13]);
  t[13] = D.n(s2[12] - s2[13]);
  t[14] = D.n(-s2[14] + s2[15]);
  t[15] = D.n(s2[14] + s2[15]);
  t[16] = s2[16];
  t[31] = s2[31];
  t[17] = D.rs(-D.w(s2[17]) * _c(4) + D.w(s2[30]) * _c(28));
  t[30] = D.rs(D.w(s2[17]) * _c(28) + D.w(s2[30]) * _c(4));
  t[18] = D.rs(-D.w(s2[18]) * _c(28) - D.w(s2[29]) * _c(4));
  t[29] = D.rs(-D.w(s2[18]) * _c(4) + D.w(s2[29]) * _c(28));
  t[19] = s2[19];
  t[20] = s2[20];
  t[21] = D.rs(-D.w(s2[21]) * _c(20) + D.w(s2[26]) * _c(12));
  t[26] = D.rs(D.w(s2[21]) * _c(12) + D.w(s2[26]) * _c(20));
  t[22] = D.rs(-D.w(s2[22]) * _c(12) - D.w(s2[25]) * _c(20));
  t[25] = D.rs(-D.w(s2[22]) * _c(20) + D.w(s2[25]) * _c(12));
  t[23] = s2[23];
  t[24] = s2[24];
  t[27] = s2[27];
  t[28] = s2[28];
  // stage 4
  u[0] = D.rs((D.w(t[0]) + D.w(t[1])) * _c(16));
  u[1] = D.rs((D.w(t[0]) - D.w(t[1])) * _c(16));
  u[2] = D.rs(D.w(t[2]) * _c(24) - D.w(t[3]) * _c(8));
  u[3] = D.rs(D.w(t[2]) * _c(8) + D.w(t[3]) * _c(24));
  u[4] = D.n(t[4] + t[5]);
  u[5] = D.n(t[4] - t[5]);
  u[6] = D.n(-t[6] + t[7]);
  u[7] = D.n(t[6] + t[7]);
  u[8] = t[8];
  u[15] = t[15];
  u[9] = D.rs(-D.w(t[9]) * _c(8) + D.w(t[14]) * _c(24));
  u[14] = D.rs(D.w(t[9]) * _c(24) + D.w(t[14]) * _c(8));
  u[10] = D.rs(-D.w(t[10]) * _c(24) - D.w(t[13]) * _c(8));
  u[13] = D.rs(-D.w(t[10]) * _c(8) + D.w(t[13]) * _c(24));
  u[11] = t[11];
  u[12] = t[12];
  u[16] = D.n(t[16] + t[19]);
  u[17] = D.n(t[17] + t[18]);
  u[18] = D.n(t[17] - t[18]);
  u[19] = D.n(t[16] - t[19]);
  u[20] = D.n(-t[20] + t[23]);
  u[21] = D.n(-t[21] + t[22]);
  u[22] = D.n(t[21] + t[22]);
  u[23] = D.n(t[20] + t[23]);
  u[24] = D.n(t[24] + t[27]);
  u[25] = D.n(t[25] + t[26]);
  u[26] = D.n(t[25] - t[26]);
  u[27] = D.n(t[24] - t[27]);
  u[28] = D.n(-t[28] + t[31]);
  u[29] = D.n(-t[29] + t[30]);
  u[30] = D.n(t[29] + t[30]);
  u[31] = D.n(t[28] + t[31]);
  // stage 5
  v[0] = D.n(u[0] + u[3]);
  v[1] = D.n(u[1] + u[2]);
  v[2] = D.n(u[1] - u[2]);
  v[3] = D.n(u[0] - u[3]);
  v[4] = u[4];
  v[5] = D.rs((D.w(u[6]) - D.w(u[5])) * _c(16));
  v[6] = D.rs((D.w(u[5]) + D.w(u[6])) * _c(16));
  v[7] = u[7];
  v[8] = D.n(u[8] + u[11]);
  v[9] = D.n(u[9] + u[10]);
  v[10] = D.n(u[9] - u[10]);
  v[11] = D.n(u[8] - u[11]);
  v[12] = D.n(-u[12] + u[15]);
  v[13] = D.n(-u[13] + u[14]);
  v[14] = D.n(u[13] + u[14]);
  v[15] = D.n(u[12] + u[15]);
  v[16] = u[16];
  v[17] = u[17];
  v[18] = D.rs(-D.w(u[18]) * _c(8) + D.w(u[29]) * _c(24));
  v[29] = D.rs(D.w(u[18]) * _c(24) + D.w(u[29]) * _c(8));
  v[19] = D.rs(-D.w(u[19]) * _c(8) + D.w(u[28]) * _c(24));
  v[28] = D.rs(D.w(u[19]) * _c(24) + D.w(u[28]) * _c(8));
  v[20] = D.rs(-D.w(u[20]) * _c(24) - D.w(u[27]) * _c(8));
  v[27] = D.rs(-D.w(u[20]) * _c(8) + D.w(u[27]) * _c(24));
  v[21] = D.rs(-D.w(u[21]) * _c(24) - D.w(u[26]) * _c(8));
  v[26] = D.rs(-D.w(u[21]) * _c(8) + D.w(u[26]) * _c(24));
  v[22] = u[22];
  v[23] = u[23];
  v[24] = u[24];
  v[25] = u[25];
  v[30] = u[30];
  v[31] = u[31];
  // stage 6
  w[0] = D.n(v[0] + v[7]);
  w[1] = D.n(v[1] + v[6]);
  w[2] = D.n(v[2] + v[5]);
  w[3] = D.n(v[3] + v[4]);
  w[4] = D.n(v[3] - v[4]);
  w[5] = D.n(v[2] - v[5]);
  w[6] = D.n(v[1] - v[6]);
  w[7] = D.n(v[0] - v[7]);
  w[8] = v[8];
  w[9] = v[9];
  w[10] = D.rs((-D.w(v[10]) + D.w(v[13])) * _c(16));
  w[13] = D.rs((D.w(v[10]) + D.w(v[13])) * _c(16));
  w[11] = D.rs((-D.w(v[11]) + D.w(v[12])) * _c(16));
  w[12] = D.rs((D.w(v[11]) + D.w(v[12])) * _c(16));
  w[14] = v[14];
  w[15] = v[15];
  w[16] = D.n(v[16] + v[23]);
  w[17] = D.n(v[17] + v[22]);
  w[18] = D.n(v[18] + v[21]);
  w[19] = D.n(v[19] + v[20]);
  w[20] = D.n(v[19] - v[20]);
  w[21] = D.n(v[18] - v[21]);
  w[22] = D.n(v[17] - v[22]);
  w[23] = D.n(v[16] - v[23]);
  w[24] = D.n(-v[24] + v[31]);
  w[25] = D.n(-v[25] + v[30]);
  w[26] = D.n(-v[26] + v[29]);
  w[27] = D.n(-v[27] + v[28]);
  w[28] = D.n(v[27] + v[28]);
  w[29] = D.n(v[26] + v[29]);
  w[30] = D.n(v[25] + v[30]);
  w[31] = D.n(v[24] + v[31]);
  // stage 7
  for (int k = 0; k < 8; ++k) p[k] = D.n(w[k] + w[15 - k]);
  for (int k = 8; k < 16; ++k) p[k] = D.n(w[15 - k] - w[k]);
  p[16] = w[16];
  p[17] = w[17];
  p[18] = w[18];
  p[19] = w[19];
  p[20] = D.rs((-D.w(w[20]) + D.w(w[27])) * _c(16));
  p[27] = D.rs((D.w(w[20]) + D.w(w[27])) * _c(16));
  p[21] = D.rs((-D.w(w[21]) + D.w(w[26])) * _c(16));
  p[26] = D.rs((D.w(w[21]) + D.w(w[26])) * _c(16));
  p[22] = D.rs((-D.w(w[22]) + D.w(w[25])) * _c(16));
  p[25] = D.rs((D.w(w[22]) + D.w(w[25])) * _c(16));
  p[23] = D.rs((-D.w(w[23]) + D.w(w[24])) * _c(16));
  p[24] = D.rs((D.w(w[23]) + D.w(w[24])) * _c(16));
  p[28] = w[28];
  p[29] = w[29];
  p[30] = w[30];
  p[31] = w[31];
  // final stage
  for (int k = 0; k < 16; ++k) out[k] = D.n(p[k] + p[31 - k]);
  for (int k = 16; k < 32; ++k) out[k] = D.n(p[31 - k] - p[k]);
}

// vpx_iwht4x4_16_add_c's 1-D pass, each output wrapped to the domain.
__device__ __forceinline__ void iwht4(const I* v, I* out, const Dom& D) {
  I a1 = v[0], c1 = v[1], d1 = v[2], b1 = v[3];
  a1 = a1 + c1;
  d1 = d1 - b1;
  const I e1 = I((a1 - d1).s() >> 1);
  b1 = e1 - b1;
  c1 = e1 - c1;
  a1 = a1 - b1;
  d1 = d1 + c1;
  out[0] = D.n(a1);
  out[1] = D.n(b1);
  out[2] = D.n(c1);
  out[3] = D.n(d1);
}

// The 1-D pass of size 4 << TX, ADST when adst (never for TX 3); kind 1
// is the WHT.
template <int TX>
__device__ __forceinline__ void pass1d(const I* in, I* out, bool adst,
                                       int kind, const Dom& D) {
  if constexpr (TX == 0) {
    if (kind == 1)
      iwht4(in, out, D);
    else if (adst)
      iadst4(in, out, D);
    else
      idct4(in, out, D);
  } else if constexpr (TX == 1) {
    if (adst)
      iadst8(in, out, D);
    else
      idct8(in, out, D);
  } else if constexpr (TX == 2) {
    if (adst)
      iadst16(in, out, D);
    else
      idct16(in, out, D);
  } else {
    idct32(in, out, D);
  }
}

// One bucket of the table: kind 0 a coefficient row [ncoef] per unit
// (raster order when ncoef == n^2, else the first ncoef in scan order); 1
// the same, 4x4 WHT (lossless); 2 (raster index, value) pairs [ncoef /
// 2], 32x32.  coef, coefh and pos point at stream 0's [n_units, ncoef],
// [n_units, ncoef] (null at bd 8) and [n_units, 4] int16; stream k's lie
// k * coef_stride (coef and coefh) and k * pos_stride elements further,
// and write planes 3k + cpos[0].  scan: [4, ncoef] int16 raster positions
// (prefix buckets only).  Its blocks are [first_block, first_block +
// ceil(n_units n_streams / (128 / n))).
struct Bucket {
  const int16_t* coef;
  const int16_t* coefh;
  const int16_t* pos;
  const int16_t* scan;
  long long coef_stride, pos_stride;
  int n_units, n_streams, tx, kind, ncoef, first_block;
};

constexpr int kMaxBuckets = 16;

// The frame's buckets, a kernel parameter (__grid_constant__: read in
// place from the parameter bank, never copied to local memory).  R is
// [P, ha, wa] int32.
struct Table {
  Bucket b[kMaxBuckets];
  int n, P, ha, wa, bd;
};

// Shared memory: a block's units, each n rows of n + 1 words; the most
// is 4 units of 32 x 33.
constexpr int kSmemWords = 4 * 32 * 33;

// The units of bucket `bk` that fall to this block, n threads a unit:
// expand into shared memory, row pass, column pass, write.
template <int TX>
__device__ __forceinline__ void bucket_units(int32_t* __restrict__ R,
                                             const Bucket& bk,
                                             const Table& tab,
                                             int32_t* smem) {
  constexpr int n = 4 << TX;
  constexpr int n2 = n * n;
  constexpr int S = n + 1;  // row stride: rows land on distinct banks
  constexpr int per_block = kThreads / n;
  constexpr int shift = TX == 0 ? 4 : (TX == 1 ? 5 : 6);
  const int slot = threadIdx.x / n;
  const int t = threadIdx.x % n;
  const long long j =
      static_cast<long long>(blockIdx.x - bk.first_block) * per_block + slot;
  const bool live = j < static_cast<long long>(bk.n_units) * bk.n_streams;
  int32_t* b = smem + slot * n * S;
  const long long k = live ? j / bk.n_units : 0;
  const long long unit = live ? j % bk.n_units : 0;
  const int ncoef = bk.ncoef;
  const int kind = bk.kind;
  const int16_t* c = bk.coef + k * bk.coef_stride + unit * ncoef;
  const int16_t* ch =
      bk.coefh ? bk.coefh + k * bk.coef_stride + unit * ncoef : nullptr;
  const int16_t* ps = bk.pos + k * bk.pos_stride + unit * 4;
  const int tt = live ? ps[3] & 3 : 0;

  // expand: zero the block, then place the coefficients (raster index q
  // at row q / n, column q % n)
  for (int q = t; q < n * S; q += n) b[q] = 0;
  __syncthreads();
  if (live) {
    if (kind == 2) {
      for (int q = t; q < ncoef / 2; q += n) {
        int idx = c[2 * q];
        const int val = c[2 * q + 1];
        idx = (idx == 0 && val == 0) ? n2 : min(max(idx, 0), n2);
        if (idx < n2) b[(idx / n) * S + idx % n] = val;
      }
    } else {
      for (int q = t; q < ncoef; q += n) {
        // v = (hi << 15) + lo, the shift done unsigned (hi may be < 0)
        const int v =
            ch ? static_cast<int>(static_cast<uint32_t>(ch[q]) << 15) + c[q]
               : c[q];
        const int idx = ncoef < n2 ? bk.scan[tt * ncoef + q] : q;
        b[(idx / n) * S + idx % n] = v;
      }
    }
  }
  __syncthreads();

  const int sh = tab.bd == 8 ? 16 : 24 - tab.bd;
  const Dom D{sh};
  I in[n], out[n];
  // row pass: row t; ADST when tx_type is 2 or 3.  The WHT's inputs shift
  // right by 2 first.
#pragma unroll
  for (int q = 0; q < n; ++q)
    in[q] = I(kind == 1 ? b[t * S + q] >> 2 : b[t * S + q]);
  pass1d<TX>(in, out, (tt & 2) != 0, kind, D);
#pragma unroll
  for (int q = 0; q < n; ++q) b[t * S + q] = out[q].s();
  __syncthreads();
  // column pass: column t; ADST when tx_type is 1 or 3
#pragma unroll
  for (int q = 0; q < n; ++q) in[q] = I(b[q * S + t]);
  pass1d<TX>(in, out, (tt & 1) != 0, kind, D);
  if (!live || ps[1] == 0) return;
  const int plane = ps[0] + 3 * static_cast<int>(k);
  const int y0 = ps[1] - 1;
  const int x = ps[2] + t;
  if (plane < 0 || plane >= tab.P || x < 0 || x >= tab.wa) return;
  int32_t* Rp = R + static_cast<long long>(plane) * tab.ha * tab.wa;
#pragma unroll
  for (int q = 0; q < n; ++q) {
    const int y = y0 + q;
    if (y < 0 || y >= tab.ha) continue;
    // the WHT has no final round shift
    Rp[static_cast<long long>(y) * tab.wa + x] =
        kind == 1 ? out[q].s()
                  : (out[q].s() + (1 << (shift - 1))) >> shift;
  }
}

// One launch for the frame: block blockIdx.x runs the bucket whose block
// range holds it, at that bucket's transform size.
__global__ void __launch_bounds__(kThreads)
residual_kernel(int32_t* __restrict__ R, const __grid_constant__ Table tab) {
  __shared__ int32_t smem[kSmemWords];
  int i = 0;
  while (i + 1 < tab.n && static_cast<int>(blockIdx.x) >=
                              tab.b[i + 1].first_block)
    ++i;
  const Bucket& bk = tab.b[i];
  switch (bk.tx) {
    case 0:
      bucket_units<0>(R, bk, tab, smem);
      break;
    case 1:
      bucket_units<1>(R, bk, tab, smem);
      break;
    case 2:
      bucket_units<2>(R, bk, tab, smem);
      break;
    default:
      bucket_units<3>(R, bk, tab, smem);
  }
}

}  // namespace

// Words of one bucket descriptor of vp9_residual_frame.
constexpr int kDescWords = 12;

// Inverse-transforms the buckets of a frame (or of a batched round) into
// R [P, ha, wa] int32 on `stream`, as one launch.  desc: n_buckets x 12
// int64 host words per bucket, (coef, coefh, pos, scan, coef_stride,
// pos_stride, n_units, n_streams, tx, kind, ncoef, first_block), the
// fields of Bucket; the block ranges must follow each other from 0, each
// ceil(n_units n_streams / (128 / n)) blocks.  *launched counts the
// launch (0 with no block).  Returns the CUDA error, or 0
// (cudaErrorInvalidValue for a table the kernel does not take).
extern "C" int vp9_residual_frame(void* R, const long long* desc,
                                  int n_buckets, int P, int ha, int wa,
                                  int bd, void* stream, int* launched) {
  *launched = 0;
  if (n_buckets < 0 || n_buckets > kMaxBuckets)
    return static_cast<int>(cudaErrorInvalidValue);
  Table tab{};
  tab.n = n_buckets;
  tab.P = P;
  tab.ha = ha;
  tab.wa = wa;
  tab.bd = bd;
  long long blocks = 0;
  for (int i = 0; i < n_buckets; ++i) {
    const long long* d = desc + i * kDescWords;
    Bucket& b = tab.b[i];
    b.coef = reinterpret_cast<const int16_t*>(d[0]);
    b.coefh = reinterpret_cast<const int16_t*>(d[1]);
    b.pos = reinterpret_cast<const int16_t*>(d[2]);
    b.scan = reinterpret_cast<const int16_t*>(d[3]);
    b.coef_stride = d[4];
    b.pos_stride = d[5];
    b.n_units = static_cast<int>(d[6]);
    b.n_streams = static_cast<int>(d[7]);
    b.tx = static_cast<int>(d[8]);
    b.kind = static_cast<int>(d[9]);
    b.ncoef = static_cast<int>(d[10]);
    b.first_block = static_cast<int>(d[11]);
    const int n = 4 << (b.tx & 3);
    if (b.tx < 0 || b.tx > 3 || b.kind < 0 || b.kind > 2 ||
        (b.kind == 2 && b.tx != 3) || (b.kind == 1 && b.tx != 0) ||
        b.n_units <= 0 || b.n_streams <= 0 || b.first_block != blocks ||
        (b.kind != 2 && b.ncoef < n * n && !b.scan))
      return static_cast<int>(cudaErrorInvalidValue);
    const int per_block = kThreads / n;
    blocks += (static_cast<long long>(b.n_units) * b.n_streams + per_block -
               1) / per_block;
  }
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  if (!blocks) return 0;
  residual_kernel<<<static_cast<int>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(R), tab);
  ++*launched;
  return static_cast<int>(cudaGetLastError());
}
