// VP9 deblocking loop filter for one frame (a luma plane and two 4:2:0
// chroma planes), hand-written for Hopper.
//
// Replaces cuda_vp9_tpu/ops/pallas/loopfilter.py `lf_frame` (with
// `_make_kernel`, `_run_chains` and `_edge_chain`): the same int32 filter
// math (vpx_dsp/loopfilter.c filter4/8/16 and the interior +4 edge, and
// their highbd forms: thresholds, flat tests and clamps scale by bd - 8
// for bd 10 and 12), the same packed metadata (lfm [n_sbs_pad, 2, 128]
// int16, bits | level << 4 per cell; thr [64, 4] int16 level -> (-,
// mblim, lim, hev)), applied in the normative superblock order.  The
// frame step also calls it on a 4:4:4 chroma plane, as plane 0 of a
// canvas on the chroma cell grid with zero chroma fields, and on the luma
// of a 4:2:2 frame (zero chroma fields), as the JAX step does.
//
// Order.  SB (r, c) needs (r, c-1) and (r-1, c+1) finished, so the host
// loop launches one grid per anti-diagonal s = c + 2r with one block per
// SB of that wave; SBs on one wave touch disjoint pixels.  Inside an SB
// all vertical chains run left to right, then all horizontal chains top
// to bottom.  In the vertical pass every pixel row is independent, in the
// horizontal pass every pixel column, so a block has 128 threads: 64 take
// the luma rows (columns), 2 x 32 the U and V rows (columns), and each
// thread walks its 8 (luma) or 4 (chroma) chains in order, with one
// __syncthreads() between the passes.
//
// What bounds it on this card: the serial wave depth (sb_cols + 2 sb_rows
// - 2 launches per frame, 62 at 1920x1088) and the launch count, not
// bytes: a 1080p frame is 12 MB of int32 pixels, read and written a few
// times in L2-resident windows.  Measured at 1920x1088: 1.80 ms a frame
// (NVIDIA H100 80GB HBM3, 700 W power limit), against 5.6 s for the plain
// torch version.  Later work: one persistent kernel with per-row progress
// flags, tiles in shared memory, CUDA graphs.
//
// Frame layout: F is int32 [3, ha, wa] contiguous, ha and wa multiples of
// 64; U and V occupy the top-left [ha/2, wa/2] of their planes.  A window
// pixel outside its plane reads as 0 and is never written (the Pallas
// kernel's 8-pixel zero apron); a cell whose bits are 0 reads nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ bool over(int a, int b, int t) {
  return abs(a - b) > t;
}

// filter4 on offset-removed samples; writes the four outputs (offset
// added back) where m holds.
__device__ __forceinline__ void filter4(int* o, int p1, int p0, int q0,
                                        int q1, bool m, bool h, int off) {
  if (!m) return;
  const int lo = -off, hi = off - 1;
  const int ps1 = p1 - off, ps0 = p0 - off, qs0 = q0 - off, qs1 = q1 - off;
  int f = h ? clampi(ps1 - qs1, lo, hi) : 0;
  f = clampi(f + 3 * (qs0 - ps0), lo, hi);
  const int f1 = clampi(f + 4, lo, hi) >> 3;
  const int f2 = clampi(f + 3, lo, hi) >> 3;
  const int fo = h ? 0 : ((f1 + 1) >> 1);
  o[0] = clampi(ps1 + fo, lo, hi) + off;
  o[1] = clampi(ps0 + f2, lo, hi) + off;
  o[2] = clampi(qs0 - f1, lo, hi) + off;
  o[3] = clampi(qs1 - fo, lo, hi) + off;
}

// One edge chain on a 16-sample window w[0..15] (edge between 7 | 8):
// the main edge (filter4/8/16 by bits 1/2/4) and the interior 4x4 edge
// at +4 (bit 8) on the main edge's output.  Thresholds are bd-scaled.
__device__ void edge_chain(int* w, int bits, int mb, int lm, int hv,
                           int bd) {
  const int ft = 1 << (bd - 8);
  const int off = 0x80 << (bd - 8);
  int o[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) o[k] = w[k];
  if (bits & 7) {
    const int p3 = w[4], p2 = w[5], p1 = w[6], p0 = w[7];
    const int q0 = w[8], q1 = w[9], q2 = w[10], q3 = w[11];
    const bool mask =
        !(over(p3, p2, lm) || over(p2, p1, lm) || over(p1, p0, lm) ||
          over(q1, q0, lm) || over(q2, q1, lm) || over(q3, q2, lm) ||
          abs(p0 - q0) * 2 + (abs(p1 - q1) >> 1) > mb);
    if (mask) {
      const bool hev = over(p1, p0, hv) || over(q1, q0, hv);
      const bool flat = !(over(p1, p0, ft) || over(q1, q0, ft) ||
                          over(p2, p0, ft) || over(q2, q0, ft) ||
                          over(p3, p0, ft) || over(q3, q0, ft));
      filter4(o + 6, p1, p0, q0, q1, true, hev, off);
      if (flat && (bits & 3)) {
        o[5] = (p3 + p3 + p3 + 2 * p2 + p1 + p0 + q0 + 4) >> 3;
        o[6] = (p3 + p3 + p2 + 2 * p1 + p0 + q0 + q1 + 4) >> 3;
        o[7] = (p3 + p2 + p1 + 2 * p0 + q0 + q1 + q2 + 4) >> 3;
        o[8] = (p2 + p1 + p0 + 2 * q0 + q1 + q2 + q3 + 4) >> 3;
        o[9] = (p1 + p0 + q0 + 2 * q1 + q2 + q3 + q3 + 4) >> 3;
        o[10] = (p0 + q0 + q1 + 2 * q2 + q3 + q3 + q3 + 4) >> 3;
      }
      if (flat && (bits & 1)) {
        bool flat2 = true;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          flat2 = flat2 && !over(w[k], p0, ft) && !over(w[15 - k], q0, ft);
        if (flat2) {
          // 15-tap: p[k] = w[7-k], q[k] = w[8+k] (original samples)
          int P = 0, Q = 0;
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            P += w[7 - k];
            Q += w[8 + k];
          }
#pragma unroll
          for (int i = 0; i < 7; ++i) {
            int qpre = 0, ppre = 0;
            for (int k = 0; k < 7 - i; ++k) {
              qpre += w[8 + k];
              ppre += w[7 - k];
            }
            o[7 - i] = (w[0] * i + w[7 - i] + P + qpre + 8) >> 4;
            o[8 + i] = (w[15] * i + w[8 + i] + Q + ppre + 8) >> 4;
          }
        }
      }
    }
  }
  if (bits & 8) {
    const int i3 = o[8], i2 = o[9], i1 = o[10], i0 = o[11];
    const int j0 = o[12], j1 = o[13], j2 = o[14], j3 = o[15];
    const bool m2 =
        !(over(i3, i2, lm) || over(i2, i1, lm) || over(i1, i0, lm) ||
          over(j1, j0, lm) || over(j2, j1, lm) || over(j3, j2, lm) ||
          abs(i0 - j0) * 2 + (abs(i1 - j1) >> 1) > mb);
    const bool h2 = over(i1, i0, hv) || over(j1, j0, hv);
    filter4(o + 10, i1, i0, j0, j1, m2, h2, off);
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) w[k] = o[k];
}

// One block per SB of wave s; see the header for the thread layout.
__global__ void __launch_bounds__(128)
lf_wave_kernel(int32_t* __restrict__ F, const int16_t* __restrict__ lfm,
               const int16_t* __restrict__ thr, int ha, int wa, int sb_cols,
               int s, int r_lo, int bd) {
  const int r = r_lo + blockIdx.x;
  const int c = s - 2 * r;
  const int t = threadIdx.x;
  const bool luma = t < 64;
  const int plane = luma ? 0 : 1 + ((t - 64) >> 5);
  const int lane = luma ? t : ((t - 64) & 31);
  const int nch = luma ? 8 : 4;
  const int sz = luma ? 64 : 32;
  const int ph = luma ? ha : ha / 2;
  const int pw = luma ? wa : wa / 2;
  const int lbase = luma ? 0 : 64;
  int32_t* P = F + (size_t)plane * ha * wa;
  const int16_t* L = lfm + (size_t)(r * sb_cols + c) * 256;
  const int sh = bd - 8;
  int w[16];

  // vertical chains: this thread's pixel row, chains left to right
  {
    const int y = r * sz + lane;
    int32_t* row = P + (size_t)y * wa;
    for (int i = 0; i < nch; ++i) {
      const int v = L[lbase + i * 8 + (lane >> 3)];
      const int bits = v & 15;
      if (!bits) continue;
      const int lvl = v >> 4;
      const int x0 = c * sz + i * 8 - 8;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int x = x0 + k;
        w[k] = (x >= 0 && x < pw) ? row[x] : 0;
      }
      edge_chain(w, bits, thr[lvl * 4 + 1] << sh, thr[lvl * 4 + 2] << sh,
                 thr[lvl * 4 + 3] << sh, bd);
#pragma unroll
      for (int k = 1; k < 15; ++k) {
        const int x = x0 + k;
        if (x >= 0 && x < pw) row[x] = w[k];
      }
    }
  }
  __syncthreads();
  // horizontal chains: this thread's pixel column, chains top to bottom
  {
    const int x = c * sz + lane;
    for (int j = 0; j < nch; ++j) {
      const int v = L[128 + lbase + j * 8 + (lane >> 3)];
      const int bits = v & 15;
      if (!bits) continue;
      const int lvl = v >> 4;
      const int y0 = r * sz + j * 8 - 8;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int y = y0 + k;
        w[k] = (y >= 0 && y < ph) ? P[(size_t)y * wa + x] : 0;
      }
      edge_chain(w, bits, thr[lvl * 4 + 1] << sh, thr[lvl * 4 + 2] << sh,
                 thr[lvl * 4 + 3] << sh, bd);
#pragma unroll
      for (int k = 1; k < 15; ++k) {
        const int y = y0 + k;
        if (y >= 0 && y < ph) P[(size_t)y * wa + x] = w[k];
      }
    }
  }
}

}  // namespace

// Filters F in place: one launch per SB anti-diagonal on `stream`.  Sets
// *launched to the number of kernel launches made.  Returns the first
// CUDA error (cudaGetLastError), 0 on success.
extern "C" int vp9_lf_frame(void* F, const void* lfm, const void* thr,
                            int ha, int wa, int bd, void* stream,
                            int* launched) {
  *launched = 0;
  const int sb_rows = ha / 64, sb_cols = wa / 64;
  const int n_waves = sb_cols + 2 * (sb_rows - 1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int s = 0; s < n_waves; ++s) {
    const int lo = s - sb_cols + 2;   // c = s - 2r <= sb_cols - 1
    const int r_lo = lo > 0 ? lo / 2 : 0;
    const int r_hi = s / 2 < sb_rows - 1 ? s / 2 : sb_rows - 1;
    if (r_hi < r_lo) continue;
    lf_wave_kernel<<<r_hi - r_lo + 1, 128, 0, st>>>(
        static_cast<int32_t*>(F), static_cast<const int16_t*>(lfm),
        static_cast<const int16_t*>(thr), ha, wa, sb_cols, s, r_lo, bd);
    ++*launched;
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
