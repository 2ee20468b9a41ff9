// VP9 motion compensation (K3 and K6), hand-written for Hopper:
// `vp9_mc_pass`.
//
// Replaces the XLA stages of cuda_vp9_tpu/runtime/fused.py `_mc_pass`
// (:163) -> `_mc_chunk_compute` (:69), the unscaled tile classes mc4,
// mc8, mc16 and mc32 with the compound average, and `_mcs_pass` (:388)
// -> `_mcs_chunk_compute` (:311), the scaled-reference 4x4 class, in the
// single-frame step and in the batched step (its vmap written out as a
// stream axis).  The plain twins are cuda_vp9_torch/ops/cuda/mc.py
// `mc_predict`, `mcs_predict` and `_land`.
//
// Unscaled tile (records int16 [cap, ch, 4] = (dx | filt << 13, dy + 1,
// sr, sc), sr / sc = ((src - dst) << 4) | subpel, signed): the w + 7
// square window of rows clip(y0 - 3 + i, 0, chh - 1) and columns
// clip(x0 - 3 + j, 0, cw - 1) of pool[slot, plane] is staged in shared
// memory; the 8-tap horizontal pass over its w + 7 rows goes to a second
// shared tile, rounded ((acc + 64) >> 7) and clipped to [0, 2^bd - 1];
// the vertical pass reads that tile, rounds and clips the same way, and
// lands the pixel.  The chunk header (slot, plane, srow, cw, chh, ...) is
// the block's; srow exists for the TPU's row bands and is not read.
//
// Scaled tile (records int16 [cap, 128, 16]; fields 0-2 plane, dx,
// dy + 1; 4-5 the source origin x0, y0; 6-7 the base phases spx, spy; 8
// filt; 9-10 cw, chh; 12-13 the q4 steps xs, ys <= 32): column c reads
// source column x0 + ((spx + c xs) >> 4) - 3 + k with phase
// (spx + c xs) & 15 straight from the pool into 14 intermediate rows
// clip(y0 - 3 + i, 0, chh - 1); output row r filters intermediate rows
// ((spy + r ys) >> 4) + k, clamped to 0..13, with phase (spy + r ys) & 15.
//
// Landing.  Chunks [0, n_ref0) write their tiles, chunks [n_ref0,
// n_chunks) average into what is there: (F + p + 1) >> 1.  A second
// prediction reads the pixel a first one wrote, so each class runs as two
// grids on the caller's stream, the firsts then the seconds; within a
// grid destinations are distinct (the packer's rule), so the blocks need
// no order.  The scaled class runs after every unscaled one, so a
// compound average with a scaled first reference sees its first
// prediction.  A padded record (dy + 1 == 0) writes nothing, and no
// pixel outside [0, ha) x [0, wa) of its plane is written (JAX drops
// those writes, mode="drop").
//
// Streams.  Block (g, c, k) of a grid is tile group g of chunk c of
// stream k.  Stream k's records, headers and n_ref0 (a device int16) lie
// rec_stride, hdr_stride and r0_stride elements after stream 0's; its
// pool slots are 8 act[k] + slot (act null: slot) and its frame planes
// 3k + plane.  Each stream's own n_ref0 decides which of its chunks a
// grid of each phase runs; the host bounds only size the grids.  A
// stream with fewer chunks than the grid runs the wire's zero padding,
// which writes nothing.  One frame is the case of one stream.
//
// What bounds it.  A tile reads its (w + 7)^2 window once and writes w^2
// pixels: at 8 taps a pixel a pass, about 16 int32 multiply-adds per
// output pixel.  An nc03 frame is a few MB of traffic and about ten
// million multiply-adds, microseconds of the card; the launch of up to 10
// grids from one host call per frame bounds it.  The design keeps each
// block's work fixed (256 threads, a fixed number of tiles, whatever the
// chunk length; chunks grow 4 times at HD and above), stages the filter
// table (2 KB) in shared memory, and reads the int16 wire directly.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPasses = 4;       // tile groups a block walks in turn
constexpr int kTaps = 4 * 16 * 8;
constexpr int kDescWords = 12;   // int64 words of one class descriptor

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// The frame and the pool, shared by every class.
struct Frame {
  int32_t* F;            // [P, ha, wa]
  int P, ha, wa;
  const int32_t* pool;   // [S, 3, pha, pwa]
  int S, pha, pwa;
  const int16_t* act;    // stream k's pool is slots 8 act[k] .. (null: 0..)
  int maxv;
};

// One class's wire: stream 0's records [cap, ch, rw], chunk headers
// [cap, hw] and n_ref0; stream k's lie k * stride elements further.
struct Wire {
  const int16_t* rec;
  const int16_t* hdr;
  const int16_t* r0;
  long long rec_stride, hdr_stride, r0_stride;
  int ch, rw, hw;
};

// One unscaled tile's parameters, staged by one thread of its block.
struct Tile {
  int ok;                // not padding
  int x0, y0;            // the source's integer origin
  int fx, fy;            // offsets of the horizontal / vertical taps
  int dx, dy;            // the destination
};

// One scaled tile's parameters.
struct STile {
  int ok, x0, y0, spx, spy, fbase, cw, chh, xs, ys, plane, dx, dy;
};

// The chunk a block serves, and whether it belongs to this grid's phase.
struct Chunk {
  int k, c;
  bool run;
};

__device__ __forceinline__ Chunk block_chunk(const Wire& a, int c_lo,
                                             int second) {
  Chunk ch;
  ch.k = blockIdx.z;
  ch.c = c_lo + blockIdx.y;
  ch.run = (ch.c >= a.r0[ch.k * a.r0_stride]) == (second != 0);
  return ch;
}

__device__ __forceinline__ void stage_taps(int32_t* taps,
                                           const int32_t* __restrict__ kern) {
  for (int i = threadIdx.x; i < kTaps; i += kThreads) taps[i] = kern[i];
}

// Lands pixel p at (row, col) of plane `plane` of frame stream k: a
// write, or (second) the compound average with what is there.
__device__ __forceinline__ void land(const Frame& fr, int k, int plane,
                                     int row, int col, int p, int second) {
  const int pf = 3 * k + plane;
  if (plane < 0 || plane > 2 || pf >= fr.P || row < 0 || row >= fr.ha ||
      col < 0 || col >= fr.wa)
    return;
  int32_t* d = fr.F + (static_cast<long long>(pf) * fr.ha + row) * fr.wa +
               col;
  *d = second ? (*d + p + 1) >> 1 : p;
}

template <int W>
struct Geom {
  static constexpr int kN = W + 7;                              // window
  static constexpr int kTP = W <= 16 ? kThreads / (W * W) : 1;  // a pass
  static constexpr int kTiles = kTP * kPasses;                  // a block
};

// One grid of an unscaled class: block (g, c, k) predicts and lands
// tiles [g kTiles, (g + 1) kTiles) of chunk c_lo + c of stream k, if the
// chunk is of this grid's phase (second: compound averages).
template <int W>
__global__ void __launch_bounds__(kThreads)
mc_kernel(Frame fr, Wire a, const int32_t* __restrict__ kern, int c_lo,
          int second) {
  using G = Geom<W>;
  constexpr int kN = G::kN;
  constexpr int kTP = G::kTP;
  __shared__ int32_t taps[kTaps];
  __shared__ int32_t win[kTP][kN][kN];
  __shared__ int32_t tmp[kTP][kN][W];
  __shared__ Tile tiles[kTP];
  const Chunk ck = block_chunk(a, c_lo, second);
  if (!ck.run) return;
  stage_taps(taps, kern);
  const int16_t* hd = a.hdr + ck.k * a.hdr_stride +
                      static_cast<long long>(ck.c) * a.hw;
  const int slot = clampi(hd[0] + (fr.act ? 8 * fr.act[ck.k] : 0), 0,
                          fr.S - 1);
  const int plane = clampi(hd[1], 0, 2);
  const int cw = clampi(hd[3], 1, fr.pwa);
  const int chh = clampi(hd[4], 1, fr.pha);
  const int32_t* src =
      fr.pool + static_cast<long long>(slot * 3 + plane) * fr.pha * fr.pwa;
  const int16_t* rec = a.rec + ck.k * a.rec_stride +
                       static_cast<long long>(ck.c) * a.ch * a.rw;
  int t0 = blockIdx.x * G::kTiles;
  for (int pass = 0; pass < kPasses && t0 < a.ch; ++pass, t0 += kTP) {
    __syncthreads();   // the taps are staged; the last pass has finished
    if (threadIdx.x < kTP) {
      Tile& t = tiles[threadIdx.x];
      const int j = t0 + threadIdx.x;
      t.ok = 0;
      if (j < a.ch) {
        const int16_t* u = rec + static_cast<long long>(j) * a.rw;
        const int w0 = u[0], w1 = u[1], sr = u[2], sc = u[3];
        if (w1 != 0) {
          const int filt = (w0 >> 13) & 3;
          t.ok = 1;
          t.dx = w0 & 0x1FFF;
          t.dy = w1 - 1;
          t.x0 = t.dx + (sc >> 4);   // arithmetic shifts of signed fields
          t.y0 = t.dy + (sr >> 4);
          t.fx = (filt * 16 + (sc & 15)) * 8;
          t.fy = (filt * 16 + (sr & 15)) * 8;
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kTP * kN * kN; i += kThreads) {
      const int q = i / (kN * kN);
      const int y = (i / kN) % kN;
      const int x = i % kN;
      const Tile& t = tiles[q];
      if (!t.ok) continue;
      const int row = clampi(t.y0 - 3 + y, 0, chh - 1);
      const int col = clampi(t.x0 - 3 + x, 0, cw - 1);
      win[q][y][x] = src[static_cast<long long>(row) * fr.pwa + col];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kTP * kN * W; i += kThreads) {
      const int q = i / (kN * W);
      const int y = (i / W) % kN;
      const int c = i % W;
      const Tile& t = tiles[q];
      if (!t.ok) continue;
      const int32_t* f = taps + t.fx;
      int acc = 0;
#pragma unroll
      for (int m = 0; m < 8; ++m) acc += f[m] * win[q][y][c + m];
      tmp[q][y][c] = clampi((acc + 64) >> 7, 0, fr.maxv);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kTP * W * W; i += kThreads) {
      const int q = i / (W * W);
      const int r = (i / W) % W;
      const int c = i % W;
      const Tile& t = tiles[q];
      if (!t.ok) continue;
      const int32_t* f = taps + t.fy;
      int acc = 0;
#pragma unroll
      for (int m = 0; m < 8; ++m) acc += f[m] * tmp[q][r + m][c];
      land(fr, ck.k, plane, t.dy + r, t.dx + c,
           clampi((acc + 64) >> 7, 0, fr.maxv), second);
    }
  }
}

constexpr int kSTP = 16;                 // scaled tiles a pass
constexpr int kSTiles = kSTP * kPasses;  // scaled tiles a block
constexpr int kSRows = 14;               // intermediate rows of a tile

// One grid of the scaled class, laid out as mc_kernel's, for one stream.
__global__ void __launch_bounds__(kThreads)
mcs_kernel(Frame fr, Wire a, const int32_t* __restrict__ kern, int c_lo,
           int second) {
  __shared__ int32_t taps[kTaps];
  __shared__ int32_t tmp[kSTP][kSRows][4];
  __shared__ STile tiles[kSTP];
  const Chunk ck = block_chunk(a, c_lo, second);
  if (!ck.run) return;
  stage_taps(taps, kern);
  const int16_t* hd = a.hdr + ck.k * a.hdr_stride +
                      static_cast<long long>(ck.c) * a.hw;
  // one stream's pool (the scaled class leaves the batch)
  const int slot = clampi(hd[0], 0, min(fr.S, 8) - 1);
  const int32_t* src = fr.pool + static_cast<long long>(
                                     slot * 3 + clampi(hd[1], 0, 2)) *
                                     fr.pha * fr.pwa;
  const int16_t* rec = a.rec + ck.k * a.rec_stride +
                       static_cast<long long>(ck.c) * a.ch * a.rw;
  int t0 = blockIdx.x * kSTiles;
  for (int pass = 0; pass < kPasses && t0 < a.ch; ++pass, t0 += kSTP) {
    __syncthreads();
    if (threadIdx.x < kSTP) {
      STile& t = tiles[threadIdx.x];
      const int j = t0 + threadIdx.x;
      t.ok = 0;
      if (j < a.ch) {
        const int16_t* u = rec + static_cast<long long>(j) * a.rw;
        if (u[2] != 0) {
          t.ok = 1;
          t.plane = u[0];
          t.dx = u[1];
          t.dy = u[2] - 1;
          t.x0 = u[4];
          t.y0 = u[5];
          t.spx = u[6];
          t.spy = u[7];
          t.fbase = clampi(u[8], 0, 3) * 16 * 8;
          t.cw = clampi(u[9], 1, fr.pwa);
          t.chh = clampi(u[10], 1, fr.pha);
          t.xs = clampi(u[12], 0, 32);
          t.ys = clampi(u[13], 0, 32);
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kSTP * kSRows * 4; i += kThreads) {
      const int q = i / (kSRows * 4);
      const int y = (i / 4) % kSRows;
      const int c = i % 4;
      const STile& t = tiles[q];
      if (!t.ok) continue;
      const int xq4 = t.spx + c * t.xs;
      const int x = t.x0 + (xq4 >> 4) - 3;
      const int32_t* s =
          src + static_cast<long long>(clampi(t.y0 - 3 + y, 0, t.chh - 1)) *
                    fr.pwa;
      const int32_t* f = taps + t.fbase + (xq4 & 15) * 8;
      int acc = 0;
#pragma unroll
      for (int m = 0; m < 8; ++m) acc += f[m] * s[clampi(x + m, 0, t.cw - 1)];
      tmp[q][y][c] = clampi((acc + 64) >> 7, 0, fr.maxv);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kSTP * 16; i += kThreads) {
      const int q = i / 16;
      const int r = (i / 4) % 4;
      const int c = i % 4;
      const STile& t = tiles[q];
      if (!t.ok) continue;
      const int yq4 = t.spy + r * t.ys;
      const int32_t* f = taps + t.fbase + (yq4 & 15) * 8;
      int acc = 0;
#pragma unroll
      for (int m = 0; m < 8; ++m)
        acc += f[m] * tmp[q][clampi((yq4 >> 4) + m, 0, kSRows - 1)][c];
      land(fr, ck.k, t.plane, t.dy + r, t.dx + c,
           clampi((acc + 64) >> 7, 0, fr.maxv), second);
    }
  }
}

// Enqueues the grid of one class and phase over chunks [c_lo, c_hi).
int launch(int kind, const Frame& fr, const Wire& a, const int32_t* kern,
           int n_streams, int c_lo, int c_hi, int second, cudaStream_t st) {
  const int tiles = kind == 0 ? kSTiles
                    : kind == 4  ? Geom<4>::kTiles
                    : kind == 8  ? Geom<8>::kTiles
                    : kind == 16 ? Geom<16>::kTiles
                                 : Geom<32>::kTiles;
  const dim3 grid((a.ch + tiles - 1) / tiles, c_hi - c_lo, n_streams);
  switch (kind) {
    case 0:
      mcs_kernel<<<grid, kThreads, 0, st>>>(fr, a, kern, c_lo, second);
      break;
    case 4:
      mc_kernel<4><<<grid, kThreads, 0, st>>>(fr, a, kern, c_lo, second);
      break;
    case 8:
      mc_kernel<8><<<grid, kThreads, 0, st>>>(fr, a, kern, c_lo, second);
      break;
    case 16:
      mc_kernel<16><<<grid, kThreads, 0, st>>>(fr, a, kern, c_lo, second);
      break;
    default:
      mc_kernel<32><<<grid, kThreads, 0, st>>>(fr, a, kern, c_lo, second);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Runs the MC classes of one frame (n_streams 1) or of one batched round
// on `stream`, in place on F [P, ha, wa] int32, from the pool [S, 3, pha,
// pwa] int32 and the filter table kernels [4, 16, 8] int32.  act: the
// round's active stream indices (int16 [n_streams], on the device), or
// null.  desc: n_desc host descriptors of kDescWords int64 each, in the
// order the classes run:
//
//   0 kind (4, 8, 16, 32; 0 the scaled 4x4 class)   1 records
//   2 chunk headers   3 n_ref0 of stream 0 (device int16)
//   4-6 the stream strides of 1-3 (elements)        7 records a chunk
//   8 n_chunks (the round's most)
//   9 the least n_ref0 of a stream with a compound chunk
//   10 the most first chunks of a stream
//   11 written here: the grids this class enqueued
//
// Each class with chunks enqueues its firsts' grid, over chunks [0,
// min(desc[10], n)), then its seconds' grid, over [min(desc[9], n), n).
// *launched counts the grids.  Returns the first CUDA error, or 0.
extern "C" int vp9_mc_pass(void* F, int P, int ha, int wa, const void* pool,
                           int S, int pha, int pwa, const void* kernels,
                           const void* act, int n_streams, long long* desc,
                           int n_desc, int bd, void* stream, int* launched) {
  *launched = 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Frame fr{static_cast<int32_t*>(F), P, ha, wa,
           static_cast<const int32_t*>(pool), S, pha, pwa,
           static_cast<const int16_t*>(act), (1 << bd) - 1};
  const int32_t* kern = static_cast<const int32_t*>(kernels);
  for (int i = 0; i < n_desc; ++i) {
    long long* d = desc + i * kDescWords;
    d[11] = 0;
    const int kind = static_cast<int>(d[0]);
    const int n = static_cast<int>(d[8]);
    Wire a{reinterpret_cast<const int16_t*>(d[1]),
           reinterpret_cast<const int16_t*>(d[2]),
           reinterpret_cast<const int16_t*>(d[3]),
           d[4], d[5], d[6], static_cast<int>(d[7]),
           kind == 0 ? 16 : 4, kind == 0 ? 4 : 8};
    const int hi0 = static_cast<int>(d[10] < n ? d[10] : n);
    const int lo1 = static_cast<int>(d[9] < n ? d[9] : n);
    if (a.ch <= 0) continue;
    if (hi0 > 0) {
      if (int err = launch(kind, fr, a, kern, n_streams, 0, hi0, 0, st))
        return err;
      ++*launched;
      ++d[11];
    }
    if (lo1 < n) {
      if (int err = launch(kind, fr, a, kern, n_streams, lo1 < 0 ? 0 : lo1,
                           n, 1, st))
        return err;
      ++*launched;
      ++d[11];
    }
  }
  return 0;
}
