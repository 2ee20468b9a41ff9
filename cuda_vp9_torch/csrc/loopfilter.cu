// VP9 deblocking loop filter, hand-written for Hopper: the whole-frame
// filter (K1, `vp9_lf_frames`) and the chroma tile filter of 4:2:2 (K7)
// and 4:4:0 frames (`vp9_lf_plane_tiles`), each one persistent launch per
// call.
//
// K1 replaces cuda_vp9_tpu/ops/pallas/loopfilter.py `lf_frame` (with
// `_make_kernel`, `_run_chains` and `_edge_chain`), both as the frame step
// calls it and as the batched multi-stream step runs it under vmap (a
// leading stream axis, runtime/fused.py get_batched_step): one launch
// filters the frames of every stream that has a filter level, and a
// single frame is its N = 1 case.  It computes the same int32 filter
// math (vpx_dsp/loopfilter.c filter4/8/16 and the interior +4 edge, and
// their highbd forms: thresholds, flat tests and clamps scale by bd - 8
// for bd 10 and 12), the same packed metadata (lfm [n_sbs_pad, 2, 128]
// int16, bits | level << 4 per cell; thr [64, 4] int16 level -> (-,
// mblim, lim, hev)), applied in the normative superblock order, on a luma
// plane and two 4:2:0 chroma planes.  The frame step also calls it on a
// 4:4:4 chroma plane, as plane 0 of a canvas on the chroma cell grid with
// zero chroma fields, and on the luma of a 4:2:2 frame (zero chroma
// fields), as the JAX step does.
//
// K7 replaces the XLA function cuda_vp9_tpu/ops/device/lf_wave.py
// `lf_plane_tiles` (`_tile_pass_v`, `_tile_pass_h`, `_filter_window`): the
// two chroma planes of a 4:2:2 frame in tiles of 64 rows and 32 columns
// (the chroma of one luma superblock), each tile's vertical windows left
// to right, then its horizontal windows top to bottom, with five int16
// per-cell maps (edge bits as in lfm, mblim, lim, hev; the thresholds are
// scaled by bd - 8 here).  The same kernel, a template on the tile
// (lf_tiles_kernel<TH, TW>), filters the chroma of a 4:4:0 frame in tiles
// of 32 rows and 64 columns (VP9's vp9_filter_block_plane_non420 order).
// JAX's lf_plane_tiles is parametric in the tile too (gx = 8, gy = 4), but
// the JAX package never calls it so: it sends 4:4:0 frames to its host
// oracle, so this instance replaces no TPU code.
//
// Order.  Both walk a grid of tiles in which tile (r, c) needs (r, c-1)
// and (r-1, c+1) finished: a 64x64 luma SB with its two 32x32 chroma
// tiles for K1, a 64x32 (4:4:0: 32x64) tile of each chroma plane for K7.
// A tile's
// footprint is the tile and the 8-pixel strips to its left and above it,
// with no corner.  In the vertical pass every pixel row is independent,
// in the horizontal pass every pixel column, so a thread owns a row
// (column) and walks its chains in order: for K1, 64 threads take the
// luma rows (columns) and 2 x 32 the U and V ones, 8 and 4 chains each;
// for K7, 2 x 64 threads the rows (4 chains each), then 2 x 32 the
// columns (8 chains each); at 4:4:0, 2 x 32 threads the rows (8 chains
// each), then 2 x 32 threads two columns each (4 chains a column).
//
// The two passes have different neighbours.  The vertical pass of (r, c)
// reads and writes only the tile's own rows and its left strip, which
// row r-1 never touches, so it waits only for (r, c-1).  The horizontal
// pass reads the top strip, which row r-1 writes up to its horizontal
// pass of (r-1, c) and its vertical pass of (r-1, c+1) (7 pixels of its
// left strip), and writes it.  So a row publishes its progress in half
// steps, and the critical path is cols + rows - 1 tile steps (46 at
// 1920x1088, 17 x 30 tiles in every form), where whole-tile hand-offs would make it cols + 2 (rows - 1)
// (62).  One condition: the vertical pass of (r, c) writes its left strip
// back before it publishes, because the horizontal pass of (r+1, c-1)
// changes those pixels next.
//
// Schedule.  One launch per call, 128 threads a block.  A block claims
// the next tile row with an atomic ticket and walks it left to right;
// before the horizontal pass of tile (r, c) it waits until row r-1 has
// run tile c and the vertical pass of tile c + 1.  With several frames
// (K1's stream axis), ticket t is row t % rows of the (t / rows)-th
// frame, and a row waits only on the row above it in its own frame.  A
// block only ever waits on a row claimed before its own (ticket t - 1),
// by a block that is already running, so the walk cannot deadlock,
// whatever order the blocks become resident in.  Passes in flight at the
// same time touch disjoint pixels.  A pixel outside its plane reads 0
// (the Pallas kernel's 8-pixel zero apron), and only pixels that a chain
// may have changed (window positions 1..14) and that lie in the plane are
// written back.  The ticket and the progress flags (2 c + 1 once tile
// (r, c) has run its vertical pass, 2 c + 2 once it has run both) live in
// an int32 workspace [1 + frames * rows] that the wrapper allocates and
// the entry point zeroes on the stream before the launch.
//
// K1's step (walk_rows, FrameTile) stages each pass's window from global
// memory into shared memory, runs its chains there, writes the changed
// pixels back and publishes after each pass.  K7's step keeps the
// loads, most stores and half its block off the critical path
// (lf_tiles_kernel, at both tile shapes):
//   - a tile's own TH x TW pixels and its map cells are fetched a step
//     early, with cp.async into the other of two shared buffers: nobody
//     changes them before the tile's vertical pass (row r-1 stops at row
//     TH r - 1, row r+1 starts after this row has published tile c + 1);
//   - its left strip is the last tile's right 8 columns, carried from
//     shared memory, not reloaded: no other block touches them before
//     the next vertical pass;
//   - only the top strip is read from global memory after the wait;
//   - one release a step, after the vertical pass: a row waits for
//     2 c + 3 or for the end of the row, never for 2 c + 2.  Before it
//     goes only what the horizontal pass of (r+1, c-1) reads, the bottom
//     8 rows of tile c-1 (2 x 8 x TW pixels).  A thread of warp 2 makes
//     it, so
//     warps 0-1 go on to the wait and the top strip without waiting for
//     its fence (they meet on a barrier of their own, barrier 1);
//   - during the horizontal pass, which has work for warps 0-1 only,
//     warps 2-3 (one a plane) write the rest of tile c-1 back (its rows
//     above the bottom 8, which row r+1 changes next) and start the
//     fetch of tile c + 1 into that buffer.
// At 4:4:0 the vertical pass has only 64 row lanes, so warps 2-3 idle in
// it, and the horizontal pass has 128 column lanes on warps 0-1: its
// step is 8 + 8 chains deep where 4:2:2's is 4 + 8.
// Every window sees exactly the pixels of the normative order: the copies
// hold the same values as the plane would.
//
// What bounds it on this card: the serial critical path of tile steps of
// one frame (cols + rows - 1 steps), each two passes of dependent chains
// in shared memory (K1: with a staged load and a store around each); not
// bytes (a 1080p frame is 12 MB of int32 pixels, 7.6 us at the memory
// rate).  One frame runs one block per SB row, so a small frame leaves
// most of the 132 SMs idle (a 640x384 frame: 6 blocks).  The stream axis
// fills them: the rows of all N frames are in flight at once, and N
// frames cost about one frame's critical path while all their rows are
// resident.  Residency is bounded by registers: 242 per thread at 128
// threads (ptxas -v) allow 2 blocks per SM, 264 on the card, so every
// row of 16 640x384 frames (96 blocks) is resident at once.  Measured by
// chip_smoke.py on an NVIDIA H100 80GB HBM3 at its 700 W power limit:
// K1 0.714 ms per 1920x1088 frame at bd 10, one SB step 13.2 us (so the
// 46-step path is 0.607 ms); 16 640x384 frames in one launch 0.260 ms,
// against 3.564 ms for 16 launches; K7 0.338-0.372 ms for two 1088x960
// planes at bd 10, one tile step 5.8-6.3 us, of which about 2 us is not
// the edge chains (the design before: 0.539-0.571 ms and 10.2-11.0 us,
// about 5.7 us not the chains, timed in the same runs); before the
// template.
//
// Frame layout: F is int32 [3, ha, wa] contiguous (K1: [N, 3, ha, wa]),
// ha and wa multiples of 64.  For K1, U and V occupy the top-left
// [ha/2, wa/2] of their planes; for K7, the left [ha, wa/2] (4:4:0: the
// top [ha/2, wa]).  A cell whose bits are 0 reads nothing.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int YS = 73;  // luma tile row stride: 72 + 1, so the rows of a
                        // vertical pass fall on distinct banks
constexpr int CS = 41;  // chroma tile row stride: 40 + 1
constexpr int kMaxSpins = 1 << 24;  // polls of a progress flag before a trap

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

// ------------------------------------------------------------ progress

// Device-scope release store of a progress flag.  The block's pixel
// stores come before it through the __syncthreads() that precedes the
// call, and a release is cumulative: a block that reads the flag with
// ld_acquire sees those pixels.
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// Device-scope acquire load of a progress flag: no later load of this
// thread (nor, through the __syncthreads() after the wait, of its block)
// moves before it.
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

// Barrier 1 of warps 0-1 alone (64 threads): K7's horizontal pass, which
// warps 2-3 do not join.
__device__ __forceinline__ void sync_warps01() {
  asm volatile("bar.sync 1, 64;" ::: "memory");
}

// K1's row walker of the header, over `frames` frames of rows x cols
// tiles.  ws[0] is the ticket, ws[1 + k rows + r] the progress of row r
// of frame k in half steps: 2 c + 1 once tile (r, c) has run its
// vertical pass, 2 c + 2 once it has run both.  tile.enter(k) selects
// frame k (and may fill shared memory); tile.vertical(r, c) and
// tile.horizontal(r, c) run one pass of one tile of that frame with the
// whole block and may use __syncthreads().
template <class Tile>
__device__ void walk_rows(int* ws, int frames, int rows, int cols,
                          Tile& tile) {
  __shared__ int s_ticket;
  int frame = -1;
  for (;;) {
    __syncthreads();  // every thread has read the last round's s_ticket
                      // and is done with the last frame's shared state
    if (threadIdx.x == 0) s_ticket = atomicAdd(ws, 1);
    __syncthreads();
    const int t = s_ticket;
    if (t >= frames * rows) return;
    const int k = t / rows, r = t % rows;
    if (k != frame) {
      frame = k;
      tile.enter(k);
      __syncthreads();
    }
    int* const progress = ws + 1 + k * rows;
    for (int c = 0; c < cols; ++c) {
      tile.vertical(r, c);
      // every thread's stores of the left strip come before the release
      __syncthreads();
      if (threadIdx.x == 0) {
        st_release(progress + r, 2 * c + 1);
        if (r > 0) {
          // the top strip is final once row r-1 has run tile c and the
          // vertical pass of tile c + 1
          const int need = c + 1 < cols ? 2 * c + 3 : 2 * cols;
          // a wait lasts a few tile steps; one of seconds is a fault (a
          // workspace that was not zeroed), and the launch fails rather
          // than hangs
          for (int spins = 0; ld_acquire(progress + r - 1) < need; ++spins) {
            if (spins == kMaxSpins) __trap();
            __nanosleep(32);
          }
        }
      }
      // the other threads read row r-1's pixels only after the acquire
      __syncthreads();
      tile.horizontal(r, c);
      // every thread's pixel stores come before the release
      __syncthreads();
      if (threadIdx.x == 0) st_release(progress + r, 2 * c + 2);
    }
  }
}

// ------------------------------------------------------------ tiles

struct Plane {  // a plane of F: first pixel, row stride, height, width
  int32_t* p;
  int rs, h, w;
};

// The TH x TW window at (y, x) of a plane, staged through registers with
// the whole block: load() issues every global load of this thread before
// store() writes any of them to shared memory, so a pass's loads are in
// flight together (each pass is on the critical path; its latency is
// what counts).  A pixel outside the plane reads 0.  __ldcg reads L2, so
// a pixel that another block wrote is never served from a stale L1 line.
template <int TH, int TW>
struct Staged {
  static constexpr int N = (TH * TW + kThreads - 1) / kThreads;
  int v[N];

  __device__ __forceinline__ void load(const Plane& P, int y0, int x0) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int y = y0 + i / TW, x = x0 + i % TW;
      v[j] = (i < TH * TW && y >= 0 && y < P.h && x >= 0 && x < P.w)
                 ? __ldcg(P.p + static_cast<size_t>(y) * P.rs + x)
                 : 0;
    }
  }

  __device__ __forceinline__ void store(int* s, int ss) const {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int i = threadIdx.x + j * kThreads;
      if (i < TH * TW) s[(i / TW) * ss + i % TW] = v[j];
    }
  }
};

// Writes the TH x TW window of s (row stride ss) back to (y, x) of a
// plane, where it lies in the plane.
template <int TH, int TW>
__device__ void unstage(const int* s, int ss, const Plane& P, int y0,
                        int x0) {
  for (int i = threadIdx.x; i < TH * TW; i += kThreads) {
    const int y = y0 + i / TW, x = x0 + i % TW;
    if (y >= 0 && y < P.h && x >= 0 && x < P.w)
      __stcg(P.p + static_cast<size_t>(y) * P.rs + x,
             s[(i / TW) * ss + i % TW]);
  }
}

// One lane's n chains in order on a staged tile: window k is the 16
// pixels base[(8 k + m) es], m = 0..15.  meta(k, bits, mb, lm, hv) gives
// chain k's edge bits and bd-scaled thresholds from shared memory and
// returns false for no edge.  Window k + 1 starts at position 8 of window
// k, so that half stays in registers: a chain loads 8 pixels and stores
// the 8 (positions 0..7) that no later chain of the lane changes.
template <class Meta>
__device__ void run_lane(int* base, int es, int n, int bd, const Meta& meta) {
  int w[16];
#pragma unroll
  for (int m = 0; m < 8; ++m) w[8 + m] = base[m * es];
#pragma unroll 1
  for (int k = 0; k < n; ++k) {
    int* p = base + 8 * k * es;
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      w[m] = w[8 + m];
      w[8 + m] = p[(8 + m) * es];
    }
    int bits, mb, lm, hv;
    if (meta(k, bits, mb, lm, hv)) edge_chain(w, bits, mb, lm, hv, bd);
#pragma unroll
    for (int m = 0; m < 8; ++m) p[m * es] = w[m];
  }
#pragma unroll
  for (int m = 8; m < 15; ++m) base[(8 * (n - 1) + m) * es] = w[m];
}

// K1's metadata: chain k's cell at cell[8 k] of an SB's staged lfm
// (bits | level << 4); thr [64, 4], already bd-scaled.
struct LfmMeta {
  const int* cell;
  const int* thr;
  __device__ bool operator()(int k, int& bits, int& mb, int& lm,
                             int& hv) const {
    const int v = cell[8 * k];
    bits = v & 15;
    if (!bits) return false;
    const int* t = thr + (v >> 4) * 4;
    mb = t[1];
    lm = t[2];
    hv = t[3];
    return true;
  }
};

// K7's metadata: chain k's cell c0 + k step of a tile's shared maps
// (32 cells each, MW to a row: 4 at 4:2:2, 8 at 4:4:0).
struct MapMeta {
  const int *bits, *mb, *lm, *hv;
  int c0, step, sh;
  __device__ bool operator()(int k, int& b, int& mbv, int& lmv,
                             int& hvv) const {
    const int i = c0 + k * step;
    b = bits[i];
    if (!b) return false;
    mbv = mb[i] << sh;
    lmv = lm[i] << sh;
    hvv = hv[i] << sh;
    return true;
  }
};

// The two passes of a tile, on a shared tile of TH x TW pixels at (y0,
// x0) = 8 pixels up and left of the tile (row stride ss): the vertical
// pass stages rows 8.. (the tile and its left strip), runs, and writes
// back the left strip, which the next row's horizontal pass of the tile
// to the left changes next; the horizontal pass stages the top strip
// (rows 0..7 right of the corner), runs, and writes back the rest.

// K1: SB (r, c) of the luma plane and both 4:2:0 chroma planes of one
// frame of the stream axis.  enter(k) points the planes and lfm at frame
// streams[k] (k itself without a stream list) and loads its thresholds.
struct FrameTile {
  int32_t* F;            // [N, 3, ha, wa]
  const int16_t* lfm0;   // frame s's lfm at lfm0 + s * lfm_stride
  const int16_t* thr0;   // frame s's thr [64, 4] at thr0 + s * thr_stride
  const int* streams;    // [n_active] frame indices, or null
  long long lfm_stride, thr_stride;
  int ha, wa, sb_cols, bd;
  Plane y, u, v;
  const int16_t* lfm;
  int* thr;           // shared: the frame's thresholds, bd-scaled, 256
  int *sy, *su, *sv;  // shared: 72 x YS luma, 40 x CS per chroma plane
  int* sl;            // shared: the SB's lfm, 256 entries

  __device__ void enter(int k) {
    const int s = streams ? streams[k] : k;
    const size_t n = static_cast<size_t>(ha) * wa;
    int32_t* f = F + 3 * n * s;
    y = {f, wa, ha, wa};
    u = {f + n, wa, ha / 2, wa / 2};
    v = {f + 2 * n, wa, ha / 2, wa / 2};
    lfm = lfm0 + lfm_stride * s;
    const int16_t* t = thr0 + thr_stride * s;
    for (int i = threadIdx.x; i < 256; i += kThreads)
      thr[i] = t[i] << (bd - 8);
  }

  // whether this thread's lfm entries hold an edge of its plane kind; a
  // plane with no edge in the SB is not written back (the chroma of a
  // 4:4:4 or 4:2:2 frame's call: zero chroma fields)
  __device__ int edges(bool chroma) const {
    const int t = threadIdx.x;
    return (chroma ? t >= 64 && t < 96 : t < 64) &&
           ((sl[t] | sl[128 + t]) & 15);
  }

  __device__ void vertical(int r, int c) const {
    const int t = threadIdx.x;
    const int16_t* L = lfm + static_cast<size_t>(r * sb_cols + c) * 256;
    Staged<64, 72> a;
    Staged<32, 40> b, d;
    a.load(y, r * 64, c * 64 - 8);
    b.load(u, r * 32, c * 32 - 8);
    d.load(v, r * 32, c * 32 - 8);
    const int e0 = __ldg(L + t), e1 = __ldg(L + 128 + t);
    a.store(sy + 8 * YS, YS);
    b.store(su + 8 * CS, CS);
    d.store(sv + 8 * CS, CS);
    sl[t] = e0;
    sl[128 + t] = e1;
    __syncthreads();
    // the lane's pixel row, windows at columns 8 k
    const bool luma = t < 64;
    const int lane = luma ? t : (t - 64) & 31;
    const int ss = luma ? YS : CS;
    run_lane((luma ? sy : (t < 96 ? su : sv)) + (8 + lane) * ss, 1,
             luma ? 8 : 4, bd,
             LfmMeta{sl + (luma ? 0 : 64) + (lane >> 3), thr});
    const bool any_y = __syncthreads_or(edges(false));
    const bool any_c = __syncthreads_or(edges(true));
    if (any_y) unstage<64, 7>(sy + 8 * YS + 1, YS, y, r * 64, c * 64 - 7);
    if (any_c) {
      unstage<32, 7>(su + 8 * CS + 1, CS, u, r * 32, c * 32 - 7);
      unstage<32, 7>(sv + 8 * CS + 1, CS, v, r * 32, c * 32 - 7);
    }
  }

  __device__ void horizontal(int r, int c) const {
    const int t = threadIdx.x;
    Staged<8, 64> a;
    Staged<8, 32> b, d;
    a.load(y, r * 64 - 8, c * 64);
    b.load(u, r * 32 - 8, c * 32);
    d.load(v, r * 32 - 8, c * 32);
    a.store(sy + 8, YS);
    b.store(su + 8, CS);
    d.store(sv + 8, CS);
    __syncthreads();
    // the lane's pixel column, windows at rows 8 k
    const bool luma = t < 64;
    const int lane = luma ? t : (t - 64) & 31;
    run_lane((luma ? sy : (t < 96 ? su : sv)) + 8 + lane, luma ? YS : CS,
             luma ? 8 : 4, bd,
             LfmMeta{sl + 128 + (luma ? 0 : 64) + (lane >> 3), thr});
    const bool any_y = __syncthreads_or(edges(false));
    const bool any_c = __syncthreads_or(edges(true));
    if (any_y) unstage<71, 64>(sy + YS + 8, YS, y, r * 64 - 7, c * 64);
    if (any_c) {
      unstage<39, 32>(su + CS + 8, CS, u, r * 32 - 7, c * 32);
      unstage<39, 32>(sv + CS + 8, CS, v, r * 32 - 7, c * 32);
    }
  }
};

__global__ void __launch_bounds__(kThreads)
lf_frame_kernel(int32_t* __restrict__ F, const int16_t* __restrict__ lfm,
                long long lfm_stride, const int16_t* __restrict__ thr,
                long long thr_stride, const int* __restrict__ streams,
                int n_active, int* ws, int ha, int wa, int bd) {
  __shared__ int sy[72 * YS];
  __shared__ int su[40 * CS];
  __shared__ int sv[40 * CS];
  __shared__ int sl[256];
  __shared__ int sthr[256];
  FrameTile tile{F, lfm, thr, streams, lfm_stride, thr_stride, ha, wa,
                 wa / 64, bd, {}, {}, {}, nullptr, sthr, sy, su, sv, sl};
  walk_rows(ws, n_active, ha / 64, wa / 64, tile);
}

// ------------------------------------------------------------ K7

// K7's planes, maps and tile geometry for tiles of TH rows and TW columns
// (the chroma of one luma superblock: 64 x 32 at 4:2:2, 32 x 64 at
// 4:4:0).  A plane's shared tile is TH + 8 rows of SS: the top strip (rows
// 0..7) and the tile's TH rows; in each, the left strip (columns 0..7) and
// the tile's TW columns (8..TW + 7).  The tile holds 32 cells of each of
// the five maps, MW to a row.
template <int TH, int TW>
struct ChromaTiles {
  static constexpr int SS = TW + 9;  // row stride: TW + 8 + 1, so the rows
                                     // of a vertical pass fall on distinct
                                     // banks
  static constexpr int TILE = (TH + 8) * SS;
  static constexpr int MW = TW / 8;
  static_assert(TH * TW == 2048 && TH <= 64 && TW <= 64,
                "a tile is 32 cells, its vertical lanes fit the block");

  Plane pl[2];             // U, V: the top-left [rows * TH, cols * TW]
  const int16_t* maps[5];  // vbits, hbits, mb, lm, hv: [rows * TH / 8,
                           // mcols]
  int mcols;

  // Starts the asynchronous copies of elements i0, i0 + di, ... (row-major)
  // of plane p's part of tile (r, c), its own TH x TW pixels, into the
  // plane's shared tile s (rows 8.., columns 8..).
  __device__ void fetch(int* s, int r, int c, int p, int i0, int di) const {
    const int rs = pl[p].rs;
    const int32_t* g =
        pl[p].p + static_cast<size_t>(r * TH) * rs + c * TW;
    int* d = s + 8 * SS + 8;
#pragma unroll 8
    for (int i = i0; i < TH * TW; i += di) {
      const int y = i / TW, x = i % TW;
      __pipeline_memcpy_async(d + y * SS + x, g + static_cast<size_t>(y) * rs
                              + x, sizeof(int));
    }
    __pipeline_commit();
  }

  // Map entry i of tile (r, c): map i / 32, cell i % 32 (MW to a row).
  __device__ int cell(int r, int c, int i) const {
    const int k = i & 31;
    return __ldg(maps[i >> 5] + (r * (TH / 8) + k / MW) * mcols + c * MW +
                 k % MW);
  }

  // Writes pixel (y, x) of tile row r's shared tiles (y = 0 is 8 rows
  // above the tile row; x = 0 is column c0 of the plane) to plane p,
  // unless it lies above the plane.
  __device__ void put(int p, int r, int c0, int y, int x, int v) const {
    const int gy = r * TH - 8 + y;
    if (gy >= 0)
      __stcg(pl[p].p + static_cast<size_t>(gy) * pl[p].rs + c0 + x, v);
  }
};

// K7 on tiles of TH x TW, both chroma planes: rows = ha / 64 tile rows and
// cols = wa / 64 tile columns at either shape.  The vertical pass has 2 TH
// row lanes (all 128 threads at 4:2:2; warps 0-1 at 4:4:0), TW / 8 chains
// each; the horizontal pass 2 TW column lanes on warps 0-1, TH / 8 chains
// each (a lane a thread at 4:2:2; two at 4:4:0), while warps 2-3 write back
// and fetch.
template <int TH, int TW>
__global__ void __launch_bounds__(kThreads)
lf_tiles_kernel(int32_t* __restrict__ F, const int16_t* __restrict__ vb,
                const int16_t* __restrict__ hb,
                const int16_t* __restrict__ mb,
                const int16_t* __restrict__ lm,
                const int16_t* __restrict__ hv, int* ws, int ha, int wa,
                int bd) {
  using T = ChromaTiles<TH, TW>;
  constexpr int SS = T::SS, TILE = T::TILE, MW = T::MW;
  __shared__ int st[2][2 * TILE];  // [buffer][plane * TILE + ...]
  __shared__ int sm[2][160];       // [buffer]: the tile's map cells
  __shared__ int s_ticket;
  const size_t n = static_cast<size_t>(ha) * wa;
  const int rows = ha / 64, cols = wa / 64, sh = bd - 8;
  const int hc = rows * TH, wc = cols * TW;
  const T K{{{F + n, wa, hc, wc}, {F + 2 * n, wa, hc, wc}},
            {vb, hb, mb, lm, hv}, wc / 8};
  const int t = threadIdx.x;
  int* const progress = ws + 1;
  for (;;) {
    __syncthreads();  // every thread has read s_ticket and is done with
                      // the last row's shared state
    if (t == 0) s_ticket = atomicAdd(ws, 1);
    __syncthreads();
    const int r = s_ticket;
    if (r >= rows) return;
    // tile 0: its pixels and maps, and its left strip, left of the planes
    K.fetch(st[0] + (t >> 6) * TILE, r, 0, t >> 6, t & 63, 64);
    for (int i = t; i < 160; i += kThreads) sm[0][i] = K.cell(r, 0, i);
    for (int i = t; i < 2 * TH * 8; i += kThreads)
      st[0][(i / (TH * 8)) * TILE + (8 + (i >> 3) % TH) * SS + (i & 7)] = 0;
    int m[3];  // warps 2-3: the next tile's map entries t - 64 + 64 j
    for (int c = 0; c < cols; ++c) {
      int* const s = st[c & 1];          // tile c
      int* const o = st[(c & 1) ^ 1];    // tile c-1, then c+1
      const int* const cm = sm[c & 1];
      __pipeline_wait_prior(0);
      __syncthreads();  // tile c in s: pixels, left strip, maps
      if (t < 2 * TH) {  // vertical pass: TH row lanes a plane, windows
                         // at columns 8 k
        const int y = t % TH;
        run_lane(s + (t / TH) * TILE + (8 + y) * SS, 1, TW / 8, bd,
                 MapMeta{cm, cm + 64, cm + 96, cm + 128, (y >> 3) * MW, 1,
                         sh});
      }
      __syncthreads();
#ifndef VP9_LF422_NO_WRITEBACK
      // what the horizontal pass of (r+1, c-1) reads: the bottom 8 rows of
      // tile c-1, its last 7 columns as this vertical pass left them (the
      // left strip, s), the others as its horizontal pass did (o)
      if (c > 0) {
        for (int i = t; i < 2 * 8 * TW; i += kThreads) {
          const int p = i / (8 * TW), y = TH + (i / TW) % 8, x = i % TW;
          const int* q =
              (x < TW - 7 ? o + 8 : s - (TW - 8)) + p * TILE + y * SS;
          K.put(p, r, (c - 1) * TW, y, x, q[x]);
        }
      }
#endif
      // every thread's stores come before the release
      __syncthreads();
      if (t < 64) {
        if (t == 0 && r > 0) {
          // the top strip is final once row r-1 has run tile c and the
          // vertical pass of tile c + 1; a wait of seconds is a fault,
          // and the launch fails rather than hangs
          const int need = c + 1 < cols ? 2 * c + 3 : 2 * cols;
          for (int spins = 0; ld_acquire(progress + r - 1) < need; ++spins) {
            if (spins == kMaxSpins) __trap();
            __nanosleep(32);
          }
        }
        sync_warps01();  // warps 0-1 read row r-1's pixels only after the
                         // acquire
        // the top strip, 8 rows above the tile's own columns (0 above the
        // planes), through L2: row r-1 wrote it
        constexpr int NJ = 2 * 8 * TW / 64;
        int v[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {  // [plane][row][col]: 2 x 8 x TW
          const int i = t + j * 64;
          const int p = i / (8 * TW), y = (i / TW) % 8, x = i % TW;
          v[j] = r > 0 ? __ldcg(K.pl[p].p +
                                static_cast<size_t>(r * TH - 8 + y) *
                                    K.pl[p].rs +
                                c * TW + x)
                       : 0;
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int i = t + j * 64;
          s[(i / (8 * TW)) * TILE + ((i / TW) % 8) * SS + 8 + i % TW] = v[j];
        }
        sync_warps01();
        // horizontal pass: TW column lanes a plane, windows at rows 8 k
#pragma unroll
        for (int j = 0; j < 2 * TW / 64; ++j) {
          const int l = t + 64 * j, x = l % TW;
          run_lane(s + (l / TW) * TILE + 8 + x, SS, TH / 8, bd,
                   MapMeta{cm + 32, cm + 64, cm + 96, cm + 128, x >> 3, MW,
                           sh});
        }
      } else {
        // warps 2-3 publish: the barrier above put every thread's stores
        // before this release, which warps 0-1 need not wait for
        if (t == 64) st_release(progress + r, 2 * c + 1);
        // warps 2-3 (U, V): the rest of tile c-1 goes back to the plane
        // (its bottom 8 rows went before the release, and row r+1 changes
        // them next), then its buffer takes tile c + 1
        const int p = (t >> 5) - 2, lane = t & 31;
#ifndef VP9_LF422_NO_WRITEBACK
        if (c > 0) {  // columns lane, lane + 32, ... of tile c-1: rows
                      // 1..7 as its horizontal pass left them, rows
                      // 8..TH-1 as this vertical pass did where it
                      // changed them
          const int rs = K.pl[p].rs;
#pragma unroll
          for (int j = 0; j < TW / 32; ++j) {
            const int x = lane + 32 * j;
            const int* q = o + p * TILE + 8 + x;
            const int* e = x < TW - 7 ? q : s + p * TILE + x - (TW - 8);
            int32_t* g = K.pl[p].p + static_cast<size_t>(r * TH) * rs +
                         (c - 1) * TW + x;  // the tile row's first row
            if (r > 0) {
#pragma unroll
              for (int y = 1; y < 8; ++y)
                __stcg(g - static_cast<size_t>(8 - y) * rs, q[y * SS]);
            }
#pragma unroll 8
            for (int y = 8; y < TH; ++y)
              __stcg(g + static_cast<size_t>(y - 8) * rs, e[y * SS]);
          }
        }
#endif
        __syncwarp();  // the warp has read its plane of o
        if (c + 1 < cols) {
          K.fetch(o + p * TILE, r, c + 1, p, lane, 32);
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            const int i = t - 64 + 64 * j;
            m[j] = i < 160 ? K.cell(r, c + 1, i) : 0;
          }
        }
      }
      __syncthreads();
      if (c + 1 < cols) {
        // the tile's right 8 columns are the next tile's left strip: no
        // other block touches them before the next vertical pass
        for (int i = t; i < 2 * TH * 8; i += kThreads) {
          const int q =
              (i / (TH * 8)) * TILE + (8 + (i >> 3) % TH) * SS + (i & 7);
          o[q] = s[q + TW];
        }
        if (t >= 64) {
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            const int i = t - 64 + 64 * j;
            if (i < 160) sm[(c & 1) ^ 1][i] = m[j];
          }
        }
      } else {
#ifndef VP9_LF422_NO_WRITEBACK
        // the last tile goes back whole: rows 1..TH + 7 of its columns
        constexpr int N = (TH + 7) * TW;
        for (int i = t; i < 2 * N; i += kThreads) {
          const int p = i / N, y = 1 + (i % N) / TW, x = i % TW;
          K.put(p, r, c * TW, y, x, s[p * TILE + y * SS + 8 + x]);
        }
#endif
        __syncthreads();  // every thread's stores come before the release
        if (t == 0) st_release(progress + r, 2 * cols);
      }
    }
  }
}

}  // namespace

// Filters frames of F [N, 3, ha, wa] in place: frame streams[k] for k <
// n_active (frame k when streams is null), with its lfm [n_sbs_pad, 2,
// 128] at lfm + streams[k] * lfm_stride and its thr [64, 4] at thr +
// streams[k] * thr_stride (int16 elements).  streams is an int32 device
// array.  Zeroes the workspace ws (int32, at least 1 + n_active * ha / 64
// entries) and launches the persistent kernel on `stream`, one block per
// (frame, SB row).  Sets *launched to the number of kernel launches made
// (1, or 0 when n_active is 0).  Returns the first CUDA error, 0 on
// success.
extern "C" int vp9_lf_frames(void* F, const void* lfm, long long lfm_stride,
                             const void* thr, long long thr_stride,
                             const void* streams, int n_active, void* ws,
                             int ha, int wa, int bd, void* stream,
                             int* launched) {
  *launched = 0;
  if (n_active <= 0) return 0;
  const int rows = ha / 64;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaMemsetAsync(ws, 0, (1 + n_active * rows) * sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  lf_frame_kernel<<<n_active * rows, kThreads, 0, st>>>(
      static_cast<int32_t*>(F), static_cast<const int16_t*>(lfm), lfm_stride,
      static_cast<const int16_t*>(thr), thr_stride,
      static_cast<const int*>(streams), n_active, static_cast<int*>(ws), ha,
      wa, bd);
  ++*launched;
  return static_cast<int>(cudaGetLastError());
}

// Filters the chroma planes of a 4:2:2 (ss_x, ss_y = 1, 0) or 4:4:0 (0, 1)
// frame F [3, ha, wa] in place (the top-left [ha >> ss_y, wa >> ss_x] of
// planes 1 and 2); vb, hb, mb, lm, hv are int16 [ha >> ss_y >> 3, wa >>
// ss_x >> 3] each.  Workspace (1 + ha / 64 entries), stream and result as
// vp9_lf_frames; another subsampling is cudaErrorInvalidValue, with no
// launch.
extern "C" int vp9_lf_plane_tiles(void* F, const void* vb, const void* hb,
                                  const void* mb, const void* lm,
                                  const void* hv, void* ws, int ha, int wa,
                                  int bd, int ss_x, int ss_y, void* stream,
                                  int* launched) {
  *launched = 0;
  if (ss_x + ss_y != 1 || ss_x * ss_y != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = ha / 64;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(ws, 0, (1 + rows) * sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* f = static_cast<int32_t*>(F);
  auto* v = static_cast<const int16_t*>(vb);
  auto* h = static_cast<const int16_t*>(hb);
  auto* b = static_cast<const int16_t*>(mb);
  auto* l = static_cast<const int16_t*>(lm);
  auto* e = static_cast<const int16_t*>(hv);
  int* w = static_cast<int*>(ws);
  if (ss_x)
    lf_tiles_kernel<64, 32><<<rows, kThreads, 0, st>>>(f, v, h, b, l, e, w,
                                                       ha, wa, bd);
  else
    lf_tiles_kernel<32, 64><<<rows, kThreads, 0, st>>>(f, v, h, b, l, e, w,
                                                       ha, wa, bd);
  ++*launched;
  return static_cast<int>(cudaGetLastError());
}
