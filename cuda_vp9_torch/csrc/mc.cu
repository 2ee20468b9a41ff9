// VP9 motion compensation (K3 and K6) and the inter residual add,
// hand-written for Hopper: `vp9_mc_pass`, one persistent launch per frame
// or batched round.
//
// Replaces the XLA stages of cuda_vp9_tpu/runtime/fused.py `_mc_pass`
// (:163) -> `_mc_chunk_compute` (:69), the unscaled tile classes mc4,
// mc8, mc16 and mc32 with the compound average, `_mcs_pass` (:388) ->
// `_mcs_chunk_compute` (:311), the scaled-reference 4x4 class, in the
// class order of :603-619, and the inter residual add under mi_mask
// (:620-633), in the single-frame step and in the batched step (its vmap
// written out as a stream axis).  The plain twins are
// cuda_vp9_torch/ops/cuda/mc.py `mc_predict`, `mcs_predict`, `_land` and
// `mask_add`.
//
// Unscaled tile (records int16 [cap, ch, 4] = (dx | filt << 13, dy + 1,
// sr, sc), sr / sc = ((src - dst) << 4) | subpel, signed): the w + 7
// square window of rows clip(y0 - 3 + i, 0, chh - 1) and columns
// clip(x0 - 3 + j, 0, cw - 1) of pool[slot, plane] is staged in shared
// memory; the 8-tap horizontal pass over its w + 7 rows goes to a second
// shared tile, rounded ((acc + 64) >> 7) and clipped to [0, 2^bd - 1];
// the vertical pass reads that tile, rounds and clips the same way.  The
// chunk header (slot, plane, srow, cw, chh, ...) is the item's; srow
// exists for the TPU's row bands and is not read.
//
// Scaled tile (records int16 [cap, ch, 16]; fields 0-2 plane, dx,
// dy + 1; 4-5 the source origin x0, y0; 6-7 the base phases spx, spy; 8
// filt; 9-10 cw, chh; 12-13 the q4 steps xs, ys <= 32): column c reads
// source column x0 + ((spx + c xs) >> 4) - 3 + k with phase
// (spx + c xs) & 15 straight from the pool into 14 intermediate rows
// clip(y0 - 3 + i, 0, chh - 1); output row r filters intermediate rows
// ((spy + r ys) >> 4) + k, clamped to 0..13, with phase (spy + r ys) & 15.
//
// Phases.  The host lists the phases in the JAX step's order: for each
// class with chunks (mc4, mc8, mc16, mc32, then mcs), its firsts over
// chunks [0, hi) and then its compound seconds over [lo, n); then, when
// mi_mask has a bit set, the mask phase.  Chunks before a stream's own
// n_ref0 (read from its flat on the device) are firsts and write their
// tiles; the others are seconds and average into what is there:
// (F + p + 1) >> 1.  Within a phase destinations are distinct (the
// packer's rule), but two phases may land on the same pixels (a second
// reads what a first wrote; tiles of two classes may overlap), so phase
// j lands only once phase j - 1 is done.  A padded record (dy + 1 == 0)
// writes nothing, and no pixel outside [0, ha) x [0, wa) of its plane is
// written (JAX drops those writes, mode="drop").  The mask phase computes
// F = clip(F + R, 0, 2^bd - 1) over every non-skip inter mi cell of each
// stream's planes: mi_mask [mi_rows, ceil(mi_cols / 16)] int16, 16 cells
// a sign-extended word, a chroma cell (8 >> ss_y) x (8 >> ss_x) pixels.
//
// Streams.  Stream k's flat lies k * stride elements after stream 0's
// (its records, headers, n_ref0 and mi_mask); its pool slots are
// 8 act[k] + slot (act null: slot) and its frame planes 3k + plane, in F
// and in R.  A stream with fewer chunks than the phase runs the wire's
// zero padding, which writes nothing.  One frame is the case of one
// stream.  The scaled class has one stream's form only.
//
// Schedule.  One persistent launch per call, its grid what the card
// holds resident at once, capped at the item count.  An item is 256
// output pixels of one chunk of one stream in one phase (16 mc4 tiles, 4
// mc8 tiles, one mc16 tile or 16 scaled tiles), one a thread, or one mc32
// tile, 4 a thread; in the mask phase it is 32 mi cells of one mi row of
// one stream (2 mask words; an item whose words are 0 writes nothing).
// Items are numbered phase by phase, and a block claims the next with an
// atomic ticket.  Before it waits, an item does all that needs no earlier
// phase: thread 0 reads the chunk's header and its stream's n_ref0 while
// the item's records are staged, one a thread; then the pool window (no
// phase writes the pool) and both filter passes, into registers; or, in
// the mask phase, its mask words.  Then an item of
// phase j > 0 waits until phase j - 1's done counter reaches that
// phase's item count (thread 0 polls it with ld.acquire.gpu, then a
// __syncthreads), lands its pixels (reading F through L2, never a stale
// L1 line), and publishes (__syncthreads, __threadfence, atomicAdd on
// phase j's counter).  Every item waits, those that write nothing too,
// so a done phase implies every earlier one.  A block only waits on items
// whose tickets come before its own, claimed by blocks already running,
// so no residency order can deadlock; a wait past kMaxSpins polls traps
// instead of hanging.  The ticket and the counters live in an int32
// workspace, one 128-byte line each, which the entry point zeroes on the
// stream before the launch (csrc/intra.cu keeps the same rules).  The
// filter table is staged in shared memory once per block, and one shared
// buffer, sized for mc32's window and intermediate tile, serves every
// class.  The register cap is kMinBlocks below.
//
// What bounds it.  A tile reads its (w + 7)^2 window once and writes w^2
// pixels: at 8 taps a pixel a pass, about 16 int32 multiply-adds per
// output pixel; the mask phase reads and writes F and reads R once over
// the masked cells.  An nc03 frame is a few MB of traffic and about ten
// million multiply-adds, microseconds of the card.  What the design
// before this one paid, one dependent grid per class and landing phase
// and the torch ops of the mask add, becomes one launch and a hand-off
// per phase; `vp9_mc_chain_floor` runs the same launch, phases and items
// with no work, the floor of that schedule.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTaps = 4 * 16 * 8;
constexpr int kLine = 32;            // ints per 128-byte workspace line
constexpr int kMaxSpins = 1 << 24;   // polls of a done counter before a trap
constexpr int kMaxPhases = 11;       // 5 classes x (firsts, seconds), mask
constexpr int kDescWords = 8;        // int64 words of one phase descriptor
constexpr int kOut = 4;              // output pixels a thread holds
constexpr int kSegCells = 32;        // mi cells of a mask item (2 words)
// Blocks an SM at least: 4 caps the registers at 64, 4 blocks of 256
// threads an SM (8 + 8 bytes spilled).  chip_smoke.py's MC timings build
// the kernel with -DVP9_MC_MIN_BLOCKS=1, 6 and 8 too and time each beside
// this one: none of them ran all of its frames faster on the device (1
// spills nothing at 93 registers, 6 and 8 spill hundreds of bytes).
#ifndef VP9_MC_MIN_BLOCKS
#define VP9_MC_MIN_BLOCKS 4
#endif
constexpr int kMinBlocks = VP9_MC_MIN_BLOCKS;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// An unscaled item: kTP tiles, kTP W^2 output pixels (256, or 1024 of
// mc32), kOutT a thread.
template <int W>
struct Geom {
  static constexpr int kN = W + 7;                              // window
  static constexpr int kTP = W <= 16 ? kThreads / (W * W) : 1;  // tiles
  static constexpr int kWin = kTP * kN * kN;
  static constexpr int kTmp = kTP * kN * W;
  static constexpr int kOutT = kTP * W * W / kThreads;
};

constexpr int kSTP = 16;     // scaled tiles an item, 16 output pixels each
constexpr int kSRows = 14;   // intermediate rows of a scaled tile

constexpr int cmax(int a, int b) { return a > b ? a : b; }

// Words of the shared buffer: the largest class's window and
// intermediate tile (mc32: 39 x 39 + 39 x 32).
constexpr int kBufWords = cmax(
    cmax(Geom<4>::kWin + Geom<4>::kTmp, Geom<8>::kWin + Geom<8>::kTmp),
    cmax(cmax(Geom<16>::kWin + Geom<16>::kTmp,
              Geom<32>::kWin + Geom<32>::kTmp),
         kSTP * kSRows * 4));

static_assert(Geom<4>::kOutT == 1 && Geom<8>::kOutT == 1 &&
                  Geom<16>::kOutT == 1 && Geom<32>::kOutT == kOut &&
                  kSTP * 16 == kThreads && Geom<4>::kTP == kSTP,
              "an item is one output pixel a thread (mc32: kOut), and at "
              "most kSTP tiles");

// One phase of the launch.
struct Phase {
  const int16_t* rec;   // stream 0's records [cap, ch, rw]
  const int16_t* hdr;   // stream 0's chunk headers [cap, hw]
  const int16_t* r0;    // stream 0's n_ref0
  int kind;             // 4, 8, 16, 32; 0 the scaled class; -1 the mask
  int ch;               // records a chunk
  int c_lo;             // its first chunk
  int second;           // compound seconds
  int groups;           // items a chunk (mask: a mi row) of a stream
  int first_item;       // the ticket of its first item
  int n_items;
};

// The launch, a kernel parameter (__grid_constant__: read in place from
// the parameter bank, never copied to local memory).
struct Pass {
  Phase ph[kMaxPhases];
  int n_phases, n_items;
  int32_t* F;              // [P, ha, wa]
  const int32_t* R;        // [P, ha, wa], the residual
  const int32_t* pool;     // [S, 3, pha, pwa]
  const int16_t* act;      // stream k's pool is slots 8 act[k] .. (null: 0..)
  const int32_t* kern;     // [4, 16, 8]
  const int16_t* mask;     // stream 0's mi_mask, or null
  long long stride;        // elements between two streams' flats
  int P, ha, wa, S, pha, pwa, n_streams, maxv;
  int mi_rows, mi_cols, words, ssx, ssy;
};

// One tile's parameters, staged by one thread of its item.
struct Tile {
  int ok;                // not padding
  int dx, dy;            // the destination
  int plane;             // scaled: the record's plane
  int x0, y0;            // the source's integer origin
  int fx, fy;            // unscaled: offsets of the horizontal / vertical taps
  int spx, spy, fbase, cw, chh, xs, ys;   // scaled
};

// What thread 0 reads of an item for its block.
struct Head {
  int run;               // the chunk belongs to this phase
  int plane, cw, chh;    // unscaled: from the header
  long long src;         // offset of the source plane in the pool
  unsigned long long bits;   // the mask phase: the segment's mask bits
};

// Lands pixel v at (row, col) of plane `plane` of stream k: a write, or
// (second) the compound average with what is there.
__device__ __forceinline__ void land(const Pass& p, int k, int plane,
                                     int row, int col, int v, int second) {
  const int pf = 3 * k + plane;
  if (plane < 0 || plane > 2 || pf >= p.P || row < 0 || row >= p.ha ||
      col < 0 || col >= p.wa)
    return;
  int32_t* d = p.F + (static_cast<long long>(pf) * p.ha + row) * p.wa + col;
  *d = second ? (__ldcg(d) + v + 1) >> 1 : v;
}

// Thread 0: the header of chunk c of stream k in phase ph, and whether
// the chunk runs there.
__device__ void read_head(const Pass& p, const Phase& ph, int k, int c,
                          Head& h) {
  const long long so = k * p.stride;
  const int16_t* hd = ph.hdr + so + static_cast<long long>(c) *
                                        (ph.kind == 0 ? 4 : 8);
  h.run = (c >= ph.r0[so]) == (ph.second != 0);
  if (ph.kind == 0) {
    // one stream's pool (the scaled class leaves the batch)
    const int slot = clampi(hd[0], 0, min(p.S, 8) - 1);
    h.src = static_cast<long long>(slot * 3 + clampi(hd[1], 0, 2)) * p.pha *
            p.pwa;
    return;
  }
  const int slot = clampi(hd[0] + (p.act ? 8 * p.act[k] : 0), 0, p.S - 1);
  h.plane = clampi(hd[1], 0, 2);
  h.cw = clampi(hd[3], 1, p.pwa);
  h.chh = clampi(hd[4], 1, p.pha);
  h.src = static_cast<long long>(slot * 3 + h.plane) * p.pha * p.pwa;
}

// Threads [0, n): record j0 + threadIdx.x of the chunk at rec (ch
// records), unscaled, into tiles[threadIdx.x].
__device__ void stage_tile(const int16_t* rec, int ch, int j0, int n,
                           Tile* tiles) {
  if (static_cast<int>(threadIdx.x) >= n) return;
  Tile& t = tiles[threadIdx.x];
  const int j = j0 + threadIdx.x;
  t.ok = 0;
  if (j >= ch) return;
  const int16_t* u = rec + static_cast<long long>(j) * 4;
  const int w0 = u[0], w1 = u[1], sr = u[2], sc = u[3];
  if (w1 == 0) return;
  const int filt = (w0 >> 13) & 3;
  t.ok = 1;
  t.dx = w0 & 0x1FFF;
  t.dy = w1 - 1;
  t.x0 = t.dx + (sc >> 4);   // arithmetic shifts of signed fields
  t.y0 = t.dy + (sr >> 4);
  t.fx = (filt * 16 + (sc & 15)) * 8;
  t.fy = (filt * 16 + (sr & 15)) * 8;
}

// The same for a scaled record.
__device__ void stage_scaled(const Pass& p, const int16_t* rec, int ch,
                             int j0, int n, Tile* tiles) {
  if (static_cast<int>(threadIdx.x) >= n) return;
  Tile& t = tiles[threadIdx.x];
  const int j = j0 + threadIdx.x;
  t.ok = 0;
  if (j >= ch) return;
  const int16_t* u = rec + static_cast<long long>(j) * 16;
  if (u[2] == 0) return;
  t.ok = 1;
  t.plane = u[0];
  t.dx = u[1];
  t.dy = u[2] - 1;
  t.x0 = u[4];
  t.y0 = u[5];
  t.spx = u[6];
  t.spy = u[7];
  t.fbase = clampi(u[8], 0, 3) * 16 * 8;
  t.cw = clampi(u[9], 1, p.pwa);
  t.chh = clampi(u[10], 1, p.pha);
  t.xs = clampi(u[12], 0, 32);
  t.ys = clampi(u[13], 0, 32);
}

// An unscaled item's staged tiles: both filter passes, a thread's
// output m into out[m].  Block-uniform (h.run is the block's).
template <int W>
__device__ void predict(const Pass& p, const Head& h, const Tile* tiles,
                        const int32_t* taps, int32_t* buf, int* out) {
  using G = Geom<W>;
  constexpr int kN = G::kN;
  constexpr int kTP = G::kTP;
  int32_t(*win)[kN][kN] = reinterpret_cast<int32_t(*)[kN][kN]>(buf);
  int32_t(*tmp)[kN][W] = reinterpret_cast<int32_t(*)[kN][W]>(buf + G::kWin);
  const int32_t* src = p.pool + h.src;
  for (int i = threadIdx.x; i < kTP * kN * kN; i += kThreads) {
    const int q = i / (kN * kN);
    const int y = (i / kN) % kN;
    const int x = i % kN;
    const Tile& t = tiles[q];
    if (!t.ok) continue;
    const int row = clampi(t.y0 - 3 + y, 0, h.chh - 1);
    const int col = clampi(t.x0 - 3 + x, 0, h.cw - 1);
    win[q][y][x] = src[static_cast<long long>(row) * p.pwa + col];
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
    tmp[q][y][c] = clampi((acc + 64) >> 7, 0, p.maxv);
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < G::kOutT; ++m) {
    const int i = threadIdx.x + m * kThreads;
    const int q = i / (W * W);
    const int r = (i / W) % W;
    const int c = i % W;
    const Tile& t = tiles[q];
    if (!t.ok) continue;
    const int32_t* f = taps + t.fy;
    int acc = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) acc += f[k] * tmp[q][r + k][c];
    out[m] = clampi((acc + 64) >> 7, 0, p.maxv);
  }
}

// After the wait: land what predict<W> left in out.
template <int W>
__device__ void land_tiles(const Pass& p, const Head& h, int k, int second,
                           const Tile* tiles, const int* out) {
#pragma unroll
  for (int m = 0; m < Geom<W>::kOutT; ++m) {
    const int i = threadIdx.x + m * kThreads;
    const Tile& t = tiles[i / (W * W)];
    if (t.ok)
      land(p, k, h.plane, t.dy + (i / W) % W, t.dx + i % W, out[m], second);
  }
}

// A scaled item's staged tiles, as predict: output pixel (r, c) of tile
// threadIdx.x / 16 into out[0].
__device__ void predict_scaled(const Pass& p, const Head& h,
                               const Tile* tiles, const int32_t* taps,
                               int32_t* buf, int* out) {
  int32_t(*tmp)[kSRows][4] = reinterpret_cast<int32_t(*)[kSRows][4]>(buf);
  const int32_t* src = p.pool + h.src;
  for (int i = threadIdx.x; i < kSTP * kSRows * 4; i += kThreads) {
    const int q = i / (kSRows * 4);
    const int y = (i / 4) % kSRows;
    const int c = i % 4;
    const Tile& t = tiles[q];
    if (!t.ok) continue;
    const int xq4 = t.spx + c * t.xs;
    const int x = t.x0 + (xq4 >> 4) - 3;
    const int32_t* s =
        src + static_cast<long long>(clampi(t.y0 - 3 + y, 0, t.chh - 1)) *
                  p.pwa;
    const int32_t* f = taps + t.fbase + (xq4 & 15) * 8;
    int acc = 0;
#pragma unroll
    for (int m = 0; m < 8; ++m) acc += f[m] * s[clampi(x + m, 0, t.cw - 1)];
    tmp[q][y][c] = clampi((acc + 64) >> 7, 0, p.maxv);
  }
  __syncthreads();
  const int q = threadIdx.x / 16;
  const Tile& t = tiles[q];
  if (!t.ok) return;
  const int r = (threadIdx.x / 4) % 4;
  const int c = threadIdx.x % 4;
  const int yq4 = t.spy + r * t.ys;
  const int32_t* f = taps + t.fbase + (yq4 & 15) * 8;
  int acc = 0;
#pragma unroll
  for (int m = 0; m < 8; ++m)
    acc += f[m] * tmp[q][clampi((yq4 >> 4) + m, 0, kSRows - 1)][c];
  out[0] = clampi((acc + 64) >> 7, 0, p.maxv);
}

__device__ void land_scaled(const Pass& p, int second, const Tile* tiles,
                            const int* out) {
  const Tile& t = tiles[threadIdx.x / 16];
  if (t.ok)
    land(p, 0, t.plane, t.dy + (threadIdx.x / 4) % 4, t.dx + threadIdx.x % 4,
         out[0], second);
}

// The mask phase's item: mi cells [kSegCells s, kSegCells (s + 1)) of mi
// row r of stream k, after the wait; bits the segment's mask bits.  A
// thread takes one row of one cell at a time, (8 >> ss_x) pixels as one
// or two 16-byte loads of F and of R (mc_table checks that wa is a
// multiple of 4 and that F and R start 16-byte aligned).
__device__ void mask_segment(const Pass& p, int k, int r, int s,
                             unsigned long long bits) {
  const int c0 = s * kSegCells;
  const int nc = min(kSegCells, p.mi_cols - c0);
  for (int plane = 0; plane < 3; ++plane) {
    const int sy = plane ? p.ssy : 0;
    const int sx = plane ? p.ssx : 0;
    const int gy = 8 >> sy;
    const int gx = 8 >> sx;
    const long long base = static_cast<long long>(3 * k + plane) * p.ha;
    for (int i = threadIdx.x; i < gy * nc; i += kThreads) {
      const int cell = i % nc;
      const int y = r * gy + i / nc;
      if (y >= p.ha || !((bits >> cell) & 1)) continue;
      const long long o = (base + y) * p.wa + (c0 + cell) * gx;
      for (int v = 0; v < gx; v += 4) {
        int4* fp = reinterpret_cast<int4*>(p.F + o + v);
        const int4 f = __ldcg(fp);
        const int4 q = *reinterpret_cast<const int4*>(p.R + o + v);
        *fp = make_int4(clampi(f.x + q.x, 0, p.maxv),
                        clampi(f.y + q.y, 0, p.maxv),
                        clampi(f.z + q.z, 0, p.maxv),
                        clampi(f.w + q.w, 0, p.maxv));
      }
    }
  }
}

// Device-scope acquire load of a done counter: no later load of this
// thread (nor, through the __syncthreads() after the wait, of its block)
// moves before it.
__device__ __forceinline__ int ld_acquire(const int* q) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(q)
               : "memory");
  return v;
}

// The persistent launch of the header.  ws[0] is the ticket,
// ws[kLine (j + 1)] phase j's done counter.  kWork false runs the same
// tickets, waits and publishes with no work: the schedule's floor.
template <bool kWork>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
mc_pass_kernel(const __grid_constant__ Pass p, int* ws) {
  __shared__ int32_t taps[kTaps];
  __shared__ int32_t buf[kBufWords];
  __shared__ Tile tiles[kSTP];
  __shared__ Head head;
  __shared__ int s_ticket;
  if (kWork)
    for (int i = threadIdx.x; i < kTaps; i += kThreads) taps[i] = p.kern[i];
  for (;;) {
    __syncthreads();  // the last item is done with the shared state
    if (threadIdx.x == 0) s_ticket = atomicAdd(ws, 1);
    __syncthreads();
    const int t = s_ticket;
    if (t >= p.n_items) return;
    int j = 0;
    while (j + 1 < p.n_phases && t >= p.ph[j + 1].first_item) ++j;
    const Phase& ph = p.ph[j];
    const int idx = t - ph.first_item;
    // MC: record group g of chunk c of stream k; mask: mi cell segment g
    // of mi row c of stream k
    const int g = idx % ph.groups;
    const int k = (idx / ph.groups) % p.n_streams;
    const int c = ph.c_lo + idx / ph.groups / p.n_streams;
    int out[kOut];
    if (kWork) {
      if (ph.kind < 0) {
        // the segment's mask words (16 cells each, low first)
        if (threadIdx.x == 0) {
          const int16_t* row =
              p.mask + k * p.stride + static_cast<long long>(c) * p.words;
          unsigned long long bits = 0;
#pragma unroll
          for (int i = 0; i < kSegCells / 16; ++i) {
            const int w = g * (kSegCells / 16) + i;
            if (w < p.words)
              bits |= static_cast<unsigned long long>(
                          static_cast<uint16_t>(row[w]))
                      << (16 * i);
          }
          head.bits = bits;
        }
      } else {
        // the header (thread 0) and the item's records (one a thread)
        const int16_t* rec =
            ph.rec + k * p.stride +
            static_cast<long long>(c) * ph.ch * (ph.kind == 0 ? 16 : 4);
        if (threadIdx.x == 0) read_head(p, ph, k, c, head);
        switch (ph.kind) {
          case 4:
            stage_tile(rec, ph.ch, g * Geom<4>::kTP, Geom<4>::kTP, tiles);
            break;
          case 8:
            stage_tile(rec, ph.ch, g * Geom<8>::kTP, Geom<8>::kTP, tiles);
            break;
          case 16:
            stage_tile(rec, ph.ch, g * Geom<16>::kTP, Geom<16>::kTP, tiles);
            break;
          case 32:
            stage_tile(rec, ph.ch, g * Geom<32>::kTP, Geom<32>::kTP, tiles);
            break;
          default:
            stage_scaled(p, rec, ph.ch, g * kSTP, kSTP, tiles);
        }
        __syncthreads();
        if (head.run) {
          switch (ph.kind) {
            case 4: predict<4>(p, head, tiles, taps, buf, out); break;
            case 8: predict<8>(p, head, tiles, taps, buf, out); break;
            case 16: predict<16>(p, head, tiles, taps, buf, out); break;
            case 32: predict<32>(p, head, tiles, taps, buf, out); break;
            default: predict_scaled(p, head, tiles, taps, buf, out);
          }
        }
      }
    }
    if (j > 0 && threadIdx.x == 0) {
      const int* prev = ws + kLine * j;
      const int want = p.ph[j - 1].n_items;
      for (int spins = 0; ld_acquire(prev) < want; ++spins) {
        if (spins == kMaxSpins) __trap();
        __nanosleep(20);
      }
    }
    // after the acquire; also makes head.bits visible
    __syncthreads();
    if (kWork) {
      if (ph.kind < 0) {
        if (head.bits) mask_segment(p, k, c, g, head.bits);
      } else if (head.run) {
        switch (ph.kind) {
          case 4: land_tiles<4>(p, head, k, ph.second, tiles, out); break;
          case 8: land_tiles<8>(p, head, k, ph.second, tiles, out); break;
          case 16: land_tiles<16>(p, head, k, ph.second, tiles, out); break;
          case 32: land_tiles<32>(p, head, k, ph.second, tiles, out); break;
          default: land_scaled(p, ph.second, tiles, out);
        }
      }
    }
    // every thread's pixel stores come before the publish
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      atomicAdd(ws + kLine * (j + 1), 1);
    }
  }
}

// Blocks of mc_pass_kernel<true> the current device holds resident at
// once, cached per device.
int resident_blocks(cudaError_t* err) {
  static int cached[64] = {};
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (!cached[dev]) {
    int per_sm = 0, sms = 0;
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, mc_pass_kernel<true>, kThreads, 0);
    if (*err == cudaSuccess)
      *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev);
    if (*err != cudaSuccess) return 0;
    cached[dev] = per_sm * sms;
  }
  return cached[dev];
}

int tiles_per_item(int kind) {
  return kind == 0    ? kSTP
         : kind == 4  ? Geom<4>::kTP
         : kind == 8  ? Geom<8>::kTP
         : kind == 16 ? Geom<16>::kTP
                      : Geom<32>::kTP;
}

// Fills p's phases from the host descriptors and the mask; returns 0 or
// a CUDA error code for a table the kernel does not take.
int fill(Pass& p, const long long* desc, int n_desc) {
  const int n_phases = n_desc + (p.mask != nullptr);
  if (n_desc < 0 || n_phases > kMaxPhases || p.n_streams <= 0 ||
      (p.mask && (p.mi_rows <= 0 || p.mi_cols <= 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  long long items = 0;
  for (int i = 0; i < n_desc; ++i) {
    const long long* d = desc + i * kDescWords;
    Phase& ph = p.ph[i];
    ph.kind = static_cast<int>(d[0]);
    if (ph.kind != 0 && ph.kind != 4 && ph.kind != 8 && ph.kind != 16 &&
        ph.kind != 32)
      return static_cast<int>(cudaErrorInvalidValue);
    ph.rec = reinterpret_cast<const int16_t*>(d[1]);
    ph.hdr = reinterpret_cast<const int16_t*>(d[2]);
    ph.r0 = reinterpret_cast<const int16_t*>(d[3]);
    ph.ch = static_cast<int>(d[4]);
    ph.c_lo = static_cast<int>(d[5]);
    ph.second = static_cast<int>(d[7]);
    const long long chunks = d[6] - d[5];
    if (ph.ch <= 0 || chunks <= 0 || ph.c_lo < 0)
      return static_cast<int>(cudaErrorInvalidValue);
    const int tp = tiles_per_item(ph.kind);
    ph.groups = (ph.ch + tp - 1) / tp;
    ph.first_item = static_cast<int>(items);
    items += chunks * p.n_streams * ph.groups;
    ph.n_items = static_cast<int>(items - ph.first_item);
    if (items > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (p.mask) {
    Phase& ph = p.ph[n_desc];
    ph = Phase{};
    ph.kind = -1;
    ph.groups = (p.mi_cols + kSegCells - 1) / kSegCells;
    ph.first_item = static_cast<int>(items);
    items += static_cast<long long>(p.mi_rows) * p.n_streams * ph.groups;
    ph.n_items = static_cast<int>(items - ph.first_item);
    if (items > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  }
  p.n_phases = n_phases;
  p.n_items = static_cast<int>(items);
  return 0;
}

// Zeroes the workspace and makes the launch on st.
template <bool kWork>
int run(const Pass& p, void* ws, void* stream, int* launched) {
  *launched = 0;
  if (p.n_items <= 0) return 0;
  cudaError_t err;
  const int resident = resident_blocks(&err);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (resident <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int grid = p.n_items < resident ? p.n_items : resident;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(ws, 0, kLine * (p.n_phases + 1) * sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  mc_pass_kernel<kWork><<<grid, kThreads, 0, st>>>(p, static_cast<int*>(ws));
  ++*launched;
  return static_cast<int>(cudaGetLastError());
}

template <bool kWork>
int pass(void* F, const void* R, int P, int ha, int wa, const void* pool,
         int S, int pha, int pwa, const void* kernels, const void* act,
         int n_streams, long long stride, const long long* desc, int n_desc,
         const void* mask, int mi_rows, int mi_cols, int ssx, int ssy, int bd,
         void* ws, void* stream, int* launched) {
  *launched = 0;
  Pass p{};
  p.F = static_cast<int32_t*>(F);
  p.R = static_cast<const int32_t*>(R);
  p.pool = static_cast<const int32_t*>(pool);
  p.act = static_cast<const int16_t*>(act);
  p.kern = static_cast<const int32_t*>(kernels);
  p.mask = static_cast<const int16_t*>(mask);
  p.stride = stride;
  p.P = P;
  p.ha = ha;
  p.wa = wa;
  p.S = S;
  p.pha = pha;
  p.pwa = pwa;
  p.n_streams = n_streams;
  p.maxv = (1 << bd) - 1;
  p.mi_rows = mi_rows;
  p.mi_cols = mi_cols;
  p.words = (mi_cols + 15) / 16;
  p.ssx = ssx;
  p.ssy = ssy;
  if (int err = fill(p, desc, n_desc)) return err;
  return run<kWork>(p, ws, stream, launched);
}

}  // namespace

// Runs the MC phases of one frame (n_streams 1) or of one batched round,
// then the mask phase, as one persistent launch on `stream`, in place on
// F [P, ha, wa] int32, from the pool [S, 3, pha, pwa] int32, the filter
// table kernels [4, 16, 8] int32 and the residual R [P, ha, wa] int32.
// act: the round's active stream indices (int16 [n_streams], on the
// device), or null.  stride: elements between two streams' flats.  desc:
// n_desc host descriptors of kDescWords int64 each, the MC phases in the
// order they run:
//
//   0 kind (4, 8, 16, 32; 0 the scaled 4x4 class)   1 stream 0's records
//   2 its chunk headers   3 its n_ref0 (device int16)
//   4 records a chunk     5-6 the phase's chunks [c_lo, c_hi)
//   7 1 for the compound seconds, 0 for the firsts
//
// mask: stream 0's mi_mask [mi_rows, ceil(mi_cols / 16)] int16 on the
// device, or null for no mask phase; chroma subsampling (ssx, ssy).  ws:
// int32 workspace of at least 32 (n_desc + 2) entries, zeroed here on the
// stream.  *launched counts the launches (1, or 0 with no phase).
// Returns the first CUDA error, or 0.
extern "C" int vp9_mc_pass(void* F, const void* R, int P, int ha, int wa,
                           const void* pool, int S, int pha, int pwa,
                           const void* kernels, const void* act,
                           int n_streams, long long stride,
                           const long long* desc, int n_desc,
                           const void* mask, int mi_rows, int mi_cols,
                           int ssx, int ssy, int bd, void* ws, void* stream,
                           int* launched) {
  return pass<true>(F, R, P, ha, wa, pool, S, pha, pwa, kernels, act,
                    n_streams, stride, desc, n_desc, mask, mi_rows, mi_cols,
                    ssx, ssy, bd, ws, stream, launched);
}

// The same launch as vp9_mc_pass on the same arguments (its grid,
// phases, items, tickets, waits and publishes) with no work per item:
// timed, the floor of the schedule.  Reads and writes no pixel.
extern "C" int vp9_mc_chain_floor(void* F, const void* R, int P, int ha,
                                  int wa, const void* pool, int S, int pha,
                                  int pwa, const void* kernels,
                                  const void* act, int n_streams,
                                  long long stride, const long long* desc,
                                  int n_desc, const void* mask, int mi_rows,
                                  int mi_cols, int ssx, int ssy, int bd,
                                  void* ws, void* stream, int* launched) {
  return pass<false>(F, R, P, ha, wa, pool, S, pha, pwa, kernels, act,
                     n_streams, stride, desc, n_desc, mask, mi_rows, mi_cols,
                     ssx, ssy, bd, ws, stream, launched);
}
