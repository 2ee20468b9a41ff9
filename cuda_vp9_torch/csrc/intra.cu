// VP9 intra wavefront (K4), hand-written for Hopper: `vp9_intra_pass`.
//
// Replaces the XLA stage of cuda_vp9_tpu/runtime/fused.py `_intra_pass`
// (:452) -> `_intra_chunk` (:433) -> ops/device/stages.py `intra_wave`
// (:161) and `_predictors` (:34), in the single-frame step and in the
// batched step (its vmap written out as a stream axis).  Per chunk of
// 4-int16 records it unpacks each record
//
//   w0 = x0/4 | plane << 14
//   w1 = (y0/4 + 1) | have_up << 15      (y0/4 + 1 == 0: padding)
//   w2 = mode | n_above << 4 | n_left << 10
//   w3 = tl_mode | have_left << 2
//
// builds the unit's above row (2 bs pixels), left column (bs) and
// top-left pixel with the availability fill of the plain twin
// (cuda_vp9_torch/ops/device/stages.py): n_above == 0 gives base - 1,
// n_left == 0 base + 1, indices past n - 1 replicate the last valid
// pixel, tl_mode 0/1/2 reads the frame / base + 1 / base - 1, every
// gather clamped into the plane), predicts with one of the 10 modes in
// closed form per pixel, adds the residual, clips to the bit depth and
// writes the unit into the frame; rows outside the plane, and padded
// records, write nothing.
//
// Order.  The twin gathers every unit's edges before it writes any unit
// of the chunk.  Here a unit stages its own edges in shared memory before
// it writes, and units of one chunk run in parallel: that relies on the
// packer's rule that a chunk holds units of one wave and one block size
// (runtime/pack.py), so no unit reads a pixel another unit of its chunk
// writes.  Chunks form a chain: the wire does not carry the wave, so a
// chunk may read what the chunk before it wrote, and chunk i starts only
// once chunk i - 1 is done.
//
// Schedule.  One persistent launch per call (a frame, or a round of the
// batched step), its grid what the card holds resident at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x the SMs), capped at
// the item count.  An item is 4 units of one chunk, one warp each; chunk
// i has items_per_chunk = ceil(n_streams ich / 4) items, numbered i
// items_per_chunk + m.  A block claims the next item with an atomic
// ticket and stages what needs no earlier chunk (each unit's record, and
// its residual block into shared memory); then, before its first pixel
// read, an item of chunk i > 0 waits until chunk i - 1's done counter
// reaches items_per_chunk (thread 0 polls it with ld.acquire.gpu, then a
// __syncthreads), and after its last pixel write it publishes (__syncthreads, __threadfence, atomicAdd on chunk
// i's counter).  A block only waits on items whose tickets come before
// its own, claimed by blocks that are already running, so no residency
// order can deadlock; a wait that outlasts kMaxSpins polls is a fault (a
// workspace that was not zeroed) and traps instead of hanging.  The
// ticket and the counters live in an int32 workspace, one 128-byte line
// each so that polls of one counter do not contend with adds to the next,
// which the entry point zeroes on the stream before the launch.  The
// loop filter's row walker (csrc/loopfilter.cu) keeps the same rules.
//
// Layout.  One warp per unit, 4 units a block of 128 threads; the lanes
// stage the residual block (before the wait) and the edges (after it),
// then walk the bs x bs pixels (bs 32: 32 pixels a lane).  Unit j of chunk i is record j % ich of stream j / ich, its
// planes offset by 3 (j / ich), its block size read from that stream's
// chunk_bs[i] on the device (one stream or A: one form), and a stream
// with fewer than i + 1 chunks (cnt) contributes padding.
//
// What bounds it.  A chunk is 64 or 256 units of at most 32x32 pixels:
// a few hundred KB of traffic, microseconds of work, against a bound of
// 0.01 ms for a whole 1080p keyframe.  The chain of chunks bounds it (a
// 1080p keyframe has 2703): with no launch between two chunks, the floor
// is n_chunks hand-offs (a publish seen by the next chunk's waiters),
// which `vp9_intra_chain_floor` times by running the same chain with no
// work per item; `vp9_empty_launches` keeps the floor of the design
// before it (one dependent launch per chunk) measurable beside it.  What
// a chunk adds to its hand-off is the edges' loads, which must follow
// the acquire, the pixel walk of its largest unit and the publish's
// fence; the residual's loads, staged before the wait, are off that
// path.  Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at its
// 700 W power limit: hd01's 1080p keyframe (2703 chunks of 256) 7.74 ms,
// 2.86 us a chunk, against a hand-off floor of 1.00 us a chunk and 3.43
// us a chunk for one dependent empty launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kUnitsPerBlock = 4;  // an item: one warp per unit
constexpr int kThreads = 32 * kUnitsPerBlock;
constexpr int kLine = 32;           // ints per 128-byte workspace line
constexpr int kMaxSpins = 1 << 24;  // polls of a done counter before a trap

__device__ __forceinline__ int avg2(int a, int b) { return (a + b + 1) >> 1; }

__device__ __forceinline__ int avg3(int a, int b, int c) {
  return (a + 2 * b + c + 2) >> 2;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// One staged unit: A[0, 2 bs) above (availability-filled), L[0, bs) left,
// tl the top-left.
struct Edges {
  int A[64];
  int L[32];
  int tl;
};

// The prediction of pixel (r, c) of a bs x bs unit in mode `mode` (0..9),
// term for term the twin's `_predictors`; dc is the DC value.
__device__ int predict(int mode, int r, int c, int bs, const Edges& e,
                       int dc, int maxval) {
  const int* A = e.A;
  const int* L = e.L;
  const int tl = e.tl;
  const int a_last = 2 * bs - 1;
  switch (mode) {
    case 0:
      return dc;
    case 1:
      return A[c];
    case 2:
      return L[r];
    case 3: {  // D45
      const int idx = r + c;
      const int lim = bs == 4 ? 6 : bs - 1;
      if (idx >= lim) return bs == 4 ? A[7] : A[bs - 1];
      return avg3(A[min(idx, a_last)], A[min(idx + 1, a_last)],
                  A[min(idx + 2, a_last)]);
    }
    case 4: {  // D135: AVG3 over [L[bs-1..0], tl, A[0..bs-1]]
      const int j = (bs - 1) - r + c;
      int s[3];
      for (int k = 0; k < 3; ++k) {
        const int q = j + k;
        s[k] = q < bs ? L[bs - 1 - q] : (q == bs ? tl : A[q - bs - 1]);
      }
      return avg3(s[0], s[1], s[2]);
    }
    case 5: {  // D117
      const int t = min(r >> 1, c);
      const int rp = r - 2 * t;
      const int cp = c - t;
      // Am1[k] = A[k - 1] (tl at 0), Lm[k] = L[k - 1] (tl at 0)
      auto am1 = [&](int k) { return k == 0 ? tl : A[k - 1]; };
      auto lm = [&](int k) { return k == 0 ? tl : L[k - 1]; };
      if (rp == 0) return avg2(am1(cp), am1(cp + 1));
      if (rp == 1) {
        if (cp == 0) return avg3(L[0], tl, A[0]);
        return avg3(cp == 1 ? tl : A[cp - 2], am1(cp), A[cp]);
      }
      if (rp == 2) return avg3(tl, L[0], L[1]);
      return avg3(lm(max(rp - 3, -1) + 1), lm(max(rp - 2, 0) + 1),
                  lm(max(rp - 1, 0) + 1));
    }
    case 6: {  // D153
      const int t = min(r, c >> 1);
      const int rp = r - t;
      const int cp = c - 2 * t;
      auto am1 = [&](int k) { return k == 0 ? tl : A[k - 1]; };
      if (cp == 0) {
        if (rp == 0) return avg2(tl, L[0]);
        return avg2(L[max(rp - 1, 0)], L[clampi(rp, 1, bs - 1)]);
      }
      if (cp == 1) {
        if (rp == 0) return avg3(L[0], tl, A[0]);
        if (rp == 1) return avg3(tl, L[0], L[1]);
        return avg3(L[max(rp - 2, 0)], L[max(rp - 1, 0)],
                    L[clampi(rp, 2, bs - 1)]);
      }
      return avg3(am1(max(cp - 3, -1) + 1), am1(max(cp - 2, -1) + 1),
                  am1(max(cp - 1, -1) + 1));
    }
    case 7: {  // D207: L extended by its last pixel
      const int v = r + (c >> 1);
      if (v >= bs - 1) return L[bs - 1];
      const int l0 = L[v], l1 = L[min(v + 1, bs - 1)];
      if ((c & 1) == 0) return avg2(l0, l1);
      return avg3(l0, l1, L[min(v + 2, bs - 1)]);
    }
    case 8: {  // D63: A extended by its last pixel
      const int i = c + (r >> 1);
      if (bs != 4 && r >= 2 && i > bs - 2) return A[bs - 1];
      const int a0 = A[min(i, a_last)], a1 = A[min(i + 1, a_last)];
      if (r & 1) return avg3(a0, a1, A[min(i + 2, a_last)]);
      return avg2(a0, a1);
    }
    default:  // TM
      return clampi(L[r] + A[c] - tl, 0, maxval);
  }
}

// The pass's arguments.  rec, cbs and cnt point at stream 0's intra
// records [cap, ich, 4], chunk_bs [cap] and chunk count (int16 each);
// stream k's lie rec_stride, cbs_stride and cnt_stride elements further.
// cnt null: every stream has n_chunks chunks.  F and R are [P, ha, wa]
// int32.
struct Pass {
  int32_t* F;
  const int32_t* R;
  const int16_t* rec;
  const int16_t* cbs;
  const int16_t* cnt;
  long long rec_stride, cbs_stride, cnt_stride;
  int n_streams, ich, n_chunks, items_per_chunk, P, ha, wa, bd;
};

// One unit's record, decoded: what a warp keeps in registers between
// staging the unit and finishing it.
struct Unit {
  long long plane_off;
  int code, y0, x0, mode, n_above, n_left, tl_mode;
  bool have_up, have_left;
};

// Stage unit j of chunk `chunk` with one warp, before the chain reaches
// the chunk: decode its record and copy its residual block (rows and
// columns clamped into the plane, as the twin's gather) into Rs, which
// no earlier chunk writes.  Returns false for a padded record (or a
// stream without the chunk), which writes nothing.
__device__ bool intra_stage(const Pass& p, int chunk, int j, Unit& u,
                            int32_t* Rs, int lane) {
  const int k = j / p.ich;
  const int16_t* r = p.rec + k * p.rec_stride +
                     (static_cast<long long>(chunk) * p.ich + j % p.ich) * 4;
  const int w1 = r[1] & 0xFFFF;
  if ((w1 & 0x7FFF) == 0 ||
      (p.cnt != nullptr && chunk >= p.cnt[k * p.cnt_stride]))
    return false;
  const int w0 = r[0] & 0xFFFF;
  const int w2 = r[2] & 0xFFFF;
  const int w3 = r[3];
  u.code = p.cbs[k * p.cbs_stride + chunk] & 3;
  u.y0 = ((w1 & 0x7FFF) - 1) << 2;
  u.x0 = (w0 & 0x3FFF) << 2;
  u.plane_off = static_cast<long long>(clampi((w0 >> 14) + 3 * k, 0,
                                              p.P - 1)) * p.ha * p.wa;
  u.mode = clampi(w2 & 15, 0, 9);
  u.n_above = (w2 >> 4) & 63;
  u.n_left = (w2 >> 10) & 63;
  u.tl_mode = w3 & 3;
  u.have_up = (w1 >> 15) != 0;
  u.have_left = ((w3 >> 2) & 1) != 0;
  const int bs = 4 << u.code;
  const int32_t* Rp = p.R + u.plane_off;
  for (int q = lane; q < bs * bs; q += 32) {
    const int row = min(u.y0 + (q >> (u.code + 2)), p.ha - 1);
    Rs[q] = Rp[static_cast<long long>(row) * p.wa +
               min(u.x0 + (q & (bs - 1)), p.wa - 1)];
  }
  return true;
}

// Finish a staged unit with its warp, once the chunk before it is done:
// stage the edges in e, then predict, add the residual, clip and write.
__device__ void intra_finish(const Pass& p, const Unit& u, Edges& e,
                             const int32_t* Rs, int lane) {
  const int code = u.code;
  const int bs = 4 << code;
  const int base = 128 << (p.bd - 8);
  const int maxval = (1 << p.bd) - 1;
  const int ha = p.ha, wa = p.wa;
  const int32_t* Fp = p.F + u.plane_off;
  const int ys = u.y0;
  const int xs = u.x0;
  const int row_up = clampi(ys - 1, 0, ha - 1);
  const int col_left = clampi(xs - 1, 0, wa - 1);
  for (int i = lane; i < 2 * bs; i += 32) {
    e.A[i] = u.n_above > 0
                 ? Fp[static_cast<long long>(row_up) * wa +
                      min(xs + min(i, u.n_above - 1), wa - 1)]
                 : base - 1;
  }
  for (int i = lane; i < bs; i += 32) {
    e.L[i] = u.n_left > 0
                 ? Fp[static_cast<long long>(min(ys + min(i, u.n_left - 1),
                                                 ha - 1)) * wa + col_left]
                 : base + 1;
  }
  if (lane == 0) {
    e.tl = u.tl_mode == 0
               ? Fp[static_cast<long long>(row_up) * wa + col_left]
               : (u.tl_mode == 1 ? base + 1 : base - 1);
  }
  __syncwarp();

  int dc = base;
  if (u.mode == 0) {
    const int log2bs = code + 2;
    int sum_a = 0, sum_l = 0;
    for (int i = 0; i < bs; ++i) {
      sum_a += e.A[i];
      sum_l += e.L[i];
    }
    if (u.have_up && u.have_left)
      dc = (sum_a + sum_l + bs) >> (log2bs + 1);
    else if (u.have_up)
      dc = (sum_a + (bs >> 1)) >> log2bs;
    else if (u.have_left)
      dc = (sum_l + (bs >> 1)) >> log2bs;
  }
  int32_t* Fw = p.F + u.plane_off;
  for (int q = lane; q < bs * bs; q += 32) {
    const int r = q >> (code + 2);
    const int c = q & (bs - 1);
    const int pred = predict(u.mode, r, c, bs, e, dc, maxval);
    const int row = ys + r;
    const int col = xs + c;
    if (row < ha && col < wa)
      Fw[static_cast<long long>(row) * wa + col] =
          clampi(pred + Rs[q], 0, maxval);
  }
}

// Device-scope acquire load of a done counter: no later load of this
// thread (nor, through the __syncthreads() after the wait, of its block)
// moves before it.
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

// The persistent chain of the header.  ws[0] is the ticket, ws[kLine (i +
// 1)] chunk i's done counter.  kWork false runs the chain alone (tickets,
// waits and publishes, no pixel): the hand-off floor.
template <bool kWork>
__global__ void __launch_bounds__(kThreads)
intra_pass_kernel(const __grid_constant__ Pass p, int* ws) {
  __shared__ Edges edges[kUnitsPerBlock];
  __shared__ int32_t res[kUnitsPerBlock][32 * 32];
  __shared__ int s_ticket;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ipc = p.items_per_chunk;
  const int n_items = p.n_chunks * ipc;
  for (;;) {
    __syncthreads();  // every thread has read the last round's s_ticket
    if (threadIdx.x == 0) s_ticket = atomicAdd(ws, 1);
    __syncthreads();
    const int t = s_ticket;
    if (t >= n_items) return;
    const int chunk = t / ipc;
    // the record and the residual need no earlier chunk: staged while
    // the chain is still on the chunks before this one
    const int j = (t - chunk * ipc) * kUnitsPerBlock + warp;
    Unit u;
    const bool live = kWork && j < p.n_streams * p.ich &&
                      intra_stage(p, chunk, j, u, res[warp], lane);
    if (chunk > 0) {
      if (threadIdx.x == 0) {
        const int* prev = ws + kLine * chunk;
        for (int spins = 0; ld_acquire(prev) < ipc; ++spins) {
          if (spins == kMaxSpins) __trap();
          __nanosleep(20);
        }
      }
      // the other threads read chunk i - 1's pixels only after the acquire
      __syncthreads();
    }
    if (live) intra_finish(p, u, edges[warp], res[warp], lane);
    // every thread's pixel stores come before the publish
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      atomicAdd(ws + kLine * (chunk + 1), 1);
    }
  }
}

__global__ void empty_kernel() {}

// Blocks of intra_pass_kernel<true> the current device holds resident at
// once, cached per device.
int resident_blocks(cudaError_t* err) {
  static int cached[64] = {};
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (!cached[dev]) {
    int per_sm = 0, sms = 0;
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, intra_pass_kernel<true>, kThreads, 0);
    if (*err == cudaSuccess)
      *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev);
    if (*err != cudaSuccess) return 0;
    cached[dev] = per_sm * sms;
  }
  return cached[dev];
}

// Zeroes the workspace and launches the chain of n_chunks chunks on st.
template <bool kWork>
int run_chain(const Pass& p, void* ws, void* stream, int* launched) {
  *launched = 0;
  if (p.n_chunks <= 0 || p.items_per_chunk <= 0) return 0;
  cudaError_t err;
  const int resident = resident_blocks(&err);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (resident <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long n_items =
      static_cast<long long>(p.n_chunks) * p.items_per_chunk;
  if (n_items > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(n_items < resident ? n_items : resident);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(ws, 0, kLine * (p.n_chunks + 1) * sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  intra_pass_kernel<kWork><<<grid, kThreads, 0, st>>>(p,
                                                      static_cast<int*>(ws));
  ++*launched;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Runs the intra chunks 0 .. n_chunks - 1 of n_streams streams in order,
// in place on F [P, ha, wa] int32 with the residual R (same shape), as
// one persistent launch on `stream`.  Records, chunk_bs and chunk counts
// as Pass takes them (cnt may be null).  ws: int32 workspace of at least
// 32 (n_chunks + 1) entries, zeroed here on the stream.  *launched counts
// the launches (1, or 0 when there is no chunk).  Returns the first CUDA
// error, or 0.
extern "C" int vp9_intra_pass(void* F, const void* R, const void* rec,
                              long long rec_stride, const void* cbs,
                              long long cbs_stride, const void* cnt,
                              long long cnt_stride, int n_streams, int ich,
                              int n_chunks, int P, int ha, int wa, int bd,
                              void* ws, void* stream, int* launched) {
  const Pass p{static_cast<int32_t*>(F),
               static_cast<const int32_t*>(R),
               static_cast<const int16_t*>(rec),
               static_cast<const int16_t*>(cbs),
               static_cast<const int16_t*>(cnt),
               rec_stride,
               cbs_stride,
               cnt_stride,
               n_streams,
               ich,
               n_chunks,
               (n_streams * ich + kUnitsPerBlock - 1) / kUnitsPerBlock,
               P,
               ha,
               wa,
               bd};
  return run_chain<true>(p, ws, stream, launched);
}

// The same chain of n_chunks chunks of n_streams x ich units (its grid,
// tickets, waits and publishes) with no work per item: timed, the
// hand-off floor of a pass, n_chunks hand-offs.  Workspace, stream and
// result as vp9_intra_pass.
extern "C" int vp9_intra_chain_floor(int n_streams, int ich, int n_chunks,
                                     void* ws, void* stream, int* launched) {
  Pass p{};
  p.n_streams = n_streams;
  p.ich = ich;
  p.n_chunks = n_chunks;
  p.items_per_chunk = (n_streams * ich + kUnitsPerBlock - 1) / kUnitsPerBlock;
  return run_chain<false>(p, ws, stream, launched);
}

// Enqueues n launches of an empty kernel (one block of 32 threads) on
// `stream`, back to back: timed over many launches, the gap of one
// dependent launch with no work, the floor of the design that enqueued
// one grid per chunk.  Returns the first CUDA error, or 0.
extern "C" int vp9_empty_launches(int n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int i = 0; i < n; ++i) {
    empty_kernel<<<1, 32, 0, st>>>();
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
