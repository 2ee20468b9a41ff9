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
// writes.  Chunks run in order: one grid per chunk, enqueued back to back
// on the caller's stream by the C entry point, so a frame (or a round of
// the batched step) is one host call.
//
// Layout.  One warp per unit, 4 units a block of 128 threads; the lanes
// stage the edges, then walk the bs x bs pixels (bs 32: 32 pixels a
// lane).  In the batched step unit j of a grid is record j % ich of chunk
// i of stream j / ich, its planes offset by 3 (j / ich), its block size
// read from that stream's chunk_bs[i], and a stream with fewer than i + 1
// chunks contributes padding.
//
// What bounds it.  A chunk is 64 or 256 units of at most 32x32 pixels:
// a few hundred KB of traffic, microseconds of work.  The chain of
// dependent launches bounds it (a 1080p keyframe has 2703 chunks), so the
// design keeps the launch loop in C and each grid small and simple; a
// single persistent launch with a barrier between chunks, or a CUDA
// graph, is the step after this one.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kUnitsPerBlock = 4;
constexpr int kThreads = 32 * kUnitsPerBlock;

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

// One grid: chunk `chunk` of every stream.  rec, cbs and cnt point at
// stream 0's intra records [cap, ich, 4], chunk_bs [cap] and chunk count
// (int16 each); stream k's lie rec_stride, cbs_stride and cnt_stride
// elements further.  bs_code >= 0 is the block size code of every
// record (single stream: the host's chunk_bs[chunk]); otherwise each
// stream's chunk_bs[chunk] gives it, and cnt marks the streams without a
// chunk `chunk` as padding.  F and R are [P, ha, wa] int32.
__global__ void __launch_bounds__(kThreads)
intra_chunk_kernel(int32_t* __restrict__ F, const int32_t* __restrict__ R,
                   const int16_t* __restrict__ rec, long long rec_stride,
                   const int16_t* __restrict__ cbs, long long cbs_stride,
                   const int16_t* __restrict__ cnt, long long cnt_stride,
                   int n_streams, int ich, int chunk, int bs_code, int P,
                   int ha, int wa, int bd) {
  __shared__ Edges edges[kUnitsPerBlock];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * kUnitsPerBlock + warp;
  if (j >= n_streams * ich) return;
  const int k = j / ich;
  const int16_t* u = rec + k * rec_stride + (static_cast<long long>(chunk) *
                                             ich + j % ich) * 4;
  int code = bs_code;
  bool keep = true;
  if (code < 0) {
    code = cbs[k * cbs_stride + chunk] & 3;
    keep = chunk < cnt[k * cnt_stride];
  }
  const int bs = 4 << code;
  const int w0 = u[0] & 0xFFFF;
  const int w1 = u[1] & 0xFFFF;
  const int w2 = u[2] & 0xFFFF;
  const int w3 = u[3];
  const int y0q = w1 & 0x7FFF;
  const int y0 = (y0q == 0 || !keep) ? -32768 : (y0q - 1) << 2;
  const int x0 = (w0 & 0x3FFF) << 2;
  const int plane = clampi((w0 >> 14) + 3 * k, 0, P - 1);
  const int mode = clampi(w2 & 15, 0, 9);
  const int n_above = (w2 >> 4) & 63;
  const int n_left = (w2 >> 10) & 63;
  const int tl_mode = w3 & 3;
  const bool have_up = (w1 >> 15) != 0;
  const bool have_left = ((w3 >> 2) & 1) != 0;
  const int base = 128 << (bd - 8);
  const int maxval = (1 << bd) - 1;

  const long long plane_off = static_cast<long long>(plane) * ha * wa;
  const int32_t* Fp = F + plane_off;
  const int ys = max(y0, 0);
  const int xs = x0;
  const int row_up = clampi(ys - 1, 0, ha - 1);
  const int col_left = clampi(xs - 1, 0, wa - 1);
  Edges& e = edges[warp];
  for (int i = lane; i < 2 * bs; i += 32) {
    e.A[i] = n_above > 0
                 ? Fp[static_cast<long long>(row_up) * wa +
                      min(xs + min(i, n_above - 1), wa - 1)]
                 : base - 1;
  }
  for (int i = lane; i < bs; i += 32) {
    e.L[i] = n_left > 0
                 ? Fp[static_cast<long long>(min(ys + min(i, n_left - 1),
                                                 ha - 1)) * wa + col_left]
                 : base + 1;
  }
  if (lane == 0) {
    e.tl = tl_mode == 0 ? Fp[static_cast<long long>(row_up) * wa + col_left]
                        : (tl_mode == 1 ? base + 1 : base - 1);
  }
  __syncwarp();

  int dc = base;
  if (mode == 0) {
    const int log2bs = code + 2;
    int sum_a = 0, sum_l = 0;
    for (int i = 0; i < bs; ++i) {
      sum_a += e.A[i];
      sum_l += e.L[i];
    }
    if (have_up && have_left)
      dc = (sum_a + sum_l + bs) >> (log2bs + 1);
    else if (have_up)
      dc = (sum_a + (bs >> 1)) >> log2bs;
    else if (have_left)
      dc = (sum_l + (bs >> 1)) >> log2bs;
  }
  const int32_t* Rp = R + plane_off;
  int32_t* Fw = F + plane_off;
  for (int p = lane; p < bs * bs; p += 32) {
    const int r = p >> (code + 2);
    const int c = p & (bs - 1);
    const int pred = predict(mode, r, c, bs, e, dc, maxval);
    const int col = xs + c;
    const int res = Rp[static_cast<long long>(min(ys + r, ha - 1)) * wa +
                       min(col, wa - 1)];
    const int row = y0 + r;
    if (row >= 0 && row < ha && col < wa)
      Fw[static_cast<long long>(row) * wa + col] =
          clampi(pred + res, 0, maxval);
  }
}

__global__ void empty_kernel() {}

}  // namespace

// Runs the intra chunks 0 .. n_chunks - 1 in order on `stream`, one grid
// each, in place on F [P, ha, wa] int32 with the residual R (same shape).
// Records, chunk_bs and chunk counts as intra_chunk_kernel takes them.
// host_bs: the host's chunk_bs (int16 [n_chunks]) when every record of
// a chunk shares its block size (the single-frame step, n_streams 1);
// null in the batched step, where each stream's chunk_bs on the device
// gives it.  *launched counts the grids enqueued.  Returns the first
// CUDA error, or 0.
extern "C" int vp9_intra_pass(void* F, const void* R, const void* rec,
                              long long rec_stride, const void* cbs,
                              long long cbs_stride, const void* cnt,
                              long long cnt_stride, int n_streams, int ich,
                              int n_chunks, const int16_t* host_bs, int P,
                              int ha, int wa, int bd, void* stream,
                              int* launched) {
  *launched = 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (n_streams * ich + kUnitsPerBlock - 1) / kUnitsPerBlock;
  for (int i = 0; i < n_chunks; ++i) {
    intra_chunk_kernel<<<blocks, kThreads, 0, st>>>(
        static_cast<int32_t*>(F), static_cast<const int32_t*>(R),
        static_cast<const int16_t*>(rec), rec_stride,
        static_cast<const int16_t*>(cbs), cbs_stride,
        static_cast<const int16_t*>(cnt), cnt_stride, n_streams, ich, i,
        host_bs ? (host_bs[i] & 3) : -1, P, ha, wa, bd);
    ++*launched;
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// Enqueues n launches of an empty kernel (one block of 32 threads) on
// `stream`, back to back as vp9_intra_pass enqueues its chunks: timed
// over many launches, the gap of one dependent launch with no work, the
// floor of a pass of n chunks.  Returns the first CUDA error, or 0.
extern "C" int vp9_empty_launches(int n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int i = 0; i < n; ++i) {
    empty_kernel<<<1, 32, 0, st>>>();
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
