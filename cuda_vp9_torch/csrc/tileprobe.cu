// Shared-memory tile probe, hand-written for Hopper.
//
// Replaces tools/profiling/pallas_probe.py `kernel` (its pl.pallas_call at
// line 110), the probe of the TPU primitives the loop-filter kernel was
// built on: a sequential grid of waves, scalar-prefetched superblock
// coordinates, dynamic-offset DMA of 72x72 tiles between device memory and
// fast memory, a transpose there, and a lane repeat of a mask row.  Here
// it asks the same question of Hopper: can a loop-filter block keep its
// superblock tile in shared memory?
//
// What it computes, per wave w (one launch each) and per valid entry of
// the wave (one block each), with superblock coordinates (sbr, sbc) (the
// Pallas probe's are +1-encoded, 0 marking a padded entry):
//   tile   = frame[64 sbr : 64 sbr + 72, 64 sbc : 64 sbc + 72]
//   m[c]   = masks[8 sbr, c], c < 8
//   tileT  = transpose(tile)
//   acc[k] = sum over j = 0, 1 of (tileT[8 + j, 8 + k] + m[k / 8]), k < 64
//   tileT[8, 8:72] = acc;  tile = transpose(tileT);  store tile
// Every load of a block comes before its stores, as every load of a
// Pallas wave comes before its stores.  The blocks of one wave run in
// parallel and their tiles may overlap in the 8-pixel apron: in the
// probe's wave 1, (0, 1) and (1, 0) share the 8x8 block [64:72, 64:72].
// Each block stores its whole tile, so the pixels an entry changes (column
// 8 of its tile, rows 8..71) must lie outside every other entry's tile of
// the wave; then every shared pixel is stored unchanged by each block that
// holds it.  The wrapper (ops/cuda/tileprobe.py `_check`) rejects other
// waves.  The probe's waves and the anti-diagonals of the loop filter's
// superblock order pass.
//
// Design: the host passes each wave's entries to its launch as kernel
// parameters (the Pallas kernel's scalar prefetch), so a launch needs no
// copy and the host never waits.  Each block copies its tile (20,736
// bytes; rows are the frame's row stride apart, 16-byte aligned when the
// row is a multiple of 4 pixels) and its mask row into shared memory with
// 16-byte cp.async, transposes into a second, padded tile (73-word rows:
// the column reads of the transpose fall on distinct banks), adds,
// transposes back and stores with 16-byte writes.  What bounds it: the
// launch, not bytes or operations; a wave moves at most 4 x 2 x 20,736
// bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TS = 72;          // tile side
constexpr int TSP = TS + 1;     // padded row of the transposed tile
constexpr int MAXC = 128;       // widest mask row
constexpr int THREADS = 256;
constexpr int MAXW = 4;         // entries per wave

struct Wave {                   // one wave's valid entries, zero-based
  int sbr[MAXW];
  int sbc[MAXW];
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

__global__ void __launch_bounds__(THREADS)
tile_probe_wave(int32_t* __restrict__ frame, int W, const Wave wave,
                const int32_t* __restrict__ masks, int mask_cols) {
  __shared__ __align__(16) int32_t tile[TS * TS];
  __shared__ int32_t tileT[TS * TSP];
  __shared__ __align__(16) int32_t mrow[MAXC];

  const int sbr = wave.sbr[blockIdx.x], sbc = wave.sbc[blockIdx.x];
  int32_t* g = frame + static_cast<size_t>(64 * sbr) * W + 64 * sbc;

  constexpr int Q = TS / 4;  // 16-byte chunks per tile row
  for (int i = threadIdx.x; i < TS * Q; i += THREADS) {
    const int r = i / Q, q = i % Q;
    cp_async16(&tile[r * TS + 4 * q], g + static_cast<size_t>(r) * W + 4 * q);
  }
  const int32_t* mg = masks + static_cast<size_t>(8 * sbr) * mask_cols;
  for (int i = threadIdx.x; i < mask_cols / 4; i += THREADS)
    cp_async16(&mrow[4 * i], mg + 4 * i);
  cp_async_wait_all();
  __syncthreads();

  for (int i = threadIdx.x; i < TS * TS; i += THREADS) {
    const int r = i / TS, c = i % TS;
    tileT[c * TSP + r] = tile[r * TS + c];
  }
  __syncthreads();
  if (threadIdx.x < 64) {  // thread k owns column 8 + k of rows 8 and 9
    const int k = threadIdx.x;
    const int m = mrow[k >> 3];
    int acc = 0;
#pragma unroll
    for (int j = 0; j < 2; ++j) acc += tileT[(8 + j) * TSP + 8 + k] + m;
    tileT[8 * TSP + 8 + k] = acc;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TS * TS; i += THREADS) {
    const int r = i / TS, c = i % TS;
    tile[r * TS + c] = tileT[c * TSP + r];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TS * Q; i += THREADS) {
    const int r = i / Q, q = i % Q;
    *reinterpret_cast<int4*>(g + static_cast<size_t>(r) * W + 4 * q) =
        *reinterpret_cast<const int4*>(&tile[r * TS + 4 * q]);
  }
}

}  // namespace

// Runs the probe in place on frame [H, W] int32 (a device array): one
// launch per wave, on `stream`.  entries (host) holds each wave's valid
// entries as zero-based (sbr, sbc) pairs, counts[w] (host, at most 4) of
// them for wave w; masks [rows, mask_cols] int32 is a device array.  The
// caller checks alignment, bounds and overlap.  Sets *launched to the
// number of kernel launches made (one per non-empty wave).  Returns the
// first CUDA error, 0 on success.
extern "C" int vp9_tile_probe(void* frame, int W, const int* entries,
                              const int* counts, int n_waves,
                              const void* masks, int mask_cols,
                              void* stream, int* launched) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *launched = 0;
  if (mask_cols > MAXC || mask_cols % 4) return cudaErrorInvalidValue;
  for (int w = 0; w < n_waves; ++w) {
    const int n = counts[w];
    if (n > MAXW) return cudaErrorInvalidValue;
    Wave wave = {};
    for (int k = 0; k < n; ++k) {
      wave.sbr[k] = entries[2 * k];
      wave.sbc[k] = entries[2 * k + 1];
    }
    entries += 2 * n;
    if (n == 0) continue;
    tile_probe_wave<<<n, THREADS, 0, st>>>(
        static_cast<int32_t*>(frame), W, wave,
        static_cast<const int32_t*>(masks), mask_cols);
    ++*launched;
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
