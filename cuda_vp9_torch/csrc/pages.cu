// Page expansion of the compacted upload, hand-written for Hopper.
//
// Replaces the gather of cuda_vp9_tpu/runtime/fused.py:513-518 (K5's page
// expansion, an XLA stage of the JAX step):
//   g    = page map of the flat, 0 meaning the all-zero page
//   flat = take(comb_pages, g, axis=0).reshape(-1)
// which rebuilds each frame's capacity-padded int16 flat from the nonzero
// 1 KB pages that the host sent (runtime/upload.py).  Here one launch
// rebuilds the flats of a whole upload: one frame, or every stream of a
// batched round, into out [n_flats, n_pages * 512] int16.  Every page of
// every flat is written, zero pages included: the caller reuses out.
//
// The upload is one buffer of bytes on the device.  Each flat has two byte
// offsets into it:
//   map    the flat's page map, int32 [n_pages] (0: a zero page; i: the
//          i-th page at `pages`), or -1: the flat was sent dense;
//   pages  its pages, int16 [n, 512], 16-byte aligned (the nonzero pages
//          in order, or the whole flat when it was sent dense).
// The host wrote them (runtime/upload.py) and passes them from its own
// ints: the launch takes them as a __grid_constant__ parameter (at most
// kMaxFlats flats; the wrapper splits a larger upload into launches), so
// no page waits on a table read from device memory.
//
// What bounds it: bytes.  It reads the maps and the nonzero pages once and
// writes every page once; a zero page costs its store and no read.
// Design: a warp takes a run of kRun pages of one flat.  It reads the
// run's map entries in one coalesced load (a lane an entry), broadcasts
// them with shuffles, and issues the loads of every nonzero page of the
// run (two 16-byte vectors a lane, 1 KB a page) before any store; a zero
// page is two 16-byte stores of zeros a lane and no load.  Runs are short
// (2 pages) so that many warps are in flight: an inter frame is nearly all
// zero pages, and its stores alone set the pace; runs of 4, 8 and 16 pages
// were no faster on a keyframe and slower on an inter frame.  The stores are streaming
// (st.global.cs, evict-first in L2): they wrote a keyframe's 41 MB in
// about three quarters of the time plain stores took.  The grid is the
// blocks that are resident at once, each walking runs at a stride; a
// run's flat costs one 32-bit division, none per page.  No shared
// memory, no synchronisation: pages are independent.
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at its 700 W
// power limit, the launch alone on the device: 0.0148-0.0159 ms for
// hd01's keyframe (40157 pages, 7490 of them sent; 0.0146 ms at the
// memory rate), 0.0064-0.0066 ms for an inter frame, 0.0132-0.0141 ms
// for a round of 16 640x360 inter frames (the design before:
// 0.0192-0.0193, 0.0063-0.0064 and 0.0162-0.0163 ms in the same runs).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVecPerPage = 64;  // 1 KB / 16 bytes
constexpr int kRun = 2;          // pages of a warp's run (<= 32)
constexpr int kMaxFlats = 64;    // flats a launch takes: ops/cuda/pages.py
                                 // MAX_FLATS

struct Params {
  int64_t off[kMaxFlats][2];  // per flat: map, pages (byte offsets)
  int n_pages;                // pages a flat
  int runs;                   // runs a flat
  int total;                  // runs of the launch
};

__global__ void __launch_bounds__(kThreads)
expand_pages_kernel(const __grid_constant__ Params P,
                    const uint8_t* __restrict__ buf, int4* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int4 zero = make_int4(0, 0, 0, 0);
  for (int w = blockIdx.x * kWarps + (threadIdx.x >> 5); w < P.total;
       w += gridDim.x * kWarps) {
    const int k = w / P.runs;
    const int p0 = (w - k * P.runs) * kRun;
    const int n = min(kRun, P.n_pages - p0);
    const int64_t map_off = P.off[k][0];
    const int4* src = reinterpret_cast<const int4*>(buf + P.off[k][1]);
    // lane j < n: 1 + the row in src of the run's page j, 0 a zero page
    int g = 0;
    if (lane < n)
      g = map_off < 0
              ? p0 + lane + 1
              : __ldg(reinterpret_cast<const int32_t*>(buf + map_off) + p0 +
                      lane);
    int4* dst = out + (static_cast<size_t>(k) * P.n_pages + p0) * kVecPerPage;
    int4 v[kRun][2];
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      const int gj = __shfl_sync(0xffffffffu, g, j);
      if (gj > 0) {
        const int4* s = src + static_cast<size_t>(gj - 1) * kVecPerPage;
        v[j][0] = __ldg(s + lane);
        v[j][1] = __ldg(s + lane + 32);
      } else {
        v[j][0] = zero;
        v[j][1] = zero;
      }
    }
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      if (j < n) {
        int4* d = dst + j * kVecPerPage;
        __stcs(d + lane, v[j][0]);
        __stcs(d + lane + 32, v[j][1]);
      }
    }
  }
}

// *n = the blocks of expand_pages_kernel resident at once on the current
// device, read once per device.
cudaError_t resident_blocks(int* n) {
  static int cached[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!cached[dev]) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, expand_pages_kernel, kThreads, 0);
    if (err != cudaSuccess) return err;
    cached[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  *n = cached[dev];
  return cudaSuccess;
}

}  // namespace

// Rebuilds n_flats (1..kMaxFlats) flats of n_pages pages each into out (a
// device array of n_flats * n_pages * 512 int16, 16-byte aligned) from
// buf (a device array of bytes, 16-byte aligned), on `stream`, in one
// launch.  table is host memory: n_flats pairs of int64 (map, pages), the
// byte offsets above; the caller has checked them against buf.  Sets
// *launched to the number of kernel launches made (1, or 0 when there is
// no page).  Returns the first CUDA error, 0 on success.
extern "C" int vp9_expand_pages(const void* buf, const int64_t* table,
                                int n_flats, int64_t n_pages, void* out,
                                void* stream, int* launched) {
  *launched = 0;
  if (n_flats < 0 || n_flats > kMaxFlats || n_pages < 0 ||
      n_pages > (int64_t{1} << 24))
    return cudaErrorInvalidValue;
  if (n_flats == 0 || n_pages == 0) return 0;
  Params P;
  for (int k = 0; k < n_flats; ++k) {
    P.off[k][0] = table[2 * k];
    P.off[k][1] = table[2 * k + 1];
  }
  P.n_pages = static_cast<int>(n_pages);
  P.runs = static_cast<int>((n_pages + kRun - 1) / kRun);
  P.total = P.runs * n_flats;
  int resident = 0;
  const cudaError_t err = resident_blocks(&resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = (P.total + kWarps - 1) / kWarps;
  if (blocks > resident) blocks = resident;
  expand_pages_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      P, static_cast<const uint8_t*>(buf), static_cast<int4*>(out));
  ++*launched;
  return static_cast<int>(cudaGetLastError());
}
