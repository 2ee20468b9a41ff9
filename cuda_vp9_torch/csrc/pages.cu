// Page expansion of the compacted upload, hand-written for Hopper.
//
// Replaces the gather of cuda_vp9_tpu/runtime/fused.py:513-518 (K5's page
// expansion, an XLA stage of the JAX step):
//   g    = page map of the flat, 0 meaning the all-zero page
//   flat = take(comb_pages, g, axis=0).reshape(-1)
// which rebuilds each frame's capacity-padded int16 flat from the nonzero
// 1 KB pages that the host sent (runtime/upload.py).  Here one launch
// rebuilds the flats of a whole upload: one frame, or every stream of a
// batched round, into out [n_flats, n_pages * 512] int16.
//
// The upload is one buffer of bytes on the device.  Its first 16 n_flats
// bytes are a table of two int64 per flat, byte offsets into the buffer:
//   map_off    the flat's page map, int32 [n_pages] (0: a zero page; i: the
//              i-th page at pages_off), or -1: the flat was sent dense;
//   pages_off  its pages, int16 [n, 512], 16-byte aligned (the nonzero
//              pages in order, or the whole flat when it was sent dense).
// The host writes the table with the pages (runtime/upload.py), so it
// arrives with them in the one host-to-device copy.
//
// What bounds it: bytes.  It reads the map and the nonzero pages once and
// writes every page of the flat once; a zero page costs its store and no
// read.  Design: one warp a page, a page is 64 16-byte vectors, so each
// lane loads and stores two int4 (a warp moves 1 KB in two coalesced
// 512-byte transactions); 8 warps a block, a grid-stride loop over the
// pages of every flat.  No shared memory, no synchronisation: pages are
// independent.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int VEC_PER_PAGE = 64;     // 1 KB / 16 bytes
constexpr int MAX_BLOCKS = 132 * 16;

__global__ void __launch_bounds__(THREADS)
expand_pages_kernel(const uint8_t* __restrict__ buf, int64_t n_pages,
                    int64_t total, int4* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t* table = reinterpret_cast<const int64_t*>(buf);
  const int4 zero = make_int4(0, 0, 0, 0);
  for (int64_t q = static_cast<int64_t>(blockIdx.x) * WARPS +
                   (threadIdx.x >> 5);
       q < total; q += static_cast<int64_t>(gridDim.x) * WARPS) {
    const int64_t k = q / n_pages, p = q - k * n_pages;
    const int64_t map_off = __ldg(table + 2 * k);
    const int64_t pages_off = __ldg(table + 2 * k + 1);
    int64_t row = p;                       // a dense flat: page p
    if (map_off >= 0) {
      const int32_t g =
          __ldg(reinterpret_cast<const int32_t*>(buf + map_off) + p);
      row = static_cast<int64_t>(g) - 1;   // -1: the zero page
    }
    int4* dst = out + q * VEC_PER_PAGE;
    if (row < 0) {
      dst[lane] = zero;
      dst[lane + 32] = zero;
    } else {
      const int4* src = reinterpret_cast<const int4*>(buf + pages_off) +
                        row * VEC_PER_PAGE;
      const int4 a = __ldg(src + lane), b = __ldg(src + lane + 32);
      dst[lane] = a;
      dst[lane + 32] = b;
    }
  }
}

}  // namespace

// Rebuilds n_flats flats of n_pages pages each into out (a device array of
// n_flats * n_pages * 512 int16, 16-byte aligned) from buf (a device array
// of bytes, 16-byte aligned, starting with the table above), on `stream`:
// one launch for all of them.  The caller checks the table's offsets.
// Sets *launched to the number of kernel launches made (1, or 0 when there
// is no page).  Returns the first CUDA error, 0 on success.
extern "C" int vp9_expand_pages(const void* buf, int n_flats,
                                int64_t n_pages, void* out, void* stream,
                                int* launched) {
  *launched = 0;
  if (n_flats < 0 || n_pages < 0) return cudaErrorInvalidValue;
  const int64_t total = static_cast<int64_t>(n_flats) * n_pages;
  if (total == 0) return 0;
  int64_t blocks = (total + WARPS - 1) / WARPS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  expand_pages_kernel<<<static_cast<int>(blocks), THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(buf), n_pages, total,
      static_cast<int4*>(out));
  ++*launched;
  return static_cast<int>(cudaGetLastError());
}
