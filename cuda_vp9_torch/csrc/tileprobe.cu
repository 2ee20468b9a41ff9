// Shared-memory tile probe, hand-written for Hopper.
//
// Replaces tools/profiling/pallas_probe.py `kernel` (its pl.pallas_call at
// line 110), the probe of the TPU primitives the loop-filter kernel was
// built on: a sequential grid of waves, scalar-prefetched superblock
// coordinates, dynamic-offset DMA of 72x72 tiles between device memory and
// fast memory, a transpose there, and a lane repeat of a mask row.  Here
// it asks the same question of Hopper: can a loop-filter block keep its
// superblock tile in shared memory, and move it with the tensor memory
// accelerator (TMA)?
//
// What it computes, per wave in wave order and per valid entry of the
// wave, with superblock coordinates (sbr, sbc) (the Pallas probe's are
// +1-encoded, 0 marking a padded entry):
//   tile   = frame[64 sbr : 64 sbr + 72, 64 sbc : 64 sbc + 72]
//   m[c]   = masks[8 sbr, c], c < 8
//   tileT  = transpose(tile)
//   acc[k] = sum over j = 0, 1 of (tileT[8 + j, 8 + k] + m[k / 8]), k < 64
//   tileT[8, 8:72] = acc;  tile = transpose(tileT);  store tile
// A later wave reads what an earlier wave stored.  The entries of one
// wave run in any order and their tiles may share apron pixels: in the
// probe's wave 1, (0, 1) and (1, 0) share the 8x8 block [64:72, 64:72].
// Each entry stores its whole tile, so the pixels an entry changes (column
// 8 of its tile, rows 8..71) must lie outside every other entry's tile of
// the wave; then every shared pixel is stored unchanged by each entry that
// holds it.  The wrapper (ops/cuda/tileprobe.py `build_table`) rejects
// other waves.
//
// Design: every wave in one launch.  The wrapper walks the entries once
// on the host, in wave order (the ticket order), and gives each entry the
// entries it must wait for: the latest earlier-wave entry at each of the
// 3x3 superblocks around it (a tile of side 72 at stride 64 meets only
// those, and each of those waited for the ones before it at its place).
// The table reaches the kernel as one __grid_constant__ parameter of at
// most kMaxEntries entries; the wrapper splits a longer table into
// launches, in order on the stream, and drops the waits on entries of an
// earlier launch.  Blocks take entries by an atomic ticket, so a block
// waits only on entries whose tickets come before its own, claimed by
// blocks that are already running: no residency order can deadlock.  The
// grid is the entries, or the blocks the card holds resident at once if
// fewer (then a block claims tickets until none is left).
// Thread 0 of the block spins on each awaited entry's done flag with
// ld.acquire.gpu (a wait that outlasts kMaxSpins polls traps instead of
// hanging), then loads the tile with one cp.async.bulk.tensor.2d from a
// 2-D tensor map of the frame into a 128-byte-aligned shared tile, which
// completes on an mbarrier; meanwhile 64 threads read the mask values
// with plain loads.  The block transposes into a padded tile (73-word
// rows: the column reads of the transpose fall on distinct banks), adds,
// transposes back into the TMA tile, and after fence.proxy.async thread 0
// stores the tile with one cp.async.bulk.tensor store, waits for the
// bulk group to complete, and publishes the entry's done flag with a
// fence and st.release.gpu.  The ticket of each launch and the flags live
// in an int32 workspace, one 128-byte line each, which the entry point
// zeroes on the stream before the first launch.  The tensor map is
// encoded on the host with cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint (no -lcuda), once per (frame pointer, shape).
//
// What bounds it: latency, not bytes or operations.  A call moves
// 2 x 20,736 bytes a tile; the probe's three waves form one chain three
// tiles deep (each entry's tile meets the one before it), so its floor is
// three tile steps; the launch, the workspace's memset and the wrapper's
// host time come on top.  Measured by chip_smoke.py on an NVIDIA H100 80GB
// HBM3 at its 700 W power limit: one entry 4.6 us on the device (the
// design before, a launch a wave with 16-byte cp.async: 3.3 us); the
// probe's 3 waves 11.9 us in one launch (3.3 us x 3 launches); 510
// entries of a 1088x1920 frame in 152 waves, a chain 62 tiles deep,
// 0.27 ms in 3 launches (0.55 ms in 152).  The wrapper's host time sets
// the call's window (0.04-0.10 ms for the probe's waves).

#include <cuda.h>  // CUtensorMap and the encoder's types (header only)
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int TS = 72;          // tile side
constexpr int TSP = TS + 1;     // padded row of the transposed tile
constexpr int THREADS = 256;
constexpr int kMaxEntries = 224;  // entries a launch takes:
                                  // ops/cuda/tileprobe.py MAX_ENTRIES
constexpr int kMaxDeps = 9;       // the 3x3 superblocks around an entry
constexpr int kLine = 32;         // ints per 128-byte workspace line
constexpr int kMaxSpins = 1 << 24;  // polls of a flag before a trap
constexpr uint32_t kTileBytes = TS * TS * sizeof(int32_t);

struct Entry {            // one entry, zero-based coordinates
  uint16_t sbr, sbc;
  uint8_t ndep;           // entries of this launch to wait for
  uint8_t dep[kMaxDeps];  // their indices in this launch
  uint8_t pad[2];
};
static_assert(sizeof(Entry) == 16, "Entry is 16 bytes");

struct Table {
  int n;                  // entries of this launch
  Entry e[kMaxEntries];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (int spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == kMaxSpins) __trap();
  }
}

__global__ void __launch_bounds__(THREADS)
tile_probe_kernel(const __grid_constant__ CUtensorMap fmap,
                  const __grid_constant__ Table T,
                  const int32_t* __restrict__ masks, int mask_cols,
                  int* ticket, int* done) {
  __shared__ __align__(128) int32_t tile[TS * TS];
  __shared__ int32_t tileT[TS * TSP];
  __shared__ __align__(8) uint64_t bar;
  __shared__ int s_ticket;
  const uint32_t bar_s = smem_u32(&bar);
  const uint32_t tile_s = smem_u32(tile);
  const uint64_t map = reinterpret_cast<uint64_t>(&fmap);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar_s)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  uint32_t parity = 0;
  for (;;) {
    // every thread has read the last s_ticket (the barrier before the
    // store) and sees the mbarrier's init
    if (threadIdx.x == 0) s_ticket = atomicAdd(ticket, 1);
    __syncthreads();
    const int t = s_ticket;
    if (t >= T.n) return;
    const Entry& e = T.e[t];
    const int x = 64 * e.sbc, y = 64 * e.sbr;
    if (threadIdx.x == 0) {
      for (int i = 0; i < e.ndep; ++i) {
        const int* f = done + kLine * e.dep[i];
        for (int spins = 0; ld_acquire(f) == 0; ++spins) {
          if (spins == kMaxSpins) __trap();
          __nanosleep(20);
        }
      }
      // the awaited tiles were stored through the async proxy, and this
      // load reads through it: order it after the acquires
      asm volatile("fence.proxy.async;" ::: "memory");
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
              bar_s),
          "r"(kTileBytes)
          : "memory");
      asm volatile(
          "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
          "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(tile_s),
          "l"(map), "r"(x), "r"(y), "r"(bar_s)
          : "memory");
    }
    // thread k < 64 owns column 8 + k of rows 8 and 9 of the transpose
    const int k = threadIdx.x;
    int m = 0;
    if (k < 64)
      m = __ldg(masks + static_cast<size_t>(8 * e.sbr) * mask_cols + (k >> 3));
    mbar_wait(bar_s, parity);
    parity ^= 1;
    for (int i = threadIdx.x; i < TS * TS; i += THREADS) {
      const int r = i / TS, c = i % TS;
      tileT[c * TSP + r] = tile[r * TS + c];
    }
    __syncthreads();
    if (k < 64) {
      // int32 wraps as the reference's does
      uint32_t acc = 0;
#pragma unroll
      for (int j = 0; j < 2; ++j)
        acc += static_cast<uint32_t>(tileT[(8 + j) * TSP + 8 + k]) +
               static_cast<uint32_t>(m);
      tileT[8 * TSP + 8 + k] = static_cast<int32_t>(acc);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < TS * TS; i += THREADS) {
      const int r = i / TS, c = i % TS;
      tile[r * TS + c] = tileT[c * TSP + r];
    }
    // each thread's writes to the tile, before the async proxy reads it
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) {
      asm volatile(
          "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group "
          "[%0, {%1, %2}], [%3];" ::"l"(map),
          "r"(x), "r"(y), "r"(tile_s)
          : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      // the store has landed in device memory (and has read the tile,
      // which the next ticket's load overwrites)
      asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
      asm volatile("fence.proxy.async;" ::: "memory");
      __threadfence();
      st_release(done + kLine * t, 1);
    }
    // with a block for every entry, no block claims a second ticket
    if (gridDim.x >= T.n) return;
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// Errors of the tensor map's encode, beside the CUDA runtime's codes.
constexpr int kNoEncoder = 100001;     // no encoder entry point
constexpr int kEncodeFailed = 100002;  // the encode refused the frame

// The tensor map of frame [H, W] int32 with 72x72 boxes, encoded once per
// (pointer, shape): the last one is kept.
int frame_map(void* frame, int H, int W, CUtensorMap* out) {
  static std::mutex mu;
  static EncodeTiled encode = nullptr;
  static void* last_ptr = nullptr;
  static int last_h = 0, last_w = 0;
  static CUtensorMap last_map;
  std::lock_guard<std::mutex> lock(mu);
  if (frame == last_ptr && H == last_h && W == last_w) {
    *out = last_map;
    return 0;
  }
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess) return static_cast<int>(err);
    if (q != cudaDriverEntryPointSuccess || !fn) return kNoEncoder;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(W) *
                                 sizeof(int32_t)};
  const cuuint32_t box[2] = {TS, TS};
  const cuuint32_t elem[2] = {1, 1};
  CUtensorMap m;
  const CUresult r = encode(
      &m, CU_TENSOR_MAP_DATA_TYPE_INT32, 2, frame, dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return kEncodeFailed;
  last_ptr = frame;
  last_h = H;
  last_w = W;
  last_map = m;
  *out = m;
  return 0;
}

// Blocks of tile_probe_kernel the current device holds resident at once,
// cached per device.
int resident_blocks(cudaError_t* err) {
  static int cached[64] = {};
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (!cached[dev]) {
    int per_sm = 0, sms = 0;
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, tile_probe_kernel, THREADS, 0);
    if (*err == cudaSuccess)
      *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev);
    if (*err != cudaSuccess) return 0;
    cached[dev] = per_sm * sms;
  }
  return cached[dev];
}

}  // namespace

// Runs the probe in place on frame [H, W] int32 (a device array whose
// rows are 16-byte aligned) on `stream`.  entries (host): n_entries rows
// of 12 ints, in ticket order: sbr, sbc (zero-based), the number of
// entries to wait for (at most 9), then their indices within the entry's
// launch (each before the entry's own).  sizes (host): the entries of each
// of n_launches launches, at most kMaxEntries each, summing to n_entries.
// masks [rows, mask_cols] int32 is a device array.  ws: int32 workspace of
// at least 32 (n_launches + n_entries) entries, zeroed here on the stream.
// The caller checks bounds and the waves.  Sets *launched to the number of
// kernel launches made.  Returns the first CUDA error (100001: no
// cuTensorMapEncodeTiled entry point; 100002: the encode failed), 0 on
// success.
extern "C" int vp9_tile_probe(void* frame, int H, int W, const int* entries,
                              int n_entries, const int* sizes,
                              int n_launches, const void* masks,
                              int mask_cols, void* ws, void* stream,
                              int* launched) {
  *launched = 0;
  if (n_entries <= 0) return 0;
  int total = 0;
  for (int l = 0; l < n_launches; ++l) {
    if (sizes[l] <= 0 || sizes[l] > kMaxEntries)
      return static_cast<int>(cudaErrorInvalidValue);
    total += sizes[l];
  }
  if (total != n_entries) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap fmap;
  int rc = frame_map(frame, H, W, &fmap);
  if (rc) return rc;
  cudaError_t err;
  const int resident = resident_blocks(&err);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (resident <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* w = static_cast<int*>(ws);
  err = cudaMemsetAsync(w, 0, sizeof(int) * kLine * (n_launches + n_entries),
                        st);
  if (err != cudaSuccess) return static_cast<int>(err);
  Table T;
  for (int l = 0, start = 0; l < n_launches; start += sizes[l++]) {
    T.n = sizes[l];
    for (int i = 0; i < T.n; ++i) {
      const int* row = entries + 12 * (start + i);
      Entry& e = T.e[i];
      if (row[2] < 0 || row[2] > kMaxDeps)
        return static_cast<int>(cudaErrorInvalidValue);
      e.sbr = static_cast<uint16_t>(row[0]);
      e.sbc = static_cast<uint16_t>(row[1]);
      e.ndep = static_cast<uint8_t>(row[2]);
      for (int j = 0; j < kMaxDeps; ++j) {
        const int d = j < row[2] ? row[3 + j] : 0;
        if (j < row[2] && (d < 0 || d >= i))
          return static_cast<int>(cudaErrorInvalidValue);
        e.dep[j] = static_cast<uint8_t>(d);
      }
      e.pad[0] = e.pad[1] = 0;
    }
    const int grid = T.n < resident ? T.n : resident;
    tile_probe_kernel<<<grid, THREADS, 0, st>>>(
        fmap, T, static_cast<const int32_t*>(masks), mask_cols,
        w + kLine * l, w + kLine * (n_launches + start));
    ++*launched;
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
