// Fused FM scorer for Hopper (sm_90a): CUDA C++ behind a plain C entry point,
// loaded with ctypes by deepctr_torch/ops/kernels/interaction.py.
//
// Replaces the Pallas kernel deepctr_tpu/ops/pallas/interaction.py::
// _fm_scorer_fwd (body _kernel, entry fm_score_fused). For each example b of
// rows f32 [B, S, D] = (w | v), D = 1 + k, and mask f32 [B, S], with
// x = v * m:
//   lin   = sum_s w_s * m_s
//   S_f   = sum_s x_sf,  Q_f = sum_s x_sf^2
//   out_b = lin + 0.5 * sum_f (S_f^2 - Q_f)
// in f32 with f32 sums, as the reference's selection matmuls at HIGHEST
// precision compute it. The TPU's mechanism (rows flattened and padded to
// 128 lanes, the selection matrices A and a_w on the MXU, the TB tile rule)
// is not carried over: on the card this is a row reduction, on the CUDA
// cores (no tensor-core instruction).
//
// What bounds it on an H100: bytes, and at the training shape the launch.
// At [65536, 18, 11] a call reads 57 MB, 17 us at the card's 3.35 TB/s, for
// about 4 FLOP a float. At [8192, 18, 11] it is 7.1 MB, 2.1 us of bytes,
// which is what an empty kernel of the same grid takes between two events.
// To hold the memory rate against its latency the card wants some 2 MB in
// flight, about 17 KB an SM, and nothing between a tile's arrival and the
// next one's request.
//
// What the design does about it:
// - A tile of whole examples is one contiguous range of rows and one of
//   mask. Four persistent blocks an SM walk over the tiles (tile t to block
//   t mod grid). In each, one producer thread asks the copy engine for a
//   tile with two bulk copies (cp.async.bulk, completing on the stage's
//   "full" mbarrier) into a ring of kStages stages in dynamic shared memory,
//   as soon as the consumers have handed the stage back ("empty" mbarrier):
//   the next tile is in flight while one is reduced (eight tiles an SM, 110
//   KB at iPinYou's width), and no thread spends registers, address
//   arithmetic or a division on the copy. A block's reduce of a tile is a
//   chain of dependent adds, so what hides it is blocks, not stages:
//   measured on an H100 with csrc/tune_fm_score.py, four blocks of two
//   stages beat two blocks of four, and one block of four was slowest
//   (PERF.md, Findings).
// - The consumer warps reduce a stage in two steps around one named barrier:
//   one thread per (example, column) sums its column over the slots in slot
//   order and leaves lin (column 0) or S_f^2 - Q_f in shared memory; one
//   thread per example then adds the columns in column order and writes the
//   logit. The stage is handed back after the first step. The order of the
//   sums is fixed and depends on nothing but the example, not on the grid,
//   the SM count or which block takes which tile: two launches, and cards
//   with other SM counts, give the same bits (the train step's bitwise
//   repeatability rests on it). No atomics.
// - The examples a tile holds (a multiple of 4, so that its bytes are a
//   multiple of the copy engine's 16) follow from the shape: as many as fit
//   a stage, 16 at most, one (example, column) task a consumer thread at
//   most where that leaves 4 or more: 16 at iPinYou's [18, 11], 8 at
//   Criteo's [39, 17].
// - Bulk copies want 16-byte aligned addresses and sizes. The last, ragged
//   tile of a batch that is no multiple of the tile, and every tile of a
//   shape whose 4 examples do not fit a stage (S * (D + 1) > 2048), are read
//   by the consumer threads straight from device memory in the same two
//   steps (neighbouring threads read neighbouring columns); the wrapper
//   refuses base pointers that are not 16-byte aligned.
// FM_* macros override the tuning constants, for ablation builds
// (csrc/tune_fm_score.py).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "mbarrier.cuh"

#ifndef FM_CONSUMERS
#define FM_CONSUMERS 256
#endif
#ifndef FM_STAGES
#define FM_STAGES 2
#endif
#ifndef FM_STAGE_KB
#define FM_STAGE_KB 32
#endif
#ifndef FM_BLOCKS_PER_SM
#define FM_BLOCKS_PER_SM 4
#endif
#ifndef FM_MAX_ROWS
#define FM_MAX_ROWS 16
#endif

namespace {

using namespace hopper;

constexpr int kMaxD = 65;                        // 1 + k, k <= 64
constexpr int kConsumers = FM_CONSUMERS;         // consumer threads
constexpr int kThreads = kConsumers + 32;        // and the producer's warp
constexpr int kStages = FM_STAGES;               // tiles a block has in flight
constexpr int kStageBytes = FM_STAGE_KB * 1024;  // rows and mask of one tile
constexpr int kBlocksPerSm = FM_BLOCKS_PER_SM;
constexpr int kMaxRows = FM_MAX_ROWS;            // examples a tile at most
// (example, column) terms of one tile: a task a consumer thread, or 4
// examples of the widest row
constexpr int kTermFloats = kConsumers > 4 * kMaxD ? kConsumers : 4 * kMaxD;

static_assert(kConsumers % 32 == 0 && kConsumers >= kMaxD, "consumer warps");
static_assert(kStageBytes % 128 == 0 && kMaxRows % 4 == 0, "stage alignment");

struct Plan {
  int tile_rows;  // examples a tile
  bool ring;      // whole tiles come through the ring; else every tile is read by thread loads
  int blocks;
  size_t smem;    // dynamic shared memory: the ring
};

// Floats between two stages of the ring: a tile's rows and mask, rounded up
// to 128 bytes.
__host__ __device__ __forceinline__ int stage_stride(int tile_rows, int slots, int d) {
  return (tile_rows * slots * (d + 1) + 31) & ~31;
}

Plan make_plan(int batch, int slots, int d, int sms) {
  Plan p;
  const long long example_bytes = 4LL * slots * (d + 1);
  const int fit = static_cast<int>(kStageBytes / example_bytes) / 4 * 4;
  int by_threads = kConsumers / d / 4 * 4;
  if (by_threads < 4) by_threads = 4;
  p.tile_rows = fit < by_threads ? fit : by_threads;
  if (p.tile_rows > kMaxRows) p.tile_rows = kMaxRows;
  p.ring = p.tile_rows >= 4;
  if (!p.ring) p.tile_rows = kConsumers / d < kMaxRows ? kConsumers / d : kMaxRows;
  const int tiles = (batch + p.tile_rows - 1) / p.tile_rows;
  p.blocks = tiles < sms * kBlocksPerSm ? tiles : sms * kBlocksPerSm;
  p.smem = p.ring ? sizeof(float) * kStages * stage_stride(p.tile_rows, slots, d) : 0;
  return p;
}

// The consumer threads only (the producer's warp never joins): named
// barrier 1.
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

// Step one over a tile of n_rows examples at x ([n_rows][slots][d]) and m
// ([n_rows][slots]), in shared memory or (kGlobal) device memory: thread
// (example r, column c) sums its column over the slots in slot order;
// term[r * d + c] = lin for c = 0, S_c^2 - Q_c else.
template <bool kGlobal>
__device__ __forceinline__ void column_terms(const float* __restrict__ x,
                                             const float* __restrict__ m, int n_rows,
                                             int slots, int d, int tid,
                                             float* __restrict__ term) {
  for (int p = tid; p < n_rows * d; p += kConsumers) {
    const int r = p / d;
    const int c = p - r * d;
    const float* xs = x + static_cast<size_t>(r) * slots * d + c;
    const float* ms = m + static_cast<size_t>(r) * slots;
    float a = 0.0f;
    float q = 0.0f;
#pragma unroll 6
    for (int s = 0; s < slots; ++s) {
      const float v = kGlobal ? __ldg(xs + s * d) * __ldg(ms + s) : xs[s * d] * ms[s];
      a += v;
      q = fmaf(v, v, q);
    }
    term[p] = c == 0 ? a : a * a - q;
  }
}

// Step two: thread r adds its example's terms in column order.
__device__ __forceinline__ void example_sums(const float* __restrict__ term, int n_rows,
                                             int d, int tid, float* __restrict__ out) {
  for (int r = tid; r < n_rows; r += kConsumers) {
    const float* e = term + r * d;
    float inter = 0.0f;
    for (int c = 1; c < d; ++c) inter += e[c];
    out[r] = e[0] + 0.5f * inter;
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    fm_score_kernel(const float* __restrict__ rows, const float* __restrict__ mask,
                    int batch, int slots, int d, int tile_rows, int ring,
                    float* __restrict__ out) {
  extern __shared__ __align__(128) float stages[];  // [kStages][stage_stride]
  __shared__ __align__(8) uint64_t full[kStages];   // the stage's tile has landed
  __shared__ __align__(8) uint64_t empty[kStages];  // the consumer warps have read it
  __shared__ float term[2][kTermFloats];            // of this tile and the next

  const int tid = threadIdx.x;
  const int example = slots * d;  // floats of one example's rows
  const int tiles = (batch + tile_rows - 1) / tile_rows;
  const int whole = ring ? batch / tile_rows : 0;  // tiles 0 .. whole - 1 take the ring
  const int stride = stage_stride(tile_rows, slots, d);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // the producer: one thread keeps the ring full, in the order the
    // consumers take the tiles
    if (tid == kConsumers) {
      const uint32_t row_bytes = sizeof(float) * tile_rows * example;
      const uint32_t mask_bytes = sizeof(float) * tile_rows * slots;
      int i = 0;
      for (int t = blockIdx.x; t < whole; t += gridDim.x, ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(&empty[s], (i / kStages - 1) & 1);
        float* dst = stages + s * stride;
        mbar_arrive_expect(&full[s], row_bytes + mask_bytes);
        bulk_copy(dst, rows + static_cast<size_t>(t) * tile_rows * example, row_bytes,
                  &full[s]);
        bulk_copy(dst + tile_rows * example, mask + static_cast<size_t>(t) * tile_rows * slots,
                  mask_bytes, &full[s]);
      }
    }
    return;
  }

  int i = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++i) {
    const int row0 = t * tile_rows;
    const int n_rows = min(tile_rows, batch - row0);
    // term[i & 1] was last read two tiles ago, before the barrier of tile
    // i - 1, which every consumer has passed
    float* tm = term[i & 1];
    if (t < whole) {
      const int s = i % kStages;
      mbar_wait(&full[s], (i / kStages) & 1);
      const float* tile = stages + s * stride;
      column_terms<false>(tile, tile + tile_rows * example, n_rows, slots, d, tid, tm);
      __syncwarp();
      if ((tid & 31) == 0) mbar_arrive(&empty[s]);  // this warp has read the stage
    } else {
      column_terms<true>(rows + static_cast<size_t>(row0) * example,
                         mask + static_cast<size_t>(row0) * slots, n_rows, slots, d, tid, tm);
    }
    consumer_sync();
    example_sums(tm, n_rows, d, tid, out + row0);
  }
}

// A kernel that does nothing, launched with fm_score_kernel's grid, block
// and shared memory: the launch's share of a call's time.
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) fm_score_empty_kernel() {}

bool valid(int batch, int slots, int d) {
  return batch >= 1 && slots >= 1 && d >= 1 && d <= kMaxD;
}

// The SM count of the current device and, at a device's first call, both
// kernels' opt-in to the ring's dynamic shared memory (above 48 KB); 0 on
// failure.
int device_sms() {
  constexpr int kMaxDevices = 64;
  static bool opted[kMaxDevices] = {};
  int device = 0;
  int sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device < 0 || device >= kMaxDevices) return 0;
  if (!opted[device]) {
    const int bytes = kStages * kStageBytes;
    if (cudaFuncSetAttribute(fm_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes) != cudaSuccess ||
        cudaFuncSetAttribute(fm_score_empty_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes) != cudaSuccess) {
      return 0;
    }
    opted[device] = true;
  }
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) {
    return 0;
  }
  return sms;
}

}  // namespace

// rows: f32 [batch, slots, d] on the device, contiguous and 16-byte aligned;
// mask: f32 [batch, slots], the same; out: f32 [batch]. d = 1 + k with
// 1 <= d <= 65. Returns a cudaError_t code; 0 means launched.
extern "C" int fm_score_fwd(const void* rows, const void* mask, int batch,
                            int slots, int d, void* out, void* stream) {
  if (!valid(batch, slots, d) || reinterpret_cast<uintptr_t>(rows) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(mask) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  const int sms = device_sms();
  if (sms < 1) return cudaErrorInitializationError;
  const Plan p = make_plan(batch, slots, d, sms);
  fm_score_kernel<<<p.blocks, kThreads, p.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rows), static_cast<const float*>(mask), batch,
      slots, d, p.tile_rows, p.ring ? 1 : 0, static_cast<float*>(out));
  return cudaGetLastError();
}

// The launch fm_score_fwd makes at this shape, of a kernel that does
// nothing.
extern "C" int fm_score_empty(int batch, int slots, int d, void* stream) {
  if (!valid(batch, slots, d)) return cudaErrorInvalidValue;
  const int sms = device_sms();
  if (sms < 1) return cudaErrorInitializationError;
  const Plan p = make_plan(batch, slots, d, sms);
  fm_score_empty_kernel<<<p.blocks, kThreads, p.smem, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}

// The shape of that launch: examples a tile, whether whole tiles take the
// ring (else every tile is read by thread loads), stages, blocks, dynamic
// shared memory a block.
extern "C" int fm_score_launch_shape(int batch, int slots, int d, int* tile_rows,
                                     int* ring, int* stages, int* blocks, size_t* smem) {
  if (!valid(batch, slots, d)) return cudaErrorInvalidValue;
  const int sms = device_sms();
  if (sms < 1) return cudaErrorInitializationError;
  const Plan p = make_plan(batch, slots, d, sms);
  *tile_rows = p.tile_rows;
  *ring = p.ring ? 1 : 0;
  *stages = kStages;
  *blocks = p.blocks;
  *smem = p.smem;
  return 0;
}
