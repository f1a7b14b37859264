// The dense layers' backward products for Hopper (sm_90a): CUDA C++ behind a
// plain C entry point, loaded with ctypes by deepctr_torch/ops/kernels/dense.py.
//
// Replaces no TPU kernel: DLRM-DCNv2 (models/dlrm.py) has no counterpart in
// deepctr_tpu, and its dense layers (ops/layers.py) ran every product on
// cuBLAS in float32, which is the yardstick. This kernel takes the two
// products of a layer's backward, in float32 by the 3xTF32 split:
// - the input gradient gx = g . w^T: C [M, N] = A [M, K] . B [N, K]^T with
//   A = g [B, out] and B = w [in, out], both K-major (kKMajor);
// - the weight gradient gw = x^T . g: C [M, N] = A [K, M]^T . B [K, N] with
//   A = x [B, in] and B = g [B, out], both MN-major: K is the batch.
// The ReLU mask and the bias gradient stay in PyTorch, in their plain order.
//
// What bounds it on an H100: operations. At the benchmark cell's widths
// (batch 8192; bottom 13-512-256-128, three cross layers 3456 <-> 512, top
// 3456-1024-1024-512-256-1) the kernel takes 24 of a step's 27 backward
// products, 525 GFLOP, against some 2 GB of operands and outputs: 3.18 ms at
// the 3xTF32 rate of 165 TFLOP/s (the TF32 tensor cores' 495 over three),
// 0.6 ms at 3.35 TB/s. cuBLAS's f32 products run on the CUDA cores, below
// their 67 TFLOP/s.
//
// What the design does about it: a persistent Hopper GEMM on the tensor
// cores, at 88-98 TFLOP/s (53-59% of the bound) on the cell's large products
// on an H100 (PERF.md).
// - Each product is cut into 128 x 128 output tiles and, where too few tiles
//   would fill the card (a weight gradient's K = 8192 against a small
//   output), its depth into a fixed number of slices (the wrapper chooses
//   it from the shape and the SM count). Blocks, one an SM, walk the (tile,
//   slice) units in a fixed order. A slice writes its partial tile into a
//   workspace and a second kernel sums the slices in slice order: no float
//   atomics, so two calls give the same bits.
// - A producer warpgroup keeps a ring of kStages stages filled, 32 of depth
//   a stage: A's 128 x 32 block by cp.async into a padded tile, and B's block
//   through registers, split into hi = rna_tf32(x) and lo = rna_tf32(x - hi)
//   (tower_tile.cuh's split_tf32, with its NaN and overflow rules) and
//   stored as the K-major hi and lo images TF32 wgmma reads. B's loads are
//   issued two stages ahead of its stores. In the weight gradient B arrives
//   MN-major: a thread loads four rows of four columns and stores them as
//   four K-major quads, so the one pass over the block splits and transposes
//   it.
// - Two consumer warpgroups own 64 rows of the tile each. A comes from
//   registers: each thread loads its fragment of the stage's A block (any
//   layout will do, which is how the MN-major A needs no transpose) and
//   splits it there; B from the stage's images. Each k8 step is three
//   wgmma.m64n128k8 products, lo.hi + hi.lo + hi.hi (lo.lo, some 2^-21 of a
//   product, is dropped), one commit group, which runs while the next
//   step's A is loaded and split.
// - The tensor cores truncate their sums, so each stage's products go to an
//   accumulator started afresh and added to an f32 total: one that ran over
//   a tile's whole depth read 14-92 times the error, one started afresh
//   every second stage up to 2.3 times cuBLAS f32's at K = 128 (once a
//   stage: at most 1.3 times). The total and the accumulator take 128 of a
//   consumer's 168 registers: the tile cannot grow.
// - Measured on an H100, with producers and consumers each alone near
//   115-140 TFLOP/s: two producer warps were the first bottleneck (30-50
//   TFLOP/s: a warpgroup doubled it), then B's loads, eight lanes a 64-byte
//   piece of a column, which the layout below lets eight lanes read as 128
//   contiguous bytes (+13-18% on the input gradients). The padded layouts
//   keep every shared store and load free of bank conflicts. B goes through
//   the producers' registers, not staged raw in shared memory and read
//   back.
// The shapes it takes: M and N multiples of 128, K a multiple of 32
// (dense.py::takes); the wrapper sends every other product to cuBLAS.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "tower_tile.cuh"

namespace {

using hopper::mbar_arrive;
using hopper::mbar_arrive_cp_async;
using hopper::mbar_arrive_if;
using hopper::mbar_init;
using hopper::mbar_init_fence;
using hopper::mbar_wait;
using hopper::smem_addr;
using tower::fence_operands;
using tower::split_tf32;
using tower::warp_index;
using tower::warpgroup_index;
using tower::wgmma_commit;
using tower::wgmma_fence;
using tower::wgmma_wait;

constexpr int kTileM = 128;        // output rows a tile, 64 a consumer warpgroup
constexpr int kTileN = 128;        // output columns a tile: one m64n128k8 a k8 step
constexpr int kDepth = 32;         // depth a stage
constexpr int kStages = 4;
constexpr int kConsumers = 256;    // two warpgroups
constexpr int kProducers = 128;    // one warpgroup
constexpr int kProducerWarps = kProducers / 32;
constexpr int kBlockThreads = kConsumers + kProducers;
constexpr int kQuads = kTileM * kDepth / 4;       // 16-byte quads of a stage's A or B block
constexpr int kPerProducer = kQuads / kProducers;  // 8
constexpr int kSets = 3;           // B's register sets in a producer: loads two stages ahead

// A's block, as cp.async lays it down: K-major rows of kDepth floats, or
// MN-major rows of kTileM, each padded so that a fragment's eight rows and
// four columns fall on 32 different banks.
constexpr int kAldK = kDepth + 4;  // 36: bank (4m + k) % 32
constexpr int kAldM = kTileM + 8;  // 136: bank (8k + m) % 32
constexpr int kAFloats = kTileM * kAldK > kDepth * kAldM ? kTileM * kAldK : kDepth * kAldM;

// B's images (hi, then lo), K-major without swizzle: a k8 step holds 16
// groups of 8 columns, each two core matrices (8 columns x 4 depths, 128 B)
// along k, kHalf floats apart (the descriptor's leading offset), the groups
// kGroup floats apart (its stride offset), the steps kStepFloats apart.
// Element (n, k) of the stage lies at (k / 8) * kStepFloats + (k % 8 / 4) *
// kHalf + (n / 8) * kGroup + (n % 8) * 4 + k % 4. The padding makes a
// 16-byte store by eight lanes hit 8 different bank groups (16-byte units
// mod 8) in both producers' patterns: eight quads of one column (K-major B:
// k8 step x 2 + half, as kStepFloats / 4 = 2 and kHalf / 4 = 1 mod 8), or
// one depth quad of columns 4 apart (MN-major B: n / 8 + n % 8, as kGroup / 4
// = 1 mod 8).
constexpr int kHalf = 36;
constexpr int kGroup = 68;
constexpr int kStepFloats = kTileN / 8 * kGroup + 8;  // 1096
constexpr int kBFloats = kDepth / 8 * kStepFloats;    // 4384
constexpr int kStageFloats = kAFloats + 2 * kBFloats;
constexpr size_t kSmem = sizeof(float) * kStages * kStageFloats;  // 214,016 B

struct Problem {
  const float* a;
  const float* b;
  float* c;          // C [m, n], or [slices][m][n] partial tiles
  int m, n, lda, ldb;
  int tiles_n, slices, units, kblocks;
};

// The descriptor of a K-major image as laid out above.
__device__ __forceinline__ uint64_t image_desc(const float* image) {
  return static_cast<uint64_t>((smem_addr(image) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(sizeof(float) * kHalf >> 4) << 16) |
         (static_cast<uint64_t>(sizeof(float) * kGroup >> 4) << 32);
}

__device__ __forceinline__ int image_at(int n, int k) {
  return k / 8 * kStepFloats + k % 8 / 4 * kHalf + n / 8 * kGroup + n % 8 * 4;
}

// A block's walk over its units, unit u = blockIdx.x + i * gridDim.x: tile
// u / slices (row-major over the tiles), slice u % slices, whose k-blocks
// are [s * kblocks / slices, (s + 1) * kblocks / slices) (never empty: the
// wrapper keeps slices <= kblocks).
struct Walk {
  int u, kb, kb_end, m0, n0, slice;

  __device__ __forceinline__ bool enter(const Problem& p) {
    if (u >= p.units) return false;
    slice = u % p.slices;
    const int tile = u / p.slices;
    m0 = tile / p.tiles_n * kTileM;
    n0 = tile % p.tiles_n * kTileN;
    kb = slice * p.kblocks / p.slices;
    kb_end = (slice + 1) * p.kblocks / p.slices;
    return true;
  }
  __device__ __forceinline__ bool start(const Problem& p) {
    u = blockIdx.x;
    return enter(p);
  }
  __device__ __forceinline__ bool next(const Problem& p) {
    if (++kb < kb_end) return true;
    u += gridDim.x;
    return enter(p);
  }
};

// --- producers ------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ float lane_of(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// This producer thread's 8 quads of B's block at k-block kb, from global
// memory into registers. K-major B [n][k]: quad i is 4 depths, at quad k4 =
// lane % 8, of column n = lane / 8 + 4 * (warp + 4 * i): eight lanes read a
// column's 128 contiguous bytes.
// MN-major B [k][n]: rows 4 * (warp + 4 * j) + r (quad 4j + r) of the 4
// columns from 4 * lane.
template <bool kKMajor>
__device__ __forceinline__ void fetch_b(const Problem& p, int n0, int kb, float4 (&v)[kPerProducer]) {
  const int t = threadIdx.x - kConsumers;
  const int w = t / 32;
  const int lane = t % 32;
  const int k0 = kb * kDepth;
#pragma unroll
  for (int i = 0; i < kPerProducer; ++i) {
    const float* src;
    if (kKMajor) {
      const int n = lane / 8 + 4 * (w + kProducerWarps * i);
      const int k4 = lane % 8;
      src = p.b + static_cast<size_t>(n0 + n) * p.ldb + k0 + 4 * k4;
    } else {
      const int k = 4 * (w + kProducerWarps * (i / 4)) + i % 4;
      src = p.b + static_cast<size_t>(k0 + k) * p.ldb + n0 + 4 * lane;
    }
    v[i] = __ldcg(reinterpret_cast<const float4*>(src));
  }
}

__device__ __forceinline__ void store_split(float* hi, float* lo, int at, float x0, float x1,
                                            float x2, float x3) {
  uint32_t h[4], l[4];
  split_tf32(x0, h[0], l[0]);
  split_tf32(x1, h[1], l[1]);
  split_tf32(x2, h[2], l[2]);
  split_tf32(x3, h[3], l[3]);
  *reinterpret_cast<uint4*>(hi + at) = make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(lo + at) = make_uint4(l[0], l[1], l[2], l[3]);
}

// The registers of fetch_b as the stage's hi and lo images.
template <bool kKMajor>
__device__ __forceinline__ void store_b(float* hi, float* lo, const float4 (&v)[kPerProducer]) {
  const int t = threadIdx.x - kConsumers;
  const int w = t / 32;
  const int lane = t % 32;
#pragma unroll
  for (int i = 0; i < kPerProducer; ++i) {
    if (kKMajor) {
      const int n = lane / 8 + 4 * (w + kProducerWarps * i);
      const int k4 = lane % 8;
      store_split(hi, lo, image_at(n, 4 * k4), v[i].x, v[i].y, v[i].z, v[i].w);
    } else if (i % 4 == 0) {
      // rows k..k+3 of columns 4 * lane + e: column e's four depths are one quad
      const int k = 4 * (w + kProducerWarps * (i / 4));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        store_split(hi, lo, image_at(4 * lane + e, k), lane_of(v[i], e), lane_of(v[i + 1], e),
                    lane_of(v[i + 2], e), lane_of(v[i + 3], e));
      }
    }
  }
}

// A's block at k-block kb into the stage by cp.async: K-major A [m][k] as
// rows of kAldK, MN-major A [k][m] as rows of kAldM.
template <bool kKMajor>
__device__ __forceinline__ void copy_a(const Problem& p, int m0, int kb, float* as) {
  const int t = threadIdx.x - kConsumers;
  const int k0 = kb * kDepth;
#pragma unroll
  for (int i = 0; i < kPerProducer; ++i) {
    const int q = i * kProducers + t;
    if (kKMajor) {
      const int m = q / (kDepth / 4);
      const int k4 = q % (kDepth / 4);
      cp_async16(as + m * kAldK + 4 * k4, p.a + static_cast<size_t>(m0 + m) * p.lda + k0 + 4 * k4);
    } else {
      const int k = q / (kTileM / 4);
      const int m4 = q % (kTileM / 4);
      cp_async16(as + k * kAldM + 4 * m4, p.a + static_cast<size_t>(k0 + k) * p.lda + m0 + 4 * m4);
    }
  }
}

// Stage `it` of the walk from w and its B registers v: wait until the
// consumers have freed the slot, start A's copies (they arrive on full when
// they land), write B's images, and arrive.
template <bool kKMajor>
__device__ __forceinline__ void fill(const Problem& p, const Walk& w, int it, const float4 (&v)[kPerProducer],
                                     float* smem, uint64_t* full, uint64_t* empty) {
  const int s = it % kStages;
  if (it >= kStages) mbar_wait(&empty[s], (it / kStages - 1) & 1);
  float* stage = smem + s * kStageFloats;
  copy_a<kKMajor>(p, w.m0, w.kb, stage);
  mbar_arrive_cp_async(&full[s]);
  store_b<kKMajor>(stage + kAFloats, stage + kAFloats + kBFloats, v);
  // the images are read by wgmma, through the async proxy
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  mbar_arrive(&full[s]);
}

// One stage of the producers' walk: fill stage `it` from walk w[kNow], whose
// B is in register set kNow, after starting the loads of the walk
// kSets - 1 stages ahead into the set stage `it` - 1 used (the sets between
// hold the stages in flight). False once w[kNow] was the last.
template <bool kKMajor, int kNow>
__device__ __forceinline__ bool produce_step(const Problem& p, Walk (&w)[kSets], bool (&has)[kSets],
                                             int& it, float4 (&v)[kSets][kPerProducer],
                                             float* smem, uint64_t* full, uint64_t* empty) {
  constexpr int kFetch = (kNow + kSets - 1) % kSets;
  constexpr int kLast = (kNow + kSets - 2) % kSets;  // the walk fetched last
  w[kFetch] = w[kLast];
  has[kFetch] = has[kLast] && w[kFetch].next(p);
  if (has[kFetch]) fetch_b<kKMajor>(p, w[kFetch].n0, w[kFetch].kb, v[kFetch]);
  fill<kKMajor>(p, w[kNow], it, v[kNow], smem, full, empty);
  ++it;
  return has[(kNow + 1) % kSets];
}

// The producers' walk, B's loads two stages ahead of its stores (one
// stage ahead was within 3% on an H100, a little slower on the weight
// gradients).
template <bool kKMajor>
__device__ __forceinline__ void produce(const Problem& p, float* smem, uint64_t* full,
                                        uint64_t* empty) {
  static_assert(kSets == 3, "produce walks three register sets");
  float4 v[kSets][kPerProducer];
  Walk w[kSets];
  bool has[kSets];
  has[0] = w[0].start(p);
  if (!has[0]) return;
  fetch_b<kKMajor>(p, w[0].n0, w[0].kb, v[0]);
  w[1] = w[0];
  has[1] = w[1].next(p);
  if (has[1]) fetch_b<kKMajor>(p, w[1].n0, w[1].kb, v[1]);
  int it = 0;
  while (produce_step<kKMajor, 0>(p, w, has, it, v, smem, full, empty) &&
         produce_step<kKMajor, 1>(p, w, has, it, v, smem, full, empty) &&
         produce_step<kKMajor, 2>(p, w, has, it, v, smem, full, empty)) {
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// --- consumers ------------------------------------------------------------------

// This thread's A fragment of the stage's k8 step ks, split: rows row and
// row + 8 of the tile at depths 8 ks + t and + 4, in mma.m16n8k8's order.
template <bool kKMajor>
__device__ __forceinline__ void load_a(const float* as, int row, int t, int ks, uint32_t (&h)[4],
                                       uint32_t (&l)[4]) {
  const int k = 8 * ks + t;
  float v[4];
  if (kKMajor) {
    v[0] = as[row * kAldK + k];
    v[1] = as[(row + 8) * kAldK + k];
    v[2] = as[row * kAldK + k + 4];
    v[3] = as[(row + 8) * kAldK + k + 4];
  } else {
    v[0] = as[k * kAldM + row];
    v[1] = as[k * kAldM + row + 8];
    v[2] = as[(k + 4) * kAldM + row];
    v[3] = as[(k + 4) * kAldM + row + 8];
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32(v[e], h[e], l[e]);
}

// The consumers' walk. The products of one k8 step (a commit group) run
// while the next step's A is loaded and split into the other register set;
// at the end of a stage, once its products are done, the stage is freed
// and the accumulator added to the f32 total.
template <bool kKMajor>
__device__ __forceinline__ void consume(const Problem& p, float* smem, uint64_t* full,
                                        uint64_t* empty) {
  constexpr int kNt = kTileN / 8;
  constexpr int kSteps = kDepth / 8;
  constexpr uint64_t kStep = (sizeof(float) * kStepFloats) >> 4;  // one k8 step, in 16 B
  const int lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int row = 64 * warpgroup_index() + 16 * (warp_index() % 4) + lane / 4;
  const bool lane0 = lane == 0;
  float acc[4 * kNt], total[4 * kNt];
#pragma unroll
  for (int i = 0; i < 4 * kNt; ++i) acc[i] = 0.0f;
  int it = 0;
  Walk w;
  for (bool more = w.start(p); more;) {
#pragma unroll
    for (int i = 0; i < 4 * kNt; ++i) total[i] = 0.0f;
    const Walk tile = w;
    do {
      const int s = it % kStages;
      mbar_wait(&full[s], (it / kStages) & 1);
      const float* stage = smem + s * kStageFloats;
      const uint64_t hi = image_desc(stage + kAFloats);
      const uint64_t lo = image_desc(stage + kAFloats + kBFloats);
      uint32_t ah[2][4], al[2][4];
      load_a<kKMajor>(stage, row, t, 0, ah[0], al[0]);
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        fence_operands(acc);
        wgmma_fence();
        tower::Wgmma<kNt>::mma(acc, al[ks % 2], hi + ks * kStep, ks == 0 ? 0 : 1);
        tower::Wgmma<kNt>::mma(acc, ah[ks % 2], lo + ks * kStep, 1);
        tower::Wgmma<kNt>::mma(acc, ah[ks % 2], hi + ks * kStep, 1);
        wgmma_commit();
        if (ks + 1 < kSteps) {
          wgmma_wait<1>();  // the previous step's products are done with the other set
          load_a<kKMajor>(stage, row, t, ks + 1, ah[(ks + 1) % 2], al[(ks + 1) % 2]);
        }
      }
      wgmma_wait<0>();
      fence_operands(acc);
      mbar_arrive_if(&empty[s], lane0);
#pragma unroll
      for (int i = 0; i < 4 * kNt; ++i) total[i] += acc[i];
      ++it;
      more = w.next(p);
    } while (more && w.u == tile.u);
    float* out = p.c + static_cast<size_t>(tile.slice) * p.m * p.n +
                 static_cast<size_t>(tile.m0 + row) * p.n + tile.n0 + 2 * t;
#pragma unroll
    for (int j = 0; j < kNt; ++j) {
      *reinterpret_cast<float2*>(out + 8 * j) = make_float2(total[4 * j], total[4 * j + 1]);
      *reinterpret_cast<float2*>(out + 8 * static_cast<size_t>(p.n) + 8 * j) =
          make_float2(total[4 * j + 2], total[4 * j + 3]);
    }
  }
}

template <bool kKMajor>
__global__ void __launch_bounds__(kBlockThreads, 1) dense_bwd_kernel(Problem p) {
  extern __shared__ __align__(128) float smem[];
  __shared__ uint64_t full[kStages], empty[kStages];
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 2 * kProducers);  // each producer's copies land, and it stored B
      mbar_init(&empty[s], kConsumers / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();
  // the roles split on a warp-uniform index: products after a branch ptxas
  // cannot prove uniform are serialized (tower_tile.cuh)
  if (warp_index() >= kConsumers / 32) {
    produce<kKMajor>(p, smem, full, empty);
  } else {
    consume<kKMajor>(p, smem, full, empty);
  }
}

// out[i] = the slices' partial sums of element i, added in slice order.
__global__ void dense_bwd_reduce_kernel(const float4* __restrict__ parts, int slices,
                                        size_t quads, float4* __restrict__ out) {
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < quads;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float4 s = __ldcs(parts + i);
    for (int j = 1; j < slices; ++j) {
      const float4 v = __ldcs(parts + j * quads + i);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    out[i] = s;
  }
}

// The SM count of the current device; 0 where it cannot be read.
int device_sms() {
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) {
    return 0;
  }
  return sms;
}

template <bool kKMajor>
cudaError_t launch(const Problem& p, int sms, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      dense_bwd_kernel<kKMajor>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmem));
  if (err != cudaSuccess) return err;
  const int blocks = p.units < sms ? p.units : sms;
  dense_bwd_kernel<kKMajor><<<blocks, kBlockThreads, kSmem, stream>>>(p);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// C [m, n] = A . B in float32 by 3xTF32 on the tensor cores. k_major: A is
// [m, k] and B [n, k] (C = A . B^T, the input gradient); else A is [k, m]
// and B [k, n] (C = A^T . B, the weight gradient). All contiguous f32 on the
// device, 16-byte aligned; m and n multiples of 128, k of 32. slices: the
// depth's split, 1 <= slices <= k / 32; above 1, workspace holds slices * m
// * n floats, 16-byte aligned, and a second kernel sums them into out.
// Returns a cudaError_t code; 0 means launched on the stream.
extern "C" int dense_bwd_product(const void* a, const void* b, void* out, void* workspace,
                                 int m, int n, int k, int k_major, int slices, void* stream) {
  if (m < kTileM || n < kTileN || k < kDepth || m % kTileM != 0 || n % kTileN != 0 ||
      k % kDepth != 0 || slices < 1 || slices > k / kDepth || !aligned16(a) || !aligned16(b) ||
      !aligned16(out) || (slices > 1 && (workspace == nullptr || !aligned16(workspace)))) {
    return cudaErrorInvalidValue;
  }
  const int sms = device_sms();
  if (sms < 1) return cudaErrorInitializationError;
  Problem p;
  p.a = static_cast<const float*>(a);
  p.b = static_cast<const float*>(b);
  p.c = static_cast<float*>(slices > 1 ? workspace : out);
  p.m = m;
  p.n = n;
  p.lda = k_major ? k : m;
  p.ldb = k_major ? k : n;
  p.tiles_n = n / kTileN;
  p.slices = slices;
  p.units = m / kTileM * p.tiles_n * slices;
  p.kblocks = k / kDepth;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = k_major ? launch<true>(p, sms, st) : launch<false>(p, sms, st);
  if (err != cudaSuccess || slices == 1) return err;
  const size_t quads = static_cast<size_t>(m) * n / 4;
  const size_t blocks = (quads + 255) / 256;
  dense_bwd_reduce_kernel<<<static_cast<unsigned>(blocks < 4 * static_cast<size_t>(sms) ? blocks : 4 * static_cast<size_t>(sms)),
                            256, 0, st>>>(static_cast<const float4*>(workspace), slices, quads,
                                          static_cast<float4*>(out));
  return cudaGetLastError();
}
