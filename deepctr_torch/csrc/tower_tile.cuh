// Row-tile machinery shared by the fused tower's forward and backward-rows
// kernels.
//
// A block owns kBm rows of the batch (64, or 32 for towers too wide for 64)
// and keeps their activations in shared memory, in two ping-pong buffers,
// row-major with a row stride act_ld(width) = round8(width) + 4..12 floats.
// A product of the tile with a layer's weights (a "pass": out = h . W, or
// out = h . W^T on the backward's walk) runs on the tensor cores.
//
// The product: wgmma.mma_async m64nNk8 with TF32 operands, in "3xTF32".
// Every operand x is split into hi = rna_tf32(x) and lo = rna_tf32(x - hi),
// and a product accumulates lo.hi + hi.lo + hi.hi in f32: f32's accuracy
// (tests/test_torch_tf32x3.py) at three tensor-core products per multiply.
// - A (the activations) comes from registers: each warp loads its 16 rows'
//   fragment from the activation buffer (any layout will do, so the
//   buffers the epilogues write need no second copy) and splits it there.
// - B (the weights) comes from shared memory, where TF32 wgmma wants it
//   K-major. A small kernel (tower_pack_kernel) writes, once per call, every
//   pass's weights as the exact shared-memory images the products read:
//   split into hi and lo, transposed where the pass needs it, zero past the
//   matrix edges, in the order the blocks consume them. A producer warp
//   copies each image with one bulk copy (cp.async.bulk, completing on an
//   mbarrier) into its warpgroup's ring of slots, as soon as a slot is free.
// - The two consumer warpgroups take turns over a pass's column passes (N
//   <= 64 columns each), each through its own ring, so that one's epilogue
//   (bias, activation, dropout hash, stores) runs while the other's
//   products keep the tensor cores busy. Within a column pass the products
//   of one image run while the next image's A is loaded and split (one
//   wgmma group in flight).
// - The tensor cores truncate the sums of a product, so the three products
//   go to an accumulator started afresh (scale-d 0) every kFlush images and
//   added to an f32 total: a few truncations of a small partial sum, never
//   of the running total (never flushing tripled the error).
// - ptxas serializes every wgmma (C7520, C7518) that follows a branch it
//   cannot prove to be the same for a whole warp, or that sits in a
//   function it did not inline. So the roles split on warp_index() (a
//   shuffle makes it warp-uniform), loads that may be masked use clamped
//   addresses and selects, an mbarrier arrive by one lane is a predicated
//   instruction, and the kernels' bodies are written out, not in lambdas.
// Why wgmma and not mma.sync: the mma.sync design (16 x 8 x 8 tiles, every
// warp splitting its own A and B fragments) spent its time in the
// instructions around the tensor cores; with every mma removed it took as
// long (PERF.md §6).
//
// A pass's output columns are cut into an even number of column passes of
// n columns (a multiple of 8, at most 64; wgmma_tf32.cuh has one
// instruction per N). An image holds kChunk depth rows of a column pass:
// element (n, k) at float (k / 8) * 8 * n_cols + (n / 8) * 64 + (k % 8 / 4) *
// 32 + (n % 8) * 4 + k % 4 (core matrices of 8 x 16 bytes; the descriptor's
// leading offset, 128 B, steps along k, its stride offset, 256 B, along n),
// hi image then lo image. The depth index is relabelled within each k8 step
// (k = q and q + 4 hold depth 2q and 2q + 1) so that a thread's two A values
// of a row are one 64-bit load.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "mbarrier.cuh"
#include "wgmma_tf32.cuh"

namespace tower {

using namespace hopper;  // cp.async, mbarriers and bulk copies

constexpr int kMaxLayers = 8;
constexpr int kThreads = 256;                  // two consumer warpgroups
constexpr int kBlockThreads = kThreads + 64;   // and two producer warps
constexpr int kChunk = 16;                     // depth of one weight image
constexpr int kStages = 8;                     // image slots a ring has at most
constexpr int kMaxNt = 8;                      // n8 tiles of a column pass (N = 64)

enum Activation { kTanh = 0, kRelu = 1, kSigmoid = 2 };

struct Tower {
  const float* w[kMaxLayers];  // [dims[l], dims[l + 1]], row-major (JAX layout)
  const float* b[kMaxLayers];  // [dims[l + 1]]
  int dims[kMaxLayers + 1];
  int num_layers;
};

__host__ __device__ __forceinline__ int round8(int n) { return (n + 7) & ~7; }
__host__ __device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

// Row stride of an activation buffer: at least round8(width), and 8 mod 16,
// so that the four rows a quarter-warp reads of an A fragment (64-bit loads)
// fall on four different groups of eight banks.
__host__ __device__ __forceinline__ int act_ld(int width) {
  return (width + 7) / 16 * 16 + 8;
}

// The activation without branches, so that the epilogue's elements
// interleave: tanh v = (e - 1) / (e + 1) with e = exp(2v), sigmoid v =
// e / (e + 1) with e = exp(v) (two MUFU operations each, within 2.5e-7 of
// tanh and sigmoid; the exponent is clamped at 80, where both are 1 in
// f32), relu a select. The clamp and relu are comparisons, not
// fminf/fmaxf, which return the other operand for a NaN: a NaN goes
// through, as through torch.tanh, torch.relu and the reference's jnp ops.
__device__ __forceinline__ float activate(float v, int act) {
  const bool tanh = act == kTanh;
  const float x = tanh ? 2.0f * v : v;
  const float e = __expf(x < -80.0f ? -80.0f : (x > 80.0f ? 80.0f : x));
  const float y = __fdividef(tanh ? e - 1.0f : e, e + 1.0f);
  return act == kRelu ? (v < 0.0f ? 0.0f : v) : y;
}

// The activation's derivative from its output a = act(z), as the reference
// backward takes it (deepctr_tpu/ops/pallas/mlp.py::_act_deriv).
__device__ __forceinline__ float activate_deriv(float a, int act) {
  const float smooth = act == kTanh ? 1.0f - a * a : a * (1.0f - a);
  return act == kRelu ? (a > 0.0f ? 1.0f : 0.0f) : smooth;
}

// --- 3xTF32 ---------------------------------------------------------------------

// x = hi + lo, both rounded to TF32 as cvt.rna.tf32.f32 rounds a finite
// value: half a TF32 ulp is added to the bits (ties away from zero) and the
// 13 bits below TF32's are cleared, hi's first so that x - hi is exact. A
// NaN's hi is the quiet NaN 0x7FC00000: the NaNs the device makes are
// 0x7FFFFFFF, whose add would carry into the sign bit and give -0, so a
// NaN activation would reach the next layer as 0 (its lo is then -0, and
// hi carries the NaN). The compiler's cvt.rna.tf32.f32 has the same guard,
// for inf as well.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = x != x ? 0x7FC00000u : (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xFFFFE000u;
}

// --- wgmma --------------------------------------------------------------------

// Shared-memory descriptor of a K-major TF32 tile without swizzle: core
// matrices of 8 rows x 16 bytes, 128 bytes apart along k (leading offset)
// and 256 bytes apart along the rows (stride offset).
__device__ __forceinline__ uint64_t kmajor_desc(const float* tile) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(tile));
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// Wait until at most kPending committed groups of products are in flight.
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kPending) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulator across
// the asynchronous products.
template <int kN>
__device__ __forceinline__ void fence_operands(float (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// threadIdx.x / 128 and threadIdx.x / 32, broadcast from lane 0, so that the
// compiler knows them to be the same in a warp: a branch on a value it
// cannot prove warp-uniform puts the products after it on a "divergent
// path", and ptxas then serializes them.
__device__ __forceinline__ int warpgroup_index() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
}

__device__ __forceinline__ int warp_index() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 32, 0);
}

// The 256 threads of the two consumer warpgroups (the producer warps never
// join): named barrier 1.
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kThreads) : "memory");
}

// The tower of a C entry point's arguments (dims: host int[num_layers + 1];
// weights, biases: host arrays of num_layers device pointers, or null);
// false for an invalid one.
inline bool make_tower(int num_layers, const void* dims, const void* weights,
                       const void* biases, Tower& t) {
  if (num_layers < 1 || num_layers > kMaxLayers) return false;
  const int* d = static_cast<const int*>(dims);
  t = {};
  t.num_layers = num_layers;
  for (int l = 0; l <= num_layers; ++l) {
    if (d[l] < 1) return false;
    t.dims[l] = d[l];
  }
  if (weights != nullptr) {
    const float* const* w = static_cast<const float* const*>(weights);
    const float* const* b = static_cast<const float* const*>(biases);
    for (int l = 0; l < num_layers; ++l) {
      t.w[l] = w[l];
      t.b[l] = b[l];
    }
  }
  return true;
}

// --- the plan: passes, column passes, weight images --------------------------------

// Pass p of a walk: the num_layers - 1 forward passes of the hidden layers,
// then, on a backward walk (back), the transposed passes of layers L-1 down
// to 0.
__host__ __device__ __forceinline__ void pass_of(const Tower& t, bool back, int p,
                                                 int& layer, bool& transposed) {
  transposed = back && p >= t.num_layers - 1;
  layer = transposed ? 2 * t.num_layers - 2 - p : p;
}

__host__ __device__ __forceinline__ int pass_depth(const Tower& t, int layer, bool tr) {
  return tr ? t.dims[layer + 1] : t.dims[layer];
}

__host__ __device__ __forceinline__ int pass_width(const Tower& t, int layer, bool tr) {
  return tr ? t.dims[layer] : t.dims[layer + 1];
}

// The column passes of a pass of the given width: an even number of them
// (the two consumer warpgroups take turns, warpgroup w the passes w, w + 2,
// ...), each of n columns, a multiple of 8 and at most 8 * kMaxNt; column
// pass cp covers columns [cp * n, cp * n + n) of which those below width are
// real. Every column pass of a pass has the same n and the same number of
// images, so that the loops and branches around the products are the same
// for the whole block.
__host__ __device__ __forceinline__ int col_passes(int width) {
  return 2 * ((width + 16 * kMaxNt - 1) / (16 * kMaxNt));
}

__host__ __device__ __forceinline__ int col_width(int width) {
  const int passes = col_passes(width);
  return round8((width + passes - 1) / passes);
}

// Floats of one image pair (hi and lo) of a column pass of n columns.
__host__ __device__ constexpr int image_floats(int n) {
  return 2 * kChunk * n;
}

__host__ __device__ __forceinline__ int pass_chunks(const Tower& t, int layer, bool tr) {
  return (pass_depth(t, layer, tr) + kChunk - 1) / kChunk;
}

struct Plan {
  int bm;          // rows a block: 64, or 32
  int stages;      // image slots in each warpgroup's ring, 2 to kStages
  int slot;        // floats of a slot: the walk's largest image
  int width;       // widest activation a block holds
  int num_passes;  // passes of the walk
  bool back;       // the backward's walk (transposed passes after the forward's)
  size_t pass_off[2 * kMaxLayers];  // first float of each pass's images
  size_t packed_floats;             // floats of all images
};

inline size_t plan_smem_bytes(int bm, int width, int stages, int slot) {
  return sizeof(float) * (2 * static_cast<size_t>(bm) * act_ld(width) +
                          2 * static_cast<size_t>(stages) * slot) +
         2 * 2 * kStages * sizeof(uint64_t);
}

// The plan of a walk over tower t: 64 rows a block where the activations
// and two rings of at least 2 image slots fit the card's opt-in shared
// memory, else 32; false where neither fits or the device cannot be read.
// smem: the block's dynamic shared memory.
inline bool make_plan(const Tower& t, bool back, Plan& plan, size_t& smem) {
  int device = 0, max_smem = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess) {
    return false;
  }
  plan = {};
  plan.back = back;
  plan.num_passes = back ? 2 * t.num_layers - 1 : t.num_layers - 1;
  for (int l = 0; l <= t.num_layers; ++l) plan.width = imax(plan.width, t.dims[l]);
  for (int p = 0; p < plan.num_passes; ++p) {
    int layer;
    bool tr;
    pass_of(t, back, p, layer, tr);
    plan.slot = imax(plan.slot, image_floats(col_width(pass_width(t, layer, tr))));
  }
  // as many slots as fit: the rings' depth is what hides the copies' latency
  for (int bm : {64, 32}) {
    for (int stages = kStages; stages >= 2 && plan.bm == 0; --stages) {
      if (plan_smem_bytes(bm, plan.width, stages, plan.slot) <= static_cast<size_t>(max_smem)) {
        plan.bm = bm;
        plan.stages = stages;
      }
    }
  }
  if (plan.bm == 0) return false;
  smem = plan_smem_bytes(plan.bm, plan.width, plan.stages, plan.slot);
  size_t off = 0;
  for (int p = 0; p < plan.num_passes; ++p) {
    plan.pass_off[p] = off;
    int layer;
    bool tr;
    pass_of(t, back, p, layer, tr);
    const int width = pass_width(t, layer, tr);
    off += static_cast<size_t>(col_passes(width)) * pass_chunks(t, layer, tr) *
           image_floats(col_width(width));
  }
  plan.packed_floats = off;
  return true;
}

// Images of the pass with the most, the pack kernel's grid.x.
inline int max_images(const Tower& t, const Plan& plan) {
  int most = 0;
  for (int p = 0; p < plan.num_passes; ++p) {
    int layer;
    bool tr;
    pass_of(t, plan.back, p, layer, tr);
    most = imax(most, pass_chunks(t, layer, tr) * col_passes(pass_width(t, layer, tr)));
  }
  return most;
}

// Block (image, pass): writes image pair `image` (column pass image /
// chunks, depth chunk image % chunks) of pass blockIdx.y.
static __global__ void __launch_bounds__(256)
    tower_pack_kernel(Tower t, Plan plan, float* __restrict__ packed) {
  const int p = blockIdx.y;
  int layer;
  bool tr;
  pass_of(t, plan.back, p, layer, tr);
  const int depth = pass_depth(t, layer, tr);
  const int width = pass_width(t, layer, tr);
  const int chunks = pass_chunks(t, layer, tr);
  const int cp = blockIdx.x / chunks;
  const int kc = blockIdx.x % chunks;
  if (cp >= col_passes(width)) return;
  const int n_cols = col_width(width);
  float* hi = packed + plan.pass_off[p] + static_cast<size_t>(blockIdx.x) * image_floats(n_cols);
  float* lo = hi + kChunk * n_cols;
  const float* __restrict__ w = t.w[layer];
  const int ld = t.dims[layer + 1];
  for (int e = threadIdx.x; e < kChunk * n_cols; e += blockDim.x) {
    // neighbouring threads read neighbouring weights: along n for W, along
    // k for W^T
    const int n = tr ? e / kChunk : e % n_cols;
    const int kk = tr ? e % kChunk : e / n_cols;
    const int q = kk % 8;
    const int k = kc * kChunk + kk / 8 * 8 + (q < 4 ? 2 * q : 2 * (q - 4) + 1);
    const int col = cp * n_cols + n;
    float v = 0.0f;
    if (k < depth && col < width) {
      v = tr ? w[static_cast<size_t>(col) * ld + k] : w[static_cast<size_t>(k) * ld + col];
    }
    uint32_t h, l;
    split_tf32(v, h, l);
    const int at = kk / 8 * 8 * n_cols + n / 8 * 64 + q / 4 * 32 + n % 8 * 4 + q % 4;
    hi[at] = __uint_as_float(h);
    lo[at] = __uint_as_float(l);
  }
}

// --- a block's walk ---------------------------------------------------------------

// A consumer warpgroup's ring of image slots and its mbarriers, in dynamic
// shared memory after the activation buffers.
struct Ring {
  float* slots;
  int stages;
  int slot;         // floats a slot
  uint64_t* full;   // [stages]: the slot's image has landed
  uint64_t* empty;  // [stages]: the warpgroup's 4 warps are done with it
  int consumed;     // images consumed so far
};

__device__ __forceinline__ Ring make_ring(float* smem, const Plan& plan, int wg) {
  float* rings = smem + 2 * plan.bm * act_ld(plan.width);
  uint64_t* bars = reinterpret_cast<uint64_t*>(rings + 2 * plan.stages * plan.slot);
  Ring r;
  r.slots = rings + wg * plan.stages * plan.slot;
  r.stages = plan.stages;
  r.slot = plan.slot;
  r.full = bars + wg * 2 * kStages;
  r.empty = r.full + kStages;
  r.consumed = 0;
  return r;
}

// Thread 0 sets up both rings' mbarriers; every thread of the block must
// call it, before any waits on them.
__device__ __forceinline__ void init_rings(const Ring& r0, const Ring& r1) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < r0.stages; ++s) {
      mbar_init(&r0.full[s], 1);
      mbar_init(&r0.empty[s], 4);
      mbar_init(&r1.full[s], 1);
      mbar_init(&r1.empty[s], 4);
    }
    mbar_init_fence();
  }
  __syncthreads();
}

// The producer of warpgroup wg's ring: one thread copies the images of the
// warpgroup's column passes, in the order it takes them, each into the next
// slot once it is free.
__device__ __forceinline__ void produce(const Tower& t, const Plan& plan,
                                        const float* __restrict__ packed, int wg,
                                        Ring& r) {
  int i = 0;
  for (int p = 0; p < plan.num_passes; ++p) {
    int layer;
    bool tr;
    pass_of(t, plan.back, p, layer, tr);
    const int chunks = pass_chunks(t, layer, tr);
    const int width = pass_width(t, layer, tr);
    const int floats = image_floats(col_width(width));
    for (int cp = wg; cp < col_passes(width); cp += 2) {
      const float* images = packed + plan.pass_off[p] + static_cast<size_t>(cp) * chunks * floats;
      for (int kc = 0; kc < chunks; ++kc, ++i) {
        const int slot = i % r.stages;
        if (i >= r.stages) mbar_wait(&r.empty[slot], (i / r.stages - 1) & 1);
        mbar_arrive_expect(&r.full[slot], sizeof(float) * floats);
        bulk_copy(r.slots + slot * r.slot, images + static_cast<size_t>(kc) * floats,
                  sizeof(float) * floats, &r.full[slot]);
      }
    }
  }
}

// This warp's two TF32 halves of its A fragments for image k0 (depth k0 to
// k0 + 15): rows 16 * (warp % 4) + lane / 4 and + 8 of src; zero where the
// rows lie outside the block or the depth outside the pass (the activation
// buffers hold zeros from the pass's depth to the next multiple of 8).
__device__ __forceinline__ void load_a(const float* a_ptr, int lda, int k0, int depth,
                                       bool rows_in, uint32_t (&ah)[2][4],
                                       uint32_t (&al)[2][4]) {
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (rows_in && k0 + 8 * ks < depth) {
      const float2 top = *reinterpret_cast<const float2*>(a_ptr + k0 + 8 * ks);
      const float2 bottom = *reinterpret_cast<const float2*>(a_ptr + 8 * lda + k0 + 8 * ks);
      a[0] = top.x;
      a[1] = bottom.x;
      a[2] = top.y;
      a[3] = bottom.y;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(a[e], ah[ks][e], al[ks][e]);
  }
}

// The products of one image (3 per k8 step, 2 steps where the depth has
// them) into acc, committed as one group; scale 0 starts acc afresh.
template <int kNt>
__device__ __forceinline__ void image_product(float (&acc)[4 * kNt], const float* image,
                                              const uint32_t (&ah)[2][4],
                                              const uint32_t (&al)[2][4], bool two,
                                              int scale) {
  constexpr uint64_t kStep = (8 * 8 * kNt * sizeof(float)) >> 4;  // one k8 step, in 16 B
  const uint64_t hi = kmajor_desc(image);
  const uint64_t lo = kmajor_desc(image + kChunk * 8 * kNt);
  fence_operands(acc);
  wgmma_fence();
  Wgmma<kNt>::mma(acc, al[0], hi, scale);
  Wgmma<kNt>::mma(acc, ah[0], lo, 1);
  Wgmma<kNt>::mma(acc, ah[0], hi, 1);
  if (two) {
    Wgmma<kNt>::mma(acc, al[1], hi + kStep, 1);
    Wgmma<kNt>::mma(acc, ah[1], lo + kStep, 1);
    Wgmma<kNt>::mma(acc, ah[1], hi + kStep, 1);
  }
  wgmma_commit();
}

// One image of a column pass: wait for its slot, start its products, free
// the previous image's slot once those are done, then load the next image's
// A into the registers they read; at the end of every kFlush images (and
// of the pass), wait for the products, free the slot and add acc to total.
template <int kNt, int kFlush>
__device__ __forceinline__ void column_step(int kc, int chunks, const float* a_ptr, int lda,
                                            int depth, bool rows_in, Ring& r,
                                            float (&acc)[4 * kNt],
                                            float (&total)[4 * kMaxNt],
                                            const uint32_t (&h)[2][4],
                                            const uint32_t (&l)[2][4],
                                            uint32_t (&h_next)[2][4],
                                            uint32_t (&l_next)[2][4]) {
  const bool lane0 = threadIdx.x % 32 == 0;
  const int slot = r.consumed % r.stages;
  mbar_wait(&r.full[slot], (r.consumed / r.stages) & 1);
  image_product<kNt>(acc, r.slots + slot * r.slot, h, l, depth - kc * kChunk > 8,
                     kc % kFlush == 0 ? 0 : 1);
  wgmma_wait<1>();
  if (kc % kFlush != 0) mbar_arrive_if(&r.empty[(r.consumed - 1) % r.stages], lane0);
  if (kc + 1 < chunks) load_a(a_ptr, lda, (kc + 1) * kChunk, depth, rows_in, h_next, l_next);
  if (kc % kFlush == kFlush - 1 || kc + 1 == chunks) {
    wgmma_wait<0>();
    fence_operands(acc);
    mbar_arrive_if(&r.empty[slot], lane0);
#pragma unroll
    for (int i = 0; i < 4 * kNt; ++i) total[i] += acc[i];
  }
  ++r.consumed;
}

// This warpgroup's column pass: total = src . M[:, its 8 * kNt columns] over
// the pass's depth, through its ring. The products of one image run while
// the next image's A fragments are loaded and split; a slot is freed once
// its products are done; acc is added to the f32 total and started afresh
// every kFlush images. rows_in: this warp's 16 rows lie in the block (a
// 32-row block's warps 2 and 3 multiply zeros).
template <int kNt>
__device__ __forceinline__ void column_product(const float* src, int lda, int depth,
                                               bool rows_in, Ring& r,
                                               float (&total)[4 * kMaxNt]) {
  constexpr int kFlush = 2;  // 4 was no faster, and never flushing tripled the error
  const int lane = threadIdx.x % 32;
  const int row = 16 * (threadIdx.x / 32 % 4) + lane / 4;
  const float* a_ptr = src + row * lda + 2 * (lane % 4);
  const int chunks = (depth + kChunk - 1) / kChunk;
  float acc[4 * kNt];
#pragma unroll
  for (int i = 0; i < 4 * kNt; ++i) {
    acc[i] = 0.0f;
    total[i] = 0.0f;
  }
  uint32_t ah[2][2][4], al[2][2][4];  // A of the image in flight and of the next
  load_a(a_ptr, lda, 0, depth, rows_in, ah[0], al[0]);
  for (int kc = 0; kc < chunks; kc += 2) {
    column_step<kNt, kFlush>(kc, chunks, a_ptr, lda, depth, rows_in, r, acc, total, ah[0],
                             al[0], ah[1], al[1]);
    if (kc + 1 < chunks) {
      column_step<kNt, kFlush>(kc + 1, chunks, a_ptr, lda, depth, rows_in, r, acc, total,
                               ah[1], al[1], ah[0], al[0]);
    }
  }
}

// Pass p over the block's activations src ([kBm][lda], row-major), run by
// the two consumer warpgroups, each through its own ring, on alternate
// column passes: for each of its column passes, z = src . M[:, cols] (+
// bias[n] where bias is given) on the tensor cores, then epi(r, n, z0, z1,
// x0, x1, valid) for each pair of columns (n, n + 1), n even, that this
// thread holds of row r < kBm; valid for every n below round8(width) (the
// epilogue writes zero where n >= width), and the epilogue stores nothing
// where it is false. It is called for every pair, valid or not, so that
// its arithmetic runs without branches. x0, x1: aux[r * aux_ld + n] and
// [... + n + 1] for rows r < rows and columns below width where aux is
// given, else 0. The bias is loaded before the column pass's products, so
// that its latency hides behind them, aux after them; while one warpgroup
// runs its epilogue, the other's products keep the tensor cores busy.
// Starts with a consumer barrier, so src may have been written just
// before.
template <int kBm, class Epilogue>
__device__ __forceinline__ void run_pass(const Tower& t, const Plan& plan, int p,
                                         const float* src, int lda, Ring& r,
                                         const float* __restrict__ bias,
                                         const float* __restrict__ aux, int aux_ld,
                                         int rows, Epilogue epi) {
  int layer;
  bool tr;
  pass_of(t, plan.back, p, layer, tr);
  const int depth = pass_depth(t, layer, tr);
  const int width = pass_width(t, layer, tr);
  const int n_cols = col_width(width);
  const int lane = threadIdx.x % 32;
  const int row = 16 * (warp_index() % 4) + lane / 4;
  const bool rows_in = 16 * (warp_index() % 4) < kBm;  // the same in a warp
  const int end = round8(width);  // the padding past the layer stays out
  const int wg = warpgroup_index();
  consumer_sync();
  for (int i = 0; i < col_passes(width) / 2; ++i) {
    const int cp = 2 * i + wg;
    // loads from clamped addresses and selects, no branches: a branch before
    // the products would serialize them
    float b[kMaxNt][2];  // bias of the thread's columns, before the products
#pragma unroll
    for (int j = 0; j < kMaxNt; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = cp * n_cols + 8 * j + 2 * (lane % 4) + e;
        b[j][e] = 0.0f;
        if (bias != nullptr) b[j][e] = __ldg(bias + min(n, width - 1));
        b[j][e] = 8 * j < n_cols && n < width ? b[j][e] : 0.0f;
      }
    }
    float total[4 * kMaxNt];
    switch (n_cols / 8) {
#define TOWER_CASE(N)                                                 \
  case N:                                                             \
    column_product<N>(src, lda, depth, rows_in, r, total);            \
    break;
      TOWER_CASE(1) TOWER_CASE(2) TOWER_CASE(3) TOWER_CASE(4)
      TOWER_CASE(5) TOWER_CASE(6) TOWER_CASE(7) TOWER_CASE(8)
#undef TOWER_CASE
      default:
        break;
    }
    // aux after the products, all loads issued before their first use: held
    // across the products, its registers made ptxas serialize them (C7511)
    float x[kMaxNt][2][2];  // [n8 tile][row, row + 8][column n, n + 1]
#pragma unroll
    for (int j = 0; j < kMaxNt; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = cp * n_cols + 8 * j + 2 * (lane % 4) + e;
        const bool in = 8 * j < n_cols && n < width;
        x[j][0][e] = x[j][1][e] = 0.0f;
        if (aux != nullptr) {  // aux may be written earlier in the kernel: L2 loads
          const int nc = min(n, width - 1);
          const float x0 = __ldcg(aux + static_cast<size_t>(min(row, rows - 1)) * aux_ld + nc);
          const float x1 = __ldcg(aux + static_cast<size_t>(min(row + 8, rows - 1)) * aux_ld + nc);
          x[j][0][e] = in && row < rows ? x0 : 0.0f;
          x[j][1][e] = in && row + 8 < rows ? x1 : 0.0f;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kMaxNt; ++j) {
      const int n8 = cp * n_cols + 8 * j;
      const bool valid = rows_in && 8 * j < n_cols && n8 < end;
      const int n = n8 + 2 * (lane % 4);
      epi(row, n, total[4 * j] + b[j][0], total[4 * j + 1] + b[j][1], x[j][0][0], x[j][0][1],
          valid);
      epi(row + 8, n, total[4 * j + 2] + b[j][0], total[4 * j + 3] + b[j][1], x[j][1][0],
          x[j][1][1], valid);
    }
  }
}

// Producer warp w of the block: its first thread feeds ring w.
__device__ __forceinline__ void produce_for(int w, const Tower& t, const Plan& plan,
                                            const float* __restrict__ packed,
                                            Ring (&rings)[2]) {
  if (threadIdx.x % 32 == 0) produce(t, plan, packed, w, rings[w]);
}

// The batch tile x[row0 : row0 + kBm, :] -> dst ([kBm][ld]), by the
// consumer threads, eight loads in flight a thread; rows past the batch and
// columns in [in_dim, round8(in_dim)) are zero.
template <int kBm>
__device__ __forceinline__ void load_rows(const float* __restrict__ x,
                                          int in_dim, int row0, int rows,
                                          float* dst, int ld) {
  constexpr int kBatch = 8;
  const int cols = round8(in_dim);
  for (int i0 = threadIdx.x; i0 < kBm * cols; i0 += kBatch * kThreads) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads;
      const int r = i / cols;
      const int k = i - r * cols;
      v[u] = i < kBm * cols && r < rows && k < in_dim
                 ? __ldg(x + static_cast<size_t>(row0 + r) * in_dim + k)
                 : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads;
      const int r = i / cols;
      if (i < kBm * cols) dst[r * ld + (i - r * cols)] = v[u];
    }
  }
}

}  // namespace tower
