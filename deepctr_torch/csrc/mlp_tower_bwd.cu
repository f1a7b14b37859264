// Fused dense-tower backward for Hopper (sm_90a): CUDA C++ behind a plain C
// entry point, loaded with ctypes by deepctr_torch/ops/kernels/mlp.py.
//
// Replaces the Pallas kernel deepctr_tpu/ops/pallas/mlp.py::_tower_bwd
// (body _make_bwd_kernel, VJP rule _tower_bwd_rule): given x, the layers and
// the logit's upstream gradient g[B] (which enters column 0 of the last
// layer only), it recomputes the forward with the same dropout masks and
// returns gx[B, in], and gW_l = a_l^T . gh_l and gb_l = sum_rows gh_l for
// every layer, where a_l is layer l's (masked) input and gh_l the gradient
// of its pre-activation output. 1 to 8 layers, any widths that fit shared
// memory, tanh/relu/sigmoid, any B, with or without dropout.
//
// What bounds it on an H100: at FNN widths (176-200-300-100-1) and B = 8192
// it is 6.16 GFLOP (the forward recompute, the transposed gh chain and the
// weight-gradient products, 751,600 FLOP a row) against 12.6 MB of inputs
// and outputs: arithmetic-bound, 91.9 us on the CUDA cores' 67 TFLOP/s f32,
// 37.3 us at the tensor cores' 165 TFLOP/s of 3xTF32. The weights (504 KB)
// do not fit a block's shared memory, so they stream from L2. The weight
// gradients are a reduction over the whole batch: the TPU kernel carries
// them through its sequential grid, but blocks on the card run in no order,
// and float atomics would make every launch's bits differ.
//
// What the design does about it, in four launches on one stream, every
// product on the tensor cores in 3xTF32 (wgmma; tower_tile.cuh says how):
// 1. pack kernel: the weight images of the walk (the hidden layers' forward
//    passes, then every layer's transposed pass), split hi and lo.
// 2. rows kernel, one block per 64-row tile (32 for towers too wide for 64),
//    two consumer warpgroups and two producer warps: the forward recompute
//    writes each hidden layer's masked output a_l to the workspace and,
//    into the slot gh_l will later take, its activation derivative act'
//    (from the output, as _act_deriv takes it). The transposed passes then
//    walk gh = (gh . W_l^T) * mask * act', reading act' back from that slot
//    before each column pass's products (the workspace is 39 MB at B = 8192,
//    mostly L2-resident), overwriting it with gh_l, recomputing the mask
//    from the hash, and write gx. Shared memory holds the two ping-pong
//    activation buffers and the two rings of weight images: keeping act'
//    there too would take 307 KB at 64 rows. B = 8192 is 128 blocks, one
//    wave on 132 SMs.
// 3. weight-gradient kernel: gW_l and gb_l as [in + 1, out] products of the
//    workspace (a_l with a column of ones for the bias) over a fixed split
//    of the batch into groups of rows (about one block an SM); each block
//    owns a 128 x 64 output tile of one group, steps over its rows 32 at a
//    time, and writes the tile to its own partial slot. Two tensor copies
//    (TMA) a step bring the rows (per-row copies were bound by the copy
//    engine's issue rate, about 65 cycles each); a warpgroup writes gh as
//    the K-major B image with 16-byte stores (its first version, one
//    element a thread, set the pace at 1.7 us a step). Tensor copies take
//    rows of 16-byte multiples only: an input width that is not a multiple
//    of 4 (Criteo's 663 = 39 x 17) is first copied into the workspace at
//    the next such stride, one more launch (the per-thread copies that
//    served such widths before took half the step at [8192, 663]).
// 4. reduce kernel: each element of every gW_l and gb_l sums its groups'
//    partials in group order.
// No atomics anywhere, and the split depends only on B, the tower and the
// card: two launches on the same inputs give the same bits.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "dropout_hash.cuh"
#include "tower_tile.cuh"

namespace {

using namespace tower;

constexpr int kWthreads = kThreads + 128;  // two consumer warpgroups and one that copies
constexpr int kWm = 128;         // rows of gW (inputs k) a block owns, 64 a warpgroup
constexpr int kWn = 64;          // columns of gW (outputs n) a block owns
constexpr int kWr = 32;          // batch rows per step
constexpr int kWstages = 4;      // steps in the ring
// a step: a rows [kWr][kWm], gh rows [kWr][kWn] (as a tensor copy lays them
// down), and gh as the K-major B image (hi, then lo)
constexpr int kWimageFloats = 2 * kWr * kWn;
constexpr int kWstepFloats = kWr * (kWm + kWn) + kWimageFloats;
constexpr size_t kWsmem = sizeof(float) * kWstages * kWstepFloats;  // 160 KB
constexpr int kMaxSplits = 64;

// The workspace of the rows kernel: hidden layer l's masked output a[l]
// (the input of layer l + 1) and the gradient gh[l] of its pre-activation
// output, both [batch, dims[l + 1]]. Between the two walks gh[l] holds the
// activation derivative of layer l.
struct Scratch {
  float* a[kMaxLayers];
  float* gh[kMaxLayers];
};

struct WgradLayer {
  const float* a;   // layer input [batch, k_dim], row stride a_ld
  const float* gh;  // output gradient, row stride gh_ld, gh_cols nonzero columns
  int k_dim, n_dim, a_ld, gh_ld, gh_cols;
  int tile0;        // first output tile of this layer
  size_t part_off;  // offset of its [k_dim + 1, n_dim] block in a partial slot
  bool tma;         // a and gh come by tensor copies (maps a and gh below)
};

// The tensor maps of the layers whose rows tensor copies can take (16-byte
// row strides): a as [batch, k_dim] in boxes of [kWr, kWm], gh as [batch,
// n_dim] in boxes of [kWr, kWn], or, for the logit's single column, as
// [batch] in boxes of kWr. Rows and columns past the tensor land as zeros.
struct WgradMaps {
  CUtensorMap a[kMaxLayers];
  CUtensorMap gh[kMaxLayers];
};

struct Wgrad {
  WgradLayer layer[kMaxLayers];
  int num_layers;
  int rows_per_split;
  size_t part_stride;  // floats in one group's partial slot
};

// Output tiles of the weight-gradient kernel: [k_dim + 1, n_dim] blocks of
// kWm x kWn for every layer.
int wgrad_tiles(const Tower& t) {
  int tiles = 0;
  for (int l = 0; l < t.num_layers; ++l) {
    tiles += (t.dims[l] + 1 + kWm - 1) / kWm * ((t.dims[l + 1] + kWn - 1) / kWn);
  }
  return tiles;
}

struct Split {
  int groups, rows_per_group;
};

// The batch's split into groups of rows: about one weight-gradient block an
// SM, groups of whole steps. It depends only on the batch, the tower and the
// card, so two launches sum in the same order.
Split split_of(int batch, const Tower& t) {
  int device = 0, sms = 132;
  if (cudaGetDevice(&device) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  int groups = imax(1, imin(kMaxSplits, sms / wgrad_tiles(t)));
  groups = imin(groups, (batch + kWr - 1) / kWr);
  int rows = (batch + groups - 1) / groups;
  rows = (rows + kWr - 1) / kWr * kWr;
  return {(batch + rows - 1) / rows, rows};
}

template <int kBm>
__global__ void __launch_bounds__(kBlockThreads, 1)
    tower_bwd_rows_kernel(const float* __restrict__ x,
                          const float* __restrict__ g, int batch, Tower t,
                          int act, Dropout drop_arg, Plan plan,
                          const float* __restrict__ packed, Scratch ws,
                          float* __restrict__ gx) {
  extern __shared__ __align__(128) float smem[];
  const int ld = act_ld(plan.width);
  float* src = smem;
  float* dst = smem + kBm * ld;
  Ring rings[2] = {make_ring(smem, plan, 0), make_ring(smem, plan, 1)};
  init_rings(rings[0], rings[1]);
  // the roles: two producer warps (one a ring) and two consumer warpgroups,
  // written out here and not in a function or lambda, which ptxas might not
  // inline: products in a called function are serialized
  const int warp = warp_index();
  if (warp >= kThreads / 32) {
    produce_for(warp - kThreads / 32, t, plan, packed, rings);
  } else {
    Ring& ring = rings[warp / 4];
    const Dropout drop = resolve_seed(drop_arg);
    const int num_layers = t.num_layers;
    const int hidden = num_layers - 1;

    const int tid = threadIdx.x;
    const int row0 = blockIdx.x * kBm;
    const int rows = min(kBm, batch - row0);
    load_rows<kBm>(x, t.dims[0], row0, rows, src, ld);

    // forward recompute: each hidden layer's masked output to dst and to the
    // workspace's a[l], its act' to the workspace's gh[l]
    for (int l = 0; l < hidden; ++l) {
      const int n_out = t.dims[l + 1];
      float* __restrict__ a_out = ws.a[l];
      float* __restrict__ d_out = ws.gh[l];
      float* d = dst;
      const bool pairs = (n_out & 1) == 0;  // (n, n + 1) 8-byte aligned in a row
      run_pass<kBm>(t, plan, l, src, ld, ring, t.b[l], nullptr, 0, rows,
                    [&](int r, int n, float z0, float z1, float, float, bool valid) {
        float v[2], dv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool in = n + e < n_out;
          const float y = activate(e ? z1 : z0, act);
          dv[e] = in ? activate_deriv(y, act) : 0.0f;
          const float m = drop.on ? y * dropout_factor(drop, row0 + r, n + e, l) : y;
          v[e] = in ? m : 0.0f;
        }
        // predicated stores, no early return (see warp_index)
        if (valid) *reinterpret_cast<float2*>(d + r * ld + n) = make_float2(v[0], v[1]);
        const bool out = valid && r < rows && n < n_out;
        const size_t at = static_cast<size_t>(row0 + r) * n_out + n;
        if (pairs) {
          if (out) *reinterpret_cast<float2*>(a_out + at) = make_float2(v[0], v[1]);
          if (out) *reinterpret_cast<float2*>(d_out + at) = make_float2(dv[0], dv[1]);
        } else {
          if (out) a_out[at] = v[0];
          if (out) d_out[at] = dv[0];
          if (out && n + 1 < n_out) a_out[at + 1] = v[1];
          if (out && n + 1 < n_out) d_out[at + 1] = dv[1];
        }
      });
      float* tmp = src;
      src = dst;
      dst = tmp;
    }

    // the upstream gradient enters column 0 of the last layer
    consumer_sync();  // every read of dst (the last pass's input) is done
    const int d_last = round8(t.dims[num_layers]);
    for (int i = tid; i < kBm * d_last; i += kThreads) {
      const int r = i / d_last;
      const int n = i - r * d_last;
      dst[r * ld + n] = (n == 0 && r < rows) ? g[row0 + r] : 0.0f;
    }
    {
      float* tmp = src;
      src = dst;
      dst = tmp;
    }

    // backward: gh . W_l^T for l = L-1 .. 0, then mask and act' of the
    // hidden layer below, read from and replaced by gh[l - 1]; the last pass
    // writes gx
    for (int l = num_layers - 1; l >= 0; --l) {
      const int n_out = t.dims[l];
      const int p = hidden + (num_layers - 1 - l);
      const bool pairs = (n_out & 1) == 0;
      if (l > 0) {
        float* gh = ws.gh[l - 1];
        float* d = dst;
        // act' of the rows, read before the products (aux)
        run_pass<kBm>(t, plan, p, src, ld, ring, nullptr,
                      gh + static_cast<size_t>(row0) * n_out, n_out, rows,
                      [&](int r, int n, float v0, float v1, float d0, float d1,
                          bool valid) {
          const float dv[2] = {d0, d1};
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool in = r < rows && n + e < n_out;
            const float m = e ? v1 : v0;
            const float k = drop.on ? m * dropout_factor(drop, row0 + r, n + e, l - 1) : m;
            v[e] = in ? k * dv[e] : 0.0f;
          }
          if (valid) *reinterpret_cast<float2*>(d + r * ld + n) = make_float2(v[0], v[1]);
          const bool out = valid && r < rows && n < n_out;
          const size_t at = static_cast<size_t>(row0 + r) * n_out + n;
          if (pairs) {
            if (out) *reinterpret_cast<float2*>(gh + at) = make_float2(v[0], v[1]);
          } else {
            if (out) gh[at] = v[0];
            if (out && n + 1 < n_out) gh[at + 1] = v[1];
          }
        });
      } else {
        run_pass<kBm>(t, plan, p, src, ld, ring, nullptr, nullptr, 0, rows,
                      [&](int r, int n, float v0, float v1, float, float, bool valid) {
          const bool out = valid && r < rows && n < n_out;
          float* o = gx + static_cast<size_t>(row0 + r) * n_out + n;
          if (pairs) {
            if (out) *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
          } else {
            if (out) o[0] = v0;
            if (out && n + 1 < n_out) o[1] = v1;
          }
        });
      }
      float* tmp = src;
      src = dst;
      dst = tmp;
    }
  }
}

// Block (tile, group): a kWm x kWn tile of gW = [a | 1]^T . gh over the
// group's rows, on the tensor cores in 3xTF32 (wgmma, as in tower_tile.cuh),
// into the group's partial slot. Warpgroup w owns rows [64w, 64w + 64) of
// the tile; A = [a | 1]^T comes from registers, loaded from a step's a rows
// in shared memory (the bias's column of ones is put in there), and B = gh
// from the step's K-major hi and lo image. The rows come kWr at a time
// through a ring of kWstages steps, fed by a third warpgroup: its first
// warp copies a step's rows as soon as a slot is free (two tensor copies,
// or, for rows they cannot take, its lanes' cp.async), its other three
// write the gh rows as the image once they have landed and mark the step
// full; the consumers free the slot once their products on it are done.
// The products of a step run while the next step's A is loaded; the
// accumulator is added to an f32 total and started afresh every kFlush
// steps.
constexpr int kFlushSteps = 2;

struct WgradStep {
  const float* wsm;
  uint64_t* full;
  uint64_t* empty;
  int steps, m, k_ones;  // the tile's row of this thread; the row of the ones
};

// A of a step for this thread, split: [a | 1]^T rows m and m + 8, batch rows
// ks * 8 + lane % 4 (+ 4).
__device__ __forceinline__ void wgrad_load(const WgradStep& w, int step,
                                           uint32_t (&h)[kWr / 8][4],
                                           uint32_t (&l)[kWr / 8][4]) {
  const float* A = w.wsm + step % kWstages * kWstepFloats;
  const int tq = threadIdx.x % 4;
#pragma unroll
  for (int ks = 0; ks < kWr / 8; ++ks) {
    const float* r0 = A + (ks * 8 + tq) * kWm + w.m;
    const float v[4] = {r0[0], r0[8], r0[4 * kWm], r0[4 * kWm + 8]};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ones = w.m + (e & 1) * 8 == w.k_ones;
      split_tf32(ones ? 1.0f : v[e], h[ks][e], l[ks][e]);
    }
  }
}

template <int kNt>
__device__ __forceinline__ void wgrad_step(const WgradStep& w, int step, float (&acc)[4 * kNt],
                                           float (&total)[4 * kMaxNt],
                                           const uint32_t (&h)[kWr / 8][4],
                                           const uint32_t (&l)[kWr / 8][4],
                                           uint32_t (&h_next)[kWr / 8][4],
                                           uint32_t (&l_next)[kWr / 8][4]) {
  // the image holds kWn columns whatever the tile's N
  constexpr uint64_t kStep = (8 * kWn * sizeof(float)) >> 4;  // one k8 step, in 16 B
  const bool lane0 = threadIdx.x % 32 == 0;
  const float* image = w.wsm + step % kWstages * kWstepFloats + kWr * (kWm + kWn);
  const uint64_t hi = kmajor_desc(image);
  const uint64_t lo = kmajor_desc(image + kWr * kWn);
  fence_operands(acc);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kWr / 8; ++ks) {
    Wgmma<kNt>::mma(acc, l[ks], hi + ks * kStep, ks == 0 && step % kFlushSteps == 0 ? 0 : 1);
    Wgmma<kNt>::mma(acc, h[ks], lo + ks * kStep, 1);
    Wgmma<kNt>::mma(acc, h[ks], hi + ks * kStep, 1);
  }
  wgmma_commit();
  wgmma_wait<1>();
  if (step % kFlushSteps != 0) mbar_arrive_if(&w.empty[(step - 1) % kWstages], lane0);
  if (step + 1 < w.steps) {
    mbar_wait(&w.full[(step + 1) % kWstages], ((step + 1) / kWstages) & 1);
    wgrad_load(w, step + 1, h_next, l_next);
  }
  if (step % kFlushSteps == kFlushSteps - 1 || step + 1 == w.steps) {
    wgmma_wait<0>();
    fence_operands(acc);
    mbar_arrive_if(&w.empty[step % kWstages], lane0);
#pragma unroll
    for (int i = 0; i < 4 * kNt; ++i) total[i] += acc[i];
  }
}

template <int kNt>
__device__ __forceinline__ void wgrad_steps(const WgradStep& w, float (&total)[4 * kMaxNt]) {
  float acc[4 * kNt];
#pragma unroll
  for (int i = 0; i < 4 * kNt; ++i) {
    acc[i] = 0.0f;
    total[i] = 0.0f;
  }
  if (w.steps == 0) return;
  uint32_t ah[2][kWr / 8][4], al[2][kWr / 8][4];
  mbar_wait(&w.full[0], 0);
  wgrad_load(w, 0, ah[0], al[0]);
  for (int step = 0; step < w.steps; step += 2) {
    wgrad_step<kNt>(w, step, acc, total, ah[0], al[0], ah[1], al[1]);
    if (step + 1 < w.steps) wgrad_step<kNt>(w, step + 1, acc, total, ah[1], al[1], ah[0], al[0]);
  }
}

// Step i's rows [r0, r0 + kWr) of a and gh into the step's slot by the
// copy warp's cp.async, for rows that tensor copies cannot take (zero past
// the group's rows; the columns past the matrix hold zeros from the start).
__device__ __forceinline__ void wgrad_copy(const WgradLayer& L, float* slot, int r0,
                                           int r_end, int k0, int n0, int a_cols,
                                           int g_cols) {
  const int t = threadIdx.x % 32;
  float* A = slot;
  float* G = A + kWr * kWm;
  for (int q = t; q < kWr * kWm; q += 32) {
    const int rr = q / kWm;
    const int c = q % kWm;
    const int r = r0 + rr;
    if (c < a_cols) {
      const bool in = r < r_end;
      cp_async4(A + q, in ? L.a + static_cast<size_t>(r) * L.a_ld + k0 + c : L.a, in);
    }
  }
  for (int q = t; q < kWr * kWn; q += 32) {
    const int rr = q / kWn;
    const int c = q % kWn;
    const int r = r0 + rr;
    if (c < g_cols) {
      const bool in = r < r_end;
      cp_async4(G + q, in ? L.gh + static_cast<size_t>(r) * L.gh_ld + n0 + c : L.gh, in);
    }
  }
}

// The step's gh rows as the K-major B image: element (row k, column n) of a
// k8 step at (n / 8) * 64 + (k % 8 / 4) * 32 + (n % 8) * 4 + k % 4, hi image
// then lo image. A thread takes four rows k of one column n at a time: four
// loads without bank conflicts and one 16-byte store into each image.
// column: gh is the logit's single column, laid down as kWr floats.
__device__ __forceinline__ void wgrad_image(float* slot, bool column) {
  constexpr int kPackers = 96;  // the copying warpgroup's warps 1 to 3
  constexpr int kQuads = kWr * kWn / 4;
  const float* G = slot + kWr * kWm;
  float* image = slot + kWr * (kWm + kWn);
  const int t = threadIdx.x - kThreads - 32;
#pragma unroll 2
  for (int q = t; q < kQuads; q += kPackers) {
    const int n = q % kWn;
    const int k = q / kWn * 4;  // rows k to k + 3
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[i] = column ? (n == 0 ? G[k + i] : 0.0f) : G[(k + i) * kWn + n];
    }
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(v[i], hi[i], lo[i]);
    const int at = k / 8 * 8 * kWn + n / 8 * 64 + k % 8 / 4 * 32 + n % 8 * 4;
    *reinterpret_cast<uint4*>(image + at) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(image + kWr * kWn + at) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void tensor_copy_2d(void* dst, const CUtensorMap* map, int c0,
                                               int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void tensor_copy_1d(void* dst, const CUtensorMap* map, int c0,
                                               uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2}], [%3];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(smem_addr(bar))
      : "memory");
}

__global__ void __launch_bounds__(kWthreads, 1)
    tower_wgrad_kernel(Wgrad wg, const __grid_constant__ WgradMaps maps, int batch,
                       float* __restrict__ partials) {
  extern __shared__ __align__(128) float wsm[];  // kWstages x {a, gh, image}
  __shared__ uint64_t raw[kWstages], full[kWstages], empty[kWstages];
  const int tile = blockIdx.x;
  const int group = blockIdx.y;
  int l = 0;
  while (l + 1 < wg.num_layers && tile >= wg.layer[l + 1].tile0) ++l;
  const WgradLayer L = wg.layer[l];
  const int tiles_n = (L.n_dim + kWn - 1) / kWn;
  const int k0 = (tile - L.tile0) / tiles_n * kWm;
  const int n0 = (tile - L.tile0) % tiles_n * kWn;
  const int r_begin = group * wg.rows_per_split;
  const int r_end = min(batch, r_begin + wg.rows_per_split);
  const int a_cols = max(0, min(kWm, L.k_dim - k0));    // copied columns
  const int g_cols = max(0, min(kWn, L.gh_cols - n0));
  const bool column = L.tma && L.gh_cols == 1;
  const int tid = threadIdx.x;
  const int steps = (r_end - r_begin + kWr - 1) / kWr;

  if (!L.tma) {  // the columns no copy writes hold zeros
    for (int i = tid; i < kWstages * kWr * kWm; i += kWthreads) {
      const int st = i / (kWr * kWm);
      const int q = i % (kWr * kWm);
      float* A = wsm + st * kWstepFloats;
      if (q % kWm >= a_cols) A[q] = 0.0f;
      if (q < kWr * kWn && q % kWn >= g_cols) A[kWr * kWm + q] = 0.0f;
    }
  }
  if (tid == 0) {
    for (int s = 0; s < kWstages; ++s) {
      mbar_init(&raw[s], L.tma ? 1 : 32);
      mbar_init(&full[s], 96);
      mbar_init(&empty[s], kThreads / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int warp = warp_index();
  if (warp >= kThreads / 32 + 1) {
    // the copying warpgroup's warps 1 to 3: each step's gh rows as its image
    // once they have landed (raw), then the step is full
    for (int j = 0; j < steps; ++j) {
      mbar_wait(&raw[j % kWstages], (j / kWstages) & 1);
      wgrad_image(wsm + j % kWstages * kWstepFloats, column);
      mbar_arrive(&full[j % kWstages]);
    }
  } else if (warp == kThreads / 32) {
    // its warp 0: each step's rows into its slot once the slot is free
    for (int i = 0; i < steps; ++i) {
      const int st = i % kWstages;
      float* slot = wsm + st * kWstepFloats;
      const int r0 = r_begin + i * kWr;
      if (i >= kWstages) mbar_wait(&empty[st], (i / kWstages - 1) & 1);
      if (L.tma) {
        if (tid % 32 == 0) {
          const uint32_t g_bytes = sizeof(float) * kWr * (column ? 1 : kWn);
          mbar_arrive_expect(&raw[st], sizeof(float) * kWr * kWm + g_bytes);
          tensor_copy_2d(slot, &maps.a[l], k0, r0, &raw[st]);
          if (column) {
            tensor_copy_1d(slot + kWr * kWm, &maps.gh[l], r0, &raw[st]);
          } else {
            tensor_copy_2d(slot + kWr * kWm, &maps.gh[l], n0, r0, &raw[st]);
          }
        }
      } else {
        wgrad_copy(L, slot, r0, r_end, k0, n0, a_cols, g_cols);
        mbar_arrive_cp_async(&raw[st]);
      }
    }
  } else {
    float total[4 * kMaxNt];
    const int lane = tid % 32;
    const int m = 16 * warp + lane / 4;  // the tile's row of this thread
    const WgradStep w = {wsm, full, empty, steps, m, L.k_dim - k0};
    switch (round8(min(kWn, L.n_dim - n0)) / 8) {
#define WGRAD_CASE(N)                \
  case N:                            \
    wgrad_steps<N>(w, total);        \
    break;
      WGRAD_CASE(1) WGRAD_CASE(2) WGRAD_CASE(3) WGRAD_CASE(4)
      WGRAD_CASE(5) WGRAD_CASE(6) WGRAD_CASE(7) WGRAD_CASE(8)
#undef WGRAD_CASE
      default:
        break;
    }
    const int nt = round8(min(kWn, L.n_dim - n0)) / 8;
    float* __restrict__ part = partials + group * wg.part_stride + L.part_off;
#pragma unroll
    for (int j = 0; j < kMaxNt; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = k0 + m + (e >= 2 ? 8 : 0);
        const int n = n0 + 8 * j + 2 * (lane % 4) + (e & 1);
        if (j < nt && k <= L.k_dim && n < L.n_dim) {
          part[static_cast<size_t>(k) * L.n_dim + n] = total[4 * j + e];
        }
      }
    }
  }
}

struct Outputs {
  float* gw[kMaxLayers];
  float* gb[kMaxLayers];
};

// One thread per element of every [k_dim + 1, n_dim] block: the sum of its
// groups' partials, in group order; the last row is the bias gradient.
__global__ void tower_wgrad_reduce_kernel(Wgrad wg, int groups,
                                          const float* __restrict__ partials,
                                          Outputs o) {
  const size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= wg.part_stride) return;
  int l = 0;
  while (l + 1 < wg.num_layers && e >= wg.layer[l + 1].part_off) ++l;
  const WgradLayer& L = wg.layer[l];
  const size_t idx = e - L.part_off;
  float sum = 0.0f;
  for (int s = 0; s < groups; ++s) sum += partials[s * wg.part_stride + e];
  const size_t n_w = static_cast<size_t>(L.k_dim) * L.n_dim;
  if (idx < n_w) {
    o.gw[l][idx] = sum;
  } else {
    o.gb[l][idx - n_w] = sum;
  }
}

template <int kBm>
cudaError_t launch_rows(const float* x, const float* g, int batch, const Tower& t,
                        int act, const Dropout& drop, const Plan& plan, size_t smem,
                        const float* packed, const Scratch& ws, float* gx,
                        cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(tower_bwd_rows_kernel<kBm>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  tower_bwd_rows_kernel<kBm><<<(batch + kBm - 1) / kBm, kBlockThreads, smem, stream>>>(
      x, g, batch, t, act, drop, plan, packed, ws, gx);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled, from the driver through the runtime (the library
// links no libcuda); null where the driver does not have it.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) {
      return static_cast<EncodeTiled>(nullptr);
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A rank-1 or rank-2 f32 tensor map: dims and box innermost first; rows
// `stride` floats apart. Zeros past the tensor.
bool encode(CUtensorMap& map, const float* base, int rank, const cuuint64_t* dims,
            uint64_t stride, const cuuint32_t* box) {
  const EncodeTiled fn = encode_tiled();
  const cuuint64_t strides[1] = {sizeof(float) * stride};
  const cuuint32_t ones[2] = {1, 1};
  return fn != nullptr &&
         fn(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank, const_cast<float*>(base), dims,
            strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Layer L's maps (WgradMaps), where its rows are 16-byte multiples at
// 16-byte addresses; false where tensor copies cannot take them.
bool encode_maps(const WgradLayer& L, int batch, CUtensorMap& a, CUtensorMap& gh) {
  const auto aligned = [](const float* p, int ld) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && (ld & 3) == 0;
  };
  if (!aligned(L.a, L.a_ld)) return false;
  const cuuint64_t a_dims[2] = {static_cast<cuuint64_t>(L.k_dim),
                                static_cast<cuuint64_t>(batch)};
  const cuuint32_t a_box[2] = {kWm, kWr};
  if (!encode(a, L.a, 2, a_dims, L.a_ld, a_box)) return false;
  if (L.gh_cols == 1) {  // the logit's column: contiguous over the rows
    const cuuint64_t dims[1] = {static_cast<cuuint64_t>(batch)};
    const cuuint32_t box[1] = {kWr};
    return (reinterpret_cast<uintptr_t>(L.gh) & 15) == 0 && encode(gh, L.gh, 1, dims, 0, box);
  }
  if (!aligned(L.gh, L.gh_ld)) return false;
  const cuuint64_t g_dims[2] = {static_cast<cuuint64_t>(L.gh_cols),
                                static_cast<cuuint64_t>(batch)};
  const cuuint32_t g_box[2] = {kWn, kWr};
  return encode(gh, L.gh, 2, g_dims, L.gh_ld, g_box);
}

// Row stride of the weight-gradient kernel's copy of x: the input width
// rounded up to 4 floats, so that tensor copies take its rows (16-byte
// strides). An input of a width that is already a multiple of 4 is read in
// place (stride 0 here).
int x_copy_ld(const Tower& t) { return t.dims[0] % 4 == 0 ? 0 : (t.dims[0] + 3) / 4 * 4; }

// x [batch, k] into rows ld floats apart; the columns past k are not read.
__global__ void tower_x_copy_kernel(const float* __restrict__ x, int batch, int k,
                                    int ld, float* __restrict__ out) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<size_t>(batch) * k) return;
  const size_t r = i / k;
  out[r * ld + (i - r * k)] = x[i];
}

// floats of the rows kernel's workspace, of the partial slots, of the
// weight images and of the copy of x; false where the tower is too wide
// for the rows kernel
bool workspace_floats(const Tower& t, int batch, size_t& scratch,
                      size_t& partials, size_t& packed, size_t& x_copy) {
  x_copy = static_cast<size_t>(batch) * x_copy_ld(t);  // a multiple of 4
  scratch = 0;
  for (int l = 0; l + 1 < t.num_layers; ++l) {
    scratch += 2 * static_cast<size_t>(batch) * t.dims[l + 1];
  }
  size_t stride = 0;
  for (int l = 0; l < t.num_layers; ++l) {
    stride += static_cast<size_t>(t.dims[l] + 1) * t.dims[l + 1];
  }
  partials = stride * split_of(batch, t).groups;
  Plan plan;
  size_t smem;
  if (!make_plan(t, true, plan, smem)) return false;
  packed = (plan.packed_floats + 3) / 4 * 4;  // the next region 16-byte aligned
  return true;
}

}  // namespace

// Dynamic shared memory bytes of a weight-gradient block.
extern "C" size_t mlp_tower_wgrad_smem_bytes() { return kWsmem; }

// Bytes of device workspace mlp_tower_bwd needs for this batch and tower
// (dims: host int[num_layers + 1]); 0 for invalid arguments.
extern "C" size_t mlp_tower_bwd_workspace(int batch, int num_layers,
                                          const void* dims) {
  Tower t;
  size_t scratch, partials, packed, x_copy;
  if (batch < 1 || !make_tower(num_layers, dims, nullptr, nullptr, t) ||
      !workspace_floats(t, batch, scratch, partials, packed, x_copy)) {
    return 0;
  }
  return sizeof(float) * (packed + x_copy + scratch + partials);
}

// x: f32 [batch, dims[0]]; g: f32 [batch], the gradient of the logits.
// dims, weights, biases as for mlp_tower_fwd, and the same dropout (rows
// count from 0; seed_ptr as there). gx: f32 [batch, dims[0]]; gws, gbs: host arrays of
// num_layers device pointers to f32 outputs shaped like the weights and
// biases. workspace: mlp_tower_bwd_workspace(...) bytes on the device.
// Returns a cudaError_t code; 0 means all three kernels launched.
extern "C" int mlp_tower_bwd(const void* x, int batch, int num_layers,
                             const void* dims, const void* weights,
                             const void* biases, const void* g, int activation,
                             int dropout_on, uint32_t seed, const void* seed_ptr,
                             uint32_t threshold, float scale, void* gx, const void* gws,
                             const void* gbs, void* workspace,
                             size_t workspace_bytes, void* stream) {
  Tower t;
  if (batch < 1 || activation < kTanh || activation > kSigmoid ||
      !make_tower(num_layers, dims, weights, biases, t)) {
    return cudaErrorInvalidValue;
  }
  size_t scratch_floats, partial_floats, packed_floats, x_copy_floats;
  if (!workspace_floats(t, batch, scratch_floats, partial_floats, packed_floats,
                        x_copy_floats) ||
      workspace_bytes <
          sizeof(float) * (packed_floats + x_copy_floats + scratch_floats + partial_floats) ||
      (reinterpret_cast<uintptr_t>(workspace) & 15) != 0) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout drop = {dropout_on != 0, seed, threshold, scale, 0u,
                        static_cast<const uint32_t*>(seed_ptr)};

  float* packed = static_cast<float*>(workspace);
  float* x_copy = packed + packed_floats;
  float* scratch = x_copy + x_copy_floats;
  float* partials = scratch + scratch_floats;
  Scratch ws = {};
  {
    float* p = scratch;
    for (int l = 0; l + 1 < num_layers; ++l) {
      const size_t n = static_cast<size_t>(batch) * t.dims[l + 1];
      ws.a[l] = p;
      ws.gh[l] = p + n;
      p += 2 * n;
    }
  }

  // 1. the weight images of the walk, then the rows kernel: 64 rows a block
  // where they fit, else 32 (a tower too wide for either was refused above,
  // and the caller raises)
  Plan plan;
  size_t smem = 0;
  make_plan(t, true, plan, smem);
  tower_pack_kernel<<<dim3(max_images(t, plan), plan.num_passes), 256, 0, st>>>(
      t, plan, packed);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const float* xf = static_cast<const float*>(x);
  const float* gf = static_cast<const float*>(g);
  float* gxf = static_cast<float*>(gx);
  err = plan.bm == 64
            ? launch_rows<64>(xf, gf, batch, t, activation, drop, plan, smem, packed,
                              ws, gxf, st)
            : launch_rows<32>(xf, gf, batch, t, activation, drop, plan, smem, packed,
                              ws, gxf, st);
  if (err != cudaSuccess) return err;

  // 2. weight gradients per group of rows, layer 0's from x, or from its
  // copy at a stride tensor copies take
  const int x_ld = x_copy_ld(t);
  if (x_ld != 0) {
    const size_t n = static_cast<size_t>(batch) * t.dims[0];
    tower_x_copy_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(
        xf, batch, t.dims[0], x_ld, x_copy);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const Split split = split_of(batch, t);
  Wgrad wg = {};
  WgradMaps maps = {};
  wg.num_layers = num_layers;
  wg.rows_per_split = split.rows_per_group;
  int tiles = 0;
  size_t off = 0;
  for (int l = 0; l < num_layers; ++l) {
    WgradLayer& L = wg.layer[l];
    const bool last = l == num_layers - 1;
    L.a = l > 0 ? ws.a[l - 1] : x_ld != 0 ? x_copy : xf;
    L.gh = last ? static_cast<const float*>(g) : ws.gh[l];
    L.k_dim = t.dims[l];
    L.n_dim = t.dims[l + 1];
    L.a_ld = l == 0 && x_ld != 0 ? x_ld : L.k_dim;
    L.gh_ld = last ? 1 : L.n_dim;
    L.gh_cols = last ? 1 : L.n_dim;
    L.tile0 = tiles;
    L.part_off = off;
    L.tma = encode_maps(L, batch, maps.a[l], maps.gh[l]);
    tiles += (L.k_dim + 1 + kWm - 1) / kWm * ((L.n_dim + kWn - 1) / kWn);
    off += static_cast<size_t>(L.k_dim + 1) * L.n_dim;
  }
  wg.part_stride = off;
  err = cudaFuncSetAttribute(tower_wgrad_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kWsmem));
  if (err != cudaSuccess) return err;
  tower_wgrad_kernel<<<dim3(tiles, split.groups), kWthreads, kWsmem, st>>>(
      wg, maps, batch, partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // 3. ordered reduce of the groups
  Outputs o = {};
  float* const* gw = static_cast<float* const*>(gws);
  float* const* gb = static_cast<float* const*>(gbs);
  for (int l = 0; l < num_layers; ++l) {
    o.gw[l] = gw[l];
    o.gb[l] = gb[l];
  }
  const int threads = 256;
  const size_t blocks = (off + threads - 1) / threads;
  tower_wgrad_reduce_kernel<<<static_cast<unsigned>(blocks), threads, 0, st>>>(
      wg, split.groups, partials, o);
  return cudaGetLastError();
}
