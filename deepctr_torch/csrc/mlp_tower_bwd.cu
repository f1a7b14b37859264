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
// What bounds it on an H100: the gh chain and the forward recompute are the
// forward's products twice over (about 500 kFLOP a row at FNN widths), f32
// FMA on the CUDA cores with the weights streamed from L2, as in the forward
// kernel (the 504 KB of weights do not fit a block's 227 KB of shared
// memory). The weight gradients are a reduction over the whole batch: the
// TPU kernel carries them through its sequential grid, but blocks on the
// card run in no order, and float atomics would make every launch's bits
// differ.
//
// What the design does about it, in three launches on one stream:
// 1. rows kernel, one block per 32-row tile (tower_tile.cuh): the forward
//    recompute keeps, in shared memory, each hidden layer's activation
//    derivative (taken from its output, as _act_deriv does) beside two
//    ping-pong buffers, and writes the masked hidden activations a_l to a
//    workspace. The transposed passes then walk gh = (gh . W_l^T) * mask *
//    act'(a), applying the mask by recomputing the hash, and write each gh_l
//    to the workspace and gx to its output. At FNN widths the tile needs
//    2 x 300 + 600 activation columns and the weight tile: 190 KB.
// 2. weight-gradient kernel: gW_l and gb_l as [in + 1, out] products of the
//    workspace (a_l with a column of ones for the bias) over a fixed split
//    of the batch into groups of rows; each block owns a 64 x 64 output tile
//    of one group and writes it to its own partial slot.
// 3. reduce kernel: each element of every gW_l and gb_l sums its groups'
//    partials in group order.
// No atomics anywhere, and the split depends only on B: two launches on the
// same inputs give the same bits.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "dropout_hash.cuh"
#include "tower_tile.cuh"

namespace {

using namespace tower;

constexpr int kWt = 64;        // weight-gradient output tile edge
constexpr int kWr = 32;        // batch rows per step of a weight-gradient tile
constexpr int kWs = kWt + 4;   // shared row stride of those steps
constexpr int kSplitRows = 512;   // target rows per group of the split
constexpr int kMaxSplits = 64;

// The workspace of the rows kernel: hidden layer l's masked output a[l]
// (the input of layer l + 1) and the gradient gh[l] of its pre-activation
// output, both [batch, dims[l + 1]].
struct Scratch {
  float* a[kMaxLayers];
  float* gh[kMaxLayers];
};

struct WgradLayer {
  const float* a;   // layer input [batch, k_dim]
  const float* gh;  // output gradient, row stride gh_ld, gh_cols nonzero columns
  int k_dim, n_dim, gh_ld, gh_cols;
  int tile0;        // first output tile of this layer
  size_t part_off;  // offset of its [k_dim + 1, n_dim] block in a partial slot
};

struct Wgrad {
  WgradLayer layer[kMaxLayers];
  int num_layers;
  int rows_per_split;
  size_t part_stride;  // floats in one group's partial slot
};

struct Split {
  int groups, rows_per_group;
};

Split split_of(int batch) {
  int groups = (batch + kSplitRows - 1) / kSplitRows;
  if (groups > kMaxSplits) groups = kMaxSplits;
  int rows = (batch + groups - 1) / groups;
  rows = (rows + kWr - 1) / kWr * kWr;
  return {(batch + rows - 1) / rows, rows};
}

size_t rows_smem_bytes(const Tower& t) {
  int width = 0;
  for (int l = 0; l <= t.num_layers; ++l) width = width > t.dims[l] ? width : t.dims[l];
  size_t cols = 2 * static_cast<size_t>(width);
  for (int l = 0; l + 1 < t.num_layers; ++l) cols += t.dims[l + 1];
  return sizeof(float) * (cols * kLd + kChunk * kWld);
}

__global__ void __launch_bounds__(kThreads)
    tower_bwd_rows_kernel(const float* __restrict__ x,
                          const float* __restrict__ g, int batch, Tower t,
                          int act, Dropout drop, int width, Scratch ws,
                          float* __restrict__ gx) {
  extern __shared__ __align__(16) float smem[];
  float* src = smem;
  float* dst = smem + width * kLd;
  float* deriv = smem + 2 * width * kLd;  // hidden layers' act', [dims][kLd]
  const int num_layers = t.num_layers;
  const int hidden = num_layers - 1;
  int deriv_cols = 0;
  for (int l = 0; l < hidden; ++l) deriv_cols += t.dims[l + 1];
  float* wtile = deriv + deriv_cols * kLd;  // [kChunk][kWld]

  const int tid = threadIdx.x;
  const int tx = tid % kTx;
  const int ty = tid / kTx;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, batch - row0);

  Stream s;
  s.num_passes = 2 * num_layers - 1;
  fetch_tile<true>(t, 0, 0, 0, s.staged);
  load_rows(x, t.dims[0], row0, rows, src);

  // forward recompute: keep act' of every hidden layer, store its masked
  // output to the workspace
  float* dl = deriv;
  for (int l = 0; l < hidden; ++l) {
    const int n_out = t.dims[l + 1];
    const float* __restrict__ bias = t.b[l];
    float* __restrict__ a_out = ws.a[l];
    run_pass<true>(t, l, src, wtile, s, [&](int n0, float (&acc)[4][4]) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx * 4 + j;
        if (n < n_out) {
          const float bn = __ldg(bias + n);
          float v[4], dv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = ty * 4 + i;
            v[i] = activate(acc[i][j] + bn, act);
            dv[i] = activate_deriv(v[i], act);
            if (drop.on) v[i] *= dropout_factor(drop, row0 + r, n, l);
            if (r < rows) a_out[static_cast<size_t>(row0 + r) * n_out + n] = v[i];
          }
          *reinterpret_cast<float4*>(dst + n * kLd + ty * 4) =
              make_float4(v[0], v[1], v[2], v[3]);
          *reinterpret_cast<float4*>(dl + n * kLd + ty * 4) =
              make_float4(dv[0], dv[1], dv[2], dv[3]);
        }
      }
    });
    dl += n_out * kLd;
    float* tmp = src;
    src = dst;
    dst = tmp;
  }

  // the upstream gradient enters column 0 of the last layer
  __syncthreads();  // every read of dst (the last pass's input) is done
  const int d_last = t.dims[num_layers];
  for (int i = tid; i < kRows * d_last; i += kThreads) {
    const int r = i / d_last;
    const int n = i - r * d_last;
    dst[n * kLd + r] = (n == 0 && r < rows) ? g[row0 + r] : 0.0f;
  }
  {
    float* tmp = src;
    src = dst;
    dst = tmp;
  }

  // backward: gh . W_l^T for l = L-1 .. 0, then mask and act' of the
  // hidden layer below; the last pass writes gx
  for (int l = num_layers - 1; l >= 0; --l) {
    const int n_out = t.dims[l];
    const int p = hidden + (num_layers - 1 - l);
    if (l > 0) dl -= n_out * kLd;
    float* __restrict__ gh_out = l > 0 ? ws.gh[l - 1] : gx;
    run_pass<true>(t, p, src, wtile, s, [&](int n0, float (&acc)[4][4]) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx * 4 + j;
        if (n < n_out) {
          float v[4];
          if (l > 0) {
            const float4 d4 = *reinterpret_cast<const float4*>(dl + n * kLd + ty * 4);
            const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              v[i] = acc[i][j];
              if (drop.on) v[i] *= dropout_factor(drop, row0 + ty * 4 + i, n, l - 1);
              v[i] *= dv[i];
            }
            *reinterpret_cast<float4*>(dst + n * kLd + ty * 4) =
                make_float4(v[0], v[1], v[2], v[3]);
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i) v[i] = acc[i][j];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = ty * 4 + i;
            if (r < rows) gh_out[static_cast<size_t>(row0 + r) * n_out + n] = v[i];
          }
        }
      }
    });
    float* tmp = src;
    src = dst;
    dst = tmp;
  }
}

// Block (tile, group): a 64 x 64 tile of [a | 1]^T . gh over the group's
// rows, into the group's partial slot.
__global__ void __launch_bounds__(kThreads)
    tower_wgrad_kernel(Wgrad wg, int batch, float* __restrict__ partials) {
  __shared__ __align__(16) float as[kWr * kWs];
  __shared__ __align__(16) float gs[kWr * kWs];
  const int tile = blockIdx.x;
  const int group = blockIdx.y;
  int l = 0;
  while (l + 1 < wg.num_layers && tile >= wg.layer[l + 1].tile0) ++l;
  const WgradLayer L = wg.layer[l];
  const int tiles_n = (L.n_dim + kWt - 1) / kWt;
  const int k0 = (tile - L.tile0) / tiles_n * kWt;
  const int n0 = (tile - L.tile0) % tiles_n * kWt;
  const int r_begin = group * wg.rows_per_split;
  const int r_end = min(batch, r_begin + wg.rows_per_split);

  const int tid = threadIdx.x;
  const int tx = tid % (kWt / 4);
  const int ty = tid / (kWt / 4);
  float acc[4][4] = {};
  for (int r0 = r_begin; r0 < r_end; r0 += kWr) {
    for (int e = tid; e < kWr * kWt; e += kThreads) {
      const int rr = e / kWt;
      const int cc = e % kWt;
      const int r = r0 + rr;
      const int k = k0 + cc;
      const int n = n0 + cc;
      float av = 0.0f, gv = 0.0f;
      if (r < r_end) {
        av = k < L.k_dim ? L.a[static_cast<size_t>(r) * L.k_dim + k]
                         : (k == L.k_dim ? 1.0f : 0.0f);
        if (n < L.gh_cols) gv = L.gh[static_cast<size_t>(r) * L.gh_ld + n];
      }
      as[rr * kWs + cc] = av;
      gs[rr * kWs + cc] = gv;
    }
    __syncthreads();
#pragma unroll 8
    for (int rr = 0; rr < kWr; ++rr) {
      const float4 a = *reinterpret_cast<const float4*>(as + rr * kWs + ty * 4);
      const float4 b = *reinterpret_cast<const float4*>(gs + rr * kWs + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
  float* __restrict__ part = partials + group * wg.part_stride + L.part_off;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (k <= L.k_dim && n < L.n_dim) {
        part[static_cast<size_t>(k) * L.n_dim + n] = acc[i][j];
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

bool make_tower(int num_layers, const void* dims, const void* weights,
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

// floats of the rows kernel's workspace, then of the partial slots
void workspace_floats(const Tower& t, int batch, size_t& scratch,
                      size_t& partials) {
  scratch = 0;
  for (int l = 0; l + 1 < t.num_layers; ++l) {
    scratch += 2 * static_cast<size_t>(batch) * t.dims[l + 1];
  }
  size_t stride = 0;
  for (int l = 0; l < t.num_layers; ++l) {
    stride += static_cast<size_t>(t.dims[l] + 1) * t.dims[l + 1];
  }
  partials = stride * split_of(batch).groups;
}

}  // namespace

// Bytes of device workspace mlp_tower_bwd needs for this batch and tower
// (dims: host int[num_layers + 1]); 0 for invalid arguments.
extern "C" size_t mlp_tower_bwd_workspace(int batch, int num_layers,
                                          const void* dims) {
  Tower t;
  if (batch < 1 || !make_tower(num_layers, dims, nullptr, nullptr, t)) return 0;
  size_t scratch, partials;
  workspace_floats(t, batch, scratch, partials);
  return sizeof(float) * (scratch + partials);
}

// x: f32 [batch, dims[0]]; g: f32 [batch], the gradient of the logits.
// dims, weights, biases as for mlp_tower_fwd, and the same dropout (rows
// count from 0). gx: f32 [batch, dims[0]]; gws, gbs: host arrays of
// num_layers device pointers to f32 outputs shaped like the weights and
// biases. workspace: mlp_tower_bwd_workspace(...) bytes on the device.
// Returns a cudaError_t code; 0 means all three kernels launched.
extern "C" int mlp_tower_bwd(const void* x, int batch, int num_layers,
                             const void* dims, const void* weights,
                             const void* biases, const void* g, int activation,
                             int dropout_on, uint32_t seed, uint32_t threshold,
                             float scale, void* gx, const void* gws,
                             const void* gbs, void* workspace,
                             size_t workspace_bytes, void* stream) {
  Tower t;
  if (batch < 1 || activation < kTanh || activation > kSigmoid ||
      !make_tower(num_layers, dims, weights, biases, t)) {
    return cudaErrorInvalidValue;
  }
  size_t scratch_floats, partial_floats;
  workspace_floats(t, batch, scratch_floats, partial_floats);
  if (workspace_bytes < sizeof(float) * (scratch_floats + partial_floats)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout drop = {dropout_on != 0, seed, threshold, scale, 0u};

  float* scratch = static_cast<float*>(workspace);
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

  // 1. rows kernel
  int width = 0;
  for (int l = 0; l <= num_layers; ++l) width = width > t.dims[l] ? width : t.dims[l];
  const size_t smem = rows_smem_bytes(t);
  // a tower too wide for shared memory fails here and is returned
  cudaError_t err = cudaFuncSetAttribute(
      tower_bwd_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  tower_bwd_rows_kernel<<<(batch + kRows - 1) / kRows, kThreads, smem, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(g), batch, t,
      activation, drop, width, ws, static_cast<float*>(gx));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // 2. weight gradients per group of rows
  const Split split = split_of(batch);
  Wgrad wg = {};
  wg.num_layers = num_layers;
  wg.rows_per_split = split.rows_per_group;
  int tiles = 0;
  size_t off = 0;
  for (int l = 0; l < num_layers; ++l) {
    WgradLayer& L = wg.layer[l];
    const bool last = l == num_layers - 1;
    L.a = l == 0 ? static_cast<const float*>(x) : ws.a[l - 1];
    L.gh = last ? static_cast<const float*>(g) : ws.gh[l];
    L.k_dim = t.dims[l];
    L.n_dim = t.dims[l + 1];
    L.gh_ld = last ? 1 : L.n_dim;
    L.gh_cols = last ? 1 : L.n_dim;
    L.tile0 = tiles;
    L.part_off = off;
    tiles += ((L.k_dim + 1 + kWt - 1) / kWt) * ((L.n_dim + kWt - 1) / kWt);
    off += static_cast<size_t>(L.k_dim + 1) * L.n_dim;
  }
  wg.part_stride = off;
  tower_wgrad_kernel<<<dim3(tiles, split.groups), kThreads, 0, st>>>(
      wg, batch, partials);
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
