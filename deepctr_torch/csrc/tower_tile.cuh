// Row-tile machinery shared by the fused tower's forward and backward kernels.
//
// A block owns kRows rows of the batch and keeps their activations in shared
// memory, column-major ([width][kLd]), so one depth step of a product reads
// four rows as one float4. A product of the tile with a layer's weights W
// [in, out] (a "pass") streams W from global memory (L2-resident after the
// first blocks) through a [kChunk x kCols] shared tile; each thread holds its
// share of the next tile in registers while the block computes on the
// current one, and the walk runs on across column blocks, layers and passes.
// Each thread keeps a 4x4 register tile of outputs: one depth step reads
// four activations and four weights as two float4 and issues 16 FMAs.
//
// A pass is forward (out = h . W, depth in, width out) or transposed
// (out = h . W^T, depth out, width in), the backward's walk. A transposed
// tile is read with eight lanes on eight consecutive elements of a row of W
// and stored with a row stride of kCols + 4 floats, so neither the global
// reads nor the shared stores of either orientation conflict.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace tower {

constexpr int kMaxLayers = 8;
constexpr int kThreads = 256;
constexpr int kRows = 32;                      // rows of the batch per block
constexpr int kCols = 128;                     // output columns per pass step
constexpr int kChunk = 32;                     // depth of one weight tile
constexpr int kLd = kRows + 4;                 // stride of an activation column
constexpr int kWld = kCols + 4;                // stride of a weight-tile row
constexpr int kTx = kCols / 4;                 // threads across the columns
constexpr int kStaged = kChunk * kCols / kThreads;  // tile floats per thread
static_assert((kRows / 4) * kTx == kThreads, "4x4 tiles must cover the block");
static_assert(kChunk == 32 && kCols % 4 == 0, "transposed tile layout");

enum Activation { kTanh = 0, kRelu = 1, kSigmoid = 2 };

struct Tower {
  const float* w[kMaxLayers];  // [dims[l], dims[l + 1]], row-major (JAX layout)
  const float* b[kMaxLayers];  // [dims[l + 1]]
  int dims[kMaxLayers + 1];
  int num_layers;
};

__device__ __forceinline__ float activate(float v, int act) {
  if (act == kTanh) return tanhf(v);
  if (act == kRelu) return fmaxf(v, 0.0f);
  return 1.0f / (1.0f + expf(-v));
}

// The activation's derivative from its output a = act(z), as the reference
// backward takes it (deepctr_tpu/ops/pallas/mlp.py::_act_deriv).
__device__ __forceinline__ float activate_deriv(float a, int act) {
  if (act == kTanh) return 1.0f - a * a;
  if (act == kRelu) return a > 0.0f ? 1.0f : 0.0f;
  return a * (1.0f - a);
}

// Pass p of a walk: the num_layers - 1 forward passes of the hidden layers,
// then, on a backward walk (kBack), the transposed passes of layers L-1 down
// to 0. A forward walk compiles without the transposed code.
template <bool kBack>
__device__ __forceinline__ void pass_of(const Tower& t, int p, int& layer,
                                        bool& transposed) {
  transposed = kBack && p >= t.num_layers - 1;
  layer = transposed ? 2 * t.num_layers - 2 - p : p;
}

__device__ __forceinline__ int pass_depth(const Tower& t, int layer, bool tr) {
  return tr ? t.dims[layer + 1] : t.dims[layer];
}

__device__ __forceinline__ int pass_width(const Tower& t, int layer, bool tr) {
  return tr ? t.dims[layer] : t.dims[layer + 1];
}

// (depth, column) within a weight tile of element i of the block's copy.
__device__ __forceinline__ void tile_coords(int i, bool tr, int& d, int& c) {
  if (!tr) {
    d = i / kCols;
    c = i % kCols;
  } else {
    const int lane = i % 32;
    const int grp = i / 32;
    d = (grp % 4) * 8 + lane % 8;
    c = (grp / 4) * 4 + lane / 8;
  }
}

// This thread's share of the weight tile of pass p at (k0, n0); zero past
// the matrix edges.
template <bool kBack>
__device__ __forceinline__ void fetch_tile(const Tower& t, int p, int k0,
                                           int n0, float (&staged)[kStaged]) {
  int layer;
  bool tr;
  pass_of<kBack>(t, p, layer, tr);
  const int depth = pass_depth(t, layer, tr);
  const int width = pass_width(t, layer, tr);
  const int ld = t.dims[layer + 1];
  const float* __restrict__ w = t.w[layer];
#pragma unroll
  for (int j = 0; j < kStaged; ++j) {
    int d, c;
    tile_coords(threadIdx.x + j * kThreads, tr, d, c);
    const int k = k0 + d;
    const int n = n0 + c;
    const size_t at = tr ? static_cast<size_t>(n) * ld + k
                         : static_cast<size_t>(k) * ld + n;
    staged[j] = (k < depth && n < width) ? __ldg(w + at) : 0.0f;
  }
}

// Step (p, k0, n0) to the next weight tile, in the order the passes consume
// them; false after the last tile of pass num_passes - 1.
template <bool kBack>
__device__ __forceinline__ bool next_tile(const Tower& t, int num_passes,
                                          int& p, int& k0, int& n0) {
  int layer;
  bool tr;
  pass_of<kBack>(t, p, layer, tr);
  k0 += kChunk;
  if (k0 < pass_depth(t, layer, tr)) return true;
  k0 = 0;
  n0 += kCols;
  if (n0 < pass_width(t, layer, tr)) return true;
  n0 = 0;
  ++p;
  return p < num_passes;
}

// The weight-tile stream of one block: the tile held in registers and where
// the walk stands.
struct Stream {
  float staged[kStaged];
  int p = 0, k0 = 0, n0 = 0;
  int num_passes;
};

// Pass p over the tile's activations src ([depth][kLd]): for each block of
// kCols output columns, acc[i][j] = sum_k src[k][4*ty + i] * M[k][n0 + 4*tx
// + j], then epi(n0, acc). The caller has fetched pass p's first tile into
// s.staged. Starts with a barrier, so src may have been written just before.
template <bool kBack, class Epilogue>
__device__ __forceinline__ void run_pass(const Tower& t, int p,
                                         const float* src, float* wtile,
                                         Stream& s, Epilogue epi) {
  int layer;
  bool tr;
  pass_of<kBack>(t, p, layer, tr);
  const int depth_total = pass_depth(t, layer, tr);
  const int width = pass_width(t, layer, tr);
  const int tid = threadIdx.x;
  const int tx = tid % kTx;
  const int ty = tid / kTx;
  for (int n0 = 0; n0 < width; n0 += kCols) {
    float acc[4][4] = {};
    for (int k0 = 0; k0 < depth_total; k0 += kChunk) {
      __syncthreads();  // wtile is free; src is complete
#pragma unroll
      for (int j = 0; j < kStaged; ++j) {
        int d, c;
        tile_coords(tid + j * kThreads, tr, d, c);
        wtile[d * kWld + c] = s.staged[j];
      }
      __syncthreads();
      if (next_tile<kBack>(t, s.num_passes, s.p, s.k0, s.n0)) {
        fetch_tile<kBack>(t, s.p, s.k0, s.n0, s.staged);
      }
      const int depth = min(kChunk, depth_total - k0);
      const float* a_ptr = src + k0 * kLd + ty * 4;
      const float* w_ptr = wtile + tx * 4;
#pragma unroll 4
      for (int kk = 0; kk < depth; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(a_ptr + kk * kLd);
        const float4 b = *reinterpret_cast<const float4*>(w_ptr + kk * kWld);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
      }
    }
    epi(n0, acc);
  }
}

// The batch tile x[row0 : row0 + kRows, :] -> dst ([in][kLd]), transposed;
// rows past the batch are zero.
__device__ __forceinline__ void load_rows(const float* __restrict__ x,
                                          int in_dim, int row0, int rows,
                                          float* dst) {
  for (int i = threadIdx.x; i < kRows * in_dim; i += kThreads) {
    const int r = i / in_dim;
    const int k = i - r * in_dim;
    dst[k * kLd + r] =
        r < rows ? x[static_cast<size_t>(row0 + r) * in_dim + k] : 0.0f;
  }
}

}  // namespace tower
