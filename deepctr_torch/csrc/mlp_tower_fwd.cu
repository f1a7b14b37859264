// Fused dense-tower forward for Hopper (sm_90a): CUDA C++ behind a plain C
// entry point, loaded with ctypes by deepctr_torch/ops/kernels/mlp.py.
//
// Replaces the Pallas kernel deepctr_tpu/ops/pallas/mlp.py::_tower_fwd
// (body _make_kernel, entry mlp_tower_fused), both branches:
// h = act(h . W_i + b_i) on the hidden layers, each followed on the
// training branch by the counter-hash dropout mask (dropout_hash.cuh), and
// the logit is column 0 of the last layer. f32 x[B, in] in, one f32 logit
// per row out.
//
// What bounds it on an H100: at FNN widths (176-200-300-100-1) a row costs
// about 250 kFLOP against 704 B of input and 4 B of output, so the kernel is
// bound by f32 FMA throughput and by reading the weights from L2, never by
// device memory. The weights (125,901 f32, 504 KB) are more than the 227 KB
// of shared memory a block may hold, so the TPU kernel's "all weights
// resident" does not carry over.
//
// What the design does about it (tower_tile.cuh has the shared machinery):
// - one block per tile of kRows rows; the tile's activations stay in shared
//   memory across all layers in two ping-pong buffers, so x is read from
//   device memory once and one logit per row is written;
// - the hidden layers' weights stream from L2 through a shared tile, the
//   next tile prefetched into registers while the block computes on the
//   current one; each thread computes a 4x4 register tile of outputs;
// - bias, activation and the dropout mask are fused into the store; the
//   mask costs one integer hash per element, recomputed, never stored;
// - rows past B are zero-filled and never stored;
// - the output layer is one dot product per row (column 0 only), eight
//   threads to a row and a shuffle reduction.
// Math is f32 FMA on the CUDA cores, as the plain f32 version computes it.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "dropout_hash.cuh"
#include "tower_tile.cuh"

namespace {

using namespace tower;

constexpr int kDot = kThreads / kRows;  // threads per row, output layer
static_assert(kDot == 8, "the output-layer reduction shuffles over 8 lanes");

size_t smem_bytes(int width) {
  return sizeof(float) *
         (2 * static_cast<size_t>(width) * kLd + kChunk * kWld);
}

// kDrop: the training branch; the eval branch compiles without the hash
template <bool kDrop>
__global__ void __launch_bounds__(kThreads)
    tower_fwd_kernel(const float* __restrict__ x, int batch, Tower t, int act,
                     Dropout drop, int width, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* src = smem;
  float* dst = smem + width * kLd;
  float* wtile = smem + 2 * width * kLd;  // [kChunk][kWld]

  const int tid = threadIdx.x;
  const int tx = tid % kTx;
  const int ty = tid / kTx;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, batch - row0);
  const int hidden = t.num_layers - 1;

  Stream s;
  s.num_passes = hidden;
  if (hidden > 0) fetch_tile<false>(t, 0, 0, 0, s.staged);
  load_rows(x, t.dims[0], row0, rows, src);

  for (int l = 0; l < hidden; ++l) {
    const int n_out = t.dims[l + 1];
    const float* __restrict__ bias = t.b[l];
    run_pass<false>(t, l, src, wtile, s, [&](int n0, float (&acc)[4][4]) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx * 4 + j;
        if (n < n_out) {
          const float bn = __ldg(bias + n);
          float v[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            v[i] = activate(acc[i][j] + bn, act);
            if (kDrop) v[i] *= dropout_factor(drop, row0 + ty * 4 + i, n, l);
          }
          *reinterpret_cast<float4*>(dst + n * kLd + ty * 4) =
              make_float4(v[0], v[1], v[2], v[3]);
        }
      }
    });
    float* tmp = src;
    src = dst;
    dst = tmp;
  }

  // output layer: logit = src[:, r] . w[:, 0] + b[0], kDot threads per row
  __syncthreads();
  const int r = tid / kDot;
  const int part = tid % kDot;
  const int depth = t.dims[hidden];
  const int ldw = t.dims[hidden + 1];
  const float* __restrict__ w = t.w[hidden];
  float acc = 0.0f;
  for (int k = part; k < depth; k += kDot) {
    acc = fmaf(src[k * kLd + r], __ldg(w + static_cast<size_t>(k) * ldw), acc);
  }
#pragma unroll
  for (int lane = kDot / 2; lane > 0; lane /= 2) {
    acc += __shfl_xor_sync(0xffffffffu, acc, lane);
  }
  if (part == 0 && r < rows) out[row0 + r] = acc + __ldg(t.b[hidden]);
}

}  // namespace

// x: f32 [batch, dims[0]] on the device, row-major. dims: host int[num_layers
// + 1]. weights, biases: host arrays of num_layers device pointers. With
// dropout_on, hidden element (row, col) of layer l is multiplied by
// dropout_factor (dropout_hash.cuh) with the given seed, threshold and scale;
// row counts from row0. out: f32 [batch] on the device. Returns a cudaError_t
// code; 0 means launched.
extern "C" int mlp_tower_fwd(const void* x, int batch, int num_layers,
                             const void* dims, const void* weights,
                             const void* biases, int activation,
                             int dropout_on, uint32_t seed, uint32_t threshold,
                             float scale, int row0, void* out, void* stream) {
  if (num_layers < 1 || num_layers > kMaxLayers || batch < 1 ||
      activation < kTanh || activation > kSigmoid || row0 < 0) {
    return cudaErrorInvalidValue;
  }
  const int* d = static_cast<const int*>(dims);
  const float* const* w = static_cast<const float* const*>(weights);
  const float* const* b = static_cast<const float* const*>(biases);
  Tower t = {};
  t.num_layers = num_layers;
  int width = 0;  // widest activation held in shared memory
  for (int l = 0; l <= num_layers; ++l) {
    if (d[l] < 1) return cudaErrorInvalidValue;
    t.dims[l] = d[l];
  }
  for (int l = 0; l < num_layers; ++l) {
    t.w[l] = w[l];
    t.b[l] = b[l];
    if (d[l] > width) width = d[l];
  }
  const Dropout drop = {dropout_on != 0, seed, threshold, scale,
                        static_cast<uint32_t>(row0)};
  const size_t smem = smem_bytes(width);
  auto kernel = drop.on ? tower_fwd_kernel<true> : tower_fwd_kernel<false>;
  // above 48 KB a block must opt in; a request past the card's limit (a
  // layer wider than about 750) fails here and is returned, so the caller
  // raises
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int blocks = (batch + kRows - 1) / kRows;
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), batch, t, activation, drop, width,
      static_cast<float*>(out));
  return cudaGetLastError();
}

extern "C" const char* deepctr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
