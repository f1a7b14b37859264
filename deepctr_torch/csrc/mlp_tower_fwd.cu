// Fused dense-tower forward for Hopper (sm_90a): CUDA C++ behind a plain C
// entry point, loaded with ctypes by deepctr_torch/ops/kernels/mlp.py.
//
// Replaces the Pallas kernel deepctr_tpu/ops/pallas/mlp.py::_tower_fwd
// (body _make_kernel, entry mlp_tower_fused) on its dropout-free branch:
// h = act(h . W_i + b_i) on the hidden layers, and the logit is column 0 of
// the last layer. f32 x[B, in] in, one f32 logit per row out.
//
// What bounds it on an H100: at FNN widths (176-200-300-100-1) a row costs
// about 250 kFLOP against 704 B of input and 4 B of output, so the kernel is
// bound by f32 FMA throughput and by reading the weights from L2, never by
// device memory. The weights (125,901 f32, 504 KB) are more than the 227 KB
// of shared memory a block may hold, so the TPU kernel's "all weights
// resident" does not carry over.
//
// What the design does about it:
// - one block per tile of kRows rows; the tile's activations stay in shared
//   memory across all layers in two ping-pong buffers, stored column-major
//   ([width][kRows]), so x is read from device memory once and one logit per
//   row is written;
// - the hidden layers' weights stream from global memory (L2-resident after
//   the first blocks) through a [kChunk x kCols] shared tile. Each thread
//   holds its share of the next tile in registers while the block computes
//   on the current one, so the L2 latency hides behind the FMAs; the walk
//   runs on across column passes and layers;
// - each thread keeps a 4x4 register tile of outputs; one depth step reads
//   four activations and four weights as two float4 and issues 16 FMAs;
// - bias and activation are fused into the store; rows past B are
//   zero-filled and never stored;
// - the output layer is one dot product per row (column 0 only), eight
//   threads to a row and a shuffle reduction.
// Math is f32 FMA on the CUDA cores, as the plain f32 version computes it.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxLayers = 8;
constexpr int kThreads = 256;
constexpr int kRows = 32;                      // rows of x per block
constexpr int kCols = 128;                     // output columns per pass
constexpr int kChunk = 32;                     // depth of one weight tile
constexpr int kLd = kRows + 4;                 // stride of an activation column
constexpr int kTx = kCols / 4;                 // threads across the columns
constexpr int kStaged = kChunk * kCols / kThreads;  // tile floats per thread
constexpr int kDot = kThreads / kRows;         // threads per row, output layer
static_assert((kRows / 4) * kTx == kThreads, "4x4 tiles must cover the block");
static_assert(kDot == 8, "the output-layer reduction shuffles over 8 lanes");

enum Activation { kTanh = 0, kRelu = 1, kSigmoid = 2 };

struct Tower {
  const float* w[kMaxLayers];  // [dims[l], dims[l + 1]], row-major (JAX layout)
  const float* b[kMaxLayers];  // [dims[l + 1]]
  int dims[kMaxLayers + 1];
  int num_layers;
  int width;  // widest activation held in shared memory: max(dims[0..L-1])
};

size_t smem_bytes(int width) {
  return sizeof(float) *
         (2 * static_cast<size_t>(width) * kLd + kChunk * kCols);
}

__device__ __forceinline__ float activate(float v, int act) {
  if (act == kTanh) return tanhf(v);
  if (act == kRelu) return fmaxf(v, 0.0f);
  return 1.0f / (1.0f + expf(-v));
}

// This thread's share of the weight tile of layer l at (k0, n0); zero past
// the matrix edges.
__device__ __forceinline__ void fetch_tile(const Tower& t, int l, int k0,
                                           int n0, float (&staged)[kStaged]) {
  const int depth = t.dims[l];
  const int width = t.dims[l + 1];
  const float* __restrict__ w = t.w[l];
#pragma unroll
  for (int j = 0; j < kStaged; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int k = k0 + i / kCols;
    const int n = n0 + i % kCols;
    staged[j] = (k < depth && n < width)
                    ? __ldg(w + static_cast<size_t>(k) * width + n)
                    : 0.0f;
  }
}

// Step (l, k0, n0) to the next weight tile of the hidden layers, in the
// order the kernel consumes them; false after the last one.
__device__ __forceinline__ bool next_tile(const Tower& t, int& l, int& k0,
                                          int& n0) {
  k0 += kChunk;
  if (k0 < t.dims[l]) return true;
  k0 = 0;
  n0 += kCols;
  if (n0 < t.dims[l + 1]) return true;
  n0 = 0;
  ++l;
  return l < t.num_layers - 1;
}

__global__ void __launch_bounds__(kThreads)
    tower_fwd_kernel(const float* __restrict__ x, int batch, Tower t, int act,
                     float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* src = smem;
  float* dst = smem + t.width * kLd;
  float* wtile = smem + 2 * t.width * kLd;  // [kChunk][kCols]

  const int tid = threadIdx.x;
  const int tx = tid % kTx;
  const int ty = tid / kTx;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, batch - row0);
  const int hidden = t.num_layers - 1;

  float staged[kStaged];
  int fl = 0, fk = 0, fn = 0;  // the tile held in `staged`
  if (hidden > 0) fetch_tile(t, 0, 0, 0, staged);

  // x tile -> src, transposed; the ragged edge is zero-filled
  const int in_dim = t.dims[0];
  for (int i = tid; i < kRows * in_dim; i += kThreads) {
    const int r = i / in_dim;
    const int k = i - r * in_dim;
    src[k * kLd + r] =
        r < rows ? x[static_cast<size_t>(row0 + r) * in_dim + k] : 0.0f;
  }

  for (int l = 0; l < hidden; ++l) {
    const int depth_total = t.dims[l];
    const int n_out = t.dims[l + 1];
    const float* __restrict__ bias = t.b[l];
    for (int n0 = 0; n0 < n_out; n0 += kCols) {
      float acc[4][4] = {};
      for (int k0 = 0; k0 < depth_total; k0 += kChunk) {
        __syncthreads();  // wtile is free; src is complete
#pragma unroll
        for (int j = 0; j < kStaged; ++j) wtile[tid + j * kThreads] = staged[j];
        __syncthreads();
        if (next_tile(t, fl, fk, fn)) fetch_tile(t, fl, fk, fn, staged);
        const int depth = min(kChunk, depth_total - k0);
        const float* a_ptr = src + k0 * kLd + ty * 4;
        const float* w_ptr = wtile + tx * 4;
#pragma unroll 4
        for (int kk = 0; kk < depth; ++kk) {
          const float4 a = *reinterpret_cast<const float4*>(a_ptr + kk * kLd);
          const float4 b = *reinterpret_cast<const float4*>(w_ptr + kk * kCols);
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx * 4 + j;
        if (n < n_out) {
          const float bn = __ldg(bias + n);
          float4 v;
          v.x = activate(acc[0][j] + bn, act);
          v.y = activate(acc[1][j] + bn, act);
          v.z = activate(acc[2][j] + bn, act);
          v.w = activate(acc[3][j] + bn, act);
          *reinterpret_cast<float4*>(dst + n * kLd + ty * 4) = v;
        }
      }
    }
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
  float s = 0.0f;
  for (int k = part; k < depth; k += kDot) {
    s = fmaf(src[k * kLd + r], __ldg(w + static_cast<size_t>(k) * ldw), s);
  }
#pragma unroll
  for (int lane = kDot / 2; lane > 0; lane /= 2) {
    s += __shfl_xor_sync(0xffffffffu, s, lane);
  }
  if (part == 0 && r < rows) out[row0 + r] = s + __ldg(t.b[hidden]);
}

}  // namespace

// x: f32 [batch, dims[0]] on the device, row-major. dims: host int[num_layers
// + 1]. weights, biases: host arrays of num_layers device pointers. out: f32
// [batch] on the device. Returns a cudaError_t code; 0 means launched.
extern "C" int mlp_tower_fwd(const void* x, int batch, int num_layers,
                             const void* dims, const void* weights,
                             const void* biases, int activation, void* out,
                             void* stream) {
  if (num_layers < 1 || num_layers > kMaxLayers || batch < 1 ||
      activation < kTanh || activation > kSigmoid) {
    return cudaErrorInvalidValue;
  }
  const int* d = static_cast<const int*>(dims);
  const float* const* w = static_cast<const float* const*>(weights);
  const float* const* b = static_cast<const float* const*>(biases);
  Tower t = {};
  t.num_layers = num_layers;
  for (int l = 0; l <= num_layers; ++l) {
    if (d[l] < 1) return cudaErrorInvalidValue;
    t.dims[l] = d[l];
  }
  for (int l = 0; l < num_layers; ++l) {
    t.w[l] = w[l];
    t.b[l] = b[l];
    if (d[l] > t.width) t.width = d[l];
  }
  const size_t smem = smem_bytes(t.width);
  // above 48 KB a block must opt in; a request past the card's limit (a
  // layer wider than about 750) fails here and is returned, so the caller
  // raises
  cudaError_t err = cudaFuncSetAttribute(
      tower_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int blocks = (batch + kRows - 1) / kRows;
  tower_fwd_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), batch, t, activation,
      static_cast<float*>(out));
  return cudaGetLastError();
}

extern "C" const char* deepctr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
