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
// 125,300 multiply-adds against 704 B of input and 4 B of output: 2.05
// GFLOP and 6.3 MB at B = 8192, so it is bound by arithmetic (30.6 us on
// the CUDA cores' 67 TFLOP/s f32; 12.4 us at the tensor cores' 165 TFLOP/s
// of 3xTF32), never by device memory. The weights (125,901 f32, 504 KB) do
// not fit the 227 KB of shared memory a block may hold, so every block
// streams them from L2.
//
// What the design does about it (tower_tile.cuh has the shared machinery):
// - the products run on the tensor cores (wgmma m64nNk8, TF32 operands
//   split hi + lo, "3xTF32"), for f32's accuracy;
// - one block per 64 rows (32 for towers too wide for 64), so B = 8192 is
//   128 blocks, one wave on 132 SMs; two consumer warpgroups take turns
//   over the column passes and two producer warps feed their rings;
// - the weights are packed once per call (tower_pack_kernel) into the
//   images the products read, and each block streams them from L2 by bulk
//   copies into rings of as many slots as shared memory holds (5 at FNN
//   widths);
// - the tile's activations stay in shared memory across all layers in two
//   ping-pong buffers, so x is read from device memory once and one logit
//   per row is written;
// - bias (loaded before the column pass's products), activation (tanh and
//   sigmoid from one exp, without branches) and the dropout mask are fused
//   into the epilogue; the mask costs one integer hash per element,
//   recomputed, never stored;
// - rows past B are zero-filled and never stored;
// - the output layer is one f32 dot product per row (column 0 only), 4
//   threads to a row and a shuffle reduction.
// What still bounds it (PERF.md §6): not the tensor cores. With every
// product removed it takes about two thirds as long: the exposed epilogue,
// the A loads and splits, and the images' trips from L2, with 8 consumer
// warps an SM.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "dropout_hash.cuh"
#include "tower_tile.cuh"

namespace {

using namespace tower;

// kDrop: the training branch; the eval branch compiles without the hash
template <int kBm, bool kDrop>
__global__ void __launch_bounds__(kBlockThreads, 1)
    tower_fwd_kernel(const float* __restrict__ x, int batch, Tower t, int act,
                     Dropout drop_arg, Plan plan, const float* __restrict__ packed,
                     float* __restrict__ out) {
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
    const int tid = threadIdx.x;
    const int row0 = blockIdx.x * kBm;
    const int rows = min(kBm, batch - row0);
    const int hidden = t.num_layers - 1;
    load_rows<kBm>(x, t.dims[0], row0, rows, src, ld);

    for (int l = 0; l < hidden; ++l) {
      const int n_out = t.dims[l + 1];
      float* d = dst;
      auto value = [&](int r, int n, float z) {
        float v = activate(z, act);
        if (kDrop) v *= dropout_factor(drop, row0 + r, n, l);
        return n < n_out ? v : 0.0f;
      };
      run_pass<kBm>(t, plan, l, src, ld, ring, t.b[l], nullptr, 0, rows,
                    [&](int r, int n, float z0, float z1, float, float, bool valid) {
        const float2 v = make_float2(value(r, n, z0), value(r, n + 1, z1));
        if (valid) *reinterpret_cast<float2*>(d + r * ld + n) = v;
      });
      float* tmp = src;
      src = dst;
      dst = tmp;
    }

    // output layer: logit = src[r, :] . w[:, 0] + b[0], kDot threads per row
    constexpr int kDot = kThreads / kBm;
    consumer_sync();
    const int r = tid / kDot;
    const int part = tid % kDot;
    const int depth = t.dims[hidden];
    const int ldw = t.dims[hidden + 1];
    const float* __restrict__ w = t.w[hidden];
    float acc = 0.0f;
#pragma unroll 8
    for (int k = part; k < depth; k += kDot) {
      acc = fmaf(src[r * ld + k], __ldg(w + static_cast<size_t>(k) * ldw), acc);
    }
#pragma unroll
    for (int lane = kDot / 2; lane > 0; lane /= 2) {
      acc += __shfl_xor_sync(0xffffffffu, acc, lane);
    }
    if (part == 0 && r < rows) out[row0 + r] = acc + __ldg(t.b[hidden]);
  }
}

template <int kBm>
cudaError_t launch(const float* x, int batch, const Tower& t, int act,
                   const Dropout& drop, const Plan& plan, size_t smem,
                   const float* packed, float* out, cudaStream_t stream) {
  auto kernel = drop.on ? tower_fwd_kernel<kBm, true> : tower_fwd_kernel<kBm, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<(batch + kBm - 1) / kBm, kBlockThreads, smem, stream>>>(
      x, batch, t, act, drop, plan, packed, out);
  return cudaGetLastError();
}

}  // namespace

// Bytes of device workspace mlp_tower_fwd needs for this tower (dims: host
// int[num_layers + 1]): the weight images of its passes; 0 where the tower
// is invalid or too wide for the kernel.
extern "C" size_t mlp_tower_fwd_workspace(int num_layers, const void* dims) {
  Tower t;
  Plan plan;
  size_t smem;
  if (!make_tower(num_layers, dims, nullptr, nullptr, t) || !make_plan(t, false, plan, smem)) {
    return 0;
  }
  return sizeof(float) * (plan.packed_floats + 1);  // never 0 for a valid tower
}

// x: f32 [batch, dims[0]] on the device, row-major. dims: host int[num_layers
// + 1]. weights, biases: host arrays of num_layers device pointers. With
// dropout_on, hidden element (row, col) of layer l is multiplied by
// dropout_factor (dropout_hash.cuh) with the given seed, threshold and scale;
// row counts from row0. seed_ptr: null, or a device uint32 read in place of
// seed when the kernel runs (a graph's replays each read their step's). out: f32 [batch] on the device. workspace:
// mlp_tower_fwd_workspace(...) bytes on the device, 16-byte aligned. Returns
// a cudaError_t code; 0 means launched.
extern "C" int mlp_tower_fwd(const void* x, int batch, int num_layers,
                             const void* dims, const void* weights,
                             const void* biases, int activation,
                             int dropout_on, uint32_t seed, const void* seed_ptr,
                             uint32_t threshold, float scale, int row0, void* out,
                             void* workspace,
                             size_t workspace_bytes, void* stream) {
  Tower t;
  if (batch < 1 || activation < kTanh || activation > kSigmoid || row0 < 0 ||
      !make_tower(num_layers, dims, weights, biases, t)) {
    return cudaErrorInvalidValue;
  }
  // a tower too wide for 32 rows a block (a layer wider than about 680) is
  // refused, and the caller raises
  Plan plan;
  size_t smem = 0;
  if (!make_plan(t, false, plan, smem) ||
      workspace_bytes < sizeof(float) * plan.packed_floats ||
      (reinterpret_cast<uintptr_t>(workspace) & 15) != 0) {
    return cudaErrorInvalidValue;
  }
  const Dropout drop = {dropout_on != 0, seed, threshold, scale,
                        static_cast<uint32_t>(row0),
                        static_cast<const uint32_t*>(seed_ptr)};
  float* packed = static_cast<float*>(workspace);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (plan.num_passes > 0) {
    tower_pack_kernel<<<dim3(max_images(t, plan), plan.num_passes), 256, 0, st>>>(
        t, plan, packed);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const float* xf = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  if (plan.bm == 64) return launch<64>(xf, batch, t, activation, drop, plan, smem, packed, o, st);
  return launch<32>(xf, batch, t, activation, drop, plan, smem, packed, o, st);
}

// Rows a block, image slots of each ring and dynamic shared memory bytes of
// the forward kernel (back 0) or the backward's rows kernel (back 1) for a
// tower (dims: host int[num_layers + 1]); rows 0 where it does not fit.
extern "C" int mlp_tower_block_shape(int num_layers, const void* dims, int back, int* rows,
                                     int* stages, size_t* smem) {
  *rows = 0;
  *stages = 0;
  *smem = 0;
  Tower t;
  Plan plan;
  if (!make_tower(num_layers, dims, nullptr, nullptr, t) ||
      !make_plan(t, back != 0, plan, *smem)) {
    return cudaErrorInvalidValue;
  }
  *rows = plan.bm;
  *stages = plan.stages;
  return cudaSuccess;
}

extern "C" const char* deepctr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
