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
// is not carried over: on the card this is a row reduction.
//
// What bounds it on an H100: bytes. At the training shape [8192, 18, 11] a
// launch reads 6.5 MB of rows and 0.6 MB of mask and writes 32 KB, about
// 2 us at the card's 3.35 TB/s, against ~20 FLOP a float. So what decides
// its time is how well the loads coalesce and the launch itself.
//
// What the design does about it:
// - one block per tile of kRows examples; the tile's rows are staged in
//   shared memory by a flat copy in which neighbouring threads read
//   neighbouring floats (a tile of all S slots is one contiguous range), so
//   every load is coalesced whatever S and D are;
// - when a tile of all slots would not fit the staging buffer (large S or
//   k), the slots are staged in chunks and the sums carried across them in
//   shared memory;
// - one thread per (example, column) sums its column over the slots in
//   slot order, and one thread per example sums the columns in column
//   order: the order is fixed, so two launches give the same bits (the
//   train step's bitwise repeatability rests on it); no atomics;
// - everything stays under 48 KB of shared memory, so no opt-in call is
//   made per launch.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;             // examples per block
constexpr int kMaxD = 65;             // 1 + k, k <= 64
constexpr int kStageFloats = 7936;    // rows and mask staged per chunk

// slots staged per chunk: all of them when kRows rows of (d + 1) floats a
// slot fit kStageFloats
int chunk_slots(int slots, int d) {
  const int fit = kStageFloats / (kRows * (d + 1));
  return slots < fit ? slots : fit;
}

size_t smem_bytes(int chunk, int d) {
  return sizeof(float) * (static_cast<size_t>(kRows) * chunk * (d + 1) +
                          2 * static_cast<size_t>(kRows) * d);
}

__global__ void __launch_bounds__(kThreads)
    fm_score_kernel(const float* __restrict__ rows,
                    const float* __restrict__ mask, int batch, int slots,
                    int d, int chunk, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* tile = smem;                          // [kRows][chunk * d]
  float* mtile = tile + kRows * chunk * d;     // [kRows][chunk]
  float* sum = mtile + kRows * chunk;          // [kRows][d]
  float* sq = sum + kRows * d;                 // [kRows][d]

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const int n_rows = min(kRows, batch - row0);
  const size_t row_stride = static_cast<size_t>(slots) * d;
  const int pairs = n_rows * d;

  for (int p = tid; p < pairs; p += kThreads) {
    sum[p] = 0.0f;
    sq[p] = 0.0f;
  }
  for (int s0 = 0; s0 < slots; s0 += chunk) {
    const int cs = min(chunk, slots - s0);
    const int seg = cs * d;  // floats of one example's chunk
    __syncthreads();         // the previous chunk is consumed
    for (int i = tid; i < n_rows * seg; i += kThreads) {
      const int r = i / seg;
      tile[i] = __ldg(rows + (row0 + r) * row_stride +
                      static_cast<size_t>(s0) * d + (i - r * seg));
    }
    for (int i = tid; i < n_rows * cs; i += kThreads) {
      const int r = i / cs;
      mtile[i] = __ldg(mask + static_cast<size_t>(row0 + r) * slots + s0 +
                       (i - r * cs));
    }
    __syncthreads();
    for (int p = tid; p < pairs; p += kThreads) {
      const int r = p / d;
      const int c = p - r * d;
      const float* t = tile + r * seg + c;
      const float* m = mtile + r * cs;
      float a = sum[p];
      float q = sq[p];
      for (int s = 0; s < cs; ++s) {
        const float x = t[s * d] * m[s];
        a += x;
        q = fmaf(x, x, q);
      }
      sum[p] = a;
      sq[p] = q;
    }
  }
  __syncthreads();
  for (int r = tid; r < n_rows; r += kThreads) {
    const float* a = sum + r * d;
    const float* q = sq + r * d;
    float inter = 0.0f;
    for (int c = 1; c < d; ++c) inter += a[c] * a[c] - q[c];
    out[row0 + r] = a[0] + 0.5f * inter;
  }
}

}  // namespace

// rows: f32 [batch, slots, d] on the device, contiguous; mask: f32 [batch,
// slots]; out: f32 [batch]. d = 1 + k with 1 <= d <= 65. Returns a
// cudaError_t code; 0 means launched.
extern "C" int fm_score_fwd(const void* rows, const void* mask, int batch,
                            int slots, int d, void* out, void* stream) {
  if (batch < 1 || slots < 1 || d < 1 || d > kMaxD) {
    return cudaErrorInvalidValue;
  }
  const int chunk = chunk_slots(slots, d);
  const int blocks = (batch + kRows - 1) / kRows;
  fm_score_kernel<<<blocks, kThreads, smem_bytes(chunk, d),
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rows), static_cast<const float*>(mask), batch,
      slots, d, chunk, static_cast<float*>(out));
  return cudaGetLastError();
}
