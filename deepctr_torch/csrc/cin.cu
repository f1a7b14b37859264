// xDeepFM's Compressed Interaction Network (ops/cin.py) for Hopper (sm_90a):
// CUDA C++ behind plain C entry points, loaded with ctypes by
// deepctr_torch/ops/kernels/cin.py.
//
// Replaces no TPU kernel: deepctr_tpu has no CIN. The port's first CIN
// (ops/cin.py's plain version) wrote each layer's outer product Z^k [B·D,
// H_{k-1}·m], Z[(b, d), (i, j)] = X^{k-1}[b, i, d]·X^0[b, j, d], to device
// memory (1.28 GB a layer at the Criteo widths), once in the forward and
// twice in the backward (Z^k again and its gradient), and multiplied it on
// cuBLAS in float32, on the CUDA cores. This kernel runs a layer's three
// products in float32 by the 3xTF32 split on the tensor cores, and forms
// the Z side of each in registers from small tiles of its two factors:
// - forward:          X^k = Z·W          [R, H_k] over depth H_{k-1}·m;
// - weight gradient:  g_W = Z^T·G        [H_{k-1}·m, H_k] over depth R;
// - operand gradient: G_z = G·W^T        [R, H_{k-1}·m] over depth H_k,
//   reduced in the epilogue to g_x[r, i] = Σ_j G_z[r, (i, j)]·X^0[r, j] and
//   g_x0[r, j] = Σ_i G_z[r, (i, j)]·X^{k-1}[r, i]; G_z is never written.
// (R = B·D rows, one an example and embedding dimension; W^k is [H_{k-1}·m,
// H_k], row i·m + j.)
//
// What bounds it on an H100: operations. At the benchmark cell's widths
// (batch 4096, D = 10, m = 39 fields, 200-200-200 maps) a train step runs
// 841.5 GFLOP of CIN products against some 0.5 GB of factors, weights,
// packed operands and outputs once the outer product stays on chip: 5.1 ms
// at the 3xTF32 rate of 165 TFLOP/s (the TF32 tensor cores' 495 over
// three), 0.15 ms at 3.35 TB/s.
//
// What the design does about it: a persistent Hopper GEMM, one block an SM,
// one producer warp and two consumer warpgroups of 64 rows each, with the A
// operand formed in registers and the B operand packed ahead.
// - A pack kernel writes B once a call as the exact shared-memory images
//   the products read (split into hi = rna_tf32(x) and lo = rna_tf32(x -
//   hi), tower_tile.cuh's split, K-major, zero past the matrix), one image
//   a stage. The producer warp moves each stage with bulk copies (the copy
//   engine, completing on an mbarrier): it spends no registers or
//   instructions on B. (The first design loaded and split B in a producer
//   warpgroup, as dense_bwd.cu does: with the products removed it alone
//   took 2.8 of the forward's 3.2 ms at the cell's widths.)
// - The fields are padded to kFields = 40 (zero factors, zero images), so a
//   forward stage is one map i of X^{k-1} over its 40 fields and a 40-wide
//   column group of the operand gradient is one i. Within a k8 step the
//   depth is relabelled (depth 2q and 2q + 1 at positions q and q + 4) so
//   that a thread's two values of a row are one 64-bit shared load; the
//   pack kernel writes the images in the same order.
// - Forward: a block owns 128 rows and 104 of H_k's columns (N = 200 is two
//   column tiles). The rows' X^0 tile [128, 40] stays in shared memory for
//   the unit (two slots, so the next unit's copy overlaps); each stage
//   brings X^{k-1}'s column i for the rows (a row of its transpose) and W's
//   image; a consumer forms its A fragment as x·x0, rounded to f32 as the
//   plain product rounds it (__fmul_rn), then splits it.
// - Weight gradient: a block owns 128 rows of (i, j) and 104 columns over a
//   fixed slice of the depth R; each stage holds 32 rows of X^{k-1}'s maps
//   i_lo..i_lo + 4 and of X^0 from their transposes by blocks of 32 rows
//   (three bulk copies a stage: 46 small ones, a row of 128 bytes each, held
//   the products to a quarter of the bound), and G's image. Slices write partial tiles; a second kernel adds them in
//   slice order.
// - Operand gradient: a block owns 128 rows; G's [128, H_k] tile (H_k <=
//   200) stays in shared memory for the unit; the block walks a fixed chunk
//   of 80-wide column tiles (two maps i) in order. Each tile's epilogue
//   reduces its accumulators against X^0 (in registers for the unit) over
//   j, across the quad's lanes by shuffles, and writes g_x for its two
//   maps; X^0's part g_x0 sums over i in registers through the unit and is
//   written once; chunks write partial g_x0 and a second kernel adds them,
//   in chunk order, to g_x0.
// - The tensor cores truncate their sums, so the products go to an
//   accumulator started afresh every F::kFlush stages and added to an f32
//   total (dense_bwd.cu's measure): every stage in the forward and the
//   operand gradient, every second in the weight gradient (64 rows of R).
//   Between flushes the products run on across stages: a stage is freed
//   once the next stage's first products are issued and all before them
//   done, so the tensor cores drain only at a flush.
// - No float atomics anywhere: two calls give the same bits.
// Measured on an H100 (PERF.md's table of kernels, row 6, has the
// figures and the run they come from): at the cell's layers 2-3 the forward
// runs at some three fifths of its 3xTF32 bound and the two gradients at
// about half, and the step's nine products take under half of cuBLAS f32's
// time. Bulk copies took the producer's cost off the consumers; what bounds
// the kernel now is the consumers' shared-memory traffic (each of a k8
// step's three wgmma reads its B image: half of the shared memory's
// bandwidth at the tensor cores' full rate), the drain at each flush and
// the operand gradient's epilogue between tiles. Two accumulators
// alternated across stages, to flush without a drain, made ptxas serialize
// the products (C7514) and ran 20-25% slower.
// The shapes it takes: rows a multiple of 128 (the wrapper pads them with
// zero rows), m <= 40, any maps, and for the operand gradient H_k <= 200.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "tower_tile.cuh"

namespace {

using hopper::bulk_copy;
using hopper::mbar_arrive_expect;
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

constexpr int kTileM = 128;        // rows of a tile, 64 a consumer warpgroup
constexpr int kConsumers = 256;    // two warpgroups
constexpr int kBlockThreads = kConsumers + 32;   // and one producer warp
constexpr int kMaxStages = 6;
constexpr int kFields = 40;        // m, padded
constexpr int kXPad = 8;           // zero rows after X^{k-1}^T's maps
constexpr int kMaxGLd = 200;       // the operand gradient's G tile: H_k <= 200

// B's images (hi, then lo), K-major without swizzle, as dense_bwd.cu lays
// them: element (n, k) of a stage at (k / 8) * step + (k % 8 / 4) * kHalf +
// (n / 8) * kGroup + (n % 8) * 4 + k % 4, step = (N / 8) * kGroup + 8 floats.
constexpr int kHalf = 36;
constexpr int kGroup = 68;

struct Args {
  const float* img;   // B's images, two a stage (hi, lo)
  const float* src;   // what the pack kernel reads: W^k, or G for the weight gradient
  const float* xt;    // X^{k-1}^T [h_in + kXPad, rows], zero past h_in
  const float* x0p;   // X^0 [rows, 40], zero past m
  const float* xb;    // X^{k-1} by blocks of 32 rows, transposed: [rows / 32][h_in + kXPad][48]
  const float* x0b;   // X^0 the same: [rows / 32][40][48]
  const float* gp;    // G [rows, ld_g], zero past h_out
  float* out;         // X^k [rows, h_out]; g_W [split][h_in·m][h_out]; g_x [rows, h_in]
  float* part;        // the operand gradient's g_x0 parts [split][rows][m]
  int rows;           // a multiple of kTileM
  int rows_real;      // the rows of G that hold data (the weight gradient's pack)
  int h_in, m, h_out, ld_g;
  int tiles_n;        // column tiles
  int depth;          // the weight gradient's stages of R; the operand's of H_k
  int split;          // the weight gradient's depth slices; the operand's column chunks
  int units;
};

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ uint64_t image_desc(const float* image) {
  return static_cast<uint64_t>((smem_addr(image) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(sizeof(float) * kHalf >> 4) << 16) |
         (static_cast<uint64_t>(sizeof(float) * kGroup >> 4) << 32);
}

// A store where pred holds, as a predicated instruction: a branch on the
// lane between asynchronous products would serialize them.
__device__ __forceinline__ void store_if(float* p, float v, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n@p st.global.f32 [%0], %1;\n}" ::"l"(p),
      "f"(v), "r"(static_cast<int>(pred))
      : "memory");
}

__device__ __forceinline__ float2 ld2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// A consumer thread's place: its rows row and row + 8 of the tile, its
// column pair 2t of each n8 tile.
struct Lane {
  int row, t;
  bool lane0;
  __device__ __forceinline__ Lane() {
    const int lane = threadIdx.x % 32;
    row = 64 * warpgroup_index() + 16 * (warp_index() % 4) + lane / 4;
    t = lane % 4;
    lane0 = lane == 0;
  }
};

// --- the three forms -------------------------------------------------------------
// Each gives its tiles (kNt n8 tiles of columns, kSteps k8 steps a stage), its
// ring (kStages stages of kStageFloats, a stage freed to the producer once
// read), its unit slots (kUnitSlots of kUnitFloats: a tile that stays for a
// unit), its walk (units, tiles of a unit, stages of a tile), the copies of a
// stage and of a unit, the pack kernel's value of each image element, and
// its consumers.

struct Fwd {
  static constexpr int kNt = 13;                // 104 columns a tile
  static constexpr int kTileN = 8 * kNt;
  static constexpr int kSteps = kFields / 8;    // a stage: one map i, its 40 fields
  static constexpr int kStages = 5;
  static constexpr int kFlush = 1;   // every stage: the first loss meets the plain one's
                                     // rounding (flushing every second stage read 1.6
                                     // times the error and twice the benchmark's loss_gap)
  static constexpr int kStep = kNt * kGroup + 8;
  static constexpr int kImage = kSteps * kStep;
  static constexpr int kXSide = 2 * kImage;     // X^{k-1}[rows, i]
  static constexpr int kStageFloats = kXSide + kTileM;
  static constexpr int kUnitSlots = 2;
  static constexpr int kUnitFloats = kTileM * kFields;  // X^0 [rows, 40]

  __device__ __forceinline__ static int tiles(const Args&, int) { return 1; }
  __device__ __forceinline__ static int stages(const Args& a, int) { return a.h_in; }
  __device__ __forceinline__ static int m0(const Args& a, int u) { return u / a.tiles_n * kTileM; }
  __host__ __device__ __forceinline__ static int images(const Args& a) { return a.tiles_n * a.h_in; }
  __device__ __forceinline__ static uint32_t unit_bytes(const Args&) {
    return sizeof(float) * kUnitFloats;
  }
  __device__ __forceinline__ static const float* unit_src(const Args& a, int u) {
    return a.x0p + static_cast<size_t>(m0(a, u)) * kFields;
  }
  static constexpr uint32_t kStageBytes = sizeof(float) * (2 * kImage + kTileM);

  __device__ __forceinline__ static void copy_stage(const Args& a, int u, int, int st, float* stage,
                                                    uint64_t* bar, int lane) {
    if (lane == 0) {
      const int image = u % a.tiles_n * a.h_in + st;
      bulk_copy(stage, a.img + static_cast<size_t>(image) * 2 * kImage,
                sizeof(float) * 2 * kImage, bar);
    } else if (lane == 1) {
      bulk_copy(stage + kXSide, a.xt + static_cast<size_t>(st) * a.rows + m0(a, u),
                sizeof(float) * kTileM, bar);
    }
  }

  // image (column tile, map i); position e (+4 for half 1) of step s holds
  // W^k's row i·m + j, j = 8s + 2e + half
  __device__ __forceinline__ static float pack_value(const Args& a, int image, int s, int half,
                                                     int e, int n) {
    const int i = image % a.h_in;
    const int col = image / a.h_in * kTileN + n;
    const int j = 8 * s + 2 * e + half;
    return j < a.m && col < a.h_out ? a.src[(static_cast<size_t>(i) * a.m + j) * a.h_out + col]
                                    : 0.0f;
  }

  // A at step ks: x[row, i]·x0[row, 8 ks + 2t] at position t, ·x0[row, 8 ks +
  // 2t + 1] at t + 4; rows row and row + 8.
  struct Frag {
    const float* x0r;
    const float* x0r8;
    float xa, xb;
    int row;
    __device__ __forceinline__ void stage(const float* s, int) {
      xa = s[kXSide + row];
      xb = s[kXSide + row + 8];
    }
    __device__ __forceinline__ void get(int ks, uint32_t (&h)[4], uint32_t (&l)[4]) const {
      const float2 p = ld2(x0r + 8 * ks);
      const float2 q = ld2(x0r8 + 8 * ks);
      split_tf32(__fmul_rn(xa, p.x), h[0], l[0]);
      split_tf32(__fmul_rn(xb, q.x), h[1], l[1]);
      split_tf32(__fmul_rn(xa, p.y), h[2], l[2]);
      split_tf32(__fmul_rn(xb, q.y), h[3], l[3]);
    }
  };
};

struct Wgrad {
  static constexpr int kNt = 13;
  static constexpr int kTileN = 8 * kNt;
  static constexpr int kDepth = 32;             // rows of R a stage
  static constexpr int kSteps = kDepth / 8;
  static constexpr int kStages = 6;
  static constexpr int kFlush = 2;
  static constexpr int kStep = kNt * kGroup + 8;
  static constexpr int kImage = kSteps * kStep;
  static constexpr int kXRows = 5;              // the maps a tile of 128 (i, j) rows spans
  static constexpr int kALd = kDepth + 16;      // 48: a quarter-warp's 16-byte loads, no conflict
  static constexpr int kASide = 2 * kImage;     // X^{k-1}^T [5][32], then X^0^T [40][32]
  static constexpr int kStageFloats = kASide + (kXRows + kFields) * kALd;
  static constexpr int kUnitSlots = 0;
  static constexpr int kUnitFloats = 0;
  static constexpr uint32_t kStageBytes =
      sizeof(float) * (2 * kImage + (kXRows + kFields) * kALd);

  __device__ __forceinline__ static int tiles(const Args&, int) { return 1; }
  __device__ __forceinline__ static int first(const Args& a, int u) {
    return u % a.split * a.depth / a.split;
  }
  __device__ __forceinline__ static int stages(const Args& a, int u) {
    return (u % a.split + 1) * a.depth / a.split - first(a, u);
  }
  __device__ __forceinline__ static int m0(const Args& a, int u) {
    return u / a.split / a.tiles_n * kTileM;
  }
  __device__ __forceinline__ static int nt(const Args& a, int u) { return u / a.split % a.tiles_n; }
  __host__ __device__ __forceinline__ static int images(const Args& a) { return a.tiles_n * a.depth; }

  // the image, then depth block b of the blocked transposes: X^{k-1}'s
  // maps i_lo + 0..4 and X^0's 40 fields, rows of kALd floats (32 of data)
  __device__ __forceinline__ static void copy_stage(const Args& a, int u, int, int st, float* stage,
                                                    uint64_t* bar, int lane) {
    const int b = first(a, u) + st;
    if (lane == 0) {
      bulk_copy(stage, a.img + static_cast<size_t>(nt(a, u) * a.depth + b) * 2 * kImage,
                sizeof(float) * 2 * kImage, bar);
    } else if (lane == 1) {
      const int i_lo = m0(a, u) / kFields;
      bulk_copy(stage + kASide,
                a.xb + (static_cast<size_t>(b) * (a.h_in + kXPad) + i_lo) * kALd,
                sizeof(float) * kXRows * kALd, bar);
    } else if (lane == 2) {
      bulk_copy(stage + kASide + kXRows * kALd, a.x0b + static_cast<size_t>(b) * kFields * kALd,
                sizeof(float) * kFields * kALd, bar);
    }
  }

  // image (column tile, depth block b); positions e and e + 4 of step s hold
  // G's rows 32 b + 16 (s / 2) + 4e + 2 (s % 2) and + 1: a thread's four
  // depths of two steps are one 16-byte load
  __device__ __forceinline__ static float pack_value(const Args& a, int image, int s, int half,
                                                     int e, int n) {
    const int r = image % a.depth * kDepth + 16 * (s / 2) + 4 * e + 2 * (s % 2) + half;
    const int col = image / a.depth * kTileN + n;
    return r < a.rows_real && col < a.h_out ? a.src[static_cast<size_t>(r) * a.h_out + col]
                                            : 0.0f;
  }

  // A at step ks: rows (i1, j1) and (i2, j2) of the tile, x[r, i]·x0[r, j]
  // at the relabelled depths; the 16-byte loads of an even step serve the
  // next one too.
  struct Frag {
    int a1, a2, b1, b2;    // rows of the A side: maps i - i_lo, fields kXRows + j
    const float* as;
    float4 xa, xb, ya, yb;
    __device__ __forceinline__ void stage(const float* s, int) { as = s + kASide; }
    __device__ __forceinline__ void get(int ks, uint32_t (&h)[4], uint32_t (&l)[4]) {
      if (ks % 2 == 0) {
        const int o = 16 * (ks / 2);
        xa = ld4(as + a1 + o);
        xb = ld4(as + a2 + o);
        ya = ld4(as + b1 + o);
        yb = ld4(as + b2 + o);
      }
      const bool odd = ks % 2 == 1;
      split_tf32(__fmul_rn(odd ? xa.z : xa.x, odd ? ya.z : ya.x), h[0], l[0]);
      split_tf32(__fmul_rn(odd ? xb.z : xb.x, odd ? yb.z : yb.x), h[1], l[1]);
      split_tf32(__fmul_rn(odd ? xa.w : xa.y, odd ? ya.w : ya.y), h[2], l[2]);
      split_tf32(__fmul_rn(odd ? xb.w : xb.y, odd ? yb.w : yb.y), h[3], l[3]);
    }
  };
};

struct Operand {
  static constexpr int kNt = 10;                // 80 columns a tile: two maps i
  static constexpr int kTileN = 8 * kNt;
  static constexpr int kSteps = 5;              // 40 of H_k a stage
  static constexpr int kStages = 4;
  static constexpr int kFlush = 1;
  static constexpr int kStep = kNt * kGroup + 8;
  static constexpr int kImage = kSteps * kStep;
  static constexpr int kXSide = 2 * kImage;     // X^{k-1}[rows, i0], [rows, i0 + 1]
  static constexpr int kStageFloats = kXSide + 2 * kTileM;
  static constexpr int kUnitSlots = 1;
  static constexpr int kUnitFloats = kTileM * kMaxGLd;   // G [rows, H_k]
  static constexpr uint32_t kStageBytes = sizeof(float) * (2 * kImage + 2 * kTileM);

  __device__ __forceinline__ static int first(const Args& a, int u) {
    return u % a.split * a.tiles_n / a.split;
  }
  __device__ __forceinline__ static int tiles(const Args& a, int u) {
    return (u % a.split + 1) * a.tiles_n / a.split - first(a, u);
  }
  __device__ __forceinline__ static int stages(const Args& a, int) { return a.depth; }
  __device__ __forceinline__ static int m0(const Args& a, int u) { return u / a.split * kTileM; }
  __host__ __device__ __forceinline__ static int images(const Args& a) { return a.tiles_n * a.depth; }
  __device__ __forceinline__ static uint32_t unit_bytes(const Args& a) {
    return sizeof(float) * kTileM * a.ld_g;
  }
  __device__ __forceinline__ static const float* unit_src(const Args& a, int u) {
    return a.gp + static_cast<size_t>(m0(a, u)) * a.ld_g;
  }

  __device__ __forceinline__ static void copy_stage(const Args& a, int u, int tile, int st,
                                                    float* stage, uint64_t* bar, int lane) {
    const int ct = first(a, u) + tile;
    if (lane == 0) {
      bulk_copy(stage, a.img + static_cast<size_t>(ct * a.depth + st) * 2 * kImage,
                sizeof(float) * 2 * kImage, bar);
    } else if (lane < 3) {
      const int i = 2 * ct + lane - 1;
      bulk_copy(stage + kXSide + (lane - 1) * kTileM,
                a.xt + static_cast<size_t>(i) * a.rows + m0(a, u), sizeof(float) * kTileM, bar);
    }
  }

  // image (column tile ct, depth stage d); column n is W^k's row i·m + j, i =
  // 2 ct + n / 40, j = n % 40; positions e and e + 4 of step s hold depths 40 d
  // + 8s + 2e and + 1
  __device__ __forceinline__ static float pack_value(const Args& a, int image, int s, int half,
                                                     int e, int n) {
    const int i = image / a.depth * 2 + n / kFields;
    const int j = n % kFields;
    const int h = image % a.depth * 40 + 8 * s + 2 * e + half;
    return i < a.h_in && j < a.m && h < a.h_out
               ? a.src[(static_cast<size_t>(i) * a.m + j) * a.h_out + h]
               : 0.0f;
  }

  // A at step ks of stage st: G[row, 40 st + 8 ks + 2t] at position t, + 1 at t + 4
  struct Frag {
    const float* gs;
    int ld, row, t;
    const float* gr;
    const float* gr8;
    float xr[2][2];   // X^{k-1}[row (+8), i0 + half]
    __device__ __forceinline__ void stage(const float* s, int st) {
      gr = gs + row * ld + 40 * st + 2 * t;
      gr8 = gr + 8 * ld;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        xr[h][0] = s[kXSide + row + 8 * h];
        xr[h][1] = s[kXSide + kTileM + row + 8 * h];
      }
    }
    __device__ __forceinline__ void get(int ks, uint32_t (&h)[4], uint32_t (&l)[4]) const {
      const float2 p = ld2(gr + 8 * ks);
      const float2 q = ld2(gr8 + 8 * ks);
      split_tf32(p.x, h[0], l[0]);
      split_tf32(q.x, h[1], l[1]);
      split_tf32(p.y, h[2], l[2]);
      split_tf32(q.y, h[3], l[3]);
    }
  };
};

// --- consumers -------------------------------------------------------------------

template <class F>
struct Ring {
  float* smem;
  uint64_t* full;
  uint64_t* empty;
  int it;   // the ring's stages consumed so far
  __device__ __forceinline__ float* stage(int i) const {
    return smem + (i % F::kStages) * F::kStageFloats;
  }
  __device__ __forceinline__ void wait(int i) const {
    mbar_wait(&full[i % F::kStages], (i / F::kStages) & 1);
  }
  __device__ __forceinline__ void free(int i, bool pred) const {
    mbar_arrive_if(&empty[i % F::kStages], pred);
  }
};

// Stage st of a tile of n stages (ring stage i = r.it + st), whose first A
// fragment is in set kFlip: its kSteps k8 steps, each three wgmma.m64nNk8
// (lo.hi + hi.lo + hi.hi) as one commit group, the next step's A formed
// while the previous group runs; the accumulator starts afresh at the first
// stage of a flush group and is added to total at its last. At a flush the
// stage is freed once its products are done; otherwise the next stage's A
// is formed on, and the stage is freed after the next stage's first group
// is issued and every group before it done (held).
template <class F, int kFlip, class Frag>
__device__ __forceinline__ void stage_body(const Ring<F>& r, int st, int n, float (&acc)[4 * F::kNt],
                                           float (&total)[4 * F::kNt], Frag& frag,
                                           uint32_t (&ah)[2][4], uint32_t (&al)[2][4], bool& held,
                                           bool lane0) {
  constexpr int kNt = F::kNt;
  constexpr int kSteps = F::kSteps;
  constexpr uint64_t kStepDesc = (sizeof(float) * F::kStep) >> 4;
  const int i = r.it + st;
  const float* stage = r.stage(i);
  const uint64_t hi = image_desc(stage);
  const uint64_t lo = image_desc(stage + F::kImage);
  const int fresh = st % F::kFlush == 0 ? 0 : 1;
  const bool flush = st % F::kFlush == F::kFlush - 1 || st + 1 == n;
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
    const int set = (ks + kFlip) % 2;
    fence_operands(acc);
    wgmma_fence();
    tower::Wgmma<kNt>::mma(acc, al[set], hi + ks * kStepDesc, ks == 0 ? fresh : 1);
    tower::Wgmma<kNt>::mma(acc, ah[set], lo + ks * kStepDesc, 1);
    tower::Wgmma<kNt>::mma(acc, ah[set], hi + ks * kStepDesc, 1);
    wgmma_commit();
    if (ks + 1 < kSteps) {
      wgmma_wait<1>();  // the previous group is done with the other set
      if (ks == 0) {
        r.free(i + F::kStages - 1, lane0 && held);   // the previous stage: its groups are done
        held = false;
      }
      frag.get(ks + 1, ah[1 - set], al[1 - set]);
    }
  }
  constexpr int kNext = (kSteps + kFlip) % 2;
  if (flush) {
    wgmma_wait<0>();
    fence_operands(acc);
#pragma unroll
    for (int k = 0; k < 4 * kNt; ++k) total[k] += acc[k];
    r.free(i, lane0);
    if (st + 1 < n) {
      r.wait(i + 1);
      frag.stage(r.stage(i + 1), st + 1);
      frag.get(0, ah[kNext], al[kNext]);
    }
  } else {
    r.wait(i + 1);
    frag.stage(r.stage(i + 1), st + 1);
    wgmma_wait<1>();
    frag.get(0, ah[kNext], al[kNext]);
    held = true;
  }
}

// One tile's products over its n stages of the ring into total.
template <class F, class Frag>
__device__ __forceinline__ void tile_products(Ring<F>& r, int n, float (&acc)[4 * F::kNt],
                                              float (&total)[4 * F::kNt], Frag& frag, bool lane0) {
  uint32_t ah[2][4], al[2][4];
#pragma unroll
  for (int k = 0; k < 4 * F::kNt; ++k) total[k] = 0.0f;
  r.wait(r.it);
  frag.stage(r.stage(r.it), 0);
  frag.get(0, ah[0], al[0]);
  bool held = false;
  for (int st = 0;;) {
    stage_body<F, 0>(r, st, n, acc, total, frag, ah, al, held, lane0);
    if (++st == n) break;
    stage_body<F, F::kSteps % 2>(r, st, n, acc, total, frag, ah, al, held, lane0);
    if (++st == n) break;
  }
  r.it += n;
}

template <class F>
__device__ __forceinline__ float* unit_slot(float* smem, int uc) {
  return smem + F::kStages * F::kStageFloats + uc % F::kUnitSlots * F::kUnitFloats;
}

__device__ __forceinline__ void consume_fwd(const Args& a, float* smem, uint64_t* full,
                                            uint64_t* empty, uint64_t* unit_full,
                                            uint64_t* unit_empty) {
  using F = Fwd;
  const Lane ln;
  float acc[4 * F::kNt], total[4 * F::kNt];
#pragma unroll
  for (int k = 0; k < 4 * F::kNt; ++k) acc[k] = 0.0f;
  Ring<F> r{smem, full, empty, 0};
  F::Frag f;
  f.row = ln.row;
  int uc = 0;
  for (int u = blockIdx.x; u < a.units; u += gridDim.x, ++uc) {
    const int slot = uc % F::kUnitSlots;
    const float* x0s = unit_slot<F>(smem, uc);
    f.x0r = x0s + ln.row * kFields + 2 * ln.t;
    f.x0r8 = f.x0r + 8 * kFields;
    mbar_wait(&unit_full[slot], (uc / F::kUnitSlots) & 1);
    tile_products<F>(r, a.h_in, acc, total, f, ln.lane0);
    mbar_arrive_if(&unit_empty[slot], ln.lane0);
    const int n0 = u % a.tiles_n * F::kTileN + 2 * ln.t;
    float* out = a.out + static_cast<size_t>(F::m0(a, u) + ln.row) * a.h_out;
#pragma unroll
    for (int j = 0; j < F::kNt; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + 8 * j + e;
        store_if(out + n, total[4 * j + e], n < a.h_out);
        store_if(out + 8 * static_cast<size_t>(a.h_out) + n, total[4 * j + 2 + e], n < a.h_out);
      }
    }
  }
}

__device__ __forceinline__ void consume_wgrad(const Args& a, float* smem, uint64_t* full,
                                              uint64_t* empty, uint64_t*, uint64_t*) {
  using F = Wgrad;
  const Lane ln;
  float acc[4 * F::kNt], total[4 * F::kNt];
#pragma unroll
  for (int k = 0; k < 4 * F::kNt; ++k) acc[k] = 0.0f;
  Ring<F> r{smem, full, empty, 0};
  F::Frag f;
  for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
    const int mt = F::m0(a, u);
    const int k1 = mt + ln.row, k2 = k1 + 8;
    const int i1 = k1 / kFields, j1 = k1 % kFields;
    const int i2 = k2 / kFields, j2 = k2 % kFields;
    const int i_lo = mt / kFields;
    f.a1 = (i1 - i_lo) * F::kALd + 4 * ln.t;
    f.a2 = (i2 - i_lo) * F::kALd + 4 * ln.t;
    f.b1 = (F::kXRows + j1) * F::kALd + 4 * ln.t;
    f.b2 = (F::kXRows + j2) * F::kALd + 4 * ln.t;
    tile_products<F>(r, F::stages(a, u), acc, total, f, ln.lane0);
    const int c0 = F::nt(a, u) * F::kTileN + 2 * ln.t;
    float* out = a.out + static_cast<size_t>(u % a.split) * a.h_in * a.m * a.h_out;
    const bool ok1 = i1 < a.h_in && j1 < a.m, ok2 = i2 < a.h_in && j2 < a.m;
    float* o1 = out + static_cast<size_t>(ok1 ? i1 * a.m + j1 : 0) * a.h_out;
    float* o2 = out + static_cast<size_t>(ok2 ? i2 * a.m + j2 : 0) * a.h_out;
#pragma unroll
    for (int j = 0; j < F::kNt; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c0 + 8 * j + e;
        store_if(o1 + col, total[4 * j + e], ok1 && col < a.h_out);
        store_if(o2 + col, total[4 * j + 2 + e], ok2 && col < a.h_out);
      }
    }
  }
}

__device__ __forceinline__ void consume_ograd(const Args& a, float* smem, uint64_t* full,
                                              uint64_t* empty, uint64_t* unit_full,
                                              uint64_t* unit_empty) {
  using F = Operand;
  const Lane ln;
  float acc[4 * F::kNt], total[4 * F::kNt];
#pragma unroll
  for (int k = 0; k < 4 * F::kNt; ++k) acc[k] = 0.0f;
  Ring<F> r{smem, full, empty, 0};
  F::Frag f;
  f.gs = unit_slot<F>(smem, 0);
  f.ld = a.ld_g;
  f.row = ln.row;
  f.t = ln.t;
  int uc = 0;
  for (int u = blockIdx.x; u < a.units; u += gridDim.x, ++uc) {
    const int r0 = F::m0(a, u) + ln.row;
    // X^0 at this thread's columns of a 40-wide group, j = 8c + 2t + e
    float x0r[2][5][2], gx0[2][5][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int c = 0; c < 5; ++c) {
        const float2 v = ld2(a.x0p + static_cast<size_t>(r0 + 8 * h) * kFields + 8 * c + 2 * ln.t);
        x0r[h][c][0] = v.x;
        x0r[h][c][1] = v.y;
        gx0[h][c][0] = gx0[h][c][1] = 0.0f;
      }
    }
    mbar_wait(unit_full, uc & 1);
    const int ct0 = F::first(a, u);
    const int tiles = F::tiles(a, u);
    for (int ct = 0; ct < tiles; ++ct) {
      tile_products<F>(r, a.depth, acc, total, f, ln.lane0);
      // column 8n + 2t + e of the tile: map i0 + n / 5, field 8 (n % 5) + 2t + e
      float gx[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};   // [half][row, row + 8]
#pragma unroll
      for (int n = 0; n < F::kNt; ++n) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float v = total[4 * n + 2 * h + e];
            gx[n / 5][h] += v * x0r[h][n % 5][e];
            gx0[h][n % 5][e] += v * f.xr[h][n / 5];
          }
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          gx[half][h] += __shfl_xor_sync(0xffffffffu, gx[half][h], 1);
          gx[half][h] += __shfl_xor_sync(0xffffffffu, gx[half][h], 2);
        }
      }
      // lane t writes value t: map i0 + t / 2, row + 8 (t % 2)
      const int half = ln.t / 2, h = ln.t % 2;
      const float v = half ? (h ? gx[1][1] : gx[1][0]) : (h ? gx[0][1] : gx[0][0]);
      const int i = 2 * (ct0 + ct) + half;
      store_if(a.out + static_cast<size_t>(r0 + 8 * h) * a.h_in + (i < a.h_in ? i : 0), v,
               i < a.h_in);
    }
    mbar_arrive_if(unit_empty, ln.lane0);
    float* part = a.part + static_cast<size_t>(u % a.split) * a.rows * a.m;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int c = 0; c < 5; ++c) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 8 * c + 2 * ln.t + e;
          store_if(part + static_cast<size_t>(r0 + 8 * h) * a.m + (j < a.m ? j : 0),
                   gx0[h][c][e], j < a.m);
        }
      }
    }
  }
}

// --- the producer warp -----------------------------------------------------------

// The unit's resident tile into its slot once the consumers have freed it;
// then each stage into the ring once the consumers have freed its slot,
// the stage's bytes announced on its full barrier by lane 0 before the
// copies start.
template <class F>
__device__ __forceinline__ void produce(const Args& a, float* smem, uint64_t* full, uint64_t* empty,
                                        uint64_t* unit_full, uint64_t* unit_empty) {
  const int lane = threadIdx.x % 32;
  int it = 0, uc = 0;
  for (int u = blockIdx.x; u < a.units; u += gridDim.x, ++uc) {
    if constexpr (F::kUnitSlots > 0) {
      const int slot = uc % F::kUnitSlots;
      if (uc >= F::kUnitSlots) mbar_wait(&unit_empty[slot], (uc / F::kUnitSlots - 1) & 1);
      if (lane == 0) {
        const uint32_t bytes = F::unit_bytes(a);
        mbar_arrive_expect(&unit_full[slot], bytes);
        bulk_copy(unit_slot<F>(smem, uc), F::unit_src(a, u), bytes, &unit_full[slot]);
      }
    }
    const int tiles = F::tiles(a, u);
    const int stages = F::stages(a, u);
    for (int tile = 0; tile < tiles; ++tile) {
      for (int st = 0; st < stages; ++st, ++it) {
        const int s = it % F::kStages;
        if (it >= F::kStages) mbar_wait(&empty[s], (it / F::kStages - 1) & 1);
        if (lane == 0) mbar_arrive_expect(&full[s], F::kStageBytes);
        __syncwarp();
        F::copy_stage(a, u, tile, st, smem + s * F::kStageFloats, &full[s], lane);
      }
    }
  }
}

template <class F, void (*kConsume)(const Args&, float*, uint64_t*, uint64_t*, uint64_t*, uint64_t*)>
__device__ __forceinline__ void run(const Args& a) {
  extern __shared__ __align__(128) float smem[];
  __shared__ uint64_t full[kMaxStages], empty[kMaxStages], unit_full[2], unit_empty[2];
  if (threadIdx.x == 0) {
    for (int s = 0; s < F::kStages; ++s) {
      mbar_init(&full[s], 1);                 // the producer's arrival with the stage's bytes
      mbar_init(&empty[s], kConsumers / 32);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&unit_full[s], 1);
      mbar_init(&unit_empty[s], kConsumers / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();
  // the roles split on a warp-uniform index: products after a branch ptxas
  // cannot prove uniform are serialized (tower_tile.cuh)
  if (warp_index() >= kConsumers / 32) {
    produce<F>(a, smem, full, empty, unit_full, unit_empty);
  } else {
    kConsume(a, smem, full, empty, unit_full, unit_empty);
  }
}

__global__ void __launch_bounds__(kBlockThreads, 1) cin_fwd_kernel(Args a) {
  run<Fwd, consume_fwd>(a);
}
__global__ void __launch_bounds__(kBlockThreads, 1) cin_wgrad_kernel(Args a) {
  run<Wgrad, consume_wgrad>(a);
}
__global__ void __launch_bounds__(kBlockThreads, 1) cin_ograd_kernel(Args a) {
  run<Operand, consume_ograd>(a);
}

// B's images: each thread a 16-byte quad of the hi image and its lo quad.
template <class F>
__global__ void cin_pack_kernel(Args a, float* img) {
  const size_t quads = static_cast<size_t>(F::images(a)) * F::kSteps * 2 * F::kTileN;
  for (size_t q = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; q < quads;
       q += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int n = static_cast<int>(q % F::kTileN);
    const size_t rest = q / F::kTileN;
    const int half = static_cast<int>(rest % 2);
    const int s = static_cast<int>(rest / 2 % F::kSteps);
    const int image = static_cast<int>(rest / 2 / F::kSteps);
    uint32_t h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(F::pack_value(a, image, s, half, e, n), h[e], l[e]);
    float* hi = img + static_cast<size_t>(image) * 2 * F::kImage + s * F::kStep + half * kHalf +
                n / 8 * kGroup + n % 8 * 4;
    *reinterpret_cast<uint4*>(hi) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(hi + F::kImage) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// out[i] = (add ? out[i] : 0) + parts[0][i] + ... + parts[n - 1][i], in
// order; the parts `stride` floats apart.
__global__ void cin_sum_kernel(const float* __restrict__ parts, int n, size_t size, size_t stride,
                               float* __restrict__ out, int add) {
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < size;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = parts[i];
    for (int j = 1; j < n; ++j) s += parts[j * stride + i];
    out[i] = add ? out[i] + s : s;
  }
}

int device_sms() {
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) {
    return 0;
  }
  return sms;
}

unsigned grid_of(size_t work, int sms) {
  const size_t blocks = (work + 255) / 256;
  const size_t most = 8 * static_cast<size_t>(sms > 0 ? sms : 1);
  return static_cast<unsigned>(blocks < most ? (blocks > 0 ? blocks : 1) : most);
}

template <class F>
cudaError_t launch(void (*kernel)(Args), const Args& a, float* img, cudaStream_t stream) {
  const int sms = device_sms();
  if (sms < 1) return cudaErrorInitializationError;
  const size_t quads = static_cast<size_t>(F::images(a)) * F::kSteps * 2 * F::kTileN;
  cin_pack_kernel<F><<<grid_of(quads, sms), 256, 0, stream>>>(a, img);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr size_t smem =
      sizeof(float) * (F::kStages * F::kStageFloats + F::kUnitSlots * F::kUnitFloats);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<a.units < sms ? a.units : sms, kBlockThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t sum(const float* parts, int n, size_t size, size_t stride, float* out, bool add,
                cudaStream_t stream) {
  cin_sum_kernel<<<grid_of(size, device_sms()), 256, 0, stream>>>(parts, n, size, stride, out,
                                                                 add ? 1 : 0);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

bool valid(const void* xt, const void* img, int rows, int h_in, int m, int h_out) {
  return xt != nullptr && img != nullptr && aligned16(xt) && aligned16(img) && rows > 0 &&
         rows % kTileM == 0 && h_in > 0 && m > 0 && m <= kFields && h_out > 0;
}

Args make_args(const void* xt, const void* img, int rows, int h_in, int m, int h_out) {
  Args a{};
  a.xt = static_cast<const float*>(xt);
  a.img = static_cast<const float*>(img);
  a.rows = rows;
  a.rows_real = rows;
  a.h_in = h_in;
  a.m = m;
  a.h_out = h_out;
  return a;
}

}  // namespace

// One CIN layer's products in float32 by 3xTF32 on the tensor cores, the
// outer product Z[r, i·m + j] = x[r, i]·x0[r, j] formed in registers. The
// operands, contiguous f32 on the device, rows a multiple of 128 (zero past
// the data): xt = x^T [h_in + 8, rows] (zero past h_in), x0p = x0 [rows,
// 40] (zero past m), xb [rows / 32][h_in + 8][48] with xb[b][i][c] = xt[i][32
// b + c] for c < 32, x0b [rows / 32][40][48] the same of x0p^T, w [h_in·m,
// h_out], g [rows_real, h_out], gp = g [rows, ld_g] (zero past h_out); m <=
// 40. img
// holds cin_image_floats(form, ...) floats for B's images. Each returns a
// cudaError_t code; 0 means launched on the stream.

// The floats of B's images for form 0 (forward), 1 (weight gradient) or 2
// (operand gradient); 0 for another form.
extern "C" long long cin_image_floats(int form, int rows, int h_in, int m, int h_out) {
  (void)m;
  if (form == 0) {
    return 2LL * Fwd::kImage * cdiv(h_out, Fwd::kTileN) * h_in;
  }
  if (form == 1) {
    return 2LL * Wgrad::kImage * cdiv(h_out, Wgrad::kTileN) * cdiv(rows, Wgrad::kDepth);
  }
  if (form == 2) {
    return 2LL * Operand::kImage * cdiv(h_in, 2) * cdiv(h_out, 40);
  }
  return 0;
}

// out [rows, h_out] = Z · w.
extern "C" int cin_forward(const void* xt, const void* x0p, const void* w, void* img, void* out,
                           int rows, int h_in, int m, int h_out, void* stream) {
  if (!valid(xt, img, rows, h_in, m, h_out) || x0p == nullptr || !aligned16(x0p) ||
      w == nullptr || out == nullptr) {
    return cudaErrorInvalidValue;
  }
  Args a = make_args(xt, img, rows, h_in, m, h_out);
  a.x0p = static_cast<const float*>(x0p);
  a.src = static_cast<const float*>(w);
  a.out = static_cast<float*>(out);
  a.tiles_n = cdiv(h_out, Fwd::kTileN);
  a.split = 1;
  a.units = rows / kTileM * a.tiles_n;
  return launch<Fwd>(cin_fwd_kernel, a, static_cast<float*>(img),
                     static_cast<cudaStream_t>(stream));
}

// out [h_in·m, h_out] = Z^T · g over the rows, the depth cut into `slices`
// fixed slices of 32-row stages (1 <= slices <= rows / 32); above 1,
// workspace holds slices · h_in·m · h_out floats and a second kernel sums
// them in slice order.
extern "C" int cin_weight_grad(const void* xb, const void* x0b, const void* g, void* img,
                               void* out, void* workspace, int rows, int rows_real, int h_in,
                               int m, int h_out, int slices, void* stream) {
  if (!valid(xb, img, rows, h_in, m, h_out) || x0b == nullptr || !aligned16(x0b) ||
      g == nullptr || out == nullptr || rows_real < 1 || rows_real > rows || slices < 1 ||
      slices > rows / Wgrad::kDepth || (slices > 1 && workspace == nullptr)) {
    return cudaErrorInvalidValue;
  }
  Args a = make_args(nullptr, img, rows, h_in, m, h_out);
  a.xb = static_cast<const float*>(xb);
  a.x0b = static_cast<const float*>(x0b);
  a.src = static_cast<const float*>(g);
  a.rows_real = rows_real;
  a.out = static_cast<float*>(slices > 1 ? workspace : out);
  a.tiles_n = cdiv(h_out, Wgrad::kTileN);
  a.depth = rows / Wgrad::kDepth;
  a.split = slices;
  a.units = cdiv(h_in * kFields, kTileM) * a.tiles_n * slices;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = launch<Wgrad>(cin_wgrad_kernel, a, static_cast<float*>(img), st);
  if (err != cudaSuccess || slices == 1) return err;
  const size_t size = static_cast<size_t>(h_in) * m * h_out;
  return sum(a.out, slices, size, size, static_cast<float*>(out), false, st);
}

// g_x [rows, h_in] = Σ_j (g · w^T)[r, (i, j)] · x0[r, j], and g_x0
// [rows_real, m] += Σ_i (g · w^T)[r, (i, j)] · x[r, i]; h_out <= 200, ld_g =
// 40·ceil(h_out / 40). The column tiles are cut into `chunks` fixed chunks
// (1 <= chunks <= ceil(h_in / 2)); workspace holds chunks · rows · m
// floats, which a second kernel adds to g_x0 in chunk order.
extern "C" int cin_operand_grad(const void* xt, const void* x0p, const void* gp, const void* w,
                                void* img, void* g_x, void* g_x0, void* workspace, int rows,
                                int rows_real, int h_in, int m, int h_out, int chunks,
                                void* stream) {
  if (!valid(xt, img, rows, h_in, m, h_out) || x0p == nullptr || !aligned16(x0p) ||
      gp == nullptr || !aligned16(gp) || w == nullptr || g_x == nullptr || g_x0 == nullptr ||
      workspace == nullptr || h_out > kMaxGLd || rows_real < 1 || rows_real > rows ||
      chunks < 1 || chunks > cdiv(h_in, 2)) {
    return cudaErrorInvalidValue;
  }
  Args a = make_args(xt, img, rows, h_in, m, h_out);
  a.x0p = static_cast<const float*>(x0p);
  a.gp = static_cast<const float*>(gp);
  a.src = static_cast<const float*>(w);
  a.out = static_cast<float*>(g_x);
  a.part = static_cast<float*>(workspace);
  a.depth = cdiv(h_out, 40);
  a.ld_g = 40 * a.depth;
  a.tiles_n = cdiv(h_in, 2);
  a.split = chunks;
  a.units = rows / kTileM * chunks;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = launch<Operand>(cin_ograd_kernel, a, static_cast<float*>(img), st);
  if (err != cudaSuccess) return err;
  return sum(a.part, chunks, static_cast<size_t>(rows_real) * m, static_cast<size_t>(rows) * m,
             static_cast<float*>(g_x0), true, st);
}
