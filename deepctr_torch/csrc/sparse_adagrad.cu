// Dense-mode sparse Adagrad for Hopper (sm_90a): the update of the rows a
// batch touches, behind a plain C entry point loaded with ctypes by
// deepctr_torch/ops/kernels/sparse.py.
//
// Replaces no TPU kernel: the reference's update
// (deepctr_tpu/optim/sparse.py, SparseAdagrad in dense mode) is plain jnp.
// The port's plain version (sparse.py::adagrad_dense_plain) builds the
// per-row summed gradient G in a zeroed f32 [V, D] scratch
// (ops/scatter.py::scatter_totals: a sort, a prefix sum in 61-bit fixed
// point, a binary search, an index_put) and then makes some ten elementwise
// passes over the whole table and its accumulator, although every row the
// batch does not touch has G = 0 and keeps its bits.
//
// What bounds it on an H100: bytes. The occurrences' ids and gradient rows
// are read, and for each touched row its accumulator and table row are read
// and written: about 10 MB at iPinYou's shape (M = 147,456 occurrences of
// D = 11), about 1.8 GB at DLRM's (M = 1,753,088 of D = 128, some 427,000
// distinct rows under its Zipf ids), where the gradient rows alone (897 MB)
// do not fit the 50 MB L2. Under Zipf ids a hot row takes thousands of occurrences (72,000 a
// batch on DLRM's hottest), so whatever adds into one row's address from
// every occurrence is serialised by the card.
//
// What the design does about it: a counting sort of the occurrences by row,
// then one pass that sums each row's segment in registers and applies the
// row, in four launches on the current stream.
// 1. elect: the blocks stream the [M, D] values for the largest |value|
//    (the last block to finish reduces the blocks' maxima and stores
//    scatter_totals' scale: frexp(max * M * D) = (m, e), scale = 2^(61 -
//    e), in double), then take 256 occurrences at a time: each distinct
//    id's owner, the occurrence that first swaps the id's int32 [V] slot
//    from INT_MAX, the value it holds between calls, to its own index, and
//    joins a list of owners; and each owner's count of occurrences. The
//    block dedupes its ids in a shared-memory hash and counts each id's
//    occurrences there, so a hot id costs one global atomic a block, not one
//    an occurrence; that atomic's old value is the block's first place in
//    the row's segment, and each occurrence keeps its owner and place;
// 2. allocate: over the owner list, each row is given its segment of an
//    int32 [M] array by a block-wide scan of the counts and one atomic a
//    block on a cursor (segments lie in any order), and a row of more than
//    C occurrences a split slot and a list entry for each chunk past its
//    first. C (chunk_for) is about half the occurrences each lane group of
//    a full card takes when M is dealt out evenly, so no chunk holds its
//    group much past the others (100 at DLRM's shape on an H100, and the
//    least, 8, at iPinYou's). The owner slots and counts go back to their
//    values between calls;
// 3. scatter: each occurrence writes its index at its place in its row's
//    segment. The order inside a segment is immaterial: the sums below are
//    exact integers;
// 4. reduce and apply: each work item, a row's first C occurrences or one of
//    its later chunks, goes to a group of lanes (below 32 columns one
//    column a lane and whole rows to a warp; else 32 lanes of 4 columns in
//    each tile of 128, as one 16-byte vector where the rows allow), with
//    the next item's row loaded while this one is summed. The group reads
//    its occurrences' gradient rows, a round of several at a time (a row of
//    one occurrence carries it in place of a segment), scales each value to
//    fixed point as scatter_totals scales it, rint(v * 2^k) half to even
//    (in float where 2^k is a float: the product is exact, or below one
//    half where it is not), and sums them as int64 in registers. A row of
//    one chunk (most rows) is applied there: g = float(double(sum) * 2^-k),
//    which is the division by 2^k, acc = acc + g*g and t = float(table) -
//    (lr*g) / (sqrt(acc) + eps), rounded once to the table's dtype, each
//    operation rounded as PyTorch's separate elementwise kernels round it
//    (the _rn intrinsics keep nvcc from contracting acc + g*g into an FMA).
//    A split row's chunks add their sums into its int64 [D] row of a small
//    workspace (one atomic a column a chunk: integer sums are exact in any
//    order) and the last chunk to finish takes the sums out, leaving zeros,
//    and applies the row. The last block to finish adds the rows written
//    and the rows split to two device counters and resets the scratch's
//    counts.
// The sums are the plain version's exact integers, so the table and
// accumulator equal its bits, from run to run. Each call leaves the owner
// slots, the counts, the split workspace and the scratch's counts as it
// found them, with no memset. Ids outside [0, V) (the sharded exchange's V
// for an empty slot) are dropped, as the plain version drops them into its
// spare row; their values still count in the scale, as they do there.
// Untouched rows are neither read nor written. A non-finite gradient is
// undefined in both versions.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;        // threads a block; occurrences an elect chunk
constexpr int kHash = 2 * kThreads;  // slots of an elect block's hash of ids
constexpr int kEmpty = -1;
// a chunk holds about 1 / kChunkShare of the occurrences that each lane
// group of a full card would take if they were dealt out evenly
constexpr int kChunkShare = 2;

// the scratch the wrapper owns beside the workspace, zeros at first: the
// scale, six counts that the last block of their pass puts back to 0, and
// one maximum an elect block
struct Scratch {
  double scale;
  unsigned done;         // elect blocks done
  unsigned owners;       // distinct ids: the length of the owner list
  unsigned placed;       // occurrences given a segment (the allocate cursor)
  unsigned splits;       // rows of more than one chunk
  unsigned extras;       // chunks past a split row's first
  unsigned reduce_done;  // reduce blocks done
  float partials[1];
};

// lanes a row: a row's columns lie across the lanes of one warp, whole rows
// to a warp (one row a warp past 32 columns)
__host__ __device__ __forceinline__ int lanes_a_row(int d) { return d < 32 ? d : 32; }

// the occurrences whose values a lane group loads at once in the reduce
// pass, whose lanes hold ``cols`` columns of a row: one each of a row
// narrower than a warp, else 4 of each tile of 128
__host__ __device__ constexpr int unroll_for(int cols) { return cols == 1 ? 8 : 4; }

__device__ __forceinline__ float load_value(const float* p) { return *p; }
__device__ __forceinline__ float load_value(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_value(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_value(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// four consecutive values at a 16-byte (f32) or 8-byte (bf16) boundary
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.y));
  v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 x;
  x.x = *reinterpret_cast<unsigned*>(&lo);
  x.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = x;
}

// the block's largest of ``v``, in every thread
__device__ float block_max(float v) {
  __shared__ float warp_max[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) warp_max[warp] = v;
  __syncthreads();
  v = lane < kThreads / 32 ? warp_max[lane] : 0.0f;
  for (int off = 16; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  __syncthreads();
  return v;
}

// the block's exclusive prefix sums of ``v``, and their totals in ``total``
__device__ int3 block_scan(int3 v, int3* total) {
  __shared__ int3 warp_sum[kThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int3 in = v;
  for (int off = 1; off < 32; off <<= 1) {
    const int x = __shfl_up_sync(0xffffffffu, in.x, off);
    const int y = __shfl_up_sync(0xffffffffu, in.y, off);
    const int z = __shfl_up_sync(0xffffffffu, in.z, off);
    if (lane >= off) in.x += x, in.y += y, in.z += z;
  }
  if (lane == 31) warp_sum[warp] = in;
  __syncthreads();
  int3 before = make_int3(0, 0, 0), all = make_int3(0, 0, 0);
  for (int j = 0; j < kThreads / 32; ++j) {
    const int3 t = warp_sum[j];
    if (j < warp) before.x += t.x, before.y += t.y, before.z += t.z;
    all.x += t.x, all.y += t.y, all.z += t.z;
  }
  __syncthreads();
  *total = all;
  return make_int3(before.x + in.x - v.x, before.y + in.y - v.y, before.z + in.z - v.z);
}

// puts ``key`` (>= 0) into the block's open-addressing hash; returns its
// slot, and whether this call put it there (one caller a key does)
__device__ __forceinline__ int hash_insert(int* keys, int key, bool* inserted) {
  int h = static_cast<int>((static_cast<unsigned>(key) * 2654435761u) >> 23) & (kHash - 1);
  while (true) {
    const int prev = atomicCAS(keys + h, kEmpty, key);
    if (prev == kEmpty || prev == key) {
      *inserted = prev == kEmpty;
      return h;
    }
    h = (h + 1) & (kHash - 1);
  }
}

// place[i]: (owner << 32) | the occurrence's place in its row's segment, or
// -1 for a dropped id; counts[owner]: the row's occurrences; owner_list: the
// owners, in any order
__global__ void __launch_bounds__(kThreads)
elect_kernel(const long long* __restrict__ ids, const float* __restrict__ rows,
             long long num_rows, int d, unsigned m, int* __restrict__ owner,
             int* __restrict__ owner_list, int* __restrict__ counts,
             long long* __restrict__ place, Scratch* __restrict__ scratch) {
  __shared__ int keys[kHash];
  __shared__ int here[kHash];        // the chunk's occurrences of the slot's id
  __shared__ int slot_owner[kHash];
  __shared__ int slot_base[kHash];   // the chunk's first place in the row's segment
  __shared__ int won_here, list_base;
  __shared__ bool last;
  // the largest |value|, over the rows as one flat array: 16 bytes a load
  // where they start at such a boundary
  float mx = 0.0f;
  const long long numel = static_cast<long long>(m) * d;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long from = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long quads = reinterpret_cast<unsigned long long>(rows) % 16 == 0 ? numel / 4 : 0;
  const float4* rows4 = reinterpret_cast<const float4*>(rows);
#pragma unroll 4
  for (long long q = from; q < quads; q += stride) {
    const float4 x = __ldg(rows4 + q);
    mx = fmaxf(mx, fmaxf(fmaxf(fabsf(x.x), fabsf(x.y)), fmaxf(fabsf(x.z), fabsf(x.w))));
  }
  for (long long e = 4 * quads + from; e < numel; e += stride) mx = fmaxf(mx, fabsf(rows[e]));
  for (unsigned base = blockIdx.x * kThreads; base < m; base += gridDim.x * kThreads) {
    const unsigned count = min(m - base, static_cast<unsigned>(kThreads));
    for (int j = threadIdx.x; j < kHash; j += kThreads) keys[j] = kEmpty, here[j] = 0;
    if (threadIdx.x == 0) won_here = 0;
    __syncthreads();
    const unsigned i = base + threadIdx.x;
    long long id = -1;
    int h = -1, rank = 0, pos = -1;
    bool first = false;
    if (threadIdx.x < count) {
      id = ids[i];
      if (id >= 0 && id < num_rows) {
        h = hash_insert(keys, static_cast<int>(id), &first);
        rank = atomicAdd(here + h, 1);
      }
    }
    __syncthreads();
    if (first) {  // one thread a distinct id: its owner, and the chunk's places
      int o = owner[id];  // INT_MAX, or the owner another block elected
      if (o == INT_MAX) {
        o = atomicCAS(owner + id, INT_MAX, static_cast<int>(i));
        if (o == INT_MAX) o = static_cast<int>(i), pos = atomicAdd(&won_here, 1);
      }
      slot_owner[h] = o;
      slot_base[h] = atomicAdd(counts + o, here[h]);
    }
    __syncthreads();
    // the owners join the owner list: one global atomic a block
    if (threadIdx.x == 0) list_base = static_cast<int>(atomicAdd(&scratch->owners, won_here));
    if (threadIdx.x < count) {
      place[i] = h < 0 ? -1ll
                       : (static_cast<long long>(slot_owner[h]) << 32) |
                             static_cast<unsigned>(slot_base[h] + rank);
    }
    __syncthreads();
    if (pos >= 0) owner_list[list_base + pos] = static_cast<int>(i);
  }
  mx = block_max(mx);
  if (threadIdx.x == 0) {
    scratch->partials[blockIdx.x] = mx;
    __threadfence();
    last = atomicAdd(&scratch->done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (last) {  // every block's maximum is in: the scale, and the count reset
    float all = 0.0f;
    for (unsigned j = threadIdx.x; j < gridDim.x; j += kThreads) {
      all = fmaxf(all, __ldcg(scratch->partials + j));
    }
    all = block_max(all);
    if (threadIdx.x == 0) {
      int e;
      frexp(__dmul_rn(static_cast<double>(all), static_cast<double>(m) * d), &e);
      scratch->scale = ldexp(1.0, 61 - e);
      scratch->done = 0;
    }
  }
}

// groups[k] for the owner list's k-th row: (segment start, or the owner
// itself for a row of one occurrence; occurrences; split slot or -1; id);
// extras: (k, chunk) for each chunk past a split row's first;
// starts[owner]: the segment's start. The owner slots and counts go back to
// INT_MAX and 0.
__global__ void __launch_bounds__(kThreads)
allocate_kernel(const long long* __restrict__ ids, int* __restrict__ owner,
                const int* __restrict__ owner_list, int* __restrict__ counts,
                int* __restrict__ starts, int4* __restrict__ groups, int2* __restrict__ extras,
                int chunk, Scratch* __restrict__ scratch) {
  __shared__ int3 bases;                 // the block's first place, split slot, extra
  __shared__ int first_extra[kThreads];  // each thread's row's first entry in the block's extras
  const unsigned n = scratch->owners;
  for (unsigned base = blockIdx.x * kThreads; base < n; base += gridDim.x * kThreads) {
    const unsigned k = base + threadIdx.x;
    int o = 0, id = 0, count = 0;
    if (k < n) {
      o = owner_list[k];
      id = static_cast<int>(ids[o]);
      count = counts[o];
      counts[o] = 0;
      owner[id] = INT_MAX;  // no one reads the slots after the elect pass
    }
    const int chunks = (count + chunk - 1) / chunk;
    int3 total;
    const int3 before =
        block_scan(make_int3(count, chunks > 1, chunks > 1 ? chunks - 1 : 0), &total);
    if (threadIdx.x == 0) {
      bases = make_int3(static_cast<int>(atomicAdd(&scratch->placed, total.x)),
                        static_cast<int>(atomicAdd(&scratch->splits, total.y)),
                        static_cast<int>(atomicAdd(&scratch->extras, total.z)));
    }
    first_extra[threadIdx.x] = before.z;
    __syncthreads();
    if (k < n) {
      const int start = bases.x + before.x;
      starts[o] = start;
      groups[k] = make_int4(count == 1 ? o : start, count, chunks > 1 ? bases.y + before.y : -1,
                            id);
    }
    // the block's extras, written by all its threads: entry e is chunk e -
    // first_extra[t] + 1 of row base + t, t the last with first_extra[t] <= e
    for (int e = threadIdx.x; e < total.z; e += kThreads) {
      int t = 0;
      for (int half = kThreads / 2; half > 0; half /= 2) {
        if (first_extra[t + half] <= e) t += half;
      }
      extras[bases.z + e] = make_int2(static_cast<int>(base) + t, e - first_extra[t] + 1);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
scatter_kernel(const long long* __restrict__ place, const int* __restrict__ starts, unsigned m,
               int* __restrict__ segments) {
  for (unsigned i = blockIdx.x * kThreads + threadIdx.x; i < m; i += gridDim.x * kThreads) {
    const long long p = place[i];
    if (p >= 0) {
      segments[starts[p >> 32] + static_cast<int>(p & 0xffffffffll)] = static_cast<int>(i);
    }
  }
}

// the columns a lane holds in the tile of columns from ``tile``: kCols
// consecutive ones with vector rows, else every ``lanes``-th
template <int kCols, bool kVec>
__device__ __forceinline__ int column(int tile, int lane, int lanes, int t) {
  return kVec ? tile + kCols * lane + t : tile + lane + t * lanes;
}

template <int kCols, bool kVec, typename T>
__device__ __forceinline__ void load_cols(const T* row, int tile, int lane, int lanes, int d,
                                          float (&v)[kCols]) {
  if constexpr (kVec) {
    load4(row + column<kCols, kVec>(tile, lane, lanes, 0), v);
  } else {
#pragma unroll
    for (int t = 0; t < kCols; ++t) {
      const int c = column<kCols, kVec>(tile, lane, lanes, t);
      v[t] = c < d ? load_value(row + c) : 0.0f;
    }
  }
}

template <int kCols, bool kVec, typename T>
__device__ __forceinline__ void store_cols(T* row, int tile, int lane, int lanes, int d,
                                           const float (&v)[kCols]) {
  if constexpr (kVec) {
    store4(row + column<kCols, kVec>(tile, lane, lanes, 0), v);
  } else {
#pragma unroll
    for (int t = 0; t < kCols; ++t) {
      const int c = column<kCols, kVec>(tile, lane, lanes, t);
      if (c < d) store_value(row + c, v[t]);
    }
  }
}

// what every work item of the reduce pass reads, and where its lane group sits
template <typename T>
struct Reduce {
  T* table;
  float* acc;
  const float* rows;
  const int* segments;
  long long* split_sums;
  int* split_done;
  double scale, inv_scale;  // 2^k and 2^-k
  float scale_f;            // 2^k where a float holds it, else 0
  float lr, eps;
  int d, chunk, lanes, g_lane, leader;  // leader: the group's first lane
  unsigned mask;                        // the group's lanes
};

// rint(v * 2^k), half to even, as scatter_totals rounds it. Where 2^k is a
// float, v * 2^k in float is exact (a power of two; below 2^-126 it rounds
// to a number under one half, as the exact product is): one float multiply
// and one conversion, the same integer as in double.
template <bool kFloat, typename T>
__device__ __forceinline__ long long fixed(float v, const Reduce<T>& r) {
  if constexpr (kFloat) return __float2ll_rn(__fmul_rn(v, r.scale_f));
  return __double2ll_rn(__dmul_rn(static_cast<double>(v), r.scale));
}

// Adagrad on a lane's columns of one row, from their fixed-point sums:
// g = float(double(sum) / 2^k), an exact product by 2^-k in double
template <int kCols, bool kVec, typename T>
__device__ __forceinline__ void apply_cols(const Reduce<T>& r, T* t_row, float* a_row,
                                           const long long (&sums)[kCols], float (&a)[kCols],
                                           float (&t)[kCols], int tile) {
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const float g = __double2float_rn(__dmul_rn(__ll2double_rn(sums[j]), r.inv_scale));
    a[j] = __fadd_rn(a[j], __fmul_rn(g, g));
    t[j] = __fsub_rn(t[j], __fdiv_rn(__fmul_rn(r.lr, g), __fadd_rn(__fsqrt_rn(a[j]), r.eps)));
  }
  store_cols<kCols, kVec>(a_row, tile, r.g_lane, r.lanes, r.d, a);
  store_cols<kCols, kVec>(t_row, tile, r.g_lane, r.lanes, r.d, t);
}

// chunk ``c`` of the row ``g`` (segment start or its one occurrence,
// occurrences, split slot or -1, id): sums its occurrences' values in
// fixed point and applies the row, or adds the sums to the row's split
// workspace and applies the row if it is the row's last chunk to finish
template <int kCols, bool kVec, bool kFloat, typename T>
__device__ __forceinline__ void reduce_item(const Reduce<T>& r, int4 g, int c) {
  constexpr int kUnroll = unroll_for(kCols);
  const int d = r.d, lanes = r.lanes, lane = r.g_lane, width = kCols * lanes;
  const int* seg = r.segments + g.x;
  const int first = c * r.chunk, end = min(g.y, first + r.chunk);
  const bool split = g.z >= 0;
  float* a_row = r.acc + static_cast<long long>(g.w) * d;
  T* t_row = r.table + static_cast<long long>(g.w) * d;
  long long* s_row = r.split_sums + static_cast<long long>(split ? g.z : 0) * d;
  for (int tile = 0; tile < d; tile += width) {
    float a[kCols], t[kCols];
    if (!split) {  // load the row's state beside its gradients
      load_cols<kCols, kVec>(a_row, tile, lane, lanes, d, a);
      load_cols<kCols, kVec>(t_row, tile, lane, lanes, d, t);
    }
    long long sums[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) sums[j] = 0;
    for (int p = first; p < end; p += kUnroll) {
      // every index of the round first, then every row: kUnroll loads in flight
      int at[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        at[u] = p + u >= end ? -1 : g.y == 1 ? g.x : __ldg(seg + p + u);
      }
      float v[kUnroll][kCols];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (at[u] >= 0) {
          load_cols<kCols, kVec>(r.rows + static_cast<long long>(at[u]) * d, tile, lane, lanes,
                                 d, v[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (at[u] >= 0) {
#pragma unroll
          for (int j = 0; j < kCols; ++j) sums[j] += fixed<kFloat>(v[u][j], r);
        }
      }
    }
    if (!split) {
      apply_cols<kCols, kVec>(r, t_row, a_row, sums, a, t, tile);
    } else {
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = column<kCols, kVec>(tile, lane, lanes, j);
        if (col < d && sums[j] != 0) {
          atomicAdd(reinterpret_cast<unsigned long long*>(s_row + col),
                    static_cast<unsigned long long>(sums[j]));
        }
      }
    }
  }
  if (!split) return;
  // a split row: the last of its chunks to finish applies it
  __threadfence();
  __syncwarp(r.mask);
  int before = 0;
  if (lane == 0) before = atomicAdd(r.split_done + g.z, 1);
  before = __shfl_sync(r.mask, before, r.leader);
  if (before != (g.y + r.chunk - 1) / r.chunk - 1) return;
  __threadfence();
  for (int tile = 0; tile < d; tile += width) {
    float a[kCols], t[kCols];
    long long sums[kCols];
    load_cols<kCols, kVec>(a_row, tile, lane, lanes, d, a);
    load_cols<kCols, kVec>(t_row, tile, lane, lanes, d, t);
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int col = column<kCols, kVec>(tile, lane, lanes, j);
      sums[j] = col < d ? static_cast<long long>(atomicExch(
                              reinterpret_cast<unsigned long long*>(s_row + col), 0ull))
                        : 0;
    }
    apply_cols<kCols, kVec>(r, t_row, a_row, sums, a, t, tile);
  }
  if (lane == 0) r.split_done[g.z] = 0;
}

template <typename T, int kCols, bool kVec>
__global__ void __launch_bounds__(kThreads)
reduce_apply_kernel(T* __restrict__ table, float* __restrict__ acc,
                    const float* __restrict__ rows, int d, int chunk,
                    const int* __restrict__ segments, const int4* __restrict__ groups,
                    const int2* __restrict__ extras, long long* __restrict__ split_sums,
                    int* __restrict__ split_done, Scratch* __restrict__ scratch, float lr,
                    float eps, unsigned long long* __restrict__ rows_written,
                    unsigned long long* __restrict__ rows_split) {
  __shared__ bool last;
  const unsigned n = scratch->owners, splits = scratch->splits, nx = scratch->extras;
  const double scale = scratch->scale;
  const int lanes = lanes_a_row(d), groups_a_warp = 32 / lanes, lane = threadIdx.x % 32;
  const int g_warp = lane / lanes;
  const Reduce<T> r{table, acc, rows, segments, split_sums, split_done, scale,
                    __drcp_rn(scale), scale <= 0x1p127 ? static_cast<float>(scale) : 0.0f,
                    lr, eps, d, chunk, lanes, lane % lanes, g_warp * lanes,
                    (lanes == 32 ? 0xffffffffu : (1u << lanes) - 1) << (g_warp * lanes)};
  const long long step = static_cast<long long>(gridDim.x) * kThreads / 32 * groups_a_warp;
  const long long items = static_cast<long long>(n) + nx;
  // each group takes every step-th item: the later chunks of split rows
  // first, then each row's first chunk; lanes past whole groups idle
  long long item = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / 32 *
                   groups_a_warp + g_warp;
  if (g_warp >= groups_a_warp) item = items;
  int c = 0;
  int4 g = make_int4(0, 0, -1, 0);
  auto locate = [&](long long i) {  // the item's chunk and row
    int k = static_cast<int>(i - nx);
    c = 0;
    if (i < nx) {
      const int2 e = extras[i];
      k = e.x, c = e.y;
    }
    g = groups[k];
  };
  if (item < items) locate(item);
  while (item < items) {
    const int4 here = g;
    const int here_c = c;
    item += step;
    if (item < items) locate(item);  // the next item's row, loaded while this one is summed
    if (r.scale_f != 0.0f) {
      reduce_item<kCols, kVec, true>(r, here, here_c);
    } else {
      reduce_item<kCols, kVec, false>(r, here, here_c);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(&scratch->reduce_done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (last && threadIdx.x == 0) {  // every block has read the counts: count the rows, reset
    atomicAdd(rows_written, static_cast<unsigned long long>(n));
    atomicAdd(rows_split, static_cast<unsigned long long>(splits));
    scratch->owners = 0;
    scratch->placed = 0;
    scratch->splits = 0;
    scratch->extras = 0;
    scratch->reduce_done = 0;
  }
}

int blocks_for(unsigned long long work, long long cap) {
  const unsigned long long b = (work + kThreads - 1) / kThreads;
  return static_cast<int>(b < 1 ? 1 : (b > static_cast<unsigned long long>(cap) ? cap : b));
}

bool aligned(const void* p, unsigned long long bytes) {
  return reinterpret_cast<unsigned long long>(p) % bytes == 0;
}

long long align16(long long bytes) { return (bytes + 15) / 16 * 16; }

// the lists of a call of m occurrences, carved in this order from one buffer
struct Lists {
  int* owner_list;     // [m]
  int* starts;         // [m], by owner
  long long* place;    // [m]
  int* segments;       // [m]
  int4* groups;        // [m]
  int2* extras;        // [m / C + 1]
};

Lists carve(void* base, long long m) {
  char* p = static_cast<char*>(base);
  Lists l;
  l.owner_list = reinterpret_cast<int*>(p);
  p += align16(4 * m);
  l.starts = reinterpret_cast<int*>(p);
  p += align16(4 * m);
  l.place = reinterpret_cast<long long*>(p);
  p += align16(8 * m);
  l.segments = reinterpret_cast<int*>(p);
  p += align16(4 * m);
  l.groups = reinterpret_cast<int4*>(p);
  p += align16(16 * m);
  l.extras = reinterpret_cast<int2*>(p);
  return l;
}

// the lane groups of the current device when every SM holds all the threads
// it can, at width d
int card_groups(int d, int* groups) {
  int device = 0, sms = 0, threads = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&threads, cudaDevAttrMaxThreadsPerMultiProcessor, device);
  }
  *groups = sms * (threads / 32) * (32 / lanes_a_row(d));
  return static_cast<int>(err);
}

// C: a chunk of about 1 / kChunkShare of the occurrences that each lane
// group of a full card would take if m were dealt out evenly, whole rounds
// of loads; a row of more than C occurrences is cut into chunks of C
long long chunk_for(long long m, int d, int groups) {
  const int unroll = unroll_for(d < 32 ? 1 : 4);
  const long long c = m / (static_cast<long long>(kChunkShare) * groups) / unroll * unroll;
  return c > unroll ? c : unroll;
}

template <typename T, int kCols>
cudaError_t launch_reduce(T* table, float* acc, const float* rows, int d, unsigned m, int chunk,
                          const Lists& l, long long* split_sums, int* split_done,
                          Scratch* scratch, float lr, float eps,
                          unsigned long long* rows_written, unsigned long long* rows_split,
                          int max_blocks, cudaStream_t s) {
  // whole tiles of 128 columns at 16-byte (f32) or 8-byte (bf16) boundaries
  // load and store 4 columns a lane as one vector
  const bool vec = kCols == 4 && d % 128 == 0 && aligned(rows, 16) && aligned(acc, 16) &&
                   aligned(table, 4 * sizeof(T));
  auto kernel = vec ? reduce_apply_kernel<T, kCols, kCols == 4>
                    : reduce_apply_kernel<T, kCols, false>;
  // a resident grid: each group takes every step-th work item
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  }
  if (err != cudaSuccess) return err;
  const int rows_a_warp = 32 / lanes_a_row(d);
  const unsigned long long items = m + m / chunk;
  const int blocks = blocks_for(32ull * ((items + rows_a_warp - 1) / rows_a_warp),
                                per_sm * sms < max_blocks ? per_sm * sms : max_blocks);
  kernel<<<blocks, kThreads, 0, s>>>(table, acc, rows, d, chunk, l.segments, l.groups, l.extras,
                                     split_sums, split_done, scratch, lr, eps, rows_written,
                                     rows_split);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_reduce(T* table, float* acc, const float* rows, int d, unsigned m, int chunk,
                          const Lists& l, long long* split_sums, int* split_done,
                          Scratch* scratch, float lr, float eps,
                          unsigned long long* rows_written, unsigned long long* rows_split,
                          int max_blocks, cudaStream_t s) {
  return d < 32 ? launch_reduce<T, 1>(table, acc, rows, d, m, chunk, l, split_sums, split_done,
                                      scratch, lr, eps, rows_written, rows_split, max_blocks, s)
                : launch_reduce<T, 4>(table, acc, rows, d, m, chunk, l, split_sums, split_done,
                                      scratch, lr, eps, rows_written, rows_split, max_blocks, s);
}

}  // namespace

// Bytes of the scratch for ``max_blocks`` elect blocks: the wrapper's zeroed
// buffer must hold at least this many.
extern "C" long long sparse_adagrad_scratch_bytes(int max_blocks) {
  return static_cast<long long>(sizeof(Scratch)) + 4ll * max_blocks;
}

// C, the occurrences of a chunk in a call of ``m`` occurrences of width
// ``d`` on the current device (-1 on a CUDA error): a row of more than C
// occurrences is split, so the call needs split rows for at most m / (C + 1)
// rows.
extern "C" long long sparse_adagrad_chunk(long long m, int d) {
  int groups = 0;
  if (card_groups(d, &groups) != 0) return -1;
  return chunk_for(m, d, groups);
}

// Bytes of the lists buffer for a call of ``m`` occurrences in chunks of
// ``chunk``.
extern "C" long long sparse_adagrad_list_bytes(long long m, long long chunk) {
  return 2 * align16(4 * m) + align16(8 * m) + align16(4 * m) + align16(16 * m) +
         8 * (m / chunk + 1);
}

// table: f32 or bf16 [V, D] (table_bf16 says which); acc f32 [V, D]; ids
// int64 [M]; rows f32 [M, D]; chunk sparse_adagrad_chunk(M, D); owner int32
// [V], INT_MAX in every slot; counts int32 [M] or more, zeros; lists of
// sparse_adagrad_list_bytes(M, chunk); split_sums int64 [M / (chunk + 1),
// D] or more, zeros; split_done int32 [M / (chunk + 1)] or more, zeros;
// scratch of
// sparse_adagrad_scratch_bytes(max_blocks), zeros at first; rows_written and
// rows_split uint64 [1]. The wrapper checks shapes and M * D < 2^31. Owner,
// counts, split_sums, split_done and scratch's counts are left as found.
extern "C" int sparse_adagrad_dense(void* table, int table_bf16, void* acc, const void* ids,
                                    const void* rows, long long num_rows, int d, int m,
                                    int chunk, float lr, float eps, void* owner, void* counts,
                                    void* lists, void* split_sums, void* split_done,
                                    void* scratch, int max_blocks, void* rows_written,
                                    void* rows_split, void* stream) {
  if (m <= 0 || d <= 0) return static_cast<int>(cudaSuccess);
  if (chunk < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto um = static_cast<unsigned>(m);
  const auto* id_p = static_cast<const long long*>(ids);
  const auto* row_p = static_cast<const float*>(rows);
  auto* owner_p = static_cast<int*>(owner);
  auto* counts_p = static_cast<int*>(counts);
  auto* scratch_p = static_cast<Scratch*>(scratch);
  const Lists l = carve(lists, m);
  const int blocks = blocks_for(um, max_blocks);
  elect_kernel<<<blocks, kThreads, 0, s>>>(id_p, row_p, num_rows, d, um, owner_p, l.owner_list,
                                           counts_p, l.place, scratch_p);
  allocate_kernel<<<blocks, kThreads, 0, s>>>(id_p, owner_p, l.owner_list, counts_p, l.starts,
                                              l.groups, l.extras, chunk, scratch_p);
  scatter_kernel<<<blocks, kThreads, 0, s>>>(l.place, l.starts, um, l.segments);
  auto* sums_p = static_cast<long long*>(split_sums);
  auto* done_p = static_cast<int*>(split_done);
  auto* acc_p = static_cast<float*>(acc);
  auto* written_p = static_cast<unsigned long long*>(rows_written);
  auto* split_p = static_cast<unsigned long long*>(rows_split);
  cudaError_t err =
      table_bf16 ? launch_reduce(static_cast<__nv_bfloat16*>(table), acc_p, row_p, d, um, chunk,
                                 l, sums_p, done_p, scratch_p, lr, eps, written_p, split_p,
                                 max_blocks, s)
                 : launch_reduce(static_cast<float*>(table), acc_p, row_p, d, um, chunk, l,
                                 sums_p, done_p, scratch_p, lr, eps, written_p, split_p,
                                 max_blocks, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
