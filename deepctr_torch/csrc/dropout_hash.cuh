// The fused tower's dropout mask, shared by the forward and backward kernels.
//
// Port of deepctr_tpu/ops/pallas/mlp.py::_dropout_mask: a stateless counter
// hash of (global batch row, unpadded column, seed, layer), murmur3's fmix32
// over one uint32 sum. An element is kept when the hash is below
// threshold = int(keep * 0xFFFFFFFF), computed once on the host in double as
// the reference does; a kept value is multiplied by scale, the f32 quotient
// 1.0f / (float)keep, and a dropped one by 0. Both kernels draw the same
// mask by construction, whatever their tiling.
//
// The seed comes with the launch, or from device memory (seed_ptr): a CUDA
// graph bakes a launch's arguments into every replay, so a graph of train
// steps reads each step's seed from a buffer that the host refills before
// each replay. The two give the same mask for the same value.

#pragma once

#include <cstdint>

namespace tower {

struct Dropout {
  int on;              // 0: no dropout (eval, scoring)
  uint32_t seed;       // below 2^24, as the reference's f32 carrier allows
  uint32_t threshold;  // keep when hash < threshold
  float scale;         // multiplier of a kept value
  uint32_t row0;       // global row of the batch's first row
  const uint32_t* seed_ptr;  // where not null, the seed is read from here
};

// `d` with the seed in effect: the one in device memory where the launch
// names it, else its own. Called once per thread before the first use; the
// branch is on a launch argument, uniform across the block.
__device__ __forceinline__ Dropout resolve_seed(Dropout d) {
  if (d.seed_ptr != nullptr) d.seed = __ldg(d.seed_ptr);
  return d;
}

__device__ __forceinline__ uint32_t dropout_hash(uint32_t row, uint32_t col,
                                                 uint32_t seed,
                                                 uint32_t layer) {
  uint32_t h = row * 0x9E3779B9u + col * 0x85EBCA6Bu + seed * 0xC2B2AE35u +
               (layer + 1u) * 0x27D4EB2Fu;
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return h;
}

// What element (row, col) of hidden layer `layer` is multiplied by.
__device__ __forceinline__ float dropout_factor(const Dropout& d, uint32_t row,
                                                uint32_t col, uint32_t layer) {
  return dropout_hash(d.row0 + row, col, d.seed, layer) < d.threshold
             ? d.scale
             : 0.0f;
}

}  // namespace tower
