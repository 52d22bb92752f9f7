// Threefry-2x32 (20 rounds) and the hash of the Sobol seeds, in uint32_t.
//
// The cipher of ops/threefry.py and the hash32 of sampling.py, bit for bit:
// the same rounds, key schedule and avalanche as megakernel.cu's copies,
// kept apart so that the draws library (draws.cu) builds without touching
// the megakernels' sources.

#pragma once

#include <cstdint>

namespace tf {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t c0, uint32_t c1,
                                             uint32_t& out0, uint32_t& out1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[8] = {13, 15, 26, 6, 17, 29, 16, 24};
  uint32_t x0 = c0 + ks[0];
  uint32_t x1 = c1 + ks[1];
#pragma unroll
  for (int block = 0; block < 5; ++block) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x0 += x1;
      x1 = rotl(x1, rot[(block % 2) * 4 + i]) ^ x0;
    }
    x0 += ks[(block + 1) % 3];
    x1 += ks[(block + 2) % 3] + (uint32_t)(block + 1);
  }
  out0 = x0;
  out1 = x1;
}

// sampling.py::hash32: xmur3-style avalanche.
__device__ __forceinline__ uint32_t hash32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  return x ^ (x >> 16);
}

}  // namespace tf
