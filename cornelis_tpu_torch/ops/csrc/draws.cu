// The wavefront's Threefry draws for Hopper (sm_90a): one launch a call.
//
// Replaces no TPU kernel. On the TPU the JAX wavefront's draws
// (cornelis_tpu/rng.py: jax.random's fold_in, bits and uniform under the
// partitionable Threefry) were fused by XLA into the surrounding program.
// The port's plain torch version (rng.py, ops/threefry.py) holds each
// uint32 word in an int64 tensor and masks it after every add and shift:
// about 350 elementwise launches a call, each a pass over (N, num) int64
// words. Two entries, both on the caller's stream:
//
//   cornelis_stream_uniforms: rng.stream_uniforms with the uniform sampler.
//     Ray i's key (k0, k1) is folded with the stream, (f0, f1) =
//     threefry2x32(k, (0, stream)), then word j is b0 ^ b1 of
//     threefry2x32(f, (0, j)) (jax's bits: the 64-bit iota's high word is
//     0), mapped to a float by jax's mantissa fill, (w >> 9) | 0x3F800000
//     read as a float32, minus 1 (exact: the float lies in [1, 2)).
//   cornelis_ray_streams: rng.make_ray_streams. Ray i's key is
//     fold_in(fold_in(root, pixel), sample); its Sobol seed is
//     hash32(pixel ^ hash32(root_word)), with root_word = b0 ^ b1 of
//     threefry2x32(fold_in(root, 0x50B0), (0, 0)). The root's words are
//     read on the device, so the caller never waits for them.
//
// Words are uint32 values held in int64 (the torch version's layout): the
// kernels read the low word of each and write zero-extended words.
//
// What bounds it: integer issue and memory, about evenly. A Threefry block
// is about 80 32-bit operations (20 rounds of add, rotate and xor, five key
// injections); a ray of stream_uniforms spends 1 + num blocks on 16 bytes of
// key and 4 * num bytes of output. The design: one thread a ray, everything
// in registers, no shared memory and no barrier, and the num words of a ray
// written by a loop of 4-byte stores (num a runtime argument: one
// instantiation serves the wavefront's 2, 4 and 8 and any other num). At
// 2,097,152 rays on an H100 (SXM, 700 W) a call takes 27, 48 and 175 us at
// num 2, 4 and 8, against about 12 ms for the torch version at num 4; at
// num 8 the output, 67 MB, outgrows the 50 MB L2, whose sectors the
// strided stores then leave partly written.

#include <cuda_runtime.h>

#include <cstdint>

#include "threefry.cuh"

namespace {

constexpr int BLOCK = 256;
constexpr uint32_t ONE_BITS = 0x3F800000u;
constexpr uint32_t SOBOL_ROOT = 0x50B0u;

__device__ __forceinline__ float word_to_uniform(uint32_t w) {
  return __uint_as_float((w >> 9) | ONE_BITS) - 1.0f;
}

__global__ void __launch_bounds__(BLOCK)
    stream_uniforms(const long long* __restrict__ keys, long long n, uint32_t stream, int num,
                    float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  const uint32_t k0 = (uint32_t)__ldg(keys + 2 * i), k1 = (uint32_t)__ldg(keys + 2 * i + 1);
  uint32_t f0, f1;
  tf::threefry2x32(k0, k1, 0u, stream, f0, f1);
  float* row = out + i * num;
  for (int j = 0; j < num; ++j) {
    uint32_t b0, b1;
    tf::threefry2x32(f0, f1, 0u, (uint32_t)j, b0, b1);
    row[j] = word_to_uniform(b0 ^ b1);
  }
}

__global__ void __launch_bounds__(BLOCK)
    ray_streams(const long long* __restrict__ root, const long long* __restrict__ pixel,
                const long long* __restrict__ sample, long long n, long long* __restrict__ keys,
                long long* __restrict__ pixel_seed) {
  const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  const uint32_t r0 = (uint32_t)__ldg(root), r1 = (uint32_t)__ldg(root + 1);
  const uint32_t px = (uint32_t)__ldg(pixel + i), si = (uint32_t)__ldg(sample + i);
  uint32_t a0, a1, k0, k1;
  tf::threefry2x32(r0, r1, 0u, px, a0, a1);
  tf::threefry2x32(a0, a1, 0u, si, k0, k1);
  reinterpret_cast<longlong2*>(keys)[i] = make_longlong2((long long)k0, (long long)k1);
  // The root word, the same in every thread, computed by each: two blocks
  // a ray in place of a barrier.
  uint32_t f0, f1, b0, b1;
  tf::threefry2x32(r0, r1, 0u, SOBOL_ROOT, f0, f1);
  tf::threefry2x32(f0, f1, 0u, 0u, b0, b1);
  pixel_seed[i] = (long long)tf::hash32(px ^ tf::hash32(b0 ^ b1));
}

unsigned blocks_for(long long n) { return (unsigned)((n + BLOCK - 1) / BLOCK); }

}  // namespace

// out (n, num) float32 from keys (n, 2) int64, on `cuda_stream`; returns
// cudaGetLastError(). n > 0, num > 0.
extern "C" int cornelis_stream_uniforms(const long long* keys, long long n, unsigned stream,
                                        int num, float* out, void* cuda_stream) {
  stream_uniforms<<<blocks_for(n), BLOCK, 0, (cudaStream_t)cuda_stream>>>(keys, n, stream, num,
                                                                          out);
  return (int)cudaGetLastError();
}

// keys (n, 2) and pixel_seed (n,) int64 from root (2,), pixel (n,) and
// sample (n,) int64, on `cuda_stream`; returns cudaGetLastError(). n > 0;
// keys 16-byte aligned.
extern "C" int cornelis_ray_streams(const long long* root, const long long* pixel,
                                    const long long* sample, long long n, long long* keys,
                                    long long* pixel_seed, void* cuda_stream) {
  ray_streams<<<blocks_for(n), BLOCK, 0, (cudaStream_t)cuda_stream>>>(root, pixel, sample, n, keys,
                                                                      pixel_seed);
  return (int)cudaGetLastError();
}
