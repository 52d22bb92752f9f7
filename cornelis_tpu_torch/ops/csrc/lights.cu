// The dynamic-scene kernel's NEE light table, built on the device by one
// block: light_table_dyn (ops/lights.py) returns the table itself, held
// against its plain version. The dynamic-scene render does not launch it:
// its megakernel launch builds the same table in every block's prologue
// (megakernel.cu), with the same device code (light_table.cuh, where the
// replaced TPU code, the bound and the design are set out).

#include <cuda_runtime.h>

#include "light_table.cuh"

namespace {

constexpr int TABLE_BLOCK = 128;

__global__ void __launch_bounds__(TABLE_BLOCK)
light_table_dyn(const light_table::Rows scene, float* __restrict__ rows, float* __restrict__ clamp) {
  light_table::build(scene, rows, clamp, threadIdx.x, TABLE_BLOCK);
}

}  // namespace

// Launches the one-block table kernel on `stream` and returns
// cudaGetLastError(). rows holds (n_spheres + n_planes) x 18 floats; clamp
// one float.
extern "C" int cornelis_light_table_dyn(const float* spheres, int n_spheres, const float* planes,
                                        int n_planes, const float* materials, int n_materials,
                                        float* rows, float* clamp, void* stream) {
  const light_table::Rows scene{spheres, n_spheres, planes, n_planes, materials, n_materials};
  light_table_dyn<<<1, TABLE_BLOCK, 0, (cudaStream_t)stream>>>(scene, rows, clamp);
  return (int)cudaGetLastError();
}
