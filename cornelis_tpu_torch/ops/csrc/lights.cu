// The dynamic-scene kernel's NEE light table, built on the device.
//
// Replaces the table construction inside
// cornelis_tpu/ops/pallas_dynamic.py::_make_kernel_dyn (_light_rows_dyn and
// _clamp_base_dyn, traced into the kernel launched at pallas_dynamic.py:485):
// every sphere and every plane becomes a row of the layout in
// ops/lights.py, zero-power rows kept, emission picked by a masked sum over
// the materials, power = luminance x 4 pi r^2 (math.pi) or x w h,
// probabilities normalised by 1 / max(total, 1e-30); and the NEE clamp
// base 16 x max(max emission channel, 1). All in float32, in the JAX
// order of operations, so the sums and the cumulative column match the
// plain version (ops/lights.py::light_table_dyn_reference) bit for bit:
// every product and sum is an explicit round-to-nearest intrinsic, which
// nvcc never contracts into an FMA.
//
// What bounds it: nothing on the card's scale. The table has one row per
// primitive (tens to hundreds), and the float32 sums are sequential. So
// one thread builds it, in one launch, before the render kernel on the same
// stream: the render reads the buffer with no host round trip, and a scene
// edit (a new emission, a moved sphere) costs one tiny launch and no
// rebuild.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int LIGHT_COLS = 18;
constexpr float FOUR_PI = (float)(4.0 * 3.141592653589793);  // math.pi
constexpr float NEE_CLAMP_FACTOR = 16.0f;

// jnp.maximum propagates NaN; fmaxf drops it.
__device__ __forceinline__ float jmax(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

__device__ __forceinline__ float luminance(const float* le) {
  return add(add(mul((float)0.2126, le[0]), mul((float)0.7152, le[1])), mul((float)0.0722, le[2]));
}

// _light_rows_dyn's emission_of: sum over m of (mid == m) * emission[m].
__device__ void emission_of(const float* __restrict__ materials, int n_materials, float mid,
                            float* le) {
  le[0] = le[1] = le[2] = 0.0f;
  for (int m = 0; m < n_materials; ++m) {
    const float mf = (mid == (float)m) ? 1.0f : 0.0f;
    for (int c = 0; c < 3; ++c) le[c] = add(le[c], mul(mf, materials[11 * m + 3 + c]));
  }
}

__global__ void light_table_dyn(const float* __restrict__ spheres, int n_spheres,
                                const float* __restrict__ planes, int n_planes,
                                const float* __restrict__ materials, int n_materials,
                                float* __restrict__ rows, float* __restrict__ clamp) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  // Pass 1: each row but its probabilities, and the total power.
  float total = 0.0f;
  for (int i = 0; i < n_spheres; ++i) {
    const float* sp = spheres + 5 * i;
    float* row = rows + LIGHT_COLS * i;
    float* le = row + 12;
    emission_of(materials, n_materials, sp[4], le);
    const float rad = sp[3];
    const float power = mul(mul(mul(luminance(le), FOUR_PI), rad), rad);
    row[0] = power;
    row[2] = 0.0f;
    row[3] = (float)i;
    for (int c = 0; c < 4; ++c) row[4 + c] = sp[c];
    for (int c = 4; c < 8; ++c) row[4 + c] = 0.0f;
    const float r2 = mul(rad, rad);
    row[15] = r2;
    row[16] = mul(r2, (float)1.0002);
    row[17] = 0.0f;
    total = add(total, power);
  }
  for (int j = 0; j < n_planes; ++j) {
    const float* pl = planes + 9 * j;
    float* row = rows + LIGHT_COLS * (n_spheres + j);
    float* le = row + 12;
    emission_of(materials, n_materials, pl[8], le);
    const float power = mul(mul(luminance(le), pl[6]), pl[7]);
    row[0] = power;
    row[2] = 1.0f;
    row[3] = (float)(n_spheres + j);
    for (int c = 0; c < 8; ++c) row[4 + c] = pl[c];
    row[15] = 0.0f;
    row[16] = 0.0f;
    row[17] = jmax(mul(pl[6], pl[7]), (float)1e-12);
    total = add(total, power);
  }
  // Pass 2: prob = power / total and the running cumulative sum.
  const float inv_total = 1.0f / jmax(total, (float)1e-30);
  float cum = 0.0f;
  for (int r = 0; r < n_spheres + n_planes; ++r) {
    float* row = rows + LIGHT_COLS * r;
    const float prob = mul(row[0], inv_total);
    cum = add(cum, prob);
    row[0] = prob;
    row[1] = cum;
  }
  float max_e = 0.0f;
  for (int m = 0; m < n_materials; ++m)
    for (int c = 0; c < 3; ++c) max_e = jmax(max_e, materials[11 * m + 3 + c]);
  clamp[0] = mul(NEE_CLAMP_FACTOR, jmax(max_e, 1.0f));
}

}  // namespace

// Launches the one-thread table kernel on `stream` and returns cudaGetLastError().
// rows holds (n_spheres + n_planes) x 18 floats; clamp one float.
extern "C" int cornelis_light_table_dyn(const float* spheres, int n_spheres, const float* planes,
                                        int n_planes, const float* materials, int n_materials,
                                        float* rows, float* clamp, void* stream) {
  light_table_dyn<<<1, 1, 0, (cudaStream_t)stream>>>(spheres, n_spheres, planes, n_planes,
                                                     materials, n_materials, rows, clamp);
  return (int)cudaGetLastError();
}
