// The dynamic-scene kernel's NEE light table and clamp base, built by the
// threads of one block. Included by lights.cu (the table alone, one block)
// and by megakernel.cu (the dynamic nee launch builds it in every block's
// prologue, from the tables that block has just staged, as the TPU kernel
// built it at the top of every grid step).
//
// Replaces the table construction inside
// cornelis_tpu/ops/pallas_dynamic.py::_make_kernel_dyn (_light_rows_dyn
// :117-159 and _clamp_base_dyn :162-171, traced into the kernel launched
// at pallas_dynamic.py:485): every sphere and every plane becomes a row of
// the layout in ops/lights.py, zero-power rows kept, emission picked by a
// masked sum over the materials, power = luminance x 4 pi r^2 (math.pi) or
// x w h, probabilities normalised by 1 / max(total, 1e-30); and the NEE
// clamp base 16 x max(max emission channel, 1). All in float32 and in the
// JAX order of operations, so every column matches the plain version
// (ops/lights.py::light_table_dyn_reference) bit for bit: each product
// and sum is an explicit round-to-nearest intrinsic, which nvcc never
// contracts into an FMA, whatever -fmad says.
//
// What bounds it: the float32 sums. total, then each prob and the
// cumulative column, are add chains in row order; a parallel scan would
// move the cumulative column's bits, so one thread runs them, its loads
// issued AHEAD rows at a time so that only the adds wait on each other.
// Everything else runs over the block's threads: each row's emission (the
// masked sum over the materials, read from the tables the block has
// staged), luminance, power, geometry and pick columns; the clamp's
// maximum runs on a second warp beside the sums.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace light_table {

constexpr int COLS = 18;  // ops/lights.py's row layout
constexpr int SPHERE_COLS = 5, PLANE_COLS = 9, MATERIAL_COLS = 11;
constexpr float FOUR_PI = (float)(4.0 * 3.141592653589793);  // math.pi
constexpr float CLAMP_FACTOR = 16.0f;
// Rows whose power (then prob) the sums' thread loads before it adds.
constexpr int AHEAD = 8;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

// jnp.maximum propagates NaN; fmaxf drops it.
__device__ __forceinline__ float jmax(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}

// The scene as compile.py lays its tables out in device memory. The
// megakernel passes a reader of the same interface over the tables it has
// staged in shared memory.
struct Rows {
  const float* spheres;
  int n_spheres;
  const float* planes;
  int n_planes;
  const float* materials;
  int n_materials;

  // (cx, cy, cz, r) of sphere i, and its material id.
  __device__ __forceinline__ float4 sphere(int i) const {
    const float* r = spheres + SPHERE_COLS * i;
    return make_float4(__ldg(r), __ldg(r + 1), __ldg(r + 2), __ldg(r + 3));
  }
  __device__ __forceinline__ float sphere_material(int i) const {
    return __ldg(spheres + SPHERE_COLS * i + 4);
  }
  // (nx, ny, nz, px, py, pz, w, h) of plane j, and its material id.
  __device__ __forceinline__ void plane(int j, float g[8]) const {
    for (int c = 0; c < 8; ++c) g[c] = __ldg(planes + PLANE_COLS * j + c);
  }
  __device__ __forceinline__ float plane_material(int j) const {
    return __ldg(planes + PLANE_COLS * j + 8);
  }
  __device__ __forceinline__ float emission(int m, int c) const {
    return __ldg(materials + MATERIAL_COLS * m + 3 + c);
  }
};

// _light_rows_dyn's emission_of: sum over m of (mid == m) * emission[m],
// in material order.
template <class Scene>
__device__ __forceinline__ void emission_of(const Scene& s, float mid, float le[3]) {
  le[0] = le[1] = le[2] = 0.0f;
  for (int m = 0; m < s.n_materials; ++m) {
    const float mf = (mid == (float)m) ? 1.0f : 0.0f;
    for (int c = 0; c < 3; ++c) le[c] = add(le[c], mul(mf, s.emission(m, c)));
  }
}

__device__ __forceinline__ float luminance(const float* le) {
  return add(add(mul((float)0.2126, le[0]), mul((float)0.7152, le[1])), mul((float)0.0722, le[2]));
}

// Row r of the table but its prob and cum: its power in column 0.
template <class Scene>
__device__ __forceinline__ void row_of(const Scene& s, int r, float* row) {
  float* le = row + 12;
  if (r < s.n_spheres) {
    const float4 sp = s.sphere(r);
    emission_of(s, s.sphere_material(r), le);
    row[0] = mul(mul(mul(luminance(le), FOUR_PI), sp.w), sp.w);
    row[2] = 0.0f;
    row[3] = (float)r;
    row[4] = sp.x;
    row[5] = sp.y;
    row[6] = sp.z;
    row[7] = sp.w;
    for (int c = 8; c < 12; ++c) row[c] = 0.0f;
    const float r2 = mul(sp.w, sp.w);
    row[15] = r2;
    row[16] = mul(r2, (float)1.0002);
    row[17] = 0.0f;
  } else {
    const int j = r - s.n_spheres;
    float g[8];
    s.plane(j, g);
    emission_of(s, s.plane_material(j), le);
    row[0] = mul(mul(luminance(le), g[6]), g[7]);
    row[2] = 1.0f;
    row[3] = (float)r;
    for (int c = 0; c < 8; ++c) row[4 + c] = g[c];
    row[15] = 0.0f;
    row[16] = 0.0f;
    row[17] = jmax(mul(g[6], g[7]), (float)1e-12);
  }
}

// total, then each row's prob = power / total and the running cum, in row
// order (one thread).
__device__ __forceinline__ void normalise(float* rows, int n) {
  float total = 0.0f;
  for (int r0 = 0; r0 < n; r0 += AHEAD) {
    float p[AHEAD];
#pragma unroll
    for (int k = 0; k < AHEAD; ++k) p[k] = r0 + k < n ? rows[COLS * (r0 + k)] : 0.0f;
#pragma unroll
    for (int k = 0; k < AHEAD; ++k)
      if (r0 + k < n) total = add(total, p[k]);
  }
  const float inv_total = __fdiv_rn(1.0f, jmax(total, (float)1e-30));
  float cum = 0.0f;
  for (int r0 = 0; r0 < n; r0 += AHEAD) {
    float p[AHEAD];
#pragma unroll
    for (int k = 0; k < AHEAD; ++k) p[k] = r0 + k < n ? rows[COLS * (r0 + k)] : 0.0f;
#pragma unroll
    for (int k = 0; k < AHEAD; ++k) {
      if (r0 + k < n) {
        const float prob = mul(p[k], inv_total);
        cum = add(cum, prob);
        rows[COLS * (r0 + k)] = prob;
        rows[COLS * (r0 + k) + 1] = cum;
      }
    }
  }
}

// 16 x max(every emission channel, 1), each maximum in material order as
// _clamp_base_dyn takes it (one thread).
template <class Scene>
__device__ __forceinline__ float clamp_base(const Scene& s) {
  float max_e = 0.0f;
  for (int m = 0; m < s.n_materials; ++m)
    for (int c = 0; c < 3; ++c) max_e = jmax(max_e, s.emission(m, c));
  return mul(CLAMP_FACTOR, jmax(max_e, 1.0f));
}

// Writes the (n_spheres + n_planes, COLS) table to `rows` and the clamp
// base to `*clamp`, thread `tid` of the block's `threads` (every thread of
// the block calls it: it holds a block barrier). A scene the block itself
// wrote needs a barrier before the call; the writes are the block's to
// read after its next barrier.
template <class Scene>
__device__ __forceinline__ void build(const Scene& s, float* rows, float* clamp, int tid,
                                      int threads) {
  const int n = s.n_spheres + s.n_planes;
  for (int r = tid; r < n; r += threads) row_of(s, r, rows + COLS * r);
  __syncthreads();
  if (tid == 0) normalise(rows, n);
  if (tid == (threads > 32 ? 32 : 0)) *clamp = clamp_base(s);
}

}  // namespace light_table
