// Path-tracing megakernel for Hopper (sm_90a): the whole path of one ray
// per thread, from the camera jitter to the last bounce.
//
// Replaces cornelis_tpu/ops/pallas_integrator.py::_make_kernel (launched
// there by _build_renderer through pl.pallas_call) on spheres, planes and
// SDF primitives, in modes "path" and "nee" with samplers "uniform" and
// "sobol", and the bounce loop of
// cornelis_tpu/ops/pallas_dynamic.py::_make_kernel_dyn, which differs only
// in its light table (ops/lights.py builds both). Mode, sampler and SDF
// support are template parameters; the SDF instantiations are launched only
// for tables with SDF rows, so the sphere-and-plane ones compile as before.
// This file instantiates mode "path" (entry point cornelis_megakernel);
// megakernel_nee.cu includes it with CORNELIS_MEGAKERNEL_NEE defined and
// instantiates mode "nee" (cornelis_megakernel_nee), compiled without FMA
// contraction (ops/build.py). Why: in the reference scenes a camera ray
// meets a sphere about 1000 units away, and the quadratic's cancellation
// leaves the hit point up to ~1e-3 off the surface, more than the min_hit_t
// guard. A point left inside its sphere shadows its own light sample, so
// NEE flips a shadow ray wherever two versions round a hit point
// differently: with contraction, a few % of rays against the plain torch
// version. Path mode has no shadow ray and keeps the contracted code.
//
// It computes what those kernels compute, draw for draw: Threefry-2x32
// uniforms keyed by (pixel, sample, stream, pair), or Owen-scrambled Sobol
// pairs keyed by (pixel seed, sample, stream, pair); camera jitter and
// generate_rays; then up to max_depth bounces of closest hit (two-phase
// sphere scan, then finite planes, under the min_hit_t guard), emission,
// layered BSDF sampling, Russian roulette and the throughput update. Mode
// "nee" adds, per bounce, the MIS weight and depth-aware clamp of emission
// found by BSDF sampling, a light chosen by the table's cumulative
// probability, a sphere-cone or plane-area sample, a shadow ray, and the
// MIS-weighted light contribution; it divides by the sampler's true
// density. Every float expression keeps the JAX package's order of
// operations; nvcc's default FMA contraction is the one known difference.
//
// What bounds it on this card: FP32 issue rate and warp divergence, not
// bytes. A ray reads no input (its pixel and sample come from its thread
// index), writes 12 B of radiance, and spends thousands of FP32 and
// special-function instructions per bounce; the scene and light tables (a
// few hundred bytes) stay in L1/L2. Paths die at different depths under
// Russian roulette and take different BSDF branches, so lanes of a warp
// idle while the longest path in the warp runs. NEE adds a shadow ray per
// bounce and a second branch (sphere or plane light).
//
// What the design does about it: one thread per path with a per-thread
// exit (the TPU exited per block of 2048 rays), only the chosen BSDF lobe
// and the chosen light's branch evaluated (the TPU evaluated both and
// selected; the functions are pure, so this is the same), the shadow ray
// traced only where its contribution can be non-zero, no precomputed pixel
// or sample arrays (the TPU needed them because its gathers were slow),
// and consecutive threads on the samples of one pixel, so a warp starts
// coherent. Path regeneration, table placement and a BVH are later work.
//
// SDFs (K1's _intersect_const:495-502 and _occluded_const:530-534, which
// call geometry.py::sdf_candidate): every SDF is sphere-traced for up to
// SPHERE_TRACE_STEPS steps after the planes, in the closest-hit scan and in
// the shadow ray. FP32 issue bounds it: a step costs about 50 operations
// (point on the ray, rotation into the object frame, the kind's distance,
// the convergence test), so a ray that grazes an object and marches all
// 128 steps costs more than the rest of its bounce. The design: each thread
// leaves its own march when it converges or escapes (the TPU froze done
// lanes and ran all 128 steps), the kind is uniform across a warp (every
// thread scans the same SDF), so the distance is a switch and not all three
// formulas, the primitive's 17 floats are loaded once per scan, and the
// normal (four more distance evaluations) is taken only for a hit that is
// closer than the best so far. The SDF arithmetic rounds every operation
// on its own (__fmul_rn, __fadd_rn, __fsqrt_rn, __fdiv_rn), whatever -fmad
// says: the tetrahedron normal differences distances about 1e-4 apart, so
// it amplifies a contracted ulp of the march by about 1e3.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// Constants are rounded from double exactly as JAX rounds a Python float
// against a float32 array.
constexpr double PI_D = 3.14159265359;  // cornelis::Pi, not M_PI
constexpr float TWO_PI = (float)(2.0 * PI_D);
constexpr float PI_F = (float)PI_D;
constexpr float HEMISPHERE_PDF = (float)(1.0 / (2.0 * PI_D));
constexpr float RAY_EPSILON = (float)5e-5;
constexpr float RAY_EPSILON2 = (float)(5e-5 * 5e-5);
constexpr float T_MIN_SCALE = (float)4e-6;
constexpr float BOUNCE_EPSILON = (float)1e-4;
constexpr float RR_BASE = (float)0.55;
constexpr float RR_YOUNG_SURVIVAL = (float)0.99;
constexpr int RR_YOUNG_DEPTH = 3;
constexpr float RR_CLAMP_LO = (float)(0.05 / 0.55);
constexpr float RR_CLAMP_HI = (float)0.99;
constexpr float FLOOR_12 = (float)1e-12;
constexpr float FLOOR_18 = (float)1e-18;
constexpr float FLOOR_9 = (float)1e-9;
constexpr float FLOOR_6 = (float)1e-6;
constexpr float CONE_OUTSIDE = (float)1.0001;
constexpr float SHADOW_SCALE = (float)(1.0 - 1e-3);
// jnp.float32(math.log(1.0 / RR_BASE)) in nee_clamp_at_depth.
constexpr float LOG_INV_RR = (float)0.5978370007556204;

// Light-table row layout (ops/lights.py).
constexpr int LIGHT_COLS = 18;
constexpr int COL_PROB = 0, COL_CUM = 1, COL_KIND = 2, COL_PRIM = 3, COL_G = 4, COL_LE = 12;
constexpr int COL_R2 = 15, COL_R2_EDGE = 16, COL_AREA = 17;

constexpr int BLOCK = 128;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return V3{x, y, z}; }
__device__ __forceinline__ V3 operator+(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
__device__ __forceinline__ V3 operator-(V3 a, V3 b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
__device__ __forceinline__ V3 operator-(V3 a) { return v3(-a.x, -a.y, -a.z); }
__device__ __forceinline__ V3 operator*(V3 a, V3 b) { return v3(a.x * b.x, a.y * b.y, a.z * b.z); }
__device__ __forceinline__ V3 operator*(V3 a, float s) { return v3(a.x * s, a.y * s, a.z * s); }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ float mag2(V3 a) { return dot(a, a); }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}

// jnp.maximum / jnp.minimum propagate NaN; fmaxf / fminf drop it.
__device__ __forceinline__ float jmax(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float jmin(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}

__device__ __forceinline__ bool almost_zero(float v) { return fabsf(v) < RAY_EPSILON; }

// math/vec.py normalize: the zero vector below RayEpsilon.
__device__ __forceinline__ V3 normalize(V3 v) {
  float m2 = mag2(v);
  bool zero = m2 < RAY_EPSILON2;
  float ln = sqrtf(zero ? 1.0f : m2);
  float s = zero ? 0.0f : 1.0f / ln;
  return v * s;
}

struct Basis {
  V3 n, t, b;
};

// math/vec.py construct_basis: helper (0,1,0), flipped to (0,0,1) at |N.y| > 0.95.
__device__ __forceinline__ Basis construct_basis(V3 n) {
  bool flip = fabsf(n.y) > (float)0.95;
  V3 helper = v3(0.0f, flip ? 0.0f : 1.0f, flip ? 1.0f : 0.0f);
  Basis bs;
  bs.n = n;
  bs.t = normalize(cross(helper, n));
  bs.b = cross(bs.t, n);
  return bs;
}

// ---- ops/threefry.py ------------------------------------------------------

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

// (x >> 8) * 2^-24: the reference's FloatFromBits.
__device__ __forceinline__ float to_unit_float(uint32_t bits) {
  return (float)(bits >> 8) * (1.0f / 16777216.0f);
}

// Counter word 1 = sample * 256 + stream * 2 + pair.
__device__ __forceinline__ void pair_uniforms(uint32_t k0, uint32_t k1, uint32_t pixel,
                                              uint32_t sample, uint32_t stream, uint32_t pair,
                                              float& u0, float& u1) {
  uint32_t b0, b1;
  threefry2x32(k0, k1, pixel, sample * 256u + stream * 2u + pair, b0, b1);
  u0 = to_unit_float(b0);
  u1 = to_unit_float(b1);
}

// ---- sampling.py ----------------------------------------------------------

__device__ __forceinline__ uint32_t hash32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t laine_karras(uint32_t x, uint32_t seed) {
  x ^= x * 0x3D20ADEAu;
  x += seed;
  x *= (seed >> 16) | 1u;
  x ^= x * 0x05526C56u;
  x ^= x * 0x53A22864u;
  return x;
}

__device__ __forceinline__ uint32_t owen_scramble(uint32_t x, uint32_t seed) {
  return __brev(laine_karras(__brev(x), seed));
}

// sobol_pair: keys hash32(seed ^ hash32(stream * 8 + 4 * pair + role)), so
// pairs 2 and 3 of stream s reuse the keys of pairs 0 and 1 of stream s + 1,
// as in the JAX package. bits is in [1, 32].
__device__ __forceinline__ void sobol_pair(uint32_t seed, uint32_t sample, uint32_t stream,
                                           uint32_t pair, int bits, float& u0, float& u1) {
  const uint32_t group = stream * 8u + 4u * pair;
  const uint32_t g0 = hash32(seed ^ hash32(group));
  const uint32_t g1 = hash32(seed ^ hash32(group + 1u));
  const uint32_t g2 = hash32(seed ^ hash32(group + 2u));
  const int shift = 32 - bits;
  const uint32_t idx = owen_scramble(sample << shift, g0) >> shift;  // shuffle_index
  // sobol2d_bits: van der Corput, and the v ^= v >> 1 recurrence over the
  // low `bits` index bits.
  const uint32_t d0 = __brev(idx);
  uint32_t d1 = 0u, v = 0x80000000u, i = idx;
  for (int b = 0; b < bits; ++b) {
    d1 = (i & 1u) ? (d1 ^ v) : d1;
    v ^= v >> 1;
    i >>= 1;
  }
  u0 = to_unit_float(owen_scramble(d0, g1));
  u1 = to_unit_float(owen_scramble(d1, g2));
}

// One ray's draw state: Threefry keys and counters, or the Sobol pixel seed.
struct Draws {
  uint32_t k0, k1, pixel, sample, seed;
  int bits;
};

template <bool SOBOL>
__device__ __forceinline__ void draw_pair(const Draws& s, uint32_t stream, uint32_t pair, float& u0,
                                          float& u1) {
  if constexpr (SOBOL) {
    sobol_pair(s.seed, s.sample, stream, pair, s.bits, u0, u1);
  } else {
    pair_uniforms(s.k0, s.k1, s.pixel, s.sample, stream, pair, u0, u1);
  }
}

// ---- geometry.py ----------------------------------------------------------

__device__ __forceinline__ bool degenerate(V3 d) {
  return almost_zero(d.x) && almost_zero(d.y) && almost_zero(d.z);
}

// Per-ray quantities of a scan, hoisted out of the object loop.
struct RayPre {
  bool deg;
  float a, tmin;
};

__device__ __forceinline__ RayPre ray_pre(V3 o, V3 d) {
  RayPre r;
  r.deg = degenerate(d);
  const float dd = mag2(d);
  // geometry.py::min_hit_t, once per ray, in the ray's own parameterization.
  const float mag = jmax(jmax(fabsf(o.x), fabsf(o.y)), fabsf(o.z));
  r.tmin = (T_MIN_SCALE * (1.0f + mag)) / sqrtf(r.deg ? 1.0f : dd);
  r.a = r.deg ? 1.0f : dd;
  return r;
}

// geometry.py::sphere_candidate_t: the nearest root at or beyond tmin, or
// +inf where there is none, so a plain `<` against it takes only hits.
__device__ __forceinline__ float sphere_t(const float* __restrict__ sp, V3 o, V3 d,
                                          const RayPre& pre) {
  V3 rel = o - v3(__ldg(sp), __ldg(sp + 1), __ldg(sp + 2));
  float r = __ldg(sp + 3);
  float b = dot(rel, d);
  float c = mag2(rel);
  float u = 2.0f * b / pre.a;
  float v = (c - r * r) / pre.a;
  float disc = -v + (u * u) / 4.0f;
  bool has_root = disc >= 0.0f;
  float shift = sqrtf(jmax(disc, FLOOR_12));
  float t0 = -u / 2.0f - shift;
  float t1 = -u / 2.0f + shift;
  t0 = t0 < pre.tmin ? INFINITY : t0;
  t1 = t1 < pre.tmin ? INFINITY : t1;
  float t = jmin(t0, t1);
  const bool valid = has_root && !pre.deg && isfinite(t);
  return valid ? t : INFINITY;
}

// geometry.py::plane_candidate: t (+inf on a miss), the point at t and the
// plane's normal.
__device__ __forceinline__ float plane_t(const float* __restrict__ pl, V3 o, V3 d,
                                         const RayPre& pre, V3& p, V3& normal) {
  normal = v3(__ldg(pl), __ldg(pl + 1), __ldg(pl + 2));
  V3 point = v3(__ldg(pl + 3), __ldg(pl + 4), __ldg(pl + 5));
  V3 diff = o - point;
  float pa = -dot(diff, normal);
  float pb = dot(d, normal);
  bool on_anchor = diff.x == 0.0f && diff.y == 0.0f && diff.z == 0.0f;
  bool b_zero = almost_zero(pb);
  bool parallel_miss = !on_anchor && b_zero;
  float safe_b = b_zero ? 1.0f : pb;
  float t = b_zero ? 0.0f : pa / safe_b;
  bool backward = t < pre.tmin;
  p = o + d * t;
  Basis bs = construct_basis(normal);
  V3 in_plane = p - point;
  bool outside = (fabsf(dot(in_plane, bs.t)) * 2.0f > __ldg(pl + 6)) ||
                 (fabsf(dot(in_plane, bs.b)) * 2.0f > __ldg(pl + 7));
  const bool valid = !pre.deg && !parallel_miss && !backward && !outside;
  return valid ? t : INFINITY;
}

// ---- geometry.py: SDF primitives ------------------------------------------

constexpr int SDF_COLS = 19;  // scene/compile.py: kind, c xyz, p0..p3, material, R (9), scale
constexpr int SDF_KIND_SPHERE = 0, SDF_KIND_BOX = 1;
constexpr int SPHERE_TRACE_STEPS = 128;
constexpr float SDF_EPS = (float)1e-4;
constexpr float SDF_MIN_T = (float)1e-3;
constexpr float SDF_MAX_T = (float)1e6;
constexpr float FLOOR_20 = (float)1e-20;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mag2_rn(V3 a) {
  return add_rn(add_rn(mul_rn(a.x, a.x), mul_rn(a.y, a.y)), mul_rn(a.z, a.z));
}
__device__ __forceinline__ V3 sub_rn(V3 a, V3 b) {
  return v3(sub_rn(a.x, b.x), sub_rn(a.y, b.y), sub_rn(a.z, b.z));
}
// o + d * t, each operation rounded.
__device__ __forceinline__ V3 ray_at_rn(V3 o, V3 d, float t) {
  return v3(add_rn(o.x, mul_rn(d.x, t)), add_rn(o.y, mul_rn(d.y, t)), add_rn(o.z, mul_rn(d.z, t)));
}
// Row i of a row-major 3x3 times v: (r0 x + r1 y) + r2 z.
__device__ __forceinline__ float row3_rn(float r0, float r1, float r2, V3 v) {
  return add_rn(add_rn(mul_rn(r0, v.x), mul_rn(r1, v.y)), mul_rn(r2, v.z));
}

// One SDF row, loaded once per scan.
struct Sdf {
  int kind;
  V3 c;
  float p0, p1, p2;
  float r[9];  // world-to-local rotation, row-major
  float scale, inv_scale;
};

__device__ __forceinline__ Sdf load_sdf(const float* __restrict__ sd) {
  Sdf f;
  f.kind = (int)__ldg(sd);
  f.c = v3(__ldg(sd + 1), __ldg(sd + 2), __ldg(sd + 3));
  f.p0 = __ldg(sd + 4);
  f.p1 = __ldg(sd + 5);
  f.p2 = __ldg(sd + 6);
#pragma unroll
  for (int i = 0; i < 9; ++i) f.r[i] = __ldg(sd + 9 + i);
  f.scale = __ldg(sd + 18);
  f.inv_scale = __fdiv_rn(1.0f, f.scale);
  return f;
}

// geometry.py::sdf_distance of local point q, the kind's formula only.
__device__ __forceinline__ float sdf_distance(const Sdf& f, V3 q) {
  if (f.kind == SDF_KIND_SPHERE) {
    return sub_rn(__fsqrt_rn(jmax(mag2_rn(q), FLOOR_20)), f.p0);
  }
  if (f.kind == SDF_KIND_BOX) {
    const float ax = sub_rn(fabsf(q.x), f.p0);
    const float ay = sub_rn(fabsf(q.y), f.p1);
    const float az = sub_rn(fabsf(q.z), f.p2);
    const float mx = jmax(ax, 0.0f), my = jmax(ay, 0.0f), mz = jmax(az, 0.0f);
    const float outside = __fsqrt_rn(add_rn(add_rn(mul_rn(mx, mx), mul_rn(my, my)), mul_rn(mz, mz)));
    const float inside = jmin(jmax(ax, jmax(ay, az)), 0.0f);
    return add_rn(outside, inside);
  }
  // torus about the local y axis
  const float ring = sub_rn(__fsqrt_rn(jmax(add_rn(mul_rn(q.x, q.x), mul_rn(q.z, q.z)), FLOOR_20)), f.p0);
  return sub_rn(__fsqrt_rn(jmax(add_rn(mul_rn(ring, ring), mul_rn(q.y, q.y)), FLOOR_20)), f.p1);
}

// World point relative to the center -> object frame: R w, then * (1 / s).
__device__ __forceinline__ V3 sdf_to_local(const Sdf& f, V3 w) {
  return v3(mul_rn(row3_rn(f.r[0], f.r[1], f.r[2], w), f.inv_scale),
            mul_rn(row3_rn(f.r[3], f.r[4], f.r[5], w), f.inv_scale),
            mul_rn(row3_rn(f.r[6], f.r[7], f.r[8], w), f.inv_scale));
}

__device__ __forceinline__ float sdf_world_dist(const Sdf& f, V3 p) {
  return mul_rn(sdf_distance(f, sdf_to_local(f, sub_rn(p, f.c))), f.scale);
}

__device__ __forceinline__ float sdf_eps(float t) { return mul_rn(SDF_EPS, jmax(1.0f, t)); }

// Per-ray quantities of the SDF march, hoisted out of the object loop.
struct SdfRay {
  V3 dn;      // d / |d|
  float dlen;  // |d| (1 for a degenerate d)
  float lim;   // max(SDF_MIN_T, min_hit_t(o)) in world units
  bool deg;
};

__device__ __forceinline__ SdfRay sdf_ray(V3 o, V3 d) {
  SdfRay r;
  r.deg = degenerate(d);
  r.dlen = __fsqrt_rn(r.deg ? 1.0f : mag2_rn(d));
  r.dn = v3(__fdiv_rn(d.x, r.dlen), __fdiv_rn(d.y, r.dlen), __fdiv_rn(d.z, r.dlen));
  const float mag = jmax(jmax(fabsf(o.x), fabsf(o.y)), fabsf(o.z));
  r.lim = jmax(SDF_MIN_T, mul_rn(T_MIN_SCALE, add_rn(1.0f, mag)));
  return r;
}

// geometry.py::sdf_candidate's march: the world-unit t at which the march
// stops, and whether it is a hit. A thread leaves at convergence or
// escape; the TPU's frozen lanes kept exactly this t.
__device__ __forceinline__ float sdf_march(const Sdf& f, V3 o, const SdfRay& r, bool& valid) {
  float t = 0.0f;
  bool hit = false;
  int i = 0;
  for (; i < SPHERE_TRACE_STEPS; ++i) {
    const float dist = sdf_world_dist(f, ray_at_rn(o, r.dn, t));
    const float eps = sdf_eps(t);
    if (fabsf(dist) < eps) {
      hit = true;
      break;
    }
    if (t > SDF_MAX_T) break;
    t = add_rn(t, jmax(dist, mul_rn(0.5f, eps)));
  }
  if (i == SPHERE_TRACE_STEPS) hit = fabsf(sdf_world_dist(f, ray_at_rn(o, r.dn, t))) < sdf_eps(t);
  valid = hit && !r.deg && t > r.lim && t <= SDF_MAX_T;
  return t;
}

// geometry.py::sdf_normal at the world point p, the march stopped at t:
// the 4-tap tetrahedron gradient in the object frame (spacing eps / s),
// normalized, rotated back to world.
__device__ V3 sdf_normal(const Sdf& f, V3 p, float t) {
  const float h = __fdiv_rn(sdf_eps(t), f.scale);
  const V3 q = sdf_to_local(f, sub_rn(p, f.c));
  const float t0 = sdf_distance(f, v3(add_rn(q.x, h), sub_rn(q.y, h), sub_rn(q.z, h)));
  const float t1 = sdf_distance(f, v3(sub_rn(q.x, h), sub_rn(q.y, h), add_rn(q.z, h)));
  const float t2 = sdf_distance(f, v3(sub_rn(q.x, h), add_rn(q.y, h), sub_rn(q.z, h)));
  const float t3 = sdf_distance(f, v3(add_rn(q.x, h), add_rn(q.y, h), add_rn(q.z, h)));
  V3 g = v3(add_rn(sub_rn(sub_rn(t0, t1), t2), t3), add_rn(add_rn(sub_rn(-t0, t1), t2), t3),
            add_rn(sub_rn(add_rn(-t0, t1), t2), t3));
  // math/vec.py normalize, rounded as torch rounds it.
  const float m2 = mag2_rn(g);
  const bool zero = m2 < RAY_EPSILON2;
  const float s = zero ? 0.0f : __fdiv_rn(1.0f, __fsqrt_rn(zero ? 1.0f : m2));
  g = v3(mul_rn(g.x, s), mul_rn(g.y, s), mul_rn(g.z, s));
  // R^T g
  return v3(row3_rn(f.r[0], f.r[3], f.r[6], g), row3_rn(f.r[1], f.r[4], f.r[7], g),
            row3_rn(f.r[2], f.r[5], f.r[8], g));
}

struct Hit {
  float t;
  V3 p, n;
  int mid;
  int prim;  // sphere i -> i, plane j -> n_spheres + j, miss -> -1
  bool hit;
};

// pallas_integrator.py::_intersect_const over table operands: a t-only
// sphere scan, one fetch of the winning sphere, the planes, then (SDF) the
// SDF marches. Updates are on a strict best_t > t, so the first object wins
// a tie, a sphere wins a tie against a plane and a plane against an SDF.
template <bool SDF>
__device__ Hit intersect(const float* __restrict__ spheres, int n_spheres,
                         const float* __restrict__ planes, int n_planes,
                         const float* __restrict__ sdfs, int n_sdfs, V3 o, V3 d) {
  const RayPre pre = ray_pre(o, d);

  float s_best_t = INFINITY;
  int s_best = -1;
  for (int s = 0; s < n_spheres; ++s) {
    const float t = sphere_t(spheres + 5 * s, o, d, pre);
    if (s_best_t > t) {
      s_best_t = t;
      s_best = s;
    }
  }

  Hit h;
  h.t = s_best_t;
  h.hit = s_best >= 0;
  h.prim = s_best;
  h.p = v3(0.0f, 0.0f, 0.0f);
  h.n = v3(0.0f, 0.0f, 0.0f);
  h.mid = 0;
  if (h.hit) {
    const float* sp = spheres + 5 * s_best;
    V3 p = o + d * s_best_t;
    h.p = p;
    h.n = normalize(p - v3(__ldg(sp), __ldg(sp + 1), __ldg(sp + 2)));
    h.mid = (int)__ldg(sp + 4);
  }

  for (int j = 0; j < n_planes; ++j) {
    const float* pl = planes + 9 * j;
    V3 p, normal;
    const float t = plane_t(pl, o, d, pre, p, normal);
    if (h.t > t) {
      h.t = t;
      h.hit = true;
      h.p = p;
      h.n = normal;
      h.mid = (int)__ldg(pl + 8);
      h.prim = n_spheres + j;
    }
  }

  if constexpr (SDF) {
    const SdfRay r = sdf_ray(o, d);
    for (int k = 0; k < n_sdfs; ++k) {
      const float* sd = sdfs + SDF_COLS * k;
      const Sdf f = load_sdf(sd);
      bool valid;
      const float tw = sdf_march(f, o, r, valid);
      const float t = valid ? __fdiv_rn(tw, r.dlen) : INFINITY;
      if (h.t > t) {
        h.t = t;
        h.hit = true;
        h.p = ray_at_rn(o, r.dn, tw);
        h.n = sdf_normal(f, h.p, tw);
        h.mid = (int)__ldg(sd + 8);
        h.prim = -1;  // not light-sampled: MIS weight 1
      }
    }
  }
  return h;
}

// pallas_integrator.py::_occluded_const: any hit closer than t_max.
template <bool SDF>
__device__ bool occluded(const float* __restrict__ spheres, int n_spheres,
                         const float* __restrict__ planes, int n_planes,
                         const float* __restrict__ sdfs, int n_sdfs, V3 o, V3 d, float t_max) {
  const RayPre pre = ray_pre(o, d);
  for (int s = 0; s < n_spheres; ++s) {
    if (sphere_t(spheres + 5 * s, o, d, pre) < t_max) return true;
  }
  for (int j = 0; j < n_planes; ++j) {
    V3 p, normal;
    if (plane_t(planes + 9 * j, o, d, pre, p, normal) < t_max) return true;
  }
  if constexpr (SDF) {
    const SdfRay r = sdf_ray(o, d);
    for (int k = 0; k < n_sdfs; ++k) {
      bool valid;
      const float tw = sdf_march(load_sdf(sdfs + SDF_COLS * k), o, r, valid);
      if (valid && __fdiv_rn(tw, r.dlen) < t_max) return true;
    }
  }
  return false;
}

// ---- materials.py ---------------------------------------------------------

struct Material {
  V3 albedo, emission, tint;
  float roughness, ior;
};

__device__ __forceinline__ Material load_material(const float* __restrict__ materials, int mid) {
  const float* m = materials + 11 * mid;
  Material mp;
  mp.albedo = v3(__ldg(m), __ldg(m + 1), __ldg(m + 2));
  mp.emission = v3(__ldg(m + 3), __ldg(m + 4), __ldg(m + 5));
  mp.tint = v3(__ldg(m + 6), __ldg(m + 7), __ldg(m + 8));
  mp.roughness = __ldg(m + 9);
  mp.ior = __ldg(m + 10);
  return mp;
}

__device__ __forceinline__ float distribution_gtr2(float cos_h, float alpha) {
  float alpha2 = alpha * alpha;
  float c2 = cos_h * cos_h;
  float denom = (1.0f - c2) + alpha2 * c2;
  float d = (alpha2 / TWO_PI) / jmax(denom * denom, FLOOR_18);
  return almost_zero(alpha2) ? 1.0f : d;
}

__device__ __forceinline__ float lambda_tr(float tan_theta, float alpha) {
  bool inf = isinf(tan_theta);
  float at = inf ? 0.0f : fabsf(tan_theta) * alpha;
  float lam = (-1.0f + sqrtf(1.0f + at * at)) * 0.5f;
  return inf ? 0.0f : lam;
}

__device__ __forceinline__ float schlick(float cos_theta, float n1, float n2) {
  float r0 = (n1 - n2) / (n1 + n2);
  r0 = r0 * r0;
  float m = 1.0f - cos_theta;
  float m2 = m * m;
  return r0 + (1.0f - r0) * (m2 * m2 * m);
}

__device__ V3 glossy_eval(V3 wi, V3 wo, V3 n, V3 tint, float alpha, float ior) {
  float cos_o = jmax(0.0f, dot(wo, n));
  float cos_i = jmax(0.0f, dot(wi, n));
  bool dead = almost_zero(cos_o) || almost_zero(cos_i);
  float sin_o = sqrtf(jmax(1.0f - cos_o * cos_o, FLOOR_12));
  float sin_i = sqrtf(jmax(1.0f - cos_i * cos_i, FLOOR_12));
  V3 h = normalize(wi + wo);
  bool h_zero = almost_zero(h.x) && almost_zero(h.y) && almost_zero(h.z);
  float cos_h = jmax(0.0f, dot(h, n));
  float safe_cos_o = dead ? 1.0f : cos_o;
  float safe_cos_i = dead ? 1.0f : cos_i;
  float d = distribution_gtr2(cos_h, alpha);
  float g = 1.0f / (1.0f + lambda_tr(sin_i / safe_cos_i, alpha) + lambda_tr(sin_o / safe_cos_o, alpha));
  float f = schlick(cos_h, 1.0f, ior);
  float scale = (dead || h_zero) ? 0.0f : f * d * g / (4.0f * safe_cos_o * safe_cos_i);
  return tint * scale;
}

__device__ float glossy_pdf(V3 wi, V3 wo, V3 n, float alpha) {
  V3 h = normalize(wi + wo);
  float cos_h = jmax(0.0f, dot(h, n));
  float d = distribution_gtr2(cos_h, alpha);
  float pdf_h = d * fabsf(cos_h);
  float wi_dot_h = dot(wi, h);
  bool small = almost_zero(wi_dot_h);
  float safe = small ? 1.0f : wi_dot_h;
  float pdf = small ? pdf_h : pdf_h / (4.0f * safe);
  return almost_zero(cos_h) ? 1.0f : pdf;
}

// Oren-Nayar with the reference's frame bug: cos(theta) is the world z.
__device__ V3 oren_nayar_eval(V3 wi, V3 wo, V3 albedo, float sigma) {
  float cos_i = wi.z;
  float cos_o = wo.z;
  float sin_i = sqrtf(jmax(1.0f - cos_i * cos_i, FLOOR_12));
  float sin_o = sqrtf(jmax(1.0f - cos_o * cos_o, FLOOR_12));
  float safe_sin_i = sin_i > 0.0f ? sin_i : 1.0f;
  float safe_sin_o = sin_o > 0.0f ? sin_o : 1.0f;
  float cphi_i = wi.x / safe_sin_i;
  float cphi_o = wo.x / safe_sin_o;
  bool valid = sin_i > 0.0f && sin_o > 0.0f && fabsf(cphi_i) <= 1.0f && fabsf(cphi_o) <= 1.0f;
  float cos_dphi = cphi_i * cphi_o +
                   sqrtf(jmax((1.0f - cphi_i * cphi_i) * (1.0f - cphi_o * cphi_o), FLOOR_12));
  float term = valid ? jmax(0.0f, cos_dphi) : 0.0f;
  float sigma2 = sigma * sigma;
  float a = 1.0f - (sigma2 / (2.0f * (sigma2 + (float)0.333)));
  float b = (float)0.45 * sigma2 / (sigma2 + (float)0.09);
  float scale = (a + b * term * sin_i * sin_o) / PI_F;
  return albedo * scale;
}

__device__ V3 layered_eval(V3 wi, V3 wo, V3 n, const Material& mp) {
  float sigma = fabsf(0.5f * mp.roughness * mp.roughness);
  float alpha = mp.roughness * mp.roughness;
  V3 d_f = oren_nayar_eval(wi, wo, mp.albedo, sigma);
  V3 g_f = glossy_eval(wi, wo, n, mp.tint, alpha, mp.ior);
  float w = 1.0f - schlick(jmax(0.0f, dot(n, wi)), 1.0f, mp.ior);
  return d_f * w + g_f;
}

// materials.py::layered_sample. Only the chosen lobe's direction is
// computed: the functions are pure, so this equals computing both and
// selecting, as the TPU kernel did.
__device__ void layered_sample(V3 wo, float x0, float x1, float x2, const Basis& bs,
                               const Material& mp, V3& wi, float& pdf, V3& f) {
  float alpha = mp.roughness * mp.roughness;
  if (x2 < 0.5f) {
    // rng.py::hemisphere_sample_basis(x0, x1): v = (cos(a) b, sin(a) b, x0).
    float ang = TWO_PI * x1;
    float b = sqrtf(jmax(1.0f - x0 * x0, 0.0f));
    float vx = cosf(ang) * b;
    float vy = sinf(ang) * b;
    wi = bs.b * vx + bs.t * vy + bs.n * x0;
  } else {
    // materials.py::glossy_sample
    float alpha2 = alpha * alpha;
    float a = 1.0f - x1;
    float b = 1.0f + (alpha2 - 1.0f) * x1;
    float cos_h = sqrtf(jmax(a / b, FLOOR_12));
    float sin_h = sqrtf(jmax(1.0f - cos_h * cos_h, FLOOR_12));
    float phi = TWO_PI * x0;
    V3 h = normalize(bs.b * (sin_h * cosf(phi)) + bs.t * (sin_h * sinf(phi)) + bs.n * cos_h);
    bool below = dot(h, bs.n) < 0.0f;
    V3 w = normalize(h * (2.0f * dot(wo, h)) - wo);
    wi = below ? v3(0.0f, 0.0f, 0.0f) : w;
  }
  pdf = 0.5f * (HEMISPHERE_PDF + glossy_pdf(wi, wo, bs.n, alpha));
  f = layered_eval(wi, wo, bs.n, mp);
}

// materials.py::layered_pdf_true: the true density of layered_sample's
// 50/50 mixture (the glossy sampler's density is twice glossy_pdf).
__device__ __forceinline__ float layered_pdf_true(V3 wi, V3 wo, V3 n, const Material& mp) {
  float alpha = mp.roughness * mp.roughness;
  return 0.5f * (HEMISPHERE_PDF + 2.0f * glossy_pdf(wi, wo, n, alpha));
}

// ---- next-event estimation (_make_kernel, mode "nee") ---------------------

__device__ __forceinline__ float light(const float* __restrict__ lights, int row, int col) {
  return __ldg(lights + LIGHT_COLS * row + col);
}

// integrator.py::nee_clamp_at_depth: base x (1/RR_BASE)^max(depth - 3, 0).
__device__ __forceinline__ float clamp_at_depth(float base, int depth) {
  const int excess = depth > RR_YOUNG_DEPTH ? depth - RR_YOUNG_DEPTH : 0;
  return base * expf((float)excess * LOG_INV_RR);
}

// The density with which light sampling picks the emitter a BSDF-sampled
// ray from o along d hit at distance t (prim), 0 off the table. The rows
// are scanned as the JAX select chain is: the last row of that prim wins.
__device__ float emission_pickup(const float* __restrict__ lights, int n_lights, V3 o, V3 d,
                                 float t, int prim) {
  float p_light = 0.0f;
  for (int r = 0; r < n_lights; ++r) {
    if ((int)light(lights, r, COL_PRIM) != prim) continue;
    const float pr = light(lights, r, COL_PROB);
    const float g0 = light(lights, r, COL_G), g1 = light(lights, r, COL_G + 1),
                g2 = light(lights, r, COL_G + 2);
    if (light(lights, r, COL_KIND) < 0.5f) {
      const float dx = g0 - o.x, dy = g1 - o.y, dz = g2 - o.z;
      const float d2 = dx * dx + dy * dy + dz * dz;
      const float sin2max = jmin(jmax(light(lights, r, COL_R2) / jmax(d2, FLOOR_12), 0.0f), 1.0f);
      const float cos_max = sqrtf(jmax(1.0f - sin2max, 0.0f));
      const float cand = pr / (TWO_PI * jmax(1.0f - cos_max, FLOOR_9));
      p_light = d2 > light(lights, r, COL_R2_EDGE) ? cand : 0.0f;
    } else {
      // Area -> solid angle at the hit distance: pr t^2 / (A |cos|).
      const float cos_l = fabsf(d.x * g0 + d.y * g1 + d.z * g2);
      p_light = pr * t * t / (light(lights, r, COL_AREA) * jmax(cos_l, FLOOR_6));
    }
  }
  return p_light;
}

struct LightSample {
  V3 wi, le;
  float t, pdf;
  bool valid;
};

// Pick a row by the cumulative table (the last row whose predecessor's cum
// is below u_sel) and sample a direction toward it from p: a uniform cone
// for a sphere, a uniform point for a plane (two-sided).
__device__ LightSample sample_light(const float* __restrict__ lights, int n_lights, V3 p,
                                    float u_sel, float ul1, float ul2) {
  int r = 0;
  for (int i = 1; i < n_lights; ++i) r = u_sel > light(lights, i - 1, COL_CUM) ? i : r;
  const float lpr = light(lights, r, COL_PROB);
  float g[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) g[i] = light(lights, r, COL_G + i);
  LightSample ls;
  ls.le = v3(light(lights, r, COL_LE), light(lights, r, COL_LE + 1), light(lights, r, COL_LE + 2));
  float pdf;
  if (light(lights, r, COL_KIND) < 0.5f) {
    const float lrad = g[3];
    const V3 to_c = v3(g[0] - p.x, g[1] - p.y, g[2] - p.z);
    const float d2 = to_c.x * to_c.x + to_c.y * to_c.y + to_c.z * to_c.z;
    const float dist = sqrtf(jmax(d2, FLOOR_12));
    const bool outside = dist > lrad * CONE_OUTSIDE;
    const float sin2max = jmin(jmax(lrad * lrad / jmax(d2, FLOOR_12), 0.0f), 1.0f);
    const float cos_max = sqrtf(jmax(1.0f - sin2max, 0.0f));
    const float one_minus = jmax(1.0f - cos_max, FLOOR_9);
    const float cos_t = 1.0f - ul1 * one_minus;
    const float sin_t = sqrtf(jmax(1.0f - cos_t * cos_t, 0.0f));
    const float phi = TWO_PI * ul2;
    const Basis lb = construct_basis(v3(to_c.x / dist, to_c.y / dist, to_c.z / dist));
    ls.wi = lb.t * (sin_t * cosf(phi)) + lb.b * (sin_t * sinf(phi)) + lb.n * cos_t;
    ls.t = dist * cos_t - sqrtf(jmax(lrad * lrad - d2 * (1.0f - cos_t * cos_t), 0.0f));
    pdf = lpr / (TWO_PI * one_minus);
    ls.valid = outside && ls.t > 0.0f;
  } else {
    const V3 nrm = v3(g[0], g[1], g[2]);
    const Basis pb = construct_basis(nrm);
    const V3 q = v3(g[3], g[4], g[5]) + pb.t * ((ul1 - 0.5f) * g[6]) + pb.b * ((ul2 - 0.5f) * g[7]);
    const V3 to_q = v3(q.x - p.x, q.y - p.y, q.z - p.z);
    const float d2q = to_q.x * to_q.x + to_q.y * to_q.y + to_q.z * to_q.z;
    const float dq = sqrtf(jmax(d2q, FLOOR_12));
    ls.wi = v3(to_q.x / dq, to_q.y / dq, to_q.z / dq);
    const float cos_lp = fabsf(dot(ls.wi, nrm));
    const float area = jmax(g[6] * g[7], FLOOR_12);
    pdf = lpr * d2q / (area * jmax(cos_lp, FLOOR_6));
    ls.t = dq;
    ls.valid = cos_lp > FLOOR_6 && dq > FLOOR_6;
  }
  ls.pdf = jmax(pdf, FLOOR_12);
  return ls;
}

// ---- the kernel -----------------------------------------------------------

// NEE: mode "nee" (else "path"); SOBOL: sampler "sobol" (else "uniform");
// SDF: scan the n_sdfs rows of `sdfs` (else they are not read).
// `lights` (n_lights rows) and `clamp` (the clamp base) are read in mode
// "nee" only; n_lights = 0 means nothing emits: no light is sampled, and
// emission is neither MIS-weighted nor clamped.
template <bool NEE, bool SOBOL, bool SDF>
__global__ void __launch_bounds__(BLOCK)
megakernel(const float* __restrict__ camera, const float* __restrict__ spheres, int n_spheres,
           const float* __restrict__ planes, int n_planes, const float* __restrict__ materials,
           float* __restrict__ out, long long n_rays, uint32_t k0, uint32_t k1, uint32_t root,
           int width, float inv_width, float inv_height, int spp_chunk, uint32_t sample_offset,
           int max_depth, int index_bits, const float* __restrict__ lights, int n_lights,
           const float* __restrict__ clamp, const float* __restrict__ sdfs, int n_sdfs) {
  const long long k = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (k >= n_rays) return;
  // Ray k is (pixel k / spp, sample offset + k % spp).
  Draws s;
  s.k0 = k0;
  s.k1 = k1;
  s.pixel = (uint32_t)(k / spp_chunk);
  s.sample = sample_offset + (uint32_t)(k % spp_chunk);
  s.seed = hash32(s.pixel ^ root);  // the per-pixel Sobol seed
  s.bits = index_bits;

  // Camera jitter (stream 0, pair 0) and generate_rays.
  float u0, u1;
  draw_pair<SOBOL>(s, 0u, 0u, u0, u1);
  const float fi = (float)(s.pixel % (uint32_t)width);
  const float fj = (float)(s.pixel / (uint32_t)width);
  const float x = (fi + u0) * inv_width;
  const float y = (fj + u1) * inv_height;
  const V3 eye = v3(__ldg(camera), __ldg(camera + 1), __ldg(camera + 2));
  const V3 corner = v3(__ldg(camera + 3), __ldg(camera + 4), __ldg(camera + 5));
  const V3 cu = v3(__ldg(camera + 6), __ldg(camera + 7), __ldg(camera + 8));
  const V3 cv = v3(__ldg(camera + 9), __ldg(camera + 10), __ldg(camera + 11));
  V3 d = v3(corner.x + x * cu.x + y * cv.x, corner.y + x * cu.y + y * cv.y,
            corner.z + x * cu.z + y * cv.z);
  d = d * (1.0f / sqrtf(mag2(d)));
  V3 o = eye;

  const bool sample_lights = NEE && n_lights > 0;
  const float clamp_base = sample_lights ? __ldg(clamp) : 0.0f;
  V3 tput = v3(1.0f, 1.0f, 1.0f);
  V3 rad = v3(0.0f, 0.0f, 0.0f);
  float prev_pdf = 1.0f;  // the previous vertex's true BSDF density (MIS)
  for (int depth = 0; depth < max_depth; ++depth) {
    const Hit h = intersect<SDF>(spheres, n_spheres, planes, n_planes, sdfs, n_sdfs, o, d);
    if (!h.hit) break;  // a miss ends the path: nothing further is added
    const Material mp = load_material(materials, h.mid);
    V3 contrib = tput * mp.emission;
    if (sample_lights && depth > 0) {
      // MIS against light sampling, and the depth-aware clamp; the camera's
      // own sighting of an emitter (depth 0) is neither.
      const float p_light = emission_pickup(lights, n_lights, o, d, h.t, h.prim);
      const float w = prev_pdf / jmax(prev_pdf + p_light, FLOOR_12);
      const float cl = clamp_at_depth(clamp_base, depth);
      contrib = v3(jmin(contrib.x * w, cl), jmin(contrib.y * w, cl), jmin(contrib.z * w, cl));
    }
    rad = rad + contrib;

    // Pair 0 = BSDF lobe (x0, x1); pair 1 = (x2 layer choice, RR); nee adds
    // pair 2 = (light select, cone u1) and pair 3 = (cone u2, spare).
    const uint32_t stream = (uint32_t)depth + 1u;
    float x0, x1, x2, u_rr;
    draw_pair<SOBOL>(s, stream, 0u, x0, x1);
    draw_pair<SOBOL>(s, stream, 1u, x2, u_rr);
    const V3 wo = -d;

    if (sample_lights) {
      float u_sel, ul1, ul2, spare;
      draw_pair<SOBOL>(s, stream, 2u, u_sel, ul1);
      draw_pair<SOBOL>(s, stream, 3u, ul2, spare);
      const LightSample ls = sample_light(lights, n_lights, h.p, u_sel, ul1, ul2);
      const float cos_surf = dot(ls.wi, h.n);
      // The light's contribution before the RR decision, as in the JAX
      // kernel; the shadow ray only where it can be non-zero.
      if (ls.valid && cos_surf > 0.0f &&
          !occluded<SDF>(spheres, n_spheres, planes, n_planes, sdfs, n_sdfs,
                         h.p + ls.wi * BOUNCE_EPSILON, ls.wi, ls.t * SHADOW_SCALE)) {
        const V3 f_l = layered_eval(ls.wi, wo, h.n, mp);
        const float p_bsdf = layered_pdf_true(ls.wi, wo, h.n, mp);
        const float mis = ls.pdf / jmax(ls.pdf + p_bsdf, FLOOR_12);
        const float scale = mis * cos_surf / ls.pdf;
        const float cl = clamp_at_depth(clamp_base, depth);
        rad = rad + v3(jmin(tput.x * f_l.x * ls.le.x * scale, cl),
                       jmin(tput.y * f_l.y * ls.le.y * scale, cl),
                       jmin(tput.z * f_l.z * ls.le.z * scale, cl));
      }
    }

    // integrator.py::russian_roulette_probability
    const float power = jmin(jmax(mag2(tput), RR_CLAMP_LO), RR_CLAMP_HI);
    const float prob = depth < RR_YOUNG_DEPTH ? RR_YOUNG_SURVIVAL : RR_BASE * power;
    if (!(u_rr <= prob)) break;

    const Basis bs = construct_basis(h.n);
    V3 wi, f;
    float pdf;
    layered_sample(wo, x0, x1, x2, bs, mp, wi, pdf, f);
    if (NEE) pdf = layered_pdf_true(wi, wo, h.n, mp);
    const float scale = fabsf(dot(wi, h.n)) / (pdf * prob);
    tput = tput * f * scale;
    o = h.p + wi * BOUNCE_EPSILON;
    d = wi;  // zero after a glossy sample below the surface: the next hit misses
    prev_pdf = pdf;
  }
  out[3 * k + 0] = rad.x;
  out[3 * k + 1] = rad.y;
  out[3 * k + 2] = rad.z;
}

template <bool NEE, bool SOBOL, bool SDF>
int launch(const float* camera, const float* spheres, int n_spheres, const float* planes,
           int n_planes, const float* materials, const float* sdfs, int n_sdfs, float* out,
           long long n_rays, uint32_t k0, uint32_t k1, uint32_t root, int width, float inv_width,
           float inv_height, int spp_chunk, uint32_t sample_offset, int max_depth, int index_bits,
           const float* lights, int n_lights, const float* clamp, cudaStream_t stream) {
  const long long blocks = (n_rays + BLOCK - 1) / BLOCK;
  megakernel<NEE, SOBOL, SDF><<<(unsigned int)blocks, BLOCK, 0, stream>>>(
      camera, spheres, n_spheres, planes, n_planes, materials, out, n_rays, k0, k1, root, width,
      inv_width, inv_height, spp_chunk, sample_offset, max_depth, index_bits, lights, n_lights,
      clamp, sdfs, n_sdfs);
  return (int)cudaGetLastError();
}

template <bool NEE>
using LaunchFn = decltype(&launch<NEE, false, false>);

// The instantiation for (sobol, SDF rows present).
template <bool NEE>
LaunchFn<NEE> pick(int sobol, int n_sdfs) {
  if (n_sdfs > 0) return sobol ? launch<NEE, true, true> : launch<NEE, false, true>;
  return sobol ? launch<NEE, true, false> : launch<NEE, false, false>;
}

// Every instantiation of this library, for cornelis_megakernel*_load.
template <bool NEE>
int load_all() {
  const void* fns[4] = {(const void*)megakernel<NEE, false, false>,
                        (const void*)megakernel<NEE, true, false>,
                        (const void*)megakernel<NEE, false, true>,
                        (const void*)megakernel<NEE, true, true>};
  for (const void* fn : fns) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

#ifndef CORNELIS_MEGAKERNEL_NEE

// Launches one thread per ray in mode "path" on `stream` and returns
// cudaGetLastError(). sobol (0 or 1) and n_sdfs > 0 choose the
// instantiation; index_bits is clamped to [1, 32].
extern "C" int cornelis_megakernel(const float* camera, const float* spheres, int n_spheres,
                                   const float* planes, int n_planes, const float* materials,
                                   const float* sdfs, int n_sdfs, float* out, long long n_rays,
                                   uint32_t k0, uint32_t k1, uint32_t root, int width,
                                   float inv_width, float inv_height, int spp_chunk,
                                   uint32_t sample_offset, int max_depth, int sobol,
                                   int index_bits, void* stream) {
  index_bits = index_bits < 1 ? 1 : (index_bits > 32 ? 32 : index_bits);
  return pick<false>(sobol, n_sdfs)(camera, spheres, n_spheres, planes, n_planes, materials, sdfs,
                                    n_sdfs, out, n_rays, k0, k1, root, width, inv_width,
                                    inv_height, spp_chunk, sample_offset, max_depth, index_bits,
                                    nullptr, 0, nullptr, (cudaStream_t)stream);
}

// Loads this library's four kernels onto the current device (CUDA loads a
// module's kernels lazily, at first use) and returns the first error.
extern "C" int cornelis_megakernel_load() { return load_all<false>(); }

#else

// The same in mode "nee" (megakernel_nee.cu), with the light table
// (n_lights rows of ops/lights.py's layout) and the clamp base.
extern "C" int cornelis_megakernel_nee(const float* camera, const float* spheres, int n_spheres,
                                       const float* planes, int n_planes, const float* materials,
                                       const float* sdfs, int n_sdfs, float* out,
                                       long long n_rays, uint32_t k0, uint32_t k1, uint32_t root,
                                       int width, float inv_width, float inv_height,
                                       int spp_chunk, uint32_t sample_offset, int max_depth,
                                       int sobol, int index_bits, const float* lights,
                                       int n_lights, const float* clamp, void* stream) {
  index_bits = index_bits < 1 ? 1 : (index_bits > 32 ? 32 : index_bits);
  return pick<true>(sobol, n_sdfs)(camera, spheres, n_spheres, planes, n_planes, materials, sdfs,
                                   n_sdfs, out, n_rays, k0, k1, root, width, inv_width,
                                   inv_height, spp_chunk, sample_offset, max_depth, index_bits,
                                   lights, n_lights, clamp, (cudaStream_t)stream);
}

extern "C" int cornelis_megakernel_nee_load() { return load_all<true>(); }

#endif
