// Path-tracing megakernel for Hopper (sm_90a): the whole path of a ray in
// one thread, from the camera jitter to the last bounce, in persistent
// blocks that start a new ray in a lane as soon as its path ends.
//
// Replaces cornelis_tpu/ops/pallas_integrator.py::_make_kernel (launched
// there by _build_renderer through pl.pallas_call) on spheres, planes and
// SDF primitives, in modes "path" and "nee" with samplers "uniform" and
// "sobol", and cornelis_tpu/ops/pallas_dynamic.py::_make_kernel_dyn, whose
// bounce loop is the same and whose light table its nee instantiations
// (megakernel_dyn) build in their prologue, from the tables each block has
// staged, as the TPU kernel built it in every grid step (light_table.cuh);
// beside it they build a hierarchy of boxes over the spheres, which their
// scans walk (see "K3's sphere hierarchy" below).
// Mode, sampler and SDF support are template parameters; the SDF
// instantiations are launched only for tables with SDF rows. This file
// instantiates mode "path" (entry point cornelis_megakernel);
// megakernel_nee.cu includes it with CORNELIS_MEGAKERNEL_NEE defined and
// instantiates mode "nee" (cornelis_megakernel_nee, and
// cornelis_megakernel_nee_dynamic), compiled without FMA contraction
// (ops/build.py). Why: in the reference scenes a camera ray meets a sphere
// about 1000 units away, and the quadratic's cancellation leaves the hit
// point up to ~1e-3 off the surface, more than the min_hit_t guard. A point
// left inside its sphere shadows its own light sample, so NEE flips a shadow
// ray wherever two versions round a hit point differently: with
// contraction, a few % of rays against the plain torch version. Path mode
// has no shadow ray and keeps the contracted code.
//
// It computes what those kernels compute, draw for draw: Threefry-2x32
// uniforms keyed by (pixel, sample, stream, pair), or Owen-scrambled Sobol
// pairs keyed by (pixel seed, sample, stream, pair); camera jitter and
// generate_rays; then up to max_depth bounces of closest hit (two-phase
// sphere scan, then finite planes, then SDFs, under the min_hit_t guard),
// emission, layered BSDF sampling, Russian roulette and the throughput
// update. Mode "nee" adds, per bounce, the MIS weight and depth-aware clamp
// of emission found by BSDF sampling, a light chosen by the table's
// cumulative probability, a sphere-cone or plane-area sample, a shadow ray,
// and the MIS-weighted light contribution; it divides by the sampler's true
// density. Every float expression keeps the JAX package's order of
// operations; nvcc's default FMA contraction is the one known difference.
// Draws depend only on (pixel, sample, stream, pair), so the order in which
// rays are traced changes no ray's radiance.
//
// Ray k of a launch is (pixel k / spp_chunk, sample sample_offset + k %
// spp_chunk), where the pixel is the frame's index of the pixel, or, given
// a list of pixel ids, the (k / spp_chunk)-th id of the list. The list is
// the port of the mesh render's `px` operand
// (cornelis_tpu/parallel/render.py::_build_mesh_pallas_renderer): each rank
// of a (tiles, samples) mesh traces its tile-major run of pixels and its
// slice of the chunk's samples. Everything after the read (jitter, keys,
// Sobol seed) uses the frame's pixel, so a ray gives the same bits on any
// rank. A launch with a list runs instantiations of its own (IDS), so the
// contiguous ones are unchanged: read behind a runtime test in them, the
// id made path/uniform with SDFs spill 24 B at its 64 registers.
//
// What bounds it on this card: FP32 issue and warp divergence, not bytes. A
// ray reads no input but, on a mesh rank, its 4-byte pixel id once at the
// start of its path, writes 12 B of radiance, and spends thousands of FP32 and special-function
// instructions per bounce. Three things kept lanes idle or busy for
// nothing, and the design takes each on:
//
// - Paths end at different depths (a miss, Russian roulette, max_depth):
//   with one thread per ray a warp ran until its longest path ended, and
//   about a third of its bounce lane-slots did no work. Here one wave of
//   blocks (SMs x resident blocks per SM) stays resident; when a lane's path
//   ends it writes its radiance and takes the next ray index at the top of
//   the next bounce, so lanes idle only at the end of the launch. Indices
//   are taken at two levels: a block claims CHUNK consecutive rays from the
//   launch's counter with one atomicAdd, and its warps take from that range
//   through one shared-memory atomic per warp and bounce, so a fresh lane
//   starts on a neighbour of its warp's other rays.
// - SDF marches that ran past any use: an SDF is sphere-traced after the
//   spheres and planes, and each march now stops once its t reaches the
//   best hit so far (closest hit) or t_max (shadow ray), where any hit it
//   could still find would lose the strict comparison that follows (see
//   sdf_march). Sky-bound rays no longer march ~20 growing steps per SDF to
//   t = 1e6, and shadow rays stop at their light.
// - Per-ray work on per-scene constants, and registers: the tables are
//   expanded once into one layout (camera, planes with their tangent bases,
//   SDF rows with 1/scale, materials, lights, spheres as float4), staged
//   in each block's shared memory (or, past SMEM_CAP, once per launch in
//   device memory) and read through one pointer. Every lane of a warp
//   reads the same row as one broadcast, each plane's construct_basis runs
//   once per block instead of per ray and scan, and no read chooses
//   between two copies: a per-table choice of shared or device memory cost
//   the nee instantiations some 10 registers. The scans carry only the
//   best t and the winner; its point, normal (an SDF's tetrahedron normal)
//   and material are taken once, after them. Occupancy then decides the
//   time more than spills do (PERF.md), so each instantiation's
//   __launch_bounds__ asks for the most blocks per SM at which ptxas still
//   spills nothing.
//
// What is left: divergence inside a bounce (BSDF lobes, light kinds) and
// inside a scan (SDF marches of different lengths in one warp), and the
// nee instantiations' 86-95 registers (5 blocks, 20 warps per SM); the
// bound's work is FP32 issue at 67 TFLOP/s. A conservative bounding volume
// per SDF and per-warp march compaction are later work.
//
// K3's sphere hierarchy. The dynamic nee instantiations (megakernel_dyn)
// scan the spheres through two fixed levels of boxes instead of row by
// row: the spheres in the Morton order of their centres (10 bits an axis
// in the centres' bounds, ties by row), leaves of walk::LEAF = 8 spheres,
// top nodes of walk::FAN = 8 leaves. A closest-hit or shadow scan tests the
// top boxes, the leaf boxes of each top node it enters and the spheres of
// each leaf it enters, a box only while the ray reaches it before the best
// t so far (closest hit) or t_max (shadow); a warp runs a node's work once
// for all its lanes that enter it. Every sphere test is sphere_t as the
// linear scan runs it; the winner is the least (t, row), as the scan in
// row order finds it, and Hit.prim its row, so K3's rays are bit for bit
// the linear scan's (K1's nee fed the same light table, the tests'
// oracle). A scene of at most 8 spheres is one leaf: the linear scan, no
// box and no build.
//
// Where it is built: in each block's prologue, from the tables the block
// has just staged, before the light table (its sort's scratch is the
// table's rows); past SMEM_CAP by stage_tables_dyn's last block, from the
// tables' own rows, into device memory after the layout. A session edits
// the tables in place every frame (RenderSession.update_scene), so a
// hierarchy built anywhere else could lag an edit; built in the launch, a
// frame is always walked on its own tables, for a sort of the block's
// (each row's rank in (code, row) order, n compares a row) and no launch.
//
// Why the boxes cull nothing that could win: sphere_t rounds. Its
// discriminant is off by up to about 20 ulp of |o - c|^2, so a ray whose
// exact line misses a sphere can still get a finite t, at a point up to
// 1.2e-3 |o - c| outside it (the worst over 4e7 grazing rays at 1 to 3000
// units was 6.7e-4). So the box test tests a cone about the ray, its
// radius growing by walk::CONE |d|_1 = 2^-8 |d|_1 a unit of t (3.3x that
// bound), against boxes padded by 2^-8 of each sphere's radius (|o - c| <=
// t |d| + r) and 2^-20 of their coordinates (their corners' own
// rounding); per axis its bounds on t come from the cone's two face
// slopes, and an axis the ray crosses slower than the cone widens bounds
// nothing. Any t that sphere_t returns thus lies in the cone's interval
// in each box around the sphere, and a box is entered while that
// interval starts at or before the limit: a tie in t is still tested.
// The walk never culls on tmin; a degenerate direction tests no sphere,
// for which sphere_t returns +inf.
//
// What bounds K3 now (PERF.md): its two walks. At sphere_grid(512) a
// lane's closest-hit scan tests about 9 spheres and 15 boxes, but a warp
// runs about 45 and 27 for its lanes (their rays part ways: divergence),
// and the shadow walk runs beside it. The light table no longer weighs:
// emission_pickup reads the hit's own row and sample_light's pick
// searches the cum column in about log2(rows) reads (pick_row), where
// each looped over all 514 rows.
//
// The SDF arithmetic rounds every operation on its own (__fmul_rn,
// __fadd_rn, __fsqrt_rn, __fdiv_rn), whatever -fmad says: the tetrahedron
// normal differences distances about 1e-4 apart, so it amplifies a
// contracted ulp of the march by about 1e3.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "light_table.cuh"

// The block's dynamic shared memory: the scene's tables, staged once per
// block in the layout of `layout`.
extern __shared__ __align__(16) float cornelis_smem[];

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

// Table row widths in device memory (scene/compile.py).
constexpr int SPHERE_COLS = 5, PLANE_COLS = 9, MATERIAL_COLS = 11;
constexpr int SDF_COLS = 19;  // kind, c xyz, p0..p3, material, R (9), scale

constexpr int BLOCK = 128;
constexpr unsigned FULL = 0xffffffffu;
// Rays a block claims from the launch's counter at a time: two per thread,
// so a block that claims the last range idles at most two paths' time.
constexpr unsigned CHUNK = 2 * BLOCK;
// The most shared memory a block stages the tables into (64 KB: a scene of
// up to about 2,500 spheres; sphere_grid(512)'s 513 spheres take 10 KB);
// above 48 KB the launch raises the kernel's dynamic shared-memory limit.
// Larger tables are staged once per launch in device memory and read from
// there through L1.
constexpr int SMEM_CAP = 64 * 1024;
constexpr int SMEM_DEFAULT = 48 * 1024;
// The tables' expanded layout: a header (camera 12 floats, the NEE clamp
// base, and in K3 its table's CUM_ORDERED flag), then each table at a
// 16-byte aligned offset. A plane row is four
// float4: (n, w), (point, h), (t, material), (b, 0) with (t, b) its
// construct_basis tangents; an SDF row five: (kind, c), (p0..p3),
// (material, R0..R2), (R3..R6), (R7, R8, scale, 1/scale); spheres are
// float4 (c, r) rows followed by their materials.
constexpr int HEADER = 16;
// The header's float that K3's table build sets to 1 where its cum column
// never falls (light_table::build), else 0; K1 leaves it unwritten.
constexpr int CUM_ORDERED = 13;
constexpr int PLANE_ROW = 16, SDF_ROW = 20;  // floats of a plane and an SDF row in it

// Blocks per SM that each instantiation's __launch_bounds__ asks for: the
// most at which ptxas spills nothing (65536 registers / 128 threads /
// blocks: 8 -> 64 registers, 7 -> 72, 5 -> 96), from its measured
// registers (PERF.md). IDS: the launch reads its pixels from a list; at 8
// blocks path/uniform with SDFs then spills 8 B, at 7 (72 registers) none.
template <bool NEE, bool SOBOL, bool SDF, bool IDS>
struct MinBlocks {
  static constexpr int value = NEE ? 5 : (SOBOL && !SDF ? 7 : (IDS && SDF && !SOBOL ? 7 : 8));
};

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

// ---- the launch ------------------------------------------------------------

// One table of the scene: `n` rows in device memory, and where the rows
// start in the expanded layout, in floats.
struct Table {
  const float* rows;
  int n;
  int at;
};

// Everything a launch reads, passed by value as a __grid_constant__: the
// kernel reads it from the parameter bank, so it holds no registers and is
// never copied to local memory.
struct Launch {
  Table spheres, planes, materials, sdfs, lights;
  const float* tables;   // the expanded layout in device memory, or null: in shared memory
  const float* camera;
  const float* clamp;  // mode "nee": the clamp base
  const uint32_t* pixel_ids;  // ray k's pixel is pixel_ids[k / spp_chunk]; null: k / spp_chunk
  float* out;
  unsigned* counter;  // rays claimed so far; zeroed by the launch
  unsigned n_rays;
  uint32_t k0, k1, root;
  int width;
  float inv_width, inv_height;
  unsigned spp_chunk;
  uint32_t sample_offset;
  int max_depth, index_bits;
};

// The expanded layout of the tables, which every read goes through: in the
// block's shared memory, or (when it is larger than SMEM_CAP) in device
// memory, staged by stage_tables. One layout and one pointer, so no read
// chooses between two.
__device__ __forceinline__ const float* tables(const Launch& L) {
  return L.tables != nullptr ? L.tables : cornelis_smem;
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// Sphere s: (center, radius), and its material.
__device__ __forceinline__ float4 sphere_cr(const Launch& L, int s) {
  return ld4(tables(L) + L.spheres.at + 4 * s);
}
__device__ __forceinline__ int sphere_mid(const Launch& L, int s) {
  return (int)tables(L)[L.spheres.at + 4 * L.spheres.n + s];
}

struct PlaneRow {
  V3 n, point, t, b;
  float w, h;
};

__device__ __forceinline__ PlaneRow plane_row(const Launch& L, int j) {
  const float* q = tables(L) + L.planes.at + PLANE_ROW * j;
  const float4 a = ld4(q), b = ld4(q + 4), c = ld4(q + 8), e = ld4(q + 12);
  PlaneRow p;
  p.n = v3(a.x, a.y, a.z);
  p.w = a.w;
  p.point = v3(b.x, b.y, b.z);
  p.h = b.w;
  p.t = v3(c.x, c.y, c.z);
  p.b = v3(e.x, e.y, e.z);
  return p;
}
__device__ __forceinline__ int plane_mid(const Launch& L, int j) {
  return (int)tables(L)[L.planes.at + PLANE_ROW * j + 11];
}

// Float4 q (0..4) of SDF row k.
__device__ __forceinline__ float4 sdf_quad(const Launch& L, int k, int q) {
  return ld4(tables(L) + L.sdfs.at + SDF_ROW * k + 4 * q);
}

__device__ __forceinline__ float material(const Launch& L, int i) {
  return tables(L)[L.materials.at + i];
}

__device__ __forceinline__ float light(const Launch& L, int row, int col) {
  return tables(L)[L.lights.at + LIGHT_COLS * row + col];
}

// Writes the expanded layout of the tables to `dst`, thread `tid` of
// `threads` taking its share: the header, plane rows with their
// construct_basis tangents, SDF rows with 1/scale, materials, lights, and
// the spheres as float4 (c, r) rows and then their materials. DYN: the
// launch builds K3's light table and clamp base itself (light_table.cuh),
// so neither is copied.
template <bool NEE, bool DYN>
__device__ __forceinline__ void expand(float* dst, const Launch& L, int tid, int threads) {
  if (tid < 12) dst[tid] = __ldg(L.camera + tid);
  if (tid == 12 && !DYN) dst[12] = (NEE && L.lights.n > 0) ? __ldg(L.clamp) : 0.0f;
  for (int j = tid; j < L.planes.n; j += threads) {
    const float* r = L.planes.rows + PLANE_COLS * j;
    const V3 n = v3(__ldg(r), __ldg(r + 1), __ldg(r + 2));
    const Basis bs = construct_basis(n);
    float4* q = reinterpret_cast<float4*>(dst + L.planes.at + PLANE_ROW * j);
    q[0] = make_float4(n.x, n.y, n.z, __ldg(r + 6));
    q[1] = make_float4(__ldg(r + 3), __ldg(r + 4), __ldg(r + 5), __ldg(r + 7));
    q[2] = make_float4(bs.t.x, bs.t.y, bs.t.z, __ldg(r + 8));
    q[3] = make_float4(bs.b.x, bs.b.y, bs.b.z, 0.0f);
  }
  for (int k = tid; k < L.sdfs.n; k += threads) {
    const float* r = L.sdfs.rows + SDF_COLS * k;
    float* q = dst + L.sdfs.at + SDF_ROW * k;
    for (int i = 0; i < SDF_COLS; ++i) q[i] = __ldg(r + i);
    q[SDF_COLS] = __fdiv_rn(1.0f, __ldg(r + SDF_COLS - 1));
  }
  for (int i = tid; i < MATERIAL_COLS * L.materials.n; i += threads)
    dst[L.materials.at + i] = __ldg(L.materials.rows + i);
  if (!DYN)
    for (int i = tid; i < LIGHT_COLS * L.lights.n; i += threads)
      dst[L.lights.at + i] = __ldg(L.lights.rows + i);
  for (int s = tid; s < L.spheres.n; s += threads) {
    const float* r = L.spheres.rows + SPHERE_COLS * s;
    reinterpret_cast<float4*>(dst + L.spheres.at)[s] =
        make_float4(__ldg(r), __ldg(r + 1), __ldg(r + 2), __ldg(r + 3));
    dst[L.spheres.at + 4 * L.spheres.n + s] = __ldg(r + 4);
  }
}

// The tables as expand staged them, read by light_table::build (the
// interface of light_table::Rows).
struct StagedScene {
  const Launch& L;
  int n_spheres, n_planes, n_materials;

  __device__ __forceinline__ explicit StagedScene(const Launch& staged)
      : L(staged), n_spheres(staged.spheres.n), n_planes(staged.planes.n),
        n_materials(staged.materials.n) {}
  __device__ __forceinline__ float4 sphere(int i) const { return sphere_cr(L, i); }
  __device__ __forceinline__ float sphere_material(int i) const {
    return tables(L)[L.spheres.at + 4 * L.spheres.n + i];
  }
  __device__ __forceinline__ void plane(int j, float g[8]) const {
    const float* q = tables(L) + L.planes.at + PLANE_ROW * j;
    const float4 a = ld4(q), b = ld4(q + 4);
    g[0] = a.x, g[1] = a.y, g[2] = a.z, g[3] = b.x, g[4] = b.y, g[5] = b.z, g[6] = a.w, g[7] = b.w;
  }
  __device__ __forceinline__ float plane_material(int j) const {
    return tables(L)[L.planes.at + PLANE_ROW * j + 11];
  }
  __device__ __forceinline__ float emission(int m, int c) const {
    return material(L, MATERIAL_COLS * m + 3 + c);
  }
};

// ---- K3's sphere hierarchy --------------------------------------------------

// Two fixed levels of boxes over the spheres in the Morton order of their
// centres: leaves of LEAF spheres, top nodes of FAN leaves. Its region
// follows the spheres' rows in the layout: the top boxes, the leaf boxes
// (each 8 floats: lo xyz, 0, hi xyz, 0), then `perm`, the original row of
// each sorted position. A scene of at most LEAF spheres is one leaf: no
// region, and the walk is the linear scan.
namespace walk {

constexpr int LEAF = 8, FAN = 8;
// The cone's slack per unit of distance along the ray, over |d| (2^-8,
// 3.3x sphere_t's worst rounding, 1.2e-3 |o - c|), and each sphere box's
// padding: that share of its radius, and 2^-20 of its coordinates (the
// rounding of the box's own corners).
constexpr float CONE = 1.0f / 256.0f;
constexpr float PAD_R = 1.0f / 256.0f;
constexpr float PAD_POS = 1.0f / 1048576.0f;

__host__ __device__ __forceinline__ int leaves(int n) { return (n + LEAF - 1) / LEAF; }
__host__ __device__ __forceinline__ int tops(int n) { return (leaves(n) + FAN - 1) / FAN; }
__host__ __device__ __forceinline__ bool flat(int n) { return n <= LEAF; }
// Floats of the region for n spheres.
__host__ __device__ __forceinline__ int floats(int n) {
  return flat(n) ? 0 : 8 * (tops(n) + leaves(n)) + ((n + 3) & ~3);
}
// Where the region starts in the layout: right after the spheres' rows.
__host__ __device__ __forceinline__ int region_at(const Launch& L) {
  return L.spheres.at + ((SPHERE_COLS * L.spheres.n + 3) & ~3);
}

// 10 bits spread to every third of 30.
__device__ __forceinline__ uint32_t spread(uint32_t x) {
  x = (x | (x << 16)) & 0x030000FFu;
  x = (x | (x << 8)) & 0x0300F00Fu;
  x = (x | (x << 4)) & 0x030C30C3u;
  return (x | (x << 2)) & 0x09249249u;
}

// Builds the region at `dst` from the n spheres of `s` (anything with
// light_table::Rows's sphere(i)), thread `tid` of the block's `threads`
// (every thread of the block calls it: it holds block barriers), with
// `codes` (n words) as scratch. Each sphere's Morton code quantizes its
// centre to 10 bits an axis in the centres' bounds; its sorted position is
// the count of spheres before it in (code, row) order, so the order is a
// total one and the same in every block. The region is the block's to
// read after its next barrier.
template <class Spheres>
__device__ __forceinline__ void build(const Spheres& s, int n, float* dst, uint32_t* codes, int tid,
                                      int threads) {
  if (flat(n)) return;
  const int nl = leaves(n), nt = tops(n);
  float lo[3] = {INFINITY, INFINITY, INFINITY}, hi[3] = {-INFINITY, -INFINITY, -INFINITY};
  for (int j = 0; j < n; ++j) {
    const float4 c = s.sphere(j);
    const float cs[3] = {c.x, c.y, c.z};
#pragma unroll
    for (int a = 0; a < 3; ++a) lo[a] = fminf(lo[a], cs[a]), hi[a] = fmaxf(hi[a], cs[a]);
  }
  float scale[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float extent = hi[a] - lo[a];
    scale[a] = extent > 0.0f && extent < INFINITY ? 1023.0f / extent : 0.0f;
  }
  for (int i = tid; i < n; i += threads) {
    const float4 c = s.sphere(i);
    const float cs[3] = {c.x, c.y, c.z};
    uint32_t q[3];
#pragma unroll
    for (int a = 0; a < 3; ++a)  // a NaN centre lands at 0
      q[a] = (uint32_t)fminf(fmaxf((cs[a] - lo[a]) * scale[a], 0.0f), 1023.0f);
    codes[i] = (spread(q[0]) << 2) | (spread(q[1]) << 1) | spread(q[2]);
  }
  __syncthreads();
  int* perm = reinterpret_cast<int*>(dst + 8 * (nt + nl));
  for (int i = tid; i < n; i += threads) {
    const uint32_t ci = codes[i];
    int rank = 0;
    for (int j = 0; j < n; ++j) {
      const uint32_t cj = codes[j];
      rank += (cj < ci || (cj == ci && j < i)) ? 1 : 0;
    }
    perm[rank] = i;
  }
  __syncthreads();
  // Leaf boxes: each sphere's box padded so that no rounded hit of
  // sphere_t lies outside it but for the cone's slack (see the note at
  // the head of this file); a NaN row adds nothing, and cannot hit.
  for (int l = tid; l < nl; l += threads) {
    float blo[3] = {INFINITY, INFINITY, INFINITY}, bhi[3] = {-INFINITY, -INFINITY, -INFINITY};
    const int end = min(n, (l + 1) * LEAF);
    for (int i = l * LEAF; i < end; ++i) {
      const float4 c = s.sphere(perm[i]);
      const float r = fabsf(c.w);
      const float big = fmaxf(fmaxf(fabsf(c.x), fabsf(c.y)), fmaxf(fabsf(c.z), r));
      const float e = r + r * PAD_R + big * PAD_POS;
      const float cs[3] = {c.x, c.y, c.z};
#pragma unroll
      for (int a = 0; a < 3; ++a) blo[a] = fminf(blo[a], cs[a] - e), bhi[a] = fmaxf(bhi[a], cs[a] + e);
    }
    float4* box = reinterpret_cast<float4*>(dst + 8 * (nt + l));
    box[0] = make_float4(blo[0], blo[1], blo[2], 0.0f);
    box[1] = make_float4(bhi[0], bhi[1], bhi[2], 0.0f);
  }
  __syncthreads();
  for (int c = tid; c < nt; c += threads) {
    float4 tlo = make_float4(INFINITY, INFINITY, INFINITY, 0.0f);
    float4 thi = make_float4(-INFINITY, -INFINITY, -INFINITY, 0.0f);
    const int end = min(nl, (c + 1) * FAN);
    for (int l = c * FAN; l < end; ++l) {
      const float4* box = reinterpret_cast<const float4*>(dst + 8 * (nt + l));
      tlo = make_float4(fminf(tlo.x, box[0].x), fminf(tlo.y, box[0].y), fminf(tlo.z, box[0].z), 0.0f);
      thi = make_float4(fmaxf(thi.x, box[1].x), fmaxf(thi.y, box[1].y), fmaxf(thi.z, box[1].z), 0.0f);
    }
    float4* box = reinterpret_cast<float4*>(dst + 8 * c);
    box[0] = tlo;
    box[1] = thi;
  }
}

}  // namespace walk

// Stages the expanded layout in device memory (L.tables) for a launch whose
// tables are larger than SMEM_CAP. DYN: block 0 also builds the light
// table and clamp base there, and the last block the sphere hierarchy,
// each from the tables' own rows, while the other blocks expand the rest;
// the megakernel that follows on the stream reads them. The hierarchy's
// scratch lies past the layout's end.
template <bool NEE, bool DYN>
__device__ __forceinline__ void stage(const Launch& L) {
  float* dst = const_cast<float*>(L.tables);
  expand<NEE, DYN>(dst, L, blockIdx.x * BLOCK + threadIdx.x, gridDim.x * BLOCK);
  if (DYN) {
    const light_table::Rows scene{L.spheres.rows, L.spheres.n,   L.planes.rows,
                                  L.planes.n,     L.materials.rows, L.materials.n};
    if (blockIdx.x == 0)
      light_table::build(scene, dst + L.lights.at, dst + 12, threadIdx.x, BLOCK,
                         dst + CUM_ORDERED);
    if (blockIdx.x == gridDim.x - 1) {
      float* region = dst + walk::region_at(L);
      walk::build(scene, L.spheres.n, region,
                  reinterpret_cast<uint32_t*>(region + walk::floats(L.spheres.n)), threadIdx.x,
                  BLOCK);
    }
  }
}

template <bool NEE>
__global__ void __launch_bounds__(BLOCK) stage_tables(const __grid_constant__ Launch L) {
  stage<NEE, false>(L);
}

// ---- the block's share of the launch's rays ---------------------------------

// The block's current range of rays, (next << 32) | end, and whether the
// launch's rays are all claimed.
__shared__ unsigned long long block_range;
__shared__ int block_done;

constexpr unsigned long long EXHAUSTED = 0x8000000000000000ull;  // next 2^31 > end 0

// Claims CHUNK rays from the launch's counter, of which the caller keeps
// the first `keep` (at most the range): sets the block's range to the rest,
// or marks the block done when nothing is left after them. Returns the
// range's first index and sets `kept`.
__device__ __forceinline__ unsigned claim(const Launch& L, unsigned keep, unsigned& kept) {
  const unsigned g = atomicAdd(L.counter, CHUNK);
  const unsigned end = g < L.n_rays ? min(g + CHUNK, L.n_rays) : g;
  kept = min(keep, end - g);
  if (g + kept >= end) {
    // Nothing is left in this range, and a range shorter than CHUNK is the
    // launch's last: no later claim gets a ray.
    atomicExch(&block_range, EXHAUSTED);
    *(volatile int*)&block_done = 1;
  } else {
    atomicExch(&block_range, ((unsigned long long)(g + kept) << 32) | end);
  }
  return g;
}

// Up to `want` rays for the calling warp, as two runs of consecutive
// indices: (x, y) = (first, count) from the block's range and (z, w) from a
// range claimed when this warp took the last ray of the block's. Both
// counts are 0 while another warp claims the next range, and once the
// launch's rays are all taken. One atomic on shared memory per call; every
// index in a range goes to exactly one warp.
__device__ __forceinline__ uint4 take(const Launch& L, unsigned want) {
  const unsigned long long old = atomicAdd(&block_range, (unsigned long long)want << 32);
  const unsigned next = (unsigned)(old >> 32), end = (unsigned)old;
  uint4 r = make_uint4(next, 0u, 0u, 0u);
  if (next >= end) return r;
  r.y = min(want, end - next);
  if (next + want < end) return r;
  r.z = claim(L, want - r.y, r.w);
  return r;
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

// One ray's draw keys: its pixel and sample, and the Sobol pixel seed.
struct Draws {
  uint32_t pixel, sample, seed;
};

template <bool SOBOL>
__device__ __forceinline__ void draw_pair(const Launch& L, const Draws& s, uint32_t stream,
                                          uint32_t pair, float& u0, float& u1) {
  if constexpr (SOBOL) {
    sobol_pair(s.seed, s.sample, stream, pair, L.index_bits, u0, u1);
  } else {
    pair_uniforms(L.k0, L.k1, s.pixel, s.sample, stream, pair, u0, u1);
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
__device__ __forceinline__ float sphere_t(float4 sp, V3 o, V3 d, const RayPre& pre) {
  V3 rel = o - v3(sp.x, sp.y, sp.z);
  float r = sp.w;
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

// geometry.py::plane_candidate: t (+inf on a miss) and the point at t.
__device__ __forceinline__ float plane_t(const PlaneRow& pl, V3 o, V3 d, const RayPre& pre,
                                         V3& p) {
  V3 diff = o - pl.point;
  float pa = -dot(diff, pl.n);
  float pb = dot(d, pl.n);
  bool on_anchor = diff.x == 0.0f && diff.y == 0.0f && diff.z == 0.0f;
  bool b_zero = almost_zero(pb);
  bool parallel_miss = !on_anchor && b_zero;
  float safe_b = b_zero ? 1.0f : pb;
  float t = b_zero ? 0.0f : pa / safe_b;
  bool backward = t < pre.tmin;
  p = o + d * t;
  V3 in_plane = p - pl.point;
  bool outside = (fabsf(dot(in_plane, pl.t)) * 2.0f > pl.w) ||
                 (fabsf(dot(in_plane, pl.b)) * 2.0f > pl.h);
  const bool valid = !pre.deg && !parallel_miss && !backward && !outside;
  return valid ? t : INFINITY;
}

// ---- geometry.py: SDF primitives ------------------------------------------

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

// geometry.py::sdf_distance of local point q, the kind's formula only; p
// holds the row's p0..p3.
__device__ __forceinline__ float sdf_distance(int kind, float4 p, V3 q) {
  if (kind == SDF_KIND_SPHERE) {
    return sub_rn(__fsqrt_rn(jmax(mag2_rn(q), FLOOR_20)), p.x);
  }
  if (kind == SDF_KIND_BOX) {
    const float ax = sub_rn(fabsf(q.x), p.x);
    const float ay = sub_rn(fabsf(q.y), p.y);
    const float az = sub_rn(fabsf(q.z), p.z);
    const float mx = jmax(ax, 0.0f), my = jmax(ay, 0.0f), mz = jmax(az, 0.0f);
    const float outside = __fsqrt_rn(add_rn(add_rn(mul_rn(mx, mx), mul_rn(my, my)), mul_rn(mz, mz)));
    const float inside = jmin(jmax(ax, jmax(ay, az)), 0.0f);
    return add_rn(outside, inside);
  }
  // torus about the local y axis
  const float ring = sub_rn(__fsqrt_rn(jmax(add_rn(mul_rn(q.x, q.x), mul_rn(q.z, q.z)), FLOOR_20)), p.x);
  return sub_rn(__fsqrt_rn(jmax(add_rn(mul_rn(ring, ring), mul_rn(q.y, q.y)), FLOOR_20)), p.y);
}

// World point p of SDF row k -> object frame: R (p - c), then * (1 / s).
__device__ __forceinline__ V3 sdf_to_local(const Launch& L, int k, V3 p) {
  const float4 q0 = sdf_quad(L, k, 0), q2 = sdf_quad(L, k, 2), q3 = sdf_quad(L, k, 3),
               q4 = sdf_quad(L, k, 4);
  const V3 w = sub_rn(p, v3(q0.y, q0.z, q0.w));
  return v3(mul_rn(row3_rn(q2.y, q2.z, q2.w, w), q4.w), mul_rn(row3_rn(q3.x, q3.y, q3.z, w), q4.w),
            mul_rn(row3_rn(q3.w, q4.x, q4.y, w), q4.w));
}

// The distance of world point p to SDF row k, in world units.
__device__ __forceinline__ float sdf_world_dist(const Launch& L, int k, int kind, V3 p) {
  return mul_rn(sdf_distance(kind, sdf_quad(L, k, 1), sdf_to_local(L, k, p)), sdf_quad(L, k, 4).z);
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

// geometry.py::sdf_candidate's march, stopped once it reaches `limit`, a t
// in the ray's own parameterization: the world-unit t at which it stops,
// and whether that is a hit. A thread leaves at convergence or escape; the
// TPU's frozen lanes kept exactly this t.
//
// The stop is exact. The caller takes a hit only at a t_world whose
// __fdiv_rn(t_world, |d|) is below `limit` (`best_t > t`, `t < t_max`).
// lim_w = limit * |d| rounded up is at least the exact product, so any
// t_world >= lim_w has t_world / |d| >= limit exactly and, __fdiv_rn being
// monotone, a rounded quotient >= limit: no use. t rises strictly at every
// step (by at least 0.5 eps > 0), so a march stopped at its first t >=
// lim_w could only have ended at such a t; a march that ends below lim_w
// ends where the full march does.
__device__ __forceinline__ float sdf_march(const Launch& L, int k, int kind, V3 o,
                                           const SdfRay& r, float limit, bool& valid) {
  const float lim_w = __fmul_ru(limit, r.dlen);
  float t = 0.0f;
  bool hit = false;
  int i = 0;
  for (; i < SPHERE_TRACE_STEPS; ++i) {
    if (t >= lim_w) break;
    const float dist = sdf_world_dist(L, k, kind, ray_at_rn(o, r.dn, t));
    const float eps = sdf_eps(t);
    if (fabsf(dist) < eps) {
      hit = true;
      break;
    }
    if (t > SDF_MAX_T) break;
    t = add_rn(t, jmax(dist, mul_rn(0.5f, eps)));
  }
  if (i == SPHERE_TRACE_STEPS && t < lim_w)
    hit = fabsf(sdf_world_dist(L, k, kind, ray_at_rn(o, r.dn, t))) < sdf_eps(t);
  valid = hit && !r.deg && t > r.lim && t <= SDF_MAX_T;
  return t;
}

// geometry.py::sdf_normal at the world point p of SDF row k, the march
// stopped at t: the 4-tap tetrahedron gradient in the object frame (spacing
// eps / s), normalized, rotated back to world.
__device__ __forceinline__ V3 sdf_normal(const Launch& L, int k, int kind, V3 p, float t) {
  const float4 prm = sdf_quad(L, k, 1), q2 = sdf_quad(L, k, 2), q3 = sdf_quad(L, k, 3),
               q4 = sdf_quad(L, k, 4);
  const float h = __fdiv_rn(sdf_eps(t), q4.z);
  const V3 q = sdf_to_local(L, k, p);
  const float t0 = sdf_distance(kind, prm, v3(add_rn(q.x, h), sub_rn(q.y, h), sub_rn(q.z, h)));
  const float t1 = sdf_distance(kind, prm, v3(sub_rn(q.x, h), sub_rn(q.y, h), add_rn(q.z, h)));
  const float t2 = sdf_distance(kind, prm, v3(sub_rn(q.x, h), add_rn(q.y, h), sub_rn(q.z, h)));
  const float t3 = sdf_distance(kind, prm, v3(add_rn(q.x, h), add_rn(q.y, h), add_rn(q.z, h)));
  V3 g = v3(add_rn(sub_rn(sub_rn(t0, t1), t2), t3), add_rn(add_rn(sub_rn(-t0, t1), t2), t3),
            add_rn(sub_rn(add_rn(-t0, t1), t2), t3));
  // math/vec.py normalize, rounded as torch rounds it.
  const float m2 = mag2_rn(g);
  const bool zero = m2 < RAY_EPSILON2;
  const float s = zero ? 0.0f : __fdiv_rn(1.0f, __fsqrt_rn(zero ? 1.0f : m2));
  g = v3(mul_rn(g.x, s), mul_rn(g.y, s), mul_rn(g.z, s));
  // R^T g, R = (R0 R1 R2; R3 R4 R5; R6 R7 R8)
  return v3(row3_rn(q2.y, q3.x, q3.w, g), row3_rn(q2.z, q3.y, q4.x, g),
            row3_rn(q2.w, q3.z, q4.y, g));
}

// ---- K3's walk of the sphere hierarchy --------------------------------------

// What the walk tested and which light-table rows K3 read, in the counting
// build (CORNELIS_WALK_COUNTS) only: per lane, and per warp (the warp runs
// a test once for all its lanes that take it). The production build counts
// nothing.
#ifdef CORNELIS_WALK_COUNTS
// Per scan kind (0 closest hit, 1 shadow): the lanes' scans, sphere tests
// and box tests, then the warps' scans, sphere tests and box tests. Then
// per light-table read (0 emission_pickup, 1 sample_light's pick): the
// lanes' calls and the rows they read, then the warps' calls and rows (the
// most rows a lane of the warp read in the call: the steps the warp ran).
__device__ unsigned long long walk_counts[20];

struct Tally {
  unsigned spheres = 0, boxes = 0, warp_spheres = 0, warp_boxes = 0;
  __device__ __forceinline__ static bool first_lane() {
    return (int)(threadIdx.x & 31u) == __ffs(__activemask()) - 1;
  }
  __device__ __forceinline__ void sphere() { ++spheres, warp_spheres += first_lane(); }
  __device__ __forceinline__ void box() { ++boxes, warp_boxes += first_lane(); }
  __device__ __forceinline__ void flush(int kind) {
    const unsigned mask = __activemask();
    const bool leader = first_lane();
    const unsigned v[6] = {1u, spheres, boxes, leader ? 1u : 0u, warp_spheres, warp_boxes};
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const unsigned sum = __reduce_add_sync(mask, v[i]);
      if (leader) atomicAdd(&walk_counts[6 * kind + i], (unsigned long long)sum);
    }
  }
};

struct RowTally {
  unsigned rows = 0;
  __device__ __forceinline__ void row() { ++rows; }
  __device__ __forceinline__ void flush(int site) {
    const unsigned mask = __activemask();
    const bool leader = Tally::first_lane();
    const unsigned lanes = __reduce_add_sync(mask, 1u), sum = __reduce_add_sync(mask, rows);
    const unsigned most = __reduce_max_sync(mask, rows);
    unsigned long long* c = walk_counts + 12 + 4 * site;
    if (leader) {
      atomicAdd(c, (unsigned long long)lanes);
      atomicAdd(c + 1, (unsigned long long)sum);
      atomicAdd(c + 2, 1ull);
      atomicAdd(c + 3, (unsigned long long)most);
    }
  }
};
#else
struct Tally {
  __device__ __forceinline__ void sphere() {}
  __device__ __forceinline__ void box() {}
  __device__ __forceinline__ void flush(int) {}
};

struct RowTally {
  __device__ __forceinline__ void row() {}
  __device__ __forceinline__ void flush(int) {}
};
#endif

// A ray as the walk's box test sees it: a cone about o + t d whose radius
// grows by CONE |d|_1 a unit of t. Per axis, the reciprocals of its two
// faces' slopes d_i + s and d_i - s, NaN where |d_i| <= s (the axis then
// bounds nothing: the cone widens along it faster than the ray moves).
struct Cone {
  V3 o;
  float a[3], b[3];
  bool pos[3];
};

__device__ __forceinline__ Cone cone(V3 o, V3 d) {
  Cone k;
  k.o = o;
  const float s = walk::CONE * (fabsf(d.x) + fabsf(d.y) + fabsf(d.z));
  const float ds[3] = {d.x, d.y, d.z};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const bool bounds = ds[i] > s || ds[i] < -s;
    k.a[i] = bounds ? __frcp_rn(ds[i] + s) : __int_as_float(0x7fc00000);
    k.b[i] = bounds ? __frcp_rn(ds[i] - s) : __int_as_float(0x7fc00000);
    k.pos[i] = ds[i] > 0.0f;
  }
  return k;
}

// Whether the cone meets the box at some t in [0, limit]: per axis the
// lower face gives t (d_i + s) >= lo_i - o_i and the upper t (d_i - s) <=
// hi_i - o_i, a lower and an upper bound on t by the sign of d_i. fmaxf
// and fminf drop a NaN bound, so `near` and `far` are never NaN.
__device__ __forceinline__ bool enters(const float* box, const Cone& k, float limit) {
  const float4 lo = ld4(box), hi = ld4(box + 4);
  const float los[3] = {lo.x, lo.y, lo.z}, his[3] = {hi.x, hi.y, hi.z};
  const float os[3] = {k.o.x, k.o.y, k.o.z};
  float near = 0.0f, far = INFINITY;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float x = (los[i] - os[i]) * k.a[i], y = (his[i] - os[i]) * k.b[i];
    near = fmaxf(near, k.pos[i] ? x : y);
    far = fminf(far, k.pos[i] ? y : x);
  }
  return near <= far && near <= limit;
}

// Calls visit(s) on the spheres s whose boxes the ray (o, d) enters below
// `limit`, a bound the visits may lower (the best t so far), until a visit
// returns true; returns whether one did. The top boxes, each top node's
// leaf boxes and each leaf's spheres are taken in the region's order; a
// warp runs a node's work once for all its lanes that enter it. A scene of
// one leaf visits every sphere in row order, with no box test.
template <class Visit>
__device__ __forceinline__ bool walk_spheres(const Launch& L, V3 o, V3 d, const float& limit,
                                             Tally& tally, Visit visit) {
  const int n = L.spheres.n;
  if (walk::flat(n)) {
    for (int s = 0; s < n; ++s) {
      tally.sphere();
      if (visit(s)) return true;
    }
    return false;
  }
  const int nl = walk::leaves(n), nt = walk::tops(n);
  const float* region = tables(L) + walk::region_at(L);
  const int* perm = reinterpret_cast<const int*>(region + 8 * (nt + nl));
  const Cone k = cone(o, d);
  for (int c = 0; c < nt; ++c) {
    tally.box();
    if (!enters(region + 8 * c, k, limit)) continue;
    const int l_end = min(nl, (c + 1) * walk::FAN);
    for (int l = c * walk::FAN; l < l_end; ++l) {
      tally.box();
      if (!enters(region + 8 * (nt + l), k, limit)) continue;
      const int i_end = min(n, (l + 1) * walk::LEAF);
      for (int i = l * walk::LEAF; i < i_end; ++i) {
        tally.sphere();
        if (visit(perm[i])) return true;
      }
    }
  }
  return false;
}

struct Hit {
  float t;
  V3 p, n;
  int mid;
  int prim;  // sphere i -> i, plane j -> n_spheres + j, SDF or miss -> -1
  bool hit;
};

// pallas_integrator.py::_intersect_const over the tables: a t-only sphere
// scan, the planes, then (SDF) the SDF marches, each stopped at the best t
// so far. Updates are on a strict best_t > t, so the first object wins a
// tie, a sphere wins a tie against a plane and a plane against an SDF. The
// scans carry only the best t and the winner; its point, normal and
// material are taken once, after them, by the same expressions. DYN: the
// spheres are walked through K3's hierarchy, which tests them out of row
// order, so a tie in t goes to the lower row explicitly: the winner is the
// least (t, row), as the scan in row order finds it.
template <bool SDF, bool DYN>
__device__ __forceinline__ Hit intersect(const Launch& L, V3 o, V3 d) {
  const RayPre pre = ray_pre(o, d);
  const int n_sp = L.spheres.n + L.planes.n;  // an SDF k wins as n_sp + k

  float best_t = INFINITY;
  int best = -1;
  if constexpr (DYN) {
    Tally tally;
    if (!pre.deg) {  // a degenerate ray hits no sphere
      walk_spheres(L, o, d, best_t, tally, [&](int s) {
        const float t = sphere_t(sphere_cr(L, s), o, d, pre);
        if (best_t > t || (best_t == t && s < best)) {
          best_t = t;
          best = s;
        }
        return false;
      });
    }
    tally.flush(0);
  } else {
    for (int s = 0; s < L.spheres.n; ++s) {
      const float t = sphere_t(sphere_cr(L, s), o, d, pre);
      if (best_t > t) {
        best_t = t;
        best = s;
      }
    }
  }
  for (int j = 0; j < L.planes.n; ++j) {
    V3 p;
    const float t = plane_t(plane_row(L, j), o, d, pre, p);
    if (best_t > t) {
      best_t = t;
      best = L.spheres.n + j;
    }
  }
  SdfRay r;
  float best_tw = 0.0f;  // the winning SDF's march t, in world units
  if constexpr (SDF) {
    r = sdf_ray(o, d);
    // A degenerate ray never hits an SDF: skip its marches.
    for (int k = 0; k < L.sdfs.n && !r.deg; ++k) {
      bool valid;
      const float tw = sdf_march(L, k, (int)sdf_quad(L, k, 0).x, o, r, best_t, valid);
      const float t = valid ? __fdiv_rn(tw, r.dlen) : INFINITY;
      if (best_t > t) {
        best_t = t;
        best = n_sp + k;
        best_tw = tw;
      }
    }
  }

  Hit h;
  h.t = best_t;
  h.hit = best >= 0;
  h.prim = best < n_sp ? best : -1;  // an SDF is not light-sampled: MIS weight 1
  h.p = v3(0.0f, 0.0f, 0.0f);
  h.n = v3(0.0f, 0.0f, 0.0f);
  h.mid = 0;
  if (best >= n_sp) {
    const int k = best - n_sp;
    h.p = ray_at_rn(o, r.dn, best_tw);
    h.n = sdf_normal(L, k, (int)sdf_quad(L, k, 0).x, h.p, best_tw);
    h.mid = (int)sdf_quad(L, k, 2).x;
  } else if (best >= L.spheres.n) {
    const int j = best - L.spheres.n;
    h.p = o + d * best_t;
    h.n = plane_row(L, j).n;
    h.mid = plane_mid(L, j);
  } else if (best >= 0) {
    const float4 sp = sphere_cr(L, best);
    h.p = o + d * best_t;
    h.n = normalize(h.p - v3(sp.x, sp.y, sp.z));
    h.mid = sphere_mid(L, best);
  }
  return h;
}

// pallas_integrator.py::_occluded_const: any hit closer than t_max; each
// SDF march stops at t_max. DYN: the spheres through K3's hierarchy.
template <bool SDF, bool DYN>
__device__ __forceinline__ bool occluded(const Launch& L, V3 o, V3 d, float t_max) {
  const RayPre pre = ray_pre(o, d);
  if constexpr (DYN) {
    Tally tally;
    const bool blocked = !pre.deg && walk_spheres(L, o, d, t_max, tally, [&](int s) {
      return sphere_t(sphere_cr(L, s), o, d, pre) < t_max;
    });
    tally.flush(1);
    if (blocked) return true;
  } else {
    for (int s = 0; s < L.spheres.n; ++s) {
      if (sphere_t(sphere_cr(L, s), o, d, pre) < t_max) return true;
    }
  }
  for (int j = 0; j < L.planes.n; ++j) {
    V3 p;
    if (plane_t(plane_row(L, j), o, d, pre, p) < t_max) return true;
  }
  if constexpr (SDF) {
    const SdfRay r = sdf_ray(o, d);
    for (int k = 0; k < L.sdfs.n && !r.deg; ++k) {
      bool valid;
      const float tw = sdf_march(L, k, (int)sdf_quad(L, k, 0).x, o, r, t_max, valid);
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

__device__ __forceinline__ Material load_material(const Launch& L, int mid) {
  const int m = MATERIAL_COLS * mid;
  Material mp;
  mp.albedo = v3(material(L, m), material(L, m + 1), material(L, m + 2));
  mp.emission = v3(material(L, m + 3), material(L, m + 4), material(L, m + 5));
  mp.tint = v3(material(L, m + 6), material(L, m + 7), material(L, m + 8));
  mp.roughness = material(L, m + 9);
  mp.ior = material(L, m + 10);
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

__device__ __forceinline__ V3 glossy_eval(V3 wi, V3 wo, V3 n, V3 tint, float alpha, float ior) {
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

__device__ __forceinline__ float glossy_pdf(V3 wi, V3 wo, V3 n, float alpha) {
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
__device__ __forceinline__ V3 oren_nayar_eval(V3 wi, V3 wo, V3 albedo, float sigma) {
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

__device__ __forceinline__ V3 layered_eval(V3 wi, V3 wo, V3 n, const Material& mp) {
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
__device__ __forceinline__ void layered_sample(V3 wo, float x0, float x1, float x2,
                                               const Basis& bs, const Material& mp, V3& wi,
                                               float& pdf, V3& f) {
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

// integrator.py::nee_clamp_at_depth: base x (1/RR_BASE)^max(depth - 3, 0).
__device__ __forceinline__ float clamp_at_depth(float base, int depth) {
  const int excess = depth > RR_YOUNG_DEPTH ? depth - RR_YOUNG_DEPTH : 0;
  return base * expf((float)excess * LOG_INV_RR);
}

// The density with which light sampling picks row r's emitter, for a
// BSDF-sampled ray from o along d that hit it at distance t.
__device__ __forceinline__ float pickup_density(const Launch& L, int r, V3 o, V3 d, float t) {
  const float pr = light(L, r, COL_PROB);
  const float g0 = light(L, r, COL_G), g1 = light(L, r, COL_G + 1), g2 = light(L, r, COL_G + 2);
  if (light(L, r, COL_KIND) < 0.5f) {
    const float dx = g0 - o.x, dy = g1 - o.y, dz = g2 - o.z;
    const float d2 = dx * dx + dy * dy + dz * dz;
    const float sin2max = jmin(jmax(light(L, r, COL_R2) / jmax(d2, FLOOR_12), 0.0f), 1.0f);
    const float cos_max = sqrtf(jmax(1.0f - sin2max, 0.0f));
    const float cand = pr / (TWO_PI * jmax(1.0f - cos_max, FLOOR_9));
    return d2 > light(L, r, COL_R2_EDGE) ? cand : 0.0f;
  }
  // Area -> solid angle at the hit distance: pr t^2 / (A |cos|).
  const float cos_l = fabsf(d.x * g0 + d.y * g1 + d.z * g2);
  return pr * t * t / (light(L, r, COL_AREA) * jmax(cos_l, FLOOR_6));
}

// The density with which light sampling picks the emitter a BSDF-sampled
// ray from o along d hit at distance t (prim), 0 off the table. DYN: K3's
// table holds prim r in row r (light_table::row_of), one row a prim, so
// the hit's own row is read. K1's host table drops zero-power rows, so its
// rows are scanned as the JAX select chain is: the last row of that prim
// wins.
template <bool DYN>
__device__ __forceinline__ float emission_pickup(const Launch& L, V3 o, V3 d, float t, int prim) {
  RowTally tally;
  float p_light = 0.0f;
  if (DYN) {
    if (prim >= 0 && prim < L.lights.n) {
      tally.row();
      p_light = pickup_density(L, prim, o, d, t);
    }
  } else {
    for (int r = 0; r < L.lights.n; ++r) {
      tally.row();
      if ((int)light(L, r, COL_PRIM) != prim) continue;
      p_light = pickup_density(L, r, o, d, t);
    }
  }
  tally.flush(0);
  return p_light;
}

// The row sample_light picks: the last row whose predecessor's cum is
// below u_sel, 0 if none. Where the cum column never falls (a NaN stays
// NaN: the total was NaN), `cum[j] < u_sel` holds on a prefix of the rows,
// and that row is the prefix's length over rows 0..n-2: DYN finds it by a
// binary search in place, about log2 n rows read. K3's table build flags
// the column (CUM_ORDERED); a column that falls (a negative emission)
// and K1's tables, of two rows at most in the cells, take the scan.
template <bool DYN>
__device__ __forceinline__ int pick_row(const Launch& L, float u_sel) {
  RowTally tally;
  int r = 0;
  if (DYN && tables(L)[CUM_ORDERED] != 0.0f) {
    const int m = L.lights.n - 1;
    for (int step = m > 0 ? 1 << (31 - __clz(m)) : 0; step > 0; step >>= 1) {
      if (r + step > m) continue;
      tally.row();
      if (light(L, r + step - 1, COL_CUM) < u_sel) r += step;
    }
  } else {
    for (int i = 1; i < L.lights.n; ++i) {
      tally.row();
      r = u_sel > light(L, i - 1, COL_CUM) ? i : r;
    }
  }
  tally.flush(1);
  return r;
}

struct LightSample {
  V3 wi, le;
  float t, pdf;
  bool valid;
};

// Pick a row by the cumulative table (pick_row) and sample a direction
// toward it from p: a uniform cone for a sphere, a uniform point for a
// plane (two-sided).
template <bool DYN>
__device__ __forceinline__ LightSample sample_light(const Launch& L, V3 p, float u_sel, float ul1,
                                                    float ul2) {
  const int r = pick_row<DYN>(L, u_sel);
  const float lpr = light(L, r, COL_PROB);
  float g[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) g[i] = light(L, r, COL_G + i);
  LightSample ls;
  ls.le = v3(light(L, r, COL_LE), light(L, r, COL_LE + 1), light(L, r, COL_LE + 2));
  float pdf;
  if (light(L, r, COL_KIND) < 0.5f) {
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

// One path in flight in a lane.
struct Path {
  unsigned k;  // ray index: (pixel (id) k / spp, sample offset + k % spp)
  Draws s;
  V3 o, d, tput, rad;
  float prev_pdf;  // the previous vertex's true BSDF density (MIS)
  int depth;
};

// Camera jitter (stream 0, pair 0) and generate_rays for ray k; with IDS,
// its pixel is the (k / spp_chunk)-th of the launch's list.
template <bool SOBOL, bool IDS>
__device__ __forceinline__ void start_path(const Launch& L, unsigned k, Path& P) {
  P.k = k;
  P.s.pixel = k / L.spp_chunk;
  if (IDS) P.s.pixel = __ldg(L.pixel_ids + P.s.pixel);
  P.s.sample = L.sample_offset + k % L.spp_chunk;
  P.s.seed = hash32(P.s.pixel ^ L.root);  // the per-pixel Sobol seed
  float u0, u1;
  draw_pair<SOBOL>(L, P.s, 0u, 0u, u0, u1);
  const float fi = (float)(P.s.pixel % (uint32_t)L.width);
  const float fj = (float)(P.s.pixel / (uint32_t)L.width);
  const float x = (fi + u0) * L.inv_width;
  const float y = (fj + u1) * L.inv_height;
  const float* cam = tables(L);  // eye, corner, u, v
  V3 d = v3(cam[3] + x * cam[6] + y * cam[9], cam[4] + x * cam[7] + y * cam[10],
            cam[5] + x * cam[8] + y * cam[11]);
  P.d = d * (1.0f / sqrtf(mag2(d)));
  P.o = v3(cam[0], cam[1], cam[2]);
  P.tput = v3(1.0f, 1.0f, 1.0f);
  P.rad = v3(0.0f, 0.0f, 0.0f);
  P.prev_pdf = 1.0f;
  P.depth = 0;
}

__device__ __forceinline__ void finish_path(const Launch& L, const Path& P) {
  float* out = L.out + 3ull * P.k;
  out[0] = P.rad.x;
  out[1] = P.rad.y;
  out[2] = P.rad.z;
}

// One bounce of path P at P.depth; false once the path has ended.
template <bool NEE, bool SOBOL, bool SDF, bool DYN>
__device__ __forceinline__ bool bounce(const Launch& L, Path& P, float clamp_base) {
  const bool sample_lights = NEE && L.lights.n > 0;
  const Hit h = intersect<SDF, DYN>(L, P.o, P.d);
  if (!h.hit) return false;  // a miss ends the path: nothing further is added
  const Material mp = load_material(L, h.mid);
  V3 contrib = P.tput * mp.emission;
  if (sample_lights && P.depth > 0) {
    // MIS against light sampling, and the depth-aware clamp; the camera's
    // own sighting of an emitter (depth 0) is neither.
    const float p_light = emission_pickup<DYN>(L, P.o, P.d, h.t, h.prim);
    const float w = P.prev_pdf / jmax(P.prev_pdf + p_light, FLOOR_12);
    const float cl = clamp_at_depth(clamp_base, P.depth);
    contrib = v3(jmin(contrib.x * w, cl), jmin(contrib.y * w, cl), jmin(contrib.z * w, cl));
  }
  P.rad = P.rad + contrib;

  // Pair 0 = BSDF lobe (x0, x1); pair 1 = (x2 layer choice, RR); nee adds
  // pair 2 = (light select, cone u1) and pair 3 = (cone u2, spare).
  const uint32_t stream = (uint32_t)P.depth + 1u;
  float x0, x1, x2, u_rr;
  draw_pair<SOBOL>(L, P.s, stream, 0u, x0, x1);
  draw_pair<SOBOL>(L, P.s, stream, 1u, x2, u_rr);
  const V3 wo = -P.d;

  if (sample_lights) {
    float u_sel, ul1, ul2, spare;
    draw_pair<SOBOL>(L, P.s, stream, 2u, u_sel, ul1);
    draw_pair<SOBOL>(L, P.s, stream, 3u, ul2, spare);
    const LightSample ls = sample_light<DYN>(L, h.p, u_sel, ul1, ul2);
    const float cos_surf = dot(ls.wi, h.n);
    // The light's contribution before the RR decision, as in the JAX
    // kernel; the shadow ray only where it can be non-zero.
    if (ls.valid && cos_surf > 0.0f &&
        !occluded<SDF, DYN>(L, h.p + ls.wi * BOUNCE_EPSILON, ls.wi, ls.t * SHADOW_SCALE)) {
      const V3 f_l = layered_eval(ls.wi, wo, h.n, mp);
      const float p_bsdf = layered_pdf_true(ls.wi, wo, h.n, mp);
      const float mis = ls.pdf / jmax(ls.pdf + p_bsdf, FLOOR_12);
      const float scale = mis * cos_surf / ls.pdf;
      const float cl = clamp_at_depth(clamp_base, P.depth);
      P.rad = P.rad + v3(jmin(P.tput.x * f_l.x * ls.le.x * scale, cl),
                         jmin(P.tput.y * f_l.y * ls.le.y * scale, cl),
                         jmin(P.tput.z * f_l.z * ls.le.z * scale, cl));
    }
  }

  // integrator.py::russian_roulette_probability
  const float power = jmin(jmax(mag2(P.tput), RR_CLAMP_LO), RR_CLAMP_HI);
  const float prob = P.depth < RR_YOUNG_DEPTH ? RR_YOUNG_SURVIVAL : RR_BASE * power;
  if (!(u_rr <= prob)) return false;

  const Basis bs = construct_basis(h.n);
  V3 wi, f;
  float pdf;
  layered_sample(wo, x0, x1, x2, bs, mp, wi, pdf, f);
  if (NEE) pdf = layered_pdf_true(wi, wo, h.n, mp);
  const float scale = fabsf(dot(wi, h.n)) / (pdf * prob);
  P.tput = P.tput * f * scale;
  P.o = h.p + wi * BOUNCE_EPSILON;
  P.d = wi;  // zero after a glossy sample below the surface: the next hit misses
  P.prev_pdf = pdf;
  return ++P.depth < L.max_depth;
}

// NEE: mode "nee" (else "path"); SOBOL: sampler "sobol" (else "uniform");
// SDF: scan the SDF rows (else they are not read); DYN: build K3's light
// table and clamp base from the staged tables (mode "nee", no SDF rows, no
// pixel list). The lights and the clamp base are read in mode "nee" only;
// no light rows means nothing emits: no light is sampled, and emission is
// neither MIS-weighted nor clamped.
//
// Persistent: each block stages the tables, then its lanes take rays from
// the block's range until the launch's rays are all taken. A lane whose
// path ends writes its radiance and takes a new ray at the next iteration.
template <bool NEE, bool SOBOL, bool SDF, bool IDS, bool DYN>
__device__ __forceinline__ void trace(const Launch& L) {
  if (L.tables == nullptr) {
    expand<NEE, DYN>(cornelis_smem, L, threadIdx.x, BLOCK);
    if (DYN) {
      // The sphere hierarchy first, its scratch in the light table's rows,
      // which the table then overwrites.
      __syncthreads();
      const StagedScene staged(L);
      walk::build(staged, L.spheres.n, cornelis_smem + walk::region_at(L),
                  reinterpret_cast<uint32_t*>(cornelis_smem + L.lights.at), threadIdx.x, BLOCK);
      light_table::build(staged, cornelis_smem + L.lights.at, cornelis_smem + 12, threadIdx.x,
                         BLOCK, cornelis_smem + CUM_ORDERED);
    }
  }
  if (threadIdx.x == 0) {
    unsigned kept;
    block_done = 0;
    claim(L, 0u, kept);
  }
  __syncthreads();
  const float clamp_base = tables(L)[12];
  const unsigned lane = threadIdx.x & 31u;

  Path P;
  bool alive = false, finished = false;
  for (;;) {
    const unsigned idle = __ballot_sync(FULL, !alive && !finished);
    if (idle) {
      const int leader = __ffs(idle) - 1;
      uint4 got = make_uint4(0u, 0u, 0u, 0u);
      if ((int)lane == leader) got = take(L, __popc(idle));
      got.x = __shfl_sync(FULL, got.x, leader);
      got.y = __shfl_sync(FULL, got.y, leader);
      got.z = __shfl_sync(FULL, got.z, leader);
      got.w = __shfl_sync(FULL, got.w, leader);
      if (!alive && !finished) {
        const unsigned rank = __popc(idle & ((1u << lane) - 1u));
        if (rank < got.y + got.w) {
          start_path<SOBOL, IDS>(L, rank < got.y ? got.x + rank : got.z + (rank - got.y), P);
          alive = L.max_depth > 0;
          if (!alive) finish_path(L, P);
        } else if (*(volatile int*)&block_done) {
          finished = true;
        }
      }
    }
    if (__all_sync(FULL, finished)) break;
    if (!alive) continue;
    if (!bounce<NEE, SOBOL, SDF, DYN>(L, P, clamp_base)) {
      finish_path(L, P);
      alive = false;
    }
  }
}

template <bool NEE, bool SOBOL, bool SDF, bool IDS>
__global__ void __launch_bounds__(BLOCK, MinBlocks<NEE, SOBOL, SDF, IDS>::value) megakernel(const __grid_constant__ Launch L) {
  trace<NEE, SOBOL, SDF, IDS, false>(L);
}

#ifdef CORNELIS_MEGAKERNEL_NEE

// The dynamic-scene render's instantiations (nee, no SDF rows, no pixel
// list), which build K3's light table in the prologue: the launch bounds
// of K1's nee ones. Only this library holds them, so K1's eight
// instantiations of each library compile as they did without them.
template <bool SOBOL>
__global__ void __launch_bounds__(BLOCK, MinBlocks<true, SOBOL, false, false>::value) megakernel_dyn(const __grid_constant__ Launch L) {
  trace<true, SOBOL, false, false, true>(L);
}

__global__ void __launch_bounds__(BLOCK) stage_tables_dyn(const __grid_constant__ Launch L) {
  stage<true, true>(L);
}

#endif

// The kernels of a launch: the megakernel instantiation and the staging
// kernel for tables past SMEM_CAP.
template <bool NEE, bool SOBOL, bool SDF, bool IDS, bool DYN>
struct Kernels {
  static constexpr auto main_fn = megakernel<NEE, SOBOL, SDF, IDS>;
  static constexpr auto stage_fn = stage_tables<NEE>;
};

#ifdef CORNELIS_MEGAKERNEL_NEE
template <bool SOBOL>
struct Kernels<true, SOBOL, false, false, true> {
  static constexpr auto main_fn = megakernel_dyn<SOBOL>;
  static constexpr auto stage_fn = stage_tables_dyn;
};
#endif

// Lays the tables out: the header, then planes, SDFs, materials, lights and
// spheres, each at a 16-byte boundary, and with `hierarchy` K3's sphere
// hierarchy after the spheres. Returns the layout's bytes.
int layout(Launch& L, bool hierarchy = false) {
  int at = HEADER;
  auto put = [&at](Table& t, int floats) {
    t.at = at;
    at += (floats + 3) & ~3;
  };
  put(L.planes, PLANE_ROW * L.planes.n);
  put(L.sdfs, SDF_ROW * L.sdfs.n);
  put(L.materials, MATERIAL_COLS * L.materials.n);
  put(L.lights, LIGHT_COLS * L.lights.n);
  put(L.spheres, SPHERE_COLS * L.spheres.n);
  if (hierarchy) at += walk::floats(L.spheres.n);
  return 4 * at;
}

// Zeroes the launch's counter and launches one wave of persistent blocks
// (SMs x the blocks an SM holds, or fewer for a small launch) on `stream`,
// with the tables in each block's shared memory, or, past SMEM_CAP, staged
// once in device memory allocated and freed on `stream` (DYN: with the
// sphere hierarchy's scratch, a word a sphere, past the layout's end).
template <bool NEE, bool SOBOL, bool SDF, bool IDS, bool DYN = false>
int launch(Launch L, cudaStream_t stream) {
  const auto kernel = Kernels<NEE, SOBOL, SDF, IDS, DYN>::main_fn;
  const auto stage_kernel = Kernels<NEE, SOBOL, SDF, IDS, DYN>::stage_fn;
  const int bytes = layout(L, DYN);
  const int smem = bytes <= SMEM_CAP ? bytes : 0;
  cudaError_t err = cudaSuccess;
  if (smem > SMEM_DEFAULT)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int device = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, BLOCK, smem);
  if (err == cudaSuccess && per_sm < 1) err = cudaErrorInvalidConfiguration;
  if (err == cudaSuccess) err = cudaMemsetAsync(L.counter, 0, sizeof(unsigned), stream);
  float* staged = nullptr;
  if (err == cudaSuccess && smem == 0) {
    err = cudaMallocAsync((void**)&staged, bytes + (DYN ? 4 * L.spheres.n : 0), stream);
    if (err == cudaSuccess) {
      L.tables = staged;
      int items = L.spheres.n > L.planes.n + L.sdfs.n ? L.spheres.n : L.planes.n + L.sdfs.n;
      items = items > MATERIAL_COLS * L.materials.n ? items : MATERIAL_COLS * L.materials.n;
      items = items > LIGHT_COLS * L.lights.n ? items : LIGHT_COLS * L.lights.n;
      stage_kernel<<<(items + BLOCK - 1) / BLOCK + 1, BLOCK, 0, stream>>>(L);
      err = cudaGetLastError();
    }
  }
  if (err == cudaSuccess) {
    const unsigned wave = (unsigned)(sms * per_sm);
    const unsigned needed = (L.n_rays + CHUNK - 1) / CHUNK;
    kernel<<<needed < wave ? needed : wave, BLOCK, smem, stream>>>(L);
    err = cudaGetLastError();
  }
  if (staged != nullptr) {
    const cudaError_t freed = cudaFreeAsync(staged, stream);
    if (err == cudaSuccess) err = freed;
  }
  return (int)err;
}

// The instantiation for (sobol, SDF rows present, a pixel list given).
template <bool NEE, bool IDS>
int pick_sampler(Launch L, int sobol, cudaStream_t stream) {
  if (L.sdfs.n > 0)
    return sobol ? launch<NEE, true, true, IDS>(L, stream) : launch<NEE, false, true, IDS>(L, stream);
  return sobol ? launch<NEE, true, false, IDS>(L, stream) : launch<NEE, false, false, IDS>(L, stream);
}

template <bool NEE>
int pick(Launch L, int sobol, cudaStream_t stream) {
  return L.pixel_ids != nullptr ? pick_sampler<NEE, true>(L, sobol, stream)
                                : pick_sampler<NEE, false>(L, sobol, stream);
}

// Loads `fns` onto the current device; the first error.
int load(std::initializer_list<const void*> fns) {
  for (const void* fn : fns) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// K1's kernels of mode NEE, for cornelis_megakernel*_load.
template <bool NEE>
int load_all() {
  return load({(const void*)megakernel<NEE, false, false, false>,
               (const void*)megakernel<NEE, true, false, false>,
               (const void*)megakernel<NEE, false, true, false>,
               (const void*)megakernel<NEE, true, true, false>,
               (const void*)megakernel<NEE, false, false, true>,
               (const void*)megakernel<NEE, true, false, true>,
               (const void*)megakernel<NEE, false, true, true>,
               (const void*)megakernel<NEE, true, true, true>, (const void*)stage_tables<NEE>});
}

// The launch's arguments, checked: n_rays in [0, 2^31) (ray indices are 32
// bits wide), index_bits clamped to [1, 32]; pixel_ids null or holding
// n_rays / spp_chunk ids. Returns 0 or a CUDA error.
int make_launch(Launch& L, const float* camera, const float* spheres, int n_spheres,
                const float* planes, int n_planes, const float* materials, int n_materials,
                const float* sdfs, int n_sdfs, float* out, unsigned* counter, long long n_rays,
                uint32_t k0, uint32_t k1, uint32_t root, int width, float inv_width,
                float inv_height, int spp_chunk, uint32_t sample_offset,
                const uint32_t* pixel_ids, int max_depth, int index_bits,
                const float* lights, int n_lights, const float* clamp) {
  if (n_rays < 0 || n_rays >= (1ll << 31) || spp_chunk < 1 || width < 1 ||
      (pixel_ids != nullptr && n_rays % spp_chunk != 0))
    return (int)cudaErrorInvalidValue;
  L.spheres = Table{spheres, n_spheres, 0};
  L.planes = Table{planes, n_planes, 0};
  L.materials = Table{materials, n_materials, 0};
  L.sdfs = Table{sdfs, n_sdfs, 0};
  L.lights = Table{lights, n_lights, 0};
  L.tables = nullptr;
  L.camera = camera;
  L.clamp = clamp;
  L.pixel_ids = pixel_ids;
  L.out = out;
  L.counter = counter;
  L.n_rays = (unsigned)n_rays;
  L.k0 = k0;
  L.k1 = k1;
  L.root = root;
  L.width = width;
  L.inv_width = inv_width;
  L.inv_height = inv_height;
  L.spp_chunk = (unsigned)spp_chunk;
  L.sample_offset = sample_offset;
  L.max_depth = max_depth;
  L.index_bits = index_bits < 1 ? 1 : (index_bits > 32 ? 32 : index_bits);
  return 0;
}

}  // namespace

#ifndef CORNELIS_MEGAKERNEL_NEE

// Traces the n_rays rays of a chunk in mode "path" on `stream` and returns
// the first CUDA error (0: launched). sobol (0 or 1) and n_sdfs > 0 choose
// the instantiation; `counter` is one unsigned of device scratch that the
// launch zeroes on `stream` before the kernel runs, so a launch must not
// share it with another in flight. pixel_ids, when not null, lists the
// n_rays / spp_chunk pixels the launch traces (a mesh rank's shard).
// Writes out[3k..3k+2] for every ray k.
extern "C" int cornelis_megakernel(const float* camera, const float* spheres, int n_spheres,
                                   const float* planes, int n_planes, const float* materials,
                                   int n_materials, const float* sdfs, int n_sdfs, float* out,
                                   unsigned* counter, long long n_rays, uint32_t k0, uint32_t k1,
                                   uint32_t root, int width, float inv_width, float inv_height,
                                   int spp_chunk, uint32_t sample_offset,
                                   const uint32_t* pixel_ids, int max_depth, int sobol,
                                   int index_bits, void* stream) {
  Launch L;
  const int err = make_launch(L, camera, spheres, n_spheres, planes, n_planes, materials,
                              n_materials, sdfs, n_sdfs, out, counter, n_rays, k0, k1, root, width,
                              inv_width, inv_height, spp_chunk, sample_offset, pixel_ids,
                              max_depth, index_bits, nullptr, 0, nullptr);
  if (err != 0 || n_rays == 0) return err;
  return pick<false>(L, sobol, (cudaStream_t)stream);
}

// Loads this library's kernels onto the current device (CUDA loads a
// module's kernels lazily, at first use) and returns the first error.
extern "C" int cornelis_megakernel_load() { return load_all<false>(); }

#else

// The same in mode "nee" (megakernel_nee.cu), with the light table
// (n_lights rows of ops/lights.py's layout) and the clamp base.
extern "C" int cornelis_megakernel_nee(const float* camera, const float* spheres, int n_spheres,
                                       const float* planes, int n_planes, const float* materials,
                                       int n_materials, const float* sdfs, int n_sdfs, float* out,
                                       unsigned* counter, long long n_rays, uint32_t k0,
                                       uint32_t k1, uint32_t root, int width, float inv_width,
                                       float inv_height, int spp_chunk, uint32_t sample_offset,
                                       const uint32_t* pixel_ids, int max_depth, int sobol,
                                       int index_bits, const float* lights, int n_lights,
                                       const float* clamp, void* stream) {
  Launch L;
  const int err = make_launch(L, camera, spheres, n_spheres, planes, n_planes, materials,
                              n_materials, sdfs, n_sdfs, out, counter, n_rays, k0, k1, root, width,
                              inv_width, inv_height, spp_chunk, sample_offset, pixel_ids,
                              max_depth, index_bits, lights, n_lights, clamp);
  if (err != 0 || n_rays == 0) return err;
  return pick<true>(L, sobol, (cudaStream_t)stream);
}

// The same in mode "nee" with K3's light table and clamp base built inside
// the launch from the tables (every sphere and plane a row of
// ops/lights.py's layout): the dynamic-scene render. Takes no SDF rows and
// no pixel list (cudaErrorInvalidValue), and at least one sphere or plane.
extern "C" int cornelis_megakernel_nee_dynamic(
    const float* camera, const float* spheres, int n_spheres, const float* planes, int n_planes,
    const float* materials, int n_materials, const float* sdfs, int n_sdfs, float* out,
    unsigned* counter, long long n_rays, uint32_t k0, uint32_t k1, uint32_t root, int width,
    float inv_width, float inv_height, int spp_chunk, uint32_t sample_offset,
    const uint32_t* pixel_ids, int max_depth, int sobol, int index_bits, void* stream) {
  if (n_sdfs != 0 || pixel_ids != nullptr || n_spheres + n_planes < 1)
    return (int)cudaErrorInvalidValue;
  Launch L;
  const int err = make_launch(L, camera, spheres, n_spheres, planes, n_planes, materials,
                              n_materials, sdfs, 0, out, counter, n_rays, k0, k1, root, width,
                              inv_width, inv_height, spp_chunk, sample_offset, nullptr, max_depth,
                              index_bits, nullptr, n_spheres + n_planes, nullptr);
  if (err != 0 || n_rays == 0) return err;
  const cudaStream_t s = (cudaStream_t)stream;
  return sobol ? launch<true, true, false, false, true>(L, s)
               : launch<true, false, false, false, true>(L, s);
}

// K3's resident blocks an SM (`blocks`) and the shared memory its launch
// asks for (`smem_bytes`, 0: the tables are staged in device memory) for a
// scene of these counts, by the launch's own query.
extern "C" int cornelis_megakernel_nee_dynamic_occupancy(int n_spheres, int n_planes,
                                                         int n_materials, int sobol, int* blocks,
                                                         int* smem_bytes) {
  Launch L{};
  L.spheres.n = n_spheres;
  L.planes.n = n_planes;
  L.materials.n = n_materials;
  L.lights.n = n_spheres + n_planes;
  const int bytes = layout(L, true);
  const int smem = bytes <= SMEM_CAP ? bytes : 0;
  const auto kernel = sobol ? megakernel_dyn<true> : megakernel_dyn<false>;
  cudaError_t err = cudaSuccess;
  if (smem > SMEM_DEFAULT)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, BLOCK, smem);
  *smem_bytes = smem;
  return (int)err;
}

#ifdef CORNELIS_WALK_COUNTS
// The counting build's tallies since the last call (walk_counts' twenty
// counters, in its order) into `out`, and zeroes them.
extern "C" int cornelis_walk_counts(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, walk_counts, sizeof(walk_counts));
  const unsigned long long zero[20] = {};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(walk_counts, zero, sizeof(walk_counts));
  return (int)err;
}
#endif

extern "C" int cornelis_megakernel_nee_load() {
  const int err = load_all<true>();
  if (err != 0) return err;
  return load({(const void*)megakernel_dyn<false>, (const void*)megakernel_dyn<true>,
               (const void*)stage_tables_dyn});
}

#endif
