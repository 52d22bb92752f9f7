"""Ray-primitive tests for spheres, finite planes and SDF primitives.

Counterpart of `cornelis_tpu/geometry.py`, with its reference quirks
(Geometry.cpp): degenerate rays never hit, negative roots map to +inf
before the near/far min, rays parallel to a plane miss, and plane extents
are tested in the tangent basis of the plane normal. The `min_hit_t`
self-intersection guard (COMPAT.md R10) rejects hits closer than
T_MIN_SCALE * (1 + |o|_inf) in world units. SDF primitives (sphere, box,
torus under rotation and uniform scale) are sphere-traced for
SPHERE_TRACE_STEPS steps, in the JAX package's order of operations.
"""

from __future__ import annotations

import math

import torch

from .math.vec import Vec3, construct_basis, dot, is_almost_zero, mag2, normalize, ray_at

INF = math.inf

# Scale-aware self-intersection guard (geometry.py:119-134 of the JAX
# package): a few float32 ulps of the origin's coordinate magnitude.
T_MIN_SCALE = 4e-6


def _degenerate(d: Vec3) -> torch.Tensor:
    """The reference's bogus-ray guard: every component almost zero."""
    return is_almost_zero(d.x) & is_almost_zero(d.y) & is_almost_zero(d.z)


def min_hit_t(o: Vec3, d: Vec3 = None) -> torch.Tensor:
    """Minimum accepted hit distance for rays from `o`, in world units;
    with `d`, divided by |d| to convert into the ray's own
    parameterization."""
    mag = torch.maximum(torch.maximum(torch.abs(o.x), torch.abs(o.y)), torch.abs(o.z))
    tmin = T_MIN_SCALE * (1.0 + mag)
    if d is None:
        return tmin
    deg = _degenerate(d)
    return tmin / torch.sqrt(torch.where(deg, 1.0, mag2(d)))


def sphere_candidate_t(o: Vec3, d: Vec3, center: Vec3, radius, tmin, pre=None):
    """Ray/sphere quadratic (Geometry.cpp:50-106): the nearest root at or
    beyond `tmin` as (t, valid), t = +inf on a miss. `pre` optionally
    carries the per-ray (degenerate mask, d.d) hoisted out of a scan."""
    if pre is None:
        deg = _degenerate(d)
        a = torch.where(deg, 1.0, mag2(d))
    else:
        deg, a = pre
    rel = o - center
    b = dot(rel, d)
    c = mag2(rel)

    u = 2.0 * b / a
    v = (c - radius * radius) / a

    disc = -v + (u * u) / 4.0
    has_root = disc >= 0.0
    shift = torch.sqrt(torch.clamp_min(disc, 1e-12))
    t0 = -u / 2.0 - shift
    t1 = -u / 2.0 + shift
    t0 = torch.where(t0 < tmin, INF, t0)
    t1 = torch.where(t1 < tmin, INF, t1)
    t = torch.minimum(t0, t1)

    valid = has_root & ~deg & torch.isfinite(t)
    t = torch.where(valid, t, INF)
    return t, valid


def plane_candidate(o: Vec3, d: Vec3, normal: Vec3, point: Vec3, width, height, tmin=None):
    """Ray/finite-rectangle intersection (Geometry.cpp:128-176). Returns
    (t, p, normal, valid); p is the unmasked point at t."""
    diff = o - point
    a = -dot(diff, normal)
    b = dot(d, normal)

    origin_on_anchor = (diff.x == 0.0) & (diff.y == 0.0) & (diff.z == 0.0)
    b_zero = is_almost_zero(b)
    # Parallel ray away from the anchor point: miss (Geometry.cpp:154).
    parallel_miss = ~origin_on_anchor & b_zero

    safe_b = torch.where(b_zero, 1.0, b)
    t = torch.where(b_zero, 0.0, a / safe_b)
    if tmin is None:
        tmin = min_hit_t(o, d)
    backward = t < tmin

    p = ray_at(o, d, t)
    basis = construct_basis(normal)
    in_plane = p - point
    outside = (torch.abs(dot(in_plane, basis.t)) * 2.0 > width) | (
        torch.abs(dot(in_plane, basis.b)) * 2.0 > height
    )

    valid = ~_degenerate(d) & ~parallel_miss & ~backward & ~outside
    t = torch.where(valid, t, INF)
    return t, p, normal, valid


# -- Implicit (SDF) surfaces (geometry.py:267-429 of the JAX package) --------

SDF_KIND_SPHERE = 0
SDF_KIND_BOX = 1
SDF_KIND_TORUS = 2

SPHERE_TRACE_STEPS = 128
# Hit tolerance SDF_EPS * max(1, t): constant relative resolution. A march
# closer than SDF_MIN_T (or min_hit_t) to its origin is no hit.
SDF_EPS = 1e-4
SDF_MIN_T = 1e-3
SDF_MAX_T = 1e6
# The plain march stops once every ray is done, checked this often. A done
# ray keeps its t, so stopping then changes nothing.
_DONE_CHECK = 8


def sdf_distance(kind: int, params, q: Vec3) -> torch.Tensor:
    """Signed distance of local point q for a primitive of `kind`, with
    params[0..3] as in SDFDescription. Only the kind's own formula is
    evaluated; the JAX function computes all three and selects, which
    gives the same values."""
    if kind == SDF_KIND_SPHERE:
        return torch.sqrt(torch.clamp_min(mag2(q), 1e-20)) - params[0]
    if kind == SDF_KIND_BOX:
        ax = torch.abs(q.x) - params[0]
        ay = torch.abs(q.y) - params[1]
        az = torch.abs(q.z) - params[2]
        mx, my, mz = (torch.clamp_min(a, 0.0) for a in (ax, ay, az))
        outside = torch.sqrt(mx * mx + my * my + mz * mz)
        inside = torch.clamp_max(torch.maximum(ax, torch.maximum(ay, az)), 0.0)
        return outside + inside
    if kind == SDF_KIND_TORUS:
        ring = torch.sqrt(torch.clamp_min(q.x * q.x + q.z * q.z, 1e-20)) - params[0]
        return torch.sqrt(torch.clamp_min(ring * ring + q.y * q.y, 1e-20)) - params[1]
    raise ValueError(f"unknown SDF kind {kind}")


def sdf_normal(kind: int, params, q: Vec3, h: torch.Tensor) -> Vec3:
    """Surface normal by the 4-tap tetrahedron gradient estimate."""

    def tap(sx, sy, sz):
        return sdf_distance(
            kind, params, Vec3(q.x + sx * h, q.y + sy * h, q.z + sz * h)
        )

    t0 = tap(1.0, -1.0, -1.0)
    t1 = tap(-1.0, -1.0, 1.0)
    t2 = tap(-1.0, 1.0, -1.0)
    t3 = tap(1.0, 1.0, 1.0)
    g = Vec3(t0 - t1 - t2 + t3, -t0 - t1 + t2 + t3, -t0 + t1 - t2 + t3)
    return normalize(g)


def _rot3(rot, v: Vec3) -> Vec3:
    """Apply a row-major 3x3 rotation (anything doubly indexable)."""
    return Vec3(
        rot[0][0] * v.x + rot[0][1] * v.y + rot[0][2] * v.z,
        rot[1][0] * v.x + rot[1][1] * v.y + rot[1][2] * v.z,
        rot[2][0] * v.x + rot[2][1] * v.y + rot[2][2] * v.z,
    )


def _rot3_t(rot, v: Vec3) -> Vec3:
    """Apply the transpose (inverse) of the rotation in _rot3."""
    return Vec3(
        rot[0][0] * v.x + rot[1][0] * v.y + rot[2][0] * v.z,
        rot[0][1] * v.x + rot[1][1] * v.y + rot[2][1] * v.z,
        rot[0][2] * v.x + rot[1][2] * v.y + rot[2][2] * v.z,
    )


def _sdf_frame(d: Vec3, kind: int, params, rot, scale):
    """(degenerate flag, |d|, unit direction, to_local, world_dist) of rays
    along d against one primitive: to_local maps a world offset from the
    centre into the primitive's frame, world_dist gives its distance in
    world units."""
    deg = _degenerate(d)
    dlen = torch.sqrt(torch.where(deg, 1.0, mag2(d)))
    dn = Vec3(d.x / dlen, d.y / dlen, d.z / dlen)

    def to_local(qw: Vec3) -> Vec3:
        q = _rot3(rot, qw) if rot is not None else qw
        if scale is not None:
            inv = 1.0 / scale
            q = Vec3(q.x * inv, q.y * inv, q.z * inv)
        return q

    def world_dist(qw: Vec3) -> torch.Tensor:
        dist = sdf_distance(kind, params, to_local(qw))
        return dist * scale if scale is not None else dist

    return deg, dlen, dn, to_local, world_dist


def _mul_round_up(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 a * b rounded toward +inf, as CUDA's __fmul_ru: the exact
    product (float64 holds it), rounded to nearest, then one float32 step
    up where that fell below it."""
    exact = a.double() * b.double()
    f = exact.float()
    return torch.where(f.double() < exact, torch.nextafter(f, torch.full_like(f, INF)), f)


def _march(o: Vec3, dn: Vec3, center: Vec3, world_dist, lim_w=None):
    """The sphere trace along the unit direction dn: (t_world, each ray's
    distance evaluations until it is done, whether it stopped at lim_w).
    With a world-unit limit lim_w a ray stops, before its next evaluation,
    once its t reaches lim_w, as the CUDA kernel's march does."""
    t = torch.zeros_like(o.x)
    done = torch.zeros_like(o.x, dtype=torch.bool)
    stopped = torch.zeros_like(done)
    steps = torch.zeros_like(o.x, dtype=torch.int32)
    for step in range(SPHERE_TRACE_STEPS):
        if step % _DONE_CHECK == 0 and step and bool(done.all()):
            break
        if lim_w is not None:
            stop = ~done & (t >= lim_w)
            stopped = stopped | stop
            done = done | stop
        steps += ~done
        dist = world_dist(ray_at(o, dn, t) - center)
        eps = SDF_EPS * torch.clamp_min(t, 1.0)
        done = done | (torch.abs(dist) < eps) | (t > SDF_MAX_T)
        t = torch.where(done, t, t + torch.maximum(dist, 0.5 * eps))
    if lim_w is not None:  # no final test past the limit after the last step
        stopped = stopped | (~done & (t >= lim_w))
    return t, steps, stopped


def _world_limit(limit, dlen: torch.Tensor):
    """`limit` (the ray's own parameterization) as the world-unit limit of
    the march, or None for +inf."""
    limit = torch.as_tensor(limit, dtype=torch.float32, device=dlen.device)
    if bool(torch.isinf(limit).all()) and bool((limit > 0).all()):
        return None
    return _mul_round_up(limit.expand_as(dlen), dlen)


def sdf_march_steps(o: Vec3, d: Vec3, kind: int, center: Vec3, params, rot=None,
                    scale=None, limit=INF) -> torch.Tensor:
    """Each ray's distance evaluations in `sdf_candidate`'s march, stopped
    at `limit` as there: what a per-ray march that stops when it is done
    evaluates (int32)."""
    _deg, dlen, dn, _to_local, world_dist = _sdf_frame(d, kind, params, rot, scale)
    return _march(o, dn, center, world_dist, _world_limit(limit, dlen))[1]


def sdf_candidate(o: Vec3, d: Vec3, kind: int, center: Vec3, params, rot=None, scale=None,
                  with_normal: bool = True, limit=INF):
    """Sphere-trace one SDF primitive for a batch of rays.

    Returns (t, p, n, valid) with t in the ray's own parameterization
    (t_world / |d|, +inf on a miss) and p the point at t_world along the
    normalized direction. `rot` is the world-to-local rotation (row-major
    3x3) and `scale` the uniform object scale: distances are
    s * d_local(R (p - c) / s), normals the local gradient rotated back.
    with_normal=False skips the normal (n is None): the shadow ray needs
    only t.

    `limit` (per ray, in the ray's parameterization) stops each march once
    its world t reaches limit * |d| rounded up, as the CUDA kernel stops at
    the best hit so far or at t_max; a ray stopped so is no hit. That
    changes no decision `valid & (t < limit)`: any t the march could still
    reach has t / |d| >= limit."""
    deg, dlen, dn, to_local, world_dist = _sdf_frame(d, kind, params, rot, scale)
    t, _steps, stopped = _march(o, dn, center, world_dist, _world_limit(limit, dlen))

    p = ray_at(o, dn, t)
    eps = SDF_EPS * torch.clamp_min(t, 1.0)
    valid = (
        ~deg
        & ~stopped
        & (torch.abs(world_dist(p - center)) < eps)
        & (t > torch.clamp_min(min_hit_t(o), SDF_MIN_T))
        & (t <= SDF_MAX_T)
    )
    n = None
    if with_normal:
        h_local = eps / scale if scale is not None else eps
        n = sdf_normal(kind, params, to_local(p - center), h_local)
        n = _rot3_t(rot, n) if rot is not None else n
    return torch.where(valid, t / dlen, INF), p, n, valid
