"""Ray-primitive tests for spheres, finite planes and SDF primitives.

Counterpart of `cornelis_tpu/geometry.py`, with its reference quirks
(Geometry.cpp): degenerate rays never hit, negative roots map to +inf
before the near/far min, rays parallel to a plane miss, and plane extents
are tested in the tangent basis of the plane normal. The `min_hit_t`
self-intersection guard (COMPAT.md R10) rejects hits closer than
T_MIN_SCALE * (1 + |o|_inf) in world units. SDF primitives (sphere, box,
torus under rotation and uniform scale) are sphere-traced for
SPHERE_TRACE_STEPS steps, in the JAX package's order of operations.

`intersect_scene` and `occluded` are the closest-hit and any-hit tests
over a `SceneArrays`, differentiable (the closest hit) in the sphere
centres and radii and the plane points: the wavefront's, and through
ops/megakernel.py's `intersect` and `occluded` the kernel's plain
version's.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .vec import (
    Vec3,
    construct_basis,
    dot,
    is_almost_zero,
    mag2,
    maximum,
    minimum,
    normalize,
    ray_at,
    take,
)

INF = math.inf

# Primitive kinds of Hit.kind: NEE weights an emitter hit by whether light
# sampling could have picked it (spheres and planes, not SDFs).
KIND_NONE = -1
KIND_SPHERE = 0
KIND_PLANE = 1
KIND_SDF = 2


class Hit(NamedTuple):
    """Closest hit of a batch of rays (IntersectionData, Geometry.hpp:7-19):
    t, point, shading normal, material id, hit mask, primitive kind and
    index within its kind's table (-1 on a miss and for SDFs)."""

    t: torch.Tensor
    position: Vec3
    normal: Vec3
    material: torch.Tensor
    hit: torch.Tensor
    kind: torch.Tensor
    prim: torch.Tensor


def _empty_hit(like: torch.Tensor) -> Hit:
    """All-miss hit record (t = inf, Geometry.cpp:7-12)."""
    zeros = torch.zeros_like(like)
    minus_one = torch.full(like.shape, -1, dtype=torch.int64, device=like.device)
    return Hit(
        t=torch.full_like(like, INF),
        position=Vec3(zeros, zeros, zeros),
        normal=Vec3(zeros, zeros, zeros),
        material=torch.zeros_like(minus_one),
        hit=torch.zeros_like(like, dtype=torch.bool),
        kind=minus_one,
        prim=minus_one,
    )


def _update_closest(best: Hit, t, p: Vec3, n: Vec3, material, valid, kind: int = KIND_NONE,
                    prim=-1) -> Hit:
    """Take the candidate where it is valid and strictly closer."""
    closer = valid & (best.t > t)
    sel = lambda a, b: torch.where(closer, a, b)
    return Hit(
        t=sel(t, best.t),
        position=Vec3(*(sel(a, b) for a, b in zip(p, best.position))),
        normal=Vec3(*(sel(a, b) for a, b in zip(n, best.normal))),
        material=sel(material, best.material),
        hit=best.hit | closer,
        kind=sel(kind, best.kind),
        prim=sel(prim, best.prim),
    )


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
    shift = torch.sqrt(maximum(disc, 1e-12))
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
        return torch.sqrt(maximum(mag2(q), 1e-20)) - params[0]
    if kind == SDF_KIND_BOX:
        ax = torch.abs(q.x) - params[0]
        ay = torch.abs(q.y) - params[1]
        az = torch.abs(q.z) - params[2]
        mx, my, mz = (maximum(a, 0.0) for a in (ax, ay, az))
        outside = torch.sqrt(mx * mx + my * my + mz * mz)
        inside = minimum(torch.maximum(ax, torch.maximum(ay, az)), 0.0)
        return outside + inside
    if kind == SDF_KIND_TORUS:
        ring = torch.sqrt(maximum(q.x * q.x + q.z * q.z, 1e-20)) - params[0]
        return torch.sqrt(maximum(ring * ring + q.y * q.y, 1e-20)) - params[1]
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
        eps = SDF_EPS * maximum(t, 1.0)
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
    eps = SDF_EPS * maximum(t, 1.0)
    valid = (
        ~deg
        & ~stopped
        & (torch.abs(world_dist(p - center)) < eps)
        & (t > maximum(min_hit_t(o), SDF_MIN_T))
        & (t <= SDF_MAX_T)
    )
    n = None
    if with_normal:
        h_local = eps / scale if scale is not None else eps
        n = sdf_normal(kind, params, to_local(p - center), h_local)
        n = _rot3_t(rot, n) if rot is not None else n
    return torch.where(valid, t / dlen, INF), p, n, valid


def sdf_objects(scene):
    """Per SDF: (kind as an int, centre, params, material, rotation, scale)."""
    kinds = scene.sdf_kind.tolist()
    for k, kind in enumerate(kinds):
        center = Vec3(scene.sdf_center.x[k], scene.sdf_center.y[k], scene.sdf_center.z[k])
        yield (int(kind), center, scene.sdf_params[k], scene.sdf_material[k],
               scene.sdf_rot[k], scene.sdf_scale[k])


def intersect_scene(scene, o: Vec3, d: Vec3) -> Hit:
    """Closest hit against every sphere, then every plane, then every SDF
    of a SceneArrays (Render.cpp:110-150; geometry.py:432-573 of the JAX
    package). Spheres are scanned in two phases: t and the winner's
    index, then one gather of the winner's centre, through which the
    point and normal stay differentiable in it."""
    best = _empty_hit(o.x)
    tmin = min_hit_t(o, d)

    if scene.num_spheres:
        deg = _degenerate(d)
        a = torch.where(deg, 1.0, mag2(d))
        c, radius = scene.sphere_center, scene.sphere_radius
        s_t, s_idx = best.t, best.prim
        for s in range(scene.num_spheres):
            t, valid = sphere_candidate_t(
                o, d, Vec3(c.x[s], c.y[s], c.z[s]), radius[s], tmin, pre=(deg, a)
            )
            closer = valid & (s_t > t)
            s_t = torch.where(closer, t, s_t)
            s_idx = torch.where(closer, s, s_idx)
        sp_hit = s_idx >= 0
        gi = s_idx.clamp_min(0)
        p = ray_at(o, d, torch.where(sp_hit, s_t, 0.0))
        # Mask before normalize: a miss would normalize the zero vector,
        # and its NaN would reach the gradient through the masked branch.
        n = normalize(Vec3(
            torch.where(sp_hit, p.x - take(c.x, gi), 1.0),
            torch.where(sp_hit, p.y - take(c.y, gi), 0.0),
            torch.where(sp_hit, p.z - take(c.z, gi), 0.0),
        ))
        sel = lambda v: torch.where(sp_hit, v, 0.0)
        best = Hit(
            t=s_t,
            position=Vec3(sel(p.x), sel(p.y), sel(p.z)),
            normal=Vec3(sel(n.x), sel(n.y), sel(n.z)),
            material=torch.where(sp_hit, take(scene.sphere_material, gi), 0),
            hit=sp_hit,
            kind=torch.where(sp_hit, KIND_SPHERE, best.kind),
            prim=s_idx,
        )

    nrm, pt = scene.plane_normal, scene.plane_point
    for j in range(scene.num_planes):
        normal = Vec3(nrm.x[j], nrm.y[j], nrm.z[j])
        t, p, n, valid = plane_candidate(
            o, d, normal, Vec3(pt.x[j], pt.y[j], pt.z[j]), scene.plane_width[j],
            scene.plane_height[j], tmin=tmin,
        )
        best = _update_closest(best, t, p, n, scene.plane_material[j], valid, KIND_PLANE, j)

    if scene.num_sdfs:
        for kind, center, params, material, rot, scale in sdf_objects(scene):
            t, p, n, valid = sdf_candidate(o, d, kind, center, params, rot=rot, scale=scale)
            best = _update_closest(best, t, p, n, material, valid, KIND_SDF)
    return best


@torch.no_grad()
def occluded(scene, o: Vec3, d: Vec3, t_max) -> torch.Tensor:
    """True where some primitive of a SceneArrays lies along d closer than
    t_max (geometry.py:576-657 of the JAX package): the shadow ray's
    any-hit test. A boolean carries no gradient, so no graph is kept."""
    occ = torch.zeros_like(o.x, dtype=torch.bool)
    tmin = min_hit_t(o, d)
    deg = _degenerate(d)
    a = torch.where(deg, 1.0, mag2(d))
    c, radius = scene.sphere_center, scene.sphere_radius
    for s in range(scene.num_spheres):
        t, valid = sphere_candidate_t(
            o, d, Vec3(c.x[s], c.y[s], c.z[s]), radius[s], tmin, pre=(deg, a)
        )
        occ = occ | (valid & (t < t_max))
    nrm, pt = scene.plane_normal, scene.plane_point
    for j in range(scene.num_planes):
        t, _p, _n, valid = plane_candidate(
            o, d, Vec3(nrm.x[j], nrm.y[j], nrm.z[j]), Vec3(pt.x[j], pt.y[j], pt.z[j]),
            scene.plane_width[j], scene.plane_height[j], tmin=tmin,
        )
        occ = occ | (valid & (t < t_max))
    if scene.num_sdfs:
        for kind, center, params, _material, rot, scale in sdf_objects(scene):
            t, _p, _n, valid = sdf_candidate(
                o, d, kind, center, params, rot=rot, scale=scale, with_normal=False
            )
            occ = occ | (valid & (t < t_max))
    return occ
