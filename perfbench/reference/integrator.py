"""The wavefront path integrator in torch ops, and its constants.

Counterpart of `cornelis_tpu/integrator.py`, the JAX package's XLA
wavefront: every ray of a chunk advances one bounce at a time as a batch
of tensors, dead rays masked, not compacted. It draws as that wavefront
does (`rng.stream_uniforms`: jax.random keys per (pixel, sample), or
Sobol), so its images match the JAX function's pixel by pixel; the CUDA
megakernel (ops/megakernel.py) draws from packed Threefry counters and
matches it only in distribution.

Two estimators, as in JAX: mode "path" replicates the reference's
(emission at every hit, its half-weighted glossy pdf); mode "nee" adds a
shadow ray toward a power-selected sphere or rectangle emitter, weighed
against BSDF sampling by the balance heuristic, divides by the true BSDF
density and clamps each bounce's contribution (NEE_CLAMP_FACTOR).

The wavefront is differentiable by autograd (diff/render.py):
`detach_sampling=True` detaches the sampled directions, their densities
and the Russian-roulette probability, so gradients flow through the
BSDF, emission, cosine and MIS weights and the hit geometry. Each bounce
of a differentiated render is checkpointed
(`torch.utils.checkpoint`, non-reentrant): the backward recomputes it
from its input state, which the counter-based draws make exact, instead
of keeping every bounce's intermediates.

Without gradient the bounce loop ends once no ray is active, which costs
a host sync a bounce (`lax.while_loop`'s early exit in JAX); the
differentiable loop runs a fixed max_depth bounces with no sync, as JAX's
fori_loop does. The bounce depth is a Python int: the JAX package's f32
carry works around a TPU compiler fault that torch does not have.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .camera import generate_rays
from .geometry import KIND_PLANE, KIND_SPHERE, Hit, intersect_scene, occluded
from .materials import (
    emission,
    gather_materials,
    layered_eval,
    layered_pdf,
    layered_pdf_true,
    layered_sample,
    layered_sample_direction,
)
from .vec import (
    PI,
    RGB,
    Vec3,
    clip,
    construct_basis,
    dot,
    mag2,
    maximum,
    take,
    where,
)
from .rng import (
    STREAM_BOUNCE_BASE,
    STREAM_CAMERA,
    RayStreams,
    make_ray_streams,
    stream_uniforms,
)

# Russian-roulette constants (Render.cpp:153-165).
RR_BASE = 0.55
RR_YOUNG_SURVIVAL = 0.99
RR_YOUNG_DEPTH = 3
RR_CLAMP_LO = 0.05 / RR_BASE
RR_CLAMP_HI = 0.99

# Bounce-origin offset (Render.cpp:207).
BOUNCE_EPSILON = 1e-4


def russian_roulette_probability(throughput: RGB, depth: int) -> torch.Tensor:
    """Survival probability (Render.cpp:153-165): 0.99 below depth 3, then
    RR_BASE * clip(|throughput|^2)."""
    if depth < RR_YOUNG_DEPTH:
        return torch.full_like(throughput.x, RR_YOUNG_SURVIVAL)
    return RR_BASE * clip(mag2(throughput), RR_CLAMP_LO, RR_CLAMP_HI)


# NEE firefly clamp: per-bounce ceiling = NEE_CLAMP_FACTOR x the brightest
# emission channel (floored at 1), grown by 1/RR_BASE per bounce past the
# young depths (integrator.py:96-134 of the JAX package).
NEE_CLAMP_FACTOR = 16.0
# log(1/RR_BASE) rounded to float32, as jnp.float32(math.log(...)).
_LOG_INV_RR = float(np.float32(math.log(1.0 / RR_BASE)))


def host_nee_clamp(materials: torch.Tensor) -> float:
    """The clamp base from a material table, in float64 on the host
    (pallas_integrator.py::_host_nee_clamp): 16 x max emission channel,
    floored at 1."""
    emission = materials[:, 3:6].detach().cpu().double()
    max_e = float(emission.max()) if emission.numel() else 0.0
    return NEE_CLAMP_FACTOR * max(max_e, 1.0)


def auto_nee_clamp(scene) -> torch.Tensor:
    """The wavefront's clamp base, from the scene's tensors in float32:
    16 x max(max emission channel, 1). Its gradient reaches the brightest
    emission where a contribution is clamped."""
    e = scene.mat_emission
    return NEE_CLAMP_FACTOR * maximum(torch.stack([e.x, e.y, e.z]).max(), 1.0)


def nee_clamp_at_depth(base, depth: int) -> torch.Tensor:
    """base x (1/RR_BASE)^max(depth - 3, 0) in float32, in the exp/log form
    of the JAX package. `base` is a float or a float32 tensor; the growth
    is a CPU scalar, which multiplies a tensor on any device."""
    excess = torch.tensor(float(max(depth - RR_YOUNG_DEPTH, 0)), dtype=torch.float32)
    growth = torch.exp(excess * _LOG_INV_RR)
    if torch.is_tensor(base):
        return base * growth
    return torch.tensor(base, dtype=torch.float32) * growth


class PathState(NamedTuple):
    """The wavefront's state between bounces (RayBatch, Render.cpp:47-82)."""

    origin: Vec3
    direction: Vec3
    throughput: RGB
    radiance: RGB
    active: torch.Tensor
    depth: int
    streams: RayStreams
    # The true density of the direction sampled at the previous vertex:
    # the BSDF side of the MIS weight at an emitter hit (mode "nee").
    prev_pdf: torch.Tensor


def _luminance(c: RGB) -> torch.Tensor:
    return 0.2126 * c.x + 0.7152 * c.y + 0.0722 * c.z


def _light_probs(scene):
    """(S + P,) power-proportional selection probabilities over every
    sphere, then every plane (zero-power ones at 0), and a has-light flag.
    Weights are luminance(L_e) x area (4 PI r^2 with the reference's PI,
    w x h), in float32 from the scene's tensors, so gradients reach
    emission and radius through them; the kernel's host table (ops/
    lights.py) uses float64 and math.pi."""
    e = scene.mat_emission
    lum = lambda mid: _luminance(RGB(take(e.x, mid), take(e.y, mid), take(e.z, mid)))
    w = torch.cat([
        lum(scene.sphere_material) * (4.0 * PI) * scene.sphere_radius ** 2,
        lum(scene.plane_material) * scene.plane_width * scene.plane_height,
    ])
    total = w.sum()
    has_light = total > 0.0
    return w / torch.where(has_light, total, 1.0), has_light


def _grad_safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt(max(x, 0)) whose gradient stays finite at 0: the backward sees
    sqrt(max(x, 1e-20)), so a masked branch cannot send inf * 0 = NaN back
    (integrator.py:207-218 of the JAX package)."""
    return torch.where(x > 0.0, torch.sqrt(maximum(x, 1e-20)), 0.0)


def _cone_pdf(d2: torch.Tensor, radius: torch.Tensor) -> torch.Tensor:
    """Uniform-cone solid-angle density toward a sphere at squared distance
    d2 (0 where the point is inside the sphere)."""
    sin2max = clip(radius * radius / maximum(d2, 1e-12), 0.0, 1.0)
    cos_max = _grad_safe_sqrt(1.0 - sin2max)
    pdf = 1.0 / (2.0 * PI * maximum(1.0 - cos_max, 1e-9))
    return torch.where(d2 > (radius * radius) * (1.0001 ** 2), pdf, 0.0)


def _light_pdf_for_hit(scene, probs: torch.Tensor, from_p: Vec3, hit: Hit) -> torch.Tensor:
    """The NEE density of the direction from `from_p` that produced `hit`:
    selection x cone density for a sphere, selection x t^2 / (A |cos|) for
    a plane; 0 for misses and SDF hits, which light sampling cannot pick."""
    idx = hit.prim.clamp_min(0)
    zeros = torch.zeros_like(from_p.x)
    n_sph = scene.num_spheres
    p_sph = p_pln = zeros
    if n_sph:
        sidx = idx % n_sph
        c = scene.sphere_center
        d2 = ((take(c.x, sidx) - from_p.x) ** 2 + (take(c.y, sidx) - from_p.y) ** 2
              + (take(c.z, sidx) - from_p.z) ** 2)
        p_sph = take(probs, sidx) * _cone_pdf(d2, take(scene.sphere_radius, sidx))
    if scene.num_planes:
        pidx = idx % scene.num_planes
        area = maximum(take(scene.plane_width, pidx) * take(scene.plane_height, pidx), 1e-12)
        pn = scene.plane_normal
        nrm = Vec3(take(pn.x, pidx), take(pn.y, pidx), take(pn.z, pidx))
        # The hit carries no direction: NEE would have sampled the one
        # toward the hit point.
        to_hit = hit.position - from_p
        d_hit = torch.sqrt(maximum(mag2(to_hit), 1e-12))
        wi = Vec3(to_hit.x / d_hit, to_hit.y / d_hit, to_hit.z / d_hit)
        cos_l = torch.abs(dot(wi, nrm))
        p_pln = take(probs, n_sph + pidx) * d_hit * d_hit / (area * maximum(cos_l, 1e-6))
    pdf = torch.where(hit.kind == KIND_SPHERE, p_sph, 0.0)
    pdf = torch.where(hit.kind == KIND_PLANE, p_pln, pdf)
    return torch.where(hit.prim >= 0, pdf, 0.0)


def _sample_light(scene, p: Vec3, u_sel, u1, u2):
    """Pick an emitter by power (spheres, then rectangle planes) and sample
    a direction toward it from p: a uniform cone for a sphere, a uniform
    point with the t^2 / (A cos) Jacobian for a plane (two-sided).

    Returns (wi, t_light, pdf, radiance, valid): pdf is selection x
    solid-angle density; valid is False where nothing emits, p is inside
    the chosen sphere, or the geometry degenerates."""
    n_sph, n_pln = scene.num_spheres, scene.num_planes
    zeros = torch.zeros_like(p.x)
    if n_sph + n_pln == 0:
        z3 = Vec3(zeros, zeros, zeros)
        return z3, zeros, torch.ones_like(zeros), z3, torch.zeros_like(zeros, dtype=torch.bool)

    probs, has_light = _light_probs(scene)
    # The categorical draw: the count of cumulative bounds below u_sel.
    cum = torch.cumsum(probs, 0)
    sel = (u_sel[:, None] > cum[None, :-1]).sum(dim=1)
    p_sel = take(probs, sel)
    mid = take(torch.cat([scene.sphere_material, scene.plane_material]), sel)
    radiance = emission(gather_materials(scene, mid))
    is_plane = sel >= n_sph

    wi_s = wi_p = Vec3(zeros, zeros, zeros)
    t_s = dq = zeros
    pdf_s = pdf_p = torch.ones_like(zeros)
    valid_s = valid_p = torch.zeros_like(zeros, dtype=torch.bool)
    if n_sph:
        ssel = sel.clamp_max(n_sph - 1)
        c = scene.sphere_center
        radius = take(scene.sphere_radius, ssel)
        to_c = Vec3(take(c.x, ssel) - p.x, take(c.y, ssel) - p.y, take(c.z, ssel) - p.z)
        d2 = mag2(to_c)
        d = torch.sqrt(maximum(d2, 1e-12))
        outside = d > radius * 1.0001
        sin2max = clip(radius * radius / maximum(d2, 1e-12), 0.0, 1.0)
        cos_max = _grad_safe_sqrt(1.0 - sin2max)
        one_minus = maximum(1.0 - cos_max, 1e-9)
        cos_t = 1.0 - u1 * one_minus
        sin_t = _grad_safe_sqrt(1.0 - cos_t * cos_t)
        phi = 2.0 * PI * u2
        basis = construct_basis(Vec3(to_c.x / d, to_c.y / d, to_c.z / d))
        wi_s = (
            basis.t * (sin_t * torch.cos(phi))
            + basis.b * (sin_t * torch.sin(phi))
            + basis.n * cos_t
        )
        # Distance along wi_s: the near root of the sphere quadratic.
        t_s = d * cos_t - _grad_safe_sqrt(radius * radius - d2 * (1.0 - cos_t * cos_t))
        pdf_s = p_sel / (2.0 * PI * one_minus)
        valid_s = outside & (t_s > 0.0)
    if n_pln:
        psel = (sel - n_sph).clamp_min(0)
        pn, pp = scene.plane_normal, scene.plane_point
        nrm = Vec3(take(pn.x, psel), take(pn.y, psel), take(pn.z, psel))
        w, h = take(scene.plane_width, psel), take(scene.plane_height, psel)
        pbasis = construct_basis(nrm)
        q = (
            Vec3(take(pp.x, psel), take(pp.y, psel), take(pp.z, psel))
            + pbasis.t * ((u1 - 0.5) * w)
            + pbasis.b * ((u2 - 0.5) * h)
        )
        to_q = q - p
        d2q = mag2(to_q)
        dq = torch.sqrt(maximum(d2q, 1e-12))
        wi_p = Vec3(to_q.x / dq, to_q.y / dq, to_q.z / dq)
        cos_l = torch.abs(dot(wi_p, nrm))
        pdf_p = p_sel * d2q / (maximum(w * h, 1e-12) * maximum(cos_l, 1e-6))
        valid_p = (cos_l > 1e-6) & (dq > 1e-6)

    wi = where(is_plane, wi_p, wi_s)
    t_light = torch.where(is_plane, dq, t_s)
    pdf = torch.where(is_plane, pdf_p, pdf_s)
    valid = has_light & (p_sel > 0.0) & torch.where(is_plane, valid_p, valid_s)
    return wi, t_light, maximum(pdf, 1e-12), radiance, valid


def _detach3(v: Vec3) -> Vec3:
    return Vec3(v.x.detach(), v.y.detach(), v.z.detach())


def _bounce(scene, state: PathState, detach_sampling: bool = False, sampler: str = "uniform",
            index_bits: int = 32, mode: str = "path", nee_clamp=None) -> PathState:
    """One bounce of the wavefront (integrator.py:426-601 of the JAX
    package): intersect, pick up emission, Russian roulette, in mode "nee"
    a light sample and its shadow ray, then the BSDF sample that spawns
    the next rays. detach_sampling detaches the sampled directions, their
    densities and the RR probability (the detached estimator of the
    differentiable mode), and evaluates the BSDF at the detached direction."""
    nee = mode == "nee"
    depth = state.depth
    hit = intersect_scene(scene, state.origin, state.direction)
    active = state.active & hit.hit
    params = gather_materials(scene, hit.material)

    # Emission pickup. nee: an emitter reached by BSDF sampling is weighed
    # against light sampling (weight 1 at depth 0, and where light sampling
    # could not have picked it), and each bounce's term is clamped.
    contrib = state.throughput * emission(params)
    clamp_val = None
    if nee:
        if depth > 0 and scene.num_spheres + scene.num_planes:
            light_probs, _ = _light_probs(scene)
            p_light_hit = _light_pdf_for_hit(scene, light_probs, state.origin, hit)
            w_emis = state.prev_pdf / maximum(state.prev_pdf + p_light_hit, 1e-12)
            contrib = contrib * w_emis
        base = nee_clamp if nee_clamp is not None else auto_nee_clamp(scene)
        clamp_val = nee_clamp_at_depth(base, depth).to(hit.t.device)
        if depth > 0:  # the camera looking straight at an emitter is not clamped
            contrib = RGB(*(torch.minimum(c, clamp_val) for c in contrib))
    radiance = RGB(*(r + torch.where(active, c, 0.0) for r, c in zip(state.radiance, contrib)))

    # Draw columns: (x0, x1) the BSDF lobe, (x2 layer, RR); nee adds
    # (light select, cone u1) and (cone u2, spare).
    u = stream_uniforms(state.streams, STREAM_BOUNCE_BASE + depth, 8 if nee else 4, sampler,
                        index_bits)
    prob = russian_roulette_probability(state.throughput, depth)
    survive = u[:, 3] <= prob  # killed when prob < u (Render.cpp:189)

    basis = construct_basis(hit.normal)
    w_out = -state.direction

    if nee:
        wi_l, t_light, pdf_l, light_le, valid_l = _sample_light(
            scene, hit.position, u[:, 4], u[:, 5], u[:, 6]
        )
        if detach_sampling:
            # The light sample's direction, distance and density are the
            # sampler's; gradients flow through f, L_e, the cosine and MIS.
            wi_l, t_light, pdf_l = _detach3(wi_l), t_light.detach(), pdf_l.detach()
        cos_l = dot(wi_l, hit.normal)
        shadow_origin = hit.position + wi_l * BOUNCE_EPSILON
        visible = ~occluded(scene, shadow_origin, wi_l, t_light * (1.0 - 1e-3))
        f_l = layered_eval(wi_l, w_out, hit.normal, params)
        p_bsdf_l = layered_pdf_true(wi_l, w_out, hit.normal, params)
        mis_l = pdf_l / maximum(pdf_l + p_bsdf_l, 1e-12)
        nee_mask = active & valid_l & visible & (cos_l > 0.0)
        nee_scale = torch.where(nee_mask, mis_l * cos_l / pdf_l, 0.0)
        nee_contrib = state.throughput * f_l * light_le * nee_scale
        radiance = RGB(*(
            r + torch.where(nee_mask, torch.minimum(c, clamp_val), 0.0)
            for r, c in zip(radiance, nee_contrib)
        ))

    if detach_sampling:
        with torch.no_grad():
            wi = layered_sample_direction(w_out, u[:, 0], u[:, 1], u[:, 2], basis, params)
            pdf = (layered_pdf_true if nee else layered_pdf)(wi, w_out, hit.normal, params)
            prob = prob.detach()
        f = layered_eval(wi, w_out, hit.normal, params)
    else:
        wi, pdf, f = layered_sample(w_out, u[:, 0], u[:, 1], u[:, 2], basis, params)
        if nee:  # the true mixture density, not the reference's half-weighted one
            pdf = layered_pdf_true(wi, w_out, hit.normal, params)

    new_origin = hit.position + wi * BOUNCE_EPSILON
    scale = torch.abs(dot(wi, hit.normal)) / (pdf * prob)
    new_throughput = state.throughput * f * scale
    active = active & survive
    return PathState(
        origin=where(active, new_origin, state.origin),
        direction=where(active, wi, state.direction),
        throughput=where(active, new_throughput, state.throughput),
        radiance=radiance,
        active=active,
        depth=depth + 1,
        streams=state.streams,
        prev_pdf=torch.where(active, pdf, state.prev_pdf) if nee else state.prev_pdf,
    )


def trace_paths(scene, origin: Vec3, direction: Vec3, streams: RayStreams, max_depth: int,
                unroll_bounces: bool = False, detach_sampling: bool = False,
                sampler: str = "uniform", index_bits: int = 32, mode: str = "path",
                nee_clamp=None) -> RGB:
    """Trace a wavefront for at most max_depth bounces; per-ray radiance.

    unroll_bounces=True is the differentiable mode's loop: exactly
    max_depth bounces, and with autograd recording each is checkpointed,
    so the backward keeps one bounce's intermediates at a time. Otherwise
    the loop stops once every path has died."""
    ones = torch.ones_like(origin.x)
    zeros = torch.zeros_like(origin.x)
    state = PathState(
        origin=origin,
        direction=direction,
        throughput=RGB(ones, ones, ones),
        radiance=RGB(zeros, zeros, zeros),
        active=torch.ones_like(origin.x, dtype=torch.bool),
        depth=0,
        streams=streams,
        prev_pdf=ones,
    )
    args = (detach_sampling, sampler, index_bits, mode, nee_clamp)
    ckpt = unroll_bounces and torch.is_grad_enabled()
    for _ in range(max_depth):
        if not unroll_bounces and not bool(state.active.any()):  # a host sync
            break
        if ckpt:
            state = checkpoint(_bounce, scene, state, *args, use_reentrant=False,
                               preserve_rng_state=False)
        else:
            state = _bounce(scene, state, *args)
    return state.radiance


def integrate_pixel_samples(scene, root_key: torch.Tensor, pixel_ids: torch.Tensor,
                            sample_idx: torch.Tensor, *, width: int, height: int,
                            spp_total: int, max_depth: int, unroll_bounces: bool = False,
                            detach_sampling: bool = False, sampler: str = "uniform",
                            mode: str = "path", nee_clamp=None) -> torch.Tensor:
    """Trace every (pixel, sample) of pixel_ids x sample_idx, pixel-major;
    per-pixel radiance sums over those samples, (len(pixel_ids), 3). Keys
    depend on the global (pixel, sample) only, so any partition of the
    frame draws the same numbers."""
    num_px, spp = pixel_ids.shape[0], sample_idx.shape[0]
    i = (pixel_ids % width).to(torch.float32)
    j = (pixel_ids // width).to(torch.float32)
    streams = make_ray_streams(root_key, pixel_ids.repeat_interleave(spp),
                               sample_idx.repeat(num_px))
    index_bits = max(1, (spp_total - 1).bit_length())

    # Camera jitter within the pixel footprint (Render.cpp:85-100).
    cam_u = stream_uniforms(streams, STREAM_CAMERA, 2, sampler, index_bits)
    x = (i.repeat_interleave(spp) + cam_u[:, 0]) * (1.0 / width)
    y = (j.repeat_interleave(spp) + cam_u[:, 1]) * (1.0 / height)
    origin, direction = generate_rays(scene.camera, x, y)
    radiance = trace_paths(scene, origin, direction, streams, max_depth, unroll_bounces,
                           detach_sampling, sampler, index_bits, mode, nee_clamp)
    return torch.stack([c.reshape(num_px, spp).sum(dim=1) for c in radiance], dim=-1)


