"""The megakernel's plain torch version, frozen from the port's
`ops/megakernel.py::render_rays_reference`: a masked wavefront of the
kernel's bounce, spheres, planes and SDF primitives, modes "path" and
"nee", samplers "uniform" and "sobol".

Ray (pixel, sample) draws its numbers from the run's key row (k0, k1,
root) and its (pixel, sample) only, so any subset of a frame's rays can
be traced on its own and meets the kernel's draws.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import lights as L
from .camera import camera_from_row, generate_rays
from .compile import SceneTables, scene_arrays
from .geometry import KIND_PLANE, KIND_SPHERE, intersect_scene
from .geometry import occluded as geometry_occluded
from .integrator import BOUNCE_EPSILON, nee_clamp_at_depth, russian_roulette_probability
from .materials import gather_material_rows, layered_eval, layered_pdf_true, layered_sample
from .sampling import hash32, sobol_pair
from .threefry import pair_uniforms
from .vec import PI, RGB, Vec3, construct_basis, dot, where

SAMPLERS = ("uniform", "sobol")
MODES = ("path", "nee")
TWO_PI = 2.0 * PI


def index_bits_for(spp_total: int) -> int:
    """Sobol index bits: ceil-log2 of the per-pixel sample budget."""
    return max(1, (spp_total - 1).bit_length())


def intersect(tables: SceneTables, o: Vec3, d: Vec3):
    """Closest hit against the tables (`_intersect_const`), which scans as
    `geometry.intersect_scene` does: a t-only sphere scan, one fetch of the
    winning sphere, the finite planes, then every SDF sphere-traced;
    strict best_t > t updates. Returns (t, p, n, material id, prim, hit),
    where prim is the unified index: sphere i -> i, plane j -> S + j, SDF
    or miss -> -1 (SDF emitters are not light sampled, so their MIS
    weight is 1)."""
    hit = intersect_scene(scene_arrays(tables), o, d)
    prim = torch.where(hit.kind == KIND_SPHERE, hit.prim, -1)
    prim = torch.where(hit.kind == KIND_PLANE, tables.spheres.shape[0] + hit.prim, prim)
    return hit.t, hit.position, hit.normal, hit.material, prim, hit.hit


def occluded(tables: SceneTables, o: Vec3, d: Vec3, t_max: torch.Tensor) -> torch.Tensor:
    """Any hit closer than t_max (`_occluded_const`): `geometry.occluded`
    on the tables."""
    return geometry_occluded(scene_arrays(tables), o, d, t_max)


def _draws(sampler, k0, k1, root, pixel, sample, index_bits):
    """(stream, pair) -> two uniforms of every ray, as in `_make_kernel`."""
    if sampler == "sobol":
        seed = hash32(pixel ^ root)
        return lambda stream, pair: sobol_pair(seed, sample, stream, pair, index_bits)
    return lambda stream, pair: pair_uniforms(k0, k1, pixel, sample, stream, pair)


def _emission_pickup(rows, kinds, prims, o, d, t, prim):
    """The density with which light sampling picks the emitter that the
    BSDF-sampled ray hit (0 off the table), as in `_make_kernel`'s MIS."""
    p_light = torch.zeros_like(t)
    for r, (kind, lprim) in enumerate(zip(kinds, prims)):
        row = rows[r]
        pr = row[L.COL_PROB]
        g = row[L.COL_G:L.COL_G + 8]
        if kind == 0:
            dx, dy, dz = g[0] - o.x, g[1] - o.y, g[2] - o.z
            d2 = dx * dx + dy * dy + dz * dz
            sin2max = torch.clamp(row[L.COL_R2] / torch.clamp_min(d2, 1e-12), 0.0, 1.0)
            cos_max = torch.sqrt(torch.clamp_min(1.0 - sin2max, 0.0))
            cand = pr / (TWO_PI * torch.clamp_min(1.0 - cos_max, 1e-9))
            cand = torch.where(d2 > row[L.COL_R2_EDGE], cand, 0.0)
        else:
            cos_l = torch.abs(d.x * g[0] + d.y * g[1] + d.z * g[2])
            cand = pr * t * t / (row[L.COL_AREA] * torch.clamp_min(cos_l, 1e-6))
        p_light = torch.where(prim == lprim, cand, p_light)
    return p_light


def _sample_light(rows, kinds, p, u_sel, ul1, ul2):
    """Pick a table row by its cumulative probability and sample a
    direction toward it: a uniform cone for a sphere, a uniform point for
    a plane. Returns (wi, t_light, pdf, valid, L_e)."""
    idx = torch.zeros(u_sel.shape, dtype=torch.int64, device=u_sel.device)
    for i in range(1, len(kinds)):
        idx = torch.where(u_sel > rows[i - 1, L.COL_CUM], i, idx)
    sel = rows[idx]
    lg = [sel[:, L.COL_G + i] for i in range(8)]
    lpr = sel[:, L.COL_PROB]
    le = RGB(sel[:, L.COL_LE], sel[:, L.COL_LE + 1], sel[:, L.COL_LE + 2])
    has_sph, has_pln = 0 in kinds, 1 in kinds

    if has_sph:
        lrad = lg[3]
        to_c = Vec3(lg[0] - p.x, lg[1] - p.y, lg[2] - p.z)
        d2 = to_c.x * to_c.x + to_c.y * to_c.y + to_c.z * to_c.z
        dist = torch.sqrt(torch.clamp_min(d2, 1e-12))
        outside = dist > lrad * 1.0001
        sin2max = torch.clamp(lrad * lrad / torch.clamp_min(d2, 1e-12), 0.0, 1.0)
        cos_max = torch.sqrt(torch.clamp_min(1.0 - sin2max, 0.0))
        one_minus = torch.clamp_min(1.0 - cos_max, 1e-9)
        cos_t = 1.0 - ul1 * one_minus
        sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
        phi = TWO_PI * ul2
        lbasis = construct_basis(Vec3(to_c.x / dist, to_c.y / dist, to_c.z / dist))
        wi_s = (
            lbasis.t * (sin_t * torch.cos(phi))
            + lbasis.b * (sin_t * torch.sin(phi))
            + lbasis.n * cos_t
        )
        t_s = dist * cos_t - torch.sqrt(
            torch.clamp_min(lrad * lrad - d2 * (1.0 - cos_t * cos_t), 0.0)
        )
        pdf_s = lpr / (TWO_PI * one_minus)
        valid_s = outside & (t_s > 0.0)
    if has_pln:
        lnrm = Vec3(lg[0], lg[1], lg[2])
        pl_basis = construct_basis(lnrm)
        q = (
            Vec3(lg[3], lg[4], lg[5])
            + pl_basis.t * ((ul1 - 0.5) * lg[6])
            + pl_basis.b * ((ul2 - 0.5) * lg[7])
        )
        to_q = Vec3(q.x - p.x, q.y - p.y, q.z - p.z)
        d2q = to_q.x * to_q.x + to_q.y * to_q.y + to_q.z * to_q.z
        dq = torch.sqrt(torch.clamp_min(d2q, 1e-12))
        wi_p = Vec3(to_q.x / dq, to_q.y / dq, to_q.z / dq)
        cos_lp = torch.abs(dot(wi_p, lnrm))  # two-sided emitter
        area = torch.clamp_min(lg[6] * lg[7], 1e-12)
        pdf_p = lpr * d2q / (area * torch.clamp_min(cos_lp, 1e-6))
        valid_p = (cos_lp > 1e-6) & (dq > 1e-6)

    if has_sph and has_pln:
        is_pln = sel[:, L.COL_KIND] > 0.5
        wi = where(is_pln, wi_p, wi_s)
        t_light = torch.where(is_pln, dq, t_s)
        pdf = torch.where(is_pln, pdf_p, pdf_s)
        valid = torch.where(is_pln, valid_p, valid_s)
    elif has_pln:
        wi, t_light, pdf, valid = wi_p, dq, pdf_p, valid_p
    else:
        wi, t_light, pdf, valid = wi_s, t_s, pdf_s, valid_s
    return wi, t_light, torch.clamp_min(pdf, 1e-12), valid, le


def render_rays_reference(
    tables: SceneTables,
    k0: int,
    k1: int,
    width: int,
    height: int,
    spp_chunk: int,
    offset: int,
    max_depth: int,
    device,
    *,
    root: int = 0,
    sampler: str = "uniform",
    mode: str = "path",
    index_bits: int = 32,
    lights: Optional[L.Lights] = None,
    pixel: Optional[torch.Tensor] = None,
    sample: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The plain torch version of the kernel: (n_rays, 3) radiance.

    With `pixel` and `sample` (equal-length integer tensors) it traces
    those rays instead of the chunk's; spp_chunk and offset are then
    unused."""
    _check_variant(sampler, mode, lights)
    tables = tables.to(device)
    if pixel is None:
        k = torch.arange(width * height * spp_chunk, dtype=torch.int64, device=device)
        pixel = k // spp_chunk
        sample = offset + k % spp_chunk
    else:
        pixel = pixel.to(device=device, dtype=torch.int64)
        sample = sample.to(device=device, dtype=torch.int64)
    draw = _draws(sampler, k0, k1, root, pixel, sample, index_bits)

    # Camera jitter (stream 0, pair 0) and generate_rays.
    u0, u1 = draw(0, 0)
    fi = (pixel % width).to(torch.float32)
    fj = (pixel // width).to(torch.float32)
    x = (fi + u0) * (1.0 / width)
    y = (fj + u1) * (1.0 / height)
    o, d = generate_rays(camera_from_row(tables.camera), x, y)

    nee = mode == "nee"
    n_lights = lights.rows.shape[0] if nee else 0
    if n_lights:
        rows = lights.rows.to(device)
        meta = lights.rows[:, [L.COL_KIND, L.COL_PRIM]].detach().cpu().to(torch.int64).tolist()
        kinds = [k for k, _ in meta]
        prims = [p for _, p in meta]
        clamp_base = lights.clamp.to(device)[0]

    ones = torch.ones_like(x)
    zeros = torch.zeros_like(x)
    black = RGB(zeros, zeros, zeros)
    tput = RGB(ones, ones, ones)
    rad = black
    prev_pdf = ones
    active = torch.ones_like(x, dtype=torch.bool)
    for depth in range(max_depth):
        if not bool(active.any()):
            break
        t, p, n, mid, prim, hit = intersect(tables, o, d)
        active = active & hit
        params = gather_material_rows(tables.materials, mid)
        contrib = tput * params.emission
        if n_lights:
            # MIS weight of an emitter reached by BSDF sampling, and the
            # depth-aware clamp; depth 0 is neither weighted nor clamped.
            if depth > 0:
                p_light = _emission_pickup(rows, kinds, prims, o, d, t, prim)
                w_emis = prev_pdf / torch.clamp_min(prev_pdf + p_light, 1e-12)
                cl = nee_clamp_at_depth(clamp_base, depth)
            else:
                w_emis = ones
                cl = torch.tensor(math.inf, device=device)
            contrib = RGB(*(torch.minimum(c * w_emis, cl) for c in contrib))
        rad = rad + where(active, contrib, black)

        # Pair 0 = BSDF lobe (x0, x1); pair 1 = (x2 layer choice, RR); nee
        # adds pair 2 = (light select, cone u1) and pair 3 = (cone u2, spare).
        stream = depth + 1
        x0, x1 = draw(stream, 0)
        x2, u_rr = draw(stream, 1)
        prob = russian_roulette_probability(tput, depth)
        survive = u_rr <= prob
        w_out = -d

        if n_lights:
            u_sel, ul1 = draw(stream, 2)
            ul2, _spare = draw(stream, 3)
            wi_l, t_light, pdf_l, valid_l, le = _sample_light(rows, kinds, p, u_sel, ul1, ul2)
            cos_surf = dot(wi_l, n)
            shadow_o = p + wi_l * BOUNCE_EPSILON
            pre_mask = active & valid_l & (cos_surf > 0.0)
            visible = ~occluded(tables, shadow_o, wi_l, t_light * (1.0 - 1e-3))
            f_l = layered_eval(wi_l, w_out, n, params)
            p_bsdf_l = layered_pdf_true(wi_l, w_out, n, params)
            mis_l = pdf_l / torch.clamp_min(pdf_l + p_bsdf_l, 1e-12)
            nee_scale = torch.where(pre_mask & visible, mis_l * cos_surf / pdf_l, 0.0)
            cl2 = nee_clamp_at_depth(clamp_base, depth)
            rad = rad + RGB(
                *(torch.minimum(tc * fc * lc * nee_scale, cl2)
                  for tc, fc, lc in zip(tput, f_l, le))
            )

        wi, pdf, f = layered_sample(w_out, x0, x1, x2, construct_basis(n), params)
        if nee:
            pdf = layered_pdf_true(wi, w_out, n, params)
        new_o = p + wi * BOUNCE_EPSILON
        scale = torch.abs(dot(wi, n)) / (pdf * prob)
        new_tput = tput * f * scale

        active = active & survive
        o = where(active, new_o, o)
        d = where(active, wi, d)
        tput = where(active, new_tput, tput)
        if nee:
            prev_pdf = torch.where(active, pdf, prev_pdf)
    return torch.stack([rad.x, rad.y, rad.z], dim=1)


def _check_variant(sampler: str, mode: str, lights: Optional[L.Lights]) -> None:
    if sampler not in SAMPLERS:
        raise ValueError(f"sampler must be one of {SAMPLERS} (not {sampler!r})")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES} (not {mode!r})")
    if mode == "nee" and lights is None:
        raise ValueError("mode 'nee' needs a light table (ops/lights.py)")
