"""The work a frame needs, counted by the frozen plain version: what
`megakernel_roofline` and `frame_mfu` divide by.

Copied from chip_smoke.py's `counted_work` and `megakernel_bound_ms` (the
OPS table with them), so that the count is the same whatever implements
the kernel. The plain version traces every ray at every depth under a
mask and leaves a finished ray's origin and direction as they were; a
ray is live at a depth when they moved since the depth before. Counts:
"traced" closest-hit scans, "hits" and "later_hits" (after the first
bounce), "bounces", "sdf_hits" (each needing a normal), SDF march steps
by kind up to the best hit of the spheres, planes and earlier SDFs, and
in mode nee "shadow_rays" (valid light samples facing the surface), "lit"
(those unoccluded) and the shadow rays' SDF march steps up to t_max.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import megakernel
from .compile import SceneTables, scene_arrays
from .geometry import sdf_candidate, sdf_march_steps, sdf_objects
from .lights import Lights
from .rng import key_row
from .vec import Vec3, dot

# Float32 operations of each part of the megakernel, counted from the
# port's ops/csrc/megakernel.cu (a sqrt, division, sin, cos or exp counts
# as 1; integer hashing of the draws 0; where the work takes one of two
# branches, the cheaper; so these are lower bounds): camera once a ray;
# ray_pre once a closest-hit scan, per sphere `sphere`, the winner's point
# and normal `sphere_win`, per plane `plane`, with SDF rows `sdf_ray` and
# per SDF `sdf`; `hit`: emission, two draws, Russian roulette; `bounce`:
# basis, lobe, layered_eval, throughput and origin; `bounce_pdf` by mode;
# nee: `nee_hit` every hit, `nee_emission` every later hit, `nee_shadow`
# every shadow ray cast, `nee_shade` every unoccluded light sample;
# `sdf_step` one march step and `sdf_normal` the normal, by SDF kind.
OPS = {
    "camera": 25, "ray_pre": 14, "sphere": 25, "sphere_win": 20, "plane": 35,
    "sdf_ray": 16, "sdf": 6, "hit": 23, "bounce": 247, "bounce_pdf": {"path": 46, "nee": 47},
    "nee_hit": 50, "nee_emission": 13, "nee_shadow": 20, "nee_shade": 243,
    "sdf_step": {0: 44, 1: 55, 2: 48}, "sdf_normal": {0: 101, 1: 145, 2: 117},
}
# Bytes a ray writes (its RGB radiance in float32); the tables the kernel
# reads are a few hundred bytes.
BYTES_PER_RAY = 12
# Rays of a frame that the count traces, and the generator seed that
# draws them: the same subsample every run.
SAMPLE_RAYS = 1 << 16
SAMPLE_SEED = 20260101


def counted_work(run):
    """(run()'s result, the counts of the work for the rays it traced):
    run() calls `megakernel.render_rays_reference`, whose `intersect`,
    `_sample_light` and `occluded` are wrapped for the call."""
    names = ("intersect", "_sample_light", "occluded")
    orig = {name: getattr(megakernel, name) for name in names}
    counts, state = {}, {}

    def add(key, mask):
        counts[key] = counts.get(key, 0) + mask.sum()

    def intersect(tables, o, d):
        out = orig["intersect"](tables, o, d)
        _t, _p, n, _mid, prim, hit = out
        od = torch.stack([*o, *d])
        later = "od" in state
        live = (state["live"] & (od != state["od"]).any(0)) if later else torch.ones_like(hit)
        if later:
            add("bounces", live)
            add("later_hits", live & hit)
        state.update(od=od, live=live, shaded=live & hit, n=n)
        add("traced", live)
        add("hits", live & hit)
        add("sdf_hits", live & hit & (prim < 0))
        if tables.sdfs.shape[0]:
            lo, ld = Vec3(*(c[live] for c in o)), Vec3(*(c[live] for c in d))
            best = orig["intersect"](tables._replace(sdfs=tables.sdfs[:0]), lo, ld)[0]
            for kind, center, params, _m, rot, scale in sdf_objects(scene_arrays(tables)):
                add(("march", kind), sdf_march_steps(lo, ld, kind, center, params, rot, scale,
                                                     limit=best))
                t, _p, _n, valid = sdf_candidate(lo, ld, kind, center, params, rot=rot,
                                                 scale=scale, with_normal=False, limit=best)
                best = torch.where(valid & (best > t), t, best)
        return out

    def sample_light(*args):
        out = orig["_sample_light"](*args)
        wi, _t, _pdf, valid, _le = out
        state["cast"] = state["shaded"] & valid & (dot(wi, state["n"]) > 0.0)
        add("shadow_rays", state["cast"])
        return out

    def occluded(tables, o, d, t_max):
        occ = orig["occluded"](tables, o, d, t_max)
        add("lit", state["cast"] & ~occ)
        if tables.sdfs.shape[0]:
            left = state["cast"] & ~orig["occluded"](tables._replace(sdfs=tables.sdfs[:0]), o, d,
                                                     t_max)
            for kind, center, params, _m, rot, scale in sdf_objects(scene_arrays(tables)):
                idx = left.nonzero().flatten()
                so, sd = Vec3(*(c[idx] for c in o)), Vec3(*(c[idx] for c in d))
                add(("shadow", kind), sdf_march_steps(so, sd, kind, center, params, rot, scale,
                                                      limit=t_max[idx]))
                t, _p, _n, valid = sdf_candidate(so, sd, kind, center, params, rot=rot,
                                                 scale=scale, with_normal=False, limit=t_max[idx])
                left[idx] = ~(valid & (t < t_max[idx]))
        return occ

    wrappers = {"intersect": intersect, "_sample_light": sample_light, "occluded": occluded}
    try:
        for name in names:
            setattr(megakernel, name, wrappers[name])
        result = run()
    finally:
        for name in names:
            setattr(megakernel, name, orig[name])
    work = {"march_steps": {}, "shadow_steps": {}}
    for key, n in counts.items():
        if isinstance(key, tuple):
            work[f"{key[0]}_steps"][key[1]] = int(n)
        else:
            work[key] = int(n)
    return result, work


def traced_ops(work: dict, tables: SceneTables, mode: str) -> float:
    """Float32 operations of the counted work beyond the camera."""
    n_s, n_p, n_k = (tables.spheres.shape[0], tables.planes.shape[0], tables.sdfs.shape[0])
    scan = (OPS["ray_pre"] + n_s * OPS["sphere"] + (n_s > 0) * OPS["sphere_win"]
            + n_p * OPS["plane"] + (n_k > 0) * (OPS["sdf_ray"] + n_k * OPS["sdf"]))
    kinds = [int(k) for k in tables.sdfs[:, 0].tolist()]
    ops = (
        work["traced"] * scan
        + work["hits"] * OPS["hit"]
        + work.get("bounces", 0) * (OPS["bounce"] + OPS["bounce_pdf"][mode])
        + sum(OPS["sdf_step"][k] * n for k, n in work["march_steps"].items())
        + sum(OPS["sdf_step"][k] * n for k, n in work["shadow_steps"].items())
        + (work["sdf_hits"] * min(OPS["sdf_normal"][k] for k in kinds) if kinds else 0)
    )
    if mode == "nee":
        ops += (work["hits"] * OPS["nee_hit"] + work.get("later_hits", 0) * OPS["nee_emission"]
                + work.get("shadow_rays", 0) * OPS["nee_shadow"]
                + work.get("lit", 0) * OPS["nee_shade"])
    return float(ops)


def frame_work(tables: SceneTables, lights: Lights, seed: int, *, width: int, height: int,
               spp: int, max_depth: int, integrator: str, sampler: str,
               sample_rays: int = SAMPLE_RAYS) -> Tuple[float, float, dict]:
    """(float32 operations, bytes, the counts) of one frame: the work of a
    fixed subsample of its (pixel, sample) rays, traced by the plain
    version on the tables' device with the frame's draws, scaled to the
    frame's width x height x spp rays."""
    device = tables.camera.device
    n_rays = width * height * spp
    gen = torch.Generator().manual_seed(SAMPLE_SEED)
    pixel = torch.randint(0, width * height, (sample_rays,), generator=gen).to(device)
    sample = torch.randint(0, spp, (sample_rays,), generator=gen).to(device)
    k0, k1, root = key_row(seed)

    def run():
        return megakernel.render_rays_reference(
            tables, k0, k1, width, height, 0, 0, max_depth, device, root=root, sampler=sampler,
            mode=integrator, index_bits=megakernel.index_bits_for(spp),
            lights=lights if integrator == "nee" else None, pixel=pixel, sample=sample,
        )

    _, work = counted_work(run)
    ops = n_rays * OPS["camera"] + traced_ops(work, tables, integrator) * n_rays / sample_rays
    return ops, float(n_rays * BYTES_PER_RAY), work
