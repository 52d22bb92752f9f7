"""The path-tracing megakernel: CUDA wrapper, plain torch version, chunks.

Counterpart of `cornelis_tpu/ops/pallas_integrator.py` on spheres, planes
and SDF primitives, in modes "path" and "nee" with samplers "uniform" and
"sobol".
`render_rays` launches the hand-written CUDA kernel
(ops/csrc/megakernel.cu) for tables on a CUDA device, and runs
`render_rays_reference` for tables on the CPU. The reference is a masked
torch wavefront of the same bounce, written step by step after
`_make_kernel` from the ported modules; it is what the CPU tests hold
against the JAX kernel and what chip_smoke.py holds the CUDA kernel
against on the card.

Ray k of a chunk is (pixel k // spp_chunk, sample offset + k % spp_chunk),
or, given `pixel_ids` (a mesh rank's shard, parallel/render.py), (pixel
pixel_ids[k // spp_chunk], sample offset + k % spp_chunk): the port of the
mesh megakernel's `px` and `si` operands. Both versions write one RGB
radiance per ray into an (n_rays, 3) float32 tensor; `render_chunk` sums
each pixel's samples outside the kernel.
Mode "nee" reads a light table (ops/lights.py): K1's `Lights`, built on
the host, or `IN_LAUNCH`, the dynamic-scene kernel's (K3,
`render_chunk_dynamic`), which the launch builds itself from the tables.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from ..camera import camera_from_row, generate_rays
from ..geometry import KIND_PLANE, KIND_SPHERE, intersect_scene
from ..geometry import occluded as geometry_occluded
from ..integrator import BOUNCE_EPSILON, nee_clamp_at_depth, russian_roulette_probability
from ..materials import gather_material_rows, layered_eval, layered_pdf_true, layered_sample
from ..math.vec import PI, RGB, Vec3, construct_basis, dot, where
from ..sampling import hash32, sobol_pair
from ..scene.compile import SDF_COLS, SceneTables, scene_arrays
from . import lights as L
from .build import launch, load_library
from .threefry import pair_uniforms

# Kernel launches made by `render_rays` in this process, those of them
# through an SDF instantiation, those through the instantiations that
# build K3's light table in the launch (`IN_LAUNCH`), and those of K3
# that walked its sphere hierarchy, more than one leaf of WALK_LEAF
# spheres (csrc/megakernel.cu's walk::LEAF). chip_smoke.py zeroes them
# before driving a main path and reads them after.
LAUNCHES = 0
SDF_LAUNCHES = 0
DYNAMIC_TABLE_LAUNCHES = 0
HIERARCHY_LAUNCHES = 0
WALK_LEAF = 8

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
    lights=None,
    pixel: Optional[torch.Tensor] = None,
    sample: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The plain torch version of the kernel: (n_rays, 3) radiance. Mode
    "nee" reads `lights` as `render_rays` does: K1's `Lights`, or
    `IN_LAUNCH`, for which it traces with `light_table_dyn_reference`'s.

    With `pixel` and `sample` (equal-length integer tensors) it traces
    those rays instead of the chunk's; spp_chunk and offset are then
    unused."""
    _check_launch(tables, sampler, mode, lights)
    if lights is L.IN_LAUNCH:
        lights = L.light_table_dyn_reference(tables)
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


def _set_argtypes(fn, lights: bool):
    """fn, its ctypes argument types set: the light table's three after
    index_bits where `lights`."""
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    fn.argtypes = [
        p, p, i, p, i, p, i,  # camera, spheres, n_spheres, planes, n_planes, materials, n_materials
        p, i,  # sdfs, n_sdfs
        p, p, ctypes.c_longlong,  # out, counter, n_rays
        u, u, u,  # k0, k1, root
        i, ctypes.c_float, ctypes.c_float,  # width, inv_width, inv_height
        i, u, p, i,  # spp_chunk, sample_offset, pixel_ids, max_depth
        i, i,  # sobol, index_bits
        *((p, i, p) if lights else ()),  # lights, n_lights, clamp
        p,  # stream
    ]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _kernel_fn(nee: bool):
    """The C entry point of mode "nee" (libmegakernel_nee) or "path"."""
    if nee:
        return _set_argtypes(load_library("megakernel_nee").cornelis_megakernel_nee, True)
    return _set_argtypes(load_library("megakernel").cornelis_megakernel, False)


@functools.lru_cache(maxsize=None)
def _in_launch_fn():
    """The C entry point of mode "nee" that builds K3's light table in the
    launch (libmegakernel_nee); the arguments of mode "path"'s."""
    return _set_argtypes(load_library("megakernel_nee").cornelis_megakernel_nee_dynamic, False)


def dynamic_occupancy(tables: SceneTables, sampler: str = "sobol") -> tuple:
    """K3's resident blocks an SM on the current CUDA device for these
    tables' counts, and the shared memory its launch asks for (0: the
    tables are staged in device memory)."""
    fn = load_library("megakernel_nee").cornelis_megakernel_nee_dynamic_occupancy
    blocks, smem = ctypes.c_int(), ctypes.c_int()
    err = fn(tables.spheres.shape[0], tables.planes.shape[0], tables.materials.shape[0],
             int(sampler == "sobol"), ctypes.byref(blocks), ctypes.byref(smem))
    if err != 0:
        raise RuntimeError(f"K3's occupancy query failed with CUDA error {err}")
    return blocks.value, smem.value


def check_tables(tables: SceneTables) -> None:
    widths = {"camera": None, "spheres": 5, "planes": 9, "materials": 11, "sdfs": SDF_COLS}
    device = tables.camera.device
    for name, t in zip(SceneTables._fields, tables):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != device:
            raise ValueError(f"table {name} must be contiguous float32 on {device}")
        w = widths[name]
        if (w is None and t.shape != (12,)) or (w is not None and (t.ndim != 2 or t.shape[1] != w)):
            raise ValueError(f"table {name} has shape {tuple(t.shape)}")
    if tables.materials.shape[0] == 0:
        raise ValueError("the material table is empty")


def _refuse_sdfs(tables: SceneTables) -> None:
    if tables.sdfs.shape[0]:
        raise NotImplementedError(
            "the dynamic-scene kernel (K3) takes no SDF primitives (as cornelis_tpu's "
            "render_chunk_pallas_dynamic); render SDF scenes with render_chunk"
        )


def _check_launch(tables: SceneTables, sampler: str, mode: str, lights, pixel_ids=None) -> None:
    """Refuse what no instantiation renders. Mode "nee" reads K1's `Lights`
    (float32 and contiguous on the tables' device) or `IN_LAUNCH`, which
    the launch builds from the spheres and planes alone: not in mode
    "path", with no `pixel_ids`, with a sphere or a plane (ValueError),
    and with no SDF rows (NotImplementedError)."""
    if sampler not in SAMPLERS:
        raise ValueError(f"sampler must be one of {SAMPLERS} (not {sampler!r})")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES} (not {mode!r})")
    device = tables.camera.device
    if lights is L.IN_LAUNCH:
        if mode != "nee" or pixel_ids is not None:
            raise ValueError("IN_LAUNCH builds mode 'nee''s light table in the launch: it takes "
                             "no pixel_ids")
        _refuse_sdfs(tables)
        L._check_dyn(tables)
    elif mode == "nee":
        if lights is None:
            raise ValueError("mode 'nee' needs a light table: a Lights or IN_LAUNCH "
                             "(ops/lights.py)")
        rows, clamp = lights
        for name, t in (("rows", rows), ("clamp", clamp)):
            if t.dtype != torch.float32 or not t.is_contiguous() or t.device != device:
                raise ValueError(f"light {name} must be contiguous float32 on {device}")
        if rows.ndim != 2 or rows.shape[1] != L.LIGHT_COLS or clamp.shape != (1,):
            raise ValueError(f"light table shapes {tuple(rows.shape)}, {tuple(clamp.shape)}")
    if pixel_ids is not None and (
            pixel_ids.dtype != torch.int32 or pixel_ids.ndim != 1
            or not pixel_ids.is_contiguous() or pixel_ids.device != device):
        raise ValueError(f"pixel_ids must be a contiguous 1-D int32 tensor on {device}")


def _launch_into(out, tables, k0, k1, width, height, spp_chunk, offset, max_depth, *, root,
                sampler, mode, index_bits, lights, pixel_ids=None, entry=None) -> None:
    """Launch the kernel on checked CUDA tables, writing ray k's radiance to
    out[k] ((n_rays, 3) float32 on the tables' device); with checked
    `pixel_ids`, ray k is pixel pixel_ids[k // spp_chunk]'s. The kernel's
    blocks take rays in no fixed order, through a ray counter that this
    launch allocates and the C entry zeroes on the launch's stream. With
    `IN_LAUNCH` the launch builds K3's light table itself. `entry`
    replaces the C entry point (one with the same arguments, from another
    build of the same source)."""
    nee, in_launch = mode == "nee", lights is L.IN_LAUNCH
    counter = torch.empty((1,), dtype=torch.int32, device=out.device)
    light_args = (
        (lights.rows.data_ptr(), lights.rows.shape[0], lights.clamp.data_ptr())
        if nee and not in_launch else ()
    )
    if entry is None:
        entry = _in_launch_fn() if in_launch else _kernel_fn(nee)
    launch(
        entry,
        out.device,
        tables.camera.data_ptr(),
        tables.spheres.data_ptr(),
        tables.spheres.shape[0],
        tables.planes.data_ptr(),
        tables.planes.shape[0],
        tables.materials.data_ptr(),
        tables.materials.shape[0],
        tables.sdfs.data_ptr(),
        tables.sdfs.shape[0],
        out.data_ptr(),
        counter.data_ptr(),
        out.shape[0],
        k0,
        k1,
        root,
        width,
        1.0 / width,
        1.0 / height,
        spp_chunk,
        offset,
        None if pixel_ids is None else pixel_ids.data_ptr(),
        max_depth,
        int(sampler == "sobol"),
        index_bits,
        *light_args,
    )


def render_rays(
    tables: SceneTables,
    k0: int,
    k1: int,
    width: int,
    height: int,
    spp_chunk: int,
    offset: int,
    max_depth: int,
    *,
    root: int = 0,
    sampler: str = "uniform",
    mode: str = "path",
    index_bits: int = 32,
    lights=None,
    pixel_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(n_rays, 3) radiance on the tables' device: the CUDA kernel on a CUDA
    device, the plain version on the CPU. A failed launch raises. Tables
    with SDF rows launch the SDF instantiation (`SDF_LAUNCHES` counts
    those launches too). With `pixel_ids` (contiguous int32 frame pixel
    indices on the tables' device) the launch traces those pixels' rays,
    len(pixel_ids) x spp_chunk of them, pixel-major. Mode "nee" reads
    `lights`: K1's `Lights`, or `IN_LAUNCH` (no SDF rows, no `pixel_ids`)
    for K3's light table and clamp base: on a CUDA device the launch
    builds them from the tables in every block (`DYNAMIC_TABLE_LAUNCHES`
    counts those launches too, `HIERARCHY_LAUNCHES` those over more than
    WALK_LEAF spheres, whose scans walk the sphere hierarchy the launch
    builds), on the CPU `lights.light_table_dyn_reference` does."""
    global LAUNCHES, SDF_LAUNCHES, DYNAMIC_TABLE_LAUNCHES, HIERARCHY_LAUNCHES
    check_tables(tables)
    _check_launch(tables, sampler, mode, lights, pixel_ids)
    device = tables.camera.device
    n_pixels = width * height if pixel_ids is None else pixel_ids.shape[0]
    if device.type == "cpu":
        pixel = sample = None
        if pixel_ids is not None:
            pixel = pixel_ids.repeat_interleave(spp_chunk)
            sample = offset + torch.arange(spp_chunk, dtype=torch.int64).repeat(n_pixels)
        return render_rays_reference(
            tables, k0, k1, width, height, spp_chunk, offset, max_depth, device,
            root=root, sampler=sampler, mode=mode, index_bits=index_bits, lights=lights,
            pixel=pixel, sample=sample,
        )
    if device.type != "cuda":
        raise ValueError(f"no megakernel for device {device}")
    out = torch.empty((n_pixels * spp_chunk, 3), dtype=torch.float32, device=device)
    _launch_into(out, tables, k0, k1, width, height, spp_chunk, offset, max_depth, root=root,
                sampler=sampler, mode=mode, index_bits=index_bits, lights=lights,
                pixel_ids=pixel_ids)
    in_launch = lights is L.IN_LAUNCH
    LAUNCHES += 1
    SDF_LAUNCHES += int(tables.sdfs.shape[0] > 0)
    DYNAMIC_TABLE_LAUNCHES += int(in_launch)
    HIERARCHY_LAUNCHES += int(in_launch and tables.spheres.shape[0] > WALK_LEAF)
    return out


def render_chunk(
    tables: SceneTables,
    key: tuple,
    sample_offset: int,
    *,
    width: int,
    height: int,
    spp_chunk: int,
    spp_total: int,
    max_depth: int,
    sampler: str = "uniform",
    mode: str = "path",
    nee_clamp: Optional[float] = None,
    lights=None,
) -> torch.Tensor:
    """(H, W, 3) radiance sums over one chunk of samples per pixel, through
    `render_rays` (`render_chunk_pallas`). `key` is the key row
    (k0, k1, root) of `rng.key_row`. Mode "nee" builds K1's light table
    from `nee_clamp` unless `lights` brings a table (a session builds K1's
    once) or `IN_LAUNCH` (see `render_rays`)."""
    k0, k1, root = key
    if mode == "nee" and lights is None:
        lights = L.light_table(tables, nee_clamp)
    rays = render_rays(
        tables, k0, k1, width, height, spp_chunk, sample_offset, max_depth,
        root=root, sampler=sampler, mode=mode, index_bits=index_bits_for(spp_total),
        lights=lights,
    )
    return rays.view(width * height, spp_chunk, 3).sum(dim=1).view(height, width, 3)


def render_chunk_dynamic(
    tables: SceneTables,
    key: tuple,
    sample_offset: int,
    *,
    width: int,
    height: int,
    spp_chunk: int,
    spp_total: int,
    max_depth: int,
    sampler: str = "uniform",
    mode: str = "path",
) -> torch.Tensor:
    """The dynamic-scene render (K3): `render_chunk` with K3's light table
    in mode "nee" (`IN_LAUNCH`); mode "path" reads none.

    Counterpart of `cornelis_tpu/ops/pallas_dynamic.py::
    render_chunk_pallas_dynamic`. On the TPU that was a second kernel: the
    baked megakernel took the scene as literals, so a kernel that read the
    tables as operands had to be written apart, with the NEE light table
    built inside it from the traced tables at the top of every grid step.
    This megakernel already reads every table as an operand, so K3 is the
    same CUDA bounce loop (ops/csrc/megakernel.cu); in mode "nee" its
    dynamic-table instantiations build the light table and clamp base
    (every sphere and plane a row, in float32) in each block's prologue
    from the tables it has just staged, with no launch of their own, and
    beside them a hierarchy of boxes over the spheres, which their
    closest-hit and shadow scans walk instead of testing every sphere (bit
    for bit the same rays). An edit of the tables in place (a new emission,
    a moved sphere) re-renders with no rebuild and no host round trip. On
    the CPU the plain version takes the table from
    `lights.light_table_dyn_reference`; K3 takes no clamp override.

    Like the JAX function (pallas_dynamic.py:591-595), it takes no SDFs in
    either mode: tables with SDF rows raise NotImplementedError (render
    such scenes with `render_chunk`, K1's SDF instantiations). In mode
    "nee" a scene with no sphere and no plane raises ValueError."""
    _refuse_sdfs(tables)
    return render_chunk(
        tables, key, sample_offset, width=width, height=height, spp_chunk=spp_chunk,
        spp_total=spp_total, max_depth=max_depth, sampler=sampler, mode=mode,
        lights=L.IN_LAUNCH if mode == "nee" else None,
    )
