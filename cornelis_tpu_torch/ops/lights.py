"""The NEE light-selection table: two constructions with one row layout.

Counterpart of `cornelis_tpu/ops/pallas_integrator.py::_light_table` and
`_host_nee_clamp` (the baked megakernel, K1), and of
`cornelis_tpu/ops/pallas_dynamic.py::_light_rows_dyn` and `_clamp_base_dyn`
(the dynamic-scene kernel, K3). Both kernels read the same table through
one CUDA bounce loop (ops/csrc/megakernel.cu); they differ only in how the
table is built, and each construction copies its JAX counterpart as it stands:

  * `light_table` (K1) runs on the host in float64 and rounds to float32,
    as K1 folds its Python-float table constants before they become
    float32 literals. Zero-power rows are dropped; a scene with nothing
    emitting has no rows (then no light is sampled).
  * `light_table_dyn` (K3) runs on the tables' device in float32: every
    sphere and every plane is a row, zero-power rows kept, emission picked
    by a masked sum over the materials, and the clamp base computed from
    the material table too. On a CUDA device it launches a one-block
    kernel (ops/csrc/lights.cu) that writes the table into device buffers.
    The dynamic-scene render does not call it there: its megakernel launch
    builds the same table in every block with the same device code
    (ops/csrc/light_table.cuh), so a scene edit neither syncs, rebuilds
    nor launches anything more.

Row layout (LIGHT_COLS float32 values): prob, cum, kind (0 sphere, 1
plane), prim (the unified index of `megakernel.intersect`: sphere i -> i,
plane j -> S + j), g0..g7 (sphere: cx, cy, cz, r, 0...; plane: nx, ny, nz,
px, py, pz, w, h), L_e r, g, b, then the three values the MIS pickup
weight reads: r * r and r * r * 1.0002 for a sphere, max(w * h, 1e-12)
for a plane. K1 folds those three in float64 (pallas_integrator.py:694,
701, 707); K3 multiplies in float32 (pallas_dynamic.py:257, 264, 268).

Both weight a sphere by 4 pi r^2 with math.pi, not the reference's PI.
Neither has a row for an SDF: an SDF emitter is reached by BSDF sampling
alone (its MIS weight is 1), as in the JAX kernels; the clamp base takes
the brightest emission over every material, an SDF's included.

A mode "nee" launch (`megakernel.render_rays`) reads one of two values:
a `Lights`, K1's table, or `IN_LAUNCH`, K3's, which the launch builds.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

from ..integrator import NEE_CLAMP_FACTOR, host_nee_clamp
from ..scene.compile import SceneTables
from .build import launch, load_library

LIGHT_COLS = 18
COL_PROB, COL_CUM, COL_KIND, COL_PRIM, COL_G, COL_LE = 0, 1, 2, 3, 4, 12
COL_R2, COL_R2_EDGE, COL_AREA = 15, 16, 17

# Launches of the table kernel (ops/csrc/lights.cu) made by `light_table_dyn`.
LAUNCHES = 0


class Lights(NamedTuple):
    """A light table and the NEE clamp base, both on the scene's device."""

    rows: torch.Tensor  # (L, LIGHT_COLS) float32; L = 0: nothing emits
    clamp: torch.Tensor  # (1,) float32 clamp base (inf: no clamp)


class _InLaunch:
    """The type of `IN_LAUNCH`, its one value."""

    __slots__ = ()

    def __repr__(self) -> str:
        return "IN_LAUNCH"


# K3's table and clamp base, built by the launch from the tables it reads
# (on the CPU, `light_table_dyn_reference`'s): what a nee launch reads in
# place of a `Lights`.
IN_LAUNCH = _InLaunch()


def _luminance(le) -> float:
    return 0.2126 * le[0] + 0.7152 * le[1] + 0.0722 * le[2]


def light_table(tables: SceneTables, nee_clamp: Optional[float] = None) -> Lights:
    """K1's table, built on the host in float64 (`_light_table`), and the
    clamp base: `nee_clamp`, or `_host_nee_clamp`'s scale-aware default."""
    device = tables.materials.device
    spheres = tables.spheres.detach().cpu().double().tolist()
    planes = tables.planes.detach().cpu().double().tolist()
    mats = tables.materials.detach().cpu().double().tolist()
    rows, total = [], 0.0
    for i, (cx, cy, cz, rad, mid) in enumerate(spheres):
        le = mats[int(mid)][3:6]
        power = _luminance(le) * 4.0 * math.pi * rad * rad
        pick = (rad * rad, (rad * rad) * 1.0002, 0.0)
        rows.append((power, 0, i, (cx, cy, cz, rad, 0.0, 0.0, 0.0, 0.0), le, pick))
        total += power
    for j, (nx, ny, nz, px, py, pz, w, h, mid) in enumerate(planes):
        le = mats[int(mid)][3:6]
        power = _luminance(le) * w * h
        pick = (0.0, 0.0, max(w * h, 1e-12))
        rows.append((power, 1, len(spheres) + j, (nx, ny, nz, px, py, pz, w, h), le, pick))
        total += power
    out, cum = [], 0.0
    if total > 0.0:
        for power, kind, prim, geom, le, pick in rows:
            if power <= 0.0:
                continue
            prob = power / total
            cum += prob
            out.append((prob, cum, float(kind), float(prim), *geom, *le, *pick))
    clamp = nee_clamp if nee_clamp is not None else host_nee_clamp(tables.materials)
    return Lights(
        rows=torch.tensor(out, dtype=torch.float32).reshape(len(out), LIGHT_COLS).to(device),
        clamp=torch.tensor([clamp], dtype=torch.float32).to(device),
    )


def light_table_dyn_reference(tables: SceneTables) -> Lights:
    """The plain version of the table kernel: K3's table and clamp base
    in float32, each value by the operations of `_light_rows_dyn` and
    `_clamp_base_dyn` in their order; the rows side by side, the running
    sums row after row."""
    _check_dyn(tables)
    sph, pln, mat = tables.spheres, tables.planes, tables.materials
    n_sph, n_rows = sph.shape[0], sph.shape[0] + pln.shape[0]
    zero = torch.zeros((), dtype=torch.float32, device=mat.device)
    zeros = torch.zeros(n_rows, dtype=torch.float32, device=mat.device)

    # emission_of: the masked sum over the materials, every row at once.
    mids = torch.cat([sph[:, 4], pln[:, 8]])
    le = torch.zeros((n_rows, 3), dtype=torch.float32, device=mat.device)
    for m in range(mat.shape[0]):
        le = le + (mids == m * 1.0).to(torch.float32)[:, None] * mat[m, 3:6]
    lum = _luminance(le.unbind(1))
    rad, w, h = sph[:, 3], pln[:, 6], pln[:, 7]
    r2 = rad * rad
    power = torch.cat([lum[:n_sph] * (4.0 * math.pi) * rad * rad, lum[n_sph:] * w * h])
    geom = torch.cat([torch.cat([sph[:, :4], zeros[:n_sph, None].expand(-1, 4)], 1), pln[:, :8]])
    pick = torch.cat([torch.stack([r2, r2 * 1.0002, zeros[:n_sph]], 1),
                      torch.stack([zeros[n_sph:], zeros[n_sph:], torch.clamp_min(w * h, 1e-12)], 1)])
    kind = torch.cat([zeros[:n_sph], zeros[n_sph:] + 1.0])
    prim = torch.arange(n_rows, dtype=torch.float32, device=mat.device)

    total = zero
    for r in range(n_rows):
        total = total + power[r]
    prob = power * (1.0 / torch.clamp_min(total, 1e-30))
    cum, running = [], zero
    for r in range(n_rows):
        running = running + prob[r]
        cum.append(running)
    rows = torch.cat([torch.stack([prob, torch.stack(cum), kind, prim], 1), geom, le, pick], 1)

    max_e = zero
    for m in range(mat.shape[0]):
        for c in range(3):
            max_e = torch.maximum(max_e, mat[m, 3 + c])
    clamp = NEE_CLAMP_FACTOR * torch.clamp_min(max_e, 1.0)
    return Lights(rows=rows, clamp=clamp.reshape(1))


def _check_dyn(tables: SceneTables) -> None:
    if tables.spheres.shape[0] + tables.planes.shape[0] == 0:
        raise ValueError("the dynamic-scene NEE light table needs a sphere or a plane")


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    fn = load_library("lights").cornelis_light_table_dyn
    p, i = ctypes.c_void_p, ctypes.c_int
    # spheres, n_spheres, planes, n_planes, materials, n_materials, rows, clamp, stream
    fn.argtypes = [p, i, p, i, p, i, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def light_table_dyn(tables: SceneTables) -> Lights:
    """K3's table on the tables' device: the one-block table kernel on a
    CUDA device, the plain version on the CPU. A failed launch raises."""
    global LAUNCHES
    from .megakernel import check_tables

    check_tables(tables)
    device = tables.camera.device
    if device.type == "cpu":
        return light_table_dyn_reference(tables)
    if device.type != "cuda":
        raise ValueError(f"no light-table kernel for device {device}")
    _check_dyn(tables)
    n_rows = tables.spheres.shape[0] + tables.planes.shape[0]
    rows = torch.empty((n_rows, LIGHT_COLS), dtype=torch.float32, device=device)
    clamp = torch.empty((1,), dtype=torch.float32, device=device)
    launch(
        _kernel_fn(),
        device,
        tables.spheres.data_ptr(),
        tables.spheres.shape[0],
        tables.planes.data_ptr(),
        tables.planes.shape[0],
        tables.materials.data_ptr(),
        tables.materials.shape[0],
        rows.data_ptr(),
        clamp.data_ptr(),
    )
    LAUNCHES += 1
    return Lights(rows=rows, clamp=clamp)
