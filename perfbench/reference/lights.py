"""The NEE light-selection table of the megakernel (K1's construction),
frozen from the port's `ops/lights.py::light_table`: built on the host
in float64 and rounded to float32; zero-power rows dropped.

Row layout (LIGHT_COLS float32 values): prob, cum, kind (0 sphere, 1
plane), prim (sphere i -> i, plane j -> S + j), g0..g7 (sphere: cx, cy,
cz, r, 0...; plane: nx, ny, nz, px, py, pz, w, h), L_e r, g, b, then the
three values the MIS pickup weight reads: r * r and r * r * 1.0002 for a
sphere, max(w * h, 1e-12) for a plane. A sphere is weighted by 4 pi r^2
with math.pi. An SDF has no row: it is reached by BSDF sampling alone.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .compile import SceneTables
from .integrator import host_nee_clamp

LIGHT_COLS = 18
COL_PROB, COL_CUM, COL_KIND, COL_PRIM, COL_G, COL_LE = 0, 1, 2, 3, 4, 12
COL_R2, COL_R2_EDGE, COL_AREA = 15, 16, 17

class Lights(NamedTuple):
    """A light table and the NEE clamp base, both on the scene's device."""

    rows: torch.Tensor  # (L, LIGHT_COLS) float32; L = 0: nothing emits
    clamp: torch.Tensor  # (1,) float32 clamp base (inf: no clamp)


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
