"""The NEE light-selection table of the dynamic-scene kernel (K3's
construction), frozen from the port's
`ops/lights.py::light_table_dyn_reference`: built on the tables' device in
float32, every sphere and every plane a row, zero-power rows kept,
emission picked by a masked sum over the materials, and the clamp base
computed from the material table too. The row layout is K1's
(reference/lights.py); its three MIS pickup values are multiplied in
float32 here, where K1 folds them in float64.
"""

from __future__ import annotations

import math

import torch

from .compile import SceneTables
from .integrator import NEE_CLAMP_FACTOR
from .lights import Lights, _luminance


def light_table_dyn(tables: SceneTables) -> Lights:
    """K3's table and clamp base in float32, each value by the operations
    of the kernel's construction in their order; the rows side by side,
    the running sums row after row."""
    sph, pln, mat = tables.spheres, tables.planes, tables.materials
    if sph.shape[0] + pln.shape[0] == 0:
        raise ValueError("the dynamic-scene NEE light table needs a sphere or a plane")
    n_sph, n_rows = sph.shape[0], sph.shape[0] + pln.shape[0]
    zero = torch.zeros((), dtype=torch.float32, device=mat.device)
    zeros = torch.zeros(n_rows, dtype=torch.float32, device=mat.device)

    # The emission of each row: the masked sum over the materials.
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
