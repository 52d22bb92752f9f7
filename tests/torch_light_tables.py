"""The tables on which K3's light table is held to its references.

Shared by tests/test_torch_dynamic.py (the plain version against
cornelis_tpu's `_light_rows_dyn` and `_clamp_base_dyn`), the `cuda`-marked
tests and chip_smoke.py (the table kernel and the dynamic render against
the plain version). Imports no JAX.
"""

import math

import torch

from cornelis_tpu_torch.scene.compile import compile_scene
from cornelis_tpu_torch.scene.library import cornell_box, cornell_panel, sphere_grid

# Cornell and the panel scene; sphere_grid(n) (sphere_grid(2200)'s nee
# tables lie past the kernel's shared-memory cap); and Cornell with a -0
# emission, with an infinite and a NaN emission in two materials no
# primitive uses (the masked sum then runs), with a non-integer material
# id and one past the table, with no emission at all (the 1e-30 floor),
# and with a negative emission between two positive ones (the cum column
# rises, falls and rises again, so no search can stand for the pick's
# scan).
CASE_NAMES = ("cornell_box", "cornell_panel", "sphere_grid(64)", "sphere_grid(512)",
              "sphere_grid(2200)", "cornell_neg0_emission", "cornell_inf_nan_unused",
              "cornell_odd_ids", "cornell_no_emission", "cornell_neg_emission")


def table_case(name: str, device="cpu"):
    """The tables of case `name` (one of CASE_NAMES) on `device`."""
    if name.startswith("sphere_grid("):
        return compile_scene(sphere_grid(int(name[12:-1])), device=device)
    if name == "cornell_panel":
        return compile_scene(cornell_panel(), device=device)
    base = compile_scene(cornell_box(), device=device)
    if name == "cornell_box":
        return base
    if name == "cornell_neg0_emission":
        base.materials[0, 3:6] = -0.0
    elif name == "cornell_inf_nan_unused":
        unused = torch.cat([base.materials, base.materials[:2]])
        unused[-1, 3], unused[-2, 4] = math.inf, math.nan
        return base._replace(materials=unused)
    elif name == "cornell_odd_ids":
        base.spheres[-2, 4], base.spheres[-1, 4] = 1.5, float(base.materials.shape[0])
    elif name == "cornell_no_emission":
        base.materials[:, 3:6] = 0.0
    elif name == "cornell_neg_emission":
        # Rows 1 and 3 emit, row 2 less than nothing: the cum column reads
        # about 0.57, 0.70, 0.17, 1.0, then 1.0 to the last row.
        signed = torch.cat([base.materials, base.materials[:2]])
        signed[-2, 3:6], signed[-1, 3:6] = 5.0, -5.0
        n = base.materials.shape[0]
        base.spheres[1:4, 4] = torch.tensor([n, n + 1, n], dtype=base.spheres.dtype)
        return base._replace(materials=signed)
    else:
        raise ValueError(f"no table case {name!r}")
    return base


def table_cases(device="cpu") -> list:
    """(name, tables) of every case."""
    return [(name, table_case(name, device)) for name in CASE_NAMES]
