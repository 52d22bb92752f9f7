"""The tables on which K3's sphere hierarchy is held to the linear scan.

K3 (the dynamic nee launch, ops/csrc/megakernel.cu) walks a hierarchy of
boxes over the spheres, built in every launch; K1's nee instantiation fed
`lights.light_table_dyn_reference`'s table scans every sphere in row order.
Their rays must agree bit for bit. These cases reach the hierarchy's edges:
sphere counts around one leaf (8 spheres), a tie in t that the walk meets
out of row order, origins inside a sphere, spheres 1000 units off with
rays grazing their silhouettes, glossy surfaces whose samples go
degenerate, and tables past the kernel's shared-memory cap. Shared by the
`cuda`-marked tests and chip_smoke.py. Imports no JAX.
"""

import numpy as np
import torch

from cornelis_tpu_torch.scene.compile import compile_scene
from cornelis_tpu_torch.scene.description import PerspectiveCameraDescription
from cornelis_tpu_torch.scene.library import cornell_panel, sphere_grid

# The kernel's leaf: a scene of at most LEAF spheres is one leaf, walked
# as the linear scan.
LEAF = 8

CASE_NAMES = ("no_sphere", "one_sphere", "one_leaf", "one_leaf_plus_one", "sphere_grid(512)",
              "tie_and_nested", "far_grazing", "glossy", "sphere_grid(2200)")


def _camera(origin, look_at, fov):
    """The camera row of a scene seen from `origin` toward `look_at`."""
    scene = sphere_grid(1)
    scene.set_camera(PerspectiveCameraDescription(origin=origin, look_at=look_at, aspect=1.0,
                                                  horizontal_fov=fov))
    return compile_scene(scene, device="cpu").camera


def _quantized(x, lo, hi):
    """The kernel's 10-bit Morton coordinate of x in [lo, hi], in float32."""
    f = np.float32
    scale = f(1023.0) / (f(hi) - f(lo))
    return int(np.clip((f(x) - f(lo)) * scale, f(0.0), f(1023.0)))


def _tie_and_nested(device):
    """A 5x5 grid of spheres in a dome the camera stands in, a sphere nested
    in another, a later row that repeats a grid sphere exactly (another
    material), and two spheres one float32 step apart in x across a Morton
    cell's edge: the later row sorts first, so the walk meets it first, and
    the rays whose t the two round alike must still take the earlier row."""
    f = np.float32
    tables = compile_scene(sphere_grid(24), device="cpu")
    grid, rest = tables.spheres[:24], tables.spheres[24:]
    dome = torch.tensor([[7.5, 0.0, 7.5, 60.0, float(grid[0, 4])]])
    outer = torch.tensor([[3.0, 2.5, 9.0, 1.4, float(grid[1, 4])]])
    inner = torch.tensor([[3.1, 2.6, 9.0, 0.5, float(grid[2, 4])]])
    centres = torch.cat([grid[:, :3], dome[:, :3], outer[:, :3], inner[:, :3]]).numpy()
    lo, hi = centres[:, 0].min(), centres[:, 0].max()
    x = f(10.25)
    while _quantized(x, lo, hi) == _quantized(np.nextafter(x, f(-np.inf)), lo, hi):
        x = np.nextafter(x, f(np.inf))
    below = np.nextafter(x, f(-np.inf))
    first = torch.tensor([[float(x), 1.2, 4.0, 0.9, float(grid[3, 4])]])
    second = torch.tensor([[float(below), 1.2, 4.0, 0.9, float(grid[4, 4])]])
    twin = grid[6:7].clone()
    twin[0, 4] = grid[7, 4]
    spheres = torch.cat([grid[:12], first, grid[12:], outer, inner, dome, second, twin, rest])
    camera = _camera((7.5, 6.0, -4.0), (7.5, 0.5, 6.0), 0.9)
    return tables._replace(spheres=spheres.contiguous(), camera=camera).to(device)


def _far_grazing(device):
    """A 6x6x2 cluster of small spheres 1000 units from the camera, seen by
    a narrow field of view, so that many rays pass within sphere_t's
    rounding (about 1e-3 of the distance) of a silhouette."""
    tables = compile_scene(sphere_grid(72), device="cpu")
    s = tables.spheres.clone()
    k = torch.arange(72)
    s[:72, 0] = 1000.0 + 2.1 * (k % 6).float()
    s[:72, 1] = 2.1 * ((k // 6) % 6).float()
    s[:72, 2] = 1000.0 + 2.1 * (k // 36).float()
    s[:72, 3] = 0.35 + 0.05 * (k % 7).float()
    s[72, :3] = torch.tensor([1005.0, 400.0, 1000.0])
    camera = _camera((0.0, 5.0, 0.0), (1005.25, 5.25, 1001.0), 0.012)
    return tables._replace(spheres=s, camera=camera).to(device)


def _glossy(device):
    """sphere_grid(32) with every material a near-mirror, whose glossy
    samples below the surface leave the next ray's direction zero."""
    tables = compile_scene(sphere_grid(32), device="cpu")
    m = tables.materials.clone()
    lit = m[:, 3:6].sum(1) > 0
    m[~lit, 9] = 0.02
    m[~lit, 6:9] = torch.tensor([0.9, 0.8, 0.7])
    return tables._replace(materials=m).to(device)


def walk_case(name: str, device="cpu"):
    """The tables of case `name` (one of CASE_NAMES) on `device`."""
    if name.startswith("sphere_grid("):
        return compile_scene(sphere_grid(int(name[12:-1])), device=device)
    if name in ("no_sphere", "one_sphere"):
        tables = compile_scene(cornell_panel(), device="cpu")
        keep = 0 if name == "no_sphere" else 1
        return tables._replace(spheres=tables.spheres[:keep].contiguous()).to(device)
    if name == "one_leaf":
        return compile_scene(sphere_grid(LEAF - 1), device=device)
    if name == "one_leaf_plus_one":
        return compile_scene(sphere_grid(LEAF), device=device)
    if name == "tie_and_nested":
        return _tie_and_nested(device)
    if name == "far_grazing":
        return _far_grazing(device)
    if name == "glossy":
        return _glossy(device)
    raise ValueError(f"no walk case {name!r}")
