"""Scene compilation: description -> the float32 tables the megakernel reads.

Counterpart of `cornelis_tpu/scene/compile.py` together with
`cornelis_tpu/ops/pallas_dynamic.py::_scene_tables`: the same values in the
same column layout, as five float32 tensors on one device.

  camera     (12,)    eye, corner, u, v (3 floats each)
  spheres    (S, 5)   cx, cy, cz, radius, material
  planes     (P, 9)   nx, ny, nz, px, py, pz, width, height, material
  materials  (M, 11)  albedo rgb, emission rgb, tint rgb, roughness, ior
  sdfs       (K, 19)  kind, cx, cy, cz, p0..p3, material, the world-to-local
                      rotation R^T (9, row-major), uniform scale

Material ids and SDF kinds (geometry.SDF_KIND_*) are stored as floats. The kernel takes the tables as
operands, so one build serves every scene (the TPU baked them in as
literals; that was a Mosaic constraint, not a property of the renderer).
The tables land on the card unless the caller asks for another device.

The wavefront (integrator.py) and the differentiable mode read the scene
as `SceneArrays`, the JAX package's field by field layout: `scene_arrays`
views the tables so, and `tables_from_arrays` packs a scene (an optimised
one, say) back into tables for the kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..camera import Camera, camera_from_row, look_at_host
from ..math.linalg import decompose_trs
from ..math.vec import Vec3
from .description import SDF_KINDS, SceneDescription

SDF_COLS = 19


class SceneTables(NamedTuple):
    camera: torch.Tensor
    spheres: torch.Tensor
    planes: torch.Tensor
    materials: torch.Tensor
    sdfs: torch.Tensor

    def to(self, device) -> "SceneTables":
        return SceneTables(*(t.to(device) for t in self))


class SceneArrays(NamedTuple):
    """A compiled scene field by field, as `cornelis_tpu.scene.compile.
    SceneArrays`: float32 tensors (Vec3s of them for 3-vectors) that
    autograd can differentiate, int64 material ids and SDF kinds. Spheres
    (S,), planes (P,), SDFs (K,) with params (K, 4) and world-to-local
    rotations (K, 3, 3), materials (M,)."""

    camera: Camera
    sphere_center: Vec3
    sphere_radius: torch.Tensor
    sphere_material: torch.Tensor
    plane_normal: Vec3
    plane_point: Vec3
    plane_width: torch.Tensor
    plane_height: torch.Tensor
    plane_material: torch.Tensor
    sdf_kind: torch.Tensor
    sdf_center: Vec3
    sdf_params: torch.Tensor
    sdf_material: torch.Tensor
    sdf_rot: torch.Tensor
    sdf_scale: torch.Tensor
    mat_albedo: Vec3
    mat_emission: Vec3
    mat_tint: Vec3
    mat_roughness: torch.Tensor
    mat_ior: torch.Tensor

    @property
    def num_spheres(self) -> int:
        return self.sphere_radius.shape[0]

    @property
    def num_planes(self) -> int:
        return self.plane_width.shape[0]

    @property
    def num_sdfs(self) -> int:
        return self.sdf_kind.shape[0]

    @property
    def device(self) -> torch.device:
        return self.mat_roughness.device


def scene_arrays(tables: SceneTables) -> SceneArrays:
    """The tables as SceneArrays: column views, ids and kinds as int64."""
    sp, pl, sd, m = tables.spheres, tables.planes, tables.sdfs, tables.materials
    vec = lambda t, i: Vec3(t[:, i], t[:, i + 1], t[:, i + 2])
    ids = lambda col: col.to(torch.int64)
    return SceneArrays(
        camera=camera_from_row(tables.camera),
        sphere_center=vec(sp, 0),
        sphere_radius=sp[:, 3],
        sphere_material=ids(sp[:, 4]),
        plane_normal=vec(pl, 0),
        plane_point=vec(pl, 3),
        plane_width=pl[:, 6],
        plane_height=pl[:, 7],
        plane_material=ids(pl[:, 8]),
        sdf_kind=ids(sd[:, 0]),
        sdf_center=vec(sd, 1),
        sdf_params=sd[:, 4:8],
        sdf_material=ids(sd[:, 8]),
        sdf_rot=sd[:, 9:18].reshape(-1, 3, 3),
        sdf_scale=sd[:, 18],
        mat_albedo=vec(m, 0),
        mat_emission=vec(m, 3),
        mat_tint=vec(m, 6),
        mat_roughness=m[:, 9],
        mat_ior=m[:, 10],
    )


def tables_from_arrays(scene: SceneArrays) -> SceneTables:
    """SceneArrays packed into the kernel's tables (detached from any
    gradient), on the scene's device."""
    with torch.no_grad():
        f = lambda t: t.to(torch.float32)
        cam = scene.camera
        camera = torch.stack(
            [torch.as_tensor(c, dtype=torch.float32, device=scene.device)
             for v in (cam.eye, cam.corner, cam.u, cam.v) for c in v]
        )
        cols = lambda *c: torch.stack([f(x) for x in c], dim=1).contiguous()
        k = scene.num_sdfs
        return SceneTables(
            camera=camera,
            spheres=cols(*scene.sphere_center, scene.sphere_radius, scene.sphere_material),
            planes=cols(*scene.plane_normal, *scene.plane_point, scene.plane_width,
                        scene.plane_height, scene.plane_material),
            materials=cols(*scene.mat_albedo, *scene.mat_emission, *scene.mat_tint,
                           scene.mat_roughness, scene.mat_ior),
            sdfs=torch.cat(
                [cols(scene.sdf_kind, *scene.sdf_center), f(scene.sdf_params).reshape(k, 4),
                 cols(scene.sdf_material), f(scene.sdf_rot).reshape(k, 9), cols(scene.sdf_scale)],
                dim=1,
            ).contiguous(),
        )


def _trs(obj):
    if obj.transform is None:
        return np.eye(3, dtype=np.float32), np.zeros(3, np.float32), 1.0
    return decompose_trs(obj.transform)


def _apply_pt(r, t, s, p):
    return tuple((s * (r @ np.asarray(p, np.float32)) + t).tolist())


def _material_id(obj) -> int:
    return obj.material if obj.material is not None else 0


def compile_scene(descr: SceneDescription, device="cuda") -> SceneTables:
    """Description -> tables on `device`, the card unless the caller asks
    for the CPU (Scene.cpp:40-53 analog).

    Objects with material=None use index 0, the default material the
    builder always installs (Scene.cpp:16,36). The kernel reads material
    rows by id without a bounds check, so ids are checked here."""
    return SceneTables(*(torch.from_numpy(a).to(device) for a in _host_tables(descr)))


def update_tables(tables: SceneTables, descr: SceneDescription) -> int:
    """Compile `descr` into the existing `tables`, in place, on their own
    device: the same rows `compile_scene` makes, copied over the old ones
    with `copy_`, so no table is allocated and every tensor keeps its
    storage. Returns the bytes copied. The scene must keep the tables'
    topology (as many spheres, planes, materials and SDFs): a ValueError
    says which count differs, and nothing is copied."""
    host = _host_tables(descr)
    for name, old, new in zip(SceneTables._fields, tables, host):
        if tuple(old.shape) != new.shape:
            raise ValueError(
                f"the scene's {name} table is {new.shape[0]} rows, the tables' "
                f"{old.shape[0]}: an edit in place keeps the counts of spheres, planes, "
                f"materials and SDFs"
            )
    for old, new in zip(tables, host):
        old.copy_(torch.from_numpy(new))
    return sum(a.nbytes for a in host)


def _host_tables(descr: SceneDescription):
    """The five tables of `descr` as float32 numpy arrays, in SceneTables'
    order; material ids checked."""
    mats = descr.materials
    if not mats:
        raise ValueError("Scene must have at least the default material at index 0.")
    for obj in list(descr.spheres) + list(descr.planes) + list(descr.sdfs):
        mid = _material_id(obj)
        if not 0 <= mid < len(mats):
            raise ValueError(f"material id {mid} out of range (0..{len(mats) - 1})")

    cam = look_at_host(
        descr.camera.origin,
        descr.camera.look_at,
        descr.camera.aspect,
        descr.camera.horizontal_fov,
    )
    camera = [c for v in cam for c in v]

    spheres = []
    for sp in descr.spheres:
        r, t, s = _trs(sp)
        spheres.append(_apply_pt(r, t, s, sp.center) + (s * sp.radius, _material_id(sp)))

    planes = []
    for pl in descr.planes:
        r, t, s = _trs(pl)
        normal = tuple((r @ np.asarray(pl.normal, np.float32)).tolist())
        planes.append(
            normal
            + _apply_pt(r, t, s, pl.point)
            + (s * pl.extents[0], s * pl.extents[1], _material_id(pl))
        )

    sdfs = []
    for sd in descr.sdfs:
        r, t, s = _trs(sd)
        params = tuple(sd.params) + (0.0,) * (4 - len(sd.params))
        sdfs.append(
            (SDF_KINDS.index(sd.kind),)
            + _apply_pt(r, t, s, sd.center)
            + params
            + (_material_id(sd),)
            + tuple(r.T.reshape(9).tolist())
            + (s,)
        )

    materials = [
        tuple(m.albedo) + tuple(m.emissive) + tuple(m.reflection_tint) + (m.roughness, m.ior)
        for m in mats
    ]

    def table(rows, width):
        return np.asarray(rows, np.float32).reshape(len(rows), width)

    return (np.asarray(camera, np.float32), table(spheres, 5), table(planes, 9),
            table(materials, 11), table(sdfs, SDF_COLS))


def from_numpy_scene(scene, device="cuda") -> SceneTables:
    """The port's tables, on `device` (the card by default), from a
    `cornelis_tpu` SceneArrays whose leaves are numpy arrays
    (`jax.device_get(compile_scene(d))`). Reads attributes only, so it
    needs no jax; `scene_arrays` of the result is the JAX scene in torch."""
    f = lambda a: np.asarray(a, np.float32)
    cam = scene.camera
    camera = np.concatenate(
        [f([v.x, v.y, v.z]) for v in (cam.eye, cam.corner, cam.u, cam.v)]
    )
    spheres = np.stack(
        [
            f(scene.sphere_center.x),
            f(scene.sphere_center.y),
            f(scene.sphere_center.z),
            f(scene.sphere_radius),
            f(scene.sphere_material),
        ],
        axis=1,
    ).reshape(-1, 5)
    planes = np.stack(
        [
            f(scene.plane_normal.x),
            f(scene.plane_normal.y),
            f(scene.plane_normal.z),
            f(scene.plane_point.x),
            f(scene.plane_point.y),
            f(scene.plane_point.z),
            f(scene.plane_width),
            f(scene.plane_height),
            f(scene.plane_material),
        ],
        axis=1,
    ).reshape(-1, 9)
    materials = np.stack(
        [
            f(scene.mat_albedo.x), f(scene.mat_albedo.y), f(scene.mat_albedo.z),
            f(scene.mat_emission.x), f(scene.mat_emission.y), f(scene.mat_emission.z),
            f(scene.mat_tint.x), f(scene.mat_tint.y), f(scene.mat_tint.z),
            f(scene.mat_roughness),
            f(scene.mat_ior),
        ],
        axis=1,
    )
    n_sdf = f(scene.sdf_kind).shape[0]
    sdfs = np.concatenate(
        [
            np.stack(
                [f(scene.sdf_kind), f(scene.sdf_center.x), f(scene.sdf_center.y),
                 f(scene.sdf_center.z)],
                axis=1,
            ).reshape(n_sdf, 4),
            f(scene.sdf_params).reshape(n_sdf, 4),
            f(scene.sdf_material).reshape(n_sdf, 1),
            f(scene.sdf_rot).reshape(n_sdf, 9),
            f(scene.sdf_scale).reshape(n_sdf, 1),
        ],
        axis=1,
    )
    return SceneTables(
        *(torch.from_numpy(np.ascontiguousarray(a)).to(device)
          for a in (camera, spheres, planes, materials, sdfs))
    )
