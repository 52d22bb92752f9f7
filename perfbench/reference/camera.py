"""Perspective camera: lookAt construction and batched ray generation.

Counterpart of `cornelis_tpu/camera.py`, with the reference camera's two
quirks (src/Camera.cpp:7-39): u = up x dir is not re-normalized, and the
aspect ratio multiplies the vertical axis v.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .vec import Vec3, cross, normalize_unchecked, vec3


class Camera(NamedTuple):
    """Compiled perspective camera: eye + image-plane frame. Components are
    Python floats or 0-d float32 tensors."""

    eye: Vec3
    corner: Vec3
    u: Vec3
    v: Vec3


# sin(0.5): the default camera's 1-radian horizontal FOV constant
# (Camera.cpp:7-9).
_SIN_HALF = 0.4794255386


def look_at(origin, target, aspect, horizontal_fov) -> Camera:
    """Build a camera from origin/target (Camera.cpp:15-34) in tensor ops,
    differentiable in its inputs: up is fixed (0,1,0); fovScale =
    2 sin(hFov/2); u = (up x dir) * fovScale (unnormalized -- reference
    quirk), v = (u x dir) * aspect * fovScale; corner = dir - u/2 - v/2."""
    o = origin if isinstance(origin, Vec3) else vec3(*origin)
    t = target if isinstance(target, Vec3) else vec3(*target)
    up = vec3(0.0, 1.0, 0.0)

    direction = normalize_unchecked(t - o)
    u = cross(up, direction)
    v = cross(u, direction)

    fov_scale = 2.0 * torch.sin(torch.as_tensor(horizontal_fov * 0.5, dtype=torch.float32))
    u = u * fov_scale
    v = v * (aspect * fov_scale)

    corner = direction - u * 0.5 - v * 0.5
    return Camera(eye=o, corner=corner, u=u, v=v)


def look_at_host(origin, target, aspect, horizontal_fov) -> Camera:
    """lookAt (Camera.cpp:15-34) in host numpy float32, operation for
    operation as `cornelis_tpu.camera.look_at_host`, so both packages bake
    bit-identical camera tables."""
    f32 = np.float32
    o = np.asarray(origin, f32)
    t = np.asarray(target, f32)
    up = np.asarray([0.0, 1.0, 0.0], f32)

    d = (t - o).astype(f32)
    d = (d * f32(1.0 / np.sqrt(f32(d @ d)))).astype(f32)
    u = np.cross(up, d).astype(f32)
    v = np.cross(u, d).astype(f32)

    fov_scale = f32(2.0) * f32(np.sin(f32(horizontal_fov) * f32(0.5)))
    u = (u * fov_scale).astype(f32)
    v = (v * (f32(aspect) * fov_scale)).astype(f32)
    corner = (d - u * f32(0.5) - v * f32(0.5)).astype(f32)

    mk = lambda a: Vec3(float(a[0]), float(a[1]), float(a[2]))
    return Camera(eye=mk(o), corner=mk(corner), u=mk(u), v=mk(v))


def camera_from_row(row: torch.Tensor) -> Camera:
    """Camera from a (12,) table row: eye, corner, u, v."""
    mk = lambda i: Vec3(row[i], row[i + 1], row[i + 2])
    return Camera(eye=mk(0), corner=mk(3), u=mk(6), v=mk(9))


def generate_rays(cam: Camera, x: torch.Tensor, y: torch.Tensor) -> Tuple[Vec3, Vec3]:
    """World rays through normalized framebuffer coords (Camera.cpp:11-13).
    Returns (origins, directions); directions use the cut-off-free
    normalize."""
    d = Vec3(
        cam.corner.x + x * cam.u.x + y * cam.v.x,
        cam.corner.y + x * cam.u.y + y * cam.v.y,
        cam.corner.z + x * cam.u.z + y * cam.v.z,
    )
    d = normalize_unchecked(d)
    o = Vec3(
        torch.zeros_like(x) + cam.eye.x,
        torch.zeros_like(x) + cam.eye.y,
        torch.zeros_like(x) + cam.eye.z,
    )
    return o, d
