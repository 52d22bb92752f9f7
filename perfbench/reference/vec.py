"""SoA 3-vector math on torch tensors.

Counterpart of `cornelis_tpu/math/vec.py`: a `Vec3` is a NamedTuple of three
same-shaped float32 tensors, with the reference's free functions (`dot`,
`mag2`, `cross`, `normalize`, `ray_at`, `construct_basis`; Math.hpp:278-292,
380-434). Python-float constants combine with float32 tensors in float32,
as JAX's weakly typed scalars do, so the two packages evaluate the same
float32 expressions in the same order.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Union

import torch

Tensor = torch.Tensor
Scalar = Union[float, Tensor]

# cornelis::RayEpsilon (Math.hpp:20): the zero cut-off of normalize() and
# the "is almost zero" guards.
RAY_EPSILON = 5e-5

PI = 3.14159265359  # cornelis::Pi (Math.hpp:25), not math.pi


class Vec3(NamedTuple):
    """A batch of 3D vectors (or linear RGB colors) in SoA form."""

    x: Tensor
    y: Tensor
    z: Tensor

    def __add__(self, other: "Vec3") -> "Vec3":  # type: ignore[override]
        return Vec3(self.x + other.x, self.y + other.y, self.z + other.z)

    def __sub__(self, other: "Vec3") -> "Vec3":
        return Vec3(self.x - other.x, self.y - other.y, self.z - other.z)

    def __neg__(self) -> "Vec3":
        return Vec3(-self.x, -self.y, -self.z)

    def __mul__(self, other: Union["Vec3", Scalar]) -> "Vec3":  # type: ignore[override]
        if isinstance(other, Vec3):
            return Vec3(self.x * other.x, self.y * other.y, self.z * other.z)
        return Vec3(self.x * other, self.y * other, self.z * other)


# Linear RGB shares the representation (Color.hpp:19-57).
RGB = Vec3


def vec3(x: Scalar, y: Scalar, z: Scalar, dtype=torch.float32) -> Vec3:
    """A Vec3 from scalars or tensors, Python floats promoted to tensors."""
    return Vec3(*(torch.as_tensor(c, dtype=dtype) for c in (x, y, z)))


def full_like(v: Vec3, value: float) -> Vec3:
    return Vec3(*(torch.full_like(c, value) for c in v))


def broadcast_to(v: Vec3, shape) -> Vec3:
    return Vec3(*(torch.broadcast_to(c, shape) for c in v))


def dot(a: Vec3, b: Vec3) -> Tensor:
    """Dot product (Math.hpp:278)."""
    return a.x * b.x + a.y * b.y + a.z * b.z


def mag2(a: Vec3) -> Tensor:
    """Squared magnitude (Math.hpp:284)."""
    return dot(a, a)


def length(a: Vec3) -> Tensor:
    return torch.sqrt(mag2(a))


def cross(a: Vec3, b: Vec3) -> Vec3:
    """Cross product (Math.hpp:380-384)."""
    return Vec3(
        a.y * b.z - a.z * b.y,
        a.z * b.x - a.x * b.z,
        a.x * b.y - a.y * b.x,
    )


def ray_at(origin: Vec3, direction: Vec3, t: Tensor) -> Vec3:
    """Point along a ray: o + t*d (Math.hpp:290-292)."""
    return Vec3(
        origin.x + direction.x * t,
        origin.y + direction.y * t,
        origin.z + direction.z * t,
    )


def is_almost_zero(v: Tensor) -> Tensor:
    """|v| < RayEpsilon (Math.hpp:22)."""
    return torch.abs(v) < RAY_EPSILON


def normalize(v: Vec3) -> Vec3:
    """Normalize with the reference's zero cut-off (Math.hpp:392-398):
    vectors shorter than RayEpsilon map to the zero vector."""
    m2 = mag2(v)
    zero = m2 < RAY_EPSILON * RAY_EPSILON
    ln = torch.sqrt(torch.where(zero, 1.0, m2))
    s = torch.where(zero, 0.0, 1.0 / ln)
    return v * s


def normalize_unchecked(v: Vec3) -> Vec3:
    """Plain v/|v| with no cut-off: the camera's normalize (nanovdb
    Vec3::normalize, Camera.cpp:11-13)."""
    return v * (1.0 / length(v))


@functools.lru_cache(maxsize=None)
def _constant(value: float, dtype: torch.dtype, device: torch.device) -> Tensor:
    return torch.tensor(value, dtype=dtype, device=device)


def maximum(x: Tensor, c: float) -> Tensor:
    """jnp.maximum(x, c) for a float bound c, gradient included: where
    x == c, torch.maximum gives x half the gradient, as JAX does
    (torch.clamp_min would give it all)."""
    return torch.maximum(x, _constant(float(c), x.dtype, x.device))


def minimum(x: Tensor, c: float) -> Tensor:
    """jnp.minimum(x, c) for a float bound c; ties as `maximum`."""
    return torch.minimum(x, _constant(float(c), x.dtype, x.device))


def clip(x: Tensor, lo: float, hi: float) -> Tensor:
    """jnp.clip(x, lo, hi) = minimum(maximum(x, lo), hi), ties as JAX."""
    return minimum(maximum(x, lo), hi)


def take(values: Tensor, idx: Tensor) -> Tensor:
    """values[idx] along the first axis, by index_select: its backward on
    CUDA is index_add_ (atomic adds). Advanced indexing's backward,
    index_put_ with accumulate, sorts the indices and adds each run of
    equal ones in sequence, and a wavefront gathers a few table rows for
    millions of rays: on an NVIDIA H100 80GB HBM3 at 700 W it took 88% of
    a differentiable step's device time (chip_smoke.py phase 6f)."""
    return values.index_select(0, idx)


def where(mask: Tensor, a: Vec3, b: Vec3) -> Vec3:
    """Componentwise select: mask ? a : b."""
    return Vec3(
        torch.where(mask, a.x, b.x),
        torch.where(mask, a.y, b.y),
        torch.where(mask, a.z, b.z),
    )


def clamp(v: Vec3, lo: Scalar, hi: Scalar) -> Vec3:
    """Componentwise clamp (RGB::clamp, Color.cpp:26-30) with jnp.clip's
    ties: minimum(maximum(x, lo), hi)."""
    return Vec3(*(torch.minimum(torch.maximum(c, torch.as_tensor(lo).to(c)),
                                torch.as_tensor(hi).to(c)) for c in v))


class Basis(NamedTuple):
    """Orthonormal surface basis {N, T, B} (Math.hpp:403-416)."""

    n: Vec3
    t: Vec3
    b: Vec3


def construct_basis(n: Vec3) -> Basis:
    """Tangent basis from a normal (Math.hpp:424-434): helper axis (0,1,0),
    flipped to (0,0,1) where |N.y| > 0.95; T = normalize(helper x N);
    B = T x N. Precondition: N normalized."""
    flip = torch.abs(n.y) > 0.95
    zeros = torch.zeros_like(n.x)
    helper = Vec3(zeros, torch.where(flip, 0.0, 1.0), torch.where(flip, 1.0, 0.0))
    t = normalize(cross(helper, n))
    b = cross(t, n)
    return Basis(n=n, t=t, b=b)
