"""4x4 transform linear algebra.

Counterpart of `cornelis_tpu/math/linalg.py`: the reference's SIMD 4x4 *
vec4 multiply (src/Linalg.cpp:43-53), its float4x4 identity and scaling
constructors (Math.hpp:330-360) and its commented-out ray-stream transform
(Linalg.hpp:30-44, Linalg.cpp:55-69), as host numpy constructors and
`torch.einsum` over tensors.

Object-to-world transforms are restricted to TRS with uniform scale
(translate . rotate . uniform-scale): spheres stay spheres, plane rects
stay rects, and signed-distance fields scale linearly (d_world(p) =
s * d_local(R^T (p - t) / s)), so every primitive bakes its transform into
world-space parameters at scene compile (scene/compile.py), with no
per-ray matrix work.

Matrices are row-major (4, 4) float32 (the reference's layout,
Math.hpp:331), acting on column vectors: world = M @ local. The constructors
are the JAX package's numpy code, so both packages bake the same bits.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

Mat4 = np.ndarray  # host-side (4, 4) float32, baked at scene compile


def identity() -> Mat4:
    """float4x4::identityMatrix (Math.hpp:333-341)."""
    return np.eye(4, dtype=np.float32)


def scaling(s: float) -> Mat4:
    """Uniform scale (float4x4::scalingMatrix restricted to uniform
    diagonals, Math.hpp:343-359 -- non-uniform scale would break spheres
    and SDF distances; validated in decompose_trs)."""
    m = np.eye(4, dtype=np.float32)
    m[0, 0] = m[1, 1] = m[2, 2] = float(s)
    return m


def compose(*ms: Mat4) -> Mat4:
    """compose(A, B, C) = A @ B @ C (C applied first)."""
    out = np.eye(4, dtype=np.float32)
    for m in ms:
        out = out @ np.asarray(m, np.float32)
    return out.astype(np.float32)


def decompose_trs(m) -> Tuple[np.ndarray, np.ndarray, float]:
    """Split a TRS matrix into (R (3,3), t (3,), s): validates that the
    linear part is s * R with R orthogonal (uniform scale, no shear) --
    the invariant every primitive's baked transform relies on."""
    m = np.asarray(m, np.float32)
    if m.shape != (4, 4):
        raise ValueError(f"transform must be 4x4, got {m.shape}")
    if not np.allclose(m[3], [0.0, 0.0, 0.0, 1.0], atol=1e-5):
        raise ValueError("transform must be affine (last row 0 0 0 1)")
    lin = np.asarray(m[:3, :3], np.float64)
    t = np.asarray(m[:3, 3], np.float32)
    s = float(np.cbrt(np.linalg.det(lin)))
    if not s > 0.0:
        raise ValueError("transform must have positive uniform scale")
    r = lin / s
    if not np.allclose(r @ r.T, np.eye(3), atol=1e-4):
        raise ValueError(
            "transform linear part must be rotation * uniform scale "
            "(no shear / non-uniform scale: spheres and SDF distances "
            "would not survive it)"
        )
    return r.astype(np.float32), t, s
