"""The torch wavefront in the furnace: closed-form checks of
tests/test_furnace.py and tests/test_nee.py TestFurnaceClosedForm.

The camera sits inside a closed emissive cube (every face emission E,
albedo a, tint black), so every path hits a wall at every bounce and the
expected pixel value is E / (1 - g), g the per-bounce throughput gain.
Mode nee is unbiased and has no sphere light to sample, so g is the
layered BRDF's reflectance a (1 - r0) 20/21 exactly; mode path replicates
the reference's averaged pdf, so g is bracketed by the gains the port's
`layered_sample` measures at extreme incidence angles. Russian roulette
and the depth cap do not enter g: a mean off E / (1 - g) is an RR,
emission or throughput fault. The bars are tests/test_furnace.py's (6
standard errors plus 0.01, path 0.02) at 16x16, 64 spp (the JAX tests
render 32x32 at 256 spp; the standard error grows to match).
"""

import jax
import numpy as np
import pytest
import torch

from cornelis_tpu.scene.compile import compile_scene as jcompile
from cornelis_tpu_torch.integrator import render_chunk
from cornelis_tpu_torch.materials import MaterialParams, layered_sample
from cornelis_tpu_torch.math.vec import RGB, Vec3, construct_basis, dot
from cornelis_tpu_torch.rng import make_key, uniform
from cornelis_tpu_torch.scene.compile import from_numpy_scene, scene_arrays
from test_furnace import ALBEDO, EMISSION, ROUGHNESS, furnace_cube
from test_torch_wavefront import one_torch_thread  # noqa: F401 (a fixture)

W = H = 16
SPP = 64


@pytest.fixture(scope="module")
def furnace():
    return scene_arrays(from_numpy_scene(jax.device_get(jcompile(furnace_cube())), device="cpu"))


def _render(scene, mode):
    img = render_chunk(scene, make_key(3), 0, width=W, height=H, spp_chunk=SPP, spp_total=SPP,
                       max_depth=32, mode=mode) / SPP
    img = img.numpy()
    assert np.isfinite(img).all()
    return img.mean(), img.std() / np.sqrt(W * H)


def test_nee_furnace_hits_the_closed_form(furnace):
    mean, stderr = _render(furnace, "nee")
    r0 = ((1.0 - 1.5) / (1.0 + 1.5)) ** 2  # ior 1.5, the default
    expect = EMISSION / (1.0 - ALBEDO * (1.0 - r0) * 20.0 / 21.0)
    assert abs(mean - expect) < 6 * stderr + 0.01, (mean, expect, stderr)


def _gain_bounds():
    """Per-bounce gain E[f |cos| / pdf] of layered_sample at four incidence
    angles (the gain is monotone in the angle), +-4 standard errors."""
    m = 1 << 16
    x = uniform(make_key(7), 3 * m).reshape(3, m)
    full = lambda v: torch.full((m,), v)
    basis = construct_basis(Vec3(full(0.0), full(0.0), full(1.0)))
    params = MaterialParams(albedo=RGB(*(full(ALBEDO),) * 3), emission=RGB(*(full(EMISSION),) * 3),
                            tint=RGB(*(full(0.0),) * 3), roughness=full(ROUGHNESS),
                            ior=full(1.5))
    gains = []
    for theta in (0.0, 0.5, 1.0, 1.4):
        wo = Vec3(full(float(np.sin(theta))), full(0.0), full(float(np.cos(theta))))
        wi, pdf, f = layered_sample(wo, x[0], x[1], x[2], basis, params)
        w = (f.x * torch.abs(dot(wi, basis.n)) / pdf).double().numpy()
        gains.append((w.mean(), w.std() / np.sqrt(m)))
    return min(g - 4 * se for g, se in gains), max(g + 4 * se for g, se in gains)


def test_path_furnace_within_the_measured_gain(furnace):
    mean, stderr = _render(furnace, "path")
    g_lo, g_hi = _gain_bounds()
    lo, hi = EMISSION / (1.0 - g_lo), EMISSION / (1.0 - g_hi)
    assert lo - 6 * stderr - 0.02 < mean < hi + 6 * stderr + 0.02, (mean, lo, hi, stderr)
