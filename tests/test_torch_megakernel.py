"""The megakernel's plain torch version against the JAX Pallas kernel, per ray.

`render_rays_reference` must compute what
`cornelis_tpu.ops.pallas_integrator._make_kernel` (path mode, uniform and
Sobol samplers; mode "nee" is in tests/test_torch_nee.py) computes. The JAX kernel runs as its own tests run it on the
CPU, in Pallas interpret mode. With spp_chunk=1 every pixel of a chunk is
one ray, so the images compare ray by ray.

Bar, and why: the draws are bit-identical and the float32 expressions the
same, so almost every ray agrees to the last bits. A few paths sit on a
knife edge (a Russian-roulette draw or a closest-hit comparison within an
ulp of its threshold), where the ulps between XLA's and torch's sin/cos
send the path elsewhere; such a ray can differ by the light's radiance.
So, per chunk: all values finite and at least 99% of rays within
rtol = atol = 1e-4. Over all chunks of a scene (1024 rays), each
channel's mean within 1% relative: one knife-edge ray that reaches the
light on one side only carries up to 15x its throughput, which moves a
1024-ray mean by up to ~0.5%. Measured: 2 of 1024 rays outside 1e-4 in
cornell_box, 1 in cornell_panel, 0 in sphere_on_plane; the largest, at
sample 7 of pixel (9, 10) in both Cornell scenes, is a reflection off the
gold sphere whose next hit distance sits at the min_hit_t guard.

The CUDA kernel itself is compared with this plain version on the card by
chip_smoke.py, and under pytest by `tests/test_torch_cuda.py` where a
card is present.
"""

import jax
import numpy as np
import pytest
import torch

from cornelis_tpu.ops.pallas_integrator import render_chunk_pallas
from cornelis_tpu.scene import library as jlib
from cornelis_tpu.scene.compile import compile_scene as jcompile
from cornelis_tpu_torch.ops import lights, megakernel
from cornelis_tpu_torch.rng import DEFAULT_SEED, key_row
from cornelis_tpu_torch.scene import library as tlib
from cornelis_tpu_torch.scene.compile import compile_scene

W = H = 16
MAX_DEPTH = 8
OFFSETS = (0, 1, 7, 12)


def agreement(a, b):
    """(fraction of rays within rtol = atol = 1e-4, per-channel relative
    difference of the means) of two (..., 3) radiance arrays."""
    ok = np.isclose(a, b, rtol=1e-4, atol=1e-4).all(axis=-1)
    ma, mb = a.reshape(-1, 3).mean(0), b.reshape(-1, 3).mean(0)
    return ok.mean(), np.abs(ma - mb) / np.maximum(np.abs(mb), 1e-12)


def _render_pair(name, sampler):
    """(port image, JAX image) per offset for one scene, seed 19791102."""
    jscene = jcompile(getattr(jlib, name)())
    tables = compile_scene(getattr(tlib, name)(), device="cpu")
    key = jax.random.key(DEFAULT_SEED)
    out = []
    for off in OFFSETS:
        j = render_chunk_pallas(
            jscene, key, np.uint32(off), width=W, height=H, spp_chunk=1,
            spp_total=16, max_depth=MAX_DEPTH, interpret=True, sampler=sampler,
        )
        t = megakernel.render_chunk(
            tables, key_row(DEFAULT_SEED), off, width=W, height=H, spp_chunk=1,
            spp_total=16, max_depth=MAX_DEPTH, sampler=sampler,
        )
        out.append((t.numpy(), np.asarray(j)))
    return out


SCENES = ["cornell_box", "cornell_panel", "sphere_on_plane"]


@pytest.fixture(scope="module", params=SCENES)
def pair(request):
    return _render_pair(request.param, "uniform")


@pytest.fixture(scope="module", params=SCENES)
def sobol_pair(request):
    """As `pair`, with the Sobol sampler (16 spp in all: 4 index bits)."""
    return _render_pair(request.param, "sobol")


@pytest.mark.parametrize("i", range(len(OFFSETS)))
def test_plain_version_matches_pallas_per_ray(pair, i):
    t, j = pair[i]
    assert t.shape == j.shape == (H, W, 3)
    assert np.isfinite(t).all()
    frac, _ = agreement(t, j)
    assert frac >= 0.99, f"only {frac:.2%} of rays agree"


def test_plain_version_matches_pallas_mean(pair):
    t = np.stack([p[0] for p in pair])
    j = np.stack([p[1] for p in pair])
    _, mean_rel = agreement(t, j)
    assert (mean_rel <= 1e-2).all(), f"channel means differ by {mean_rel}"
    # Not a black image: some paths find the light.
    assert (t.sum(-1) > 0).sum() >= 5


@pytest.mark.parametrize("i", range(len(OFFSETS)))
def test_plain_sobol_matches_pallas_per_ray(sobol_pair, i):
    t, j = sobol_pair[i]
    assert t.shape == j.shape == (H, W, 3)
    assert np.isfinite(t).all()
    frac, _ = agreement(t, j)
    assert frac >= 0.99, f"only {frac:.2%} of rays agree"


def test_plain_sobol_matches_pallas_mean(sobol_pair):
    t = np.stack([p[0] for p in sobol_pair])
    j = np.stack([p[1] for p in sobol_pair])
    _, mean_rel = agreement(t, j)
    assert (mean_rel <= 1e-2).all(), f"channel means differ by {mean_rel}"
    assert (t.sum(-1) > 0).sum() >= 5


def test_cpu_wrapper_runs_plain_version_without_counting():
    tables = compile_scene(tlib.cornell_box(), device="cpu")
    before = megakernel.LAUNCHES
    a = megakernel.render_rays(tables, 0, 5, 8, 8, 2, 3, 4)
    b = megakernel.render_rays_reference(tables, 0, 5, 8, 8, 2, 3, 4, "cpu")
    assert megakernel.LAUNCHES == before
    assert a.shape == (8 * 8 * 2, 3) and torch.equal(a, b)


def test_chunk_sums_samples_per_pixel():
    tables = compile_scene(tlib.sphere_on_plane(), device="cpu")
    rays = megakernel.render_rays_reference(tables, 0, 9, 4, 3, 5, 2, 4, "cpu")
    chunk = megakernel.render_chunk(
        tables, (0, 9, 0), 2, width=4, height=3, spp_chunk=5, spp_total=8, max_depth=4
    )
    torch.testing.assert_close(chunk, rays.view(3, 4, 5, 3).sum(2), rtol=0, atol=0)


def test_samples_are_chunk_invariant():
    # Ray (pixel, sample) draws depend on the sample index only, not on
    # how samples are split into chunks.
    tables = compile_scene(tlib.cornell_box(), device="cpu")
    whole = megakernel.render_rays_reference(tables, 0, 1, 4, 4, 4, 0, 6, "cpu").view(16, 4, 3)
    part = megakernel.render_rays_reference(tables, 0, 1, 4, 4, 2, 2, 6, "cpu").view(16, 2, 3)
    torch.testing.assert_close(whole[:, 2:], part, rtol=0, atol=0)


@pytest.mark.parametrize(
    "field,bad",
    [
        ("camera", torch.zeros(11)),
        ("spheres", torch.zeros(2, 4)),
        ("planes", torch.zeros(2, 9, dtype=torch.float64)),
        ("materials", torch.zeros(0, 11)),
        ("materials", torch.zeros(11, 3).t()),
    ],
)
def test_wrapper_rejects_bad_tables(field, bad):
    tables = compile_scene(tlib.cornell_box(), device="cpu")._replace(**{field: bad})
    with pytest.raises(ValueError):
        megakernel.render_rays(tables, 0, 1, 4, 4, 1, 0, 2)


@pytest.mark.parametrize(
    "mode,sampler", [("path", "uniform"), ("path", "sobol"), ("nee", "uniform"), ("nee", "sobol")]
)
def test_cpu_tables_run_plain_version(mode, sampler):
    # The tables' device alone decides: CPU tables run the plain version
    # and launch nothing.
    tables = compile_scene(tlib.cornell_box(), device="cpu")
    key = key_row(5)
    before = megakernel.LAUNCHES
    chunk = megakernel.render_chunk(
        tables, key, 3, width=4, height=4, spp_chunk=2, spp_total=8, max_depth=4,
        sampler=sampler, mode=mode,
    )
    assert megakernel.LAUNCHES == before
    rays = megakernel.render_rays_reference(
        tables, key[0], key[1], 4, 4, 2, 3, 4, "cpu", root=key[2], sampler=sampler,
        mode=mode, index_bits=3, lights=lights.light_table(tables),
    )
    torch.testing.assert_close(chunk, rays.view(4, 4, 2, 3).sum(2), rtol=0, atol=0)
