"""The parts of mode "nee" against cornelis_tpu: the XLA wavefront, the light
table, the clamp, a scene with nothing to sample, and the pinned firefly.

  * The port's plain version in nee/sobol against
    `cornelis_tpu.integrator.render_chunk` (the XLA wavefront), which
    shares the Sobol draws bit for bit (as tests/test_pallas.py holds the
    Pallas kernel against it). Bars as in tests/test_torch_nee.py, for the
    same reason: 99% of rays on the mixed panel scene, 90% on Cornell,
    where the float32 sphere quadratic leaves hit points inside their
    sphere at random.
  * `ops.lights.light_table` against `_light_table(host)` row by row:
    kind and prim exact, the values equal to their float64 value rounded
    to float32; the clamp base against `_host_nee_clamp`.
  * An override binds, and math.inf disables the clamp.
  * A scene whose only emitter has negative luminance: K1's table is
    empty, so nothing is light-sampled, yet BSDF sampling still finds the
    emission; the plain version matches the JAX kernel ray by ray.
  * The firefly pinned by tests/test_nee.py (Cornell 512^2, nee + sobol,
    the default seed, spp_total 2048, pixel 77580, samples 544-575),
    traced as 32 explicit rays: the clamp takes it from > 5e3 to < 3.5e3.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cornelis_tpu.integrator import render_chunk as xla_render_chunk
from cornelis_tpu.ops.pallas_integrator import (
    _host_nee_clamp,
    _light_table,
    render_chunk_pallas,
    scene_to_host,
)
from cornelis_tpu.scene.compile import compile_scene as jcompile
from cornelis_tpu_torch.ops import lights, megakernel
from cornelis_tpu_torch.rng import DEFAULT_SEED, key_row
from cornelis_tpu_torch.scene.compile import compile_scene, from_numpy_scene
from cornelis_tpu_torch.scene.library import cornell_box
from test_torch_nee import agreement, scenes

W = H = 16


def _tables(name):
    jdesc, tdesc = scenes(name)
    return jcompile(jdesc), compile_scene(tdesc, device="cpu")


@pytest.mark.parametrize("name,bar", [("mixed_panel", 0.99), ("cornell_box", 0.90)])
def test_nee_sobol_matches_xla_wavefront(name, bar):
    jscene, tables = _tables(name)
    key = jax.random.key(4)
    kw = dict(width=W, height=H, spp_chunk=1, spp_total=8, max_depth=6, sampler="sobol", mode="nee")
    ours, theirs = [], []
    for off in (0, 5):
        x = xla_render_chunk(jscene, key, jnp.uint32(off), **kw)
        t = megakernel.render_chunk(tables, key_row(4), off, **kw)
        ours.append(t.numpy())
        theirs.append(np.asarray(x))
        frac, _ = agreement(ours[-1], theirs[-1])
        assert frac >= bar, f"only {frac:.2%} of rays agree"
    _, mean_rel = agreement(np.stack(ours), np.stack(theirs))
    assert (mean_rel <= 1e-2).all(), f"channel means differ by {mean_rel}"


@pytest.mark.parametrize("name", ["cornell_box", "cornell_panel", "mixed_panel"])
def test_light_table_equals_jax_rows(name):
    jscene = jcompile(scenes(name)[0])
    host = scene_to_host(jscene)
    expect = _light_table(host)
    got = lights.light_table(from_numpy_scene(jax.device_get(jscene), device="cpu"))
    rows = got.rows.numpy()
    assert rows.shape == (len(expect), lights.LIGHT_COLS)
    f32 = np.float32
    for row, (prob, cum, kind, prim, g, le) in zip(rows, expect):
        assert (row[lights.COL_KIND], row[lights.COL_PRIM]) == (kind, prim)
        want = [prob, cum, *g, *le]
        have = [row[lights.COL_PROB], row[lights.COL_CUM], *row[lights.COL_G:lights.COL_LE + 3]]
        np.testing.assert_array_equal(np.asarray(have), f32(want))
        # The MIS pickup's folded products, as K1 folds them in float64.
        r, w, h = g[3], g[6], g[7]
        folded = (r * r, (r * r) * 1.0002, 0.0) if kind == 0 else (0.0, 0.0, max(w * h, 1e-12))
        np.testing.assert_array_equal(row[lights.COL_R2:], f32(folded))
    assert got.clamp.item() == f32(_host_nee_clamp(host))


def test_light_table_override_and_no_emitter():
    tables = compile_scene(cornell_box(), device="cpu")
    assert lights.light_table(tables, 123.5).clamp.item() == 123.5
    assert lights.light_table(tables, math.inf).clamp.item() == math.inf
    dark = tables._replace(materials=tables.materials.clone())
    dark.materials[:, 3:6] = 0.0
    got = lights.light_table(dark)
    assert got.rows.shape == (0, lights.LIGHT_COLS) and got.clamp.item() == 16.0


def _clamped(nee_clamp):
    tables = compile_scene(cornell_box(), device="cpu")
    return megakernel.render_chunk(
        tables, key_row(DEFAULT_SEED), 0, width=W, height=H, spp_chunk=2, spp_total=2,
        max_depth=8, sampler="sobol", mode="nee", nee_clamp=nee_clamp,
    )


def test_clamp_override_binds_and_inf_disables():
    default, tight = _clamped(None), _clamped(0.01)
    # A clamp only lowers a contribution; at 0.01 it lowers most pixels.
    assert (tight <= default).all()
    assert (tight < default).any(-1).float().mean() > 0.5
    # inf: no bounce is clamped, so a finite clamp above every contribution
    # gives the same image to the bit.
    torch.testing.assert_close(_clamped(math.inf), _clamped(1e30), rtol=0, atol=0)


def _negative_emitter():
    jdesc, tdesc = scenes("cornell_box")
    for desc in (jdesc, tdesc):
        light = next(m for m in desc.materials if max(m.emissive) > 0)
        light.emissive = (1.0, -1.0, 0.0)  # luminance < 0: no table row
    return jdesc, tdesc


def test_scene_with_nothing_to_sample_matches_pallas():
    jdesc, tdesc = _negative_emitter()
    tables = compile_scene(tdesc, device="cpu")
    assert lights.light_table(tables).rows.shape[0] == 0
    key = jax.random.key(DEFAULT_SEED)
    kw = dict(width=W, height=H, spp_chunk=1, spp_total=16, max_depth=8, sampler="sobol", mode="nee")
    j = np.asarray(render_chunk_pallas(jcompile(jdesc), key, np.uint32(3), interpret=True, **kw))
    t = megakernel.render_chunk(tables, key_row(DEFAULT_SEED), 3, **kw).numpy()
    frac, mean_rel = agreement(t, j)
    assert frac >= 0.99 and (mean_rel <= 1e-2).all(), (frac, mean_rel)
    assert np.abs(t).max() > 0  # the emission is found by BSDF sampling


class TestFireflyPinned:
    """tests/test_nee.py::TestFireflyPinned on the port's plain version. The
    JAX lowerings put the raw sum near 10836; the port's, traced on the CPU,
    is 10656 (knife edges move it)."""

    PIXEL = 77580
    SAMPLES = (544, 576)

    def _max_sum(self, nee_clamp):
        tables = compile_scene(cornell_box(), device="cpu")
        k0, k1, root = key_row(DEFAULT_SEED)
        sample = torch.arange(*self.SAMPLES)
        rays = megakernel.render_rays_reference(
            tables, k0, k1, 512, 512, 1, 0, 64, "cpu", root=root, sampler="sobol",
            mode="nee", index_bits=megakernel.index_bits_for(2048),
            lights=lights.light_table(tables, nee_clamp),
            pixel=torch.full_like(sample, self.PIXEL), sample=sample,
        )
        return float(rays.sum(0).max())

    def test_firefly_exists_unclamped(self):
        assert self._max_sum(math.inf) > 5e3

    def test_default_clamp_suppresses_it(self):
        raw, clamped = self._max_sum(math.inf), self._max_sum(None)
        assert 20.0 < clamped < 3.5e3
        assert clamped < raw / 3.0
