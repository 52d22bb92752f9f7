"""The dynamic-scene render (K3) against cornelis_tpu's dynamic-scene kernel.

`ops.megakernel.render_chunk_dynamic` is the megakernel with K3's light
table, `lights.IN_LAUNCH` (every sphere and plane a row, in float32): on a
card its launch builds
the table from the tables in every block; on the CPU the plain version
takes it from `lights.light_table_dyn_reference`. It must compute what
`cornelis_tpu.ops.pallas_dynamic.render_chunk_pallas_dynamic` computes,
here in Pallas interpret mode, ray by ray (spp_chunk 1). Bars as in
tests/test_torch_nee.py and for the same reason: 99% of rays within
rtol = atol = 1e-4 per chunk where no sphere is seen from far away (the
mixed panel scene, and mode "path"), 90% on Cornell in mode "nee", where
the float32 sphere quadratic leaves hit points inside their sphere at
random and the two frameworks round them differently; channel means
within 1% everywhere.

Also: the table against `_light_rows_dyn` and `_clamp_base_dyn` (eager
JAX, one float32 op at a time, so bit for bit), on the scenes' tables and
on the edge tables of tests/torch_light_tables.py (sphere_grid(64), a -0
emission, an infinite and a NaN emission no primitive uses, ids off the
material table, no emission); doubling every emission doubles the image
(the bar of tests/test_dynamic.py), and the scope guards.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cornelis_tpu.ops.pallas_dynamic import (
    _clamp_base_dyn,
    _light_rows_dyn,
    render_chunk_pallas_dynamic,
)
from cornelis_tpu.ops.pallas_integrator import HostScene
from cornelis_tpu.scene.compile import compile_scene as jcompile
from cornelis_tpu.scene.library import sdf_gallery
from cornelis_tpu_torch.ops import lights, megakernel
from cornelis_tpu_torch.ops.megakernel import render_chunk_dynamic
from cornelis_tpu_torch.rng import DEFAULT_SEED, key_row
from cornelis_tpu_torch.scene.compile import compile_scene, from_numpy_scene
from cornelis_tpu_torch.scene.description import SceneDescription
from test_torch_nee import agreement, scenes
from torch_light_tables import table_case

W = H = 16
KW = dict(width=W, height=H, spp_chunk=1, spp_total=16, max_depth=8)
OFFSETS = (0, 5, 9, 13)


@pytest.mark.parametrize(
    "name,mode,sampler,bar",
    [
        ("cornell_box", "path", "sobol", 0.99),
        ("cornell_box", "nee", "sobol", 0.90),
        ("mixed_panel", "nee", "sobol", 0.99),
        ("cornell_panel", "nee", "uniform", 0.90),
    ],
)
def test_plain_k3_matches_pallas_dynamic(name, mode, sampler, bar):
    jdesc, tdesc = scenes(name)
    jscene, tables = jcompile(jdesc), compile_scene(tdesc, device="cpu")
    key = jax.random.key(DEFAULT_SEED)
    ours, theirs = [], []
    for off in OFFSETS:
        j = render_chunk_pallas_dynamic(
            jscene, key, np.uint32(off), interpret=True, sampler=sampler, mode=mode, **KW
        )
        t = render_chunk_dynamic(
            tables, key_row(DEFAULT_SEED), off, sampler=sampler, mode=mode, **KW
        )
        ours.append(t.numpy())
        theirs.append(np.asarray(j))
        assert np.isfinite(ours[-1]).all()
        frac, _ = agreement(ours[-1], theirs[-1])
        assert frac >= bar, f"only {frac:.2%} of rays agree"
    _, mean_rel = agreement(np.stack(ours), np.stack(theirs))
    assert (mean_rel <= 1e-2).all(), f"channel means differ by {mean_rel}"


def _pseudo(tables):
    """The tables as the HostScene of float32 scalars that K3 reads."""
    s = lambda v: jnp.float32(v)
    sph = tuple(tuple(s(v) for v in row) for row in tables.spheres.tolist())
    pln = tuple(
        tuple(s(v) for v in row[:8]) + (jnp.int32(int(row[8])),) for row in tables.planes.tolist()
    )
    mats = tuple(
        (tuple(s(v) for v in r[0:3]), tuple(s(v) for v in r[3:6]), tuple(s(v) for v in r[6:9]),
         s(r[9]), s(r[10]))
        for r in tables.materials.tolist()
    )
    return HostScene(camera=None, spheres=sph, planes=pln, materials=mats, sdfs=())


@pytest.mark.parametrize(
    "name",
    ["cornell_box", "cornell_panel", "mixed_panel", "sphere_grid(64)", "cornell_neg0_emission",
     "cornell_inf_nan_unused", "cornell_odd_ids", "cornell_no_emission", "cornell_neg_emission"],
)
def test_light_table_dyn_equals_jax_rows(name):
    if name in ("cornell_box", "cornell_panel", "mixed_panel"):
        tables = from_numpy_scene(jax.device_get(jcompile(scenes(name)[0])), device="cpu")
    else:
        tables = table_case(name)
    pseudo = _pseudo(tables)
    got = lights.light_table_dyn(tables)
    rows = got.rows.numpy()
    expect = _light_rows_dyn(pseudo)
    assert rows.shape == (len(expect), lights.LIGHT_COLS)
    f32 = np.float32
    for row, (prob, cum, kind, prim, g, le) in zip(rows, expect):
        assert (row[lights.COL_KIND], row[lights.COL_PRIM]) == (kind, prim)
        want = np.array([np.float32(v) for v in (prob, cum, *g, *le)])
        have = np.concatenate([row[:2], row[lights.COL_G:lights.COL_LE + 3]])
        np.testing.assert_array_equal(have, want)
        r, w, h = (f32(v) for v in (g[3], g[6], g[7]))
        if kind == 0:
            pick = (r * r, (r * r) * f32(1.0002), 0.0)
        else:
            pick = (0.0, 0.0, max(w * h, f32(1e-12)))
        np.testing.assert_array_equal(row[lights.COL_R2:], np.array(pick, np.float32))
    np.testing.assert_array_equal(got.clamp.numpy(), np.float32(_clamp_base_dyn(pseudo)))


def test_doubling_emission_doubles_the_image():
    tables = compile_scene(scenes("cornell_box")[1], device="cpu")
    kw = dict(KW, spp_chunk=4, sampler="sobol", mode="nee")
    base = render_chunk_dynamic(tables, key_row(6), 0, **kw)
    brighter = tables._replace(materials=tables.materials.clone())
    brighter.materials[:, 3:6] *= 2.0
    img = render_chunk_dynamic(brighter, key_row(6), 0, **kw)
    torch.testing.assert_close(img, base * 2.0, rtol=1e-5, atol=1e-5)
    assert base.max() > 0


def test_no_objects_raises_value_error():
    empty = SceneDescription()
    empty.add_material(scenes("cornell_box")[1].materials[0])
    tables = compile_scene(empty, device="cpu")
    with pytest.raises(ValueError):
        render_chunk_dynamic(tables, key_row(0), 0, sampler="sobol", mode="nee", **KW)
    # Mode "path" has no light table: every ray misses.
    img = render_chunk_dynamic(tables, key_row(0), 0, sampler="sobol", mode="path", **KW)
    assert float(img.abs().max()) == 0.0


def test_sdf_scene_raises_not_implemented():
    # The tables carry SDFs now, but K3 takes none, as
    # render_chunk_pallas_dynamic (pallas_dynamic.py:591) takes none.
    tables = from_numpy_scene(jax.device_get(jcompile(sdf_gallery())), device="cpu")
    assert tables.sdfs.shape[0] == 3
    for mode in ("path", "nee"):
        with pytest.raises(NotImplementedError):
            render_chunk_dynamic(tables, key_row(0), 0, sampler="sobol", mode=mode, **KW)


def test_cpu_tables_launch_nothing():
    tables = compile_scene(scenes("cornell_box")[1], device="cpu")
    before = (megakernel.LAUNCHES, lights.LAUNCHES)
    render_chunk_dynamic(tables, key_row(1), 0, sampler="uniform", mode="nee", **dict(KW, max_depth=2))
    assert (megakernel.LAUNCHES, lights.LAUNCHES) == before


def test_dynamic_table_on_the_cpu_is_the_plain_tables():
    # On CPU tables, render_rays(lights=IN_LAUNCH) traces with
    # light_table_dyn_reference's table, and launches nothing.
    tables = compile_scene(scenes("cornell_panel")[1], device="cpu")
    k0, k1, root = key_row(3)
    kw = dict(root=root, sampler="sobol", mode="nee", index_bits=4)
    before = (megakernel.LAUNCHES, megakernel.DYNAMIC_TABLE_LAUNCHES, lights.LAUNCHES)
    got = megakernel.render_rays(tables, k0, k1, 8, 8, 2, 0, 4, lights=lights.IN_LAUNCH, **kw)
    want = megakernel.render_rays(tables, k0, k1, 8, 8, 2, 0, 4,
                                  lights=lights.light_table_dyn_reference(tables), **kw)
    assert torch.equal(got, want)
    assert (megakernel.LAUNCHES, megakernel.DYNAMIC_TABLE_LAUNCHES, lights.LAUNCHES) == before


@pytest.mark.parametrize(
    "case", ["path", "sdf", "pixel_ids", "empty", "k1_wrong_width", "nee_without_table"]
)
def test_dynamic_table_guards(case):
    # IN_LAUNCH builds mode nee's table from spheres and planes alone: it is
    # refused in mode path, with a pixel list and with neither a sphere nor
    # a plane (ValueError), and with SDF rows (NotImplementedError, as
    # render_chunk_dynamic refuses them). A nee launch needs a table, and
    # K1's has LIGHT_COLS columns.
    tables = compile_scene(scenes("cornell_box")[1], device="cpu")
    kw = dict(mode="nee", lights=lights.IN_LAUNCH)
    error = ValueError
    if case == "path":
        kw["mode"] = "path"
    elif case == "sdf":
        tables = from_numpy_scene(jax.device_get(jcompile(sdf_gallery())), device="cpu")
        error = NotImplementedError
    elif case == "pixel_ids":
        kw["pixel_ids"] = torch.zeros(4, dtype=torch.int32)
    elif case == "empty":
        tables = tables._replace(spheres=tables.spheres[:0], planes=tables.planes[:0])
    elif case == "k1_wrong_width":
        k1 = lights.light_table(tables)
        kw["lights"] = k1._replace(rows=k1.rows[:, :-1].contiguous())
    else:
        kw["lights"] = None
    with pytest.raises(error):
        megakernel.render_rays(tables, 0, 1, 4, 4, 1, 0, 2, **kw)
