"""The port's torch wavefront against cornelis_tpu's XLA wavefront.

The same scenes (JAX's SceneArrays carried over by `from_numpy_scene`)
and the same seeds go through both packages; the wavefront draws as the
JAX one does (tests/test_torch_rng.py pins the draws bit for bit).

- Closest hit and shadow rays: `intersect_scene` and `occluded` on 2048
  random rays per builtin scene (camera rays, and rays leaving the first
  hits in random directions). Hit flags, kind, primitive and material
  equal (measured: all); t within 3e-4 relative and normals within 5e-3,
  the SDF march tolerances of tests/test_torch_sdf.py (measured: 1.0e-4
  and 9.9e-4), t also within 2e-4 absolute and points within 3e-4 of the
  scene's size: rays leaving a Cornell sphere 1e-3 off its surface, about
  1000 units out, re-hit it at t of 1e-3 to 1e-2, where float32 rounding
  of the quadratic at that scale moves t by up to 1.6e-4 (measured).
- `integrator.render_chunk`: 16x16, samples 0-3 of spp_total 4 as four
  chunks of one sample (so each pixel is one ray), max_depth 8, every
  mode x sampler, on each scene in a file of its own
  (tests/test_torch_wavefront_{sphere,cornell,sdf,sdf_nee}.py, with the
  checks defined here). Bars: per chunk at least 99% of
  rays within rtol = atol = 1e-4, and on Cornell in mode nee 90%; over
  the four chunks the channel means within 1%. Measured (seed 19791102):
  Cornell path 99.22-100%, nee 93.75-97.27% (the float32 knife edge of
  ROADMAP §C: a hit point left inside its sphere shadows its own light
  sample, and rounding decides which); sphere_on_plane 99.61-100%; means
  within 8.5e-4.
- `render_diff`: its image equals `render_chunk`'s sums over spp bit for
  bit (the same bounces, recorded by autograd); against JAX's render_diff
  at 16x16x4 spp per pixel (four rays each): at least 99% within 1e-4,
  Cornell in mode nee 85% (measured 89.06%; the per-ray bar above is the
  90% one), channel means within 1%.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cornelis_tpu import geometry as jgeo
from cornelis_tpu import integrator as jint
from cornelis_tpu.diff import render_diff as jrender_diff
from cornelis_tpu.math.vec import Vec3 as JVec3
from cornelis_tpu.scene import library as jlib
from cornelis_tpu.scene.compile import compile_scene as jcompile
from cornelis_tpu_torch import geometry as tgeo
from cornelis_tpu_torch import integrator as tint
from cornelis_tpu_torch.diff import render_diff
from cornelis_tpu_torch.math.vec import Vec3
from cornelis_tpu_torch.rng import DEFAULT_SEED, make_key
from cornelis_tpu_torch.scene.compile import (
    SceneArrays,
    compile_scene,
    from_numpy_scene,
    scene_arrays,
    tables_from_arrays,
)
from cornelis_tpu_torch.scene.library import BUILTIN_SCENES, cornell_box

N_RAYS = 2048
T_RTOL = 3e-4
T_ATOL = 2e-4
N_ATOL = 5e-3
RAY_TOL = 1e-4
FRACTION = {"default": 0.99, ("cornell_box", "nee"): 0.90}
PIXEL_FRACTION = {"default": 0.99, ("cornell_box", "nee"): 0.85}
MEAN_REL = 0.01
CHUNK = dict(width=16, height=16, spp_chunk=1, spp_total=4, max_depth=8)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread while a module of these runs: the suite's workers
    share the host's cores, and at these sizes idle intra-op threads only
    take cycles from the other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def both(name: str):
    """(JAX SceneArrays, the port's SceneArrays) of a JAX library scene."""
    jscene = jcompile(getattr(jlib, name)())
    return jscene, scene_arrays(from_numpy_scene(jax.device_get(jscene), device="cpu"))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


_intersect = jax.jit(jgeo.intersect_scene)
_occluded = jax.jit(jgeo.occluded)


def _rays(jscene, seed):
    """2048 rays as numpy (o, d): camera rays through random film points,
    and rays leaving the first hits of others (where there are) in random
    directions. The JAX closest hit is compiled once per scene, for 2048
    rays."""
    rng = np.random.default_rng(seed)
    cam = jax.device_get(jscene.camera)
    f = lambda v: np.float32([v.x, v.y, v.z])
    x, y = rng.random((2, N_RAYS), dtype=np.float32)
    d = f(cam.corner)[:, None] + x * f(cam.u)[:, None] + y * f(cam.v)[:, None]
    d = (d / np.linalg.norm(d, axis=0)).astype(np.float32)
    o = np.repeat(f(cam.eye)[:, None], N_RAYS, axis=1)
    hit = _intersect(jscene, JVec3(*o), JVec3(*d))
    half = N_RAYS // 2
    p = np.stack([np.asarray(c)[half:] for c in hit.position])
    n = np.stack([np.asarray(c)[half:] for c in hit.normal])
    p = np.where(np.asarray(hit.hit)[None, half:], p + 1e-3 * n, o[:, half:])
    w = rng.normal(size=(3, half)).astype(np.float32)
    w = (w / np.linalg.norm(w, axis=0)).astype(np.float32)
    return np.concatenate([o[:, :half], p], axis=1), np.concatenate([d[:, :half], w], axis=1)


@pytest.fixture(scope="module", params=sorted(BUILTIN_SCENES))
def scene_rays(request):
    jscene = jcompile(jlib.BUILTIN_SCENES[request.param]())
    tscene = scene_arrays(from_numpy_scene(jax.device_get(jscene), device="cpu"))
    o, d = _rays(jscene, sorted(BUILTIN_SCENES).index(request.param))
    return request.param, jscene, tscene, o, d


def test_intersect_scene_matches_jax(scene_rays):
    name, jscene, tscene, o, d = scene_rays
    want = _intersect(jscene, JVec3(*o), JVec3(*d))
    got = tgeo.intersect_scene(tscene, Vec3(*_t(o)), Vec3(*_t(d)))
    for field in ("hit", "kind", "prim", "material"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)), err_msg=f"{name} {field}")
    hit = np.asarray(want.hit)
    assert hit.mean() > 0.3, name
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(want.t)[hit], rtol=T_RTOL,
                               atol=T_ATOL)
    assert np.isinf(got.t.numpy()[~hit]).all()
    for a, b in zip(got.normal, want.normal):
        np.testing.assert_allclose(a.numpy()[hit], np.asarray(b)[hit], atol=N_ATOL)
    size = 1.0 + np.abs(o).max()
    for a, b in zip(got.position, want.position):
        np.testing.assert_allclose(a.numpy()[hit], np.asarray(b)[hit], rtol=0, atol=T_RTOL * size)


def test_occluded_matches_jax(scene_rays):
    name, jscene, tscene, o, d = scene_rays
    t_max = np.random.default_rng(5).uniform(0.0, 1500.0, N_RAYS).astype(np.float32)
    want = np.asarray(_occluded(jscene, JVec3(*o), JVec3(*d), t_max))
    got = tgeo.occluded(tscene, Vec3(*_t(o)), Vec3(*_t(d)), _t(t_max))
    assert 0.0 < want.mean() < 1.0, name
    np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


def test_sphere_candidate_matches_jax():
    rng = np.random.default_rng(3)
    c, r = np.float32([0.5, -0.25, 1.0]), np.float32(1.5)
    o = rng.normal(size=(3, 512)).astype(np.float32) * 4.0
    d = (c[:, None] - o + rng.normal(size=(3, 512)) * 1.5).astype(np.float32)
    jt, jp, jn, jv = jgeo.sphere_candidate(JVec3(*o), JVec3(*d), JVec3(*c), r)
    tt, tp, tn, tv = tgeo.sphere_candidate(Vec3(*_t(o)), Vec3(*_t(d)), Vec3(*_t(c)), _t(r))
    hit = np.asarray(jv)
    assert 0.1 < hit.mean() < 0.9
    np.testing.assert_array_equal(tv.numpy(), hit)
    np.testing.assert_allclose(tt.numpy()[hit], np.asarray(jt)[hit], rtol=1e-6)
    for a, b in zip(list(tp) + list(tn), list(jp) + list(jn)):
        np.testing.assert_allclose(a.numpy()[hit], np.asarray(b)[hit], rtol=1e-5, atol=1e-5)


def test_scene_arrays_round_trip_to_tables():
    tables = compile_scene(cornell_box(), device="cpu")
    arrays = scene_arrays(tables)
    assert isinstance(arrays, SceneArrays)
    assert (arrays.num_spheres, arrays.num_planes, arrays.num_sdfs) == (4, 5, 0)
    back = tables_from_arrays(arrays)
    for name, a, b in zip(tables._fields, tables, back):
        assert torch.equal(a, b), name


def test_scene_arrays_equal_jax_fields():
    jscene, tscene = both("sdf_gallery")
    host = jax.device_get(jscene)
    for field in SceneArrays._fields:
        if field == "camera":
            continue
        want, got = getattr(host, field), getattr(tscene, field)
        if isinstance(got, Vec3):
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b, np.float32))
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(got.numpy().dtype))


def _agreement(a, b):
    close = np.isclose(a, b, rtol=RAY_TOL, atol=RAY_TOL).all(axis=-1).mean()
    ma, mb = a.reshape(-1, 3).mean(0), b.reshape(-1, 3).mean(0)
    return close, float((np.abs(ma - mb) / np.maximum(np.abs(mb), 1e-12)).max())


VARIANTS = [("path", "uniform"), ("path", "sobol"), ("nee", "uniform"), ("nee", "sobol")]


def check_render_chunk(name, mode, sampler):
    jscene, tscene = both(name)
    bar = FRACTION.get((name, mode), FRACTION["default"])
    kw = dict(CHUNK, sampler=sampler, mode=mode)
    jsum = tsum = 0.0
    for offset in range(4):
        want = np.asarray(jint.render_chunk(jscene, jax.random.key(DEFAULT_SEED),
                                            jnp.uint32(offset), **kw))
        got = tint.render_chunk(tscene, make_key(DEFAULT_SEED), offset, **kw)
        assert got.shape == (16, 16, 3) and got.dtype == torch.float32
        assert bool(torch.isfinite(got).all())
        frac, _ = _agreement(got.numpy(), want)
        assert frac >= bar, (name, mode, sampler, offset, frac)
        jsum, tsum = jsum + want, tsum + got.numpy()
    assert _agreement(tsum, jsum)[1] <= MEAN_REL


def check_render_diff(name, mode):
    jscene, tscene = both(name)
    kw = dict(width=16, height=16, spp=4, max_depth=8, mode=mode)
    with torch.no_grad():
        got = render_diff(tscene, make_key(DEFAULT_SEED), **kw)
    chunk = tint.render_chunk(tscene, make_key(DEFAULT_SEED), 0, width=16, height=16,
                              spp_chunk=4, spp_total=4, max_depth=8, mode=mode)
    assert torch.equal(got, chunk / 4)
    want = np.asarray(jrender_diff(jscene, jax.random.key(DEFAULT_SEED), **kw))
    frac, rel = _agreement(got.numpy(), want)
    assert frac >= PIXEL_FRACTION.get((name, mode), PIXEL_FRACTION["default"]), frac
    assert rel <= MEAN_REL, rel


def test_render_chunk_rejects_unknown_sampler():
    _, tscene = both("sphere_on_plane")
    with pytest.raises(ValueError, match="unknown sampler"):
        tint.render_chunk(tscene, make_key(1), 0, width=4, height=4, spp_chunk=1, spp_total=1,
                          max_depth=2, sampler="halton")
