"""The port's SDF primitives and SDF scenes against cornelis_tpu.

Geometry: `sdf_distance`, `sdf_normal` and `sdf_candidate` of the port
against `cornelis_tpu.geometry` for each kind, on random points and rays
(numpy seeds), with and without a rotation and a uniform scale; the JAX
side takes them as Python floats, as K1 bakes them. Bars, and why:

- distances within 1e-6: one float32 expression on both sides; torch's
  CPU sqrt is not always correctly rounded (measured: 2.4e-7 at most);
- hit flags equal on at least 99.9% of rays (measured: all 24,576); t
  within 3e-4 relative where both hit: one ulp that moves a march step
  across the hit tolerance SDF_EPS * max(1, t) stops the march a step
  earlier or later, which moves t by up to that tolerance (measured:
  1.0e-4);
- normals within 5e-3: the 4-tap tetrahedron normal takes differences of
  distances about 1e-4 apart, computed from values near 1, so it
  amplifies a rounding of the march by about 1e3, and a march stopped a
  step apart takes it at a point up to the hit tolerance away (measured:
  1.3e-3 on one ray of a torus, 4.4e-4 elsewhere).

Tables: sdf_gallery and its turned-and-scaled copy (`sdf_gallery_transformed`)
compile to the tables `from_numpy_scene` carries over from the JAX
package, bit for bit.

The whole slice: `render_rays_reference` against
`render_chunk_pallas(..., interpret=True)` on both scenes, 16x16, one
sample per pixel at three offsets, max_depth 8, in all four mode x sampler
variants. Bars: per chunk at least 95% of rays within rtol = atol = 1e-4
(measured: 99.6-100%, one ray of 256 apart in some nee chunks; 98-99.6%
of rays bitwise equal in path mode, 56-61% in nee mode), over the chunks
channel means within 1% (measured: 3.3e-6). The margin is for the SDF
knife edge above (a ray whose march stops a step apart grazes on
elsewhere), which XLA's contraction of a * b + c into FMAs can move.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cornelis_tpu import geometry as jg
from cornelis_tpu.math.vec import Vec3 as JVec3
from cornelis_tpu.ops.pallas_integrator import (
    _host_nee_clamp,
    _light_table,
    host_scene_from_description,
    render_chunk_pallas,
)
from cornelis_tpu.scene import library as jlib
from cornelis_tpu.scene.compile import compile_scene as jcompile
from cornelis_tpu.scene.description import SceneDescription as JScene
from cornelis_tpu_torch import geometry as tg
from cornelis_tpu_torch.math.vec import Vec3 as TVec3
from cornelis_tpu_torch.math.vec import mag2
from cornelis_tpu_torch import RenderOptions, RenderSession, RenderStatus
from cornelis_tpu_torch.__main__ import main as cli_main
from cornelis_tpu_torch.ops import lights, megakernel
from cornelis_tpu_torch.rng import DEFAULT_SEED, key_row
from cornelis_tpu_torch.utils.png import read_png
from cornelis_tpu_torch.scene import library as tlib
from cornelis_tpu_torch.scene.compile import (
    SDF_COLS,
    compile_scene,
    from_numpy_scene,
    scene_arrays,
)
from test_torch_nee import agreement

KINDS = {"sphere": 0, "box": 1, "torus": 2}
PARAMS = {0: (1.0, 0.0, 0.0, 0.0), 1: (0.8, 0.5, 0.6, 0.0), 2: (1.0, 0.35, 0.0, 0.0)}
N = 4096


def _jv(a):
    return JVec3(*(jnp.asarray(a[:, i]) for i in range(3)))


def _tv(a):
    return TVec3(*(torch.from_numpy(np.ascontiguousarray(a[:, i])) for i in range(3)))


def _rotation(rng):
    a, b, c = rng.uniform(-1.0, 1.0, 3)
    rx = np.array([[1, 0, 0], [0, math.cos(a), -math.sin(a)], [0, math.sin(a), math.cos(a)]])
    ry = np.array([[math.cos(b), 0, math.sin(b)], [0, 1, 0], [-math.sin(b), 0, math.cos(b)]])
    rz = np.array([[math.cos(c), -math.sin(c), 0], [math.sin(c), math.cos(c), 0], [0, 0, 1]])
    return (rx @ ry @ rz).astype(np.float32)


@pytest.mark.parametrize("kind", list(KINDS))
def test_sdf_distance_matches_jax(kind):
    k = KINDS[kind]
    params = np.asarray(PARAMS[k], np.float32)
    q = np.random.RandomState(3 + k).uniform(-2.0, 2.0, (N, 3)).astype(np.float32)
    want = np.asarray(jg.sdf_distance(k, jnp.asarray(params), _jv(q)))
    got = tg.sdf_distance(k, torch.from_numpy(params), _tv(q)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", list(KINDS))
def test_sdf_normal_matches_jax(kind):
    k = KINDS[kind]
    params = np.asarray(PARAMS[k], np.float32)
    rng = np.random.RandomState(11 + k)
    q = rng.uniform(-2.0, 2.0, (N, 3)).astype(np.float32)
    h = np.float32(1e-4) * rng.uniform(1.0, 3.0, N).astype(np.float32)
    want = jg.sdf_normal(k, jnp.asarray(params), _jv(q), jnp.asarray(h))
    got = tg.sdf_normal(k, torch.from_numpy(params), _tv(q), torch.from_numpy(h))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-3)


@pytest.mark.parametrize("transformed", [False, True], ids=["plain", "turned-scaled"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_sdf_candidate_matches_jax(kind, transformed):
    k = KINDS[kind]
    rng = np.random.RandomState(23 + 2 * k + transformed)
    params = np.asarray(PARAMS[k], np.float32)
    rot = _rotation(rng) if transformed else np.eye(3, dtype=np.float32)
    scale = np.float32(0.7 if transformed else 1.0)
    center = np.asarray([0.3, -0.2, 0.5], np.float32)
    o = (rng.uniform(-1.0, 1.0, (N, 3)) + [0.0, 0.0, -6.0]).astype(np.float32)
    target = (center + rng.uniform(-1.2, 1.2, (N, 3))).astype(np.float32)
    # Directions of length 0.5-2: t is in the ray's own parameterization.
    d = ((target - o) * rng.uniform(0.5, 2.0, (N, 1)) / 6.0).astype(np.float32)

    jt, _jp, jn, jvalid = jg.sdf_candidate(
        _jv(o), _jv(d), k, JVec3(*map(float, center)), tuple(map(float, params)),
        rot=tuple(tuple(float(v) for v in row) for row in rot), scale=float(scale),
    )
    tt, _tp, tn, tvalid = tg.sdf_candidate(
        _tv(o), _tv(d), k, TVec3(*(torch.tensor(float(v)) for v in center)),
        torch.from_numpy(params), rot=torch.from_numpy(rot), scale=torch.tensor(scale),
    )
    jvalid, tvalid = np.asarray(jvalid), tvalid.numpy()
    assert (tvalid == jvalid).mean() >= 0.999
    hit = jvalid & tvalid
    assert 0.1 < hit.mean() < 0.9
    assert np.isinf(tt.numpy()[~tvalid]).all()
    np.testing.assert_allclose(tt.numpy()[hit], np.asarray(jt)[hit], rtol=3e-4)
    for a, b in zip(tn, jn):
        np.testing.assert_allclose(a.numpy()[hit], np.asarray(b)[hit], atol=5e-3)


def test_sdf_candidate_shadow_form_and_degenerate_ray():
    # with_normal=False gives the same t and flag, and no normal; a zero
    # direction never hits.
    o = TVec3(*(torch.tensor([0.0, 0.0]) for _ in range(2)), torch.tensor([-5.0, -5.0]))
    d = TVec3(torch.tensor([0.0, 0.0]), torch.tensor([0.0, 0.0]), torch.tensor([1.0, 0.0]))
    c = TVec3(*(torch.tensor(0.0) for _ in range(3)))
    p = torch.tensor([1.0, 0.0, 0.0, 0.0])
    t, _p, n, valid = tg.sdf_candidate(o, d, 0, c, p)
    t2, _p2, n2, valid2 = tg.sdf_candidate(o, d, 0, c, p, with_normal=False)
    assert valid.tolist() == valid2.tolist() == [True, False]
    assert torch.equal(t, t2) and n2 is None and n is not None
    assert abs(t[0].item() - 4.0) < 5e-3 and math.isinf(t[1].item())


def test_sdf_march_steps_count_each_rays_own_march():
    # A unit sphere at the origin, rays from (0, 0, -5): head-on (a hit at
    # the second evaluation), away from it and past it (both escape past
    # SDF_MAX_T). Each count is the evaluations of that ray's own march,
    # which stops when it is done; the batch marches on for the others.
    def own_march(oz, dz, dx):
        norm = math.hypot(dx, dz)
        t, n = 0.0, 0
        while n < tg.SPHERE_TRACE_STEPS:
            n += 1
            px, pz = t * dx / norm, oz + t * dz / norm
            dist = math.hypot(px, pz) - 1.0
            eps = tg.SDF_EPS * max(t, 1.0)
            if abs(dist) < eps or t > tg.SDF_MAX_T:
                break
            t += max(dist, 0.5 * eps)
        return n

    rays = [(2.0, 0.0), (-1.0, 0.0), (1.0, 0.3)]
    o = TVec3(torch.zeros(3), torch.zeros(3), torch.full((3,), -5.0))
    d = TVec3(torch.tensor([dx for _dz, dx in rays]), torch.zeros(3),
              torch.tensor([dz for dz, _dx in rays]))
    c = TVec3(*(torch.tensor(0.0) for _ in range(3)))
    steps = tg.sdf_march_steps(o, d, 0, c, torch.tensor([1.0, 0.0, 0.0, 0.0]))
    want = [own_march(-5.0, dz, dx) for dz, dx in rays]
    assert want[0] == 2 and min(want[1:]) > 8
    assert steps.dtype == torch.int32 and steps.tolist() == want


def _random_sdf_rays(kind):
    """(o, d, center, params, rot, scale) of test_sdf_candidate_matches_jax's
    turned-and-scaled case, as torch values."""
    rng = np.random.RandomState(23 + 2 * kind + 1)
    params = np.asarray(PARAMS[kind], np.float32)
    rot, scale = _rotation(rng), np.float32(0.7)
    center = np.asarray([0.3, -0.2, 0.5], np.float32)
    o = (rng.uniform(-1.0, 1.0, (N, 3)) + [0.0, 0.0, -6.0]).astype(np.float32)
    target = (center + rng.uniform(-1.2, 1.2, (N, 3))).astype(np.float32)
    d = ((target - o) * rng.uniform(0.5, 2.0, (N, 1)) / 6.0).astype(np.float32)
    return (_tv(o), _tv(d), TVec3(*(torch.tensor(float(v)) for v in center)),
            torch.from_numpy(params), torch.from_numpy(rot), torch.tensor(scale))


def _gallery_sdf_rays(k):
    """Rays from around sdf_gallery_transformed's camera toward its SDF row k."""
    kind, c, params, _mid, rot, scale = list(
        tg.sdf_objects(scene_arrays(compile_scene(tlib.sdf_gallery_transformed(), device="cpu"))))[k]
    rng = np.random.RandomState(41 + k)
    center = np.asarray([float(v) for v in c], np.float32)
    o = (rng.uniform(-1.0, 1.0, (N, 3)) + [0.0, 1.5, -6.0]).astype(np.float32)
    target = (center + rng.uniform(-1.5, 1.5, (N, 3))).astype(np.float32)
    d = ((target - o) * rng.uniform(0.5, 2.0, (N, 1))).astype(np.float32)
    return kind, (_tv(o), _tv(d), c, params, rot, scale)


MARCH_CASES = {**{name: lambda k=k: (k, _random_sdf_rays(k)) for name, k in KINDS.items()},
               **{f"gallery{k}": lambda k=k: _gallery_sdf_rays(k) for k in range(3)}}


@pytest.mark.parametrize("limit", ["at_t", "ulp_below", "ulp_above", "inf"])
@pytest.mark.parametrize("case", list(MARCH_CASES))
def test_sdf_march_cut_at_a_limit_decides_as_the_full_march(case, limit):
    # The kernel stops each SDF march once t_world reaches the limit (the
    # best hit so far, or t_max) times |d|, rounded up. The decision that
    # follows, valid and t < limit, must be the full march's: a hit below
    # the limit at the same t, else "not closer"; and the cut march never
    # evaluates more than the full one. Misses get the limit of the ray's
    # distance to the centre, so the cut falls mid-march.
    kind, (o, d, c, params, rot, scale) = MARCH_CASES[case]()
    args = (o, d, kind, c, params, rot, scale)
    t_full, _p, _n, v_full = tg.sdf_candidate(*args, with_normal=False)
    assert 0.05 < v_full.double().mean().item() < 0.95
    to_centre = torch.sqrt(mag2(o - c) / mag2(d))
    base = torch.where(v_full, t_full, to_centre)
    lim = {"at_t": base, "inf": torch.full_like(base, math.inf),
           "ulp_below": torch.nextafter(base, torch.full_like(base, -math.inf)),
           "ulp_above": torch.nextafter(base, torch.full_like(base, math.inf))}[limit]
    t_cut, _p, _n, v_cut = tg.sdf_candidate(*args, with_normal=False, limit=lim)
    closer_full, closer_cut = v_full & (t_full < lim), v_cut & (t_cut < lim)
    assert torch.equal(closer_cut, closer_full)
    assert torch.equal(t_cut[closer_cut], t_full[closer_full])
    full_steps = tg.sdf_march_steps(*args)
    cut_steps = tg.sdf_march_steps(*args, limit=lim)
    if limit == "inf":
        assert torch.equal(cut_steps, full_steps)
    else:
        assert (cut_steps <= full_steps).all() and cut_steps.sum() < full_steps.sum()


def transformed_scenes():
    """(JAX description, port description) of the turned-and-scaled scene."""
    d = tlib.sdf_gallery_transformed()
    return JScene.from_json(d.to_json()), d


SCENES = {
    "sdf_gallery": lambda: (jlib.sdf_gallery(), tlib.sdf_gallery()),
    "sdf_transformed": transformed_scenes,
}


@pytest.mark.parametrize("name", list(SCENES))
def test_sdf_tables_equal_jax(name):
    jdesc, tdesc = SCENES[name]()
    ours = compile_scene(tdesc, device="cpu")
    theirs = from_numpy_scene(jax.device_get(jcompile(jdesc)), device="cpu")
    assert ours.sdfs.shape == (3, SDF_COLS)
    for field, a, b in zip(ours._fields, ours, theirs):
        assert a.dtype == torch.float32 and a.shape == b.shape, field
        assert torch.equal(a, b), field
    if name == "sdf_transformed":
        assert not torch.equal(ours.sdfs[:2, 9:18], torch.eye(3).reshape(1, 9).expand(2, 9))
        assert ours.sdfs[:2, 18].tolist() == pytest.approx([0.8, 1.25])


W = H = 16
MAX_DEPTH = 8
OFFSETS = (0, 5, 11)
RAY_BAR = 0.95
VARIANTS = [("path", "uniform"), ("path", "sobol"), ("nee", "uniform"), ("nee", "sobol")]


@pytest.fixture(scope="module", params=[
    (scene, mode, sampler) for scene in SCENES for mode, sampler in VARIANTS
], ids=lambda p: "-".join(p))
def chunks(request):
    """[(port chunk, JAX chunk) per offset], seed 19791102."""
    name, mode, sampler = request.param
    jdesc, tdesc = SCENES[name]()
    jscene, tables = jcompile(jdesc), compile_scene(tdesc, device="cpu")
    key = jax.random.key(DEFAULT_SEED)
    before = megakernel.LAUNCHES, megakernel.SDF_LAUNCHES
    out = []
    for off in OFFSETS:
        kw = dict(width=W, height=H, spp_chunk=1, spp_total=16, max_depth=MAX_DEPTH,
                  sampler=sampler, mode=mode)
        j = render_chunk_pallas(jscene, key, np.uint32(off), interpret=True, **kw)
        t = megakernel.render_chunk(tables, key_row(DEFAULT_SEED), off, **kw)
        out.append((t.numpy(), np.asarray(j)))
    # CPU tables run the plain version: no kernel was launched.
    assert (megakernel.LAUNCHES, megakernel.SDF_LAUNCHES) == before
    return out


@pytest.mark.parametrize("i", range(len(OFFSETS)))
def test_sdf_plain_version_matches_pallas_per_ray(chunks, i):
    t, j = chunks[i]
    assert t.shape == j.shape == (H, W, 3)
    assert np.isfinite(t).all() and (t >= 0).all()
    frac, _ = agreement(t, j)
    assert frac >= RAY_BAR, f"only {frac:.2%} of rays agree"


def test_sdf_plain_version_matches_pallas_mean(chunks):
    t = np.stack([c[0] for c in chunks])
    j = np.stack([c[1] for c in chunks])
    _, mean_rel = agreement(t, j)
    assert (mean_rel <= 1e-2).all(), f"channel means differ by {mean_rel}"
    assert t.mean() > 0


def test_sdf_session_renders_the_chunks_on_the_cpu(tmp_path):
    # The session sums render_chunk's chunks of the SDF scene; CPU tables
    # run the plain version and launch nothing.
    opts = RenderOptions(width=12, height=12, samples_aa=4, spp_chunk=2, max_depth=3,
                         device="cpu", output=str(tmp_path / "sdf.png"),
                         integrator="nee", sampler="sobol")
    before = megakernel.LAUNCHES, megakernel.SDF_LAUNCHES
    result = RenderSession(tlib.sdf_gallery(), opts).render()
    assert result.status == RenderStatus.DONE and result.chunks == 2
    assert (megakernel.LAUNCHES, megakernel.SDF_LAUNCHES) == before
    tables = compile_scene(tlib.sdf_gallery(), device="cpu")
    kw = dict(width=12, height=12, spp_chunk=2, spp_total=4, max_depth=3, sampler="sobol",
              mode="nee")
    want = sum(megakernel.render_chunk(tables, key_row(opts.seed), off, **kw) for off in (0, 2)) / 4
    np.testing.assert_allclose(result.image, want.numpy(), rtol=1e-6, atol=1e-7)
    assert read_png(str(tmp_path / "sdf.png")).shape == (12, 12, 3)


def test_cli_renders_sdf_gallery_on_the_cpu(tmp_path):
    out = tmp_path / "cli.png"
    rc = cli_main(["--scene", "sdf-gallery", "--device", "cpu", "--width", "8", "--height", "8",
                   "--spp", "2", "--max-depth", "2", "-o", str(out)])
    assert rc == 0 and read_png(str(out)).shape == (8, 8, 3)


def test_light_table_leaves_sdfs_out_and_clamps_over_all_materials():
    # K1's table holds spheres and planes only (an SDF emitter is found by
    # BSDF sampling alone, MIS weight 1); the clamp base takes the brightest
    # emission over every material, an SDF's included.
    d = tlib.sdf_gallery()
    d.sdfs[1].material = d.add_material(
        type(d.materials[0])(albedo=(0.0, 0.0, 0.0), emissive=(40.0, 30.0, 20.0)))
    host = host_scene_from_description(JScene.from_json(d.to_json()))
    got = lights.light_table(compile_scene(d, device="cpu"))
    want = _light_table(host)
    assert got.rows.shape[0] == len(want) == 1
    assert got.rows[0, lights.COL_PRIM].item() == want[0][3] == 0
    assert got.clamp.item() == np.float32(_host_nee_clamp(host)) == 16.0 * 40.0
