"""The port's 4x4 transform algebra (cornelis_tpu_torch/math/linalg.py)
against the JAX package's (tests/test_linalg.py): the host builders bit
for bit, the tensor transforms against numpy and JAX, `decompose_trs`,
and an SDF placed under a composed TRS that compiles to the same tables
and renders the same through both packages' wavefronts.

Bars: builders and compiled tables equal; the einsum transforms within
float32 rounding (rtol 1e-5, atol 1e-6); the render at the wavefront
bars of tests/test_torch_wavefront.py (at least 99% of pixels within
rtol = atol = 1e-4, channel means within 1%).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cornelis_tpu import integrator as jint
from cornelis_tpu.math import linalg as jlg
from cornelis_tpu.rng import make_key as jmake_key
from cornelis_tpu.scene import compile as jcompile
from cornelis_tpu.scene import description as jdesc
from cornelis_tpu_torch import integrator as tint
from cornelis_tpu_torch.math import linalg as lg
from cornelis_tpu_torch.rng import make_key
from cornelis_tpu_torch.scene import description as tdesc
from cornelis_tpu_torch.scene.compile import compile_scene, scene_arrays

BUILDERS = [
    ("identity", ()),
    ("scaling", (2.5,)),
    ("translation", ((1.0, -2.0, 3.5),)),
    ("rotation_x", (0.7,)),
    ("rotation_y", (-1.2,)),
    ("rotation_z", (2.5,)),
    ("rotation_axis_angle", ((1.0, 2.0, 3.0), 0.9)),
]


@pytest.mark.parametrize("name,args", BUILDERS, ids=[b[0] for b in BUILDERS])
def test_builders_equal_jax(name, args):
    ours, theirs = getattr(lg, name)(*args), getattr(jlg, name)(*args)
    assert ours.dtype == theirs.dtype == np.float32
    np.testing.assert_array_equal(ours, theirs)


def test_compose_equals_jax():
    ms = [lg.translation((1, 2, 3)), lg.rotation_axis_angle((0, 1, 1), 0.3), lg.scaling(1.5)]
    np.testing.assert_array_equal(lg.compose(*ms), jlg.compose(*ms))


def test_compose_order():
    # compose(T, R): R applied first, then T.
    m = lg.compose(lg.translation((1, 0, 0)), lg.rotation_z(np.pi / 2))
    p = lg.transform_point(m, torch.tensor([1.0, 0.0, 0.0]))
    np.testing.assert_allclose(p.numpy(), [1.0, 1.0, 0.0], atol=1e-6)


def test_rotations_orthonormal():
    for m in (lg.rotation_x(0.7), lg.rotation_y(-1.2), lg.rotation_z(2.5),
              lg.rotation_axis_angle((1, 2, 3), 0.9)):
        r = m[:3, :3]
        np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-6)
        assert np.linalg.det(r) == pytest.approx(1.0, abs=1e-6)


def test_zero_axis_rejected():
    with pytest.raises(ValueError):
        lg.rotation_axis_angle((0, 0, 0), 1.0)


@pytest.mark.parametrize("batch", [(), (128,), (4, 5)])
def test_matrix_multiply_matches_numpy_and_jax(batch):
    rng = np.random.default_rng(len(batch))
    a = rng.normal(size=(4, 4)).astype(np.float32)
    x = rng.normal(size=(*batch, 4)).astype(np.float32)
    got = lg.matrix_multiply(a, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (*batch, 4)
    np.testing.assert_allclose(got.numpy(), x @ a.T, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(jlg.matrix_multiply(a, x)), rtol=1e-5,
                               atol=1e-6)


def test_transforms_match_jax():
    rng = np.random.default_rng(7)
    m = lg.compose(lg.translation((0.5, -1, 2)), lg.rotation_axis_angle((1, 1, 0), 0.6),
                   lg.scaling(1.7))
    v = rng.normal(size=(64, 3)).astype(np.float32)
    for name in ("transform_point", "transform_vector", "transform_normal"):
        got = getattr(lg, name)(m, torch.from_numpy(v)).numpy()
        want = np.asarray(getattr(jlg, name)(m, jnp.asarray(v)))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=name)


def test_transform_normal_inverse_transpose():
    m = lg.compose(lg.rotation_y(0.8), lg.scaling(2.0))
    n = lg.transform_normal(m, torch.tensor([0.0, 0.0, 1.0])).numpy()
    expect = m[:3, :3] @ np.array([0, 0, 1.0]) / 2.0**2
    np.testing.assert_allclose(n / np.linalg.norm(n), expect / np.linalg.norm(expect), atol=1e-5)


def test_transform_rays():
    m = lg.compose(lg.translation((0, 5, 0)), lg.rotation_z(np.pi / 2))
    o = torch.tensor([[1.0, 0.0, 0.0], [0.0, 0.0, 0.0]])
    d = torch.tensor([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0]])
    o2, d2 = lg.transform_rays(m, o, d)
    np.testing.assert_allclose(o2.numpy(), [[0, 6, 0], [0, 5, 0]], atol=1e-6)
    np.testing.assert_allclose(d2.numpy(), [[0, 0, 1], [0, 1, 0]], atol=1e-6)


def test_tensor_matrix_on_the_points_device():
    m = torch.from_numpy(lg.translation((1.0, 2.0, 3.0)))
    p = lg.transform_point(m, torch.zeros(2, 3))
    np.testing.assert_array_equal(p.numpy(), [[1, 2, 3], [1, 2, 3]])


def test_decompose_trs_equals_jax():
    m = lg.compose(lg.translation((1, 2, 3)), lg.rotation_x(0.4), lg.scaling(2.5))
    r, t, s = lg.decompose_trs(m)
    jr, jt, js = jlg.decompose_trs(m)
    assert s == js == pytest.approx(2.5, rel=1e-5)
    np.testing.assert_array_equal(r, jr)
    np.testing.assert_array_equal(t, jt)
    np.testing.assert_allclose(r, lg.rotation_x(0.4)[:3, :3], atol=1e-5)


@pytest.mark.parametrize("kind", ["nonuniform", "shear", "projective", "shape", "mirror"])
def test_decompose_rejects_what_jax_rejects(kind):
    bad = np.eye(4, dtype=np.float32)
    if kind == "nonuniform":
        bad[0, 0] = 2.0
    elif kind == "shear":
        bad[0, 1] = 0.5
    elif kind == "projective":
        bad[3, 0] = 0.1
    elif kind == "mirror":
        bad[0, 0] = -1.0
    else:
        bad = bad[:3]
    with pytest.raises(ValueError):
        jlg.decompose_trs(bad)
    with pytest.raises(ValueError):
        lg.decompose_trs(bad)


def test_transformed_sphere_equals_moved_sphere():
    # Translation and uniform scale are exact float ops: the compiled
    # tables of the transformed sphere equal the moved one's.
    m = lg.compose(lg.translation((20.0, -8.0, 4.0)), lg.scaling(2.0))
    a, b = tdesc.SceneDescription(), tdesc.SceneDescription()
    a.add_sphere(tdesc.SphereDescription(center=(1.0, 2.0, 50.0), radius=3.0,
                                         transform=m.tolist()))
    b.add_sphere(tdesc.SphereDescription(center=(22.0, -4.0, 104.0), radius=6.0))
    assert torch.equal(compile_scene(a, device="cpu").spheres,
                       compile_scene(b, device="cpu").spheres)


def _glowing_box(desc, linalg):
    """tests/test_linalg.py's oriented box: a glowing unit box turned 45
    degrees about z and scaled 1.5, seen from z = -10."""
    scene = desc.SceneDescription()
    scene.set_camera(desc.PerspectiveCameraDescription(origin=(0.0, 0.0, -10.0),
                                                       look_at=(0.0, 0.0, 0.0), aspect=1.0))
    glow = scene.add_material(desc.MaterialDescription(emissive=(5.0, 5.0, 5.0)))
    m = linalg.compose(linalg.rotation_z(np.pi / 4), linalg.scaling(1.5))
    scene.add_sdf(desc.SDFDescription(kind="box", params=(1.0, 1.0, 1.0, 0.0), material=glow,
                                      transform=m.tolist()))
    return scene


def test_sdf_under_a_trs_renders_as_in_jax():
    ours = scene_arrays(compile_scene(_glowing_box(tdesc, lg), device="cpu"))
    theirs = jcompile.compile_scene(_glowing_box(jdesc, jlg))
    np.testing.assert_array_equal(ours.sdf_rot.numpy(), np.asarray(theirs.sdf_rot))
    np.testing.assert_array_equal(ours.sdf_scale.numpy(), np.asarray(theirs.sdf_scale))
    kw = dict(width=24, height=24, spp_chunk=4, spp_total=4, max_depth=2)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = tint.render_chunk(ours, make_key(1), 0, **kw).numpy() / 4
    finally:
        torch.set_num_threads(threads)
    want = np.asarray(jint.render_chunk(theirs, jmake_key(1), jnp.uint32(0), **kw)) / 4
    assert np.isfinite(got).all() and got.max() > 1.0  # the glowing box is visible
    ok = np.isclose(got, want, rtol=1e-4, atol=1e-4).all(-1)
    assert ok.mean() >= 0.99, f"only {ok.mean():.2%} of pixels agree"
    rel = np.abs(got.mean((0, 1)) - want.mean((0, 1))) / want.mean((0, 1))
    assert (rel <= 1e-2).all(), f"channel means differ by {rel}"
