"""The port's differentiable mode on its own, and its inverse renderer
against cornelis_tpu's.

- Finite differences, as tests/test_diff.py TestFiniteDifference and
  TestNeeGradients (24x24, 24 spp, max_depth 4, key 5, the same eps and
  tolerances): the same key on both sides of the difference, so the
  render is a deterministic function of the scene and the difference
  sees no Monte Carlo noise. Roughness moves the sampled directions, so
  only the attached estimator (detach=False) matches its difference.
- Gradients finite and reaching every material field; at equal spp the
  NEE albedo gradient varies less over keys than path mode's.
- The loss weight: corrupting zero-weight pixels leaves the loss as it
  was, to the bit (tests/test_diff.py TestLossWeight).
- inverse.py against the JAX package's on sphere_on_plane (16x16, 4 spp,
  max_depth 3): params round-trip through the domain transforms, an
  unknown field is refused, make_loss gives JAX's value (within 1%) for
  every key strategy, and after three InverseRenderer steps (Adam, lr
  0.1, "dual", seed 3) the visible materials' params are within 1e-3 of
  JAX's (torch.optim.Adam's update is optax.adam's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cornelis_tpu import diff as jdiff
from cornelis_tpu.math.vec import Vec3 as JVec3
from cornelis_tpu.scene import library as jlib
from cornelis_tpu.scene.compile import compile_scene as jcompile
from cornelis_tpu_torch.diff import (
    OPTIMIZABLE_FIELDS,
    InverseRenderer,
    apply_params,
    extract_params,
    make_loss,
    params_from_numpy,
    params_to_numpy,
    render_diff,
)
from cornelis_tpu_torch.math.vec import Vec3
from cornelis_tpu_torch.rng import fold_in, make_key
from test_torch_wavefront import one_torch_thread  # noqa: F401 (a fixture)

from cornelis_tpu_torch.scene.compile import compile_scene, from_numpy_scene, scene_arrays
from cornelis_tpu_torch.scene.library import cornell_box, sphere_on_plane

W = H = 24
SPP = 24
DEPTH = 4
FD_FIELDS = ("mat_albedo", "mat_emission", "mat_tint", "mat_roughness", "sphere_center",
             "sphere_radius", "plane_point")


@pytest.fixture(scope="module")
def scene():
    return scene_arrays(compile_scene(cornell_box(), device="cpu"))


def _mean(scene, key, detach=True, mode="path"):
    return render_diff(scene, key, width=W, height=H, spp=SPP, max_depth=DEPTH, detach=detach,
                       mode=mode).mean()


def _leaves(scene, fields=FD_FIELDS):
    out = {}
    for f in fields:
        v = getattr(scene, f)
        leaf = lambda t: t.detach().clone().requires_grad_(True)
        out[f] = Vec3(*(leaf(c) for c in v)) if isinstance(v, Vec3) else leaf(v)
    return out


def _grads(scene, key, detach=True, mode="path"):
    leaves = _leaves(scene)
    _mean(scene._replace(**leaves), key, detach, mode).backward()
    return {f: Vec3(*(c.grad for c in v)) if isinstance(v, Vec3) else v.grad
            for f, v in leaves.items()}


def check_field(scene, field, component, index, eps, rtol, atol=2e-4, detach=True, mode="path",
                key=5):
    key = make_key(key)

    def perturbed(delta):
        value = getattr(scene, field)
        bump = lambda t: t + delta * (torch.arange(t.shape[0]) == index)
        if component is None:
            new = bump(value)
        else:
            new = value._replace(**{component: bump(getattr(value, component))})
        return scene._replace(**{field: new})

    g = _grads(scene, key, detach, mode)[field]
    g = float((g if component is None else getattr(g, component))[index])
    with torch.no_grad():
        fd = (float(_mean(perturbed(eps), key, detach, mode))
              - float(_mean(perturbed(-eps), key, detach, mode))) / (2 * eps)
    assert np.isfinite(g), field
    np.testing.assert_allclose(g, fd, rtol=rtol, atol=atol)


def _light(scene):
    return int(torch.argmax(scene.mat_emission.x))


class TestFiniteDifference:
    def test_albedo_gradient(self, scene):
        check_field(scene, "mat_albedo", "x", 1, eps=1e-2, rtol=0.05)

    def test_emission_gradient(self, scene):
        check_field(scene, "mat_emission", "x", _light(scene), eps=1e-2, rtol=0.05)

    def test_roughness_gradient(self, scene):
        check_field(scene, "mat_roughness", None, 1, eps=2e-4, rtol=0.05, atol=5e-4,
                    detach=False)

    def test_sphere_radius_gradient(self, scene):
        check_field(scene, "sphere_radius", None, 0, eps=1e-3, rtol=0.25, atol=2e-3)


class TestNeeGradients:
    def test_albedo_fd(self, scene):
        check_field(scene, "mat_albedo", "x", 1, eps=1e-2, rtol=0.05, mode="nee")

    def test_emission_fd(self, scene):
        check_field(scene, "mat_emission", "x", _light(scene), eps=1e-2, rtol=0.05, mode="nee")

    def test_roughness_fd_attached(self, scene):
        # Key 6, not JAX's 5: at key 5 the port's rounding puts a
        # discontinuity (an RR kill or a below-horizon flip moved by the
        # roughness) inside the 2e-4 window: one-sided differences -1.79e-3
        # and +0.89e-3 against a gradient of -1.81e-3, to which the central
        # difference converges at eps 5e-5 (-1.79e-3, measured on the CPU).
        check_field(scene, "mat_roughness", None, 1, eps=2e-4, rtol=0.05, atol=5e-4,
                    detach=False, mode="nee", key=6)

    @pytest.mark.parametrize("mode", ["path", "nee"])
    def test_grads_flow_and_finite(self, scene, mode):
        grads = _grads(scene, make_key(1), mode=mode)
        assert float(grads["mat_albedo"].x.abs().sum()) > 0
        assert float(grads["mat_emission"].x.abs().sum()) > 0
        assert float(grads["mat_roughness"].abs().sum()) > 0
        for f, g in grads.items():
            for leaf in (g if isinstance(g, Vec3) else (g,)):
                assert bool(torch.isfinite(leaf).all()), f

    def test_nee_gradient_variance_below_path(self, scene):
        def samples(mode):
            return np.asarray([float(_grads(scene, make_key(100 + s), mode=mode)["mat_albedo"].x[1])
                               for s in range(6)])

        v_path, v_nee = samples("path").var(), samples("nee").var()
        assert v_nee < v_path / 2.0, (v_path, v_nee)


def test_loss_weight_masks_corrupted_pixels():
    scene = scene_arrays(compile_scene(sphere_on_plane(), device="cpu"))
    key = make_key(5)
    with torch.no_grad():
        target = render_diff(scene, key, width=16, height=16, spp=4, max_depth=3)
    corrupted = target.clone()
    corrupted[:4, :4] = 100.0
    weight = torch.ones((16, 16))
    weight[:4, :4] = 0.0
    params = extract_params(scene, ("mat_albedo",))
    kw = dict(width=16, height=16, spp=4, max_depth=3, key_strategy="fixed")
    with torch.no_grad():
        lc = float(make_loss(scene, target, weight=weight, **kw)(params, key))
        ld = float(make_loss(scene, corrupted, weight=weight, **kw)(params, key))
        plain = float(make_loss(scene, corrupted, **kw)(params, key))
    assert lc == ld, (lc, ld)
    assert plain > ld + 1.0


def test_extract_apply_roundtrip():
    scene = scene_arrays(compile_scene(cornell_box(), device="cpu"))
    params = extract_params(scene, ("mat_albedo", "mat_roughness", "sphere_center"))
    assert all(leaf.requires_grad and leaf.is_leaf for leaf in params["mat_albedo"])
    back = apply_params(scene, params)
    np.testing.assert_allclose(back.mat_albedo.x.detach().numpy(), scene.mat_albedo.x.numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(back.mat_roughness.detach().numpy(),
                               scene.mat_roughness.numpy(), atol=1e-5)
    assert torch.equal(back.sphere_center.x.detach(), scene.sphere_center.x)


def test_rejects_unknown_field():
    scene = scene_arrays(compile_scene(cornell_box(), device="cpu"))
    with pytest.raises(ValueError, match="not optimizable"):
        extract_params(scene, ("mat_ior",))
    assert "mat_ior" not in OPTIMIZABLE_FIELDS


INV = dict(width=16, height=16, spp=4, max_depth=3)


@pytest.fixture(scope="module")
def inverse_case():
    """sphere_on_plane, its JAX target at 16 spp, and the corrupted albedo
    scene, in both packages."""
    true_scene = jcompile(jlib.sphere_on_plane())
    target = np.asarray(jdiff.render_diff(true_scene, jax.random.key(9), **dict(INV, spp=16)))
    corrupted = true_scene._replace(mat_albedo=JVec3(
        true_scene.mat_albedo.x * 0.3 + 0.1,
        true_scene.mat_albedo.y * 0.5 + 0.3,
        true_scene.mat_albedo.z * 0.2 + 0.5,
    ))
    tscene = scene_arrays(from_numpy_scene(jax.device_get(corrupted), device="cpu"))
    return corrupted, tscene, target


def test_params_carry_across(inverse_case):
    jscene, tscene, _ = inverse_case
    fields = ("mat_albedo", "mat_roughness", "sphere_center")
    jparams = jax.device_get(jdiff.extract_params(jscene, fields))
    ours = params_to_numpy(extract_params(tscene, fields))
    carried = params_from_numpy(jparams, device="cpu")
    for f in fields:
        for a, b, c in zip(*(v if isinstance(v, tuple) else (v,) for v in
                             (ours[f], jparams[f], params_to_numpy(carried)[f]))):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-6)
            np.testing.assert_array_equal(c, np.asarray(b))


@pytest.mark.parametrize("strategy", ["dual", "per_step", "fixed"])
def test_make_loss_matches_jax(inverse_case, strategy):
    jscene, tscene, target = inverse_case
    jloss = jdiff.make_loss(jscene, jnp.asarray(target), key_strategy=strategy, **INV)
    jparams = jdiff.extract_params(jscene, ("mat_albedo",))
    want = float(jloss(jparams, jax.random.fold_in(jax.random.key(3), 1)))
    loss = make_loss(tscene, torch.tensor(target), key_strategy=strategy, **INV)
    with torch.no_grad():
        got = float(loss(extract_params(tscene, ("mat_albedo",)), fold_in(make_key(3), 1)))
    assert got == pytest.approx(want, rel=0.01)


def test_inverse_renderer_steps_match_jax(inverse_case):
    jscene, tscene, target = inverse_case
    kw = dict(fields=("mat_albedo",), learning_rate=0.1, seed=3, key_strategy="dual", **INV)
    jinv = jdiff.InverseRenderer(jscene, target, **kw)
    inv = InverseRenderer(tscene, torch.tensor(target), **kw)
    jl = [jinv.step() for _ in range(3)]
    tl = [inv.step() for _ in range(3)]
    np.testing.assert_allclose(tl, jl, rtol=0.01)
    want = jax.device_get(jinv.state.params["mat_albedo"])
    got = params_to_numpy(inv.params)["mat_albedo"]
    visible = slice(1, 3)  # the sphere's and the plane's; 3 is the light
    for a, b in zip(got, want):
        np.testing.assert_allclose(a[visible], np.asarray(b)[visible], atol=1e-3)
    assert inv.step_count == 3
    rec = inv.scene()
    assert not rec.mat_albedo.x.requires_grad
