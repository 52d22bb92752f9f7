"""The last public helpers of the JAX package in the port: `rng.ray_keys`,
`materials.distribution_gtr3p2`, `camera.default_camera`, `look_at` and
`horizontal_fov_35mm`, the `math.vec` constructors and converters, and
the package's exports.

Bars: ray keys bit for bit; GTR3p2 within float32 rounding of JAX's
(rtol 2e-6: torch's and XLA's pow may differ in the last ulps) and
against the reference's own dumps at tests/test_oracle.py's tolerance;
the tensor look_at within float32 rounding of JAX's (torch's and XLA's
sin may differ by an ulp); the rest exact.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cornelis_tpu
import cornelis_tpu_torch
from cornelis_tpu import camera as jcamera
from cornelis_tpu import materials as jmaterials
from cornelis_tpu import rng as jrng
from cornelis_tpu.math import vec as jvec
from cornelis_tpu_torch import camera, materials, rng
from cornelis_tpu_torch.math import vec

ORACLE = os.path.join(os.path.dirname(__file__), "golden", "oracle", "models.f32")


def _np(v):
    return np.asarray([np.asarray(c) for c in v])


@pytest.mark.parametrize("seed", [0, 7, rng.DEFAULT_SEED])
def test_ray_keys_bitwise(seed):
    ids = np.random.default_rng(seed).integers(0, 2**32, 257, dtype=np.uint64).astype(np.uint32)
    ids[:3] = [0, 1, 2**32 - 1]
    want = np.asarray(jax.random.key_data(jrng.ray_keys(jrng.make_key(seed), jnp.asarray(ids))))
    got = rng.ray_keys(rng.make_key(seed), torch.from_numpy(ids.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


class TestGtr3p2:
    def test_matches_jax(self):
        rng_ = np.random.default_rng(3)
        c = rng_.uniform(-1, 1, 4096).astype(np.float32)
        a = rng_.uniform(0, 1, 4096).astype(np.float32)
        c[:4], a[:4] = [1.0, 0.0, 1.0, 0.5], [0.5, 0.5, 1e-3, 0.0]
        got = materials.distribution_gtr3p2(torch.from_numpy(c), torch.from_numpy(a)).numpy()
        want = np.asarray(jmaterials.distribution_gtr3p2(jnp.asarray(c), jnp.asarray(a)))
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=0)

    def test_against_the_reference_oracle(self):
        r = np.fromfile(ORACLE, np.float32).reshape(-1, 10)
        got = materials.distribution_gtr3p2(torch.from_numpy(r[:, 0]),
                                            torch.from_numpy(r[:, 1])).numpy()
        ok = np.isclose(got, r[:, 6], atol=1e-5, rtol=1e-4) | (np.isnan(got) & np.isnan(r[:, 6]))
        assert ok.all(), f"worst |diff| {np.nanmax(np.abs(got - r[:, 6])):.3e}"

    def test_closed_form_and_guard(self):
        a, c = 0.5, 0.8
        expected = ((a * a + a) / (2 * np.pi)) / (1 + (a * a - 1) * c * c) ** 1.5
        got = materials.distribution_gtr3p2(torch.tensor(c), torch.tensor(a))
        assert float(got) == pytest.approx(expected, rel=1e-5)
        # alpha^2 almost zero -> 1.0 (Materials.cpp:7-8).
        assert float(materials.distribution_gtr3p2(torch.tensor(0.5), torch.tensor(1e-3))) == 1.0

    def test_gradient_finite_at_the_peak(self):
        a = torch.tensor(0.3, requires_grad=True)
        materials.distribution_gtr3p2(torch.tensor(1.0), a).backward()
        assert torch.isfinite(a.grad)


class TestCamera:
    def test_default_camera_equals_jax(self):
        np.testing.assert_array_equal(_np(camera.default_camera()),
                                      _np(jcamera.default_camera()))
        assert all(c.dtype == torch.float32 for v in camera.default_camera() for c in v)

    @pytest.mark.parametrize("origin,target,aspect,fov", [
        ((278.0, 273.0, -800.0), (278.0, 273.0, 0.0), 1.0, 0.6911),
        ((1.0, 2.0, 3.0), (0.0, 0.5, 10.0), 1.3, 0.9),
        ((0.0, 5.0, -5.0), (0.1, 0.0, 0.0), 0.75, 1.2),
    ])
    def test_look_at_matches_jax_and_the_host_form(self, origin, target, aspect, fov):
        ours = _np(camera.look_at(origin, target, aspect, fov))
        np.testing.assert_allclose(ours, _np(jcamera.look_at(origin, target, aspect, fov)),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(ours, _np(camera.look_at_host(origin, target, aspect, fov)),
                                   rtol=1e-6, atol=1e-6)

    def test_look_at_is_differentiable(self):
        origin = vec.Vec3(*(torch.tensor(v, requires_grad=True) for v in (1.0, 2.0, 3.0)))
        cam = camera.look_at(origin, (0.0, 0.0, 10.0), 1.0, 0.8)
        (cam.corner.x + cam.u.y + cam.v.z).backward()
        assert all(torch.isfinite(c.grad) for c in origin) and all(c.grad != 0 for c in origin)

    @pytest.mark.parametrize("focal", [18.0, 35.0, 50.0, 200.0])
    def test_horizontal_fov_35mm(self, focal):
        assert camera.horizontal_fov_35mm(focal) == jcamera.horizontal_fov_35mm(focal)
        assert camera.horizontal_fov_35mm(focal) == pytest.approx(2 * math.atan(18.0 / focal))

    @pytest.mark.parametrize("focal", [0.0, -1.0])
    def test_horizontal_fov_35mm_rejects(self, focal):
        with pytest.raises(ValueError):
            camera.horizontal_fov_35mm(focal)


class TestVec:
    def test_vec3_promotes_floats(self):
        v = vec.vec3(1.0, 2, torch.tensor(3.5))
        assert all(c.dtype == torch.float32 and c.shape == () for c in v)
        np.testing.assert_array_equal(_np(v), _np(jvec.vec3(1.0, 2, 3.5)))

    def test_array_roundtrip(self):
        a = np.random.default_rng(0).normal(size=(5, 7, 3)).astype(np.float32)
        v = vec.from_array(torch.from_numpy(a))
        np.testing.assert_array_equal(_np(v), _np(jvec.from_array(jnp.asarray(a))))
        np.testing.assert_array_equal(vec.to_array(v).numpy(), a)

    def test_full_like_and_broadcast_to(self):
        v = vec.vec3(1.0, 2.0, 3.0)
        b = vec.broadcast_to(v, (4, 2))
        np.testing.assert_array_equal(_np(b), _np(jvec.broadcast_to(jvec.vec3(1.0, 2.0, 3.0),
                                                                    (4, 2))))
        f = vec.full_like(b, 0.25)
        assert all(c.shape == (4, 2) and bool((c == 0.25).all()) for c in f)

    def test_clamp_matches_jax_with_ties(self):
        x = torch.tensor([-1.0, 0.0, 0.5, 1.0, 2.0], requires_grad=True)
        c = vec.clamp(vec.Vec3(x, x * 2, x - 1), 0.0, 1.0)
        want = jvec.clamp(jvec.Vec3(*(jnp.asarray(a) for a in
                                      (x.detach().numpy(), 2 * x.detach().numpy(),
                                       x.detach().numpy() - 1))), 0.0, 1.0)
        np.testing.assert_array_equal(_np(tuple(t.detach() for t in c)), _np(want))
        c.x.sum().backward()
        jgrad = jax.grad(lambda a: jnp.clip(a, 0.0, 1.0).sum())(jnp.asarray(x.detach().numpy()))
        np.testing.assert_array_equal(x.grad.numpy(), np.asarray(jgrad))


def test_exports_cover_the_jax_package():
    assert set(cornelis_tpu.__all__) <= set(cornelis_tpu_torch.__all__)
    for name in cornelis_tpu_torch.__all__:
        assert hasattr(cornelis_tpu_torch, name), name
