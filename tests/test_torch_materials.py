"""The port's layered BRDF against cornelis_tpu.materials and the oracle.

The same float32 expressions in the same order: values agree to a few
ulps (tolerance ULPS), except where torch's and XLA's sin/cos differ in
the last bits and the gold material's GGX lobe (alpha^2 = 1e-8, D up to
1e3) turns that ulp of a sampled direction into a relative change of up
to ~2e-4 in its pdf and BRDF (tolerance LOBE; tests/test_oracle.py
explains the same effect against the reference binary).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cornelis_tpu import materials as JM
from cornelis_tpu.math.vec import Vec3 as JVec3
from cornelis_tpu.math.vec import construct_basis as jbasis
from cornelis_tpu_torch import materials as TM
from cornelis_tpu_torch.math.vec import Vec3, construct_basis

ORACLE = os.path.join(os.path.dirname(__file__), "golden", "oracle")
ULPS = dict(rtol=1e-5, atol=1e-6)
LOBE = dict(rtol=1e-3, atol=1e-5)


def oracle(name, width):
    return np.fromfile(os.path.join(ORACLE, name + ".f32"), np.float32).reshape(-1, width)


def col(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def tv(a):
    return Vec3(*(col(c) for c in np.asarray(a, np.float32).T))


def jv(a):
    return JVec3(*(jnp.asarray(c) for c in np.asarray(a, np.float32).T))


def close(t, j, tol=ULPS):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **tol)


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _inputs(seed, n=2048):
    """Random directions, including below-horizon wi/wo and the
    roughness extremes of the library (0.01 gold ... 1)."""
    rng = np.random.default_rng(seed)
    nrm, wi, wo = _unit(rng, n), _unit(rng, n), _unit(rng, n)
    wo = np.where((wo * nrm).sum(1, keepdims=True) < 0, -wo, wo)  # viewer above the surface
    rough = rng.choice([0.01, 0.05, 0.2, 0.5, 1.0], size=n).astype(np.float32)
    ior = rng.choice([0.47, 1.5, 2.4], size=n).astype(np.float32)
    albedo, tint = rng.random((2, n, 3), dtype=np.float32)
    x0, x1, x2 = rng.random((3, n), dtype=np.float32)
    return nrm, wi, wo, rough, ior, albedo, tint, x0, x1, x2


def _params(mod, vec, scalar, rough, ior, albedo, tint):
    return mod.MaterialParams(
        albedo=vec(albedo), emission=vec(albedo), tint=vec(tint),
        roughness=scalar(rough), ior=scalar(ior),
    )


@pytest.mark.parametrize("seed", [0, 1])
def test_layered_eval_and_pdfs_match_jax(seed):
    nrm, wi, wo, rough, ior, albedo, tint, *_ = _inputs(seed)
    pt = _params(TM, tv, col, rough, ior, albedo, tint)
    pj = _params(JM, jv, jnp.asarray, rough, ior, albedo, tint)
    for a, b in zip(TM.layered_eval(tv(wi), tv(wo), tv(nrm), pt), JM.layered_eval(jv(wi), jv(wo), jv(nrm), pj)):
        close(a, b)
    close(TM.layered_pdf(tv(wi), tv(wo), tv(nrm), pt), JM.layered_pdf(jv(wi), jv(wo), jv(nrm), pj))
    close(TM.layered_pdf_true(tv(wi), tv(wo), tv(nrm), pt), JM.layered_pdf_true(jv(wi), jv(wo), jv(nrm), pj))


@pytest.mark.parametrize("seed", [2, 3])
def test_layered_sample_matches_jax(seed):
    nrm, _, wo, rough, ior, albedo, tint, x0, x1, x2 = _inputs(seed)
    pt = _params(TM, tv, col, rough, ior, albedo, tint)
    pj = _params(JM, jv, jnp.asarray, rough, ior, albedo, tint)
    wi_t, pdf_t, f_t = TM.layered_sample(tv(wo), col(x0), col(x1), col(x2), construct_basis(tv(nrm)), pt)
    wi_j, pdf_j, f_j = JM.layered_sample(jv(wo), jnp.asarray(x0), jnp.asarray(x1), jnp.asarray(x2), jbasis(jv(nrm)), pj)
    for a, b in zip(wi_t, wi_j):
        close(a, b)
    close(pdf_t, pdf_j, LOBE)
    for a, b in zip(f_t, f_j):
        close(a, b, LOBE)
    # Both layers were drawn; the diffuse layer stays in the upper hemisphere.
    glossy = x2 >= 0.5
    assert 0.3 < glossy.mean() < 0.7
    cos = (wi_t.x * col(nrm[:, 0]) + wi_t.y * col(nrm[:, 1]) + wi_t.z * col(nrm[:, 2])).numpy()
    assert (cos[~glossy] >= -1e-6).all()


def test_microfacet_blocks_match_oracle():
    r = oracle("models", 10)
    c, alpha, tan_i, tan_o, ior = (col(r[:, k]) for k in range(5))
    # The reference binary's values; tolerances as tests/test_oracle.py.
    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(TM.distribution_gtr2(c, alpha).numpy(), r[:, 5], **tol)
    np.testing.assert_allclose(TM.lambda_tr(tan_i, alpha).numpy(), r[:, 7], **tol)
    np.testing.assert_allclose(TM.shadow_masking_tr(tan_i, tan_o, alpha).numpy(), r[:, 8], **tol)
    np.testing.assert_allclose(TM.schlick(c, 1.0, ior).numpy(), r[:, 9], **tol)


def test_oren_nayar_matches_oracle():
    r = oracle("orennayar", 16)
    f = TM.oren_nayar_eval(tv(r[:, 3:6]), tv(r[:, 6:9]), tv(r[:, 10:13]), col(r[:, 9]))
    # acos-free identity against the reference's acos chain, as tests/test_oracle.py.
    for k, comp in enumerate(f):
        np.testing.assert_allclose(comp.numpy(), r[:, 13 + k], rtol=1e-3, atol=1e-4)


def test_glossy_matches_oracle():
    r = oracle("glossy", 27)
    n, wi, wo = tv(r[:, 0:3]), tv(r[:, 3:6]), tv(r[:, 6:9])
    alpha, ior = col(r[:, 9]), col(r[:, 10])
    f = TM.glossy_eval(wi, wo, n, tv(r[:, 11:14]), alpha, ior)
    # Tolerances as tests/test_oracle.py.
    for k in range(2):
        np.testing.assert_allclose(f[k].numpy(), r[:, 14 + k], rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(TM.glossy_pdf(wi, wo, n, alpha).numpy(), r[:, 17], rtol=2e-3, atol=1e-4)
    s = TM.glossy_sample(wo, col(r[:, 18]), col(r[:, 19]), construct_basis(n), alpha)
    for k in range(3):
        np.testing.assert_allclose(s[k].numpy(), r[:, 20 + k], rtol=1e-3, atol=5e-4)


def test_layered_matches_oracle():
    r = oracle("layered", 31)
    n, wi, wo = tv(r[:, 0:3]), tv(r[:, 3:6]), tv(r[:, 6:9])
    params = TM.MaterialParams(
        albedo=tv(r[:, 11:14]), emission=tv(r[:, 11:14]), tint=tv(r[:, 14:17]),
        roughness=col(r[:, 9]), ior=col(r[:, 10]),
    )
    f = TM.layered_eval(wi, wo, n, params)
    # Tolerances as tests/test_oracle.py, which explains the 8e-3 on the
    # sampled pdf (GGX D of 1e2..1e3 at alpha ~ 1e-2).
    for k in range(3):
        np.testing.assert_allclose(f[k].numpy(), r[:, 17 + k], rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(TM.layered_pdf(wi, wo, n, params).numpy(), r[:, 20], rtol=2e-3, atol=1e-4)
    wi_s, pdf_s, f_s = TM.layered_sample(wo, col(r[:, 21]), col(r[:, 22]), col(r[:, 23]), construct_basis(n), params)
    for k in range(3):
        np.testing.assert_allclose(wi_s[k].numpy(), r[:, 24 + k], rtol=1e-3, atol=5e-4)
    np.testing.assert_allclose(pdf_s.numpy(), r[:, 27], rtol=8e-3, atol=1e-4)
    np.testing.assert_allclose(f_s.x.numpy(), r[:, 28], rtol=8e-3, atol=2e-4)


def test_gather_materials_rows():
    table = torch.arange(3 * 11, dtype=torch.float32).view(3, 11)
    p = TM.gather_material_rows(table, torch.tensor([2, 0]))
    assert p.albedo.x.tolist() == [22.0, 0.0]
    assert p.emission.z.tolist() == [27.0, 5.0]
    assert p.ior.tolist() == [32.0, 10.0]
