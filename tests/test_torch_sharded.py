"""The port's sharded inverse-render step against cornelis_tpu's.

diff.make_sharded_train_step on the (1, 1) mesh of one process against
cornelis_tpu.diff.sharded.make_sharded_train_step on the conftest's
8-device CPU mesh as (4, 2): Cornell 24x24, 8 spp, max_depth 4, albedo
and roughness from a corrupted start toward the true scene's render, one
Adam step (lr 0.05) with key 3, in modes path and nee. The draws are
shared (rng.py), so the bars are those of
tests/test_torch_inverse.py::test_inverse_renderer_steps_match_jax: the
loss within 1% and the new params within 1e-3, with the knife-edge masks
of tests/test_torch_diff.py (ROADMAP §C). Each step's loss must first be
the dual loss of its own package's two renders (rtol 1e-5); then the
pixels whose radiance differs between the packages in either render are
masked out of both losses, which must agree within 1% (in mode nee the
unmasked losses are 5.5% apart at this key: Cornell's float32 NEE knife
edge). The light's albedo row rides on the min_hit_t guard (its gradient
comes from rays that re-hit the light) and is left out of the params'
bar. The process-group side of the port's step is
tests/test_torch_multiprocess_sharded.py's.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from cornelis_tpu import diff as jdiff
from cornelis_tpu.diff.sharded import make_sharded_train_step as jax_step
from cornelis_tpu.math.vec import Vec3 as JVec3
from cornelis_tpu.parallel import make_mesh as jax_mesh
from cornelis_tpu.scene import library as jlib
from cornelis_tpu.scene.compile import compile_scene as jcompile
from cornelis_tpu_torch.diff import (
    make_sharded_train_step,
    params_from_numpy,
    params_to_numpy,
    render_diff,
)
from cornelis_tpu_torch.diff.inverse import _leaves
from cornelis_tpu_torch.parallel import make_mesh
from cornelis_tpu_torch.rng import make_key, split
from cornelis_tpu_torch.scene.compile import from_numpy_scene, scene_arrays

CASE = dict(width=24, height=24, spp=8, max_depth=4)
FIELDS = ("mat_albedo", "mat_roughness")
LR = 0.05


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def dual_loss(a, b, target, keep=None):
    """mean((A - t)(B - t)) over the pixels `keep` (all by default)."""
    prod = ((a - target) * (b - target)).astype(np.float64)
    return float(prod.mean() if keep is None else prod[keep].mean())


@pytest.mark.parametrize("mode", ["path", "nee"])
def test_sharded_step_matches_jax(mode):
    true_scene = jcompile(jlib.cornell_box())
    target = np.asarray(jdiff.render_diff(true_scene, jax.random.key(9), mode=mode, **CASE))
    corrupted = true_scene._replace(
        mat_albedo=JVec3(*(c * 0.6 + 0.2 for c in true_scene.mat_albedo)),
        mat_roughness=true_scene.mat_roughness * 0.5 + 0.25,
    )
    jparams = jdiff.extract_params(corrupted, FIELDS)
    optimizer = optax.adam(LR)
    step = jax_step(corrupted, target, jax_mesh((4, 2)), optimizer, mode=mode, **CASE)
    jnew, _, jloss = step(jparams, optimizer.init(jparams), jax.random.key(3))

    scene = scene_arrays(from_numpy_scene(jax.device_get(corrupted), device="cpu"))
    params = params_from_numpy(jax.device_get(jparams), device="cpu")
    ours = make_sharded_train_step(scene, torch.tensor(target), make_mesh((1, 1)),
                                   torch.optim.Adam(list(_leaves(params)), lr=LR), mode=mode,
                                   **CASE)
    loss = ours(params, make_key(3))

    # The step's loss is the dual loss of the two renders on either side.
    tkeys, jkeys = split(make_key(3)), jax.random.split(jax.random.key(3))
    with torch.no_grad():
        ours_ab = [render_diff(scene_arrays(from_numpy_scene(jax.device_get(corrupted),
                                                             device="cpu")), k, mode=mode,
                               **CASE).numpy() for k in tkeys]
    theirs_ab = [np.asarray(jdiff.render_diff(corrupted, k, mode=mode, **CASE)) for k in jkeys]
    np.testing.assert_allclose(float(loss), dual_loss(*ours_ab, target), rtol=1e-5)
    np.testing.assert_allclose(float(jloss), dual_loss(*theirs_ab, target), rtol=1e-5)
    # Knife edges (ROADMAP §C; tests/test_torch_diff.py): pixels whose
    # radiance differs between the packages leave both losses.
    agree = np.ones(target.shape[:2], bool)
    for a, b in zip(ours_ab, theirs_ab):
        agree &= np.isclose(a, b, rtol=1e-4, atol=1e-4).all(axis=-1)
    np.testing.assert_allclose(dual_loss(*ours_ab, target, agree),
                               dual_loss(*theirs_ab, target, agree), rtol=0.01)
    light = int(np.argmax(np.asarray(true_scene.mat_emission.x)))
    keep = np.arange(len(np.asarray(true_scene.mat_roughness))) != light
    got, want = params_to_numpy(params), jax.device_get(jnew)
    for a, b in zip(got["mat_albedo"], want["mat_albedo"]):
        np.testing.assert_allclose(a[keep], np.asarray(b)[keep], atol=1e-3)
    np.testing.assert_allclose(got["mat_roughness"], np.asarray(want["mat_roughness"]),
                               atol=1e-3)
    # The step moved every param it reached.
    start = jax.device_get(jparams)
    assert np.abs(got["mat_roughness"] - np.asarray(start["mat_roughness"])).max() > LR / 2
