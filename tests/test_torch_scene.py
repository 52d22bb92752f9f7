"""Scene descriptions, library and compiled tables of the port against
cornelis_tpu. Compilation is host numpy float32 in both packages, so the
tables must be bitwise equal.
"""

import jax
import numpy as np
import pytest
import torch

from cornelis_tpu.ops.pallas_dynamic import _scene_tables
from cornelis_tpu.scene import library as jlib
from cornelis_tpu.scene.compile import compile_scene as jcompile
from cornelis_tpu.scene.description import SceneDescription as JScene
from cornelis_tpu_torch.scene import library as tlib
from cornelis_tpu_torch.scene.compile import compile_scene, from_numpy_scene
from cornelis_tpu_torch.scene.description import (
    SceneDescription,
    SDFDescription,
    SphereDescription,
)

# Every builtin, SDF scenes included (tests/test_torch_sdf.py holds the
# SDF table's columns to the JAX package's arrays).
ANALYTIC = list(tlib.BUILTIN_SCENES)


def test_same_builtin_scenes():
    assert tlib.BUILTIN_SCENES.keys() == jlib.BUILTIN_SCENES.keys()


@pytest.mark.parametrize("name", ANALYTIC)
def test_tables_equal_jax_compile(name):
    ours = compile_scene(tlib.BUILTIN_SCENES[name](), device="cpu")
    theirs = from_numpy_scene(jax.device_get(jcompile(jlib.BUILTIN_SCENES[name]())), device="cpu")
    for field, a, b in zip(ours._fields, ours, theirs):
        assert a.dtype == torch.float32 and a.shape == b.shape, field
        assert torch.equal(a, b), field


@pytest.mark.parametrize("name", ["cornell", "cornell-panel", "sphere-plane"])
def test_tables_equal_dynamic_kernel_layout(name):
    # The dynamic-scene Pallas kernel's operand layout: same columns.
    cam, sph, pln, mat = (np.asarray(a) for a in _scene_tables(jcompile(jlib.BUILTIN_SCENES[name]())))
    ours = compile_scene(tlib.BUILTIN_SCENES[name](), device="cpu")
    np.testing.assert_array_equal(ours.camera.numpy(), cam.reshape(12))
    np.testing.assert_array_equal(ours.spheres.numpy(), sph)
    np.testing.assert_array_equal(ours.planes.numpy(), pln)
    np.testing.assert_array_equal(ours.materials.numpy(), mat)


@pytest.mark.parametrize("name", list(tlib.BUILTIN_SCENES))
def test_json_round_trip_between_packages(name):
    ours = tlib.BUILTIN_SCENES[name]()
    theirs = jlib.BUILTIN_SCENES[name]()
    assert ours.to_json() == theirs.to_json()
    assert JScene.from_json(ours.to_json()).to_dict() == theirs.to_dict()
    assert SceneDescription.from_json(theirs.to_json()).to_dict() == ours.to_dict()


def test_json_file_round_trip(tmp_path):
    path = str(tmp_path / "scene.json")
    tlib.cornell_box().save(path)
    a = compile_scene(SceneDescription.load(path), device="cpu")
    b = from_numpy_scene(jax.device_get(jcompile(JScene.load(path))), device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_transformed_scene_equal_jax():
    from cornelis_tpu.math.linalg import compose, rotation_y, scaling, translation

    m = compose(translation((1.0, 2.0, 3.0)), rotation_y(0.3), scaling(2.0)).tolist()
    d = tlib.sphere_on_plane()
    d.spheres[0].transform = m
    d.planes[0].transform = m
    jd = JScene.from_json(d.to_json())
    ours = compile_scene(d, device="cpu")
    theirs = from_numpy_scene(jax.device_get(jcompile(jd)), device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(ours, theirs))


def test_sdf_scenes_raise():
    # SDF scenes compile; one whose SDF names a material that is not in the
    # table raises, as a sphere or a plane with one does.
    assert compile_scene(tlib.sdf_gallery(), device="cpu").sdfs.shape == (3, 19)
    d = SceneDescription()
    d.add_sdf(SDFDescription())
    assert compile_scene(d, device="cpu").sdfs.shape == (1, 19)
    d.add_sdf(SDFDescription(kind="box", material=4))
    with pytest.raises(ValueError):
        compile_scene(d, device="cpu")


def test_material_ids_checked():
    d = SceneDescription()
    d.add_sphere(SphereDescription(material=3))
    with pytest.raises(ValueError):
        compile_scene(d, device="cpu")


def test_empty_object_tables():
    d = SceneDescription()
    t = compile_scene(d, device="cpu")
    assert t.spheres.shape == (0, 5) and t.planes.shape == (0, 9) and t.sdfs.shape == (0, 19)
    assert t.materials.shape == (1, 11)
