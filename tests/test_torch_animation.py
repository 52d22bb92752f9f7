"""RenderSession.update_scene on the CPU: an animation's frames rendered by
one session whose tables are edited in place.

The frames are the benchmark's animation (perfbench/kinds/dynamic.py's
`frame_scene`: the small spheres lifted on a sine, one sphere material
lit a frame) on sphere_grid(16), at 16x16, 4 spp, depth 8, nee/sobol,
where the dynamic-scene render (K3) takes its light table from
`lights.light_table_dyn_reference`. The frozen reference
(perfbench/reference/, with K3's table from its lights_dyn.py) compiles
each frame's scene on its own. Both are plain torch versions of the same
operations in the same order on the CPU, so the images are held equal
bit for bit; so are two sessions that reach one frame by different
edits, and the reference's K3 table and the port's.
"""

import json
import math

import numpy as np
import pytest
import torch

from cornelis_tpu_torch import RenderOptions, RenderSession, SceneDescription
from cornelis_tpu_torch.ops import lights
from cornelis_tpu_torch.scene.library import sdf_gallery, sphere_grid
from cornelis_tpu_torch.utils import trace
from perfbench.kinds.dynamic import frame_scene
from perfbench.reference import compile as ref_compile
from perfbench.reference import description as ref_description
from perfbench.reference import frames as ref_frames
from perfbench.reference import lights_dyn as ref_lights_dyn
from perfbench.reference.compile import SceneTables as RefTables
from torch_light_tables import CASE_NAMES, table_case

W = H = 16
SPP, DEPTH, SEED = 4, 8, 2**31 + 7
CONFIG = {
    "scene": json.loads(json.dumps(sphere_grid(16).to_dict())),
    "motion": {"small_spheres": 16, "lift": 1.0, "period_frames": 8,
               "first_sphere_material": 2, "sphere_materials": 2,
               "emission": [20.0, 20.0, 20.0]},
}


def _scene(index):
    return SceneDescription.from_dict(frame_scene(CONFIG, index))


def _options(**kw):
    return RenderOptions(**{**dict(width=W, height=H, samples_aa=SPP, max_depth=DEPTH,
                                   integrator="nee", sampler="sobol", seed=SEED,
                                   device="cpu", output=None), **kw})


def _reference(index, integrator="nee"):
    """The frozen reference's image of frame `index`, (H, W, 3)."""
    desc = ref_description.SceneDescription.from_dict(frame_scene(CONFIG, index))
    tables = ref_compile.compile_scene(desc, device="cpu")
    table = ref_lights_dyn.light_table_dyn(tables) if integrator == "nee" else None
    pixels = torch.arange(W * H)
    image = ref_frames.pixel_means(tables, table, SEED, pixels, width=W, height=H, spp=SPP,
                                   max_depth=DEPTH, integrator=integrator, sampler="sobol")
    return image.numpy().reshape(H, W, 3)


@pytest.mark.parametrize("index", [1, 5])
def test_an_updated_session_renders_the_references_frame(index):
    session = RenderSession(_scene(0), _options())
    session.update_scene(_scene(index))
    got = session.render().image
    want = _reference(index)
    assert np.array_equal(got, want), float(np.abs(got - want).max())
    # The frame differs from frame 0's, so the edit reached the render.
    assert not np.array_equal(got, _reference(0))


def test_two_sessions_reach_one_frame_alike():
    """Built from frame 0 or from frame 3, each updated to frame 3: one
    image, bit for bit (an updated session keeps no trace of its first
    scene, whose K1 table it drops)."""
    from_0 = RenderSession(_scene(0), _options())
    from_0.update_scene(_scene(3))
    from_3 = RenderSession(_scene(3), _options())
    from_3.update_scene(_scene(3))
    assert np.array_equal(from_0.render().image, from_3.render().image)


def test_a_path_session_updated_renders_as_a_new_session_of_the_frame():
    """Mode "path" keeps K1 (its tables are operands): an updated session
    renders frame 2 as a session built from frame 2, and as the
    reference."""
    updated = RenderSession(_scene(0), _options(integrator="path"))
    updated.update_scene(_scene(2))
    fresh = RenderSession(_scene(2), _options(integrator="path"))
    got = updated.render().image
    assert np.array_equal(got, fresh.render().image)
    assert np.array_equal(got, _reference(2, integrator="path"))


def test_an_update_keeps_every_tables_storage():
    session = RenderSession(_scene(0), _options())
    before = [t.data_ptr() for t in session.tables]
    shapes = [t.shape for t in session.tables]
    session.update_scene(_scene(6))
    assert [t.data_ptr() for t in session.tables] == before
    assert [t.shape for t in session.tables] == shapes
    want = ref_compile.compile_scene(
        ref_description.SceneDescription.from_dict(frame_scene(CONFIG, 6)), device="cpu")
    for got, ref in zip(session.tables, want):
        assert torch.equal(got, ref)
    # The K1 table is gone: the next chunks build K3's.
    assert session.lights is lights.IN_LAUNCH


def test_a_never_updated_session_keeps_k1():
    session = RenderSession(_scene(0), _options())
    assert isinstance(session.lights, lights.Lights)
    image = session.render().image
    assert np.array_equal(image, RenderSession(_scene(0), _options()).render().image)


@pytest.mark.parametrize("change", ["sphere", "plane", "material", "sdf"])
def test_a_changed_topology_raises_value_error(change):
    session = RenderSession(_scene(0), _options(integrator="path"))
    before = [t.clone() for t in session.tables]
    d = frame_scene(CONFIG, 1)
    if change == "sphere":
        d["spheres"].pop(0)
    elif change == "plane":
        d["planes"].append(dict(d["planes"][0]))
    elif change == "material":
        d["materials"].append(dict(d["materials"][0]))
    else:
        d["sdfs"].append(sdf_gallery().to_dict()["sdfs"][0])
    with pytest.raises(ValueError, match="keeps the counts"):
        session.update_scene(SceneDescription.from_dict(d))
    for got, old in zip(session.tables, before):  # nothing was copied
        assert torch.equal(got, old)


def test_what_k3_cannot_take_raises_not_implemented():
    with pytest.raises(NotImplementedError, match="mesh"):
        RenderSession(_scene(0), _options(mesh_shape=(1, 1))).update_scene(_scene(1))
    with pytest.raises(NotImplementedError, match="SDF"):
        RenderSession(sdf_gallery(), _options()).update_scene(sdf_gallery())
    with pytest.raises(NotImplementedError, match="nee_clamp"):
        RenderSession(_scene(0), _options(nee_clamp=math.inf)).update_scene(_scene(1))
    # Mode "path" takes SDF rows and leaves the clamp unread.
    RenderSession(sdf_gallery(), _options(integrator="path")).update_scene(sdf_gallery())
    RenderSession(_scene(0), _options(integrator="path", nee_clamp=2.0)).update_scene(_scene(1))


def test_the_edit_is_a_span_with_its_attributes():
    session = RenderSession(_scene(0), _options())
    with trace.collect() as spans:
        session.update_scene(_scene(1))
    (edit,) = [s for s in spans if s.name == "ct.scene.update"]
    n_bytes = sum(t.numel() * t.element_size() for t in session.tables)
    assert edit.attrs == {"spheres": 17, "bytes": n_bytes}
    assert edit.end_ns > edit.start_ns


@pytest.mark.parametrize("name", CASE_NAMES)
def test_the_references_k3_table_is_the_ports(name):
    tables = table_case(name)
    want = lights.light_table_dyn_reference(tables)
    got = ref_lights_dyn.light_table_dyn(RefTables(*tables))
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))  # bit for bit, NaNs too
