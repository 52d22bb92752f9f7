"""RenderSession.update_scene on the card: tests marked `cuda`, which skip
where torch sees no CUDA device. Imports no JAX; run them on a host with
a card as tests/test_torch_cuda.py's are:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_animation.py

A nee session launches K1 until its first update, and K3 (the
dynamic-scene render, its light table built in the launch) once a chunk
after it, with no table launch. The updated frame at 64x64 is held to
the plain version of the same frame (K3's plain table, the same key) at
the bar of K3's other card tests (tests/test_torch_cuda.py): at least
99% of pixels within rtol = atol = 1e-4 and each channel's mean within 1%,
since K1's nee instantiations and the plain version's torch ops round
sinf, cosf and a knife-edge comparison apart now and then. The edit
itself copies into the tables' own storage on the card. K3's sphere
hierarchy, walked over more than one leaf of spheres, is held bit for bit
to the linear scan (K1's nee fed the plain table) on
tests/torch_walk_scenes.py's cases, and through a session whose edit moves
a sphere into view.
"""

import json

import numpy as np
import pytest
import torch

from cornelis_tpu_torch import RenderOptions, RenderSession, SceneDescription
from cornelis_tpu_torch.ops import lights, megakernel
from cornelis_tpu_torch.ops.megakernel import render_chunk
from cornelis_tpu_torch.rng import key_row
from cornelis_tpu_torch.scene.library import sphere_grid
from torch_walk_scenes import CASE_NAMES as WALK_CASES
from torch_walk_scenes import walk_case

pytestmark = pytest.mark.cuda

SIZE, SPP, CHUNK = 64, 16, 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


def _edited(n):
    """sphere_grid(n) with its small spheres lifted by half a unit and one
    sphere material lit."""
    d = json.loads(json.dumps(sphere_grid(n).to_dict()))
    for sphere in d["spheres"][:n]:
        sphere["center"][1] += 0.5
    d["materials"][2]["emissive"] = [20.0, 20.0, 20.0]
    return SceneDescription.from_dict(d)


def _options(device):
    return RenderOptions(width=SIZE, height=SIZE, samples_aa=SPP, spp_chunk=CHUNK, max_depth=64,
                         integrator="nee", sampler="sobol", output=None, device=device)


def _counts():
    return megakernel.LAUNCHES, megakernel.DYNAMIC_TABLE_LAUNCHES, lights.LAUNCHES


@pytest.mark.parametrize("n", [64, 512])
def test_cuda_an_updated_session_launches_k3_once_a_chunk(cuda, n):
    session = RenderSession(sphere_grid(n), _options("cuda"))
    before = _counts()
    session.render()
    torch.cuda.synchronize()
    after = _counts()
    assert (after[0] - before[0], after[1] - before[1]) == (SPP // CHUNK, 0)
    ptrs = [t.data_ptr() for t in session.tables]
    session.update_scene(_edited(n))
    assert [t.data_ptr() for t in session.tables] == ptrs
    before = _counts()
    session.render()
    torch.cuda.synchronize()
    after = _counts()
    assert tuple(a - b for a, b in zip(after, before)) == (SPP // CHUNK, SPP // CHUNK, 0)


@pytest.mark.parametrize("n", [64, 512])
def test_cuda_an_updated_frame_agrees_with_the_plain_version(cuda, n):
    session = RenderSession(sphere_grid(n), _options("cuda"))
    session.update_scene(_edited(n))
    got = session.render().image
    plain = RenderSession(sphere_grid(n), _options("cpu"))
    plain.update_scene(_edited(n))
    want = plain.render().image
    for table, ref in zip(session.tables, plain.tables):
        assert torch.equal(table.cpu(), ref)
    ok = np.isclose(got, want, rtol=1e-4, atol=1e-4).all(axis=-1)
    mean_rel = np.abs(got.mean((0, 1)) - want.mean((0, 1))) / np.abs(want.mean((0, 1)))
    assert np.isfinite(got).all()
    assert ok.mean() >= 0.99 and (mean_rel <= 1e-2).all(), (ok.mean(), mean_rel)


# K3's sphere hierarchy (ops/csrc/megakernel.cu), built in every launch,
# must be the linear scan done better: its nee rays bit for bit those of
# K1's nee instantiation fed light_table_dyn_reference's table, which scans
# every sphere in row order, on tests/torch_walk_scenes.py's cases.
@pytest.mark.parametrize("sampler", ["uniform", "sobol"])
@pytest.mark.parametrize("case", WALK_CASES)
def test_cuda_k3s_sphere_hierarchy_is_the_linear_scan_bitwise(cuda, case, sampler):
    tables = walk_case(case, "cuda")
    size = 32 if case == "sphere_grid(2200)" else SIZE
    k0, k1, root = key_row(3)
    args = (tables, k0, k1, size, size, SPP, 0, 64)
    kw = dict(root=root, sampler=sampler, mode="nee", index_bits=4)
    before = megakernel.HIERARCHY_LAUNCHES
    got = megakernel.render_rays(*args, lights=lights.IN_LAUNCH, **kw)
    walked = megakernel.HIERARCHY_LAUNCHES - before
    want = megakernel.render_rays(*args, lights=lights.light_table_dyn_reference(tables), **kw)
    torch.cuda.synchronize()
    assert walked == int(tables.spheres.shape[0] > megakernel.WALK_LEAF)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_cuda_a_sphere_moved_into_view_is_in_the_next_frame(cuda):
    """The hierarchy is built from the tables each launch renders: a sphere
    moved between two frames of one session into the rays toward the
    image's centre is in the second frame, bit for bit the linear scan of
    the edited tables."""
    opts = _options("cuda")
    session = RenderSession(sphere_grid(512), opts)
    session.update_scene(_edited(512))
    first = session.render().image
    d = json.loads(json.dumps(_edited(512).to_dict()))
    camera = d["camera"]
    eye, look = np.array(camera["origin"]), np.array(camera["look_at"])
    d["spheres"][0]["center"] = (eye + 0.15 * (look - eye)).tolist()
    session.update_scene(SceneDescription.from_dict(d))
    second = session.render().image
    kw = dict(width=SIZE, height=SIZE, spp_chunk=CHUNK, spp_total=SPP, max_depth=64,
              sampler="sobol", mode="nee", lights=lights.light_table_dyn_reference(session.tables))
    want = sum(render_chunk(session.tables, session.key, o, **kw)
               for o in range(0, SPP, CHUNK)) / SPP
    centre = (slice(SIZE // 2 - 1, SIZE // 2 + 1),) * 2
    assert not np.array_equal(first[centre], second[centre])
    assert torch.equal(torch.from_numpy(second).cuda().view(torch.int32), want.view(torch.int32))
