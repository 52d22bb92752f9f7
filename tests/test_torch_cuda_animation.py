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
itself copies into the tables' own storage on the card.
"""

import json

import numpy as np
import pytest
import torch

from cornelis_tpu_torch import RenderOptions, RenderSession, SceneDescription
from cornelis_tpu_torch.ops import lights, megakernel
from cornelis_tpu_torch.scene.library import sphere_grid

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
