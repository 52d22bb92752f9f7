"""The port's mesh render across real processes: gloo ranks on the CPU,
through RenderSession and the command line, against one process.

Each rank is a subprocess (tests/_torch_mp_child.py) that joins a gloo
process group over TCP on 127.0.0.1, renders Cornell through the public
entry points with `mesh_shape`, and rank 0 writes the result. The draws
are keyed by (pixel, sample), so the frame does not depend on the mesh.

Bars, as tests/test_parallel.py and tests/test_multiprocess.py hold the
JAX package: a tiles-only mesh sums each pixel's samples in a single
render's order, so its image is bitwise equal (and its PNG byte-equal);
a mesh with a samples axis adds the ranks' partial sums, another float
order, so rtol 1e-5 / atol 1e-6 (tests/test_multiprocess.py:101).
"""

import numpy as np
import pytest
import torch
from _torch_mp_child import launch_ranks

from cornelis_tpu_torch import RenderOptions, RenderSession, cornell_box
from cornelis_tpu_torch.__main__ import main as cli_main

OPTIONS = dict(width=32, height=32, samples_aa=8, spp_chunk=4, max_depth=8, device="cpu",
               output=None)


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _single(**kw) -> np.ndarray:
    return RenderSession(cornell_box(), RenderOptions(**{**OPTIONS, **kw})).render().image


def _meshed(tmp_path, mesh, **kw) -> np.ndarray:
    out = tmp_path / "rank0.npy"
    outputs = launch_ranks(
        dict(kind="session", mesh=list(mesh), options={**OPTIONS, **kw}, out=str(out)),
        mesh[0] * mesh[1], tmp_path,
    )
    # Each rank launched (ran the plain version of) one chunk per 4 spp.
    assert all("session ok, 2 chunks" in o for o in outputs), outputs
    return np.load(out)


def test_two_tile_ranks_equal_one_process_bitwise(tmp_path):
    np.testing.assert_array_equal(_meshed(tmp_path, (2, 1)), _single())


def test_four_ranks_on_a_2x2_mesh_match_one_process(tmp_path):
    multi = _meshed(tmp_path, (2, 2), width=64, height=64)
    np.testing.assert_allclose(multi, _single(width=64, height=64), rtol=1e-5, atol=1e-6)


def test_samples_axis_nee_sobol_matches_one_process(tmp_path):
    kw = dict(integrator="nee", sampler="sobol")
    multi = _meshed(tmp_path, (1, 2), **kw)
    np.testing.assert_allclose(multi, _single(**kw), rtol=1e-5, atol=1e-6)


def test_cli_mesh_writes_rank_zeros_png_equal_to_one_process(tmp_path):
    argv = ["--device", "cpu", "--width", "32", "--height", "32", "--spp", "8", "--max-depth",
            "8"]
    launch_ranks(dict(kind="cli", argv=argv + ["-o", "mesh.png", "--mesh", "2x1"]), 2, tmp_path)
    pngs = sorted(p.relative_to(tmp_path).as_posix() for p in tmp_path.rglob("*.png"))
    assert pngs == ["rank0/mesh.png"]
    single = tmp_path / "single.png"
    assert cli_main(argv + ["-o", str(single)]) == 0
    assert (tmp_path / "rank0" / "mesh.png").read_bytes() == single.read_bytes()
