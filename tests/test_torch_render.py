"""The slice end to end: the port's RenderSession and CLI against the JAX
session on its Pallas megakernel (interpret mode on the CPU).

Both sessions render Cornell at 16x16, 8 spp in chunks of 4, max_depth 8,
with the reference seed, and write a PNG. Bars, and why:

  * film images: all finite, at least 99% of pixels within
    rtol = atol = 1e-4, and each channel's mean within 1% relative. The
    draws are bit-identical, so pixels differ only where a knife-edge
    path (see tests/test_torch_megakernel.py) went elsewhere; one such
    path among the 2048 carries up to the light's radiance.
  * PNGs: within +-1 per 8-bit channel on at least 99% of pixels. The
    tonemap's pow comes from different libraries, which moves a value
    sitting on a rounding boundary by one step.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cornelis_tpu.options import RenderOptions as JOptions
from cornelis_tpu.render import RenderSession as JSession
from cornelis_tpu.scene.library import cornell_box as jcornell
from cornelis_tpu.utils.png import read_png
from cornelis_tpu_torch import RenderOptions, RenderSession, RenderStatus, cornell_box
from cornelis_tpu_torch.__main__ import main
from cornelis_tpu_torch.ops import megakernel

SIZE = dict(width=16, height=16, samples_aa=8, spp_chunk=4, max_depth=8)


@pytest.fixture(scope="module")
def renders(tmp_path_factory):
    out = tmp_path_factory.mktemp("render")
    from cornelis_tpu.ops import pallas_integrator as pk

    mp = pytest.MonkeyPatch()
    mp.setenv("CORNELIS_PALLAS_INTERPRET", "1")
    # A completed Pallas render marks the process warm; undo restores it.
    mp.setattr(pk, "_PROCESS_WARM", pk._PROCESS_WARM)
    try:
        j = JSession(jcornell(), JOptions(backend="pallas", output=str(out / "jax.png"), **SIZE)).render()
    finally:
        mp.undo()
    before = megakernel.LAUNCHES
    t = RenderSession(
        cornell_box(),
        RenderOptions(device="cpu", output=str(out / "torch.png"), **SIZE),
    ).render()
    assert megakernel.LAUNCHES == before  # the plain version launches nothing
    return t, j, out


def test_session_completes(renders):
    t, j, _ = renders
    assert t.status == RenderStatus.DONE
    assert t.chunks == 2
    assert t.film.sample_count == j.film.sample_count == 8
    assert t.image.shape == j.image.shape == (16, 16, 3)
    assert np.isfinite(t.image).all()


def test_film_images_agree(renders):
    t, j, _ = renders
    ok = np.isclose(t.image, j.image, rtol=1e-4, atol=1e-4).all(-1)
    assert ok.mean() >= 0.99, f"only {ok.mean():.2%} of pixels agree"
    rel = np.abs(t.image.mean((0, 1)) - j.image.mean((0, 1))) / j.image.mean((0, 1))
    assert (rel <= 1e-2).all(), f"channel means differ by {rel}"


def test_pngs_agree(renders):
    _, _, out = renders
    a = read_png(str(out / "torch.png")).astype(int)
    b = read_png(str(out / "jax.png")).astype(int)
    assert a.shape == b.shape == (16, 16, 3)
    ok = (np.abs(a - b) <= 1).all(-1)
    assert ok.mean() >= 0.99, f"only {ok.mean():.2%} of pixels within +-1"


@pytest.fixture(scope="module")
def nee_renders():
    """The new slice, integrator "nee" with sampler "sobol", through both
    sessions (no PNG)."""
    from cornelis_tpu.ops import pallas_integrator as pk

    kw = dict(SIZE, integrator="nee", sampler="sobol", output=None)
    mp = pytest.MonkeyPatch()
    mp.setenv("CORNELIS_PALLAS_INTERPRET", "1")
    mp.setattr(pk, "_PROCESS_WARM", pk._PROCESS_WARM)
    try:
        j = JSession(jcornell(), JOptions(backend="pallas", **kw)).render()
    finally:
        mp.undo()
    before = megakernel.LAUNCHES
    t = RenderSession(cornell_box(), RenderOptions(device="cpu", **kw)).render()
    assert megakernel.LAUNCHES == before
    return t, j


def test_nee_sobol_session_agrees(nee_renders):
    # NEE exposes the Cornell knife edge of tests/test_torch_nee.py (a
    # camera hit left inside its sphere shadows its own light sample) on
    # 2-7% of rays, and a pixel sums 8 of them: at least 75% of pixels
    # within 1e-4 (measured 86.3%), channel means within 1% (0.34%).
    t, j = nee_renders
    assert t.status == RenderStatus.DONE and t.chunks == 2
    assert t.image.shape == j.image.shape == (16, 16, 3)
    assert np.isfinite(t.image).all() and (t.image >= 0).all()
    ok = np.isclose(t.image, j.image, rtol=1e-4, atol=1e-4).all(-1)
    assert ok.mean() >= 0.75, f"only {ok.mean():.2%} of pixels agree"
    rel = np.abs(t.image.mean((0, 1)) - j.image.mean((0, 1))) / j.image.mean((0, 1))
    assert (rel <= 1e-2).all(), f"channel means differ by {rel}"


def test_cli_nee_sobol_flags(tmp_path):
    path = tmp_path / "nee.png"
    rc = main(
        ["--device", "cpu", "--integrator", "nee", "--sampler", "sobol", "--nee-clamp", "inf",
         "--width", "8", "--height", "8", "--spp", "2", "--max-depth", "4", "-o", str(path)]
    )
    assert rc == 0
    assert read_png(str(path)).shape == (8, 8, 3)


def test_cli_renders_png(tmp_path):
    path = tmp_path / "cli.png"
    rc = main(
        ["--device", "cpu", "--width", "16", "--height", "16",
         "--spp", "4", "--max-depth", "4", "-o", str(path)]
    )
    assert rc == 0
    img = read_png(str(path))
    assert img.shape == (16, 16, 3) and img.max() > 0


def test_python_m_entry(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "cornelis_tpu_torch", "--device", "cpu",
         "--width", "16", "--height", "16", "--spp", "2", "--max-depth", "4", "-o", "m.png"],
        cwd=tmp_path, env=dict(os.environ, PYTHONPATH=repo), capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert read_png(str(tmp_path / "m.png")).shape == (16, 16, 3)


def test_cli_scene_file(tmp_path):
    scene = tmp_path / "scene.json"
    cornell_box().save(str(scene))
    rc = main(
        ["--scene", str(scene), "--device", "cpu", "--width", "8",
         "--height", "8", "--spp", "1", "--max-depth", "2", "-o", str(tmp_path / "f.png")]
    )
    assert rc == 0 and (tmp_path / "f.png").exists()


def test_defaults_are_the_main_path():
    o = RenderOptions()
    assert (o.width, o.height, o.samples_aa, o.max_depth) == (512, 512, 256, 64)
    assert (o.sampler, o.integrator, o.nee_clamp, o.device) == ("uniform", "path", None, "cuda")
    # About 8M rays per launch on CUDA: 32 spp per chunk, 8 launches.
    assert o.resolved_spp_chunk() == 32
    assert RenderOptions(device="cpu").resolved_spp_chunk() == 8


@pytest.mark.parametrize(
    "kwargs,error",
    [
        (dict(sampler="halton"), ValueError),
        (dict(integrator="bdpt"), ValueError),
        (dict(nee_clamp=0), ValueError),
        (dict(nee_clamp=-1), ValueError),
        (dict(device="tpu"), ValueError),
        (dict(samples_aa=0), ValueError),
        (dict(width=0), ValueError),
    ],
)
def test_options_reject(kwargs, error):
    with pytest.raises(error):
        RenderOptions(**kwargs).validate()


def test_no_output_file(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    res = RenderSession(
        cornell_box(),
        RenderOptions(width=4, height=4, samples_aa=1, max_depth=1, output=None,
                      device="cpu"),
    ).render()
    assert res.status == RenderStatus.DONE and not list(tmp_path.iterdir())
    # Depth 1 sees only emitters directly: the light sphere or black.
    assert torch.tensor(res.image).max() <= 15.0
