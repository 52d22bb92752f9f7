"""The port's command line (cornelis_tpu_torch/cli.py) against the JAX
package's (tests/test_cli.py less its schedule case): the flag surface,
--list-scenes, --dump-scene round-tripping through --scene FILE,
--checkpoint resume, --time-budget, --standard-srgb, --spp-chunk, -q and
--profile-dir, all on the CPU (the kernel's plain version).
"""

import json
import logging

import numpy as np
import pytest

from cornelis_tpu.cli import build_parser as jbuild_parser
from cornelis_tpu.cli import main as jmain
from cornelis_tpu_torch import render as render_mod
from cornelis_tpu_torch.cli import build_parser, load_scene, main, parse_mesh
from cornelis_tpu_torch.film import Film
from cornelis_tpu_torch.options import RenderOptions
from cornelis_tpu_torch.render import RenderSession
from cornelis_tpu_torch.scene.description import SceneDescription
from cornelis_tpu_torch.scene.library import cornell_box, sphere_on_plane
from cornelis_tpu_torch.utils.logging import logger
from cornelis_tpu_torch.utils.png import read_png

# The JAX package's TPU scheduling flags, which the port leaves out.
LEFT_OUT = {"--backend", "--warmup-threshold", "--warm-device-max-age", "--save-schedule",
            "--replay-schedule"}


def _flags(parser) -> set:
    return {s for a in parser._actions for s in a.option_strings}


def _render_args(out, *extra):
    return ["--scene", "sphere-plane", "--spp", "2", "--width", "16", "--height", "16",
            "--max-depth", "2", "--device", "cpu", "-o", str(out), *extra]


@pytest.fixture(autouse=True)
def _logger_level():
    """-q sets the session logger to WARNING; give each test the level it
    found."""
    level = logger.level
    yield
    logger.setLevel(level)


class TestParsing:
    def test_flags_are_the_jax_clis_less_its_scheduling(self):
        ours, theirs = _flags(build_parser()), _flags(jbuild_parser())
        assert theirs - LEFT_OUT <= ours
        assert not LEFT_OUT & ours
        assert ours - theirs == {"--device", "--dist-backend"}

    def test_defaults_are_the_main_path(self):
        args, d = build_parser().parse_args([]), RenderOptions()
        assert args.scene == "cornell" and args.output == "cornelisrender2.png"
        assert (args.spp, args.width, args.height, args.max_depth) == (
            d.samples_aa, d.width, d.height, d.max_depth)
        assert (args.spp_chunk, args.time_budget, args.checkpoint, args.standard_srgb) == (
            0, 0.0, None, False)
        assert (args.profile_dir, args.list_scenes, args.dump_scene, args.quiet) == (
            None, False, None, False)

    def test_parse_mesh(self):
        assert parse_mesh(None) is None
        assert parse_mesh("4x2") == (4, 2)
        assert parse_mesh("8") == (8, 1)
        for bad in ("axb", "0x2"):
            with pytest.raises(SystemExit):
                parse_mesh(bad)

    def test_unknown_scene_errors(self):
        with pytest.raises(SystemExit):
            load_scene("no-such-scene-or-file")


class TestInformational:
    def test_list_scenes_as_jax(self, capsys):
        assert main(["--list-scenes"]) == 0
        ours = capsys.readouterr().out
        assert jmain(["--list-scenes"]) == 0
        theirs = capsys.readouterr().out
        assert "cornell" in ours and "sphere-plane" in ours
        assert set(theirs.split()) <= set(ours.split())

    def test_dump_scene_roundtrips(self, capsys):
        assert main(["--dump-scene", "cornell"]) == 0
        dumped = capsys.readouterr().out
        assert SceneDescription.from_dict(json.loads(dumped)).to_dict() == cornell_box().to_dict()
        assert jmain(["--dump-scene", "cornell"]) == 0
        assert json.loads(capsys.readouterr().out) == json.loads(dumped)

    def test_dump_scene_unknown_errors(self):
        with pytest.raises(SystemExit):
            main(["--dump-scene", "no-such-scene"])

    def test_dumped_scene_renders_through_scene_file(self, tmp_path, capsys):
        assert main(["--dump-scene", "sphere-plane"]) == 0
        scene_file = tmp_path / "scene.json"
        scene_file.write_text(capsys.readouterr().out)
        out_file, out_builtin = tmp_path / "file.png", tmp_path / "builtin.png"
        args = ["--spp", "1", "--width", "8", "--height", "8", "--max-depth", "2", "--device",
                "cpu", "-q"]
        assert main(["--scene", str(scene_file), "-o", str(out_file), *args]) == 0
        assert main(["--scene", "sphere-plane", "-o", str(out_builtin), *args]) == 0
        assert out_file.read_bytes() == out_builtin.read_bytes()


class TestEndToEnd:
    def test_render_writes_png(self, tmp_path):
        out = tmp_path / "render.png"
        assert main(_render_args(out, "-q")) == 0
        assert read_png(str(out)).shape == (16, 16, 3)

    def test_quiet_silences_progress(self, tmp_path, caplog):
        with caplog.at_level(logging.INFO, logger="cornelis_tpu_torch"):
            assert main(_render_args(tmp_path / "a.png")) == 0
            assert any("Starting render session" in r.message for r in caplog.records)
            caplog.clear()
            assert main(_render_args(tmp_path / "b.png", "-q")) == 0
            assert logger.level == logging.WARNING
        assert not [r for r in caplog.records if r.levelno < logging.WARNING]

    def test_render_sobol(self, tmp_path):
        out = tmp_path / "render.png"
        assert main(_render_args(out, "--sampler", "sobol", "-q")) == 0
        assert read_png(str(out)).max() > 0

    def test_checkpoint_resume(self, tmp_path):
        out, ckpt = tmp_path / "render.png", tmp_path / "film.ckpt"
        args = _render_args(out, "--checkpoint", str(ckpt), "--spp-chunk", "1", "-q")
        assert main(args) == 0
        film, next_sample, seed = Film.load_checkpoint(str(ckpt))
        assert (next_sample, film.sample_count, seed) == (2, 2, RenderOptions().seed)
        first = out.read_bytes()
        # Resuming a finished render is a no-op that still writes the image.
        out.unlink()
        assert main(args) == 0
        assert out.read_bytes() == first

    def test_time_budget_stops_after_one_chunk(self, tmp_path):
        out, ckpt = tmp_path / "render.png", tmp_path / "film.ckpt"
        assert main(_render_args(out, "--spp", "8", "--spp-chunk", "1", "--time-budget", "1e-6",
                                 "--checkpoint", str(ckpt), "-q")) == 0
        film, next_sample, _ = Film.load_checkpoint(str(ckpt))
        assert next_sample == film.sample_count == 1
        assert out.exists()

    def test_negative_time_budget_rejected(self, tmp_path):
        with pytest.raises(ValueError):
            main(_render_args(tmp_path / "x.png", "--time-budget", "-1"))

    def test_spp_chunk_sets_the_launches(self, tmp_path, monkeypatch):
        offsets = []
        real = render_mod.render_chunk

        def counting(tables, key, offset, **kw):
            offsets.append((offset, kw["spp_chunk"]))
            return real(tables, key, offset, **kw)

        monkeypatch.setattr(render_mod, "render_chunk", counting)
        assert main(_render_args(tmp_path / "c.png", "--spp", "5", "--spp-chunk", "2", "-q")) == 0
        assert offsets == [(0, 2), (2, 2), (4, 1)]

    def test_standard_srgb(self, tmp_path):
        quirk, std = tmp_path / "quirk.png", tmp_path / "std.png"
        assert main(_render_args(quirk, "-q")) == 0
        assert main(_render_args(std, "--standard-srgb", "-q")) == 0
        opts = RenderOptions(samples_aa=2, width=16, height=16, max_depth=2, device="cpu",
                             output=None)
        film = RenderSession(sphere_on_plane(), opts).render().film
        assert np.array_equal(read_png(str(std)), film.to_srgb8(standard_srgb=True))
        assert np.array_equal(read_png(str(quirk)), film.to_srgb8())

    def test_profile_dir_writes_a_trace(self, tmp_path):
        prof = tmp_path / "prof"
        assert main(_render_args(tmp_path / "p.png", "--profile-dir", str(prof), "-q")) == 0
        traces = list(prof.glob("*.json"))
        assert len(traces) == 1
        events = json.loads(traces[0].read_text())["traceEvents"]
        assert any(e.get("name") == "aten::sum" for e in events)
