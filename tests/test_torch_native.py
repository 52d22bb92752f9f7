"""The port's native host runtime (cornelis_tpu_torch/native/, its own copy
of cornelis_native.cpp built into cornelis_tpu_torch/_build/) at the bars
of tests/test_native.py: PNG bytes equal to the Python encoder's and to
the JAX package's native library's, the tonemap within one count of the
torch tonemap (and under 1% of values apart: libm's pow against torch's),
accumulate equal to numpy's, mismatched shapes rejected, and the
CORNELIS_NO_NATIVE=1 fallback. Skipped only where the library cannot be
built (no g++ or zlib), decided in a fixture.
"""

import os

import numpy as np
import pytest
import torch

from cornelis_tpu import native as jnative
from cornelis_tpu_torch import native
from cornelis_tpu_torch.film import Film
from cornelis_tpu_torch.math import color
from cornelis_tpu_torch.utils import png as pypng


@pytest.fixture(autouse=True)
def _needs_native():
    if not native.available():
        pytest.skip("native library unavailable (no g++ or zlib)")


def _random_image(h=33, w=47, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def _torch_tonemap(linear, standard=False):
    return color.quantize_to_8bit(color.srgb_encode(torch.from_numpy(linear), standard)).numpy()


class TestBuild:
    def test_built_into_the_ports_build_dir(self):
        path = native.build()
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert os.path.dirname(path) == os.path.join(repo, "cornelis_tpu_torch", "_build")
        assert os.path.basename(path).startswith("libcornelis_native_")
        assert native.load().cn_abi_version() == 1

    def test_kill_switch(self, monkeypatch):
        monkeypatch.setenv("CORNELIS_NO_NATIVE", "1")
        assert native.load() is None and not native.available()
        img = _random_image(4, 5)
        assert native.encode_png(img) is None and native.srgb_quantize(img) is None
        assert not native.accumulate(np.zeros(3, np.float32), np.ones(3, np.float32))

    def test_film_png_does_not_depend_on_the_switch(self, tmp_path, monkeypatch):
        film = Film(6, 5)
        film.add_samples(np.random.default_rng(9).random((5, 6, 3)).astype(np.float32), 1)
        film.save_png(str(tmp_path / "native.png"))
        monkeypatch.setenv("CORNELIS_NO_NATIVE", "1")
        film.save_png(str(tmp_path / "python.png"))
        assert (tmp_path / "native.png").read_bytes() == (tmp_path / "python.png").read_bytes()


class TestPng:
    def test_roundtrip_through_python_reader(self, tmp_path):
        img = _random_image()
        path = tmp_path / "native.png"
        assert native.write_png(str(path), img)
        assert np.array_equal(pypng.read_png(str(path)), img)

    @pytest.mark.parametrize("level", [1, 6, 9])
    def test_encode_matches_python_encoder_bytes(self, level):
        img = _random_image(seed=1)
        assert native.encode_png(img, compress_level=level) == pypng.encode_png(img, level)

    def test_encode_matches_jax_native_bytes(self):
        if not jnative.available():
            pytest.skip("the JAX package's native library did not build")
        img = _random_image(64, 48, seed=2)
        assert native.encode_png(img) == jnative.encode_png(img)

    def test_encode_size_consistency(self):
        data = native.encode_png(_random_image(5, 7, seed=2))
        assert data is not None and data[:8] == b"\x89PNG\r\n\x1a\n"

    def test_rejects_bad_shape(self):
        with pytest.raises(ValueError):
            native.encode_png(np.zeros((4, 4), np.uint8))


class TestSrgbQuantize:
    @pytest.mark.parametrize("standard", [False, True])
    def test_matches_torch_within_one_count(self, standard):
        rng = np.random.default_rng(3)
        linear = rng.random((64, 64, 3), np.float32) * 1.5  # includes > 1 values
        linear[0, 0] = 0.0
        linear[0, 1] = 0.0031308  # segment boundary
        nat = native.srgb_quantize(linear, standard=standard)
        diff = np.abs(nat.astype(int) - _torch_tonemap(linear, standard).astype(int))
        assert diff.max() <= 1
        assert (diff > 0).mean() < 0.01

    def test_negative_radiance_clamps_to_zero(self):
        nat = native.srgb_quantize(np.array([[[-0.5, -1e-9, 0.0]]], np.float32))
        assert nat.min() >= 0 and nat[0, 0, 2] == 0


class TestAccumulate:
    def test_matches_numpy(self):
        rng = np.random.default_rng(4)
        dst = rng.random((16, 16, 3)).astype(np.float32)
        src = rng.random((16, 16, 3)).astype(np.float32)
        want = dst + src
        assert native.accumulate(dst, src)
        assert np.array_equal(dst, want)

    def test_rejects_mismatched(self):
        dst = np.zeros((4, 4, 3), np.float32)
        assert not native.accumulate(dst[::2], np.zeros((2, 4, 3), np.float32))
        assert not native.accumulate(dst, np.zeros((4, 3, 3), np.float32))
        assert not native.accumulate(dst.astype(np.float64), dst)


class TestFilmIntegration:
    def test_film_png_is_the_native_encode_of_its_tonemap(self, tmp_path):
        film = Film(24, 16)
        film.add_samples(np.random.default_rng(5).random((16, 24, 3)).astype(np.float32) * 4, 4)
        path = tmp_path / "film.png"
        film.save_png(str(path))
        assert path.read_bytes() == native.encode_png(film.to_srgb8())
        assert path.read_bytes() == pypng.encode_png(film.to_srgb8())
