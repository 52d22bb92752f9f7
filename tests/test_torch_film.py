"""The port's Film and PNG codec against the JAX package's
(tests/test_film.py): accumulation, the tonemap with either sRGB slope,
PNG round trips, `mse`, `load_image_linear` and checkpoints that load in
either package; and against the JAX package's native host runtime
(`cornelis_tpu/native/`), which the port does not carry: its PNG bytes and
its tonemap. The native cases skip only where that library cannot be
built (no g++ or zlib), decided in a fixture.

Bars: the tonemap within one 8-bit count of JAX's on every pixel (the
pow of the two libraries may differ in the last ulp, moving a value on a
rounding boundary by one step), and on under 1% of pixels at all;
`load_image_linear` within float32 rounding of JAX's (rtol 1e-6); the
rest exact.
"""

import numpy as np
import pytest
import torch

from cornelis_tpu import film as jfilm
from cornelis_tpu import native as jnative
from cornelis_tpu.utils import png as jpng
from cornelis_tpu_torch.film import Film, load_image_linear, mse
from cornelis_tpu_torch.math import color
from cornelis_tpu_torch.utils.png import encode_png, read_png, write_png


def _linear(h=24, w=40, seed=0, scale=1.5):
    rng = np.random.default_rng(seed)
    img = (rng.random((h, w, 3)) * scale).astype(np.float32)
    img[0, 0] = 0.0
    img[0, 1] = 0.0031308  # the transfer's segment boundary
    img[0, 2] = -0.25  # negative radiance clamps to 0
    return img


def _random_image(h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def _tonemap(linear, standard=False):
    """The film's tonemap (`Film.to_srgb8`) of a linear image."""
    return color.quantize_to_8bit(color.srgb_encode(torch.from_numpy(linear), standard)).numpy()


@pytest.fixture
def native():
    if not jnative.available():
        pytest.skip("the JAX package's native library did not build (no g++ or zlib)")
    return jnative


def _films(linear, count=4):
    ours, theirs = Film(linear.shape[1], linear.shape[0]), jfilm.Film(linear.shape[1],
                                                                      linear.shape[0])
    ours.add_samples(linear * count, count)
    theirs.add_samples(linear * count, count)
    return ours, theirs


class TestPng:
    def test_roundtrip(self, tmp_path):
        rng = np.random.default_rng(0)
        img = rng.integers(0, 256, (17, 23, 3), dtype=np.uint8)
        p = str(tmp_path / "t.png")
        write_png(p, img)
        assert np.array_equal(read_png(p), img)

    def test_signature(self):
        data = encode_png(np.zeros((4, 4, 3), np.uint8))
        assert data[:8] == b"\x89PNG\r\n\x1a\n"
        assert b"IHDR" in data and b"IDAT" in data and b"IEND" in data

    def test_rejects_bad_input(self):
        with pytest.raises(ValueError):
            encode_png(np.zeros((4, 4, 3), np.float32))

    @pytest.mark.parametrize("level", [1, 6, 9])
    def test_bytes_equal_jax_python_encoder(self, level):
        img = np.random.default_rng(1).integers(0, 256, (9, 13, 3), dtype=np.uint8)
        assert encode_png(img, level) == jpng.encode_png(img, level)


class TestAgainstJaxNative:
    @pytest.mark.parametrize("shape", [(33, 47), (64, 48), (1, 1)])
    @pytest.mark.parametrize("level", [1, 6, 9])
    def test_encode_bytes_equal_native(self, native, shape, level):
        img = _random_image(*shape, seed=level)
        assert encode_png(img, level) == native.encode_png(img, compress_level=level)

    def test_write_png_file_equals_native(self, native, tmp_path):
        img = _random_image(33, 47, seed=4)
        write_png(str(tmp_path / "port.png"), img)
        assert native.write_png(str(tmp_path / "native.png"), img)
        assert (tmp_path / "port.png").read_bytes() == (tmp_path / "native.png").read_bytes()

    def test_film_png_is_the_native_encode_of_its_tonemap(self, native, tmp_path):
        film = Film(24, 16)
        film.add_samples(np.random.default_rng(5).random((16, 24, 3)).astype(np.float32) * 4, 4)
        path = tmp_path / "film.png"
        film.save_png(str(path))
        assert path.read_bytes() == native.encode_png(film.to_srgb8())

    @pytest.mark.parametrize("standard", [False, True])
    def test_tonemap_within_one_count_of_native(self, native, standard):
        linear = np.random.default_rng(3).random((64, 64, 3), np.float32) * 1.5  # > 1 too
        linear[0, 0] = 0.0
        linear[0, 1] = 0.0031308  # the transfer's segment boundary
        diff = np.abs(_tonemap(linear, standard).astype(int)
                      - native.srgb_quantize(linear, standard=standard).astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01

    def test_negative_radiance_tonemaps_to_zero(self, native):
        linear = np.array([[[-0.5, -1e-9, 0.0]]], np.float32)
        assert np.array_equal(_tonemap(linear), np.zeros((1, 1, 3), np.uint8))
        assert np.array_equal(native.srgb_quantize(linear), _tonemap(linear))


class TestFilm:
    def test_dimensions_validated(self):
        with pytest.raises(ValueError):
            Film(0, 10)

    def test_aspect(self):
        assert Film(20, 10).aspect == pytest.approx(2.0) == jfilm.Film(20, 10).aspect

    def test_accumulate_average(self):
        film = Film(2, 2)
        film.add_samples(np.full((2, 2, 3), 4.0, np.float32), 4)
        film.add_samples(np.full((2, 2, 3), 8.0, np.float32), 4)
        assert np.allclose(film.image(), 1.5)

    def test_accumulates_tensors(self):
        import torch

        film = Film(3, 2)
        film.add_samples(torch.ones((2, 3, 3)), 1)
        film.add_samples(np.ones((2, 3, 3), np.float32), 1)
        assert film.sample_count == 2 and np.array_equal(film.image(), np.ones((2, 3, 3)))

    def test_empty_film_black(self):
        assert np.all(Film(2, 2).image() == 0)

    def test_srgb8_output(self):
        film = Film(1, 1)
        film.add_samples(np.ones((1, 1, 3), np.float32), 1)
        assert np.all(film.to_srgb8() == 255)

    @pytest.mark.parametrize("standard", [False, True])
    def test_to_srgb8_matches_jax(self, standard):
        ours, theirs = _films(_linear(seed=2))
        a = ours.to_srgb8(standard_srgb=standard).astype(int)
        b = theirs.to_srgb8(standard_srgb=standard).astype(int)
        diff = np.abs(a - b)
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01

    def test_standard_slope_differs_on_the_linear_segment(self):
        # 255 * 0.00288 is 9.51 counts at the reference's slope 12.95 and
        # 9.49 at the standard 12.92.
        film = Film(1, 1)
        film.add_samples(np.full((1, 1, 3), 0.00288, np.float32), 1)
        assert film.to_srgb8()[0, 0, 0] == 10
        assert film.to_srgb8(standard_srgb=True)[0, 0, 0] == 9

    def test_save_load_roundtrip(self, tmp_path):
        film = Film(8, 8)
        film.add_samples(np.random.default_rng(1).random((8, 8, 3)).astype(np.float32), 1)
        p = str(tmp_path / "img.png")
        film.save_png(p)
        back = load_image_linear(p)
        assert mse(film.image(), back) < 1e-4

    @pytest.mark.parametrize("standard", [False, True])
    def test_load_image_linear_matches_jax(self, tmp_path, standard):
        p = str(tmp_path / "img.png")
        write_png(p, np.random.default_rng(3).integers(0, 256, (12, 10, 3), dtype=np.uint8))
        ours = load_image_linear(p, standard_srgb=standard)
        theirs = np.asarray(jfilm.load_image_linear(p, standard_srgb=standard))
        assert ours.dtype == np.float32 and ours.shape == theirs.shape
        np.testing.assert_allclose(ours, theirs, rtol=1e-6, atol=0)

    def test_mse_matches_jax(self):
        a, b = _linear(seed=4), _linear(seed=5)
        assert mse(a, b) == jfilm.mse(a, b)
        assert mse(a, a) == 0.0

    def test_save_png_within_one_count_of_jax(self, tmp_path):
        ours, theirs = _films(_linear(seed=6))
        ours.save_png(str(tmp_path / "t.png"))
        theirs.save_png(str(tmp_path / "j.png"))
        diff = np.abs(read_png(str(tmp_path / "t.png")).astype(int)
                      - read_png(str(tmp_path / "j.png")).astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        film = Film(4, 4)
        film.add_samples(np.full((4, 4, 3), 2.0, np.float32), 16)
        p = str(tmp_path / "ckpt.npz")
        film.save_checkpoint(p, next_sample=16, seed=99)
        loaded, next_sample, seed = Film.load_checkpoint(p)
        assert next_sample == 16 and seed == 99
        assert loaded.sample_count == 16
        assert np.array_equal(loaded.radiance_sum, film.radiance_sum)
        assert not (tmp_path / "ckpt.npz.tmp").exists()

    def test_jax_loads_ours(self, tmp_path):
        ours, _ = _films(_linear(seed=7), count=6)
        p = str(tmp_path / "t.npz")
        ours.save_checkpoint(p, next_sample=6, seed=5)
        loaded, next_sample, seed = jfilm.Film.load_checkpoint(p)
        assert (next_sample, seed, loaded.sample_count) == (6, 5, 6)
        assert np.array_equal(loaded.radiance_sum, ours.radiance_sum)

    def test_ours_loads_jax(self, tmp_path):
        _, theirs = _films(_linear(seed=8), count=3)
        p = str(tmp_path / "j.npz")
        theirs.save_checkpoint(p, next_sample=3, seed=11)
        loaded, next_sample, seed = Film.load_checkpoint(p)
        assert (next_sample, seed, loaded.sample_count) == (3, 11, 3)
        assert np.array_equal(loaded.radiance_sum, theirs.radiance_sum)
        assert np.array_equal(loaded.image(), theirs.image())
