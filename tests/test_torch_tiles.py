"""The port's frame tiling math against cornelis_tpu.math.tiles.

`cornelis_tpu_torch/math/tiles.py` is a copy in plain Python and numpy;
its tile bounds, tile-major pixel order, even splits and padding must be
the JAX package's exactly, and the order a permutation of the frame
(the properties of tests/test_parallel.py:105-114).
"""

import numpy as np
import pytest

from cornelis_tpu.math import tiles as jtiles
from cornelis_tpu_torch.math import tiles

FRAMES = [(32, 32, 8), (20, 12, 8), (7, 5, 3), (512, 512, 32)]


@pytest.mark.parametrize("w,h,t", FRAMES)
def test_tile_major_order_matches_jax(w, h, t):
    got = tiles.tile_major_order(w, h, t, t)
    want = jtiles.tile_major_order(w, h, t, t)
    assert got.dtype == want.dtype == np.uint32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("w,h,t", FRAMES)
def test_frame_tiling_matches_jax(w, h, t):
    got, want = tiles.FrameTiling(w, h, t, t), jtiles.FrameTiling(w, h, t, t)
    assert (got.num_x, got.num_y, len(got)) == (want.num_x, want.num_y, len(want))
    for a, b in zip(got, want):
        assert (a.tile_number, a.min_i, a.min_j, a.max_i, a.max_j) == (
            b.tile_number, b.min_i, b.min_j, b.max_i, b.max_j)
        assert (a.width, a.height, a.area) == (b.width, b.height, b.area)
    assert sum(tile.area for tile in got) == w * h


def test_frame_tiling_rejects_what_jax_rejects():
    for args in ((0, 4), (4, -1), (4, 4, 0, 4), (4, 4, 4, 0)):
        with pytest.raises(ValueError):
            jtiles.FrameTiling(*args)
        with pytest.raises(ValueError):
            tiles.FrameTiling(*args)


@pytest.mark.parametrize("n,parts", [(10, 3), (1024, 8), (7, 7), (3, 5), (0, 2)])
def test_split_evenly_and_pad_match_jax(n, parts):
    assert tiles.split_evenly(n, parts) == jtiles.split_evenly(n, parts)
    assert tiles.pad_to_multiple(n, parts) == jtiles.pad_to_multiple(n, parts)


def test_tile_major_order_is_permutation():
    for w, h, t in FRAMES:
        perm = tiles.tile_major_order(w, h, t, t)
        assert sorted(perm.tolist()) == list(range(w * h))
    # First tile's pixels come first (row-major inside the tile).
    perm = tiles.tile_major_order(8, 8, 4, 4)
    assert perm[:4].tolist() == [0, 1, 2, 3]
    assert perm[4:8].tolist() == [8, 9, 10, 11]
