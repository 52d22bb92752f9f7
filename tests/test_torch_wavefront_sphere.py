"""The port's torch wavefront on sphere_on_plane against cornelis_tpu's.

sphere_on_plane through `integrator.render_chunk` in every mode x sampler
and through `render_diff` in both modes, with the bars of
tests/test_torch_wavefront.py (measured, seed 19791102: 99.61-100% of
rays per chunk, render_diff 100% of pixels, channel means within 5.6e-6).
"""

import pytest

from test_torch_wavefront import (  # noqa: F401 (a fixture)
    VARIANTS,
    check_render_chunk,
    check_render_diff,
    one_torch_thread,
)


@pytest.mark.parametrize("mode,sampler", VARIANTS)
def test_render_chunk_matches_jax_on_sphere_on_plane(mode, sampler):
    check_render_chunk("sphere_on_plane", mode, sampler)


@pytest.mark.parametrize("mode", ["path", "nee"])
def test_render_diff_matches_jax_on_sphere_on_plane(mode):
    check_render_diff("sphere_on_plane", mode)
