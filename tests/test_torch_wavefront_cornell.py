"""The port's torch wavefront on the Cornell box against cornelis_tpu's.

cornell_box through `integrator.render_chunk` in every mode x sampler and
through `render_diff` in both modes, with the bars of
tests/test_torch_wavefront.py: per ray at least 99%, in mode nee 90%
(measured, seed 19791102: path 99.22-100%, nee 93.75-97.27%: the float32
knife edge of ROADMAP §C), per pixel of render_diff 99%, in mode nee 85%
(measured 89.06%), channel means within 1% (measured: 8.5e-4).
"""

import pytest

from test_torch_wavefront import (  # noqa: F401 (a fixture)
    VARIANTS,
    check_render_chunk,
    check_render_diff,
    one_torch_thread,
)


@pytest.mark.parametrize("mode,sampler", VARIANTS)
def test_render_chunk_matches_jax_on_cornell_box(mode, sampler):
    check_render_chunk("cornell_box", mode, sampler)


@pytest.mark.parametrize("mode", ["path", "nee"])
def test_render_diff_matches_jax_on_cornell_box(mode):
    check_render_diff("cornell_box", mode)
