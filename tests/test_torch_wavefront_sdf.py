"""The port's torch wavefront on the SDF scene against cornelis_tpu's.

sdf_gallery (a torus, a box and an SDF sphere on a plane under a sphere
light) through `integrator.render_chunk` in mode path, both samplers,
and through `render_diff` in mode path (mode nee is in
tests/test_torch_wavefront_sdf_nee.py), with the bars of
tests/test_torch_wavefront.py (measured, seed 19791102: 99.22-100% of
rays per chunk, channel means within 7.7e-6; render_diff 100% of pixels).
The march is the JAX one, 128 steps with no limit; the port stops it
once every ray is done, which changes no t.
"""

import pytest

from test_torch_wavefront import (  # noqa: F401 (a fixture)
    VARIANTS,
    check_render_chunk,
    check_render_diff,
    one_torch_thread,
)

MODE = "path"


@pytest.mark.parametrize("mode,sampler", [v for v in VARIANTS if v[0] == MODE])
def test_render_chunk_matches_jax_on_sdf_gallery(mode, sampler):
    check_render_chunk("sdf_gallery", mode, sampler)


def test_render_diff_matches_jax_on_sdf_gallery():
    check_render_diff("sdf_gallery", MODE)
