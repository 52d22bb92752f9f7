"""The port's gradients on sphere_on_plane against jax.grad: the check of
tests/test_torch_diff.py in modes path and nee, on the whole image (no
pixel differs; measured: every field within 7.0e-4 of JAX's).
"""

import pytest

from test_torch_diff import check_gradients
from test_torch_wavefront import one_torch_thread  # noqa: F401 (a fixture)


@pytest.mark.parametrize("mode", ["path", "nee"])
def test_gradients_match_jax_grad_on_sphere_on_plane(mode):
    check_gradients("sphere_on_plane", mode, True)
