"""The port's NEE gradients on the Cornell box against jax.grad: the
check and bars of tests/test_torch_diff.py, in mode nee (measured: 38 of
256 pixels differ by the float32 knife edge and are masked; every other
field within 6.3e-4 of JAX's, the light's albedo and tint rows left out).
"""

from test_torch_diff import check_gradients
from test_torch_wavefront import one_torch_thread  # noqa: F401 (a fixture)


def test_nee_gradients_match_jax_grad():
    check_gradients("cornell_box", "nee", True)
