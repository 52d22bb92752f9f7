"""The port's probes (K4, K5, K6) and the warm-up (K2) against cornelis_tpu.

The JAX probe kernels of `benchmarks/dynamic_scene_probe.py` (K5 baked,
K6 dynamic) and `benchmarks/bf16_probe.py` (K4) run here in Pallas
interpret mode: `jax.experimental.pallas.pallas_call` is patched with
interpret=True inside the test, and nothing in the JAX package changes.
The port's plain versions take the same input (which the port builds as
jnp.linspace builds it).

Bars, and why: K4 in float32 and in bfloat16 bit for bit (measured:
equal). K5 and K6: the same entries finite, the finite ones within
rtol 1e-4 (measured: 3.1e-5 at most, 98.8-99.1% bitwise equal). XLA
contracts the scan's products and sums into FMAs where torch rounds each
one, and t0 = -b - sqrt(disc) cancels, which magnifies those ulps.
"""

import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from cornelis_tpu_torch.ops import warm
from cornelis_tpu_torch.probes import bf16 as tb
from cornelis_tpu_torch.probes import scene_table as st

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_OBJ = 8


@pytest.fixture
def probes(monkeypatch):
    """The JAX probe modules, their pallas_call in interpret mode."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.syspath_prepend(os.path.join(REPO, "benchmarks"))
    import bf16_probe
    import dynamic_scene_probe

    return dynamic_scene_probe, bf16_probe


def test_probe_constants_and_inputs_equal_jax(probes):
    dsp, _ = probes
    assert st.consts(N_OBJ) == dsp._consts(N_OBJ)
    np.testing.assert_array_equal(st.table(N_OBJ).numpy(), np.asarray(dsp._consts(N_OBJ), np.float32))
    n = st.SHAPE[0] * st.SHAPE[1]
    np.testing.assert_array_equal(
        st.probe_input().numpy(),
        np.asarray(jnp.linspace(0.0, 24.0, n, dtype=jnp.float32)).reshape(st.SHAPE),
    )
    n = tb.SHAPE[0] * tb.SHAPE[1]
    np.testing.assert_array_equal(
        tb.probe_input().numpy(), np.asarray(jnp.linspace(0.0, 4.0, n)).reshape(tb.SHAPE)
    )


@pytest.mark.parametrize("kind", ["baked", "dynamic"])
def test_scan_probe_matches_jax(probes, kind):
    dsp, _ = probes
    build = dsp.build_baked if kind == "baked" else dsp.build_dynamic
    run, shape, tab = build(N_OBJ)
    assert shape == st.SHAPE
    o = st.probe_input()
    args = (jnp.asarray(o.numpy()),) if tab is None else (tab, jnp.asarray(o.numpy()))
    want = np.asarray(run(*args))
    if kind == "baked":
        got = st.scan_baked(o, N_OBJ).numpy()
    else:
        got = st.scan_dynamic(o, st.table(N_OBJ)).numpy()
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    assert 0.01 < fin.mean() < 0.5
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quad_probe_matches_jax(probes, dtype):
    _, bp = probes
    run, shape = bp.build(getattr(jnp, dtype))
    assert shape == tb.SHAPE
    x = tb.probe_input(getattr(torch, dtype))
    want = np.asarray(run(jnp.asarray(x.float().numpy()).astype(getattr(jnp, dtype))).astype(jnp.float32))
    got = tb.quad_probe(x)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_baked_and_dynamic_differ_only_in_r_squared():
    # K5 squares r in double (a literal), K6 in float32: where they differ,
    # only that rounding moved the root.
    o = st.probe_input()
    baked, dynamic = st.scan_baked(o, N_OBJ), st.scan_dynamic(o, st.table(N_OBJ))
    fin = torch.isfinite(baked)
    assert torch.equal(fin, torch.isfinite(dynamic))
    torch.testing.assert_close(baked[fin], dynamic[fin], rtol=1e-4, atol=0.0)
    assert not torch.equal(baked, dynamic)


def test_cpu_probes_launch_nothing_and_cli_needs_a_card(monkeypatch, capsys):
    before = (dict(st.LAUNCHES), dict(tb.LAUNCHES))
    st.scan_baked(st.probe_input(), 3)  # any count: the plain version
    tb.quad_probe(tb.probe_input(torch.bfloat16)[:4].contiguous())
    assert (st.LAUNCHES, tb.LAUNCHES) == before
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert st.main([]) == 1 and tb.main() == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_probe_wrappers_check_their_inputs():
    with pytest.raises(ValueError):
        st.scan_baked(st.probe_input().double())
    with pytest.raises(ValueError):
        st.scan_dynamic(st.probe_input(), st.table(N_OBJ)[:, :3])
    with pytest.raises(ValueError):
        tb.quad_probe(tb.probe_input().half())


def test_zero_block_plain_version_and_warm_needs_cuda():
    before = warm.LAUNCHES
    z = warm.zero_block("cpu")
    assert warm.LAUNCHES == before
    assert torch.equal(z, torch.zeros((8, 128))) and z.dtype == torch.float32
    with pytest.raises(ValueError):
        warm.warm_kernels("cpu")

