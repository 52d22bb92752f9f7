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
one, and t0 = -b - sqrt(disc) cancels, which magnifies those ulps. On
the special lanes (`scene_table.special_lanes`: NaN, infinities, zeros,
huge origins, origins inside a sphere, grazing rays) the same bar holds
but for the grazing lanes. There disc is 0 to within its rounding, so
the FMAs may move its sign and a lane may be finite on one side only;
where both are finite the root is within rtol 1e-3, as the sqrt of a
disc of rounding size is about 1e-3 of b (measured: 4.2e-4 at most, 3
lanes finite on one side).

The kernels drop jnp.maximum's and jnp.minimum's NaN tests as dead (the
proof is in ops/csrc/probes.cu): the plain versions, which keep them,
equal bit for bit a numpy copy of the scan body with np.fmax and np.fmin,
which do not propagate NaN, on the special lanes.
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
from cornelis_tpu_torch.probes import scan_designs as sd
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


@pytest.mark.parametrize("kind", ["baked", "dynamic"])
def test_scan_probe_special_lanes_match_jax(probes, kind):
    dsp, _ = probes
    build = dsp.build_baked if kind == "baked" else dsp.build_dynamic
    run, _, tab = build(N_OBJ)
    o = st.special_input()
    args = (jnp.asarray(o.numpy()),) if tab is None else (tab, jnp.asarray(o.numpy()))
    want = np.asarray(run(*args)).ravel()
    got = (st.scan_baked(o, N_OBJ) if kind == "baked" else st.scan_dynamic(o, st.table(N_OBJ)))
    got = got.numpy().ravel()
    lanes = st.special_lanes()
    assert not np.isnan(want).any() and not np.isnan(got).any()
    grazing = np.zeros(got.size, bool)
    start = lanes["extreme"].size + lanes["inside"].size
    grazing[start:start + lanes["grazing"].size] = True
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got)[~grazing], fin[~grazing])
    np.testing.assert_allclose(got[~grazing & fin], want[~grazing & fin], rtol=1e-4)
    both = grazing & fin & np.isfinite(got)
    assert both.sum() >= 4  # some of sphere 0's tangent rays hit it on both sides
    np.testing.assert_allclose(got[both], want[both], rtol=1e-3)


def _fmin_fmax_scan(o: torch.Tensor, spheres) -> np.ndarray:
    """The scan body in numpy with np.fmax and np.fmin, which do not
    propagate NaN; the sqrt is torch's on the same shape, as in the plain
    versions (torch's CPU sqrt is not always correctly rounded)."""
    f = np.float32
    ox = o.numpy()
    oy, oz = ox * f(0.5), ox * f(0.25)
    best = np.full_like(ox, np.inf)
    with np.errstate(all="ignore"):
        for cx, cy, cz, rr in spheres:
            rx, ry, rz = ox - f(cx), oy - f(cy), oz - f(cz)
            b = rx * f(st.D[0]) + ry * f(st.D[1]) + rz * f(st.D[2])
            c = rx * rx + ry * ry + rz * rz - f(rr)
            disc = b * b - c
            shift = torch.sqrt(torch.from_numpy(np.fmax(disc, f(1e-12)))).numpy()
            t0 = -b - shift
            best = np.fmin(best, np.where((disc >= 0) & (t0 > f(1e-3)), t0, f(np.inf)))
    return best


@pytest.mark.parametrize("n_obj", st.BAKED_COUNTS)
def test_scan_nan_tests_are_dead(n_obj):
    o = st.special_input()
    tab = st.table(n_obj)
    baked = [(cx, cy, cz, r * r) for cx, cy, cz, r in st.consts(n_obj)]
    dynamic = [(cx, cy, cz, r * r) for cx, cy, cz, r in tab.numpy()]  # float32 r * r
    for plain, spheres in ((st.scan_baked_reference(o, n_obj), baked),
                           (st.scan_dynamic_reference(o, tab), dynamic)):
        np.testing.assert_array_equal(plain.numpy().view(np.int32),
                                      _fmin_fmax_scan(o, spheres).view(np.int32))


def test_special_lanes_reach_every_case():
    lanes = st.special_lanes()
    o = st.special_input().ravel()
    flat = np.concatenate(list(lanes.values()))
    np.testing.assert_array_equal(o[: flat.size].numpy().view(np.int32), flat.view(np.int32))
    assert np.isnan(lanes["extreme"]).sum() == 1 and np.isinf(lanes["extreme"]).sum() == 2
    assert lanes["inside"].size >= 2  # spheres 0 and 84
    assert lanes["grazing"].size >= 2 * (2 * st.GRAZE_ULPS + 1)
    # Each grazing lane's ray is tangent to some sphere: its disc is within
    # rounding of 0 against the nearest sphere.
    u, d = np.array([1.0, 0.5, 0.25]), np.array(st.D)
    spheres = np.asarray(st.consts(st.DEFAULT_N))
    for x in lanes["grazing"].astype(np.float64):
        rel = x * u - spheres[:, :3]
        b, c = rel @ d, (rel * rel).sum(1) - spheres[:, 3] ** 2
        assert np.abs(b * b - c).min() < 1e-4 * (1.0 + (b * b).max())


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


@pytest.mark.parametrize("spec", sd.DESIGNS, ids=lambda spec: sd.design_name(*spec))
def test_scan_design_sources(spec):
    # Each design's source: probes.cu with its body's substitutions made
    # and every placeholder of its C entry filled.
    src = sd.design_source(*spec)
    assert "@" not in src and 'extern "C" int design(' in src
    assert ("sqrt_disc(fmaxf" in src) == (spec[4] == "plain")
    assert ("best != best" in src) == (spec[4] == "nan-tests")
    kernel = "scan_baked_design<512, " if spec[0] == "baked" else "scan_dynamic<"
    assert f"const auto kernel = {kernel}{spec[1]}, {spec[2]}, {spec[3]}>;" in src


def test_scan_designs_need_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert sd.main() == 1
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

