"""The port's Threefry, key words and hemisphere sampling against cornelis_tpu.

Draws must be bit-identical to the JAX megakernel's, or no ray of the two
renderers could be compared: the cipher is checked on the Random123
known-answer vectors and bitwise against both cornelis_tpu's threefry and
jax's own, and the seed -> key-word step against jax.random.key_data.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cornelis_tpu import rng as jrng
from cornelis_tpu.math.vec import Vec3 as JVec3
from cornelis_tpu.math.vec import construct_basis as jconstruct_basis
from cornelis_tpu.ops import threefry as jtf
from cornelis_tpu_torch import rng as trng
from cornelis_tpu_torch.math.vec import Vec3, construct_basis
from cornelis_tpu_torch.ops import threefry as ttf

ORACLE = os.path.join(os.path.dirname(__file__), "golden", "oracle")


def _t(a):
    return torch.as_tensor(np.asarray(a, np.int64))


def _u32(rng, n):
    return rng.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize(
    "key,ctr,expect",
    [
        # Random123 kat_vectors, threefry2x32 with 20 rounds: zero, ones, pi digits.
        ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
        ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF), (0x1CB996FC, 0xBB002BE7)),
        ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3), (0xC4923A9C, 0x483DF7A0)),
    ],
)
def test_threefry_known_answers(key, ctr, expect):
    x0, x1 = ttf.threefry2x32(key[0], key[1], _t([ctr[0]]), _t([ctr[1]]))
    assert (int(x0[0]), int(x1[0])) == expect


def test_threefry_bitwise_equal_to_jax():
    from jax._src.prng import threefry_2x32

    k0, k1, c0, c1 = (_u32(np.random.default_rng(1), 4096) for _ in range(4))
    ours = ttf.threefry2x32(_t(k0), _t(k1), _t(c0), _t(c1))
    theirs = threefry_2x32(jnp.stack([k0, k1]), jnp.stack([c0, c1]))
    for o, t in zip(ours, theirs):
        np.testing.assert_array_equal(o.numpy(), np.asarray(t).astype(np.int64))


@pytest.mark.parametrize("stream,pair", [(0, 0), (1, 0), (1, 1), (17, 1), (64, 0)])
def test_pair_uniforms_bitwise_equal(stream, pair):
    # The exact draws of the megakernel: any difference, even one ulp,
    # would send a path elsewhere.
    rng = np.random.default_rng(stream * 7 + pair)
    k0, k1 = (int(v) for v in _u32(rng, 2))
    pixel = _u32(rng, 2048)
    sample = rng.integers(0, 1 << 24, size=2048).astype(np.uint32)
    j = jtf.pair_uniforms(
        jnp.uint32(k0), jnp.uint32(k1), jnp.asarray(pixel), jnp.asarray(sample),
        np.uint32(stream), pair,
    )
    t = ttf.pair_uniforms(k0, k1, _t(pixel), _t(sample), stream, pair)
    for a, b in zip(t, j):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_to_unit_float_quantization():
    bits = _t([0, 0xFF, 0x100, 0xFFFFFFFF])
    f = ttf.to_unit_float(bits).numpy()
    np.testing.assert_array_equal(
        f, np.float32([0.0, 0.0, 2.0**-24, (2**24 - 1) / 2**24])
    )


@pytest.mark.parametrize("seed", [0, 1, 7, trng.DEFAULT_SEED, 2**31 - 1, 2**31 + 5, 2**32 - 1])
def test_key_words_equal_jax_key_data(seed):
    expect = np.asarray(jax.random.key_data(jax.random.key(seed))).astype(np.int64)
    assert trng.key_words(seed) == tuple(int(v) for v in expect)


@pytest.mark.parametrize("seed", [-1, 2**32, 2**40])
def test_key_words_reject_unpinned_seeds(seed):
    with pytest.raises(ValueError):
        trng.key_words(seed)


def _unit_vectors(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def test_hemisphere_sample_basis_matches_jax():
    rng = np.random.default_rng(3)
    x1, x2 = rng.random((2, 1024), dtype=np.float32)
    n = _unit_vectors(rng, 1024)
    t = trng.hemisphere_sample_basis(
        torch.from_numpy(x1), torch.from_numpy(x2),
        construct_basis(Vec3(*(torch.from_numpy(c) for c in n.T))),
    )
    j = jrng.hemisphere_sample_basis(
        jnp.asarray(x1), jnp.asarray(x2), jconstruct_basis(JVec3(*(jnp.asarray(c) for c in n.T)))
    )
    # Same float32 expressions; sin/cos come from different libraries
    # (SLEEF in torch, XLA's own on the CPU), a few ulps apart.
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    assert trng.hemisphere_pdf() == jrng.hemisphere_pdf()


def test_hemisphere_sample_matches_oracle():
    r = np.fromfile(os.path.join(ORACLE, "hemisphere.f32"), np.float32).reshape(-1, 11)
    x1, x2 = torch.from_numpy(r[:, 0].copy()), torch.from_numpy(r[:, 1].copy())
    v = trng.hemisphere_sample(x1, x2)
    basis = construct_basis(Vec3(*(torch.from_numpy(r[:, k].copy()) for k in (2, 3, 4))))
    w = trng.hemisphere_sample_basis(x1, x2, basis)
    # The reference binary's own values; tolerance as tests/test_oracle.py.
    for got, col in zip(list(v) + list(w), range(5, 11)):
        np.testing.assert_allclose(got.numpy(), r[:, col], rtol=1e-4, atol=1e-5)


# -- The wavefront's draws: jax.random under partitionable Threefry ---------

SEEDS = [0, 9, trng.DEFAULT_SEED, 2**32 - 1]


def _key_data(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_split_bits_uniform_bitwise_equal_to_jax(seed):
    k, tk = jax.random.key(seed), trng.make_key(seed)
    for data in (0, 1, 77, 0x50B0, 2**32 - 1):
        np.testing.assert_array_equal(trng.fold_in(tk, data).numpy(),
                                      _key_data(jax.random.fold_in(k, data)))
    for num in (2, 5):
        np.testing.assert_array_equal(trng.split(tk, num).numpy(),
                                      _key_data(jax.random.split(k, num)))
    np.testing.assert_array_equal(trng.bits(tk, 7).numpy(),
                                  np.asarray(jax.random.bits(k, (7,), jnp.uint32)).astype(np.int64))
    u = trng.uniform(tk, 9)
    assert u.dtype == torch.float32
    np.testing.assert_array_equal(u.numpy(), np.asarray(jax.random.uniform(k, (9,))))


def test_uniform_mantissa_fill_edges():
    # jax.random.uniform's float: 23 random mantissa bits under 1.0f, minus 1.
    words = _t([0, 0x1FF, 0x200, 0xFFFFFFFF])
    np.testing.assert_array_equal(
        trng.bits_to_uniform(words).numpy(),
        np.float32([0.0, 0.0, 2.0**-23, 1.0 - 2.0**-23]),
    )


@pytest.mark.parametrize("seed", SEEDS)
def test_inverse_renderer_step_keys_equal_jax(seed):
    # InverseRenderer's step key fold_in(root, step) and the "dual" split.
    k, tk = jax.random.key(seed), trng.make_key(seed)
    for step in (0, 1, 2, 249):
        jstep, tstep = jax.random.fold_in(k, step), trng.fold_in(tk, step)
        np.testing.assert_array_equal(tstep.numpy(), _key_data(jstep))
        np.testing.assert_array_equal(trng.split(tstep).numpy(), _key_data(jax.random.split(jstep)))


@pytest.mark.parametrize("seed", SEEDS)
def test_ray_streams_and_stream_uniforms_bitwise_equal_to_jax(seed):
    rng = np.random.default_rng(seed % 1000)
    pixel = rng.integers(0, 1 << 21, 512).astype(np.uint32)
    sample = rng.integers(0, 64, 512).astype(np.uint32)
    js = jrng.make_ray_streams(jax.random.key(seed), jnp.asarray(pixel), jnp.asarray(sample), 64)
    ts = trng.make_ray_streams(trng.make_key(seed), _t(pixel), _t(sample))
    np.testing.assert_array_equal(ts.key.numpy(), _key_data(js.key))
    np.testing.assert_array_equal(ts.pixel_seed.numpy(), np.asarray(js.pixel_seed).astype(np.int64))
    np.testing.assert_array_equal(ts.sample_idx.numpy(), sample.astype(np.int64))
    for sampler in ("uniform", "sobol"):
        for stream, num in ((0, 2), (1, 4), (5, 8), (17, 7)):
            got = trng.stream_uniforms(ts, stream, num, sampler, index_bits=6)
            want = jrng.stream_uniforms(js, stream, num, sampler, index_bits=6)
            assert got.shape == (512, num) and got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_stream_uniforms_rejects_unknown_sampler():
    ts = trng.make_ray_streams(trng.make_key(1), _t([0]), _t([0]))
    with pytest.raises(ValueError, match="unknown sampler"):
        trng.stream_uniforms(ts, 0, 2, "halton")


# Edge ids of a (pixel, sample) pair: the draws kernel (ops/csrc/draws.cu)
# reads the low 32 bits of each int64 word, and is held to this torch code
# on the card.
EDGE_IDS = [0, 1, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1]


@pytest.mark.parametrize("stream", [0, 1, 17, 64])
@pytest.mark.parametrize("num", [2, 4, 7, 8])
def test_uniform_draws_at_edge_ids_bitwise_equal_to_jax(num, stream):
    seed = num * 100 + stream
    rng = np.random.default_rng(seed)
    pixel, sample = (np.array(v, np.uint32).ravel() for v in np.meshgrid(EDGE_IDS, EDGE_IDS))
    pixel = np.concatenate([pixel, _u32(rng, 64)])
    sample = np.concatenate([sample, _u32(rng, 64)])
    js = jrng.make_ray_streams(jax.random.key(seed), jnp.asarray(pixel), jnp.asarray(sample), 64)
    ts = trng.make_ray_streams(trng.make_key(seed), _t(pixel), _t(sample))
    np.testing.assert_array_equal(ts.key.numpy(), _key_data(js.key))
    np.testing.assert_array_equal(ts.pixel_seed.numpy(), np.asarray(js.pixel_seed).astype(np.int64))
    got = trng.stream_uniforms(ts, stream, num)
    assert got.shape == (len(pixel), num) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jrng.stream_uniforms(js, stream, num)))


def test_cpu_draws_launch_no_kernel():
    from cornelis_tpu_torch.ops import draws

    before = dict(draws.LAUNCHES)
    ts = trng.make_ray_streams(trng.make_key(3), _t(np.arange(64)), _t(np.arange(64) % 4))
    for num in (2, 4, 8):
        trng.stream_uniforms(ts, 1, num)
    assert draws.LAUNCHES == before


def _draw_args(**change):
    keys = torch.zeros((4, 2), dtype=torch.int64)
    args = dict(keys=keys, stream=1, num=4)
    args.update(change)
    return args


@pytest.mark.parametrize("change,match", [
    (dict(keys=torch.zeros((4, 2), dtype=torch.int32)), "int64"),
    (dict(keys=torch.zeros((4, 3), dtype=torch.int64)), "shape"),
    (dict(keys=torch.zeros(8, dtype=torch.int64)), "shape"),
    (dict(keys=torch.zeros((2, 4), dtype=torch.int64).t()), "contiguous"),
    (dict(num=0), "num"),
    ({}, "one CUDA device"),
])
def test_draws_stream_uniforms_checks_its_arguments(change, match):
    from cornelis_tpu_torch.ops import draws

    with pytest.raises(ValueError, match=match):
        draws.stream_uniforms(**_draw_args(**change))


@pytest.mark.parametrize("change,match", [
    (dict(root=torch.zeros(3, dtype=torch.int64)), "root must have shape"),
    (dict(pixel_ids=torch.zeros((4, 1), dtype=torch.int64)), "pixel_ids must have shape"),
    (dict(sample_idx=torch.zeros(5, dtype=torch.int64)), "sample_idx must have shape"),
    (dict(sample_idx=torch.zeros(4, dtype=torch.int32)), "int64"),
    (dict(pixel_ids=torch.zeros(8, dtype=torch.int64)[::2]), "contiguous"),
    ({}, "one CUDA device"),
])
def test_draws_ray_streams_checks_its_arguments(change, match):
    from cornelis_tpu_torch.ops import draws

    args = dict(root=torch.zeros(2, dtype=torch.int64), pixel_ids=torch.zeros(4, dtype=torch.int64),
                sample_idx=torch.zeros(4, dtype=torch.int64))
    args.update(change)
    with pytest.raises(ValueError, match=match):
        draws.ray_streams(**args)
