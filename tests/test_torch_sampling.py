"""The port's Sobol pipeline and Sobol root word against cornelis_tpu, bit for bit.

Every function of `cornelis_tpu_torch.sampling` is held against its
counterpart in `cornelis_tpu.sampling` on numpy-seeded uint32 words, half
of them at or above 2^31, where a product of two words no longer fits in
int64. Any difference, even one bit, would send a Sobol path elsewhere, so
the bar is equality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cornelis_tpu import sampling as js
from cornelis_tpu_torch import sampling as ts
from cornelis_tpu_torch.rng import DEFAULT_SEED, key_row

N = 4096


def _words(seed):
    """uint32 words: half uniform over [0, 2^32), half in [2^31, 2^32)."""
    rng = np.random.default_rng(seed)
    low = rng.integers(0, 1 << 32, size=N // 2, dtype=np.uint64)
    high = rng.integers(1 << 31, 1 << 32, size=N // 2, dtype=np.uint64)
    return np.concatenate([low, high, [0, 1, 2**31, 2**32 - 1]]).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _eq(ours, theirs):
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs).astype(np.int64))


def test_words_cover_the_high_half():
    w = _words(0)
    assert (w >= 2**31).mean() > 0.7 and (w < 2**31).any()


@pytest.mark.parametrize("fn", ["reverse_bits32", "hash32"])
def test_unary_functions_bitwise(fn):
    x = _words(1)
    _eq(getattr(ts, fn)(_t(x)), getattr(js, fn)(jnp.asarray(x)))


@pytest.mark.parametrize("fn", ["_laine_karras", "owen_scramble"])
def test_scrambles_bitwise(fn):
    x, seed = _words(2), _words(3)
    _eq(getattr(ts, fn)(_t(x), _t(seed)), getattr(js, fn)(jnp.asarray(x), jnp.asarray(seed)))


@pytest.mark.parametrize("bits", [1, 3, 11, 32])
def test_shuffle_index_bitwise(bits):
    idx = _words(4) >> np.uint32(32 - bits) if bits < 32 else _words(4)
    seed = _words(5)
    _eq(ts.shuffle_index(_t(idx), bits, _t(seed)), js.shuffle_index(jnp.asarray(idx), bits, jnp.asarray(seed)))


@pytest.mark.parametrize("bits", [1, 3, 11, 32])
def test_sobol2d_bits_bitwise(bits):
    idx = _words(6)
    for ours, theirs in zip(ts.sobol2d_bits(_t(idx), bits), js.sobol2d_bits(jnp.asarray(idx), bits)):
        _eq(ours, theirs)


def test_bits_to_unit_float_bitwise():
    x = _words(7)
    ours = ts.bits_to_unit_float(_t(x))
    assert ours.dtype == torch.float32
    np.testing.assert_array_equal(ours.numpy(), np.asarray(js.bits_to_unit_float(jnp.asarray(x))))


@pytest.mark.parametrize("bits", [1, 3, 11, 32])
@pytest.mark.parametrize("pair", [0, 1, 2, 3])
def test_sobol_pair_bitwise(bits, pair):
    rng = np.random.default_rng(bits * 4 + pair)
    seed = _words(8 + pair)
    sample = rng.integers(0, 1 << min(bits, 31), size=seed.size, dtype=np.int64).astype(np.uint32)
    stream = int(rng.integers(0, 65))
    ours = ts.sobol_pair(_t(seed), _t(sample), stream, pair, bits)
    theirs = js.sobol_pair(jnp.asarray(seed), jnp.asarray(sample), np.uint32(stream), pair, bits)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_sobol_pairs_overlap_across_streams():
    # Pairs 2 and 3 of stream s are pairs 0 and 1 of stream s + 1, in the
    # JAX package and so in the port (reproduced on purpose).
    seed, sample = _t(_words(12)), _t(_words(13) >> np.uint32(28))
    for p in (0, 1):
        for a, b in zip(ts.sobol_pair(seed, sample, 5, p + 2, 4), ts.sobol_pair(seed, sample, 6, p, 4)):
            assert torch.equal(a, b)


@pytest.mark.parametrize(
    "seed,root",
    [(0, 0xAC008A48), (1, 0xCDC02B1E), (DEFAULT_SEED, 0xE76EF33C), (2**32 - 1, 0x4ACE1326)],
)
def test_key_row_root_word(seed, root):
    key = jax.random.key(seed)
    expect = js.hash32(jax.random.bits(jax.random.fold_in(key, 0x50B0), (), jnp.uint32))
    k0, k1, ours = key_row(seed)
    assert ours == int(expect) == root
    assert (k0, k1) == tuple(int(v) for v in np.asarray(jax.random.key_data(key)))
