"""The port's threefry (``repro_torch.prng``) against ``jax.random``, and
``SyntheticLM`` batches against the reference's, bit for bit.

The port follows jax with ``jax_threefry_partitionable`` on (jax's default
since 0.5); the ``partitionable`` fixture pins it for each test and puts
the old value back, so the tests hold under a jax that defaults it off.
"""

import jax
import numpy as np
import pytest
import torch

from repro.data.synthetic import SyntheticLM as JSyntheticLM
from repro_torch import prng
from repro_torch.data import SyntheticLM

SEEDS = [0, 1, 2 ** 32 + 5, -1, 123456789]


@pytest.fixture(autouse=True)
def partitionable():
    was = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", was)


def _data(k):
    return np.asarray(jax.random.key_data(k))


def test_threefry2x32_known_answer():
    """The Threefry-2x32 (20 rounds) test vector of the Random123 suite,
    which jax's own tests check too."""
    y1, y2 = prng.threefry2x32(torch.tensor(0x13198A2E),
                               torch.tensor(0x03707344),
                               torch.tensor(0x243F6A88),
                               torch.tensor(0x85A308D3))
    assert (int(y1), int(y2)) == (0xC4923A9C, 0x483DF7A0)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_equals_jax(seed):
    np.testing.assert_array_equal(prng.key(seed).numpy(),
                                  _data(jax.random.key(seed)))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_x64_equals_jax_under_x64(seed):
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        want = _data(jax.random.key(seed))
    finally:
        jax.config.update("jax_enable_x64", was)
    np.testing.assert_array_equal(prng.key(seed, x64=True).numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("data", [0, 3, 2 ** 31 + 7, 2 ** 32 - 1])
def test_fold_in_equals_jax(seed, data):
    np.testing.assert_array_equal(
        prng.fold_in(prng.key(seed), data).numpy(),
        _data(jax.random.fold_in(jax.random.key(seed), data)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [2, 3, 7])
def test_split_equals_jax(seed, num):
    np.testing.assert_array_equal(
        prng.split(prng.key(seed), num).numpy(),
        _data(jax.random.split(jax.random.key(seed), num)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape,lo,hi", [
    ((5,), 0, 10),
    ((3, 7), 0, 4),                 # a power-of-two span
    ((33,), -5, 1000003),           # odd size, a large odd span
    ((4, 5), 0, 2 ** 31 - 1),       # the multiplier wraps in uint32
    ((6,), -2 ** 31, 2 ** 31 - 1),  # the widest int32 span
    ((2, 2), 3, 3),                 # an empty span returns minval
])
def test_randint_equals_jax(seed, shape, lo, hi):
    k = jax.random.split(jax.random.key(seed))[1]
    want = np.asarray(jax.random.randint(k, shape, lo, hi))
    got = prng.randint(torch.from_numpy(_data(k).astype(np.int64)), shape,
                       lo, hi)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_randint_refuses_bounds_outside_int32():
    with pytest.raises(ValueError, match="int32 bounds"):
        prng.randint(prng.key(0), (2,), 0, 2 ** 31)


@pytest.mark.parametrize("seed,step,batch,seq_len,vocab", [
    (0, 0, 4, 100, 64),
    (3, 7, 2, 33, 1000),
    (1, 123, 1, 1, 5),
    (2 ** 32 + 5, 1, 3, 17, 49155),
    (7, 2 ** 20, 8, 64, 128),
])
def test_synthetic_batch_equals_the_reference(seed, step, batch, seq_len,
                                              vocab):
    want = JSyntheticLM(vocab_size=vocab, seq_len=seq_len,
                        seed=seed).batch(step, batch)
    got = SyntheticLM(vocab_size=vocab, seq_len=seq_len,
                      seed=seed).batch(step, batch)
    for name in ("tokens", "targets", "loss_mask"):
        assert got[name].dtype == (torch.float32 if name == "loss_mask"
                                   else torch.int32)
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))
