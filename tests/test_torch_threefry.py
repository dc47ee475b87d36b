"""The port's copy of JAX's PRNG (``mantaflow_tpu_torch/utils/
threefry.py``) against ``jax.random`` on the CPU, bit for bit.

The stream is threefry-2x32 with ``jax_threefry_partitionable`` on (JAX
0.9.0's default). The flag's value is asserted, so that a JAX upgrade that
changes it fails here instead of drifting the whitewater and surface
turbulence parity tests.
"""

import jax
import numpy as np
import pytest
import torch

from mantaflow_tpu_torch.utils import threefry as tf


def test_jax_threefry_is_partitionable():
    assert jax.__version__ == "0.9.0"
    assert jax.config.jax_threefry_partitionable is True


def _bits(a):
    return np.asarray(a).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1, 1234, 9832, 2 ** 31 - 1])
def test_key_and_split_are_bitwise(seed):
    k, tk = jax.random.PRNGKey(seed), tf.PRNGKey(seed)
    np.testing.assert_array_equal(tk.numpy(), _bits(k))
    for num in (2, 6):
        np.testing.assert_array_equal(tf.split(tk, num).numpy(),
                                      _bits(jax.random.split(k, num)))


# the draws of the JAX package's whitewater (ops/whitewater.py:147-222:
# (n_cyl, n, 3) per-cell offsets and the (ncand,) cylinder draws, 'single'
# and 'multiple' modes at 16^3) and surface turbulence
# (ops/surfaceturbulence.py:114-116: (2, n, 3)) at the tests' sizes
SHAPES = [(1, 4096, 3), (1 * 4 * 4096,), (8 * 4 * 4096,), (2, 4096, 3),
          (2, 13824, 3), (7,), (1,)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("seed", [9832, 1234])
def test_uniform_is_bitwise(shape, seed):
    """uniform of a split key and of the key itself, as the call sites
    draw them."""
    k, tk = jax.random.PRNGKey(seed), tf.PRNGKey(seed)
    ks, tks = jax.random.split(k, 6), tf.split(tk, 6)
    for jkey, tkey in ((ks[0], tks[0]), (ks[4], tks[4]), (k, tk)):
        ref = np.asarray(jax.random.uniform(jkey, shape, np.float32))
        got = tf.uniform(tkey, shape)
        assert got.dtype == torch.float32 and tuple(got.shape) == shape
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      ref.view(np.uint32))
        assert float(got.min()) >= 0.0 and float(got.max()) < 1.0


def test_random_bits_match_reference():
    k, tk = jax.random.PRNGKey(42), tf.PRNGKey(42)
    ref = np.asarray(jax.random.bits(k, (5, 33), np.uint32)).astype(np.int64)
    np.testing.assert_array_equal(tf.random_bits(tk, (5, 33)).numpy(), ref)


def test_refusals():
    with pytest.raises(ValueError):
        tf.PRNGKey(2 ** 31)
    with pytest.raises(ValueError):
        tf.uniform(tf.PRNGKey(0), (3,), torch.float64)
