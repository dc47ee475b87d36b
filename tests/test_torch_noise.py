"""The port's wavelet noise (``mantaflow_tpu_torch/utils/noise.py``)
against the JAX package's ``utils/noise.py`` on the CPU.

- The generated tile and the file-loaded tile bit for bit, and the seed
  offset (the reference's MT19937 stream) bit for bit.
- Evaluation (value, gradient, curl; every knob) over the same tile at the
  same positions within 1e-6 x max(1, max|value|): XLA may contract the
  27-term weighted sum into FMAs on the CPU, PyTorch does not. The field
  is built from the tile array (``from_tiles``), so evaluation is held
  apart from generation.
"""

import numpy as np
import pytest
import torch

from mantaflow_tpu.core.domain import Domain as JDomain
from mantaflow_tpu.utils import noise as jn
from mantaflow_tpu_torch.core.domain import Domain
from mantaflow_tpu_torch.utils import noise as tn

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, ref, tol=1e-6):
    got = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got.astype(np.float64) - ref).max())
    assert err <= tol * scale, f"{err} > {tol} x {scale}"


def test_generated_tile_is_bitwise():
    """The generated tile (numpy on the host, the JAX package's filters and
    RandomState) and the seed offset, bit for bit."""
    jf = jn.WaveletNoiseField(fixed_seed=11)
    tf = tn.WaveletNoiseField(fixed_seed=11, device=CPU)
    jt = np.asarray(jf.tiles)
    assert tf.tiles.dtype == torch.float32
    np.testing.assert_array_equal(tf.tiles.numpy().view(np.uint32),
                                  jt.view(np.uint32))
    assert tuple(np.float32(c) for c in tf.seed_offset) == tuple(
        np.float32(c) for c in jf.seed_offset)
    # one tile per (seed, load_from_file) and process
    assert tn.WaveletNoiseField._tile_cache[(11, False)] is \
        tn.WaveletNoiseField(fixed_seed=11, device=CPU)._tile_cache[
            (11, False)]


@pytest.mark.parametrize("seed", [-1, 34894231])
def test_file_tile_and_seed_offset_are_bitwise(seed):
    """The file-loaded tile (tests/testdata_ref/waveletNoiseTile.bin, found
    by the same path rules) and the seed offset of the default and another
    seed; the domain's normalization."""
    dom, jdom = Domain(size=(40, 20, 10)), JDomain(size=(40, 20, 10))
    jf = jn.WaveletNoiseField(jdom, fixed_seed=seed, load_from_file=True)
    tf = tn.WaveletNoiseField(dom, fixed_seed=seed, load_from_file=True,
                              device=CPU)
    np.testing.assert_array_equal(tf.tiles.numpy(), np.asarray(jf.tiles))
    assert tn.WaveletNoiseField._load_tile_file() is not None
    assert tf.seed == jf.seed
    assert tuple(np.float32(c) for c in tf.seed_offset) == tuple(
        np.float32(c) for c in jf.seed_offset)
    assert tf.gs_inv == jf.gs_inv


def _fields(tile, dom, jdom, knobs):
    jf = jn.WaveletNoiseField(jdom, fixed_seed=7, load_from_file=True)
    jf.tiles = jf.tiles.at[:].set(tile)
    tf = tn.WaveletNoiseField.from_tiles(tile, dom, fixed_seed=7, device=CPU)
    for k, v in knobs.items():
        setattr(jf, k, v)
        setattr(tf, k, v)
    return jf, tf


KNOBS = [
    {},
    {"pos_scale": (45.0, 45.0, 45.0), "clamp": True, "clamp_neg": 0.0,
     "clamp_pos": 1.0, "val_offset": 0.75, "time_anim": 0.2},
    {"pos_scale": (75.0, 75.0, 75.0), "clamp": True, "clamp_neg": -1.0,
     "clamp_pos": 1.0, "val_scale": 0.3, "pos_offset": (1.5, -2.0, 0.25)},
]


@pytest.mark.parametrize("knobs", KNOBS, ids=["plain", "fire", "karman"])
@pytest.mark.parametrize("is3d", [True, False], ids=["3d", "2d"])
def test_evaluation_matches_reference(knobs, is3d):
    """evaluate, evaluate_vec of each tile and evaluate_curl on a seeded
    tile at seeded positions (negative and past the tile too), 1e-6."""
    rng = np.random.RandomState(3)
    tile = rng.standard_normal((3, 128, 128, 128)).astype(np.float32)
    size = (24, 20, 16) if is3d else (24, 20, 1)
    dom = Domain(size=size, dim=3 if is3d else 2)
    jdom = JDomain(size=size, dim=3 if is3d else 2)
    jf, tf = _fields(tile, dom, jdom, knobs)
    pos = rng.uniform(-30.0, 300.0, (3, 4000)).astype(np.float32)
    jp = [np.asarray(p) for p in pos]
    tp = [torch.from_numpy(p.copy()) for p in pos]
    for time in (0.0, 3.7):
        _close(tf.evaluate(*tp, time=time), jf.evaluate(*jp, time=time))
        for t in range(3):
            for got, ref in zip(tf.evaluate_vec(*tp, time=time, tile=t),
                                jf.evaluate_vec(*jp, time=time, tile=t)):
                _close(got, ref)
        for got, ref in zip(tf.evaluate_curl(*tp, time=time),
                            jf.evaluate_curl(*jp, time=time)):
            _close(got, ref)


def test_evaluation_on_grid_positions():
    """The (z, y, x) cell positions the scene ops pass (initops'
    densityInflow/addNoise) keep their shape."""
    rng = np.random.RandomState(5)
    tile = rng.standard_normal((3, 128, 128, 128)).astype(np.float32)
    dom, jdom = Domain(size=(16, 12, 8)), JDomain(size=(16, 12, 8))
    jf, tf = _fields(tile, dom, jdom, KNOBS[1])
    z, y, x = np.meshgrid(np.arange(8), np.arange(12), np.arange(16),
                          indexing="ij")
    pos = [a.astype(np.float32) for a in (x, y, z)]
    got = tf.evaluate(*[torch.from_numpy(p) for p in pos], time=1.2)
    assert got.shape == (8, 12, 16)
    _close(got, jf.evaluate(*pos, time=1.2))


def test_from_tiles_refuses_a_wrong_shape():
    with pytest.raises(ValueError):
        tn.WaveletNoiseField.from_tiles(np.zeros((3, 64, 64, 64)),
                                        device=CPU)
