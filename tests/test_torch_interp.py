"""Interpolation of mantaflow_tpu_torch vs mantaflow_tpu (core/interp.py).

Every lookup, table form and scatter of the module, in 3D and 2D, on grids
and positions made from a numpy seed: positions below 0, inside, at and
beyond n - 1 on every axis (the border clamping of BUILD_INDEX). The JAX
package builds rolled row tables; the port reads the same values through
``RolledTable`` views, so the table rows are compared exactly. Values
agree to abs 1e-6 (the same float32 terms, summed in the same order where
the JAX package fixes the order; XLA may contract a product and a sum into
a fused multiply-add).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mantaflow_tpu.core import interp as ji
from mantaflow_tpu_torch.core import interp as ti

# [z, y, x] grid shapes
SHAPES = {"3d": (6, 7, 9), "2d": (1, 8, 11)}
TOL = 1e-6


def _positions(shape, n=400, seed=0):
    """(3, n) positions in (x, y, z): random over [-1.5, size + 0.5), and
    the edge values -0.25, 0, 0.5, n - 1, n - 1 + 1e-3 and n on each
    axis."""
    sz, sy, sx = shape
    rng = np.random.default_rng(seed)
    cols = []
    for size in (sx, sy, sz):
        v = rng.uniform(-1.5, size + 0.5, n)
        edges = np.array([-0.25, 0.0, 0.5, size - 1.0, size - 1.0 + 1e-3,
                          float(size), size - 0.5])
        v[:len(edges)] = edges
        v[len(edges):2 * len(edges)] = np.roll(edges, 3)
        cols.append(v)
    pos = np.stack(cols).astype(np.float32)
    if sz == 1:
        pos[2] = 0.5
    return pos


def _grid(shape, seed=1, lead=()):
    return np.random.default_rng(seed).uniform(
        -1.0, 1.0, lead + shape).astype(np.float32)


def _both(pos):
    return ([jnp.asarray(p) for p in pos], [torch.from_numpy(p) for p in pos])


def _close(got, ref, tol=TOL):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=tol, rtol=0)


@pytest.mark.parametrize("dim", sorted(SHAPES))
def test_axis_weights_match_reference(dim):
    pos = _positions(SHAPES[dim])
    for p, n in zip(pos, SHAPES[dim][::-1]):
        for shift in (0.0, 0.5):
            for clamp_hi in (True, False):
                ri, rw = ji._axis_weights(jnp.asarray(p - shift), n, clamp_hi)
                gi, gw = ti._axis_weights(torch.from_numpy(p - shift), n,
                                          clamp_hi)
                np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
                np.testing.assert_array_equal(gw.numpy(), np.asarray(rw))


@pytest.mark.parametrize("dim", sorted(SHAPES))
def test_interpol_and_component_match_reference(dim):
    shape = SHAPES[dim]
    data, mac = _grid(shape), _grid(shape, 2, (3,))
    jp, tp = _both(_positions(shape))
    _close(ti.interpol(torch.from_numpy(data), *tp),
           ji.interpol(jnp.asarray(data), *jp))
    for c in range(3):
        _close(ti.interpol_component(torch.from_numpy(mac), c, *tp),
               ji.interpol_component(jnp.asarray(mac), c, *jp))


@pytest.mark.parametrize("dim", sorted(SHAPES))
def test_interpol_mac_matches_reference(dim):
    shape = SHAPES[dim]
    mac = _grid(shape, 3, (3,))
    jp, tp = _both(_positions(shape))
    for g, r in zip(ti.interpol_mac(torch.from_numpy(mac), *tp),
                    ji.interpol_mac(jnp.asarray(mac), *jp)):
        _close(g, r)


@pytest.mark.parametrize("dim", sorted(SHAPES))
def test_corner_table_rows_match_reference(dim):
    """A RolledTable's rows equal the JAX package's table rows at every
    base a lookup can take, and at every other row."""
    shape = SHAPES[dim]
    data = _grid(shape, 4)
    ref = np.asarray(ji.build_corner_table(jnp.asarray(data)))
    base = torch.arange(ref.shape[0])
    got = ti.build_corner_table(torch.from_numpy(data)).rows(base)
    np.testing.assert_array_equal(got.T.numpy(), ref)


@pytest.mark.parametrize("dim", sorted(SHAPES))
def test_row_table_lookups_match_reference(dim):
    shape = SHAPES[dim]
    data, mac = _grid(shape, 5), _grid(shape, 6, (3,))
    pos = _positions(shape)
    jp, tp = _both(pos)
    _close(ti.interpol_fast(torch.from_numpy(data), *tp),
           ji.interpol_fast(jnp.asarray(data), *jp))
    _close(ti.interpol_rows(ti.build_corner_table(torch.from_numpy(data)),
                            shape, *tp),
           ji.interpol_rows(ji.build_corner_table(jnp.asarray(data)), shape,
                            *jp))
    tm, jm = torch.from_numpy(mac), jnp.asarray(mac)
    for tables in (False, True):
        got = ti.interpol_mac_fast(
            tm, *tp, tables=ti.mac_corner_tables(tm) if tables else None)
        ref = ji.interpol_mac_fast(
            jm, *jp, tables=ji.mac_corner_tables(jm) if tables else None)
        for g, r in zip(got, ref):
            _close(g, r)
    # the same values as the gathers of interpol_mac
    for g, r in zip(ti.interpol_mac_fast(tm, *tp), ti.interpol_mac(tm, *tp)):
        _close(g, r.numpy())


@pytest.mark.parametrize("dim", sorted(SHAPES))
def test_base_and_weights_match_reference(dim):
    shape = SHAPES[dim]
    jp, tp = _both(_positions(shape))
    rb, rw = ji._base_and_weights(shape, *jp)
    gb, gw = ti._base_and_weights(shape, *tp)
    np.testing.assert_array_equal(gb.numpy(), np.asarray(rb))
    np.testing.assert_array_equal(gw.numpy(), np.asarray(rw))


@pytest.mark.parametrize("dim", sorted(SHAPES))
@pytest.mark.parametrize("with_flags", [False, True])
def test_packed_mac_lookup_matches_reference(dim, with_flags):
    """interpol_mac_packed: the JAX package's (T, 24-44) pack against the
    port's rolled views, the containing cell's flag included."""
    shape = SHAPES[dim]
    mac = _grid(shape, 7, (3,))
    flags = np.random.default_rng(8).integers(0, 64, shape).astype(np.int32)
    jp, tp = _both(_positions(shape))
    jpack = ji.build_mac_pack(jnp.asarray(mac),
                              jnp.asarray(flags) if with_flags else None)
    tpack = ti.build_mac_pack(torch.from_numpy(mac),
                              torch.from_numpy(flags) if with_flags else None)
    ref = ji.interpol_mac_packed(jpack, shape, *jp, with_flags=with_flags)
    got = ti.interpol_mac_packed(tpack, shape, *tp, with_flags=with_flags)
    assert len(got) == len(ref) == (4 if with_flags else 3)
    for g, r in zip(got[:3], ref[:3]):
        _close(g, r)
    if with_flags:
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    # the same values as the gathers of interpol_mac
    for g, r in zip(got[:3], ti.interpol_mac(torch.from_numpy(mac), *tp)):
        _close(g, r.numpy())


@pytest.mark.parametrize("dim", sorted(SHAPES))
@pytest.mark.parametrize("order", [1, 2])
def test_cubic_and_hi_match_reference(dim, order):
    shape = SHAPES[dim]
    data = _grid(shape, 9)
    jp, tp = _both(_positions(shape))
    _close(ti.interpol_hi(torch.from_numpy(data), *tp, order_space=order),
           ji.interpol_hi(jnp.asarray(data), *jp, order_space=order))
    if order == 2:
        _close(ti.interpol_cubic(torch.from_numpy(data), *tp),
               ji.interpol_cubic(jnp.asarray(data), *jp))


@pytest.mark.parametrize("dim", sorted(SHAPES))
@pytest.mark.parametrize("with_values", [False, True])
def test_row_scatters_match_reference(dim, with_values):
    """scatter_rows and scatter_rows2, the inverse of the row lookups, on
    the corner weights of the same positions."""
    shape = SHAPES[dim]
    pos = _positions(shape, n=300, seed=10)
    vals = np.random.default_rng(11).uniform(-1, 1, 300).astype(np.float32)
    jp, tp = _both(pos)
    rb, rw = ji._base_and_weights(shape, *jp)
    gb, gw = ti._base_and_weights(shape, *tp)
    jv, tv = (jnp.asarray(vals), torch.from_numpy(vals)) if with_values \
        else (None, None)
    _close(ti.scatter_rows(shape, gb, gw, tv),
           ji.scatter_rows(shape, rb, rw, jv))
    if with_values:
        for g, r in zip(ti.scatter_rows2(shape, gb, gw, tv),
                        ji.scatter_rows2(shape, rb, rw, jv)):
            _close(g, r)
