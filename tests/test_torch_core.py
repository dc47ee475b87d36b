"""mantaflow_tpu_torch core modules vs mantaflow_tpu on the same inputs.

Every case builds its inputs once with numpy, runs the JAX function on the
CPU and the port's counterpart with device="cpu", and compares. Integer and
boolean results must be equal; float results agree to 1e-6 (elementwise
float32, same operation order).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mantaflow_tpu.core import flags as jfl
from mantaflow_tpu.core import mac as jmac
from mantaflow_tpu.core import masks as jmasks
from mantaflow_tpu.core import solver as jslv
from mantaflow_tpu.core.domain import Domain as JDomain
from mantaflow_tpu.core.shapes import Sphere as JSphere
import mantaflow_tpu_torch as mt
from mantaflow_tpu_torch.core import flags as tfl
from mantaflow_tpu_torch.core import mac as tmac
from mantaflow_tpu_torch.core import masks as tmasks
from mantaflow_tpu_torch.core import solver as tslv
from mantaflow_tpu_torch.core.domain import Domain, domain_from_shape
from mantaflow_tpu_torch.core.shapes import Sphere

CPU = "cpu"


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _vel(shape, seed):
    return np.random.RandomState(seed).randn(3, *shape).astype(np.float32)


def test_domain_matches_reference():
    for size, dim in (((16, 12, 8), 3), ((10, 6, 1), 2)):
        a, b = JDomain(size=size, dim=dim), Domain(size=size, dim=dim)
        assert (a.shape, a.dx, a.num_cells, a.is3d) == \
            (b.shape, b.dx, b.num_cells, b.is3d)
    assert domain_from_shape((8, 12, 16)) == Domain(size=(16, 12, 8))
    with pytest.raises(ValueError):
        Domain(size=(8, 8, 2), dim=2)


@pytest.mark.parametrize("size,bw,open_bound", [
    ((16, 12, 10), 1, ""), ((16, 12, 10), 1, "yY"), ((12, 10, 1), 0, "xXy"),
    ((12, 14, 9), 2, "zZx")])
def test_flags_init_fill_open_bound(size, bw, open_bound):
    dim = 2 if size[2] == 1 else 3
    jdom, dom = JDomain(size=size, dim=dim), Domain(size=size, dim=dim)
    ref = jfl.fill_grid(jfl.init_domain(jdom, bw), jfl.TypeFluid)
    got = tfl.fill_grid(tfl.init_domain(dom, bw, device=CPU), tfl.TypeFluid)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), np.asarray(ref))
    ref = jfl.set_open_bound(ref, jdom, bw, open_bound)
    got = tfl.set_open_bound(got, dom, bw, open_bound)
    np.testing.assert_array_equal(_np(got), np.asarray(ref))
    for pred in ("is_fluid", "is_obstacle", "is_empty", "is_outflow"):
        np.testing.assert_array_equal(_np(getattr(tfl, pred)(got)),
                                      np.asarray(getattr(jfl, pred)(ref)))


def test_init_domain_needs_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfl.init_domain(Domain(size=(8, 8, 8)), 1)
    assert mt.resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("bnd", [0, 1, 2])
def test_interior_mask_and_axis_index(bnd):
    size = (9, 7, 5)
    jdom, dom = JDomain(size=size), Domain(size=size)
    np.testing.assert_array_equal(_np(tmasks.interior_mask(dom, bnd, CPU)),
                                  np.asarray(jmasks.interior_mask(jdom, bnd)))
    for ax in "xyz":
        np.testing.assert_array_equal(_np(tmasks.axis_index(dom, ax, CPU)),
                                      np.asarray(jmasks.axis_index(jdom, ax)))


def test_shift_wraps_like_reference():
    """shift wraps (jnp.roll); the wrapped entries are compared too."""
    a = np.random.RandomState(1).rand(2, 5, 6, 7).astype(np.float32)
    for d in (-2, -1, 1, 3):
        for ax in "xyz":
            np.testing.assert_array_equal(
                _np(tmasks.shift(torch.tensor(a), d, ax)),
                np.asarray(jmasks.shift(jnp.asarray(a), d, ax)))


@pytest.mark.parametrize("fn", ["get_centered", "at_mac_x", "at_mac_y",
                                "at_mac_z"])
def test_mac_stencils(fn):
    v = _vel((6, 7, 8), 2)
    ref = getattr(jmac, fn)(jnp.asarray(v))
    got = getattr(tmac, fn)(torch.tensor(v))
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=1e-6)


def test_curl_centered():
    v = _vel((6, 7, 8), 3)
    ref = jmac.curl_centered(jnp.asarray(v))
    got = tmac.curl_centered(torch.tensor(v))
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=1e-6)


def _ts_pair(dt, tpf, lock):
    j = dataclasses.replace(jslv.TimeState.create(dt),
                            time_per_frame=jnp.float32(tpf),
                            lock_dt=jnp.array(lock))
    t = dataclasses.replace(tslv.TimeState.create(dt, device=CPU),
                            time_per_frame=torch.tensor(tpf,
                                                        dtype=torch.float32),
                            lock_dt=torch.tensor(lock))
    return j, t


def _ts_equal(j, t):
    for f in ("dt", "time_total", "time_per_frame", "frame", "lock_dt",
              "count"):
        got, ref = _np(getattr(t, f)), np.asarray(getattr(j, f))
        assert got.dtype == ref.dtype, f
        np.testing.assert_allclose(got, ref, atol=1e-6, err_msg=f)


@pytest.mark.parametrize("dt,tpf,lock,max_vel", [
    (1.0, 0.0, False, 0.5), (0.4, 0.7, False, 4.0), (0.3, 0.5, True, 2.0),
    (2.0, 0.95, False, 0.01)])
def test_adapt_timestep_and_step(dt, tpf, lock, max_vel):
    j, t = _ts_pair(dt, tpf, lock)
    j = jslv.adapt_timestep(j, jnp.float32(max_vel), 3.0, 1e-4, 2.0, 1.0)
    t = tslv.adapt_timestep(t, torch.tensor(max_vel, dtype=torch.float32),
                            3.0, 1e-4, 2.0, 1.0)
    _ts_equal(j, t)
    for _ in range(3):
        j, t = jslv.step(j, 1.0), tslv.step(t, 1.0)
        _ts_equal(j, t)


def test_sphere_levelset():
    res = 16
    kw = dict(center=(res / 2.0, res * 0.1, res / 2.0), radius=res * 0.14)
    ref = JSphere(**kw).compute_levelset(JDomain(size=(res, res, res)))
    got = Sphere(**kw).compute_levelset(Domain(size=(res, res, res)), CPU)
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=1e-6)
