"""Exact-gather and window-path advection of mantaflow_tpu_torch vs
mantaflow_tpu (ops/advection.py, ops/advection_fast.py).

The same seeded grids go through the JAX package's functions (XLA on the
CPU) and the port's (PyTorch on the CPU; the window passes through the
window kernel's wrapper, which runs its plain version on a CPU tensor), on a
16^3 domain and a 24x20 2D one, each walled, with open bounds ("yY": the
outflow extrapolation) and an obstacle sphere, at a CFL of about 2.
``advect_real``, ``advect_vec3`` and ``advect_mac`` over order 1/2,
clamp mode 1/2, cubic or linear lookups and first- or second-order traces
(order 1 has no clamp), abs 1e-5: the same float32 terms in the same order
(XLA may contract a product and a sum into a fused multiply-add).
``_corner_minmax`` takes a min and a max, which do not depend on order, so
it is compared bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mantaflow_tpu.core import flags as jfl
from mantaflow_tpu.core.domain import Domain as JDomain
from mantaflow_tpu.ops import advection as jadv
from mantaflow_tpu.ops import advection_fast as jadvf
from mantaflow_tpu_torch.core import flags as tfl
from mantaflow_tpu_torch.core.domain import Domain
from mantaflow_tpu_torch.ops import advection as tadv
from mantaflow_tpu_torch.ops import advection_fast as tadvf
from mantaflow_tpu_torch.ops import advection_kernels as tadvk

SIZES = {"3d": (16, 16, 16), "2d": (24, 20, 1)}
TOL = 1e-5
DT = 1.0
# (order, clamp_mode, order_space, order_trace); order 1 has no clamp
CONFIGS = ([(1, 2, s, t) for s in (1, 2) for t in (1, 2)]
           + [(2, c, s, t) for c in (1, 2) for s in (1, 2) for t in (1, 2)])


def _ids(cfg):
    return "o%d-c%d-s%d-t%d" % cfg


def _case(size, seed=0):
    """Walled flags with open y bounds, an obstacle sphere and an empty
    patch; a MAC velocity of up to ~2 cells per step, a scalar grid and a
    centred Vec3 grid, all as numpy."""
    sx, sy, sz = size
    is3d = sz > 1
    jdom = JDomain(size=size, dim=3 if is3d else 2)
    flags = jfl.fill_grid(jfl.init_domain(jdom, 1), jfl.TypeFluid)
    flags = np.array(jfl.set_open_bound(flags, jdom, 1, "yY",
                                        jfl.TypeOutflow | jfl.TypeEmpty))
    zc, yc, xc = np.meshgrid(np.arange(sz) + 0.5, np.arange(sy) + 0.5,
                             np.arange(sx) + 0.5, indexing="ij")
    r2 = (xc - 0.4 * sx) ** 2 + (yc - 0.45 * sy) ** 2
    if is3d:
        r2 = r2 + (zc - 0.5 * sz) ** 2
    flags[np.sqrt(r2) < 0.15 * min(sx, sy)] = jfl.TypeObstacle
    patch = (xc > 0.7 * sx) & (yc > 0.6 * sy) & (yc < 0.8 * sy)
    flags[patch & ((flags & jfl.TypeFluid) != 0)] = jfl.TypeEmpty
    rng = np.random.RandomState(seed)
    vel = (rng.rand(3, sz, sy, sx) * 2 - 1).astype(np.float32) * 2.0
    if not is3d:
        vel[2] = 0.0
    grid = rng.rand(sz, sy, sx).astype(np.float32)
    vec = rng.rand(3, sz, sy, sx).astype(np.float32)
    return jdom, Domain(size=size, dim=jdom.dim), flags, vel, grid, vec


@pytest.fixture(scope="module", params=list(SIZES))
def case(request):
    return _case(SIZES[request.param])


def _close(got, ref, tol=TOL):
    ref = np.asarray(ref)
    got = got.numpy()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert float(np.max(np.abs(got - ref))) < tol


@pytest.mark.parametrize("cfg", CONFIGS, ids=_ids)
def test_advect_real_and_mac_match_reference(case, cfg):
    _, _, flags, vel, grid, _ = case
    order, clamp, space, trace = cfg
    kw = dict(order=order, clamp_mode=clamp, order_space=space,
              order_trace=trace)
    jf, jv = jnp.asarray(flags), jnp.asarray(vel)
    tf, tv = torch.tensor(flags), torch.tensor(vel)
    _close(tadv.advect_real(tf, tv, torch.tensor(grid), DT, **kw),
           jadv.advect_real(jf, jv, jnp.asarray(grid), DT, **kw))
    _close(tadv.advect_mac(tf, tv, tv, DT, **kw),
           jadv.advect_mac(jf, jv, jv, DT, **kw))


@pytest.mark.parametrize("cfg", [(2, 1, 2, 2), (2, 2, 1, 1)], ids=_ids)
def test_advect_vec3_matches_reference(case, cfg):
    _, _, flags, vel, _, vec = case
    order, clamp, space, trace = cfg
    kw = dict(order=order, clamp_mode=clamp, order_space=space,
              order_trace=trace)
    _close(tadv.advect_vec3(torch.tensor(flags), torch.tensor(vel),
                            torch.tensor(vec), DT, **kw),
           jadv.advect_vec3(jnp.asarray(flags), jnp.asarray(vel),
                            jnp.asarray(vec), DT, **kw))


def test_corner_minmax_is_bitwise(case):
    jdom, dom, flags, _, grid, _ = case
    sz, sy, sx = dom.shape
    rng = np.random.RandomState(1)
    # integer positions below 0, inside and past size - 2 on every axis
    ix, iy, iz = (rng.randint(-3, n + 3, dom.shape).astype(np.int32)
                  for n in (sx, sy, sz))
    ok = (flags & (jfl.TypeFluid | jfl.TypeEmpty)) != 0
    for mask in (ok, None):
        ref = jadv._corner_minmax(
            jnp.asarray(grid), None if mask is None else jnp.asarray(mask),
            jnp.asarray(ix), jnp.asarray(iy), jnp.asarray(iz), jdom)
        got = tadv._corner_minmax(
            torch.tensor(grid), None if mask is None else torch.tensor(mask),
            torch.tensor(ix), torch.tensor(iy), torch.tensor(iz), dom)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_trunc_rounds_toward_zero():
    x = np.array([-1.7, -0.5, -0.0, 0.4, 1.99, 2.0], np.float32)
    np.testing.assert_array_equal(tadv._trunc(torch.tensor(x)).numpy(),
                                  np.asarray(jadv._trunc(jnp.asarray(x))))


@pytest.mark.parametrize("order", [1, 2])
def test_window_path_drivers_match_reference(case, order):
    """advect_real_fast / advect_mac_fast (the latter with the outflow
    extrapolation, which advect_mac_pl skips without open bounds), through
    the window kernel's wrapper."""
    jdom, dom, flags, vel, grid, _ = case
    # the window path needs |u| dt <= k
    vel = vel * 0.6
    jf, jv = jnp.asarray(flags), jnp.asarray(vel)
    tf, tv = torch.tensor(flags), torch.tensor(vel)
    calls = []
    orig = tadvk.window_pass

    def counting(*a, **k):
        calls.append(1)
        return orig(*a, **k)
    counting.launches = 0
    tadvk.window_pass = counting
    try:
        got_d = tadvf.advect_real_fast(tf, tv, torch.tensor(grid), DT, dom,
                                       3, order=order)
        got_v = tadvf.advect_mac_fast(tf, tv, tv, DT, dom, 3, order=order)
    finally:
        tadvk.window_pass = orig
    n_comp = 3 if dom.is3d else 2
    assert len(calls) == (1 + n_comp) * order
    _close(got_d, jadvf.advect_real_fast(jf, jv, jnp.asarray(grid), DT, jdom,
                                         3, order=order))
    _close(got_v, jadvf.advect_mac_fast(jf, jv, jv, DT, jdom, 3, order=order))
    # advect_mac_pl without outflow handling differs only in outflow cells
    pl = tadvk.advect_mac_pl(tf, tv, tv, DT, dom, 3, order=order,
                             has_outflow=False)
    outflow = tfl.is_outflow(tf)[None].expand_as(pl)
    assert torch.equal(pl[~outflow], got_v[~outflow])
