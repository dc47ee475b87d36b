"""The port's implicit density projection (``ops/idp.py``) against the JAX
package's on the CPU: a clumped block of particles beside a sphere
obstacle (with particles inside its cells) at 20³ and 32² (the JAX test's
``tests/test_idp.py`` size), every public function and one Correct19 step
(scenes/zflip.py:51-95) stage by stage.

Tolerances: flags, per-cell ranks and the face max/min scatters exact; the
density's trilinear accumulation 1e-5 x max(1, max|value|) (the JAX
package's ``.at[].add`` is ``index_add_`` here, its order differs on the
card); positions and the other elementwise work 1e-6 x max(1, ...).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mantaflow_tpu.core import flags as jfl
from mantaflow_tpu.core import particles as jpt
from mantaflow_tpu.core.domain import Domain as JDomain
from mantaflow_tpu.ops import idp as jidp
from mantaflow_tpu.ops import pressure as jprs
from mantaflow_tpu_torch.core import particles as tpt
from mantaflow_tpu_torch.core.domain import Domain
from mantaflow_tpu_torch.ops import idp as tidp


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _close(got, ref, tol=1e-6):
    got, ref = _np(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got.astype(np.float64) - ref).max())
    assert err <= tol * scale, f"{err} > {tol} x {scale}"


def _pair(a):
    a = np.ascontiguousarray(a)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _setup(dim):
    n = 20 if dim == 3 else 32
    size = (n, n, n) if dim == 3 else (n, n, 1)
    jdom, dom = JDomain(size=size, dim=dim), Domain(size=size, dim=dim)
    shp = dom.shape
    z, y, x = np.meshgrid(*(np.arange(s) + 0.5 for s in shp), indexing="ij")
    c = np.array([0.7 * n, 0.4 * n, 0.5 * n if dim == 3 else 0.5])
    r = np.sqrt((x - c[0]) ** 2 + (y - c[1]) ** 2
                + ((z - c[2]) ** 2 if dim == 3 else 0.0))
    wall = np.minimum.reduce([x - 1, n - 1 - x, y - 1, n - 1 - y]
                             + ([z - 1, n - 1 - z] if dim == 3 else []))
    phi_obs = np.minimum(r - 0.15 * n, wall).astype(np.float32)
    flags = np.asarray(jfl.init_domain(jdom)).copy()
    flags[(phi_obs < 0) & (flags == jfl.TypeEmpty)] = jfl.TypeObstacle
    rng = np.random.RandomState(dim)
    # a clump of 4x overfull cells and particles scattered over the sphere
    m = 2500 if dim == 3 else 900
    lo, hi = 0.2 * n, 0.45 * n
    pos = rng.uniform(lo, hi, (m, 3))
    pos[: m // 5] = rng.uniform(0.5 * n, 0.9 * n, (m // 5, 3))
    if dim == 2:
        pos[:, 2] = 0.5
    pos = pos.astype(np.float32)
    cap = m + 100
    p = np.zeros((cap, 3), np.float32)
    p[:m] = pos
    pf = np.full(cap, jpt.PDELETE, np.int32)
    pf[:m] = 0
    pf[rng.rand(cap) < 0.02] = jpt.PDELETE
    ptype = np.where(rng.rand(cap) < 0.1, 4, 1).astype(np.int32)
    return dict(jdom=jdom, dom=dom, flags=_pair(flags),
                phi=_pair(phi_obs), ptype=_pair(ptype),
                parts=(jpt.Particles(pos=jnp.asarray(p),
                                     flags=jnp.asarray(pf),
                                     count=jnp.int32(m)),
                       tpt.Particles(pos=torch.from_numpy(p.copy()),
                                     flags=torch.from_numpy(pf.copy()),
                                     count=torch.tensor(m,
                                                        dtype=torch.int32))))


@pytest.fixture(scope="module", params=[3, 2], ids=["3d", "2d"])
def case(request):
    return _setup(request.param)


def test_mark_fluid_and_boundary_cells_matches_reference(case):
    (jf, tf), (jphi, tphi), (jpt_, tpt_) = case["flags"], case["phi"], \
        case["ptype"]
    jp, tp = case["parts"]
    for ptype, exclude in ((None, 0), ((jpt_, tpt_), 4)):
        ref = jidp.mark_fluid_and_boundary_cells(
            jp, jf, jphi, case["jdom"], None if ptype is None else ptype[0],
            exclude)
        got = tidp.mark_fluid_and_boundary_cells(
            tp, tf, tphi, case["dom"], None if ptype is None else ptype[1],
            exclude)
        np.testing.assert_array_equal(_np(got[0]), np.asarray(ref[0]))
        _close(got[1], ref[1])
    assert float(np.abs(np.asarray(ref[1])).max()) > 0  # pushed out


@pytest.mark.parametrize("clamp", [True, False])
def test_map_mass_to_grid_matches_reference(case, clamp):
    (jf, tf), (jphi, tphi) = case["flags"], case["phi"]
    jp, tp = case["parts"]
    ref = jidp.map_mass_to_grid(jp, jf, jphi, case["jdom"], 0.8, 0.25,
                                not clamp)
    got = tidp.map_mass_to_grid(tp, tf, tphi, case["dom"], 0.8, 0.25,
                                not clamp)
    np.testing.assert_array_equal(_np(got[0]), np.asarray(ref[0]))
    _close(got[1], ref[1], 1e-5)
    _close(got[2], ref[2])
    demoted = (np.asarray(ref[0]) == jfl.TypeEmpty).sum()
    assert demoted > 0 and np.abs(np.asarray(ref[1])).max() > 0


def test_correct19_step_matches_reference(case):
    """mapMassToGrid, the lambda solve (the JAX package's lambda into
    both), computeDeltaX, mapMACToPartPositions; then
    resampeOverfullCells."""
    (jf, tf), (jphi, tphi), (jpt_, tpt_) = case["flags"], case["phi"], \
        case["ptype"]
    jp, tp = case["parts"]
    jdom, dom = case["jdom"], case["dom"]
    jfl2, jrho, jdx = jidp.map_mass_to_grid(jp, jf, jphi, jdom, 1.0, 0.25)
    stencil = jprs.make_laplace_stencil(jfl2, jdom)
    lam, _, _ = jprs.solve_pressure_system(jrho, jfl2, jdom, stencil, 1e-3,
                                           4.0)
    tflags2 = torch.from_numpy(np.array(jfl2))
    tlam = torch.from_numpy(np.array(lam))
    ref_dx = jidp.compute_delta_x(lam, jfl2, jdom)
    got_dx = tidp.compute_delta_x(tlam, tflags2, dom)
    _close(got_dx, ref_dx)
    assert float(np.abs(np.asarray(ref_dx)).max()) > 0
    tdx = torch.from_numpy(np.array(ref_dx))
    for ptype, exclude in ((None, 0), ((jpt_, tpt_), 4)):
        ref = jidp.map_mac_to_part_positions(
            jp, ref_dx, jfl2, jdom, 1.0, None if ptype is None else ptype[0],
            exclude)
        got = tidp.map_mac_to_part_positions(
            tp, tdx, tflags2, dom, 1.0, None if ptype is None else ptype[1],
            exclude)
        _close(got.pos, ref.pos)
    assert float(np.abs(np.asarray(ref.pos - jp.pos)).max()) > 1e-3
    rng = np.random.RandomState(9)
    jvel, tvel = _pair(rng.standard_normal((3,) + dom.shape).astype(
        np.float32))
    jpv, tpv = _pair(rng.standard_normal((jp.capacity, 3)).astype(
        np.float32))
    # a density error with overfull cells (< -1) where the clump is
    dens = np.array(jrho) * 3.0
    jd, td = _pair(dens.astype(np.float32))
    ref = jidp.resample_overfull_cells(jp, jpv, jvel, jd, jdom, 0.8)
    got = tidp.resample_overfull_cells(tp, tpv, tvel, td, dom, 0.8)
    _close(got[0].pos, ref[0].pos)
    _close(got[1], ref[1])
    _close(got[2], ref[2])
    assert (dens < -1.0).any()
    assert float(np.abs(np.asarray(ref[0].pos - jp.pos)).max()) > 0
