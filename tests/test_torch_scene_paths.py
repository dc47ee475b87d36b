"""Two scenes' loops over the port's ops against the same loops over the
JAX package's, and two reference-binary golden scenes through the port.

- ``scenes/surfaceTension.py`` (a liquid box with surface tension): the
  parallel redistancing with velocity transport, order-1 levelset
  advection, the boundary Neumann copy of ``Grid.setBoundNeumann``
  (``scene/api.py:306-326``), flags from the levelset, order-2 MAC
  advection, wall BCs, the curvature and the ghost-fluid PcMIC solve with
  surface tension, 3 steps at 16³ (the scene runs 40³).
- ``scenes/karman.py`` in 3D (``dim = 3``): inflow walls, an obstacle
  cylinder and fraction BCs with PcMIC, 3 steps at 32x16x16 (the scene
  runs 2 res x res x res; the initial y-noise is left out, as on the card).
- ``tests/ref_scenes/test_0020_shapes.py`` and ``test_1040_secOrderBnd.py``
  replayed through the port's ops against ``tests/testdata_ref/`` with
  their own thresholds (1e-7 and 1e-4).

Both packages' loops run on the CPU from the same numpy state. Flags and
fractions agree exactly and the CG iterations within 2 (equal when
measured). The grids agree to 2e-5: the redistancing's and the obstacle
SDF's square roots differ by float32 ulps between XLA and torch
(``tests/test_torch_levelset.py``), and the steps carry that (measured
after 3 steps: surface tension 1.4e-6, Kármán 5.8e-6).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mantaflow_tpu.core import flags as jfl
from mantaflow_tpu.core import masks as jmasks
from mantaflow_tpu.core import shapes as jsh
from mantaflow_tpu.core.domain import Domain as JDomain
from mantaflow_tpu.ops import advection as jadv
from mantaflow_tpu.ops import extforces as jext
from mantaflow_tpu.ops import extrapolation as jxtr
from mantaflow_tpu.ops import flip as jflip
from mantaflow_tpu.ops import levelset as jls
from mantaflow_tpu.ops import obstacles as jobs
from mantaflow_tpu.ops import pressure as jprs
from mantaflow_tpu.scene.api import _wall_sdf as j_wall_sdf
from mantaflow_tpu_torch.core import flags as tfl
from mantaflow_tpu_torch.core import masks as tmasks
from mantaflow_tpu_torch.core import shapes as tsh
from mantaflow_tpu_torch.core.domain import Domain
from mantaflow_tpu_torch.ops import advection as tadv
from mantaflow_tpu_torch.ops import extforces as text
from mantaflow_tpu_torch.ops import extrapolation as txtr
from mantaflow_tpu_torch.ops import flip as tflip
from mantaflow_tpu_torch.ops import levelset as tls
from mantaflow_tpu_torch.ops import obstacles as tobs
from mantaflow_tpu_torch.ops import pressure as tprs

CPU = "cpu"
TESTDATA_REF = os.path.join(os.path.dirname(__file__), "testdata_ref")
TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


# ---------------------------------------------------------------------------
# scenes/surfaceTension.py

ST_DT, ST_SURF, ST_ACC, ST_BW = 0.25, 0.1, 5e-4, 1


def _neumann(xp, masks, data, dom, w):
    """Grid.setBoundNeumann(w) (scene/api.py:306-326): copy the first
    interior layer into the boundary shells, over either package's ops."""
    for ax, n in (("x", dom.shape[2]), ("y", dom.shape[1]),
                  ("z", dom.shape[0])):
        if ax == "z" and not dom.is3d:
            continue
        idx = (masks.axis_index(dom, ax) if xp is jnp
               else masks.axis_index(dom, ax, data.device))
        for layer in range(w + 1):
            data = xp.where(idx == (w - layer), masks.shift(data, 1, ax),
                            data)
            data = xp.where(idx == (n - 1 - w + layer),
                            masks.shift(data, -1, ax), data)
    return data


def _surface_tension_init(res):
    gs = (res, res, res)
    box = dict(p0=tuple(g * 0.25 for g in gs), p1=tuple(g * 0.75 for g in gs))
    jdom, dom = JDomain(size=gs), Domain(size=gs)
    jphi = jsh.Box(**box).compute_levelset(jdom)
    jflags = jfl.update_from_levelset(jfl.init_domain(jdom, ST_BW), jphi,
                                      1e10)
    tphi = tsh.Box(**box).compute_levelset(dom, CPU)
    tflags = tfl.update_from_levelset(tfl.init_domain(dom, ST_BW, device=CPU),
                                      tphi, 1e10)
    vel = np.zeros((3,) + jdom.shape, np.float32)
    return (jdom, jflags, jphi, jnp.asarray(vel)), \
        (dom, tflags, tphi, torch.from_numpy(vel))


def _surface_tension_step_jax(dom, flags, phi, vel):
    phi, vel = jls.reinit_marching(phi, flags, dom, vel)
    phi = jadv.advect_real(flags, vel, phi, ST_DT, order=1)
    phi = _neumann(jnp, jmasks, phi, dom, ST_BW)
    flags = jfl.update_from_levelset(flags, phi, 1e10)
    vel = jadv.advect_mac(flags, vel, vel, ST_DT, order=2)
    vel = jext.set_wall_bcs(flags, vel, dom)
    curv = jflip.get_curvature(phi, dom)
    vel, p, _, it, _ = jprs.solve_pressure(
        vel, flags, dom, ST_ACC, phi=phi, curv=curv, surf_tens=ST_SURF,
        preconditioner=jprs.PcMIC)
    return flags, phi, vel, p, int(it)


def _surface_tension_step_torch(dom, flags, phi, vel):
    phi, vel = tls.reinit_marching(phi, flags, dom, vel)
    phi = tadv.advect_real(flags, vel, phi, ST_DT, order=1)
    phi = _neumann(torch, tmasks, phi, dom, ST_BW)
    flags = tfl.update_from_levelset(flags, phi, 1e10)
    vel = tadv.advect_mac(flags, vel, vel, ST_DT, order=2)
    vel = text.set_wall_bcs(flags, vel, dom)
    curv = tflip.get_curvature(phi, dom)
    vel, p, _, it, _ = tprs.solve_pressure(
        vel, flags, dom, ST_ACC, phi=phi, curv=curv, surf_tens=ST_SURF,
        preconditioner=tprs.PcMIC)
    return flags, phi, vel, p, int(it)


def test_surface_tension_steps_match_reference():
    (jdom, jf, jp, jv), (dom, tf, tp, tv) = _surface_tension_init(16)
    moved = 0.0
    for _ in range(3):
        jf, jp, jv, jpr, jit = _surface_tension_step_jax(jdom, jf, jp, jv)
        tf, tp, tv, tpr, tit = _surface_tension_step_torch(dom, tf, tp, tv)
        np.testing.assert_array_equal(_np(tf), np.asarray(jf))
        assert abs(tit - jit) <= 2
        for got, ref in ((tp, jp), (tv, jv), (tpr, jpr)):
            np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=0,
                                       atol=TOL)
        moved = max(moved, float(np.abs(np.asarray(jv)).max()))
    assert moved > 1e-3  # surface tension set the box in motion


# ---------------------------------------------------------------------------
# scenes/karman.py with dim = 3

KM_DT, KM_ACC, KM_ITER, KM_VEL = 1.0, 1e-4, 5.0, (0.9, 0.0, 0.0)


def _karman_init(xp, fl, sh, obs, wall_sdf, dom, res, dev):
    """flags, phiObs, fractions and the inflow cylinder of karman.py's
    setup (dim 3: gs = (2 res, res, res)), over either package."""
    gs = dom.size
    kw = dict(device=dev) if dev is not None else {}
    flags = fl.init_domain(dom, 0, inflow="xX", **kw)
    phi_walls = wall_sdf(dom, 0, "yYzZ", **kw)
    center = (gs[0] * 0.25, gs[1] * 0.5, gs[2] * 0.5)
    axis = (0.0, 0.0, float(gs[2]))
    obstacle = sh.Cylinder(center=center, radius=res * 0.2, z=axis)
    infl = sh.Cylinder(center=center, radius=res * 0.21, z=axis)
    phi_obs = (obstacle.compute_levelset(dom, dev) if dev is not None
               else obstacle.compute_levelset(dom))
    phi_obs = xp.minimum(phi_obs, phi_walls)
    fractions = obs.update_fractions(flags, phi_obs, dom)
    flags = obs.set_obstacle_flags(flags, phi_obs, dom, fractions=fractions)
    flags = fl.fill_grid(flags)
    return flags, phi_obs, fractions, infl


def _karman_step(ops, dom, flags, phi_obs, fractions, infl, vel, density):
    """One karman.py step with sec_order_bc, over ``ops`` (adv, ext, xtr,
    prs) of either package."""
    adv, ext, xtr, prs = ops
    density = infl.apply_to_grid(density, 2.0, dom)
    density = adv.advect_real(flags, vel, density, KM_DT, order=2,
                              order_space=1)
    vel = adv.advect_mac(flags, vel, vel, KM_DT, order=2)
    vel = xtr.extrapolate_mac_simple(flags, vel, dom, 2, into_obs=True)
    vel = ext.set_wall_bcs_frac(flags, vel, dom, phi_obs)
    vel = ext.set_inflow_bcs(vel, dom, "xX", KM_VEL)
    vel, p, _, it, _ = prs.solve_pressure(
        vel, flags, dom, KM_ACC, fractions=fractions,
        cg_max_iter_fac=KM_ITER, preconditioner=prs.PcMIC)
    vel = xtr.extrapolate_mac_simple(flags, vel, dom, 5, into_obs=True)
    vel = ext.set_wall_bcs_frac(flags, vel, dom, phi_obs)
    vel = ext.set_inflow_bcs(vel, dom, "xX", KM_VEL)
    return vel, density, p, int(it)


def test_karman_3d_steps_match_reference():
    res = 16
    size = (2 * res, res, res)
    jdom, dom = JDomain(size=size), Domain(size=size)
    jf, jpo, jfr, jin = _karman_init(jnp, jfl, jsh, jobs, j_wall_sdf, jdom,
                                     res, None)
    tf, tpo, tfr, tin = _karman_init(torch, tfl, tsh, tobs, tfl._wall_sdf,
                                     dom, res, CPU)
    np.testing.assert_array_equal(_np(tf), np.asarray(jf))
    np.testing.assert_allclose(_np(tpo), np.asarray(jpo), rtol=0, atol=2e-6)
    np.testing.assert_array_equal(_np(tfr), np.asarray(jfr))
    assert (np.asarray(jf) & jfl.TypeObstacle)[:, 1:-1, 1:-1].any()
    assert (np.asarray(jf) & jfl.TypeInflow).any()
    vel = np.zeros((3,) + jdom.shape, np.float32)
    vel[0] = KM_VEL[0]
    jv, tv = jnp.asarray(vel), torch.from_numpy(vel.copy())
    jd = jnp.zeros(jdom.shape, jnp.float32)
    td = torch.zeros(dom.shape)
    jops, tops = (jadv, jext, jxtr, jprs), (tadv, text, txtr, tprs)
    for _ in range(3):
        jv, jd, jpr, jit = _karman_step(jops, jdom, jf, jpo, jfr, jin, jv,
                                        jd)
        tv, td, tpr, tit = _karman_step(tops, dom, tf, tpo, tfr, tin, tv, td)
        assert abs(tit - jit) <= 2
        for got, ref in ((tv, jv), (td, jd), (tpr, jpr)):
            np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=0,
                                       atol=TOL)
    assert float(np.asarray(jd).max()) > 1.0


# ---------------------------------------------------------------------------
# reference-binary golden scenes through the port


def _golden(name):
    from mantaflow_tpu.io.uni import read_grid_uni
    return np.asarray(read_grid_uni(os.path.join(TESTDATA_REF,
                                                 name + ".uni"))[0])


def test_ref_scene_0020_shapes():
    """tests/ref_scenes/test_0020_shapes.py: Sphere, Box and Cylinder
    stamped onto a real and a MAC grid at 42³, 1e-7 against the binary."""
    res = 42
    gs = np.array([res, res, res], np.float64)
    dom = Domain(size=(res,) * 3)

    def v(*c):
        return tuple(float(a) for a in gs * np.array(c))

    cases = [
        ("Sph", tsh.Sphere(center=v(0.3, 0.4, 0.5), radius=res * 0.2), 0.302,
         tsh.Sphere(center=v(0.6, 0.5, 0.4), radius=res * 0.25),
         (0.1, 0.1, 0.4)),
        ("Box", tsh.Box(p0=v(0.2, 0.2, 0.3), p1=v(0.9, 0.8, 0.9)), 0.812,
         tsh.Box(p0=v(0.2, 0.2, 0.3), p1=v(0.9, 0.8, 0.9)), (0.5, 0.1, 0.1)),
        ("Cyl", tsh.Cylinder(center=v(0.5, 0.5, 0.5), radius=res * 0.2,
                             z=v(0, 0.3, 0)), 0.432,
         tsh.Cylinder(center=v(0.5, 0.5, 0.5), radius=res * 0.2,
                      z=v(0, 0.3, 0)), (0.4, 0.3, 0.2)),
    ]
    for name, shp_d, dval, shp_v, vval in cases:
        dens = shp_d.apply_to_grid(torch.zeros(dom.shape), dval, dom)
        vel = shp_v.apply_to_mac_grid(torch.zeros((3,) + dom.shape), vval,
                                      dom)
        for what, got in (("dens", dens), ("vel", vel)):
            ref = _golden(f"test_0020_shapes_{what}{name}")
            assert ref.shape == got.shape
            assert float(np.abs(_np(got).astype(np.float64) - ref).max()) \
                <= 1e-7, f"{what}{name}"


def test_ref_scene_1040_sec_order_bnd():
    """tests/ref_scenes/test_1040_secOrderBnd.py: a sphere obstacle by
    fractions, the vortex field, 10 steps of fraction BCs and PcMIC solves
    at 16², 1e-4 against the binary."""
    res = 16
    dom = Domain(size=(res, res, 1), dim=2)
    center = (res * 0.5, res * 0.5, 0.5)
    radius = res * 0.4
    flags = tfl.init_domain(dom, device=CPU)
    phi_obs = -tsh.Sphere(center=center, radius=radius).compute_levelset(
        dom, CPU)
    vel = tobs.init_vortex_velocity(phi_obs, dom, center, radius)
    fractions = tobs.update_fractions(flags, phi_obs, dom)
    flags = tobs.set_obstacle_flags(flags, phi_obs, dom, fractions=fractions)
    flags = tfl.fill_grid(flags)
    density = torch.zeros(dom.shape)
    for _ in range(10):
        density = tadv.advect_real(flags, vel, density, 1.0, order=2,
                                   order_space=1, clamp_mode=1)
        vel = tadv.advect_mac(flags, vel, vel, 1.0, order=2, strength=1.0,
                              clamp_mode=1)
        vel = text.set_wall_bcs_frac(flags, vel, dom, phi_obs)
        vel = txtr.extrapolate_mac_simple(flags, vel, dom, 1)
        vel = tprs.solve_pressure(vel, flags, dom, fractions=fractions,
                                  preconditioner=tprs.PcMIC)[0]
        vel = text.set_wall_bcs_frac(flags, vel, dom, phi_obs)
        vel = txtr.extrapolate_mac_simple(flags, vel, dom, 1)
    for what, got in (("frac", fractions), ("vel", vel)):
        ref = _golden(f"test_1040_secOrderBnd_{what}")
        assert ref.shape == got.shape
        diff = float(np.abs(_np(got).astype(np.float64) - ref).max())
        assert diff <= 1e-4, f"{what}: {diff}"
