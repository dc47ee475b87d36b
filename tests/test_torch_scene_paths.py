"""Four scenes' loops over the port's ops against the same loops over the
JAX package's, and seven reference-binary golden scenes through the port.

- ``scenes/surfaceTension.py`` (a liquid box with surface tension): the
  parallel redistancing with velocity transport, order-1 levelset
  advection, the boundary Neumann copy of ``Grid.setBoundNeumann``
  (``scene/api.py:306-326``), flags from the levelset, order-2 MAC
  advection, wall BCs, the curvature and the ghost-fluid PcMIC solve with
  surface tension, 3 steps at 16³ (the scene runs 40³).
- ``scenes/karman.py`` in 3D (``dim = 3``): the initial y-noise, inflow
  walls, an obstacle cylinder and fraction BCs with PcMIC, 3 steps at
  32x16x16 (the scene runs 2 res x res x res).
- ``scenes/fire.py`` (3 steps at 24³) and ``scenes/turbulence.py`` (the
  k-epsilon channel, 3 steps at 32x16x16), with the scene API's adaptive
  time step and turbulence particles replayed on the host.
- ``tests/ref_scenes/test_0020_shapes.py``, ``test_1040_secOrderBnd.py``,
  ``test_1030_waveeq.py``, ``test_1020_uvs.py``, ``test_2025_turb.py``,
  ``test_1050_guiding2d.py`` and ``test_0042_interpol4d.py`` replayed
  through the port's ops against ``tests/testdata_ref/`` with their own
  thresholds.

Both packages' loops run on the CPU from the same numpy state. Flags and
fractions agree exactly and the CG iterations within 2 (equal when
measured). The grids agree to 2e-5: the redistancing's and the obstacle
SDF's square roots differ by float32 ulps between XLA and torch
(``tests/test_torch_levelset.py``), and the steps carry that (measured
after 3 steps: surface tension 1.4e-6, Kármán 5.8e-6); the k-epsilon
channel's to 2e-5 x max(1, max|grid|), its pressure by its residual.
"""

import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mantaflow_tpu.core import flags as jfl
from mantaflow_tpu.core import grid4d as jg4
from mantaflow_tpu.core import masks as jmasks
from mantaflow_tpu.core import particles as jpt
from mantaflow_tpu.core import shapes as jsh
from mantaflow_tpu.core.domain import Domain as JDomain
from mantaflow_tpu.ops import advection as jadv
from mantaflow_tpu.ops import extforces as jext
from mantaflow_tpu.ops import extrapolation as jxtr
from mantaflow_tpu.ops import fire as jfire
from mantaflow_tpu.ops import flip as jflip
from mantaflow_tpu.ops import initops as jini
from mantaflow_tpu.ops import kepsilon as jke
from mantaflow_tpu.ops import levelset as jls
from mantaflow_tpu.ops import obstacles as jobs
from mantaflow_tpu.ops import pressure as jprs
from mantaflow_tpu.ops import vortex as jvx
from mantaflow_tpu.scene import api as japi
from mantaflow_tpu.scene.api import _wall_sdf as j_wall_sdf
from mantaflow_tpu.utils import noise as jnoise
from mantaflow_tpu_torch.core import flags as tfl
from mantaflow_tpu_torch.core import grid4d as tg4
from mantaflow_tpu_torch.core import masks as tmasks
from mantaflow_tpu_torch.core import particles as tpt
from mantaflow_tpu_torch.core import shapes as tsh
from mantaflow_tpu_torch.core.domain import Domain
from mantaflow_tpu_torch.ops import advection as tadv
from mantaflow_tpu_torch.ops import extforces as text
from mantaflow_tpu_torch.ops import extrapolation as txtr
from mantaflow_tpu_torch.ops import fire as tfire
from mantaflow_tpu_torch.ops import flip as tflip
from mantaflow_tpu_torch.ops import guiding as tgd
from mantaflow_tpu_torch.ops import initops as tini
from mantaflow_tpu_torch.ops import kepsilon as tke
from mantaflow_tpu_torch.ops import levelset as tls
from mantaflow_tpu_torch.ops import obstacles as tobs
from mantaflow_tpu_torch.ops import pressure as tprs
from mantaflow_tpu_torch.ops import turbulence as ttur
from mantaflow_tpu_torch.ops import vortex as tvx
from mantaflow_tpu_torch.ops import waves as twav
from mantaflow_tpu_torch.scene import api as tapi
from mantaflow_tpu_torch.utils import noise as tnoise
from mantaflow_tpu_torch.utils.mtrand import RandomStream

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


def _karman_noise(pk, dom, flags):
    """The y-velocity karman.py's addNoise leaves (posScale 75, clamp
    +-1, scale 0.1 on an SDF of -1 everywhere, the file-loaded tile)."""
    noise = pk.noise(dom, -1, True, **pk.kw)
    noise.pos_scale = (75.0, 75.0, 75.0)
    noise.clamp, noise.clamp_neg, noise.clamp_pos = True, -1.0, 1.0
    z = pk.zeros(dom.shape)
    return pk.ini.add_noise(flags, z, noise, dom, sdf=z - 1.0, scale=0.1,
                            time=0.0)


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
    # the y-noise (karman.py:40-51): addNoise on the testall SDF, then
    # setComponent into the velocity's y component
    jvy, tvy = (_karman_noise(pk, dom_, f_) for pk, dom_, f_ in
                ((J, jdom, jf), (T, dom, tf)))
    np.testing.assert_allclose(_np(tvy), np.asarray(jvy), rtol=0, atol=1e-6)
    assert 0.01 < float(np.abs(np.asarray(jvy)).max()) <= 0.1 + 1e-6
    jv, tv = jv.at[1].set(jvy), torch.stack([tv[0], tvy, tv[2]])
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


# ---------------------------------------------------------------------------
# the breadth ops' scene loops: scenes/fire.py, scenes/turbulence.py


J = SimpleNamespace(
    Domain=JDomain, fl=jfl, sh=jsh, ini=jini, fire=jfire, adv=jadv,
    ext=jext, prs=jprs, ke=jke, vx=jvx, pt=jpt, kw={}, api=japi,
    noise=jnoise.WaveletNoiseField,
    zeros=lambda shape: jnp.zeros(shape, jnp.float32),
    arr=jnp.asarray, cat=lambda a, b: jnp.concatenate([a, b]),
    maxnorm=lambda v: float(jnp.sqrt(jnp.max(v[0] ** 2 + v[1] ** 2
                                             + v[2] ** 2))))
T = SimpleNamespace(
    Domain=Domain, fl=tfl, sh=tsh, ini=tini, fire=tfire, adv=tadv,
    ext=text, prs=tprs, ke=tke, vx=tvx, pt=tpt, kw={"device": CPU},
    api=tapi,
    noise=tnoise.WaveletNoiseField,
    zeros=lambda shape: torch.zeros(shape),
    arr=lambda a: torch.from_numpy(np.array(a, np.float32)),
    cat=lambda a, b: torch.cat([a, b]),
    maxnorm=lambda v: float(torch.sqrt(torch.max(v[0] ** 2 + v[1] ** 2
                                                 + v[2] ** 2))))


def _clock(pk, dt, frame_length=1.0, cfl=3.0, dt_min=1e-4, dt_max=1.0):
    """The package's scene API Solver (FluidSolver::step and
    adaptTimestep, fluidsolver.cpp:143-204) with a scene's time
    settings."""
    s = pk.api.Solver(name="clock", gridSize=(8, 8, 8), **pk.kw)
    s.timestep, s.frameLength, s.cfl = dt, frame_length, cfl
    s.timestepMin, s.timestepMax = dt_min, dt_max
    return s


FIRE_GRAV_D = tuple(g * -0.001 for g in (0.0, -0.0981, 0.0))
FIRE_GRAV_H = tuple(g * 0.1 for g in (0.0, -0.0981, 0.0))


def _fire_init(pk, res):
    """scenes/fire.py's setup at ``res``: open yY bounds, the file-loaded
    noise with the scene's knobs, the source box."""
    dom = pk.Domain(size=(res, res, res))
    flags = pk.fl.fill_grid(pk.fl.init_domain(dom, 1, **pk.kw))
    flags = pk.fl.set_open_bound(flags, dom, 1, "yY",
                                 pk.fl.TypeOutflow | pk.fl.TypeEmpty)
    noise = pk.noise(dom, -1, True, **pk.kw)
    noise.pos_scale = (45.0, 45.0, 45.0)
    noise.clamp, noise.clamp_neg, noise.clamp_pos = True, 0.0, 1.0
    noise.val_scale, noise.val_offset, noise.time_anim = 1.0, 0.75, 0.2
    box = pk.sh.Box(center=(res * 0.5, res * 0.15, res * 0.5),
                    size=(res / 8, 0.05 * res, res / 8))
    st = {k: pk.zeros(dom.shape) for k in ("density", "heat", "fuel",
                                           "react", "flame")}
    st.update(flags=flags, vel=pk.zeros((3,) + dom.shape))
    return dom, st, noise, box


def _fire_step(pk, dom, st, noise, box, clock):
    """One pass of scenes/fire.py's loop over ``pk``'s ops."""
    flags, vel = st["flags"], st["vel"]
    clock.adaptTimestep(pk.maxnorm(vel))
    dt = clock.timestep
    g = {k: st[k] for k in ("density", "heat", "fuel", "react")}
    if clock.timeTotal < 200:
        t = clock.timeTotal * dom.dx
        for k in ("density", "heat", "fuel", "react"):
            g[k] = pk.ini.density_inflow(flags, g[k], noise, box, dom, 1.0,
                                         0.5, time=t)
    g["fuel"], g["density"], g["react"], _, _, _, g["heat"] = \
        pk.fire.process_burn(g["fuel"], g["density"], g["react"], dt, dom,
                             heat=g["heat"])
    for k in ("density", "heat", "fuel", "react"):
        g[k] = pk.adv.advect_real(flags, vel, g[k], dt, order=2)
    vel = pk.adv.advect_mac(flags, vel, vel, dt, order=2)
    flags, _, g["density"] = pk.ext.reset_outflow_grids(flags, dom,
                                                        real=g["density"])
    flame = g["fuel"] * 0.5
    vel = pk.ext.vorticity_confinement(vel, flags, dom, 0.1, flame)
    vel = pk.ext.add_buoyancy(flags, g["density"], vel, FIRE_GRAV_D, dt, dom)
    vel = pk.ext.add_buoyancy(flags, g["heat"], vel, FIRE_GRAV_H, dt, dom)
    vel = pk.ext.set_wall_bcs(flags, vel, dom)
    vel, p, _, it, _ = pk.prs.solve_pressure(vel, flags, dom, 1e-3,
                                             preconditioner=pk.prs.PcMIC)
    flame = pk.fire.update_flame(g["react"], flame, dom)
    clock.step()
    return {**g, "flags": flags, "vel": vel, "flame": flame, "pressure": p,
            "it": int(it)}


def test_fire_steps_match_reference():
    """scenes/fire.py's loop, 3 steps at 24³ (the scene runs 52³): flags
    exact, CG iterations within 2, the grids 2e-5."""
    jdom, jst, jno, jbox = _fire_init(J, 24)
    dom, tst, tno, tbox = _fire_init(T, 24)
    np.testing.assert_array_equal(_np(tst["flags"]), np.asarray(jst["flags"]))
    jc, tc = (_clock(J, 1.1, 1.2, 3.0, 0.2, 2.0),
              _clock(T, 1.1, 1.2, 3.0, 0.2, 2.0))
    for _ in range(3):
        jst = _fire_step(J, jdom, jst, jno, jbox, jc)
        tst = _fire_step(T, dom, tst, tno, tbox, tc)
        np.testing.assert_array_equal(_np(tst["flags"]),
                                      np.asarray(jst["flags"]))
        assert abs(tst["it"] - jst["it"]) <= 2
        assert abs(tc.timestep - jc.timestep) <= 1e-6 * jc.timestep
        for k in ("density", "heat", "fuel", "react", "flame", "vel",
                  "pressure"):
            np.testing.assert_allclose(_np(tst[k]), np.asarray(jst[k]),
                                       rtol=0, atol=TOL, err_msg=k)
    # the source emitted fuel and smoke, the flame burned, the plume rose
    assert float(np.asarray(jst["fuel"]).max()) > 0.01
    assert float(np.asarray(jst["density"]).max()) > 1e-3
    assert float(np.asarray(jst["flame"]).max()) > 0.1
    assert float(np.asarray(jst["vel"][1]).max()) > 1e-3


class _TurbParticles:
    """scene/vortex_api.py:88-210's TurbulenceParticleSystem over a
    package's ops: the persistent RandomStream(34894231) seeding (shared:
    its draws do not depend on the state) and the static ctime/inflow."""

    def __init__(self, pk, noise):
        self.pk, self.noise = pk, noise
        self.pos = self.tex0 = self.tex1 = pk.arr(np.zeros((0, 3)))
        self.ctime, self.inflow = 0.0, np.zeros(3, np.float32)

    def add(self, pts):
        new = self.pk.arr(pts)
        self.pos = self.pk.cat(self.pos, new)
        self.tex0 = self.pk.cat(self.tex0, new)
        self.tex1 = self.pk.cat(self.tex1, new)

    def advect(self, flags, vel, dt, dom):
        n = self.pos.shape[0]
        zi = np.zeros(n, np.int32)
        parts = self.pk.pt.Particles(
            pos=self.pos, flags=self.pk.arr(zi).to(torch.int32)
            if self.pk is T else jnp.asarray(zi),
            count=self.pk.arr(n).to(torch.int32) if self.pk is T
            else jnp.int32(n))
        self.pos = self.pk.pt.advect_in_grid(parts, flags, vel, dt, dom, 2,
                                             delete_in_obstacle=False).pos

    def synthesize(self, flags, k, dt, dom, inflow_bias):
        self.inflow = self.inflow + np.asarray(inflow_bias, np.float32) * dt
        old_alpha = 2.0 * ((self.ctime / 5.0) % 1.0)
        self.ctime += dt
        alpha = 2.0 * ((self.ctime / 5.0) % 1.0)
        off = self.pk.arr(self.inflow)
        if old_alpha < 1.0 <= alpha:
            self.tex0 = self.pos - off
        if old_alpha > alpha:
            self.tex1 = self.pos - off
        self.pos, self.tex0, self.tex1 = self.pk.vx.synthesize_turbulence(
            self.pos, self.tex0, self.tex1, flags, k, self.noise, dom, 1.0,
            dt, 1, 0.1, 1.0 / 0.01, 1.5 * 0.1 ** 2)

    def delete_in_obstacle(self, flags, dom):
        sz, sy, sx = dom.shape
        p = np.asarray(_np(self.pos))
        f = np.asarray(_np(flags))
        keep = (f[np.clip(p[:, 2].astype(int), 0, sz - 1),
                  np.clip(p[:, 1].astype(int), 0, sy - 1),
                  np.clip(p[:, 0].astype(int), 0, sx - 1)] & 2) == 0
        if self.pk is T:
            keep = torch.from_numpy(keep)
        self.pos, self.tex0, self.tex1 = (a[keep] for a in
                                          (self.pos, self.tex0, self.tex1))


def _turb_seed(stream, box, num):
    """TurbulenceParticleSystem.seed (turbulencepart.cpp:57-68): rejection
    samples of the box's bounding box."""
    ext = np.asarray(box.get_extent(), np.float32)
    p0 = np.asarray(box.get_center(), np.float32) - ext * 0.5
    pts = np.empty((num, 3), np.float32)
    for i in range(num):
        while True:
            p = stream.get_vec3s(1)[0] * ext + p0
            if bool(box.is_inside(float(p[0]), float(p[1]), float(p[2]))):
                break
        pts[i] = p
    return pts


KE_INFLOW = (0.52, 0.0, 0.0)


def _turb_init(pk, gs, noise):
    dom = pk.Domain(size=gs)
    flags = pk.fl.fill_grid(pk.fl.init_domain(dom, **pk.kw))
    res = gs[0]
    for i in range(4):
        for j in range(4):
            obs = pk.sh.Sphere(center=(res * 0.2, gs[1] * (i + 1) / 5.0,
                                       gs[2] * (j + 1) / 5.0),
                               radius=res * 0.025)
            flags = obs.apply_to_grid(flags, pk.fl.TypeObstacle, dom)
    box = pk.sh.Box(center=(res * 0.05, gs[1] * 0.43, gs[2] * 0.6),
                    size=(res * 0.02, gs[1] * 0.005, gs[2] * 0.07))
    k, eps = pk.ke.bcs(flags, pk.zeros(dom.shape), pk.zeros(dom.shape), 0.1,
                       0.1, True)
    return dom, {"flags": flags, "vel": pk.zeros((3,) + dom.shape), "k": k,
                 "eps": eps}, box, _TurbParticles(pk, noise)


def _turb_step(pk, dom, st, tp, new_pts, dt, clamp_mode=2):
    """One pass of scenes/turbulence.py's loop over ``pk``'s ops."""
    flags, vel, k, eps = st["flags"], st["vel"], st["k"], st["eps"]
    tp.add(new_pts)
    tp.advect(flags, vel, dt, dom)
    tp.synthesize(flags, k, dt, dom, KE_INFLOW)
    tp.delete_in_obstacle(flags, dom)
    k, eps = pk.ke.bcs(flags, k, eps, 0.1, 0.1, False)
    k = pk.adv.advect_real(flags, vel, k, dt, order=1)
    eps = pk.adv.advect_real(flags, vel, eps, dt, order=1)
    k, eps = pk.ke.bcs(flags, k, eps, 0.1, 0.1, False)
    k, eps, prod, nu_t, _ = pk.ke.compute_production(vel, k, eps, dom, 2.5)
    k, eps = pk.ke.sources(k, eps, prod, dt)
    k, eps, vel = pk.ke.gradient_diffusion(k, eps, nu_t, dt, dom, 10.0, vel)
    vel = pk.adv.advect_mac(flags, vel, vel, dt, order=2,
                            clamp_mode=clamp_mode)
    vel = pk.ext.set_wall_bcs(flags, vel, dom)
    vel = pk.ext.set_inflow_bcs(vel, dom, "xXyYzZ", KE_INFLOW)
    vel, p, rhs, it, _ = pk.prs.solve_pressure(
        vel, flags, dom, 1e-3, cg_max_iter_fac=0.5,
        preconditioner=pk.prs.PcMIC)
    vel = pk.ext.set_wall_bcs(flags, vel, dom)
    vel = pk.ext.set_inflow_bcs(vel, dom, "xXyYzZ", KE_INFLOW)
    return {"flags": flags, "vel": vel, "k": k, "eps": eps, "pressure": p,
            "rhs": rhs, "it": int(it)}


def _default_noise_pair(dom, jdom):
    """NoiseField() (the generated tile of the default seed, time_anim 0):
    the port's tile, bit for bit the JAX package's (tests/
    test_torch_noise.py), given to both so that it is generated once."""
    tno = tnoise.WaveletNoiseField(dom, device=CPU)
    jno = jnoise.WaveletNoiseField(jdom, load_from_file=True)
    jno.tiles = jnp.asarray(tno.tiles.numpy())
    assert jno.seed == tno.seed
    return jno, tno


def test_kepsilon_channel_steps_match_reference():
    """scenes/turbulence.py's loop, 3 steps at 32x16x16 (the scene runs
    64x32x32): the turbulence particles, the k-epsilon chain, PcMIC with
    cgMaxIterFac 0.5. Flags exact, CG within 2, grids 2e-5 x max(1,
    max|grid|), the pressure by its residual, particles 2e-5."""
    gs = (32, 16, 16)
    jdom, dom = JDomain(size=gs), Domain(size=gs)
    jno, tno = _default_noise_pair(dom, jdom)
    jdom, jst, jbox, jtp = _turb_init(J, gs, jno)
    dom, tst, tbox, ttp = _turb_init(T, gs, tno)
    np.testing.assert_array_equal(_np(tst["flags"]), np.asarray(jst["flags"]))
    assert (np.asarray(jst["flags"]) & jfl.TypeObstacle)[1:-1, 1:-1,
                                                         1:-1].any()
    stream = RandomStream(34894231)
    for _ in range(3):
        pts = _turb_seed(stream, tbox, 500)
        jst = _turb_step(J, jdom, jst, jtp, pts, 0.5)
        tst = _turb_step(T, dom, tst, ttp, pts, 0.5)
        assert abs(tst["it"] - jst["it"]) <= 2
        for k in ("vel", "k", "eps"):
            ref = np.asarray(jst[k])
            scale = max(1.0, float(np.abs(ref).max()))
            np.testing.assert_allclose(_np(tst[k]), ref, rtol=0,
                                       atol=TOL * scale, err_msg=k)
        # the pressure by its residual: at the same iteration count the
        # two float32 CGs part by ~5e-5 on a max|p| of 1.2 over the 50-60
        # iterations (their dots round in another order), so the port's
        # solution is held to the solve's own exit test on its system
        stencil = tprs.make_laplace_stencil(tst["flags"], dom)
        res = torch.where(tfl.is_fluid(tst["flags"]), tst["rhs"]
                          - tprs.apply_laplace(tst["flags"], tst["pressure"],
                                               stencil, dom), 0.0)
        assert float(res.abs().max()) < 1e-3
        for a, b in ((ttp.pos, jtp.pos), (ttp.tex0, jtp.tex0),
                     (ttp.tex1, jtp.tex1)):
            assert a.shape[0] == b.shape[0]
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=0,
                                       atol=TOL)
    assert float(np.abs(np.asarray(jst["vel"][0])).max()) > 0.3
    assert jtp.pos.shape[0] > 1000


# ---------------------------------------------------------------------------
# more reference-binary golden scenes through the port


def test_ref_scene_1030_waveeq():
    """tests/ref_scenes/test_1030_waveeq.py: 20 explicit then 20 implicit
    wave-equation steps at 113x127, mass normalized, 1e-4."""
    dom = Domain(size=(113, 127, 1), dim=2)
    dt, c_sqr = 0.9, 0.12
    flags = tfl.fill_grid(tfl.init_domain(dom, device=CPU))
    h = tsh.Box(p0=(113 * 0.3, 127 * 0.3, 0.3), p1=(113 * 0.5, 127 * 0.5,
                                                    0.5)).apply_to_grid(
        torch.zeros(dom.shape), 1.0, dom)
    hprev, vel = h.clone(), torch.zeros(dom.shape)
    implicit = False
    for t in range(40):
        mass = float(twav.total_sum(h, dom))
        if implicit:
            h, hprev, _, _ = twav.cg_solve_wave_eq(flags, h, hprev, dt, dom,
                                                   False, c_sqr)
        else:
            curv = twav.calc_sec_deriv_2d(h, dom)
            vel = vel + (c_sqr * dt) * curv
            h = h + dt * vel
            if t >= 20:
                implicit = True
        h = twav.normalize_sum_to(h, dom, mass)
    for what, got in (("height", h), ("vel", vel)):
        ref = _golden(f"test_1030_waveeq_{what}")
        diff = float(np.abs(_np(got).astype(np.float64) - ref).max())
        assert diff <= 1e-4, f"{what}: {diff}"


def test_ref_scene_1020_uvs():
    """tests/ref_scenes/test_1020_uvs.py: three UV grids advected through a
    buoyant start field for 20 steps with updateUvWeight's staggered
    resets at 50x75, 0.015."""
    res = 50
    gs = (50, 75, 1)
    dom = Domain(size=gs, dim=2)
    flags = tfl.fill_grid(tfl.init_domain(dom, device=CPU))
    clock = _clock(T, 0.5)
    uv = [ttur.reset_uv_grid(dom, device=CPU) for _ in range(3)]
    src = tsh.Cylinder(center=(gs[0] * 0.3, gs[1] * 0.4, 0.5),
                       radius=res * 0.10, z=(gs[0] * 0.10, 0.0, 0.0))
    src_vel = tsh.Cylinder(center=(gs[0] * 0.3, gs[1] * 0.4, 0.5),
                           radius=res * 0.151, z=(gs[0] * 0.151, 0.0, 0.0))
    density = src.apply_to_grid(torch.zeros(dom.shape), 1.0, dom)
    vel = src_vel.apply_to_mac_grid(torch.zeros((3,) + dom.shape),
                                    (5.0, 0.0, 0.0), dom)
    vel = text.set_wall_bcs(flags, vel, dom)
    vel = text.add_buoyancy(flags, density, vel, (0.0, -1e-2, 0.0), 0.5, dom)
    vel = tprs.solve_pressure(vel, flags, dom, 1e-6, cg_max_iter_fac=2.0,
                              preconditioner=tprs.PcMIC)[0]
    vel = text.set_wall_bcs(flags, vel, dom)
    for _ in range(20):
        for i in range(3):
            uv[i] = tadv.advect_vec3(flags, vel, uv[i], clock.timestep,
                                     order=1)
            uv[i], _ = ttur.update_uv_weight(11.0, i, 3, uv[i],
                                             clock.timeTotal,
                                             clock.timestep, dom)
        clock.step()
    for i in range(3):
        ref = _golden(f"test_1020_uvs_uv{i}")
        diff = float(np.abs(_np(uv[i]).astype(np.float64) - ref).max())
        assert diff <= 0.015, f"uv{i}: {diff}"


def test_ref_scene_2025_turb():
    """tests/ref_scenes/test_2025_turb.py: the sphere array, file-loaded
    noise, turbulence particles and the k-epsilon chain, 32 frames at
    70x35x35; k 5e-3, eps 1e-3, vel 2e-2."""
    gs = (70, 35, 35)
    dom = Domain(size=gs)
    noise = tnoise.WaveletNoiseField(dom, load_from_file=True, device=CPU)
    dom, st, box, tp = _turb_init(T, gs, noise)
    stream = RandomStream(34894231)
    for _ in range(32):
        st = _turb_step(T, dom, st, tp, _turb_seed(stream, box, 500), 1.2,
                        clamp_mode=1)
    for what, tol in (("k", 5e-3), ("eps", 1e-3), ("vel", 2e-2)):
        ref = _golden(f"test_2025_turb_{what}")
        diff = float(np.abs(_np(st[what]).astype(np.float64) - ref).max())
        assert diff <= tol, f"{what}: {diff}"


def test_ref_scene_1050_guiding2d():
    """tests/ref_scenes/test_1050_guiding2d.py: the spiral target with
    y-weights 1 and 5, 5 steps of PD_fluid_guiding at 60², dens 0.04,
    vel 0.4."""
    res = 60
    dom = Domain(size=(res, res, 1), dim=2)
    flags = tfl.fill_grid(tfl.init_domain(dom, 1, device=CPU))
    src = tsh.Cylinder(center=(res * 0.5, res * 0.3, 0.5), radius=res * 0.14,
                       z=(0.0, res * 0.04 * 1.5, 0.0))
    vel_t = tgd.get_spiral_velocity(dom, 1.5 * 2, device=CPU)
    w = tgd.set_gradient_y_weight(torch.zeros(dom.shape), dom, 0, res // 2,
                                  1, 1)
    w = tgd.set_gradient_y_weight(w, dom, res // 2, res, 5, 5)
    density = torch.zeros(dom.shape)
    vel = torch.zeros((3,) + dom.shape)
    dt = 1.0
    for _ in range(5):
        flags, _, density = text.reset_outflow_grids(flags, dom,
                                                     real=density)
        density = src.apply_to_grid(density, 1.0, dom)
        density = tadv.advect_real(flags, vel, density, dt, order=2,
                                   clamp_mode=1)
        vel = tadv.advect_mac(flags, vel, vel, dt, order=2, clamp_mode=1)
        vel = text.set_wall_bcs(flags, vel, dom)
        vel = text.add_buoyancy(flags, density, vel,
                                (0.0, 0.25 * 2 * -1e-2, 0.0), dt, dom)
        vel, _, _ = tgd.pd_fluid_guiding(vel, vel_t, flags, w, dom, 2, 1.0,
                                         1.0, 0.99)
        vel = text.set_wall_bcs(flags, vel, dom)
    for what, got, tol in (("dens", density, 0.04), ("vel", vel, 0.4)):
        ref = _golden(f"test_1050_guiding2d_{what}")
        diff = float(np.abs(_np(got).astype(np.float64) - ref).max())
        assert diff <= tol, f"{what}: {diff}"


def _interpolate_grid4d(target_shape, source):
    """interpolateGrid4d (mantaflow_tpu/scene/api.py:1282-1310, grid4d.cpp:
    455-468) with no offset, scale or size: one t plane of the target at a
    time, so the 80^4 target's positions stay small."""
    st, sz, sy, sx = target_shape
    ss = source.shape[-4:]
    tgt = (sx, sy, sz, st)
    f = [ss[3 - c] / tgt[c] for c in range(4)]
    off = [f[c] * 0.5 for c in range(4)]
    xs = torch.arange(sx, dtype=torch.float32).reshape(1, 1, 1, sx) * f[0] \
        + off[0]
    ys = torch.arange(sy, dtype=torch.float32).reshape(1, 1, sy, 1) * f[1] \
        + off[1]
    zs = torch.arange(sz, dtype=torch.float32).reshape(1, sz, 1, 1) * f[2] \
        + off[2]
    ts = torch.arange(st, dtype=torch.float32) * f[3] + off[3]
    shape = (1, sz, sy, sx)
    px, py, pz = (a.expand(shape) for a in (xs, ys, zs))
    planes = [tg4.interpol4d(source, px, py, pz, ts[t].expand(shape))
              for t in range(st)]
    return torch.cat(planes)


def test_ref_scene_0042_interpol4d():
    """tests/ref_scenes/test_0042_interpol4d.py: region-stamped 4D grids
    resampled 20^4 -> 40^4 -> 80^4 -> 40^4 -> 20^4, scalar and four
    channels, 1e-5."""
    shapes = {n: (n, n, n, n) for n in (20, 40, 80)}
    idx = torch.arange(20)
    m1 = (idx >= 6) & (idx <= 14)
    region = (m1.reshape(20, 1, 1, 1) & m1.reshape(1, 20, 1, 1)
              & m1.reshape(1, 1, 20, 1) & m1.reshape(1, 1, 1, 20))
    sm = torch.where(region, 1.0, tg4.zeros4d((20,) * 4, device=CPU))
    out = {"scalar2": sm, "vec3t2": sm[None].expand(4, -1, -1, -1, -1)}

    def chain(g):
        d = _interpolate_grid4d(shapes[40], g)
        xl = _interpolate_grid4d(shapes[80], d)
        d2 = _interpolate_grid4d(shapes[40], xl)
        return d, _interpolate_grid4d(shapes[20], d2)

    out["scalar1"], out["scalar3"] = chain(sm)
    # every channel holds the same region: one chain, four channels
    out["vec3t1"], out["vec3t3"] = (a[None].expand(4, -1, -1, -1, -1)
                                    for a in (out["scalar1"],
                                              out["scalar3"]))
    for name, got in out.items():
        ref = _golden(f"test_0042_interpol4d_{name}")
        assert ref.shape == got.shape, name
        diff = float(np.abs(_np(got.contiguous()).astype(np.float64)
                            - ref).max())
        assert diff <= 1e-5, f"{name}: {diff}"
    np.testing.assert_allclose(
        _np(out["scalar1"]),
        np.asarray(jg4.interpol4d(jnp.asarray(_np(sm)),
                                  *np.meshgrid(*(np.arange(40) * 0.5 + 0.25,)
                                               * 4, indexing="ij")[::-1])),
        rtol=0, atol=1e-6)
