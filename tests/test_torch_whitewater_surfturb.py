"""The port's whitewater and surface-turbulence modules against the JAX
package's on the CPU, on seeded inputs at the JAX tests' sizes
(``tests/test_whitewater.py``'s 24³ pool, ``tests/test_surfaceturbulence
.py``'s 24³ ball).

Both draw from the same ``jax.random`` stream (the port's
``utils/threefry.py``), so the sampled candidates are the JAX package's.
Tolerances: particle flags, counts and the per-cell emission counts exact
(integer work on the same inputs: each stage takes the JAX package's
previous outputs); positions, velocities, lifetimes, potentials and
normals 1e-6 x max(1, max|value|) (sin/cos, sqrt and FMA contraction
differ by ulps between XLA and PyTorch); surface turbulence 1e-5, its
levelset redistancing and scatters carrying float32 ulps between the
frames.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mantaflow_tpu.core import flags as jfl
from mantaflow_tpu.core import particles as jpt
from mantaflow_tpu.core.domain import Domain as JDomain
from mantaflow_tpu.ops import surfaceturbulence as jst
from mantaflow_tpu.ops import whitewater as jww
from mantaflow_tpu_torch.core import particles as tpt
from mantaflow_tpu_torch.core.domain import Domain
from mantaflow_tpu_torch.ops import surfaceturbulence as tst
from mantaflow_tpu_torch.ops import whitewater as tww

RES = 24


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


def _parts(pos, flags, count):
    return (jpt.Particles(pos=jnp.asarray(pos), flags=jnp.asarray(flags),
                          count=jnp.int32(count)),
            tpt.Particles(pos=torch.from_numpy(pos.copy()),
                          flags=torch.from_numpy(flags.copy()),
                          count=torch.tensor(count, dtype=torch.int32)))


def _same_parts(tp, jp, tol=1e-6):
    np.testing.assert_array_equal(_np(tp.flags), np.asarray(jp.flags))
    assert int(tp.count) == int(jp.count)
    _close(tp.pos, jp.pos, tol)


def _to_torch(jp):
    return tpt.Particles(pos=torch.from_numpy(np.array(jp.pos)),
                         flags=torch.from_numpy(np.array(jp.flags)),
                         count=torch.tensor(int(jp.count), dtype=torch.int32))


@pytest.fixture(scope="module")
def pool():
    """tests/test_whitewater.py's pool: a box of liquid (phi from the box
    SDF), an obstacle block, and a fast random velocity."""
    size = (RES, RES, RES)
    jdom, dom = JDomain(size=size), Domain(size=size)
    z, y, x = np.meshgrid(*(np.arange(RES) + 0.5,) * 3, indexing="ij")
    phi = np.maximum.reduce([1 - x, x - (RES - 1), 1 - y, y - 10, 1 - z,
                             z - (RES - 1)]).astype(np.float32)
    flags = np.asarray(jfl.init_domain(jdom)).copy()
    flags = np.where((phi < 0) & ((flags & jfl.TypeObstacle) == 0),
                     jfl.TypeFluid, flags).astype(np.int32)
    flags[4:7, 3:6, 14:17] = jfl.TypeObstacle
    rng = np.random.RandomState(0)
    vel = (rng.standard_normal((3,) + dom.shape) * 3.0).astype(np.float32)
    return dict(jdom=jdom, dom=dom, flags=_pair(flags), phi=_pair(phi),
                vel=_pair(vel))


POT_KW = dict(radius=2, tau_min_ta=0.1, tau_max_ta=5.0, tau_min_wc=0.1,
              tau_max_wc=5.0, tau_min_ke=0.01, tau_max_ke=5.0,
              scale_from_manta=1.0 / RES)


def test_potentials_match_reference(pool):
    (jf, tf), (jphi, tphi), (jv, tv) = pool["flags"], pool["phi"], \
        pool["vel"]
    got = tww.compute_secondary_particle_potentials(tf, tv, tphi,
                                                    pool["dom"], **POT_KW)
    ref = jww.compute_secondary_particle_potentials(jf, jv, jphi,
                                                    pool["jdom"], **POT_KW)
    for g, r in zip(got, ref):
        _close(g, r)
    assert float(np.asarray(ref[0]).max()) > 0 and \
        float(np.asarray(ref[2]).max()) > 0


def _sampled(pool, mode, cap=4096, pre=100):
    """The JAX package's potentials; ``pre`` live particles in front, the
    rest dead, both packages' sampling from the same inputs."""
    (jf, tf), (jphi, _), (jv, tv) = pool["flags"], pool["phi"], pool["vel"]
    pots = jww.compute_secondary_particle_potentials(jf, jv, jphi,
                                                     pool["jdom"], **POT_KW)
    tpots = [torch.from_numpy(np.array(p)) for p in pots[:4]]
    rng = np.random.RandomState(1)
    pos = (rng.rand(cap, 3) * (RES - 2) + 1).astype(np.float32)
    pflags = np.full(cap, jpt.PDELETE, np.int32)
    pflags[:pre] = jpt.PFOAM
    pflags[rng.rand(cap) < 0.05] = jpt.PDELETE  # holes among the live
    jp, tp = _parts(pos, pflags, cap)
    jvs, tvs = _pair((rng.standard_normal((cap, 3)) * 0.1).astype(np.float32))
    jls, tls = _pair(rng.rand(cap).astype(np.float32))
    args = dict(l_min=2.0, l_max=5.0, c_s=0.3, c_b=0.8, k_ta=40.0,
                k_wc=40.0, dt=1.0, mode=mode)
    ref = jww.sample_secondary_particles(jp, jvs, jls, jf, jv, *pots[:4],
                                         pool["jdom"], **args)
    got = tww.sample_secondary_particles(tp, tvs, tls, tf, tv, *tpots,
                                         pool["dom"], **args)
    return ref, got


@pytest.mark.parametrize("mode", ["single", "multiple"])
def test_sampling_matches_reference(pool, mode):
    (jp, jvs, jls), (tp, tvs, tls) = _sampled(pool, mode)
    _same_parts(tp, jp)
    _close(tvs, jvs)
    _close(tls, jls)
    emitted = int((np.asarray(jp.flags) & jpt.PDELETE == 0).sum()) - 95
    assert emitted > 10


@pytest.mark.parametrize("mode,anti", [("linear", 0), ("linear", 3),
                                       ("cubic", 2)])
def test_update_matches_reference(pool, mode, anti):
    (jf, tf), (jv, tv) = pool["flags"], pool["vel"]
    (jp, jvs, jls), _ = _sampled(pool, "single")
    nr = np.asarray(jww.compute_secondary_particle_potentials(
        jf, jv, pool["phi"][0], pool["jdom"], **POT_KW)[3])
    jnr, tnr = _pair(nr)
    rng = np.random.RandomState(2)
    jfs, tfs = _pair((rng.standard_normal(jvs.shape) * 0.01).astype(
        np.float32))
    tp = _to_torch(jp)
    tvs, tls = torch.from_numpy(np.array(jvs)), torch.from_numpy(
        np.array(jls))
    args = dict(gravity=(0.0, -0.003, 0.0), k_b=0.5, k_d=0.6, c_s=0.3,
                c_b=0.8, dt=1.0, antitunneling=anti, mode=mode, radius=1)
    for exclude in (0, jpt.PBUBBLE):
        ref = jww.update_secondary_particles(jp, jvs, jls, jfs, jf, jv, jnr,
                                             pool["jdom"], exclude=exclude,
                                             **args)
        got = tww.update_secondary_particles(tp, tvs, tls, tfs, tf, tv, tnr,
                                             pool["dom"], exclude=exclude,
                                             **args)
        _same_parts(got[0], ref[0])
        _close(got[1], ref[1])
        _close(got[2], ref[2])
    _same_parts(tww.delete_particles_in_obstacle(got[0], tf, pool["dom"]),
                jww.delete_particles_in_obstacle(ref[0], jf, pool["jdom"]))


def test_levelset_helpers_match_reference(pool):
    (jf, tf), (jphi, tphi), (jv, tv) = pool["flags"], pool["phi"], \
        pool["vel"]
    np.testing.assert_array_equal(
        _np(tww.set_flags_from_levelset(tf, tphi)),
        np.asarray(jww.set_flags_from_levelset(jf, jphi)))
    np.testing.assert_array_equal(
        _np(tww.set_flags_from_levelset(tf, tphi, 0, jfl.TypeEmpty)),
        np.asarray(jww.set_flags_from_levelset(jf, jphi, 0, jfl.TypeEmpty)))
    c = (0.5, -1.0, 2.0)
    np.testing.assert_array_equal(
        _np(tww.set_mac_from_levelset(tv, tphi, pool["dom"], c)),
        np.asarray(jww.set_mac_from_levelset(jv, jphi, pool["jdom"], c)))


def test_legacy_potentials_match_reference(pool):
    (jf, tf), (jphi, tphi), (jv, tv) = pool["flags"], pool["phi"], \
        pool["vel"]
    dom, jdom, s = pool["dom"], pool["jdom"], 1.0 / RES
    tn_ = tww.compute_surface_normals(tphi, dom)
    jn_ = jww.compute_surface_normals(jphi, jdom)
    _close(tn_, jn_)
    _close(tww.compute_potential_trapped_air(tf, tv, dom, 2, 0.1, 5.0, s),
           jww.compute_potential_trapped_air(jf, jv, jdom, 2, 0.1, 5.0, s))
    _close(tww.compute_potential_kinetic_energy(tf, tv, dom, 0.01, 5.0, s),
           jww.compute_potential_kinetic_energy(jf, jv, jdom, 0.01, 5.0, s))
    _close(tww.compute_potential_wave_crest(tf, tv, dom, 2, tn_, 0.1, 5.0,
                                            s),
           jww.compute_potential_wave_crest(jf, jv, jdom, 2, jn_, 0.1, 5.0,
                                            s))
    for r in (1, 2):
        _close(tww.update_neighbor_ratio(tf, dom, r),
               jww.update_neighbor_ratio(jf, jdom, r))


def test_unknown_modes_raise(pool):
    (_, tf), (_, tv) = pool["flags"], pool["vel"]
    _, tp = _parts(np.zeros((8, 3), np.float32), np.zeros(8, np.int32), 8)
    z3, z1 = torch.zeros(8, 3), torch.zeros(8)
    g = torch.zeros(pool["dom"].shape)
    with pytest.raises(ValueError):
        tww.sample_secondary_particles(tp, z3, z1, tf, tv, g, g, g, g,
                                       pool["dom"], 2.0, 5.0, 0.3, 0.8, 40.0,
                                       40.0, 1.0, mode="both")
    with pytest.raises(ValueError):
        tww.update_secondary_particles(tp, z3, z1, z3, tf, tv, g,
                                       pool["dom"], (0, -1, 0), 0.5, 0.6,
                                       0.3, 0.8, 1.0, mode="verlet")


# ---------------------------------------------------------------------------
# surface turbulence

def _ball(rng, res=RES, r=5.0):
    g = np.stack(np.meshgrid(*(np.arange(res) + 0.25,) * 3,
                             indexing="ij"), -1).reshape(-1, 3)
    pts = np.concatenate([g + off for off in (0.0, 0.5)])
    pts = pts + rng.uniform(-0.1, 0.1, pts.shape)
    keep = np.linalg.norm(pts - res / 2, axis=1) < r
    return pts[keep][:, ::-1].astype(np.float32)


def test_surface_turbulence_matches_reference():
    """Three frames of the pipeline (advection, maintenance, waves, the
    displaced output) on tests/test_surfaceturbulence.py's moving ball,
    each package from its own state."""
    size = (RES, RES, RES)
    jdom, dom = JDomain(size=size), Domain(size=size)
    flags = np.asarray(jfl.fill_grid(jfl.init_domain(jdom))).copy()
    jf, tf = _pair(flags)
    rng = np.random.RandomState(3)
    ball = _ball(rng)
    cap = 8192
    cpos = np.zeros((cap, 3), np.float32)
    cpos[:len(ball)] = ball
    cflags = np.full(cap, jpt.PDELETE, np.int32)
    cflags[:len(ball)] = 0
    jc, tc = _parts(cpos, cflags, len(ball))
    spos = np.zeros((cap, 3), np.float32)
    jsf, tsf = _parts(spos, np.full(cap, jpt.PDELETE, np.int32), 0)
    z = np.zeros(cap, np.float32)
    jw = [jnp.asarray(z)] * 5
    tw = [torch.from_numpy(z.copy()) for _ in range(5)]
    p_j = jst.SurfTurbParams(curv_thresh_center=0.010,
                             curv_thresh_radius=0.005)
    p_t = tst.SurfTurbParams(curv_thresh_center=0.010,
                             curv_thresh_radius=0.005)
    jnrm = tnrm = None
    for frame in range(3):
        jprev, tprev = jc.pos, tc.pos
        jc = dataclasses.replace(jc, pos=jc.pos + jnp.asarray([0.2, 0, 0]))
        tc = dataclasses.replace(tc, pos=tc.pos + torch.tensor([0.2, 0, 0]))
        ref = jst.particle_surface_turbulence(
            jf, jc, jprev, jsf, jnrm, jw[0], jw[1], jw[2], jw[3], jw[4],
            jdom, p_j, frame)
        got = tst.particle_surface_turbulence(
            tf, tc, tprev, tsf, tnrm, tw[0], tw[1], tw[2], tw[3], tw[4],
            dom, p_t, frame)
        _same_parts(got[0], ref[0], 1e-5)
        for g, r in zip(got[1:], ref[1:]):
            _close(g, r, 1e-5)
        jsf, _, jnrm, jh, jdth, jsrc, jseed, jamp = ref
        tsf, _, tnrm, th, tdth, tsrc, tseed, tamp = got
        jw = [jh, jdth, jsrc, jseed, jamp]
        tw = [th, tdth, tsrc, tseed, tamp]
    act = np.asarray(jsf.active_mask())
    assert act.sum() > 100 and np.abs(np.asarray(jw[0])).max() > 0


def test_surface_stages_match_reference():
    """surface_maintenance, advect_surface_points and surface_waves each on
    the JAX package's inputs."""
    size = (RES, RES, RES)
    jdom, dom = JDomain(size=size), Domain(size=size)
    flags = np.asarray(jfl.fill_grid(jfl.init_domain(jdom))).copy()
    jf, tf = _pair(flags)
    rng = np.random.RandomState(4)
    ball = _ball(rng)
    cap = 8192
    cpos = np.zeros((cap, 3), np.float32)
    cpos[:len(ball)] = ball
    cflags = np.full(cap, jpt.PDELETE, np.int32)
    cflags[:len(ball)] = 0
    jc, tc = _parts(cpos, cflags, len(ball))
    spos = (rng.rand(cap, 3) * 10 + 7).astype(np.float32)
    sfl = np.where(rng.rand(cap) < 0.3, 0, jpt.PDELETE).astype(np.int32)
    jsf, tsf = _parts(spos, sfl, cap)
    pj, pt = jst.SurfTurbParams(), tst.SurfTurbParams()
    ref = jst.surface_maintenance(jsf, jc, jf, jdom, pj, seed=77)
    got = tst.surface_maintenance(tsf, tc, tf, dom, pt, seed=77)
    _same_parts(got[0], ref[0], 1e-5)
    _close(got[1], ref[1], 1e-5)
    _close(got[2], ref[2], 1e-5)
    moved = cpos + rng.uniform(-0.3, 0.3, cpos.shape).astype(np.float32)
    jm, tm = _parts(moved, cflags, len(ball))
    _same_parts(tst.advect_surface_points(_to_torch(ref[0]), tm, tc.pos, tf,
                                          dom, pt),
                jst.advect_surface_points(ref[0], jm, jc.pos, jf, jdom, pj),
                1e-5)
    h = [rng.uniform(-0.1, 0.1, cap).astype(np.float32) for _ in range(4)]
    jh = [jnp.asarray(a) for a in h]
    th = [torch.from_numpy(a.copy()) for a in h]
    tphi = torch.from_numpy(np.array(ref[1]))
    for g, r in zip(tst.surface_waves(_to_torch(ref[0]), *th, tphi, tf, dom,
                                      pt, 5),
                    jst.surface_waves(ref[0], *jh, ref[1], jf, jdom, pj, 5)):
        _close(g, r, 1e-5)
