"""Obstacle and initialisation plugins of mantaflow_tpu_torch vs
mantaflow_tpu: ``ops/obstacles.py`` (fractions, obstacle flags, the vortex
field, moving obstacles) and ``ops/initops.py`` (emission, noise,
symmetry checks, blurs).

The fixtures follow ``tests/test_obstacles.py``: walled 2D and 3D domains
(karman.py's ``inflow="xX"`` among them) with a sphere or cylinder
obstacle joined with the wall SDF. The noise field is the JAX package's
WaveletNoiseField; the port is handed an object that returns the values
that field computed at the same positions. Flags are exact; grids agree
to 1e-6 (the vortex field's trigonometry comes from different libraries)
or exactly where stated.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mantaflow_tpu.core import flags as jfl
from mantaflow_tpu.core import particles as jparts
from mantaflow_tpu.core import shapes as jsh
from mantaflow_tpu.core.domain import Domain as JDomain
from mantaflow_tpu.ops import initops as jini
from mantaflow_tpu.ops import obstacles as jobs
from mantaflow_tpu.scene.api import _wall_sdf as j_wall_sdf
from mantaflow_tpu_torch.core import flags as tfl
from mantaflow_tpu_torch.core import particles as tparts
from mantaflow_tpu_torch.core import shapes as tsh
from mantaflow_tpu_torch.core.domain import Domain
from mantaflow_tpu_torch.ops import initops as tini
from mantaflow_tpu_torch.ops import obstacles as tobs

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reset_obstacle_ids():
    """MovingObstacleState hands out 5 id bits a process; each case starts
    from the first, in both packages."""
    jobs.MovingObstacleState._next_id_bit = 10
    tobs.MovingObstacleState._next_id_bit = 10
    yield
    jobs.MovingObstacleState._next_id_bit = 10
    tobs.MovingObstacleState._next_id_bit = 10


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _t(a):
    return torch.from_numpy(np.array(a))


def _doms(size):
    dim = 2 if size[2] == 1 else 3
    return JDomain(size=size, dim=dim), Domain(size=size, dim=dim)


CASES = {
    # karman.py in 3D, cut: inflow x faces, a cylinder along z
    "karman3d": ((32, 16, 16), 0, dict(inflow="xX"), "cylinder"),
    "karman2d": ((32, 16, 1), 0, dict(inflow="xX"), "cylinder"),
    # test_obstacles.py: walls and a sphere
    "walls2d": ((24, 20, 1), 0, {}, "sphere"),
    "open3d": ((20, 18, 16), 1, dict(open_s="yY", outflow="X"), "sphere"),
}


def _case(name):
    size, bw, spec, obstacle = CASES[name]
    jdom, dom = _doms(size)
    n = size[1]
    if obstacle == "cylinder":
        kw = dict(center=(size[0] * 0.25, n * 0.5, size[2] * 0.5),
                  radius=n * 0.2, z=(0.0, 0.0, float(size[2])))
        js, ts = jsh.Cylinder(**kw), tsh.Cylinder(**kw)
    else:
        kw = dict(center=(size[0] * 0.45, n * 0.5, size[2] * 0.5),
                  radius=n * 0.25)
        js, ts = jsh.Sphere(**kw), tsh.Sphere(**kw)
    jflags = jfl.init_domain(jdom, bw, **spec)
    wall = "".join(c for c in "xXyYzZ"
                   if c not in "".join(spec.values()))
    phi = jnp.minimum(js.compute_levelset(jdom), j_wall_sdf(jdom, bw, wall))
    tphi = torch.minimum(ts.compute_levelset(dom, CPU),
                         tfl._wall_sdf(dom, bw, wall, device=CPU))
    return jdom, dom, bw, jflags, np.array(phi), _np(tphi)


@pytest.mark.parametrize("name", list(CASES))
def test_fractions_obstacle_flags_match_reference(name):
    jdom, dom, bw, jflags, jphi, tphi = _case(name)
    np.testing.assert_allclose(tphi, jphi, rtol=0, atol=2e-6)
    tflags = _t(jflags)
    # the same phi on both sides: fractions divide differences of it
    for thr in (0.01, 0.2):
        ref = np.array(jobs.update_fractions(jflags, jnp.asarray(jphi), jdom,
                                             bw, thr))
        got = _np(tobs.update_fractions(tflags, _t(jphi), dom, bw, thr))
        np.testing.assert_array_equal(got, ref)
    assert ((got > 0.05) & (got < 0.95)).sum() > 4
    frac = ref
    rng = np.random.RandomState(1)
    phi_out = rng.randn(*jdom.shape).astype(np.float32)
    phi_in = rng.randn(*jdom.shape).astype(np.float32)
    for kw in (dict(fractions=frac), dict(),
               dict(phi_out=phi_out, phi_in=phi_in, boundary_width=2)):
        ref = jobs.set_obstacle_flags(
            jflags, jnp.asarray(jphi), jdom,
            **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
               for k, v in kw.items()})
        got = tobs.set_obstacle_flags(
            tflags, _t(jphi), dom,
            **{k: (_t(v) if isinstance(v, np.ndarray) else v)
               for k, v in kw.items()})
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(_np(got), np.array(ref))
    p1, p2 = (rng.randn(2, 4000) * 2).astype(np.float32)
    p2[:100] = p1[:100] + 1e-5  # the flat (denominator) branch
    np.testing.assert_array_equal(
        _np(tobs._calc_fraction(_t(p1), _t(p2), 0.01)),
        np.array(jobs._calc_fraction(jnp.asarray(p1), jnp.asarray(p2),
                                     0.01)))


@pytest.mark.parametrize("size", [(16, 16, 1), (14, 12, 10)])
def test_init_vortex_velocity_matches_reference(size):
    jdom, dom = _doms(size)
    center = (size[0] * 0.5, size[1] * 0.5, size[2] * 0.5)
    phi = -np.array(jsh.Sphere(center=center, radius=size[0] * 0.4)
                    .compute_levelset(jdom))
    ref = np.array(jobs.init_vortex_velocity(jnp.asarray(phi), jdom, center,
                                             size[0] * 0.4))
    got = _np(tobs.init_vortex_velocity(_t(phi), dom, center, size[0] * 0.4))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("smooth", [True, False])
def test_moving_obstacle_over_frames(smooth):
    """Two obstacles (a box, a sphere) moved over 6 frames, each stamping
    with its own id bit; the flags and the obstacle velocities equal the
    JAX package's every frame; then particles pushed out of them."""
    size = (24, 24, 1)
    jdom, dom = _doms(size)
    jflags = jfl.fill_grid(jfl.init_domain(jdom))
    tflags = _t(jflags)
    jvel = jnp.zeros((3,) + jdom.shape, jnp.float32)
    tvel = torch.zeros((3,) + dom.shape)
    states = []
    for shape_kw in (("Box", dict(center=(6.0, 12.0, 0.5),
                                  size=(2.0, 2.0, 1.0), dim=2)),
                     ("Sphere", dict(center=(12.0, 5.0, 0.5), radius=2.5))):
        cls, kw = shape_kw
        j_ = jobs.MovingObstacleState(jdom)
        t_ = tobs.MovingObstacleState(dom)
        j_.add(getattr(jsh, cls)(**kw))
        t_.add(getattr(tsh, cls)(**kw))
        assert t_.id_bit == j_.id_bit
        states.append((j_, t_))
    paths = [((6.0, 12.0, 0.5), (18.0, 12.0, 0.5)),
             ((12.0, 5.0, 0.5), (12.0, 19.0, 0.5))]
    for t in (-1, 0, 3, 5, 7, 10, 12):
        for (j_, t_), (p0, p1) in zip(states, paths):
            jflags, jvel = j_.move_linear(t, 0, 10, p0, p1, jflags, jvel,
                                          1.0, smooth)
            tflags, tvel = t_.move_linear(t, 0, 10, p0, p1, tflags, tvel,
                                          1.0, smooth)
            np.testing.assert_array_equal(_np(tflags), np.array(jflags))
            np.testing.assert_array_equal(_np(tvel), np.array(jvel))
    assert (np.array(jflags) & jfl.TypeObstacle).any()
    pts = np.array([[12.4, 18.6, 0.5], [17.4, 12.5, 0.5], [2.5, 2.5, 0.5],
                    [11.6, 17.2, 0.5]], np.float32)
    jp = states[0][0].project_outside(jflags, jparts.make_particles(pts),
                                      jdom)
    tp = states[0][1].project_outside(tflags, tparts.make_particles(
        pts, device=CPU), dom)
    np.testing.assert_allclose(_np(tp.pos), np.array(jp.pos), rtol=0,
                               atol=1e-6)
    assert abs(float(tp.pos[2, 0]) - 2.5) < 1e-6


def test_moving_obstacle_id_bits_run_out():
    dom = Domain(size=(8, 8, 1), dim=2)
    ids = [tobs.MovingObstacleState(dom).id_bit for _ in range(6)]
    assert ids == [1 << b for b in range(10, 16)]
    with pytest.raises(RuntimeError, match="5 separate"):
        tobs.MovingObstacleState(dom)


# ---------------------------------------------------------------------------
# initops


@pytest.fixture(scope="module")
def noise_fields():
    """The JAX package's noise field and, for the port, one that returns
    the values the JAX field gives at the same positions."""
    from mantaflow_tpu.utils.noise import WaveletNoiseField
    out = {}
    for size in ((20, 18, 16), (20, 18, 1)):
        jdom, dom = _doms(size)
        jn = WaveletNoiseField(jdom)
        jn.pos_scale = (20.0, 20.0, 20.0)
        out[size] = (jn, _FixedNoise(jn, jdom))
    return out


class _FixedNoise:
    """``evaluate`` returns the JAX noise field's values on the cell grid
    (the positions KnApplyNoiseInfl and KnAddNoise ask for)."""

    def __init__(self, jnoise, jdom):
        from mantaflow_tpu.core.shapes import _cell_centers
        px, py, pz = _cell_centers(jdom)
        self.pos = [np.array(p - 0.5) for p in (px, py, pz)]
        self.values = {t: np.array(jnoise.evaluate(
            *(jnp.asarray(p) for p in self.pos), time=t)) for t in (0.0, 0.7)}

    def evaluate(self, px, py, pz, time=0.0):
        for got, want in zip((px, py, pz), self.pos):
            np.testing.assert_array_equal(_np(got), want)
        return torch.from_numpy(self.values[time])


@pytest.mark.parametrize("size", [(20, 18, 16), (20, 18, 1)])
def test_emission_and_noise_match_reference(noise_fields, size):
    jdom, dom = _doms(size)
    jn, tn = noise_fields[size]
    rng = np.random.RandomState(8)
    flags = np.array(jfl.fill_grid(jfl.init_domain(jdom, 1)))
    flags[..., :4] = jfl.TypeEmpty
    dens = (rng.rand(*jdom.shape) * 0.5).astype(np.float32)
    src = (rng.rand(*jdom.shape)).astype(np.float32)
    tex = (rng.rand(*jdom.shape) - 0.3).astype(np.float32)
    kw = dict(center=(size[0] * 0.5, size[1] * 0.3, size[2] * 0.5),
              radius=size[0] * 0.3, z=(0.0, 2.0, 0.0))
    js, ts = jsh.Cylinder(**kw), tsh.Cylinder(**kw)
    sdf = np.array(js.compute_levelset(jdom))
    for sigma, scale, time in ((0.0, 1.0, 0.0), (2.0, 0.8, 0.7)):
        ref = jini.density_inflow(jnp.asarray(flags), jnp.asarray(dens), jn,
                                  js, jdom, scale, sigma, time)
        got = tini.density_inflow(_t(flags), _t(dens), tn, ts, dom, scale,
                                  sigma, time)
        np.testing.assert_allclose(_np(got), np.array(ref), rtol=0,
                                   atol=1e-6)
    for s_ in (None, sdf):
        ref = jini.add_noise(jnp.asarray(flags), jnp.asarray(dens), jn, jdom,
                             None if s_ is None else jnp.asarray(s_), 0.1)
        got = tini.add_noise(_t(flags), _t(dens), tn, dom,
                             None if s_ is None else _t(s_), 0.1)
        np.testing.assert_array_equal(_np(got), np.array(ref))
    for texture in (None, tex):
        for absolute in (True, False):
            ref = jini.apply_emission(
                jnp.asarray(flags), jnp.asarray(dens), jnp.asarray(src), jdom,
                None if texture is None else jnp.asarray(texture), absolute)
            got = tini.apply_emission(
                _t(flags), _t(dens), _t(src), dom,
                None if texture is None else _t(texture), absolute)
            np.testing.assert_array_equal(_np(got), np.array(ref))


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("bound", [0, 2])
def test_check_symmetry_matches_reference(axis, bound):
    size = (11, 10, 9)
    jdom, dom = _doms(size)
    rng = np.random.RandomState(10 + axis)
    a = rng.randn(*jdom.shape).astype(np.float32)
    v = rng.randn(3, *jdom.shape).astype(np.float32)
    err = np.full(jdom.shape, -1.0, np.float32)
    for sym in (False, True):
        ra, re = jini.check_symmetry(jnp.asarray(a), jdom, jnp.asarray(err),
                                     sym, axis, bound)
        ga, ge = tini.check_symmetry(_t(a), dom, _t(err), sym, axis, bound)
        np.testing.assert_array_equal(_np(ga), np.array(ra))
        np.testing.assert_array_equal(_np(ge), np.array(re))
        for disable in (0, 1, 6):
            ra, re = jini.check_symmetry_vec3(jnp.asarray(v), jdom,
                                              jnp.asarray(err), sym, axis,
                                              bound, disable)
            ga, ge = tini.check_symmetry_vec3(_t(v), dom, _t(err), sym,
                                              axis, bound, disable)
            np.testing.assert_array_equal(_np(ga), np.array(ra))
            np.testing.assert_array_equal(_np(ge), np.array(re))
    ra, re = jini.check_symmetry(jnp.asarray(a), jdom)
    ga, ge = tini.check_symmetry(_t(a), dom)
    assert re is None and ge is None
    np.testing.assert_array_equal(_np(ga), np.array(ra))


@pytest.mark.parametrize("size", [(14, 12, 10), (14, 12, 1)])
@pytest.mark.parametrize("sigma", [0.5, 1.0, 2.2])
def test_blurs_match_reference(size, sigma):
    jdom, dom = _doms(size)
    rng = np.random.RandomState(12)
    g = rng.randn(*jdom.shape).astype(np.float32)
    v = rng.randn(3, *jdom.shape).astype(np.float32)
    np.testing.assert_allclose(
        _np(tini.blur_real_grid(_t(g), dom, sigma)),
        np.array(jini.blur_real_grid(jnp.asarray(g), jdom, sigma)),
        rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        _np(tini.blur_mac_grid(_t(v), dom, sigma)),
        np.array(jini.blur_mac_grid(jnp.asarray(v), jdom, sigma)),
        rtol=0, atol=1e-6)


@pytest.mark.parametrize("size", [(11, 10, 9), (11, 10, 1)])
def test_symmetry_masks_and_gauss_kernel_match_reference(size):
    jdom, dom = _doms(size)
    for ax in (0, 1, 2):
        np.testing.assert_array_equal(
            _np(tini._axis_index_grid(dom, ax, CPU)),
            np.asarray(jini._axis_index_grid(jdom, ax)))
        for bound in (1, 2):
            mid = size[0] - 1 - jini._axis_index_grid(jdom, 2)
            np.testing.assert_array_equal(
                _np(tini._inbounds_mask(dom, bound, ax, CPU)),
                np.asarray(jini._inbounds_mask(jdom, bound, ax)))
            np.testing.assert_array_equal(
                _np(tini._inbounds_mask(dom, bound, 2, CPU,
                                        _t(np.asarray(mid)))),
                np.asarray(jini._inbounds_mask(jdom, bound, 2, mid)))
    for sigma in (0.5, 1.0, 2.2):
        k, r = tini._gauss_kernel_1d(sigma)
        jk, jr = jini._gauss_kernel_1d(sigma)
        assert r == jr
        np.testing.assert_array_equal(k, np.asarray(jk))
