"""The port's vortex and guiding modules against the JAX package's on the
CPU, on seeded inputs at the JAX tests' sizes (``tests/test_vortex.py``
16³-24³, ``tests/test_guiding.py`` 32² and ``scenes/guiding_2d.py``'s
60²).

Tolerances: 1e-6 x max(1, max|value|) for the pairwise kernel, the
advection, the turbulence synthesis and the blur (elementwise and gather
work); the host-side K41 seeding bit for bit; the VIC splat 1e-5 (its
``index_add_`` order) and its l2-exit CG solves by residual (1e-5 of
max|solution| at the JAX package's iteration count within 2); the PD
guiding loop's iterations equal and its velocity and pressure 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mantaflow_tpu.core import flags as jfl
from mantaflow_tpu.core import shapes as jsh
from mantaflow_tpu.core.domain import Domain as JDomain
from mantaflow_tpu.ops import guiding as jgd
from mantaflow_tpu.ops import pressure as jprs
from mantaflow_tpu.ops import vortex as jvx
from mantaflow_tpu.utils import noise as jn
from mantaflow_tpu_torch.core import flags as tfl
from mantaflow_tpu_torch.core import shapes as tsh
from mantaflow_tpu_torch.core.domain import Domain
from mantaflow_tpu_torch.ops import guiding as tgd
from mantaflow_tpu_torch.ops import vortex as tvx
from mantaflow_tpu_torch.utils import noise as tn

CPU = "cpu"


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


def _particles(rng, n_vp=12, n_pts=300):
    pos = (8 + 8 * rng.rand(n_vp, 3)).astype(np.float32)
    vort = rng.standard_normal((n_vp, 3)).astype(np.float32)
    vort[0] = 0.0  # a particle without strength
    sigma = (1.0 + 2.0 * rng.rand(n_vp)).astype(np.float32)
    active = rng.rand(n_vp) < 0.8
    pts = (6 + 12 * rng.rand(n_pts, 3)).astype(np.float32)
    pts[:3] = pos[:3]  # points on the particles themselves (r = 0)
    return pos, vort, sigma, active, pts


def test_vortex_kernel_and_advection_match_reference():
    rng = np.random.RandomState(0)
    pos, vort, sigma, active, pts = _particles(rng)
    j = [jnp.asarray(a) for a in (pos, vort, sigma, active, pts)]
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in
         (pos, vort, sigma, active, pts)]
    _close(tvx.vortex_kernel(t[4], t[0], t[1], t[2], t[3], 0.7),
           jvx.vortex_kernel(j[4], j[0], j[1], j[2], j[3], 0.7))
    for mode in (0, 1, 2):
        _close(tvx.vp_advect_points(t[4], t[0], t[1], t[2], t[3], 0.5, mode),
               jvx.vp_advect_points(j[4], j[0], j[1], j[2], j[3], 0.5, mode))
    _close(tvx.vp_advect_points(t[0], t[0], t[1], t[2], t[3], 0.5, 2,
                                self_adv=True),
           jvx.vp_advect_points(j[0], j[0], j[1], j[2], j[3], 0.5, 2,
                                self_adv=True))


def test_k41_seeding_is_bitwise():
    size = (16, 16, 16)
    jdom, dom = JDomain(size=size), Domain(size=size)
    jball = jsh.Sphere(center=(8.0, 8.0, 8.0), radius=4.0)
    tball = tsh.Sphere(center=(8.0, 8.0, 8.0), radius=4.0)
    for dt, prob in ((1.0, 1.0), (0.5, 0.3)):
        got = tvx.vp_seed_k41(tball, dom, dt, 1.0, 0.5, 2.0, prob)
        ref = jvx.vp_seed_k41(jball, jdom, dt, 1.0, 0.5, 2.0, prob)
        assert len(got[0]) > 5
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)


def test_hsv2rgb_matches_reference():
    h = np.linspace(-0.2, 1.3, 61).astype(np.float32)
    jh, th = _pair(h)
    _close(tvx.hsv2rgb(th, 0.75, 1.0), jvx.hsv2rgb(jh, 0.75, 1.0))
    jv, tv = _pair(np.linspace(0.1, 1.0, 61).astype(np.float32))
    _close(tvx.hsv2rgb(th, 0.3, tv), jvx.hsv2rgb(jh, 0.3, jv))


@pytest.mark.parametrize("dim", [3, 2])
def test_synthesize_turbulence_matches_reference(dim):
    size = (24, 24, 24) if dim == 3 else (24, 24, 1)
    jdom, dom = JDomain(size=size, dim=dim), Domain(size=size, dim=dim)
    rng = np.random.RandomState(1)
    jno = jn.WaveletNoiseField(jdom, fixed_seed=11, load_from_file=True)
    tno = tn.WaveletNoiseField(dom, fixed_seed=11, load_from_file=True,
                               device=CPU)
    jflags = jfl.fill_grid(jfl.init_domain(jdom))
    tflags = tfl.fill_grid(tfl.init_domain(dom, device=CPU))
    jk, tk = _pair(rng.rand(*dom.shape).astype(np.float32))
    pos = rng.uniform(-1.0, 25.0, (200, 3)).astype(np.float32)
    if dim == 2:
        pos[:, 2] = 0.5
    tex0 = (pos + rng.standard_normal(pos.shape)).astype(np.float32)
    tex1 = (pos - rng.standard_normal(pos.shape)).astype(np.float32)
    j = [jnp.asarray(a) for a in (pos, tex0, tex1)]
    t = [torch.from_numpy(a.copy()) for a in (pos, tex0, tex1)]
    for alpha in (1.0, 0.3):
        got = tvx.synthesize_turbulence(*t, tflags, tk, tno, dom, alpha, 0.5,
                                        2, 0.5, 1 / 0.2, 0.015)
        ref = jvx.synthesize_turbulence(*j, jflags, jk, jno, jdom, alpha,
                                        0.5, 2, 0.5, 1 / 0.2, 0.015)
        for g, r in zip(got, ref):
            _close(g, r)
        assert float((got[0] - t[0]).abs().max()) > 1e-4


def test_density_from_levelset_matches_reference():
    size = (16, 16, 16)
    jdom, dom = JDomain(size=size), Domain(size=size)
    rng = np.random.RandomState(2)
    jp, tp = _pair((rng.standard_normal(dom.shape) * 2).astype(np.float32))
    _close(tvx.density_from_levelset(tp, dom, 0.8, 1.5),
           jvx.density_from_levelset(jp, jdom, 0.8, 1.5))


def test_vic_integration_matches_reference():
    """VICintegration on a shell of seeded triangles: the splat 1e-5, the
    three l2-exit solves within the reference's residual."""
    size = (16, 16, 16)
    jdom, dom = JDomain(size=size), Domain(size=size)
    rng = np.random.RandomState(3)
    d = rng.standard_normal((150, 3))
    centers = (8.0 + 4.0 * d / np.linalg.norm(d, axis=1, keepdims=True)
               ).astype(np.float32)
    tvort = rng.standard_normal((150, 3)).astype(np.float32)
    areas = (0.2 + 0.3 * rng.rand(150)).astype(np.float32)
    jflags = jfl.fill_grid(jfl.init_domain(jdom))
    tflags = tfl.fill_grid(tfl.init_domain(dom, device=CPU))
    jv, jw = jvx.vic_integration(centers, tvort, areas, jflags, jdom, 1.5,
                                 cg_accuracy=1e-4, scale=0.1)
    tv, tw = tvx.vic_integration(centers, tvort, areas, tflags, dom, 1.5,
                                 cg_accuracy=1e-4, scale=0.1)
    _close(tw, jw, 1e-5)
    assert float(np.abs(np.asarray(jv)).max()) > 1e-6
    _close(tv, jv, 1e-5)


def test_guiding_helpers_match_reference():
    for dim, size in ((2, (32, 28, 1)), (3, (16, 14, 12))):
        jdom = JDomain(size=size, dim=dim)
        dom = Domain(size=size, dim=dim)
        for r in (1, 2, 5):
            _close(tgd.gaussian_kernel_1d(r, device=CPU),
                   jgd.gaussian_kernel_1d(r))
        for w3 in (False, True):
            _close(tgd.get_spiral_velocity(dom, 1.5, w3, device=CPU),
                   jgd.get_spiral_velocity(jdom, 1.5, w3))
        rng = np.random.RandomState(4)
        jw, tw = _pair(rng.rand(*dom.shape).astype(np.float32))
        for lo, hi, a, b in ((0, 10, 1.0, 5.0), (5, 5, 2.0, 3.0)):
            _close(tgd.set_gradient_y_weight(tw, dom, lo, hi, a, b),
                   jgd.set_gradient_y_weight(jw, jdom, lo, hi, a, b))
        f = np.asarray(jfl.fill_grid(jfl.init_domain(jdom, 1))).copy()
        f[tuple(slice(s // 3, s // 3 + 2) for s in f.shape)] = \
            jfl.TypeObstacle
        jf, tf = _pair(f)
        jv, tv = _pair(rng.standard_normal((3,) + dom.shape).astype(
            np.float32))
        _close(tgd.separable_blur_mac(tv, tf, dom,
                                      tgd.gaussian_kernel_1d(2, device=CPU)),
               jgd.separable_blur_mac(jv, jf, jdom,
                                      jgd.gaussian_kernel_1d(2)))


@pytest.mark.parametrize("res,sigma", [(32, 1.0), (60, 0.99)])
def test_pd_fluid_guiding_matches_reference(res, sigma):
    """The PD loop on the spiral target from rest (tests/test_guiding.py:
    weight 1, blur radius 2, at 32²; and at scenes/guiding_2d.py's 60²
    with its sigma 0.99), the nested CG at 1e-5 so that its exit does not
    decide the comparison: iterations equal, velocity and pressure 1e-5.
    (With the weights 1 and 5 and PcNone the JAX package's loop itself
    diverges from rest; the scene's PcMGStatic case is the next test, and
    tests/ref_scenes/test_1050_guiding2d.py's replay in
    tests/test_torch_scene_paths.py drives its PcNone steps.)"""
    size = (res, res, 1)
    jdom, dom = JDomain(size=size, dim=2), Domain(size=size, dim=2)
    jf = jfl.fill_grid(jfl.init_domain(jdom, 1))
    tf = tfl.fill_grid(tfl.init_domain(dom, 1, device=CPU))
    jvt = jgd.get_spiral_velocity(jdom, 0.5 * res / 32)
    tvt = tgd.get_spiral_velocity(dom, 0.5 * res / 32, device=CPU)
    jw, tw = _pair(np.ones(dom.shape, np.float32))
    jv, tv = _pair(np.zeros((3,) + dom.shape, np.float32))
    kw = dict(blur_radius=2, sigma=sigma, max_iters=40, cg_accuracy=1e-5)
    ref = jgd.pd_fluid_guiding(jv, jvt, jf, jw, jdom, **kw)
    got = tgd.pd_fluid_guiding(tv, tvt, tf, tw, dom, **kw)
    assert int(got[2]) == int(ref[2]) and 1 < int(ref[2]) < 40
    _close(got[0], ref[0], 1e-5)
    _close(got[1], ref[1], 1e-5)


def test_pd_fluid_guiding_multigrid_matches_reference():
    """scenes/guiding_2d.py's own call at 64²: weights 1 below and 5 above
    mid-height, blur radius 2, sigma 0.99, PcMGStatic with its CG at 1e-3:
    iterations equal, velocity and pressure 1e-5."""
    res = 64
    size = (res, res, 1)
    jdom, dom = JDomain(size=size, dim=2), Domain(size=size, dim=2)
    jf = jfl.fill_grid(jfl.init_domain(jdom, 1))
    tf = tfl.fill_grid(tfl.init_domain(dom, 1, device=CPU))
    jvt = jgd.get_spiral_velocity(jdom, 0.5)
    tvt = tgd.get_spiral_velocity(dom, 0.5, device=CPU)
    w = np.ones(dom.shape, np.float32)
    w[:, res // 2:] = 5.0
    jw, tw = _pair(w)
    jv, tv = _pair(np.zeros((3,) + dom.shape, np.float32))
    kw = dict(blur_radius=2, sigma=0.99, preconditioner=jprs.PcMGStatic,
              zero_pressure_fixing=True)
    ref = jgd.pd_fluid_guiding(jv, jvt, jf, jw, jdom, **kw)
    got = tgd.pd_fluid_guiding(tv, tvt, tf, tw, dom, **kw)
    assert int(got[2]) == int(ref[2]) and 1 < int(ref[2]) < 200
    _close(got[0], ref[0], 1e-5)
    _close(got[1], ref[1], 1e-5)
