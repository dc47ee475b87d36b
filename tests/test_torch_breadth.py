"""The port's grid4d, fire, k-epsilon, wave-equation and wavelet-turbulence
modules against the JAX package's on the CPU, on the same seeded inputs at
16³-24³ (the JAX tests' own sizes, ``tests/test_breadth_ops.py`` and
``tests/test_grid4d.py``).

Tolerances: exact where only integer or max/min work differs (flags, the
UV reset, the clamps' branches); 1e-6 x max(1, max|field|) for elementwise
and gather work (XLA may contract multiply-adds into FMAs on the CPU); the
wave equation's CG by its iterations (within 2) and 1e-5 on the solution.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mantaflow_tpu.core import flags as jfl
from mantaflow_tpu.core import grid4d as jg4
from mantaflow_tpu.core.domain import Domain as JDomain
from mantaflow_tpu.ops import fire as jfire
from mantaflow_tpu.ops import kepsilon as jke
from mantaflow_tpu.ops import turbulence as jtur
from mantaflow_tpu.ops import waves as jwav
from mantaflow_tpu.utils import noise as jn
from mantaflow_tpu_torch.core import grid4d as tg4
from mantaflow_tpu_torch.core.domain import Domain
from mantaflow_tpu_torch.ops import fire as tfire
from mantaflow_tpu_torch.ops import kepsilon as tke
from mantaflow_tpu_torch.ops import turbulence as ttur
from mantaflow_tpu_torch.ops import waves as twav
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


def _doms(size, dim=3):
    return JDomain(size=size, dim=dim), Domain(size=size, dim=dim)


def _pair(a):
    a = np.ascontiguousarray(a)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _flags(size, dim=3, bw=1, open_s=None, obstacle=True):
    jdom, dom = _doms(size, dim)
    jf = jfl.fill_grid(jfl.init_domain(jdom, bw))
    if open_s:
        jf = jfl.set_open_bound(jf, jdom, bw, open_s)
    f = np.asarray(jf).copy()
    if obstacle:
        f[tuple(slice(s // 3, s // 3 + 2) for s in f.shape)] = \
            jfl.TypeObstacle
    return _pair(f.astype(np.int32))


# ---------------------------------------------------------------------------
# grid4d

def test_grid4d_matches_reference():
    rng = np.random.RandomState(0)
    data = rng.standard_normal((6, 5, 7, 8)).astype(np.float32)
    jd, td = _pair(data)
    pos = [rng.uniform(-2.0, n + 2.0, (4, 3, 5)).astype(np.float32)
           for n in (8, 7, 5, 6)]
    jp = [jnp.asarray(p) for p in pos]
    tp = [torch.from_numpy(p.copy()) for p in pos]
    _close(tg4.interpol4d(td, *tp), jg4.interpol4d(jd, *jp))
    z = tg4.zeros4d((8, 7, 5, 6), channels=4, device=CPU)
    assert z.shape == jg4.zeros4d((8, 7, 5, 6), channels=4).shape
    assert tg4.zeros4d((8, 7, 5, 6), device=CPU).shape == (6, 5, 7, 8)
    np.testing.assert_array_equal(_np(tg4.get_slice_t(td, 2)),
                                  np.asarray(jg4.get_slice_t(jd, 2)))
    vol = rng.standard_normal((5, 7, 8)).astype(np.float32)
    jv, tv = _pair(vol)
    np.testing.assert_array_equal(_np(tg4.set_slice_t(td, 3, tv)),
                                  np.asarray(jg4.set_slice_t(jd, 3, jv)))
    assert float(tg4.max_abs(td)) == float(jg4.max_abs(jd))


# ---------------------------------------------------------------------------
# fire

@pytest.mark.parametrize("colors", [True, False], ids=["rgb_heat", "plain"])
def test_fire_matches_reference(colors):
    size = (16, 16, 16)
    jdom, dom = _doms(size)
    rng = np.random.RandomState(1)
    fields = [np.where(rng.rand(16, 16, 16) < 0.5,
                       rng.rand(16, 16, 16) * 1.5, 0.0).astype(np.float32)
              for _ in range(7)]
    j = [jnp.asarray(f) for f in fields]
    t = [torch.from_numpy(f.copy()) for f in fields]
    extra_j = j[3:] if colors else [None] * 4
    extra_t = t[3:] if colors else [None] * 4
    jo = jfire.process_burn(*j[:3], 0.5, jdom, *extra_j, burning_rate=0.6,
                            flame_smoke=1.2)
    to = tfire.process_burn(*t[:3], 0.5, dom, *extra_t, burning_rate=0.6,
                            flame_smoke=1.2)
    for got, ref in zip(to, jo):
        assert (got is None) == (ref is None)
        if ref is not None:
            _close(got, ref)
    _close(tfire.update_flame(t[2], t[0], dom),
           jfire.update_flame(j[2], j[0], jdom))


# ---------------------------------------------------------------------------
# k-epsilon

def test_kepsilon_matches_reference():
    size = (24, 20, 16)
    jdom, dom = _doms(size)
    jf, tf = _flags(size)
    rng = np.random.RandomState(2)
    jv, tv = _pair((rng.standard_normal((3, 16, 20, 24)) * 0.3).astype(
        np.float32))
    # k, eps with negative and tiny values: the clamp's three branches
    k = (rng.rand(16, 20, 24) * 0.5 - 0.05).astype(np.float32)
    eps = (rng.rand(16, 20, 24) * 0.2 - 0.02).astype(np.float32)
    eps[eps == 0] = 1e-3
    jk, tk = _pair(k)
    je, te = _pair(eps)
    for fill in (True, False):
        for got, ref in zip(tke.bcs(tf, tk, te, 0.1, 0.1, fill),
                            jke.bcs(jf, jk, je, 0.1, 0.1, fill)):
            np.testing.assert_array_equal(_np(got), np.asarray(ref))
    for got, ref in zip(tke._turbulence_clamp(tk, te),
                        jke._turbulence_clamp(jk, je)):
        _close(got, ref)
    _close(tke._fill_in_boundary(tv, dom), jke._fill_in_boundary(jv, jdom))
    to = tke.compute_production(tv, tk, te, dom, pscale=2.5)
    jo = jke.compute_production(jv, jk, je, jdom, pscale=2.5)
    for got, ref in zip(to, jo):
        _close(got, ref)
    tk2, te2, tprod, tnu, _ = to
    jk2, je2, jprod, jnu, _ = jo
    for got, ref in zip(tke.sources(tk2, te2, tprod, 0.5),
                        jke.sources(jk2, je2, jprod, 0.5)):
        _close(got, ref)
    for vel in (True, False):
        got = tke.gradient_diffusion(tk2, te2, tnu, 0.5, dom, 10.0,
                                     tv if vel else None)
        ref = jke.gradient_diffusion(jk2, je2, jnu, 0.5, jdom, 10.0,
                                     jv if vel else None)
        for g, r in zip(got, ref):
            assert (g is None) == (r is None)
            if r is not None:
                _close(g, r)


# ---------------------------------------------------------------------------
# wave equation

@pytest.mark.parametrize("crank_nic", [False, True])
def test_wave_equation_matches_reference(crank_nic):
    size = (48, 40, 1)
    jdom, dom = _doms(size, 2)
    jf, tf = _flags(size, 2, 0, obstacle=False)
    h = np.zeros((1, 40, 48), np.float32)
    h[0, 14:24, 14:26] = 2.0
    prev = h.copy()
    prev[0, 15:23, 15:25] = 1.5
    jh, th = _pair(h)
    jp, tp = _pair(prev)
    _close(twav.calc_sec_deriv_2d(th, dom), jwav.calc_sec_deriv_2d(jh, jdom))
    assert float(twav.total_sum(th, dom)) == float(jwav.total_sum(jh, jdom))
    _close(twav.normalize_sum_to(th, dom, 300.0),
           jwav.normalize_sum_to(jh, jdom, 300.0))
    vel = np.zeros_like(h)
    for got, ref in zip(twav.explicit_wave_step(tf, th, tp, vel, 0.9, dom,
                                                0.12),
                        jwav.explicit_wave_step(jf, jh, jp, vel, 0.9, jdom,
                                                0.12)):
        _close(got, ref)
    for _ in range(3):
        tn_, tprev, tit, trn = twav.cg_solve_wave_eq(tf, th, tp, 1.0, dom,
                                                     crank_nic, 0.1)
        jn_, jprev, jit, jrn = jwav.cg_solve_wave_eq(jf, jh, jp, 1.0, jdom,
                                                     crank_nic, 0.1)
        assert abs(int(tit) - int(jit)) <= 2
        _close(tn_, jn_, 1e-5)
        assert tprev is th  # utm1 <- ut, ut <- the solution
        _close(tprev, jprev, 1e-5)
        th, tp, jh, jp = tn_, tprev, jn_, jprev
    assert float(trn) < 1e-5 and int(tit) > 1


# ---------------------------------------------------------------------------
# wavelet turbulence

@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("dim", [3, 2])
def test_interpolation_matches_reference(order, dim):
    src = (12, 10, 8) if dim == 3 else (12, 10, 1)
    tgt = (24, 20, 16) if dim == 3 else (24, 20, 1)
    jsd, sd = _doms(src, dim)
    jtd, td = _doms(tgt, dim)
    rng = np.random.RandomState(3)
    shp = sd.shape
    jg, tg = _pair(rng.standard_normal(shp).astype(np.float32))
    jm, tm = _pair(rng.standard_normal((3,) + shp).astype(np.float32))
    kw = dict(scale=(1.0, 0.9, 1.1), offset=(0.5, -1.0, 0.25))
    _close(ttur.interpolate_grid(td, tg, sd, order_space=order, **kw),
           jtur.interpolate_grid(jtd, jg, jsd, order_space=order, **kw))
    _close(ttur.interpolate_grid_vec3(td, tm, sd, order_space=order),
           jtur.interpolate_grid_vec3(jtd, jm, jsd, order_space=order))
    _close(ttur.interpolate_mac_grid(td, tm, sd, order_space=order, **kw),
           jtur.interpolate_mac_grid(jtd, jm, jsd, order_space=order, **kw))


def _noise_pair(dom, jdom):
    jf = jn.WaveletNoiseField(jdom, fixed_seed=11, load_from_file=True)
    tf = tn.WaveletNoiseField(dom, fixed_seed=11, load_from_file=True,
                              device=CPU)
    for f in (jf, tf):
        f.pos_scale = (4.0, 4.0, 4.0)
        f.time_anim = 0.3
    return jf, tf


def test_noise_application_matches_reference():
    size = (20, 16, 12)
    jdom, dom = _doms(size)
    jfl_, tfl_ = _flags(size)
    jno, tno = _noise_pair(dom, jdom)
    rng = np.random.RandomState(4)
    jv, tv = _pair(rng.standard_normal((3, 12, 16, 20)).astype(np.float32))
    jg, tg = _pair(rng.standard_normal((12, 16, 20)).astype(np.float32))
    jw, tw = _pair(rng.rand(12, 16, 20).astype(np.float32))
    _close(ttur.apply_simple_noise_vec3(tfl_, tv, tno, dom, 0.3, tw, 1.5),
           jtur.apply_simple_noise_vec3(jfl_, jv, jno, jdom, 0.3, jw, 1.5))
    _close(ttur.apply_simple_noise_real(tfl_, tg, tno, dom, 0.3, None, 1.5),
           jtur.apply_simple_noise_real(jfl_, jg, jno, jdom, 0.3, None, 1.5))
    _close(ttur.apply_noise_vec3(tfl_, tv, tno, dom, 0.3, 2.0),
           jtur.apply_noise_vec3(jfl_, jv, jno, jdom, 0.3, 2.0))
    # the uv and weight grids at half resolution: interpolated on the fly
    jhd, hd = _doms((10, 8, 6))
    juv, tuv = _pair((rng.rand(3, 6, 8, 10) * 9).astype(np.float32))
    jhw, thw = _pair(rng.rand(6, 8, 10).astype(np.float32))
    _close(ttur.apply_noise_vec3(tfl_, tv, tno, dom, 0.3, 1.0, thw, hd, tuv,
                                 hd, 2.0),
           jtur.apply_noise_vec3(jfl_, jv, jno, jdom, 0.3, 1.0, jhw, jhd, juv,
                                 jhd, 2.0))
    # the same resolution: used as they are
    juv2, tuv2 = _pair((rng.rand(3, 12, 16, 20) * 9).astype(np.float32))
    _close(ttur.apply_noise_vec3(tfl_, tv, tno, dom, 0.3, 1.0, tw, dom, tuv2,
                                 dom),
           jtur.apply_noise_vec3(jfl_, jv, jno, jdom, 0.3, 1.0, jw, jdom,
                                 juv2, jdom))


@pytest.mark.parametrize("dim", [3, 2])
def test_energy_vorticity_strain_coeffs_match_reference(dim):
    size = (20, 16, 12) if dim == 3 else (20, 16, 1)
    jdom, dom = _doms(size, dim)
    jf, tf = _flags(size, dim)
    rng = np.random.RandomState(5)
    jv, tv = _pair(rng.standard_normal((3,) + dom.shape).astype(np.float32))
    _close(ttur.compute_energy(tf, tv, dom), jtur.compute_energy(jf, jv, jdom))
    for got, ref in zip(ttur.compute_vorticity(tv, dom),
                        jtur.compute_vorticity(jv, jdom)):
        _close(got, ref)
    for c in range(3):
        _close(ttur.get_curl(tv, dom, c), jtur.get_curl(jv, jdom, c))
    _close(ttur.compute_strain_rate_mag(tv, dom),
           jtur.compute_strain_rate_mag(jv, jdom))
    je, te = _pair(np.asarray(jtur.compute_energy(jf, jv, jdom)))
    _close(ttur.compute_wavelet_coeffs(te, dom),
           jtur.compute_wavelet_coeffs(je, jdom))


def test_uv_grids_match_reference():
    size = (12, 10, 8)
    jdom, dom = _doms(size)
    off = (0.5, 1.0, -2.0)
    np.testing.assert_array_equal(
        _np(ttur.reset_uv_grid(dom, off, device=CPU)),
        np.asarray(jtur.reset_uv_grid(jdom, off)))
    rng = np.random.RandomState(6)
    juv, tuv = _pair((rng.rand(3, 8, 10, 12) * 5).astype(np.float32))
    resets = 0
    for step in range(24):
        time = step * 0.5
        for i in range(3):
            tu, tw = ttur.update_uv_weight(11.0, i, 3, tuv, time, 0.5, dom)
            ju, jw = jtur.update_uv_weight(11.0, i, 3, juv, time, 0.5, jdom)
            np.testing.assert_array_equal(_np(tu), np.asarray(ju))
            assert np.float32(tw) == np.float32(jw)
            resets += int(float(tu[0, 0, 0, 1]) == 1.0
                          and float(tuv[0, 0, 0, 1]) != 1.0)
            tuv, juv = tu, ju
    assert resets > 0  # the cycle wrapped and reset a grid


@pytest.mark.parametrize("what", ["real", "vec3", "int"])
def test_extrapolate_simple_flags_matches_reference(what):
    size = (16, 14, 12)
    jdom, dom = _doms(size)
    jf, tf = _flags(size)
    rng = np.random.RandomState(7)
    shp = ((3,) if what == "vec3" else ()) + dom.shape
    v = rng.standard_normal(shp).astype(np.float32)
    if what == "int":
        v = np.asarray(jf).copy()
    jv, tv = _pair(v)
    for frm, to in ((jfl.TypeFluid, jfl.TypeObstacle),
                    (jfl.TypeObstacle, jfl.TypeFluid)):
        _close(ttur.extrapolate_simple_flags(tf, tv, dom, 3, frm, to),
               jtur.extrapolate_simple_flags(jf, jv, jdom, 3, frm, to))
