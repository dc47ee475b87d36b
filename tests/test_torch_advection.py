"""Window advection of mantaflow_tpu_torch vs mantaflow_tpu.

The port's ``window_pass`` runs its plain PyTorch version on CPU tensors; it
is held against the Pallas ``advection_pallas.window_pass`` run in interpret
mode, as the JAX package's own tests run it, on the same fixture
(tests/test_advection_pallas.py: 12x16x24, displacements of 3.8 > k=3).
Tolerances: abs 1e-6 for one pass (the reference's own kernel tolerance),
abs 1e-5 for the MacCormack drivers. The kernel itself is tested on the
card by tests/test_torch_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mantaflow_tpu.core import flags as jfl
from mantaflow_tpu.core.domain import Domain as JDomain
from mantaflow_tpu.ops import advection as jadv
from mantaflow_tpu.ops import advection_fast as jadvf
from mantaflow_tpu.ops import advection_pallas as jadvp
from mantaflow_tpu_torch.core import flags as tfl
from mantaflow_tpu_torch.core.domain import Domain
from mantaflow_tpu_torch.ops import advection as tadv
from mantaflow_tpu_torch.ops import advection_fast as tadvf
from mantaflow_tpu_torch.ops import advection_kernels as tadvk

VARIANTS = {"plain": (False, False), "minmax": (True, False),
            "minmax_ok": (True, True)}


@pytest.fixture(scope="module")
def fixture():
    rng = np.random.RandomState(0)
    Z, Y, X = 12, 16, 24
    src = rng.rand(Z, Y, X).astype(np.float32)
    ok = rng.rand(Z, Y, X) > 0.3
    zz, yy, xx = np.meshgrid(np.arange(Z), np.arange(Y), np.arange(X),
                             indexing="ij")
    disp = (rng.rand(3, Z, Y, X) * 2 - 1) * 3.8  # exceeds k: tests clamping
    pos = [(g + 0.5 + d).astype(np.float32)
           for g, d in ((xx, disp[0]), (yy, disp[1]), (zz, disp[2]))]
    return (X, Y, Z), src, ok, pos


def _compare(refs, outs, tol):
    if not isinstance(refs, tuple):
        refs, outs = (refs,), (outs,)
    assert len(refs) == len(outs)
    for r, o in zip(refs, outs):
        r = np.asarray(r)
        o = o.cpu().numpy()
        assert o.shape == r.shape and o.dtype == r.dtype
        if r.dtype == bool:
            np.testing.assert_array_equal(o, r)
        else:
            assert float(np.max(np.abs(o - r))) < tol


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_window_pass_matches_pallas(fixture, variant):
    size, src, ok, pos = fixture
    want_minmax, with_ok = VARIANTS[variant]
    ref = jadvp.window_pass(jnp.asarray(src), *map(jnp.asarray, pos),
                            JDomain(size=size), 3,
                            ok_mask=jnp.asarray(ok) if with_ok else None,
                            want_minmax=want_minmax)
    got = tadvk.window_pass(torch.tensor(src), *map(torch.tensor, pos),
                            Domain(size=size), 3,
                            ok_mask=torch.tensor(ok) if with_ok else None,
                            want_minmax=want_minmax)
    _compare(ref, got, 1e-6)
    assert tadvk.window_pass.launches == 0  # CPU tensors never launch


def test_window_interp_2d_matches_reference():
    rng = np.random.RandomState(4)
    Y, X = 10, 14
    src = rng.rand(1, Y, X).astype(np.float32)
    ok = rng.rand(1, Y, X) > 0.3
    yy, xx = np.meshgrid(np.arange(Y), np.arange(X), indexing="ij")
    px = (xx + 0.5 + rng.uniform(-2.5, 2.5, (Y, X)))[None].astype(np.float32)
    py = (yy + 0.5 + rng.uniform(-2.5, 2.5, (Y, X)))[None].astype(np.float32)
    pz = np.full_like(px, 0.5)
    ref = jadvf.window_interp(*(jnp.asarray(a) for a in (src, px, py, pz)),
                              JDomain(size=(X, Y, 1), dim=2), 2,
                              ok_mask=jnp.asarray(ok), want_minmax=True)
    got = tadvf.window_interp(*(torch.tensor(a) for a in (src, px, py, pz)),
                              Domain(size=(X, Y, 1), dim=2), 2,
                              ok_mask=torch.tensor(ok), want_minmax=True)
    _compare(ref, got, 1e-6)


@pytest.fixture(scope="module")
def flow():
    """Smooth CFL<=2 flow on a walled 3D domain (test_advection_pallas)."""
    res = 16
    t = np.linspace(0, 2 * np.pi, res)
    zz, yy, xx = np.meshgrid(t, t, t, indexing="ij")
    vel = np.stack([1.5 * np.sin(zz) * np.cos(yy),
                    1.5 * np.sin(xx) * np.cos(zz),
                    1.5 * np.sin(yy) * np.cos(xx)]).astype(np.float32)
    dens = (np.sin(2 * xx) * np.sin(yy) * 0.5 + 0.5).astype(np.float32)
    return res, vel, dens


def _flags(res, open_bound=""):
    jdom, dom = JDomain(size=(res,) * 3), Domain(size=(res,) * 3)
    jf = jfl.fill_grid(jfl.init_domain(jdom, 1), jfl.TypeFluid)
    tf = tfl.fill_grid(tfl.init_domain(dom, 1, device="cpu"), tfl.TypeFluid)
    if open_bound:
        jf = jfl.set_open_bound(jf, jdom, 1, open_bound)
        tf = tfl.set_open_bound(tf, dom, 1, open_bound)
    return jdom, dom, jf, tf


@pytest.mark.parametrize("order", [1, 2])
def test_advect_real_pl_matches_reference(flow, order):
    res, vel, dens = flow
    jdom, dom, jf, tf = _flags(res)
    ref = jadvp.advect_real_pl(jf, jnp.asarray(vel), jnp.asarray(dens), 1.0,
                               jdom, 2, order=order)
    got = tadvk.advect_real_pl(tf, torch.tensor(vel), torch.tensor(dens),
                               torch.tensor(1.0), dom, 2, order=order)
    _compare(ref, got, 1e-5)


@pytest.mark.parametrize("open_bound", ["", "yY"])
def test_advect_mac_pl_matches_reference(flow, open_bound):
    res, vel, _ = flow
    jdom, dom, jf, tf = _flags(res, open_bound)
    ref = jadvp.advect_mac_pl(jf, jnp.asarray(vel), jnp.asarray(vel), 1.0,
                              jdom, 2, has_outflow=bool(open_bound))
    got = tadvk.advect_mac_pl(tf, torch.tensor(vel), torch.tensor(vel),
                              torch.tensor(1.0), dom, 2,
                              has_outflow=bool(open_bound))
    _compare(ref, got, 1e-5)


def test_apply_outflow_bc_matches_reference(flow):
    res, vel, _ = flow
    jdom, dom, jf, tf = _flags(res, "xXyY")
    prev = np.roll(vel, 1, axis=-1) * 0.7
    ref = jadv.apply_outflow_bc(jf, jnp.asarray(vel), jnp.asarray(prev), 0.6,
                                jdom)
    got = tadv.apply_outflow_bc(tf, torch.tensor(vel), torch.tensor(prev),
                                torch.tensor(0.6), dom)
    _compare(ref, got, 1e-6)

