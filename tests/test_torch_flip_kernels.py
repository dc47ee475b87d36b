"""The FLIP path's hand-written CUDA kernels vs their plain PyTorch
versions, on the card.

Cases marked ``gpu`` need a CUDA device and skip without one; run them on a
machine with a GPU (the JAX package is not needed there, hence no conftest):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_flip_kernels.py -m gpu

Fixture: the 24^3 corner dam of tests/test_flip_bucket.py, with made-up
particle velocities and a random grid velocity. Tolerances: the rebin is a
permutation and the extrapolation layer repeats the plain arithmetic in its
order (the kernels are built without fused multiply-adds), so both are
exact; the advection and both blends to abs 1e-6 (the JAX tests'
Pallas-vs-XLA tolerance); the gather p2g sums in another order than the
plain rolls, so p2g (fused or alone) to abs 1e-5 and the levelset (a min of
the same expressions, for a window of one, two or three cells) to 1e-6.
The unmarked cases run on the CPU: a wrapper refuses a tensor it cannot
launch on rather than computing it on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mantaflow_tpu_torch.core import flags as fl
from mantaflow_tpu_torch.core import particles as cp
from mantaflow_tpu_torch.core.domain import Domain
from mantaflow_tpu_torch.core.shapes import Sphere
from mantaflow_tpu_torch.models import flip
from mantaflow_tpu_torch.ops import advect_bucket_kernels as advk
from mantaflow_tpu_torch.ops import blend_kernels as blk
from mantaflow_tpu_torch.ops import extrapolation_kernels as xk
from mantaflow_tpu_torch.ops import flip_bucket as fb
from mantaflow_tpu_torch.ops import levelset_kernels as lsk
from mantaflow_tpu_torch.ops import p2g_kernels as p2gk
from mantaflow_tpu_torch.ops import rebin_kernels as rbk

FIELDS = ("px", "py", "pz", "vx", "vy", "vz")
BENCH = dict(gravity=(0.0, -0.003, 0.0), ghost_fluid=True, cg_accuracy=1e-3,
             ring_only_obstacles=True)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def corner24(device):
    dom = Domain(size=(24,) * 3)
    st = flip.make_dam_state_bucketed(dom, flip.FlipParams(**BENCH),
                                      dam_frac=(0.3, 0.3, 0.35), ppc=12,
                                      device=device)
    bk = st.buckets
    bk = dataclasses.replace(bk, vx=torch.where(bk.valid, bk.px * 0.01, 0.0),
                             vy=torch.where(bk.valid, bk.py * 0.02 - 0.05,
                                            0.0),
                             vz=torch.where(bk.valid, bk.pz * 0.005, 0.0))
    vel = np.random.RandomState(7).randn(3, 24, 24, 24).astype(np.float32)
    return dom, st.flags, bk, torch.tensor(vel * np.float32(0.25),
                                           device=device)


def _max_err(got, ref, fields=FIELDS):
    return max(float((getattr(got, f) - getattr(ref, f)).abs().max())
               for f in fields)


@pytest.mark.gpu
@pytest.mark.parametrize("n_pairs", [1, 3])
def test_extrap_layer_kernel_matches_plain(cuda, n_pairs):
    dom = Domain(size=(16, 14, 12))
    rng = np.random.RandomState(0)
    ms = [torch.tensor(rng.choice([0.0, 0.0, 1.0, 2.0, 2.5, 3.7],
                                  size=dom.shape).astype(np.float32),
                       device=cuda) for _ in range(n_pairs)]
    vs = [torch.tensor(rng.randn(*dom.shape).astype(np.float32), device=cuda)
          for _ in range(n_pairs)]
    for d, direction, upd in ((1, 0.0, True), (2, -1.0, True),
                              (1, -1.0, False)):
        before = xk.extrap_layer.launches
        gm, gv = xk.extrap_layer(ms, vs, dom, d, direction, upd)
        torch.cuda.synchronize()
        assert xk.extrap_layer.launches == before + 1
        rm, rv = xk.extrap_layer_plain(ms, vs, dom, d, direction, upd)
        for g, r in zip(gm + gv, rm + rv):
            assert torch.equal(g, r)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("ring_only", [True, False])
@pytest.mark.parametrize("pending", [True, False])
def test_advect_blend_kernel_matches_plain(cuda, mode, ring_only, pending):
    dom, flags, bk, vel = corner24(cuda)
    if not ring_only:  # a stamped sphere for the flags-at-position probes
        c = torch.arange(24, device=cuda) + 0.5
        zz, yy, xx = torch.meshgrid(c, c, c, indexing="ij")
        sphere = ((xx - 5.0) ** 2 + (yy - 4.0) ** 2
                  + (zz - 4.5) ** 2).sqrt() < 3.0
        flags = torch.where(sphere, fl.TypeObstacle, flags)
    vold = vel * 0.85
    for dt in (0.5, 2.5):
        args = (bk, flags, vel, vold, torch.tensor(dt, device=cuda),
                torch.tensor(pending, device=cuda), 0.97, dom, mode,
                ring_only)
        before = advk.advect_blend.launches
        got = advk.advect_blend(*args)
        torch.cuda.synchronize()
        assert advk.advect_blend.launches == before + 1
        ref = advk.advect_blend_plain(*args)
        assert torch.equal(got.valid, ref.valid)
        assert _max_err(got, ref) < 1e-6
        if not pending:
            for f in ("vx", "vy", "vz"):
                assert torch.equal(getattr(got, f), getattr(bk, f))


@pytest.mark.gpu
@pytest.mark.parametrize("scale", [1.0, 6.0])
def test_rebin_kernel_matches_plain_bitwise(cuda, scale):
    dom, flags, bk, vel = corner24(cuda)
    moved = fb.advect_bucketed(bk, flags, vel * scale,
                               torch.tensor(1.0, device=cuda), dom, 0)
    before = rbk.rebin_pass.launches
    got = rbk.rebin(moved, dom)
    torch.cuda.synchronize()
    assert rbk.rebin_pass.launches == before + 3
    ref = fb.rebin(moved, dom)
    assert torch.equal(got.valid, ref.valid)
    assert int(got.dropped) == int(ref.dropped)
    if scale > 1.0:
        assert int(got.dropped) > 0
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(ref, f)), f


@pytest.mark.gpu
def test_rebin_kernel_overflow_fixture(cuda):
    pos = np.array([[3.5, 3.5, 3.5], [2.6, 3.5, 3.5], [4.4, 3.5, 3.5],
                    [3.5, 2.7, 3.5], [3.5, 3.5, 4.3]], np.float32)
    pvel = np.arange(8 * 3, dtype=np.float32).reshape(8, 3) * np.float32(0.01)
    dom = Domain(size=(8, 8, 8))
    bk = fb.bin_from_particles(cp.make_particles(pos, capacity=8,
                                                 device=cuda), pvel, dom,
                               ppc=4)
    bk = dataclasses.replace(bk, **{
        f: torch.where(bk.valid, getattr(bk, f)
                       + 0.9 * (3.5 - getattr(bk, f)), getattr(bk, f))
        for f in ("px", "py", "pz")})
    got, ref = rbk.rebin(bk, dom), fb.rebin(bk, dom)
    assert int(got.dropped) == int(ref.dropped) == 1
    assert torch.equal(got.valid, ref.valid)
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(ref, f)), f


@pytest.mark.gpu
def test_p2g_union_kernel_matches_plain(cuda):
    dom, flags, bk, vel = corner24(cuda)
    moved = fb.rebin(fb.advect_bucketed(bk, flags, vel,
                                        torch.tensor(1.0, device=cuda), dom,
                                        0), dom)
    for b in (bk, moved):
        before = p2gk.p2g_union.launches
        v, w, phi = p2gk.p2g_union(b, dom, 1.0)
        torch.cuda.synchronize()
        assert p2gk.p2g_union.launches == before + 1
        rv, rw, rphi = p2gk.p2g_union_plain(b, dom, 1.0)
        assert float((v - rv).abs().max()) < 1e-5
        assert float((w - rw).abs().max()) < 1e-5
        assert float((phi - rphi).abs().max()) < 1e-6


def _moved(cuda):
    dom, flags, bk, vel = corner24(cuda)
    moved = fb.rebin(fb.advect_bucketed(bk, flags, vel,
                                        torch.tensor(1.0, device=cuda), dom,
                                        0), dom)
    return dom, bk, moved, vel


@pytest.mark.gpu
def test_p2g_mac_kernel_matches_plain(cuda):
    dom, bk, moved, _ = _moved(cuda)
    for b in (bk, moved):
        before = p2gk.p2g_mac.launches
        v, w = p2gk.p2g_mac(b, dom)
        torch.cuda.synchronize()
        assert p2gk.p2g_mac.launches == before + 1
        rv, rw = fb.p2g_mac(b, dom)
        assert float((v - rv).abs().max()) < 1e-5
        assert float((w - rw).abs().max()) < 1e-5
        # the fused kernel runs the same device code
        fv, fw, _ = p2gk.p2g_union(b, dom, 1.0)
        assert torch.equal(v, fv) and torch.equal(w, fw)


@pytest.mark.gpu
@pytest.mark.parametrize("radius_factor,rw", [(1.0, 1), (1.5, 2), (2.5, 3)])
def test_union_levelset_kernel_matches_plain(cuda, radius_factor, rw):
    dom, bk, moved, _ = _moved(cuda)
    assert fb.levelset_radius(dom, radius_factor)[1] == rw
    for b in (bk, moved):
        before = lsk.union_levelset.launches
        phi = lsk.union_levelset(b, dom, radius_factor)
        torch.cuda.synchronize()
        assert lsk.union_levelset.launches == before + 1
        ref = fb.union_levelset_bucketed(b, dom, radius_factor)
        assert float((phi - ref).abs().max()) < 1e-6


@pytest.mark.gpu
def test_flip_update_kernel_matches_plain(cuda):
    dom, bk, moved, vel = _moved(cuda)
    for b in (bk, moved):
        before = blk.flip_update.launches
        got = blk.flip_update(b, vel, vel * 0.85, 0.97, dom)
        torch.cuda.synchronize()
        assert blk.flip_update.launches == before + 1
        ref = fb.flip_update_bucketed(b, vel, vel * 0.85, 0.97, dom)
        assert _max_err(got, ref, ("vx", "vy", "vz")) < 1e-6
        for f in ("vx", "vy", "vz"):
            assert torch.equal(getattr(got, f)[~b.valid],
                               getattr(b, f)[~b.valid])


@pytest.mark.gpu
def test_finalize_then_step_equals_pending_step_on_card(cuda):
    """The standalone blend kernel applies what the advection kernel's
    fused blend applies."""
    dom = Domain(size=(16,) * 3)
    p = flip.FlipParams(gravity=(0.0, -0.003, 0.0), ghost_fluid=True,
                        radius_factor=2.5, cg_accuracy=1e-3)
    st = flip.make_dam_state_bucketed(
        dom, p, ppc=14, device=cuda,
        obstacle=Sphere(center=(11.2, 4.48, 8.0), radius=2.4))
    for _ in range(3):
        st = flip.flip_step_bucketed(st, dom, p)
    a = flip.flip_step_bucketed(st, dom, p)
    before = blk.flip_update.launches
    b = flip.flip_step_bucketed(flip.finalize_buckets(st, dom, p), dom, p)
    assert blk.flip_update.launches == before + 1
    for f in FIELDS + ("valid",):
        assert torch.equal(getattr(a.buckets, f), getattr(b.buckets, f)), f


ROUTES = {
    "bench": (BENCH, None, 10),
    "no_ghost_fluid": (dict(BENCH, ghost_fluid=False), None, 10),
    "obstacle_wide_radius": (dict(gravity=(0.0, -0.003, 0.0),
                                  ghost_fluid=True, radius_factor=2.5,
                                  cg_accuracy=1e-3),
                             dict(center=(11.2, 4.48, 8.0), radius=2.4), 14),
}


@pytest.mark.gpu
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_flip_steps_on_card_match_cpu(cuda, route):
    dom = Domain(size=(16,) * 3)
    kw, obs, ppc = ROUTES[route]
    p = flip.FlipParams(**kw)
    states = []
    for d in (cuda, "cpu"):
        st = flip.make_dam_state_bucketed(
            dom, p, ppc=ppc, device=d, obstacle=obs and Sphere(**obs))
        for _ in range(3):
            st = flip.flip_step_bucketed(st, dom, p)
        states.append(st)
    g, c = states
    assert torch.equal(g.flags.cpu(), c.flags)
    assert int(g.buckets.count()) == int(c.buckets.count())
    assert int(g.buckets.dropped) == int(c.buckets.dropped) == 0
    for name in ("vel", "phi", "pressure"):
        diff = getattr(g, name).cpu() - getattr(c, name)
        assert float(diff.abs().max()) < 2e-4, name


@pytest.mark.gpu
def test_flip_kernels_refuse_what_they_cannot_take(cuda):
    dom, flags, bk, vel = corner24(cuda)
    bad = dataclasses.replace(bk, px=bk.px.double())
    for call in (lambda: rbk.rebin(bad, dom),
                 lambda: p2gk.p2g_union(bad, dom),
                 lambda: p2gk.p2g_mac(bad, dom),
                 lambda: lsk.union_levelset(bad, dom, 2.5),
                 lambda: blk.flip_update(bad, vel, vel, 0.97, dom),
                 lambda: advk.advect_blend(bad, flags, vel, vel, 0.5, True,
                                           0.97, dom)):
        with pytest.raises(ValueError, match="contiguous float32"):
            call()
    with pytest.raises(ValueError, match="contiguous float32"):
        advk.advect_blend(bk, flags, vel[:, :, :, :8], vel, 0.5, True, 0.97,
                          dom)
    with pytest.raises(ValueError, match="contiguous float32"):
        blk.flip_update(bk, vel, vel[:, :, :, :8], 0.97, dom)
    g = vel[0].transpose(0, 2)
    with pytest.raises(ValueError, match="contiguous float32"):
        xk.extrap_layer([g], [g], dom, 1)


def _meta_buckets(dom):
    shape = (4, dom.num_cells)
    return fb.Buckets(*(torch.empty(shape, device="meta") for _ in FIELDS),
                      valid=torch.empty(shape, dtype=torch.bool,
                                        device="meta"),
                      dropped=torch.empty((), dtype=torch.int32,
                                          device="meta"))


@pytest.mark.parametrize("which", ["extrap_layer", "rebin_pass",
                                   "advect_blend", "p2g_union", "p2g_mac",
                                   "union_levelset", "flip_update"])
def test_flip_wrappers_raise_off_cpu_and_cuda(which):
    """A tensor on another device is refused, not computed on the CPU."""
    dom = Domain(size=(4, 4, 4))
    bk = _meta_buckets(dom)
    g = torch.empty(dom.shape, device="meta")
    vel = torch.empty((3,) + dom.shape, device="meta")
    calls = {
        "extrap_layer": lambda: xk.extrap_layer([g], [g], dom, 1),
        "rebin_pass": lambda: rbk.rebin_pass(bk, dom, 0),
        "advect_blend": lambda: advk.advect_blend(bk, g, vel, vel, 0.5, True,
                                                  0.97, dom),
        "p2g_union": lambda: p2gk.p2g_union(bk, dom),
        "p2g_mac": lambda: p2gk.p2g_mac(bk, dom),
        "union_levelset": lambda: lsk.union_levelset(bk, dom, 2.5),
        "flip_update": lambda: blk.flip_update(bk, vel, vel, 0.97, dom),
    }
    with pytest.raises(ValueError, match="unsupported device"):
        calls[which]()
