"""The FLIP path's hand-written CUDA kernels vs their plain PyTorch
versions, on the card.

Cases marked ``gpu`` need a CUDA device and skip without one; run them on a
machine with a GPU (the JAX package is not needed there, hence no conftest):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_flip_kernels.py -m gpu

Fixture: the 24^3 corner dam of tests/test_flip_bucket.py, with made-up
particle velocities and a random grid velocity; for the z-slab forms of
the sharded step, the 16^3 dam of tests/test_flip_sharded.py:145-162 with
particles displaced across the slab faces. Tolerances: the rebin is a
permutation and the extrapolation layer repeats the plain arithmetic in its
order (the kernels are built without fused multiply-adds), so both are
exact; the advection and both blends to abs 1e-6 (the JAX tests'
Pallas-vs-XLA tolerance); the gather p2g sums in another order than the
plain rolls, so p2g (fused or alone) to abs 1e-5 and the levelset (a min of
the same expressions, for a window of one, two or three cells; also on
made-up gap-free buckets of 1 to 40 slots, empty and full, over 19x23x29)
to 1e-6.
The z-slab forms equal the one-domain kernels on the slab's cells bit for
bit (the same device code reads the same corners and sources), and the
z rebin of a slab (K9) its plain version. The transfer (fused and alone,
one gather) also on made-up buckets of 1 to 40 slots with made-up
velocities, where a face's weight reaches ~68 and is held to abs 1e-5
plus 1e-6 of itself (its float32 spacing there is 7.6e-6); two launches
bitwise equal; its z-slab form over 2- and 32-plane slabs bitwise equal to
the one-domain launch. The unmarked cases run on the CPU: a wrapper refuses
a tensor it cannot launch on rather than computing it on the CPU, and the
launch plans cover the domain and mirror the kernels' constants.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mantaflow_tpu_torch.core import flags as fl
from mantaflow_tpu_torch.core import particles as cp
from mantaflow_tpu_torch.core.domain import Domain
from mantaflow_tpu_torch.core.shapes import Sphere
from mantaflow_tpu_torch.kernels import _build
from mantaflow_tpu_torch.models import flip
from mantaflow_tpu_torch.ops import advect_bucket_kernels as advk
from mantaflow_tpu_torch.ops import blend_kernels as blk
from mantaflow_tpu_torch.ops import extrapolation_kernels as xk
from mantaflow_tpu_torch.ops import flip_bucket as fb
from mantaflow_tpu_torch.ops import levelset_kernels as lsk
from mantaflow_tpu_torch.ops import p2g_kernels as p2gk
from mantaflow_tpu_torch.ops import rebin_kernels as rbk
from mantaflow_tpu_torch.parallel import sharding as shd

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
@pytest.mark.parametrize("n_pairs", [1, 2, 3])
def test_extrap_layer_2d_kernel_matches_plain(cuda, n_pairs):
    """The layer kernel's 2D instance (four neighbours, no z test) against
    its plain version, exactly."""
    dom = Domain(size=(37, 29, 1), dim=2)
    rng = np.random.RandomState(1)
    ms = [torch.tensor(rng.choice([0.0, 0.0, 1.0, 2.0, 2.5, 3.7],
                                  size=dom.shape).astype(np.float32),
                       device=cuda) for _ in range(n_pairs)]
    vs = [torch.tensor(rng.randn(*dom.shape).astype(np.float32), device=cuda)
          for _ in range(n_pairs)]
    for d, direction, upd in ((1, 0.0, True), (2, -1.0, True),
                              (1, -1.0, False), (3, 1.0, True)):
        before = xk.extrap_layer.launches
        gm, gv = xk.extrap_layer(ms, vs, dom, d, direction, upd)
        torch.cuda.synchronize()
        assert xk.extrap_layer.launches == before + 1
        rm, rv = xk.extrap_layer_plain(ms, vs, dom, d, direction, upd)
        for g, r in zip(gm + gv, rm + rv):
            assert torch.equal(g, r)
        assert any(not torch.equal(g, m) for g, m in zip(gm, ms))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("ring_only", [True, False])
@pytest.mark.parametrize("stop", [True, False])
def test_advect_forms_kernel_matches_plain(cuda, mode, ring_only, stop):
    """The kernel's instances without the blend (``advect``) and without
    stopping in obstacles (every form with stop_in_obstacle=False) against
    their plain versions, to abs 1e-6 as the step's form is held; the form
    without the blend passes the velocities through."""
    dom, flags, bk, vel = corner24(cuda)
    c = torch.arange(24, device=cuda) + 0.5
    zz, yy, xx = torch.meshgrid(c, c, c, indexing="ij")
    sphere = ((xx - 5.0) ** 2 + (yy - 4.0) ** 2 + (zz - 4.5) ** 2).sqrt() \
        < 3.0
    flags = torch.where(sphere, fl.TypeObstacle, flags)
    for dt in (0.5, 4.0):
        dt_t = torch.tensor(dt, device=cuda)
        before = advk.advect.launches
        got = advk.advect(bk, flags, vel, dt_t, dom, mode,
                          ring_only=ring_only, stop_in_obstacle=stop)
        torch.cuda.synchronize()
        assert advk.advect.launches == before + 1
        ref = fb.advect_bucketed(bk, flags, vel, dt_t, dom, mode, stop,
                                 ring_only)
        assert _max_err(got, ref) < 1e-6
        for f in ("vx", "vy", "vz"):
            assert torch.equal(getattr(got, f), getattr(bk, f))
        args = (bk, flags, vel, vel * 0.85, dt_t,
                torch.tensor(True, device=cuda), 0.97, dom, mode)
        kw = {"ring_only": ring_only, "stop_in_obstacle": stop}
        got = advk.advect_blend(*args, **kw)
        ref = advk.advect_blend_plain(*args, **kw)
        assert _max_err(got, ref) < 1e-6


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
                torch.tensor(pending, device=cuda), 0.97, dom, mode)
        before = advk.advect_blend.launches
        got = advk.advect_blend(*args, ring_only=ring_only)
        torch.cuda.synchronize()
        assert advk.advect_blend.launches == before + 1
        ref = advk.advect_blend_plain(*args, ring_only=ring_only)
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
    got = rbk.rebin_three_pass(moved, dom)
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
    got, ref = rbk.rebin_three_pass(bk, dom), fb.rebin(bk, dom)
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


def _synthetic_buckets(size, ppc, fill, device, seed=5):
    """Gap-free buckets over a domain of ``size`` (x, y, z): each cell holds
    ``fill`` particles ("random": 0..ppc, "full": ppc, "empty": 0), at
    random positions in the cell; free slots parked at the centre."""
    sx, sy, sz = size
    rng = np.random.default_rng(seed)
    T = sx * sy * sz
    n = {"random": rng.integers(0, ppc + 1, T), "full": np.full(T, ppc),
         "empty": np.zeros(T, np.int64)}[fill]
    # random cells left empty, so that some bricks' windows are empty too
    if fill == "random":
        n[rng.random(T) < 0.5] = 0
    valid = np.arange(ppc)[:, None] < n[None, :]
    flat = np.arange(T)
    centre = [(flat % sx) + 0.5, (flat // sx) % sy + 0.5, flat // (sx * sy)
              + 0.5]
    pos = [np.where(valid, c[None, :] + rng.uniform(-0.5, 0.5, (ppc, T)),
                    c[None, :]).astype(np.float32) for c in centre]
    zero = torch.zeros((ppc, T), dtype=torch.float32, device=device)
    return Domain(size=size), fb.Buckets(
        *(torch.tensor(p_, device=device) for p_ in pos), zero, zero, zero,
        torch.tensor(valid, device=device),
        torch.zeros((), dtype=torch.int32, device=device))


@pytest.mark.gpu
@pytest.mark.parametrize("ppc,fill", [(1, "random"), (24, "random"),
                                      (40, "random"), (24, "empty"),
                                      (9, "full")])
@pytest.mark.parametrize("radius_factor", [1.0, 1.5, 2.5, 4.0])
def test_union_levelset_kernel_synthetic_buckets(cuda, ppc, fill,
                                                 radius_factor):
    """Slot counts below, at and above one staged chunk (40: five), empty
    and full buckets, a domain (19x23x29) no brick divides; windows of 1-3
    cells (compiled in) and of 4 (read at run time)."""
    dom, bk = _synthetic_buckets((19, 23, 29), ppc, fill, cuda)
    before = lsk.union_levelset.launches
    phi = lsk.union_levelset(bk, dom, radius_factor)
    torch.cuda.synchronize()
    assert lsk.union_levelset.launches == before + 1
    ref = fb.union_levelset_bucketed(bk, dom, radius_factor)
    assert float((phi - ref).abs().max()) <= 1e-6


@pytest.mark.parametrize("rw,pc", [(1, 8), (2, 8), (3, 8), (10, 8), (30, 2)])
def test_levelset_plan_covers_the_domain(rw, pc):
    plan = lsk.levelset_plan((29, 23, 19), rw)
    bx, by, bz = lsk.LS_BRICK
    gx, gy, gz = plan.grid
    assert (gx - 1) * bx < 19 <= gx * bx
    assert (gy - 1) * by < 23 <= gy * by
    assert (gz - 1) * bz < 29 <= gz * bz
    assert plan.tile == (bx + 2 * rw) * (by + 2 * rw)
    assert plan.pc == pc and plan.smem_bytes <= lsk.SMEM_OPTIN_BYTES


def test_levelset_plan_refuses_a_window_too_wide():
    with pytest.raises(ValueError, match="does not fit"):
        lsk.levelset_plan((128, 128, 128), 60)


def _synthetic_moving(size, ppc, fill, device):
    """``_synthetic_buckets`` with made-up particle velocities (seed 6)."""
    dom, bk = _synthetic_buckets(size, ppc, fill, device)
    rng = np.random.default_rng(6)
    v = [torch.tensor(rng.standard_normal(tuple(bk.px.shape))
                      .astype(np.float32), device=device) for _ in range(3)]
    return dom, dataclasses.replace(
        bk, **{f: torch.where(bk.valid, v[i], 0.0)
               for i, f in enumerate(("vx", "vy", "vz"))})


def _p2g_close(got, ref):
    """vel to abs 1e-5, phi to 1e-6; the weight to abs 1e-5 plus 1e-6 of
    itself: at 40 slots a face sums up to ~68 of weight, whose float32
    spacing (7.6e-6) two orders of summing part by more than 1e-5 (on the
    H100 the earlier one-thread-per-destination gather, which sums in this
    gather's order, parts from the plain version by 5.7e-5 on the full
    40-slot fill, as this one does: tools/profile_torch_kernel_ab.py)."""
    v, w = got[:2]
    rv, rw = ref[:2]
    assert float((v - rv).abs().max()) < 1e-5
    assert bool(((w - rw).abs() <= 1e-5 + 1e-6 * rw.abs()).all())
    if len(got) == 3:
        assert float((got[2] - ref[2]).abs().max()) < 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize("ppc,fill", [(1, "random"), (24, "random"),
                                      (40, "random"), (24, "empty"),
                                      (40, "full")])
def test_p2g_kernels_synthetic_buckets(cuda, ppc, fill):
    """The fused transfer (K10) and the transfer alone (K11) on made-up
    gap-free buckets over 19x23x29 (no brick divides it), 1 to 40 slots
    (a full 40-slot plane is staged in several turns): each against its
    plain version, the two equal on vel and weight, and two launches of
    each bitwise equal."""
    dom, bk = _synthetic_moving((19, 23, 29), ppc, fill, cuda)
    before = (p2gk.p2g_union.launches, p2gk.p2g_mac.launches)
    fused = [p2gk.p2g_union(bk, dom, 1.0) for _ in range(2)]
    alone = [p2gk.p2g_mac(bk, dom) for _ in range(2)]
    torch.cuda.synchronize()
    assert (p2gk.p2g_union.launches, p2gk.p2g_mac.launches) == tuple(
        b + 2 for b in before)
    for a, b in zip(fused[0] + alone[0], fused[1] + alone[1]):
        assert torch.equal(a, b)
    assert torch.equal(fused[0][0], alone[0][0])
    assert torch.equal(fused[0][1], alone[0][1])
    _p2g_close(fused[0], p2gk.p2g_union_plain(bk, dom, 1.0))
    _p2g_close(alone[0], fb.p2g_mac(bk, dom))


@pytest.mark.gpu
@pytest.mark.parametrize("lz", [2, 32])
def test_p2g_union_slab_synthetic_matches_one_domain(cuda, lz):
    """The z-slab form over slabs of 2 and of 32 planes (bricks 8 deep)
    of made-up buckets over 19x23x64: bitwise equal to the same planes of
    the one-domain launch and to a second launch, and close to its plain
    version."""
    dom, bk = _synthetic_moving((19, 23, 64), 24, "random", cuda)
    whole = p2gk.p2g_union(bk, dom, 1.0)
    mesh = shd.make_zmesh(64 // lz, devices=[cuda])
    ext = rbk.halo_buckets(shd.shard_buckets(bk, mesh).slabs, 1,
                           Domain(size=(19, 23, lz)))
    for i, e in enumerate(ext):
        before = p2gk.p2g_union_slab.launches
        got = p2gk.p2g_union_slab(e, dom, i * lz, 1.0)
        again = p2gk.p2g_union_slab(e, dom, i * lz, 1.0)
        torch.cuda.synchronize()
        assert p2gk.p2g_union_slab.launches == before + 2
        for g, a, w in zip(got, again, whole):
            assert torch.equal(g, a)
            assert torch.equal(g, w[..., i * lz:(i + 1) * lz, :, :])
        if i in (0, len(ext) // 2, len(ext) - 1):
            _p2g_close(got, p2gk.p2g_union_slab_plain(e, dom, i * lz, 1.0))


@pytest.mark.parametrize("shape,levelset", [((29, 23, 19), True),
                                            ((29, 23, 19), False),
                                            ((128, 128, 128), True),
                                            ((2, 16, 16), True)])
def test_p2g_plan_covers_the_domain(shape, levelset):
    plan = p2gk.p2g_plan(shape, levelset)
    bx, by, bz = p2gk.P2G_BRICK
    gx, gy, gz = plan.grid
    lz, sy, sx = shape
    assert (gx - 1) * bx < sx <= gx * bx
    assert (gy - 1) * by < sy <= gy * by
    assert (gz - 1) * bz < lz <= gz * bz
    assert plan.tile == (bx + 2) * (by + 2) <= plan.threads
    assert plan.threads == bx * by * (4 if levelset else 3)
    assert plan.cap == p2gk.P2G_CAP
    assert plan.smem_bytes == 4 * plan.floats * plan.cap
    assert plan.smem_bytes <= p2gk.SMEM_OPTIN_BYTES


def test_p2g_plan_mirrors_the_kernel_constants():
    """The plan's brick, thread groups, staged floats and staging size
    are the ones csrc/p2g_gather.cuh compiles."""
    src = (_build.CSRC / "p2g_gather.cuh").read_text()
    bx, by, bz = p2gk.P2G_BRICK
    assert f"constexpr int kBx = {bx}, kBy = {by}, kBz = {bz};" in src
    assert f"constexpr int kCap = {p2gk.P2G_CAP};" in src
    for levelset in (True, False):
        plan = p2gk.p2g_plan((16, 16, 16), levelset)
        assert plan.threads // (bx * by) == (4 if levelset else 3)
    assert "kGroups = kLevelset ? 4 : 3;" in src
    assert "kRec = kLevelset ? 22 : 18;" in src
    assert p2gk.p2g_plan((16, 16, 16), True).floats == 22
    assert p2gk.p2g_plan((16, 16, 16), False).floats == 18


@pytest.mark.parametrize("cap", [0, 4096])
def test_p2g_plan_refuses_what_does_not_fit(monkeypatch, cap):
    monkeypatch.setattr(p2gk, "P2G_CAP", cap)
    with pytest.raises(ValueError, match="do not fit"):
        p2gk.p2g_plan((128, 128, 128), True)


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


def dam16_crossing(device):
    """tests/test_flip_sharded.py:145-162: the 16^3 dam at PPC 12, every
    particle displaced by up to 0.9 cells (seed 7), many across slab
    faces; a few cells overflow."""
    res = 16
    dom = Domain(size=(res,) * 3)
    bk = flip.make_dam_state_bucketed(
        dom, flip.FlipParams(gravity=(0.0, -0.003, 0.0), ghost_fluid=True),
        ppc=12, device=device).buckets
    d = np.random.default_rng(7).uniform(
        -0.9, 0.9, size=(3,) + tuple(bk.px.shape)).astype(np.float32)
    return dom, dataclasses.replace(bk, **{
        f: torch.clamp(getattr(bk, f) + torch.where(
            bk.valid, torch.tensor(d[i], device=device), 0.0), 1.01,
            res - 1.01) for i, f in enumerate(("px", "py", "pz"))})


def _slabs(whole, n):
    t = whole.shape[-1] // n
    return [whole[..., i * t:(i + 1) * t] for i in range(n)]


@pytest.mark.gpu
@pytest.mark.parametrize("n", [2, 4, 8])
def test_rebin_zshard_kernel_matches_plain_bitwise(cuda, n):
    dom, bk = dam16_crossing(cuda)
    mesh = shd.make_zmesh(n, devices=[cuda])
    lz = 16 // n
    local = Domain(size=(16, 16, lz))
    sbk = shd.shard_buckets(bk, mesh)
    xy = []
    for i, b in enumerate(sbk.slabs):
        for axis in (0, 1):
            b = rbk.rebin_pass(b, local, axis, z_base=i * lz)
        xy.append(b)
    for i, e in enumerate(rbk.halo_buckets(xy, 1, local)):
        before = rbk.rebin_zpass_halo.launches
        got = rbk.rebin_zpass_halo(e, local, i * lz, 16)
        torch.cuda.synchronize()
        assert rbk.rebin_zpass_halo.launches == before + 1
        ref = fb.rebin_zpass_halo_plain(e, local, i * lz, 16)
        assert int(got.dropped) == int(ref.dropped)
        for f in FIELDS + ("valid",):
            assert torch.equal(getattr(got, f), getattr(ref, f)), (i, f)
    got = shd.unshard_buckets(rbk.rebin_zshard_three_pass(sbk, dom, mesh))
    ref = fb.rebin(bk, dom)
    assert int(got.dropped) == int(ref.dropped) > 0
    for f in FIELDS + ("valid",):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("ring_only", [True, False])
def test_advect_blend_slab_kernel_matches_plain(cuda, n, ring_only):
    """The z-slab form against its plain version (abs 1e-6) and, on the
    slab's cells, against the one-domain kernel (exact); one shard (zero
    halos) included."""
    dom, bk = dam16_crossing(cuda)
    bk = rbk.rebin(bk, dom)
    vel = torch.tensor(np.random.RandomState(7).randn(3, 16, 16, 16)
                       .astype(np.float32) * 0.25, device=cuda)
    flags = torch.where(Sphere(center=(11.2, 4.8, 8.0), radius=3.2)
                        .inside_grid(dom, cuda), fl.TypeObstacle,
                        fl.init_domain(dom, 0, device=cuda))
    mesh = shd.make_zmesh(n, devices=[cuda])
    lz = 16 // n
    vh = shd.halo_z(shd.scatter_z(vel, mesh, 1), 2, 1)
    oh = shd.halo_z(shd.scatter_z(vel * 0.85, mesh, 1), 2, 1)
    obh = shd.halo_z(shd.scatter_z(fl.is_obstacle(flags), mesh, 0), 2, 0)
    for mode in (0, 2):
        dt, pend = torch.tensor(2.5, device=cuda), torch.tensor(True,
                                                                device=cuda)
        whole = advk.advect_blend(bk, flags, vel, vel * 0.85, dt, pend, 0.97,
                                  dom, mode, ring_only=ring_only)
        for i, b in enumerate(shd.shard_buckets(bk, mesh).slabs):
            args = (b, None if ring_only else obh[i], vh[i], oh[i], dt, pend,
                    0.97, dom, i * lz, mode)
            before = advk.advect_blend_slab.launches
            got = advk.advect_blend_slab(*args, ring_only=ring_only)
            torch.cuda.synchronize()
            assert advk.advect_blend_slab.launches == before + 1
            ref = advk.advect_blend_slab_plain(*args, ring_only=ring_only)
            assert _max_err(got, ref) < 1e-6
            for f in FIELDS:
                assert torch.equal(getattr(got, f),
                                   _slabs(getattr(whole, f), n)[i]), f


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 8])
def test_p2g_union_slab_kernel_matches_plain(cuda, n):
    dom, bk = dam16_crossing(cuda)
    bk = rbk.rebin(bk, dom)
    mesh = shd.make_zmesh(n, devices=[cuda])
    lz = 16 // n
    whole = p2gk.p2g_union(bk, dom, 1.0)
    before = p2gk.p2g_union_slab.launches
    outs = p2gk.p2g_union_zshard(shd.shard_buckets(bk, mesh), dom, 1.0, mesh)
    torch.cuda.synchronize()
    assert p2gk.p2g_union_slab.launches == before + n
    for got, ref in zip(outs, whole):
        assert torch.equal(shd.gather_z(got, mesh, ref.dim() - 3), ref)
    ext = rbk.halo_buckets(shd.shard_buckets(bk, mesh).slabs, 1,
                           Domain(size=(16, 16, lz)))
    for i, e in enumerate(ext):
        got = p2gk.p2g_union_slab(e, dom, i * lz, 1.0)
        ref = p2gk.p2g_union_slab_plain(e, dom, i * lz, 1.0)
        for g, r, tol in zip(got, ref, (1e-5, 1e-5, 1e-6)):
            assert float((g - r).abs().max()) < tol


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["bench", "no_ghost_fluid"])
def test_zshard_steps_on_card_match_cpu(cuda, route):
    """Three z-sharded steps over 8 shards on the card: equal to the card's
    one-device steps, and to the same sharded steps on the CPU within the
    card-vs-CPU tolerance."""
    dom = Domain(size=(16,) * 3)
    kw, _, ppc = ROUTES[route]
    p = flip.FlipParams(**kw)
    runs = {}
    for d, sharded in ((cuda, True), (cuda, False), ("cpu", True)):
        st = flip.make_dam_state_bucketed(dom, p, ppc=ppc, device=d)
        mesh = shd.make_zmesh(8, devices=[d]) if sharded else None
        if sharded:
            st = shd.shard_flip_bucket_state(st, mesh)
        for _ in range(3):
            st = flip.flip_step_bucketed(st, dom, p, zshard=mesh)
        runs[(str(d), sharded)] = flip.state_to_numpy(st)
    g, one, c = (runs[("cuda", True)], runs[("cuda", False)],
                 runs[("cpu", True)])
    for k in ("flags", "vel", "phi", "pressure"):
        np.testing.assert_array_equal(g[k], one[k], err_msg=k)
    for k in FIELDS + ("valid", "dropped"):
        np.testing.assert_array_equal(g["buckets"][k], one["buckets"][k],
                                      err_msg=k)
    np.testing.assert_array_equal(g["flags"], c["flags"])
    assert g["buckets"]["valid"].sum() == c["buckets"]["valid"].sum()
    assert int(g["buckets"]["dropped"]) == 0
    for k in ("vel", "phi", "pressure"):
        assert float(np.abs(g[k] - c[k]).max()) < 2e-4, k


@pytest.mark.gpu
def test_zshard_steps_across_cards_match_one_card(cuda):
    """Four shards, one on each visible card (round robin), step as four
    shards on one card do, and the caller's current device is left as it
    was."""
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if len(cards) < 2:
        pytest.skip("needs two CUDA devices")
    dom = Domain(size=(16,) * 3)
    p = flip.FlipParams(**BENCH)
    caller = torch.cuda.current_device()
    runs = []
    for devs in ([cards[0]], cards):
        mesh = shd.make_zmesh(4, devices=devs)
        st = shd.shard_flip_bucket_state(flip.make_dam_state_bucketed(
            dom, p, ppc=10, device=cards[0]), mesh)
        assert [s.valid.device for s in st.buckets.slabs] == [
            mesh.device(i) for i in range(4)]
        for _ in range(3):
            st = flip.flip_step_bucketed(st, dom, p, zshard=mesh)
        assert torch.cuda.current_device() == caller
        runs.append(flip.state_to_numpy(st))
    one, many = runs
    for k in ("flags", "vel", "phi", "pressure"):
        np.testing.assert_array_equal(many[k], one[k], err_msg=k)
    for k in FIELDS + ("valid", "dropped"):
        np.testing.assert_array_equal(many["buckets"][k], one["buckets"][k],
                                      err_msg=k)


def test_launch_gives_the_caller_its_device_back(monkeypatch):
    """An export selects its tensors' card with cudaSetDevice; the launch
    then restores the caller's current device."""
    current = {"dev": 1}
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current["dev"])
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: current.update(dev=d))
    with _build.caller_device():
        current["dev"] = 3
    assert current["dev"] == 1


def _meta_buckets(dom):
    shape = (4, dom.num_cells)
    return fb.Buckets(*(torch.empty(shape, device="meta") for _ in FIELDS),
                      valid=torch.empty(shape, dtype=torch.bool,
                                        device="meta"),
                      dropped=torch.empty((), dtype=torch.int32,
                                          device="meta"))


@pytest.mark.parametrize("which", ["extrap_layer", "rebin_pass",
                                   "advect_blend", "p2g_union", "p2g_mac",
                                   "union_levelset", "flip_update",
                                   "rebin_zpass_halo", "advect_blend_slab",
                                   "p2g_union_slab"])
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
        "rebin_zpass_halo": lambda: rbk.rebin_zpass_halo(bk, dom, 0, 4),
        "advect_blend_slab": lambda: advk.advect_blend_slab(
            bk, g, vel, vel, 0.5, True, 0.97, dom, 0),
        "p2g_union_slab": lambda: p2gk.p2g_union_slab(bk, dom, 0),
    }
    with pytest.raises(ValueError, match="unsupported device"):
        calls[which]()
