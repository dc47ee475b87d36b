"""The step's bucket advection over the live slots only
(``ops/advect_bucket_kernels.py``: ``advect_blend_live``, its z-slab form
``advect_blend_slab_live``; ``csrc/advect_bucket.cu``), the form that
passes invalid slots through (``advect_blend``, ``advect_blend_slab``) and
the rebin that consumes the step form's output.

On the CPU every form runs the plain version, ``advect_blend_plain``. Its
live slots are held against the JAX package on the 16^3 dam and the 24^3
corner dam of tests/test_flip_bucket.py (made-up particle velocities, a
random grid velocity, seed 7): against the XLA forms the JAX step's CPU
branch runs (``flip_update_bucketed`` where pending, then
``advect_bucketed``) over the three integration modes, pending true and
false, the bounds test alone (``ring_only``) and a stamped sphere
obstacle (against ``advect_blend_pallas`` in interpret mode:
tests/test_torch_advect_live_pallas.py). The rebin gives the same buckets
bit for bit, ``dropped`` included, when the advected buckets' invalid
slots hold NaN and +-1e30 (one domain, and the
sharded rebin over 4 slabs). One bucketed step runs the step form and
equals the JAX step. The kernel's launch plan covers the domain and
mirrors the kernel's constants.

Cases marked ``gpu`` need a CUDA device and skip without one; run them on
the card (the JAX package is not needed there, hence no conftest; the
cases against it import it when they run):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_advect_live.py -m gpu

They hold the step form against the plain version on the live slots, over
the same options, on the corner dam and on made-up gap-free buckets of 1,
24 and 40 slots over 19x23x29 (random, empty and full cells: empty tiles,
and P not a multiple of the tile); show that the kernel writes no invalid
slot (poison in the input's invalid slots survives the public form, whose
live slots equal the step form's); hold the public form's pass-through
exact on every slot, the slab form against its plain version and the
one-domain kernel, zshard steps against one-device steps bit for bit, and
the rebin on the card with poisoned invalid slots.

Tolerances: the advection repeats the reference's operations in its order,
so abs 1e-6 (the JAX tests hold the Pallas advection to XLA at 1e-6); the
rebin is a permutation, exact; one step's grids to abs 1e-4 and particles
to 1e-5, as tests/test_torch_flip.py.
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mantaflow_tpu_torch.core import flags as fl
from mantaflow_tpu_torch.core.domain import Domain
from mantaflow_tpu_torch.core.shapes import Sphere
from mantaflow_tpu_torch.kernels import _build
from mantaflow_tpu_torch.models import flip as tflip
from mantaflow_tpu_torch.ops import advect_bucket_kernels as advk
from mantaflow_tpu_torch.ops import flip_bucket as fb
from mantaflow_tpu_torch.ops import rebin_kernels as rbk
from mantaflow_tpu_torch.parallel import sharding as shd

FIELDS = ("px", "py", "pz", "vx", "vy", "vz")
BUCKETS = FIELDS + ("valid", "dropped")
DAM = dict(gravity=(0.0, -0.003, 0.0), ghost_fluid=True)
BENCH = dict(DAM, cg_accuracy=1e-3, ring_only_obstacles=True)
# (size, dam_frac, ppc) of tests/test_flip_bucket.py's fixtures
FIXTURES = {"dam16": ((16,) * 3, (0.4, 0.6, 1.0), 14),
            "corner24": ((24,) * 3, (0.3, 0.3, 0.35), 12)}
SPHERES = {"dam16": dict(center=(11.2, 4.8, 8.0), radius=3.2),
           "corner24": dict(center=(5.0, 4.0, 4.5), radius=3.0)}
CSRC = Path(advk.__file__).resolve().parent.parent / "csrc"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs test files in parallel worker processes; torch's own
    thread pool in each would oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _fixture(which, device):
    """(dom, flags, flags with the sphere obstacle, buckets with made-up
    velocities, grid velocity) of a dam fixture on ``device``."""
    size, frac, ppc = FIXTURES[which]
    dom = Domain(size=size)
    st = tflip.make_dam_state_bucketed(dom, tflip.FlipParams(**DAM),
                                       dam_frac=frac, ppc=ppc, device=device)
    bk = st.buckets
    bk = dataclasses.replace(bk, vx=torch.where(bk.valid, bk.px * 0.01, 0.0),
                             vy=torch.where(bk.valid, bk.py * 0.02 - 0.05,
                                            0.0),
                             vz=torch.where(bk.valid, bk.pz * 0.005, 0.0))
    sphere = Sphere(**SPHERES[which]).inside_grid(dom, device)
    obstacle = torch.where(sphere, fl.TypeObstacle, st.flags)
    vel = np.random.RandomState(7).randn(3, *dom.shape).astype(np.float32)
    return (dom, st.flags, obstacle, bk,
            torch.tensor(vel * np.float32(0.25), device=device))


@pytest.fixture(scope="module", params=sorted(FIXTURES))
def cpu_fixture(request):
    return (request.param,) + _fixture(request.param, "cpu")


def _args(fx, mode, pending, ring_only, dt=0.5):
    """(positional arguments, keywords) of one advection call."""
    dom, flags, obstacle, bk, vel = fx
    dev = bk.px.device
    return ((bk, flags if ring_only else obstacle, vel, vel * 0.85,
             torch.tensor(dt, device=dev), torch.tensor(pending, device=dev),
             0.97, dom, mode), {"ring_only": ring_only})


def _assert_live_close(got, ref, valid, atol=1e-6):
    """Every live slot's six fields within ``atol`` (ref: torch or numpy)."""
    v = valid.cpu().numpy()
    for f in FIELDS:
        g = getattr(got, f).cpu().numpy()[v]
        r = np.asarray(getattr(ref, f))[v]
        np.testing.assert_allclose(g, r, atol=atol, rtol=0, err_msg=f)


def _poisoned(bk):
    """``bk`` with the invalid slots' six fields NaN, +1e30 and -1e30 by
    turns: what no rebin may read."""
    bad = torch.tensor([float("nan"), 1e30, -1e30], device=bk.px.device)
    idx = torch.arange(bk.px.numel(), device=bk.px.device)
    return dataclasses.replace(bk, **{
        f: torch.where(bk.valid, getattr(bk, f),
                       bad[(idx + k) % 3].view(bk.px.shape))
        for k, f in enumerate(FIELDS)})


def _assert_buckets_equal(got, ref):
    assert int(got.dropped) == int(ref.dropped)
    for f in FIELDS + ("valid",):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f


def _jax_inputs(fx, ring_only):
    import jax.numpy as jnp
    from mantaflow_tpu.core.domain import Domain as JDomain
    from mantaflow_tpu.ops import flip_bucket as jfb
    dom, flags, obstacle, bk, vel = fx
    jbk = jfb.Buckets(**{f: jnp.asarray(getattr(bk, f).numpy())
                         for f in BUCKETS})
    jflags = jnp.asarray((flags if ring_only else obstacle).numpy())
    return JDomain(size=tuple(reversed(dom.shape))), jbk, jflags, \
        jnp.asarray(vel.numpy())


# -- CPU: the plain version against the JAX package ---------------------------


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("pending", [True, False])
@pytest.mark.parametrize("ring_only", [True, False])
def test_step_form_matches_plain_and_jax_cpu_branch(cpu_fixture, mode,
                                                    pending, ring_only):
    """The step form on the CPU is the plain version; its live slots equal
    the JAX CPU branch's blend (where pending) and advection."""
    import jax.numpy as jnp
    from mantaflow_tpu.ops import flip_bucket as jfb
    which, *fx = cpu_fixture
    args, kw = _args(fx, mode, pending, ring_only)
    got = advk.advect_blend_live(*args, **kw)
    assert advk.advect_blend_live.launches == 0
    _assert_buckets_equal(got, advk.advect_blend_plain(*args, **kw))
    jdom, jbk, jflags, jvel = _jax_inputs(fx, ring_only)
    ref = jbk
    if pending:
        ref = jfb.flip_update_bucketed(jbk, jvel, jvel * 0.85, 0.97, jdom)
    ref = jfb.advect_bucketed(ref, jflags, jvel, jnp.float32(0.5), jdom,
                              mode, ring_only=ring_only)
    _assert_live_close(got, ref, fx[3].valid)
    moved = (got.px != fx[3].px)[fx[3].valid]
    assert bool(moved.any())


def _advected(fx, mode=2, dt=2.5):
    """The step form's output at a large dt (movers on every axis)."""
    args, kw = _args(fx, mode, True, False, dt=dt)
    return advk.advect_blend_live(*args, **kw)


def test_rebin_ignores_invalid_slots(cpu_fixture):
    """fb.rebin (what rbk.rebin runs on the CPU) reads the live slots
    alone: NaN and +-1e30 in the advected buckets' invalid slots give the
    same buckets bit for bit, dropped included."""
    which, *fx = cpu_fixture
    dom = fx[0]
    moved = _advected(fx)
    ref = fb.rebin(moved, dom)
    bad = _poisoned(moved)
    assert bool(torch.isnan(bad.px).any())
    _assert_buckets_equal(fb.rebin(bad, dom), ref)
    _assert_buckets_equal(rbk.rebin(bad, dom), ref)


@pytest.mark.parametrize("n", [1, 4])
def test_sharded_rebin_ignores_invalid_slots(n):
    """The sharded plain rebin (rebin_slab_plain over each slab and its
    halo planes) on poisoned slabs equals the rebin of the clean set."""
    fx = _fixture("dam16", "cpu")
    dom = fx[0]
    moved = _advected(fx)
    mesh = shd.make_zmesh(n, devices=["cpu"])
    sbk = shd.shard_buckets(moved, mesh)
    ref = shd.unshard_buckets(rbk.rebin_zshard(sbk, dom, mesh))
    bad = dataclasses.replace(sbk, slabs=[_poisoned(b) for b in sbk.slabs])
    _assert_buckets_equal(
        shd.unshard_buckets(rbk.rebin_zshard(bad, dom, mesh)), ref)
    _assert_buckets_equal(ref, fb.rebin(moved, dom))


def test_bucketed_step_runs_the_step_form_and_matches_jax(monkeypatch):
    """One bucketed step of the bench dam at 16^3 from the JAX package's
    state two steps in (blend pending): the advection goes through the
    step form (never the pass-through form), and the step equals the JAX
    step (CPU branch)."""
    import jax
    from mantaflow_tpu.core.domain import Domain as JDomain
    from mantaflow_tpu.models import flip as jflip
    jdom, dom = JDomain(size=(16,) * 3), Domain(size=(16,) * 3)
    jp, tp = jflip.FlipParams(**BENCH), tflip.FlipParams(**BENCH)
    step = jax.jit(lambda s: jflip.flip_step_bucketed(s, jdom, jp))
    jst = step(step(jflip.make_dam_state_bucketed(jdom, jp, ppc=10)))
    assert bool(jst.blend_pending)
    tst = tflip.state_from_numpy(_jax_to_numpy(jst), device="cpu")
    seen = []
    for name in ("advect_blend", "advect_blend_live"):
        orig = getattr(advk, name)
        monkeypatch.setattr(advk, name, lambda *a, _o=orig, _n=name, **k:
                            (seen.append(_n), _o(*a, **k))[1])
    got = tflip.state_to_numpy(tflip.flip_step_bucketed(tst, dom, tp))
    ref = _jax_to_numpy(step(jst))
    assert seen == ["advect_blend_live"]
    np.testing.assert_array_equal(got["flags"], ref["flags"])
    np.testing.assert_array_equal(got["buckets"]["valid"],
                                  ref["buckets"]["valid"])
    assert int(got["buckets"]["dropped"]) == int(ref["buckets"]["dropped"])
    for k in ("vel", "vel_old", "phi", "pressure"):
        np.testing.assert_allclose(got[k], ref[k], atol=1e-4, err_msg=k)
    for k in FIELDS:
        np.testing.assert_allclose(got["buckets"][k], ref["buckets"][k],
                                   atol=1e-5, err_msg=k)


def _jax_to_numpy(st):
    d = {k: np.asarray(getattr(st, k))
         for k in ("flags", "vel", "vel_old", "pressure", "phi")}
    d["buckets"] = {k: np.asarray(getattr(st.buckets, k)) for k in BUCKETS}
    d["ts"] = {k: np.asarray(getattr(st.ts, k))
               for k in ("dt", "time_total", "time_per_frame", "frame",
                         "lock_dt", "count")}
    d["blend_pending"] = np.asarray(st.blend_pending)
    return d


# -- CPU: the launch plan -----------------------------------------------------


@pytest.mark.parametrize("shape,grid", [((128, 128, 128), (4, 32, 64)),
                                        ((32, 128, 128), (4, 32, 16)),
                                        ((29, 23, 19), (1, 6, 15)),
                                        ((1, 1, 1), (1, 1, 1))])
def test_advect_plan_covers_the_domain(shape, grid):
    """Tiles of 32 x 4 x 2 cells over (nz, sy, sx): every cell in one tile,
    no tile wholly outside."""
    plan = advk.advect_plan(shape, 24)
    assert plan.grid == grid
    tx, ty, tz = advk.ADVECT_TILE
    nz, sy, sx = shape
    for n, t, g in zip((sx, sy, nz), (tx, ty, tz), plan.grid):
        assert (g - 1) * t < n <= g * t


def test_advect_plan_mirrors_the_kernel_constants():
    src = (CSRC / "advect_bucket.cu").read_text()
    tx, ty, tz = advk.ADVECT_TILE
    assert f"constexpr int kTx = {tx}, kTy = {ty}, kTz = {tz};" in src
    for name, key in (("Vel", "vel"), ("Old", "vel_old"), ("Obs", "obs")):
        lo, hi = advk.ADVECT_HALOS[key]
        assert f"constexpr int k{name}Lo = {lo}, k{name}Hi = {hi};" in src
    # the shared memory the kernel checks its launch against
    body = re.search(r"live_smem_bytes\(int P\) \{(.*?)\n\}", src, re.S)
    assert body and "kVelWin + kOldWin" in body.group(1)


@pytest.mark.parametrize("ppc", [1, 10, 16, 24, 40, 160, 255])
def test_advect_plan_fits_every_ppc_the_rebin_takes(ppc):
    """Every PPC up to the fused rebin's 160 (and the list's 255) fits one
    block's shared memory; at PPC 24 four blocks share an SM."""
    plan = advk.advect_plan((128, 128, 128), ppc)
    assert plan.smem_bytes <= _build.SMEM_OPTIN_BYTES
    vel = (32 + 5) * (4 + 5) * (2 + 5)
    old = (32 + 2) * (4 + 2) * (2 + 2)
    obs = (32 + 3) * (4 + 3) * (2 + 3)
    assert plan.smem_bytes == 12 * (vel + old) + obs + 8 * ppc * 8 \
        + 2 * ppc * 256
    if ppc == 24:
        assert 4 * (plan.smem_bytes + 1024) <= 228 * 1024


def test_advect_plan_refuses_past_255_slots():
    with pytest.raises(ValueError, match="do not fit"):
        advk.advect_plan((128, 128, 128), 256)
    with pytest.raises(ValueError, match="do not fit"):
        advk.advect_plan((8, 8, 8), 0)


@pytest.mark.parametrize("which", ["advect_blend_live",
                                   "advect_blend_slab_live"])
def test_step_forms_raise_off_cpu_and_cuda(which):
    """A tensor on another device is refused, not computed on the CPU."""
    dom = Domain(size=(4, 4, 4))
    shape = (4, dom.num_cells)
    bk = fb.Buckets(*(torch.empty(shape, device="meta") for _ in FIELDS),
                    valid=torch.empty(shape, dtype=torch.bool, device="meta"),
                    dropped=torch.empty((), dtype=torch.int32,
                                        device="meta"))
    g = torch.empty(dom.shape, device="meta")
    vel = torch.empty((3,) + dom.shape, device="meta")
    extra = (0,) if which == "advect_blend_slab_live" else ()
    with pytest.raises(ValueError, match="unsupported device"):
        getattr(advk, which)(bk, g, vel, vel, 0.5, True, 0.97, dom, *extra)


# -- the card -----------------------------------------------------------------


def _made_up(ppc, fill, device, seed=5):
    """Gap-free buckets over 19x23x29, each cell ``fill`` ("random":
    0..ppc, half the cells empty; "full": ppc; "empty": 0), at random
    positions in the cell, made-up velocities; free slots at the centre."""
    sx, sy, sz = 19, 23, 29
    rng = np.random.default_rng(seed)
    t = sx * sy * sz
    n = {"random": rng.integers(0, ppc + 1, t), "full": np.full(t, ppc),
         "empty": np.zeros(t, np.int64)}[fill]
    if fill == "random":
        n[rng.random(t) < 0.5] = 0
    valid = np.arange(ppc)[:, None] < n[None, :]
    flat = np.arange(t)
    fields = [np.where(valid, c[None, :] + rng.uniform(-0.5, 0.5, (ppc, t)),
                       c[None, :])
              for c in (flat % sx + 0.5, (flat // sx) % sy + 0.5,
                        flat // (sx * sy) + 0.5)]
    fields += [np.where(valid, rng.standard_normal((ppc, t)), 0.0)
               for _ in range(3)]
    dom = Domain(size=(sx, sy, sz))
    vel = rng.standard_normal((3, sz, sy, sx)) * 0.4
    flags = torch.where(Sphere(center=(9.0, 11.0, 14.0), radius=5.0)
                        .inside_grid(dom, device), fl.TypeObstacle,
                        fl.init_domain(dom, 0, device=device))
    bk = fb.Buckets(*(torch.tensor(f.astype(np.float32), device=device)
                      for f in fields), torch.tensor(valid, device=device),
                    torch.zeros((), dtype=torch.int32, device=device))
    return (dom, fl.init_domain(dom, 0, device=device), flags, bk,
            torch.tensor(vel.astype(np.float32), device=device))


def _check_step_form(call):
    """The step form against the plain version on the live slots, the
    public form on every slot (invalid slots exactly the input's), the two
    forms' live slots equal; one launch each."""
    args, kw = call
    before = (advk.advect_blend_live.launches, advk.advect_blend.launches)
    got = advk.advect_blend_live(*args, **kw)
    public = advk.advect_blend(*args, **kw)
    torch.cuda.synchronize()
    assert (advk.advect_blend_live.launches,
            advk.advect_blend.launches) == (before[0] + 1, before[1] + 1)
    ref = advk.advect_blend_plain(*args, **kw)
    bk = args[0]
    live = bk.valid
    for f in FIELDS:
        g, p_, r = getattr(got, f), getattr(public, f), getattr(ref, f)
        assert torch.equal(g[live], p_[live]), f
        assert torch.equal(p_[~live], getattr(bk, f)[~live]), f
        assert float((p_ - r).abs().max()) < 1e-6, f
    assert got.valid is bk.valid and got.dropped is bk.dropped


@pytest.mark.gpu
@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("pending", [True, False])
@pytest.mark.parametrize("ring_only", [True, False])
def test_step_form_kernel_matches_plain(cuda, mode, pending, ring_only):
    fx = _fixture("corner24", cuda)
    for dt in (0.5, 2.5):
        _check_step_form(_args(fx, mode, pending, ring_only, dt))


@pytest.mark.gpu
@pytest.mark.parametrize("ppc,fill", [(1, "random"), (24, "random"),
                                      (40, "random"), (24, "empty"),
                                      (40, "full")])
@pytest.mark.parametrize("ring_only", [True, False])
def test_step_form_kernel_made_up_buckets(cuda, ppc, fill, ring_only):
    fx = _made_up(ppc, fill, cuda)
    for mode in (0, 2):
        _check_step_form(_args(fx, mode, True, ring_only, dt=2.0))


@pytest.mark.gpu
def test_step_form_kernel_writes_no_invalid_slot(cuda):
    """Poison in the input's invalid slots survives the public form (its
    outputs start as copies; the kernel writes the live slots alone), and
    its live slots equal the step form's on the clean input."""
    fx = _made_up(24, "random", cuda)
    args, kw = _args(fx, 2, True, False, dt=2.0)
    bad = _poisoned(args[0])
    out = advk.advect_blend(bad, *args[1:], **kw)
    clean = advk.advect_blend_live(*args, **kw)
    live = bad.valid
    for f in FIELDS:
        g, b_ = getattr(out, f), getattr(bad, f)
        assert torch.equal(g[~live].isnan(), b_[~live].isnan()), f
        assert torch.equal(torch.nan_to_num(g[~live]),
                           torch.nan_to_num(b_[~live])), f
        assert torch.equal(g[live], getattr(clean, f)[live]), f


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 4])
def test_slab_step_form_kernel_matches_plain_and_one_domain(cuda, n):
    dom, _, obstacle, bk, vel = _fixture("dam16", cuda)
    bk = rbk.rebin(_advected((dom, None, obstacle, bk, vel)), dom)
    mesh = shd.make_zmesh(n, devices=[cuda])
    lz = 16 // n
    vh = shd.halo_z(shd.scatter_z(vel, mesh, 1), 2, 1)
    oh = shd.halo_z(shd.scatter_z(vel * 0.85, mesh, 1), 2, 1)
    obh = shd.halo_z(shd.scatter_z(fl.is_obstacle(obstacle), mesh, 0), 2, 0)
    dt, pend = torch.tensor(2.5, device=cuda), torch.tensor(True,
                                                            device=cuda)
    whole = advk.advect_blend_live(bk, obstacle, vel, vel * 0.85, dt, pend,
                                   0.97, dom, 2, ring_only=False)
    for i, b in enumerate(shd.shard_buckets(bk, mesh).slabs):
        args = (b, obh[i], vh[i], oh[i], dt, pend, 0.97, dom, i * lz, 2)
        before = advk.advect_blend_slab_live.launches
        got = advk.advect_blend_slab_live(*args)
        torch.cuda.synchronize()
        assert advk.advect_blend_slab_live.launches == before + 1
        ref = advk.advect_blend_slab_plain(*args)
        public = advk.advect_blend_slab(*args)
        cells = slice(i * lz * 256, (i + 1) * lz * 256)
        for f in FIELDS:
            g, p_ = getattr(got, f), getattr(public, f)
            assert torch.equal(g[b.valid], p_[b.valid]), f
            assert torch.equal(p_[~b.valid], getattr(b, f)[~b.valid]), f
            assert float((p_ - getattr(ref, f)).abs().max()) < 1e-6, f
            assert torch.equal(g[b.valid],
                               getattr(whole, f)[:, cells][b.valid]), f


@pytest.mark.gpu
def test_zshard_steps_equal_one_device_steps(cuda):
    """Three bench-dam steps at 16^3 over 4 slabs on the card equal three
    one-device steps bit for bit: the step forms' outputs reach the state
    only through the rebin."""
    dom = Domain(size=(16,) * 3)
    p = tflip.FlipParams(**BENCH)
    st = tflip.make_dam_state_bucketed(dom, p, ppc=10, device=cuda)
    st = tflip.flip_step_bucketed(st, dom, p)
    mesh = shd.make_zmesh(4, devices=[cuda])
    sh = shd.shard_flip_bucket_state(st, mesh)
    for _ in range(3):
        st = tflip.flip_step_bucketed(st, dom, p)
        sh = tflip.flip_step_bucketed(sh, dom, p, zshard=mesh)
    whole = shd.unshard_buckets(sh.buckets)
    for f in FIELDS + ("valid",):
        assert torch.equal(getattr(whole, f), getattr(st.buckets, f)), f
    for k in ("flags", "vel", "vel_old", "pressure", "phi"):
        assert torch.equal(getattr(sh, k), getattr(st, k)), k
    assert int(sh.buckets.dropped) == int(st.buckets.dropped) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 4])
def test_rebin_kernels_ignore_invalid_slots(cuda, n):
    """The fused rebin and its sharded form on the card, on the step
    form's output with its invalid slots poisoned, equal the same rebin of
    the clean output and the plain rebin, bit for bit."""
    fx = _fixture("dam16", cuda)
    dom = fx[0]
    moved = _advected(fx)
    ref = fb.rebin(moved, dom)
    bad = _poisoned(moved)
    _assert_buckets_equal(rbk.rebin(moved, dom), ref)
    _assert_buckets_equal(rbk.rebin(bad, dom), ref)
    mesh = shd.make_zmesh(n, devices=[cuda])
    sbad = shd.shard_buckets(bad, mesh)
    _assert_buckets_equal(
        shd.unshard_buckets(rbk.rebin_zshard(sbad, dom, mesh)), ref)
