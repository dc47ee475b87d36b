"""The fused bucket rebin (``ops/rebin_kernels.py:rebin_fused``, its z-slab
form ``rebin_fused_slab``, ``csrc/rebin_fused.cu``) against the JAX
package and against the three-pass rebin.

On the CPU the wrappers run their plain versions: ``rebin_fused`` runs
``flip_bucket.rebin`` and is held against the JAX package's
``flip_bucket.rebin`` and its fused Pallas kernel
(``flip_bucket_pallas.rebin_fused``, in interpret mode) on the 24^3 corner
dam advected by a random velocity (seed 7) and on the overflow fixture of
tests/test_flip_bucket.py; ``flip_bucket.rebin_slab_plain`` over 4 and 8
slabs of the 16^3 boundary-crossing fixture of
tests/test_flip_sharded.py:145-162 against ``flip_bucket.rebin`` of the
whole set; the launch plan against the kernel's constants.

Cases marked ``gpu`` need a CUDA device and skip without one; run them on
the card (the JAX package is not needed there, hence no conftest; the
cases against it import it when they run):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_rebin_fused.py -m gpu

They hold the kernel against ``flip_bucket.rebin`` and the three
``rebin_pass`` launches (corner dam, overflow fixture, made-up gap-free
buckets of 1, 24 and 40 slots over 19x23x29), and the slab form at 4 and
8 slabs against the one-domain kernel, one launch per call. Tolerance: the
rebin is a permutation, so every comparison is exact, ``dropped``
included (the JAX tests hold their fused kernel to 1e-6,
tests/test_flip_bucket.py:267-310; it is bitwise equal here).
"""

import dataclasses

import numpy as np
import pytest
import torch

from mantaflow_tpu_torch.core import particles as tcp
from mantaflow_tpu_torch.core.domain import Domain
from mantaflow_tpu_torch.models import flip as tflip
from mantaflow_tpu_torch.ops import flip_bucket as fb
from mantaflow_tpu_torch.ops import rebin_kernels as rbk
from mantaflow_tpu_torch.parallel import sharding as shd

FIELDS = ("px", "py", "pz", "vx", "vy", "vz", "valid")
DAM = dict(gravity=(0.0, -0.003, 0.0), ghost_fluid=True)
OVERFLOW_POS = np.array([[3.5, 3.5, 3.5], [2.6, 3.5, 3.5], [4.4, 3.5, 3.5],
                         [3.5, 2.7, 3.5], [3.5, 3.5, 4.3]], np.float32)


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


def _velocities(bk, where):
    return dict(vx=where(bk.valid, bk.px * 0.01, 0.0),
                vy=where(bk.valid, bk.py * 0.02 - 0.05, 0.0),
                vz=where(bk.valid, bk.pz * 0.005, 0.0))


def _grid_velocity(scale):
    v = np.random.RandomState(7).randn(3, 24, 24, 24).astype(np.float32)
    return v * np.float32(0.25 * scale)


def _corner24(device, scale):
    """The port's 24^3 corner dam with made-up particle velocities,
    advected one step by a random grid velocity times ``scale`` (6 pushes
    most particles a cell or more, and buckets overflow)."""
    dom = Domain(size=(24,) * 3)
    st = tflip.make_dam_state_bucketed(dom, tflip.FlipParams(**DAM),
                                       dam_frac=(0.3, 0.3, 0.35), ppc=12,
                                       device=device)
    bk = dataclasses.replace(st.buckets, **_velocities(st.buckets,
                                                       torch.where))
    moved = fb.advect_bucketed(bk, st.flags,
                               torch.tensor(_grid_velocity(scale),
                                            device=device),
                               torch.tensor(1.0, device=device), dom, 0)
    return dom, moved


def _overflow(device):
    """tests/test_flip_bucket.py's overflow fixture: five particles
    converge on one cell of PPC 4."""
    dom = Domain(size=(8, 8, 8))
    pvel = np.arange(24, dtype=np.float32).reshape(8, 3) * np.float32(0.01)
    bk = fb.bin_from_particles(tcp.make_particles(OVERFLOW_POS, capacity=8,
                                                  device=device),
                               pvel, dom, ppc=4)
    return dom, dataclasses.replace(bk, **{
        f: torch.where(bk.valid, getattr(bk, f)
                       + 0.9 * (3.5 - getattr(bk, f)), getattr(bk, f))
        for f in ("px", "py", "pz")})


def _crossing(device):
    """tests/test_flip_sharded.py:145-162: the 16^3 dam at PPC 12, every
    particle displaced by up to 0.9 cells (seed 7), many across slab
    faces; a few cells overflow."""
    res = 16
    dom = Domain(size=(res,) * 3)
    bk = tflip.make_dam_state_bucketed(dom, tflip.FlipParams(**DAM),
                                       ppc=12, device=device).buckets
    d = np.random.default_rng(7).uniform(
        -0.9, 0.9, size=(3,) + tuple(bk.px.shape)).astype(np.float32)
    return dom, dataclasses.replace(bk, **{
        f: torch.clamp(getattr(bk, f) + torch.where(
            bk.valid, torch.tensor(d[i], device=device), 0.0), 1.01,
            res - 1.01) for i, f in enumerate(("px", "py", "pz"))})


def _made_up(ppc, seed, device):
    """Gap-free buckets over 19x23x29 with 0..ppc particles in half the
    cells, each up to 1.45 cells from its cell centre (movers on every
    axis, overflow), random velocities."""
    sx, sy, sz = 19, 23, 29
    rng = np.random.default_rng(seed)
    t = sx * sy * sz
    n = rng.integers(0, ppc + 1, t)
    n[rng.random(t) < 0.5] = 0
    valid = np.arange(ppc)[:, None] < n[None, :]
    flat = np.arange(t)
    fields = []
    for c, ext in zip((flat % sx + 0.5, (flat // sx) % sy + 0.5,
                       flat // (sx * sy) + 0.5), (sx, sy, sz)):
        p = np.clip(c + rng.uniform(-1.45, 1.45, (ppc, t)), 0.01, ext - 0.01)
        fields.append(np.where(valid, p, c))
    for _ in range(3):
        fields.append(np.where(valid, rng.standard_normal((ppc, t)), 0.0))
    return Domain(size=(sx, sy, sz)), fb.Buckets(
        *(torch.tensor(f.astype(np.float32), device=device) for f in fields),
        torch.tensor(valid, device=device),
        torch.zeros((), dtype=torch.int32, device=device))


def _assert_equal(got, ref):
    assert int(got.dropped) == int(ref.dropped)
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(ref, f)), f


def _jax_buckets(bk):
    import jax.numpy as jnp
    from mantaflow_tpu.ops import flip_bucket as jfb
    return jfb.Buckets(**{f: jnp.asarray(getattr(bk, f).numpy())
                          for f in FIELDS + ("dropped",)})


def _assert_jax(got, ref):
    assert int(got.dropped) == int(ref.dropped)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)


# -- CPU: the plain versions against the JAX package (imported in the cases
# that use it: the card has no JAX) ------------------------------------------


@pytest.mark.parametrize("scale", [1.0, 6.0])
def test_rebin_fused_matches_reference_bitwise(scale):
    """The port's buckets, advected, go through rebin_fused (the plain
    rebin on the CPU), the JAX three-pass rebin and the JAX fused kernel:
    bitwise equal to both, dropped included."""
    from mantaflow_tpu.core.domain import Domain as JDomain
    from mantaflow_tpu.ops import flip_bucket as jfb
    from mantaflow_tpu.ops import flip_bucket_pallas as jfbp
    dom, moved = _corner24("cpu", scale)
    got = rbk.rebin_fused(moved, dom)
    jdom = JDomain(size=(24,) * 3)
    jm = _jax_buckets(moved)
    _assert_jax(got, jfb.rebin(jm, jdom))
    _assert_jax(got, jfbp.rebin_fused(jm, jdom, interpret=True))
    if scale > 1.0:
        assert int(got.dropped) > 0


def test_rebin_fused_overflow_fixture_matches_reference():
    """The JAX package's own fixture, binned by each package: one particle
    dropped, the same one, by both forms of both packages."""
    import jax.numpy as jnp
    from mantaflow_tpu.core import particles as jcp
    from mantaflow_tpu.core.domain import Domain as JDomain
    from mantaflow_tpu.ops import flip_bucket as jfb
    from mantaflow_tpu.ops import flip_bucket_pallas as jfbp
    dom, tbk = _overflow("cpu")
    jdom = JDomain(size=(8, 8, 8))
    pvel = np.arange(24, dtype=np.float32).reshape(8, 3) * np.float32(0.01)
    jbk = jfb.bin_from_particles(jcp.make_particles(OVERFLOW_POS, capacity=8),
                                 jnp.asarray(pvel), jdom, ppc=4)
    jbk = dataclasses.replace(jbk, **{
        f: jnp.where(jbk.valid, getattr(jbk, f)
                     + 0.9 * (3.5 - getattr(jbk, f)), getattr(jbk, f))
        for f in ("px", "py", "pz")})
    got = rbk.rebin_fused(tbk, dom)
    assert int(got.dropped) == 1
    _assert_jax(got, jfb.rebin(jbk, jdom))
    _assert_jax(got, jfbp.rebin_fused(jbk, jdom, interpret=True))


@pytest.mark.parametrize("n", [4, 8])
def test_rebin_slab_plain_equals_whole_rebin(n):
    """Each slab's whole rebin from its pre-rebin planes and one halo
    plane of each neighbour equals the whole set's rebin on its planes;
    its dropped counts its own cells' overflow, so the slabs' counts sum
    to the whole set's (some overflow lands in halo planes)."""
    dom, bk = _crossing("cpu")
    ref = fb.rebin(bk, dom)
    mesh = shd.make_zmesh(n, devices=["cpu"])
    lz = 16 // n
    local = Domain(size=(16, 16, lz))
    ext = rbk.halo_buckets(shd.shard_buckets(bk, mesh).slabs, 1, local)
    drops, t = [], local.num_cells
    for i, e in enumerate(ext):
        got = rbk.rebin_fused_slab(e, local, i * lz, 16)
        for f in FIELDS:
            assert torch.equal(getattr(got, f),
                               getattr(ref, f)[:, i * t:(i + 1) * t]), (i, f)
        drops.append(int(got.dropped))
    assert sum(drops) == int(ref.dropped) > 0
    # the x and y passes overflow too, also in planes that are other
    # slabs' halo planes, which each slab takes off its own count
    whole_xy = fb._rebin_axis(fb._rebin_axis(bk, dom, 0), dom, 1)
    assert int(whole_xy.dropped) > 0
    out = rbk.rebin_zshard(shd.shard_buckets(bk, mesh), dom, mesh)
    _assert_equal(shd.unshard_buckets(out), ref)
    _assert_equal(shd.unshard_buckets(
        rbk.rebin_zshard_three_pass(shd.shard_buckets(bk, mesh), dom, mesh)),
        ref)


def test_rebin_slab_plain_refuses_a_slab_without_halo():
    dom, bk = _crossing("cpu")
    with pytest.raises(ValueError, match="6 planes"):
        fb.rebin_slab_plain(bk, Domain(size=(16, 16, 4)), 0, 16)


@pytest.mark.parametrize("ppc,smem", [(1, 4732), (8, 16016), (24, 41808),
                                      (40, 67600), (48, 80496)])
def test_rebin_plan_fits_the_runner_ppcs(ppc, smem):
    """Every PPC the auto runner reaches (max_ppc 48) takes the 32x4 tile
    (128 threads, one a column) and 4-plane runs; the shared bytes are the
    kernel's fused_smem_bytes: counts (4 bytes) of the 204 window cells,
    the 192 x-merge cells and three ring planes of 128 columns, 2-byte
    references of the x merge, the ring and the z merge per slot, and one
    code byte per slot and window cell."""
    plan = rbk.rebin_plan((128, 128, 128), ppc)
    assert plan.rows == 4 and plan.window == 204
    assert plan.grid == (4, 32, 32)
    assert plan.smem_bytes == smem
    assert smem == 4 * (204 + 192 + 384) + 2 * ppc * (192 + 512) + 204 * ppc
    assert plan.smem_bytes <= rbk.SMEM_OPTIN_BYTES
    assert ppc * plan.window <= rbk.REBIN_REF_LIMIT
    # a slab's planes and a domain no tile divides
    assert rbk.rebin_plan((32, 128, 128), ppc).grid == (4, 32, 8)
    assert rbk.rebin_plan((29, 23, 19), ppc).grid == (1, 6, 8)


@pytest.mark.parametrize("ppc,rows", [(80, 4), (81, 2), (120, 2), (121, 1),
                                      (160, 1)])
def test_rebin_plan_narrows_the_tile_past_80_slots(ppc, rows):
    plan = rbk.rebin_plan((16, 16, 40), ppc)
    assert plan.rows == rows
    assert plan.grid == (2, -(-16 // rows), 4)
    assert ppc * plan.window <= rbk.REBIN_REF_LIMIT
    assert plan.smem_bytes <= rbk.SMEM_OPTIN_BYTES


def test_rebin_plan_refuses_past_160_slots():
    with pytest.raises(ValueError, match="161 slots"):
        rbk.rebin_plan((128, 128, 128), 161)


@pytest.mark.parametrize("which", ["rebin_fused", "rebin_fused_slab"])
def test_rebin_fused_wrappers_raise_off_cpu_and_cuda(which):
    """A tensor on another device is refused, not computed on the CPU."""
    dom = Domain(size=(4, 4, 4))
    meta = {f: torch.empty((2, 64), device="meta") for f in FIELDS[:6]}
    bk = fb.Buckets(**meta, valid=torch.empty((2, 64), dtype=torch.bool,
                                              device="meta"),
                    dropped=torch.empty((), dtype=torch.int32,
                                        device="meta"))
    call = {"rebin_fused": lambda: rbk.rebin_fused(bk, dom),
            "rebin_fused_slab": lambda: rbk.rebin_fused_slab(bk, dom, 0, 4)}
    with pytest.raises(ValueError, match="unsupported device"):
        call[which]()


# -- the card: the kernel against the plain versions -------------------------


def _fused_once(bk, dom):
    before = rbk.rebin_fused.launches
    got = rbk.rebin_fused(bk, dom)
    torch.cuda.synchronize()
    assert rbk.rebin_fused.launches == before + 1
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("scale", [1.0, 6.0])
def test_rebin_fused_kernel_matches_plain_and_three_pass(cuda, scale):
    dom, moved = _corner24(cuda, scale)
    got = _fused_once(moved, dom)
    _assert_equal(got, fb.rebin(moved, dom))
    before = rbk.rebin_pass.launches
    _assert_equal(got, rbk.rebin_three_pass(moved, dom))
    assert rbk.rebin_pass.launches == before + 3
    if scale > 1.0:
        assert int(got.dropped) > 0


@pytest.mark.gpu
def test_rebin_fused_kernel_overflow_fixture(cuda):
    dom, bk = _overflow(cuda)
    got = _fused_once(bk, dom)
    assert int(got.dropped) == 1
    _assert_equal(got, fb.rebin(bk, dom))
    _assert_equal(got, rbk.rebin_three_pass(bk, dom))


@pytest.mark.gpu
@pytest.mark.parametrize("ppc", [1, 24, 40])
def test_rebin_fused_kernel_made_up_buckets(cuda, ppc):
    dom, bk = _made_up(ppc, ppc, cuda)
    got = _fused_once(bk, dom)
    assert int(got.dropped) > 0
    _assert_equal(got, fb.rebin(bk, dom))
    _assert_equal(got, rbk.rebin_three_pass(bk, dom))
    # two launches are bitwise equal
    _assert_equal(_fused_once(bk, dom), got)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [4, 8])
def test_rebin_fused_slab_kernel_matches_one_domain(cuda, n):
    dom, bk = _crossing(cuda)
    whole = _fused_once(bk, dom)
    mesh = shd.make_zmesh(n, devices=[cuda])
    lz = 16 // n
    local = Domain(size=(16, 16, lz))
    ext = rbk.halo_buckets(shd.shard_buckets(bk, mesh).slabs, 1, local)
    drops, t = [], local.num_cells
    for i, e in enumerate(ext):
        before = rbk.rebin_fused_slab.launches
        got = rbk.rebin_fused_slab(e, local, i * lz, 16)
        torch.cuda.synchronize()
        assert rbk.rebin_fused_slab.launches == before + 1
        _assert_equal(got, fb.rebin_slab_plain(e, local, i * lz, 16))
        for f in FIELDS:
            assert torch.equal(getattr(got, f),
                               getattr(whole, f)[:, i * t:(i + 1) * t]), (i, f)
        drops.append(int(got.dropped))
    assert sum(drops) == int(whole.dropped) > 0
    before = rbk.rebin_fused_slab.launches
    out = rbk.rebin_zshard(shd.shard_buckets(bk, mesh), dom, mesh)
    assert rbk.rebin_fused_slab.launches == before + n
    _assert_equal(shd.unshard_buckets(out), whole)
