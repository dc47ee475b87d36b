"""The bucketed particle pipeline of mantaflow_tpu_torch (ops/flip_bucket.py,
the plain versions that the CPU runs and the CUDA kernels are held against)
vs mantaflow_tpu's XLA forms, on the same numpy inputs.

Fixtures: the 16^3 dam and the 24^3 corner dam of tests/test_flip_bucket.py,
binned by each package from its own (bit-identical) particle sample. The
kernel wrappers run their plain versions on these CPU tensors, so the cases
that go through a wrapper hold the kernel's function too.

Tolerances: binning, the rebin (a permutation), counts and flags are exact.
The advection and the blend repeat the reference's operations in its tap
order, so abs 1e-6 (the JAX tests hold the Pallas advection to XLA at
1e-6). p2g sums in another order than XLA's reduction (abs 1e-5, the
Pallas p2g's tolerance); the levelset takes a min of the same float
expressions (abs 1e-6).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mantaflow_tpu.core import particles as jcp
from mantaflow_tpu.core.domain import Domain as JDomain
from mantaflow_tpu.core.shapes import Sphere as JSphere
from mantaflow_tpu.models import flip as jflip
from mantaflow_tpu.ops import flip_bucket as jfb
from mantaflow_tpu_torch.core import flags as tfl
from mantaflow_tpu_torch.core import particles as tcp
from mantaflow_tpu_torch.core.domain import Domain
from mantaflow_tpu_torch.models import flip as tflip
from mantaflow_tpu_torch.ops import advect_bucket_kernels as tadv
from mantaflow_tpu_torch.ops import flip_bucket as tfb
from mantaflow_tpu_torch.ops import p2g_kernels as tp2g
from mantaflow_tpu_torch.ops import rebin_kernels as trb

FIELDS = ("px", "py", "pz", "vx", "vy", "vz")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs test files in parallel worker processes; torch's own
    thread pool in each would oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(res, frac, ppc):
    """(jdom, dom, JAX flags, port flags, JAX buckets, port buckets) of a
    dam set-up."""
    jdom, dom = JDomain(size=(res,) * 3), Domain(size=(res,) * 3)
    kw = dict(gravity=(0.0, -0.003, 0.0), ghost_fluid=True)
    jst = jflip.make_dam_state_bucketed(jdom, jflip.FlipParams(**kw),
                                        dam_frac=frac, ppc=ppc)
    tst = tflip.make_dam_state_bucketed(dom, tflip.FlipParams(**kw),
                                        dam_frac=frac, ppc=ppc, device="cpu")
    return jdom, dom, jst.flags, tst.flags, jst.buckets, tst.buckets


def _with_velocities(jbk, tbk):
    """Give both bucket sets the same made-up particle velocities."""
    def v(bk, xp, where):
        return dict(vx=where(bk.valid, bk.px * 0.01, 0.0),
                    vy=where(bk.valid, bk.py * 0.02 - 0.05, 0.0),
                    vz=where(bk.valid, bk.pz * 0.005, 0.0))
    return (dataclasses.replace(jbk, **v(jbk, jnp, jnp.where)),
            dataclasses.replace(tbk, **v(tbk, torch, torch.where)))


@pytest.fixture(scope="module")
def dam16():
    jdom, dom, jflags, tflags, jbk, tbk = _both(16, (0.4, 0.6, 1.0), 14)
    jbk, tbk = _with_velocities(jbk, tbk)
    return jdom, dom, jflags, tflags, jbk, tbk


@pytest.fixture(scope="module")
def corner24():
    jdom, dom, jflags, tflags, jbk, tbk = _both(24, (0.3, 0.3, 0.35), 12)
    jbk, tbk = _with_velocities(jbk, tbk)
    vel = np.random.RandomState(7).randn(3, 24, 24, 24).astype(np.float32)
    vel *= np.float32(0.25)
    return jdom, dom, jflags, tflags, jbk, tbk, vel


def _assert_buckets(got, ref, atol=0.0, fields=FIELDS):
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    assert int(got.dropped) == int(ref.dropped)
    assert got.dropped.dtype == torch.int32
    for f in fields:
        g, r = getattr(got, f).numpy(), np.asarray(getattr(ref, f))
        if atol == 0.0:
            np.testing.assert_array_equal(g, r, err_msg=f)
        else:
            np.testing.assert_allclose(g, r, atol=atol, rtol=0, err_msg=f)


def test_binning_matches_reference(dam16):
    _, _, _, _, jbk, tbk = dam16
    _assert_buckets(tbk, jbk)
    assert tbk.valid.dtype == torch.bool and tbk.px.dtype == torch.float32


def test_host_helpers_match_reference(dam16):
    jdom, dom, _, _, jbk, tbk = dam16
    assert tfb.max_cell_occupancy(tbk, dom) == \
        jfb.max_cell_occupancy(jbk, jdom) == 8
    _assert_buckets(tfb.rebin_to_ppc(tbk, dom, 16),
                    jfb.rebin_to_ppc(jbk, jdom, 16))
    with pytest.raises(ValueError, match="still overflows"):
        tfb.rebin_to_ppc(tbk, dom, 6)
    tparts, tpvel = tfb.to_particles(tbk, dom)
    jparts, jpvel = jfb.to_particles(jbk, jdom)
    assert tparts.capacity == jparts.capacity
    np.testing.assert_array_equal(tparts.pos.numpy(), np.asarray(jparts.pos))
    np.testing.assert_array_equal(tpvel.numpy(), np.asarray(jpvel))


def test_binning_overflow_counts_drops():
    pos = np.array([[3.2, 3.5, 3.5], [3.8, 3.5, 3.5], [3.5, 3.1, 3.9],
                    [1.5, 1.5, 1.5]], np.float32)
    vel = np.arange(12, dtype=np.float32).reshape(4, 3)
    jbk = jfb.bin_from_particles(jcp.make_particles(pos, capacity=8),
                                 jnp.asarray(np.pad(vel, ((0, 4), (0, 0)))),
                                 JDomain(size=(8, 8, 8)), ppc=2)
    tbk = tfb.bin_from_particles(tcp.make_particles(pos, capacity=8,
                                                    device="cpu"),
                                 np.pad(vel, ((0, 4), (0, 0))),
                                 Domain(size=(8, 8, 8)), ppc=2)
    assert int(tbk.dropped) == 1
    _assert_buckets(tbk, jbk)


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("ring_only", [True, False])
def test_advect_matches_reference(corner24, mode, ring_only):
    jdom, dom, jflags, tflags, jbk, tbk, vel = corner24
    ref = jfb.advect_bucketed(jbk, jflags, jnp.asarray(vel), 0.5, jdom, mode,
                              ring_only=ring_only)
    got = tfb.advect_bucketed(tbk, tflags, torch.tensor(vel),
                              torch.tensor(0.5), dom, mode,
                              ring_only=ring_only)
    _assert_buckets(got, ref, atol=1e-6)


def test_advect_into_sphere_obstacle_matches_reference(corner24):
    """flags-at-position probes and the bisection against a stamped
    sphere, with displacements large enough to reach it."""
    jdom, dom, jflags, tflags, jbk, tbk, vel = corner24
    inside = np.asarray(JSphere(center=(5.0, 4.0, 4.5), radius=3.0)
                        .inside_grid(jdom))
    jflags = jnp.where(inside, 2, jflags)
    tflags = torch.where(torch.tensor(inside), tfl.TypeObstacle, tflags)
    ref = jfb.advect_bucketed(jbk, jflags, jnp.asarray(vel) * 4, 1.0, jdom,
                              2)
    got = tfb.advect_bucketed(tbk, tflags, torch.tensor(vel) * 4,
                              torch.tensor(1.0), dom, 2)
    _assert_buckets(got, ref, atol=1e-6)


@pytest.mark.parametrize("pending", [True, False])
def test_blend_then_advect_matches_reference(corner24, pending):
    """advect_blend's plain version (what the kernel computes): the JAX
    CPU branch of flip_step_bucketed, blend where pending then advect."""
    jdom, dom, jflags, tflags, jbk, tbk, vel = corner24
    vold = vel * np.float32(0.85)
    ref = jfb.flip_update_bucketed(jbk, jnp.asarray(vel), jnp.asarray(vold),
                                   0.97, jdom) if pending else jbk
    ref = jfb.advect_bucketed(ref, jflags, jnp.asarray(vel), 0.5, jdom, 2,
                              ring_only=True)
    got = tadv.advect_blend(tbk, tflags, torch.tensor(vel),
                            torch.tensor(vold), torch.tensor(0.5),
                            torch.tensor(pending), 0.97, dom, 2,
                            ring_only=True)
    _assert_buckets(got, ref, atol=1e-6)


def test_flip_update_matches_reference(dam16):
    jdom, dom, _, _, jbk, tbk = dam16
    rng = np.random.RandomState(0)
    vel = rng.randn(3, 16, 16, 16).astype(np.float32) * np.float32(0.01)
    vold = rng.randn(3, 16, 16, 16).astype(np.float32) * np.float32(0.01)
    ref = jfb.flip_update_bucketed(jbk, jnp.asarray(vel), jnp.asarray(vold),
                                   0.97, jdom)
    got = tfb.flip_update_bucketed(tbk, torch.tensor(vel),
                                   torch.tensor(vold), 0.97, dom)
    _assert_buckets(got, ref, atol=1e-6)


def _moved(corner24, scale):
    jdom, dom, jflags, tflags, jbk, tbk, vel = corner24
    v = vel * np.float32(scale)
    return (jfb.advect_bucketed(jbk, jflags, jnp.asarray(v), 1.0, jdom, 0),
            tfb.advect_bucketed(tbk, tflags, torch.tensor(v),
                                torch.tensor(1.0), dom, 0))


@pytest.mark.parametrize("scale", [1.0, 6.0])
def test_rebin_matches_reference_bitwise(corner24, scale):
    """Scale 6 pushes most particles a cell or more: buckets overflow, and
    the same particles are dropped with the same count."""
    jdom, dom = corner24[:2]
    jm, tm = _moved(corner24, scale)
    ref = jfb.rebin(jm, jdom)
    got = trb.rebin(tm, dom)
    _assert_buckets(got, ref)
    if scale > 1.0:
        assert int(got.dropped) > 0
    # every valid particle sits in its bucket cell
    for p, c in zip((got.px, got.py, got.pz), tfb._cell_coords(dom, "cpu")):
        assert not bool((got.valid & (p.to(torch.int32) != c[None])).any())


def test_rebin_overflow_fixture_drops_match():
    """tests/test_flip_bucket.py's overflow fixture: five particles
    converge on one cell of ppc 4; the last in merge order is dropped."""
    pos = np.array([[3.5, 3.5, 3.5], [2.6, 3.5, 3.5], [4.4, 3.5, 3.5],
                    [3.5, 2.7, 3.5], [3.5, 3.5, 4.3]], np.float32)
    pvel = np.arange(8 * 3, dtype=np.float32).reshape(8, 3) * np.float32(0.01)
    tgt = 3.5  # exact in float32
    jdom, dom = JDomain(size=(8, 8, 8)), Domain(size=(8, 8, 8))
    jbk = jfb.bin_from_particles(jcp.make_particles(pos, capacity=8),
                                 jnp.asarray(pvel), jdom, ppc=4)
    tbk = tfb.bin_from_particles(tcp.make_particles(pos, capacity=8,
                                                    device="cpu"),
                                 pvel, dom, ppc=4)
    jbk = dataclasses.replace(jbk, **{
        f: jnp.where(jbk.valid, getattr(jbk, f)
                     + 0.9 * (tgt - getattr(jbk, f)), getattr(jbk, f))
        for f in ("px", "py", "pz")})
    tbk = dataclasses.replace(tbk, **{
        f: torch.where(tbk.valid, getattr(tbk, f)
                       + 0.9 * (tgt - getattr(tbk, f)), getattr(tbk, f))
        for f in ("px", "py", "pz")})
    ref = jfb.rebin(jbk, jdom)
    got = trb.rebin(tbk, dom)
    assert int(got.dropped) == 1
    _assert_buckets(got, ref)


def test_p2g_matches_reference(corner24):
    jdom, dom = corner24[:2]
    jm, tm = _moved(corner24, 1.0)
    jm, tm = jfb.rebin(jm, jdom), tfb.rebin(tm, dom)
    vref, wref = jfb.p2g_mac(jm, jdom)
    vel, weight = tfb.p2g_mac(tm, dom)
    np.testing.assert_allclose(vel.numpy(), np.asarray(vref), atol=1e-5)
    np.testing.assert_allclose(weight.numpy(), np.asarray(wref), atol=1e-5)


@pytest.mark.parametrize("radius_factor", [1.0, 1.5])
def test_union_levelset_matches_reference(dam16, radius_factor):
    jdom, dom, _, _, jbk, tbk = dam16
    ref = jfb.union_levelset_bucketed(jbk, jdom, radius_factor)
    got = tfb.union_levelset_bucketed(tbk, dom, radius_factor)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def test_p2g_union_plain_is_p2g_and_levelset(dam16):
    """The fused kernel's plain version returns p2g_mac's and
    union_levelset_bucketed's results; it takes rw == 1 radii only."""
    jdom, dom, _, _, jbk, tbk = dam16
    vel, weight, phi = tp2g.p2g_union(tbk, dom, 1.0)
    vref, wref = jfb.p2g_mac(jbk, jdom)
    np.testing.assert_allclose(vel.numpy(), np.asarray(vref), atol=1e-5)
    np.testing.assert_allclose(weight.numpy(), np.asarray(wref), atol=1e-5)
    np.testing.assert_allclose(
        phi.numpy(), np.asarray(jfb.union_levelset_bucketed(jbk, jdom, 1.0)),
        atol=1e-6)
    with pytest.raises(ValueError, match="rw == 1"):
        tp2g.p2g_union(tbk, dom, 1.5)


def test_counts_and_mark_fluid_match_reference(corner24):
    jdom, dom, jflags, tflags = corner24[:4]
    jm, tm = _moved(corner24, 1.0)
    jm, tm = jfb.rebin(jm, jdom), tfb.rebin(tm, dom)
    np.testing.assert_array_equal(tfb.counts_bucketed(tm, dom).numpy(),
                                  np.asarray(jfb.counts_bucketed(jm, jdom)))
    np.testing.assert_array_equal(
        tfb.mark_fluid_cells_bucketed(tm, tflags, dom).numpy(),
        np.asarray(jfb.mark_fluid_cells_bucketed(jm, jflags, jdom)))
