"""The FLIP set-up of mantaflow_tpu_torch vs mantaflow_tpu: the random
stream, the dam's box levelset and flags, and the particle sampler.

Sampling runs on the host in numpy in both packages, so positions, counts
and capacities must be bit-identical, and so must the flags of the dam. The
box levelset evaluates the same float32 expressions branch for branch; XLA
may contract its ``a*a + b*b`` into a fused multiply-add, so it agrees to
two ulps (abs and rel 1e-6).
"""

import numpy as np
import pytest
import torch

from mantaflow_tpu.core import flags as jfl
from mantaflow_tpu.core import particles as jcp
from mantaflow_tpu.core.domain import Domain as JDomain
from mantaflow_tpu.core.shapes import Box as JBox
from mantaflow_tpu.utils.mtrand import RandomStream as JRandomStream
from mantaflow_tpu_torch.core import flags as tfl
from mantaflow_tpu_torch.core import particles as tcp
from mantaflow_tpu_torch.core.domain import Domain
from mantaflow_tpu_torch.core.shapes import Box
from mantaflow_tpu_torch.utils.mtrand import RandomStream

CPU = "cpu"
# (size, dim, box p1 as fractions of the size, boundary width)
CASES = [((16, 16, 16), 3, (0.4, 0.6, 1.0), 0),
         ((12, 10, 14), 3, (0.3, 0.3, 0.35), 1),
         ((20, 12, 1), 2, (0.5, 0.4, 1.0), 0)]


def _dam(size, dim, frac, bw):
    jdom, dom = JDomain(size=size, dim=dim), Domain(size=size, dim=dim)
    p1 = tuple(s * f for s, f in zip(size, frac))
    jphi = JBox(p0=(0, 0, 0), p1=p1, dim=dim).compute_levelset(jdom)
    tphi = Box(p0=(0, 0, 0), p1=p1, dim=dim).compute_levelset(dom, CPU)
    jflags = jfl.update_from_levelset(jfl.init_domain(jdom, bw), jphi, 1e10)
    tflags = tfl.update_from_levelset(tfl.init_domain(dom, bw, device=CPU),
                                      tphi, 1e10)
    return jdom, dom, jphi, tphi, jflags, tflags


@pytest.mark.parametrize("seed,n", [(9832, 1000), (7, 33)])
def test_random_stream_matches_reference(seed, n):
    a, b = RandomStream(seed), JRandomStream(seed)
    np.testing.assert_array_equal(a.rand_int(5), b.rand_int(5))
    got, ref = a.get_vec3s(n), b.get_vec3s(n)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("size,dim,frac,bw", CASES)
def test_box_levelset_and_flags_match_reference(size, dim, frac, bw):
    _, _, jphi, tphi, jflags, tflags = _dam(size, dim, frac, bw)
    assert tphi.dtype == torch.float32 and tflags.dtype == torch.int32
    np.testing.assert_allclose(tphi.numpy(), np.asarray(jphi), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_array_equal(tflags.numpy(), np.asarray(jflags))


def test_box_sdf_off_grid_points_match_reference():
    """Inside, face, edge and corner regions of BoxSDF, on points off the
    cell centres."""
    rng = np.random.RandomState(3)
    pts = rng.uniform(-4.0, 14.0, (3, 400)).astype(np.float32)
    jb = JBox(p0=(1.0, 2.0, 0.5), p1=(6.0, 7.5, 9.0))
    tb = Box(center=(3.5, 4.75, 4.75), size=(2.5, 2.75, 4.25))
    ref = np.asarray(jb.sdf(*pts))
    got = tb.sdf(*(torch.tensor(p) for p in pts)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("size,dim,frac,bw", CASES)
def test_sampled_positions_bit_exact(size, dim, frac, bw):
    jdom, dom, _, _, jflags, tflags = _dam(size, dim, frac, bw)
    ref = jcp.sample_flags_with_particles(np.asarray(jflags), jdom, 2, 0.05,
                                          headroom=1.02)
    got = tcp.sample_flags_with_particles(tflags.numpy(), dom, 2, 0.05,
                                          headroom=1.02, device=CPU)
    assert got.capacity == ref.capacity
    assert int(got.count) == int(ref.count) > 0
    np.testing.assert_array_equal(got.pos.numpy(), np.asarray(ref.pos))
    np.testing.assert_array_equal(got.flags.numpy(), np.asarray(ref.flags))
    np.testing.assert_array_equal(got.active_mask().numpy(),
                                  np.asarray(ref.active_mask()))


def test_make_particles_default_capacity_matches_reference():
    pos = np.random.RandomState(1).rand(1500, 3).astype(np.float32) * 8
    ref = jcp.make_particles(pos)
    got = tcp.make_particles(pos, device=CPU)
    assert got.capacity == ref.capacity == 4096
    assert got.count.dtype == torch.int32 and int(got.count) == 1500
    np.testing.assert_array_equal(got.pos.numpy(), np.asarray(ref.pos))
    np.testing.assert_array_equal(got.flags.numpy(), np.asarray(ref.flags))
