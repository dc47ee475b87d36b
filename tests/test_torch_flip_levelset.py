"""The scene-API FLIP functions of mantaflow_tpu_torch vs mantaflow_tpu:
the averaged and improved particle levelsets (with the Cardano eigenvalue
solver and the smoothing passes), combineGridVel and adjustNumber.

Inputs are made from a numpy seed: particles over a 16^3 (and a 24x20 2D)
breaking dam, jittered so that their averaged positions stretch, a few
deleted, dead slots after them; the JAX side runs on the CPU (these are XLA
in the JAX package, no Pallas kernel), the port on the CPU. Tolerances: the
levelsets to abs 1e-5 (the kernel sums are scatter-adds in another order
than XLA's, and the eigenvalue solver's cube roots and arc cosines are
other implementations than XLA's); the smoothing passes and
combine_grid_vel exact; adjust_number bitwise (positions, flags, count:
the seeds are the reference's RandomStream draws).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mantaflow_tpu.core import particles as jcp
from mantaflow_tpu.core.domain import Domain as JDomain
from mantaflow_tpu.models import flip as jflip
from mantaflow_tpu.ops import flip as jfo
from mantaflow_tpu_torch.core import particles as tcp
from mantaflow_tpu_torch.core.domain import Domain
from mantaflow_tpu_torch.ops import flip as tfo

SIZES = {"3d": ((16, 16, 16), 3), "2d": ((24, 20, 1), 2)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs test files in parallel worker processes; torch's own
    thread pool in each would oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(dim, seed=0, spare=400):
    """The dam's particles (the JAX package's sampling) jittered by up to
    0.45 cells, 15 deleted, ``spare`` dead slots after them; the dam's
    flags, a random MAC field, a type channel and a levelset that is the
    dam's box distance plus noise."""
    size, d = SIZES[dim]
    jdom, dom = JDomain(size=size, dim=d), Domain(size=size, dim=d)
    st = jflip.make_dam_state(jdom, jflip.FlipParams(), discretization=2)
    n = int(st.parts.count)
    cap = n + spare
    rng = np.random.default_rng(seed)
    pos = np.zeros((cap, 3), np.float32)
    pos[:n] = np.asarray(st.parts.pos)[:n]
    pos[:n] += rng.uniform(-0.45, 0.45, (n, 3)).astype(np.float32)
    if d == 2:
        pos[:, 2] = 0.5
    pos[:n] = np.clip(pos[:n], 0.01, np.array(size, np.float32) - 0.01)
    pflags = np.zeros(cap, np.int32)
    pflags[rng.choice(n, 15, replace=False)] = jcp.PDELETE
    pflags[n:] = jcp.PINVALID | jcp.PDELETE
    sz, sy, sx = jdom.shape
    yy = np.arange(sy, dtype=np.float32).reshape(1, sy, 1) + 0.5
    xx = np.arange(sx, dtype=np.float32).reshape(1, 1, sx) + 0.5
    phi = (np.maximum(yy - 0.6 * sy, xx - 0.4 * sx)
           + rng.normal(0.0, 0.3, jdom.shape)).astype(np.float32)
    phi = np.broadcast_to(phi, jdom.shape).copy()
    return dict(
        jdom=jdom, dom=dom, n=n, pos=pos, pflags=pflags,
        flags=np.array(st.flags), phi=phi,
        ptype=rng.choice([1, 2, 4], cap).astype(np.int32),
        vel=rng.uniform(-1, 1, (3,) + dom.shape).astype(np.float32),
        weight=np.where(rng.random((3,) + dom.shape) < 0.5,
                        rng.uniform(0, 2, (3,) + dom.shape), 0.0
                        ).astype(np.float32),
        cvel=rng.uniform(-1, 1, (3,) + dom.shape).astype(np.float32))


def _parts(c):
    j = jcp.Particles(pos=jnp.asarray(c["pos"]), flags=jnp.asarray(c["pflags"]),
                      count=jnp.int32(c["n"]))
    t = tcp.Particles(pos=torch.from_numpy(c["pos"].copy()),
                      flags=torch.from_numpy(c["pflags"].copy()),
                      count=torch.tensor(c["n"], dtype=torch.int32))
    return j, t


@pytest.fixture(scope="module", params=sorted(SIZES))
def case(request):
    return _case(request.param)


@pytest.mark.parametrize("kw", [
    dict(), dict(radius_factor=2.0, smoothen=2, smoothen_neg=0),
    dict(smoothen=0, smoothen_neg=3, exclude=2)], ids=["default", "wide",
                                                        "exclude"])
@pytest.mark.parametrize("which", ["averaged", "improved"])
def test_particle_levelsets_match_reference(case, which, kw):
    jp, tp = _parts(case)
    jkw, tkw = dict(kw), dict(kw)
    if "exclude" in kw:
        jkw["ptype"] = jnp.asarray(case["ptype"])
        tkw["ptype"] = torch.from_numpy(case["ptype"])
    jfn = getattr(jfo, f"{which}_particle_levelset")
    tfn = getattr(tfo, f"{which}_particle_levelset")
    ref = np.asarray(jfn(jp, jnp.asarray(case["flags"]), case["jdom"],
                         **jkw))
    got = tfn(tp, torch.from_numpy(case["flags"]), case["dom"], **tkw)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)
    assert (ref < 0).any() and (ref > 0).any()


def test_max_eigenvalue_matches_reference():
    """The Cardano solver on random matrices, on symmetric ones (three real
    roots) and on rotations scaled by s (one real root s and a complex pair:
    the reference reports max(s, 0))."""
    rng = np.random.default_rng(3)
    mats = [rng.normal(0, 1.5, (200, 3, 3))]
    a = rng.normal(0, 1, (200, 3, 3))
    mats.append(a + np.swapaxes(a, 1, 2))
    th = rng.uniform(0.3, 2.5, 200)
    s = rng.uniform(-2, 2, 200)
    rot = np.zeros((200, 3, 3))
    rot[:, 0, 0] = rot[:, 1, 1] = np.cos(th)
    rot[:, 0, 1], rot[:, 1, 0] = -np.sin(th), np.sin(th)
    rot[:, 2, 2] = 1.0
    mats.append(rot * s[:, None, None])
    m = np.concatenate(mats).astype(np.float32)
    ref = np.asarray(jfo._max_eigenvalue_3x3(jnp.asarray(m)))
    got = tfo._max_eigenvalue_3x3(torch.from_numpy(m)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    # the complex pair reported as 0: a negative real root reads 0
    np.testing.assert_array_equal(got[-200:][s < -0.1], 0.0)


@pytest.mark.parametrize("smoothen,smoothen_neg", [(1, 1), (2, 0), (0, 2),
                                                   (3, 1)])
def test_smoothing_passes_match_reference(case, smoothen, smoothen_neg):
    """The smoothing loop with its swap quirks, and the two smoothing
    kernels alone, exactly."""
    phi = case["phi"]
    f = 1.0 / 7.0
    ref = jfo._smooth_postprocess(jnp.asarray(phi), case["jdom"], smoothen,
                                  smoothen_neg, f)
    got = tfo._smooth_postprocess(torch.from_numpy(phi), case["dom"],
                                  smoothen, smoothen_neg, f)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    for name in ("_smooth_grid", "_smooth_grid_neg"):
        ref = getattr(jfo, name)(jnp.asarray(phi), case["jdom"], f)
        got = getattr(tfo, name)(torch.from_numpy(phi), case["dom"], f)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("kw", [dict(), dict(thresh=0.5),
                                dict(phi=True, narrow_band=1.5),
                                dict(phi=True, narrow_band=0.0, thresh=0.2)])
def test_combine_grid_vel_matches_reference(case, kw):
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("phi"):
        jkw["phi"] = jnp.asarray(case["phi"])
        tkw["phi"] = torch.from_numpy(case["phi"])
    ref = jfo.combine_grid_vel(jnp.asarray(case["vel"]),
                               jnp.asarray(case["weight"]),
                               jnp.asarray(case["cvel"]), case["jdom"],
                               **jkw)
    got = tfo.combine_grid_vel(torch.from_numpy(case["vel"]),
                               torch.from_numpy(case["weight"]),
                               torch.from_numpy(case["cvel"]), case["dom"],
                               **tkw)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("kw", [
    dict(min_particles=8, max_particles=6),
    dict(min_particles=12, max_particles=20, narrow_band=2.0),
    dict(min_particles=10, max_particles=3, radius_factor=1.5,
         exclude=True),
    dict(min_particles=2, max_particles=30)],
    ids=["cull_and_seed", "band", "exclude", "nothing_to_seed"])
def test_adjust_number_matches_reference_bitwise(case, kw):
    """Culls, kills out of the band and reseeds: positions, flags and count
    bit for bit, the seeds the reference's RandomStream(9832) draws. The
    'band' case asks for more seeds than there are free slots."""
    jp, tp = _parts(case)
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("exclude"):
        ex = np.where(np.arange(case["dom"].num_cells).reshape(
            case["dom"].shape) % 3 == 0, -1.0, 1.0).astype(np.float32)
        jkw["exclude"], tkw["exclude"] = jnp.asarray(ex), torch.from_numpy(ex)
    args = (case["vel"], case["flags"])
    ref = jfo.adjust_number(jp, *map(jnp.asarray, args), case["jdom"],
                            phi=jnp.asarray(case["phi"]), **jkw)
    got = tfo.adjust_number(tp, *map(torch.from_numpy, args), case["dom"],
                            phi=torch.from_numpy(case["phi"]), **tkw)
    np.testing.assert_array_equal(got.pos.numpy(), np.asarray(ref.pos))
    np.testing.assert_array_equal(got.flags.numpy(), np.asarray(ref.flags))
    assert int(got.count) == int(ref.count) == got.capacity
    # particles were killed or culled, and (but for the last case) the
    # freed slots reseeded
    assert (got.flags.numpy() != case["pflags"]).sum() > 15
    if kw["min_particles"] > 2:
        assert ((got.flags.numpy() & jcp.PNEW) != 0).any()


def test_adjust_number_input_untouched(case):
    """The port updates copies: the input particles stay as they were."""
    _, tp = _parts(case)
    before = dataclasses.replace(tp, pos=tp.pos.clone(),
                                 flags=tp.flags.clone())
    tfo.adjust_number(tp, torch.from_numpy(case["vel"]),
                      torch.from_numpy(case["flags"]), case["dom"], 8, 6,
                      torch.from_numpy(case["phi"]))
    assert torch.equal(tp.pos, before.pos)
    assert torch.equal(tp.flags, before.flags)
