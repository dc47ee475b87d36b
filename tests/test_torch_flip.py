"""The bucketed FLIP step of mantaflow_tpu_torch vs mantaflow_tpu: the
whole slice.

Three steps of the bench's FLIP dam (bench.py:84-86: gravity -0.003, ghost
fluid, CG 1e-3, ring-only obstacles) at 16^3 with PPC 10, the JAX side on
its CPU branch (flip_step_bucketed's XLA forms), the port on the CPU (the
kernel wrappers' plain versions). Flags, valid masks, particle counts and
the time state are exact; grids agree to abs 1e-4 (the CG exits on a 1e-3
residual and sums in another order); particle positions to abs 1e-5.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from mantaflow_tpu.core.domain import Domain as JDomain
from mantaflow_tpu.models import flip as jflip
from mantaflow_tpu_torch.core.domain import Domain
from mantaflow_tpu_torch.models import flip as tflip

RES = 16
BENCH = dict(gravity=(0.0, -0.003, 0.0), ghost_fluid=True, cg_accuracy=1e-3,
             ring_only_obstacles=True)
TS = ("dt", "time_total", "time_per_frame", "frame", "lock_dt", "count")
BUCKETS = ("px", "py", "pz", "vx", "vy", "vz", "valid", "dropped")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs test files in parallel worker processes; torch's own
    thread pool in each would oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_to_numpy(st):
    d = {k: np.asarray(getattr(st, k))
         for k in ("flags", "vel", "vel_old", "pressure", "phi")}
    d["buckets"] = {k: np.asarray(getattr(st.buckets, k)) for k in BUCKETS}
    d["ts"] = {k: np.asarray(getattr(st.ts, k)) for k in TS}
    d["blend_pending"] = np.asarray(st.blend_pending)
    return d


@pytest.fixture(scope="module")
def runs():
    jdom = JDomain(size=(RES,) * 3)
    jp = jflip.FlipParams(**BENCH)
    jst = jflip.make_dam_state_bucketed(jdom, jp, ppc=10)
    init = _jax_to_numpy(jst)
    step = jax.jit(lambda s: jflip.flip_step_bucketed(s, jdom, jp))
    for _ in range(3):
        jst = step(jst)
    jfin = jflip.finalize_buckets(jst, jdom, jp)

    dom = Domain(size=(RES,) * 3)
    tp = tflip.FlipParams(**BENCH)
    tst = tflip.make_dam_state_bucketed(dom, tp, ppc=10, device="cpu")
    tst3 = tst
    for _ in range(3):
        tst3 = tflip.flip_step_bucketed(tst3, dom, tp)
    return dict(init=init, jax=_jax_to_numpy(jst), jfin=_jax_to_numpy(jfin),
                dom=dom, tp=tp, tst=tst, tst3=tst3,
                torch=tflip.state_to_numpy(tst3))


def test_initial_state_matches_reference(runs):
    got = tflip.state_to_numpy(runs["tst"])
    for k in ("flags", "vel", "vel_old", "pressure", "phi", "blend_pending"):
        assert got[k].dtype == runs["init"][k].dtype, k
        np.testing.assert_array_equal(got[k], runs["init"][k], err_msg=k)
    for k in BUCKETS:
        np.testing.assert_array_equal(got["buckets"][k],
                                      runs["init"]["buckets"][k], err_msg=k)


def test_three_steps_exact_parts_match_reference(runs):
    got, ref = runs["torch"], runs["jax"]
    np.testing.assert_array_equal(got["flags"], ref["flags"])
    np.testing.assert_array_equal(got["buckets"]["valid"],
                                  ref["buckets"]["valid"])
    assert int(got["buckets"]["dropped"]) == int(ref["buckets"]["dropped"]) \
        == 0
    assert got["buckets"]["valid"].sum() == \
        runs["init"]["buckets"]["valid"].sum()
    assert bool(got["blend_pending"])
    for k in TS:
        assert got["ts"][k].dtype == ref["ts"][k].dtype, k
        np.testing.assert_allclose(got["ts"][k], ref["ts"][k], atol=1e-6,
                                   err_msg=k)
    assert int(runs["tst3"].cg_iters) > 0


@pytest.mark.parametrize("field", ["vel", "vel_old", "phi", "pressure"])
def test_three_steps_grids_match_reference(runs, field):
    np.testing.assert_allclose(runs["torch"][field], runs["jax"][field],
                               atol=1e-4)


def test_three_steps_particles_match_reference(runs):
    for k in ("px", "py", "pz", "vx", "vy", "vz"):
        np.testing.assert_allclose(runs["torch"]["buckets"][k],
                                   runs["jax"]["buckets"][k], atol=1e-5,
                                   err_msg=k)


def test_finalize_buckets_matches_reference(runs):
    fin = tflip.finalize_buckets(runs["tst3"], runs["dom"], runs["tp"])
    assert not bool(fin.blend_pending)
    for k in ("vx", "vy", "vz"):
        np.testing.assert_allclose(getattr(fin.buckets, k).numpy(),
                                   runs["jfin"]["buckets"][k], atol=1e-5)
    again = tflip.finalize_buckets(fin, runs["dom"], runs["tp"])
    assert torch.equal(again.buckets.vx, fin.buckets.vx)


def test_state_numpy_round_trip(runs):
    """The JAX initial state crosses to the port and back unchanged, and
    the port steps on from it like the reference does."""
    st = tflip.state_from_numpy(runs["init"], device="cpu")
    back = tflip.state_to_numpy(st)
    for k in ("flags", "vel", "pressure", "phi"):
        np.testing.assert_array_equal(back[k], runs["init"][k])
    for k in BUCKETS:
        np.testing.assert_array_equal(back["buckets"][k],
                                      runs["init"]["buckets"][k])
    for _ in range(3):
        st = tflip.flip_step_bucketed(st, runs["dom"], runs["tp"])
    np.testing.assert_array_equal(st.flags.numpy(), runs["jax"]["flags"])
    np.testing.assert_allclose(st.vel.numpy(), runs["jax"]["vel"], atol=1e-4)


def test_run_auto_escalates_without_losing_particles():
    """PPC 8 leaves no headroom over discretization 2's eight particles
    per cell; under a strong gravity a step of the second chunk overflows.
    The runner rebins the pre-chunk state at _next_ppc(8 + 4, 8) = 16 and
    redoes the chunk; the per-step runner does the same for one step."""
    dom = Domain(size=(12,) * 3)
    p = tflip.FlipParams(**{**BENCH, "gravity": (0.0, -0.1, 0.0)})
    st = tflip.make_dam_state_bucketed(dom, p, ppc=8, device="cpu")
    n0 = int(st.buckets.count())
    probe = [st]
    for _ in range(6):
        probe.append(tflip.flip_step_bucketed(probe[-1], dom, p))
    drops = [int(s.buckets.dropped) for s in probe]
    first = next(i for i, d in enumerate(drops) if d > 0)
    assert 3 < first <= 6
    out = tflip.flip_run_bucketed_auto(st, dom, p, 6, check_every=3)
    assert out.buckets.ppc == 16 == tflip._next_ppc(12, 8)
    assert int(out.buckets.dropped) == 0
    assert int(out.buckets.count()) == n0
    assert int(out.ts.count) == 6
    one = tflip.flip_step_bucketed_auto(probe[first - 1], dom, p)
    assert one.buckets.ppc == 16
    assert int(one.buckets.dropped) == 0
    assert int(one.buckets.count()) == n0


def test_next_ppc_matches_reference():
    for want, occ in ((14, 9), (12, 17), (16, 16), (20, 3)):
        assert tflip._next_ppc(want, occ) == jflip._next_ppc(want, occ)


def test_guards_match_reference():
    dom = Domain(size=(12,) * 3)
    st = tflip.make_dam_state_bucketed(dom, tflip.FlipParams(), device="cpu")
    with pytest.raises(ValueError, match="FLIP blend"):
        tflip.flip_step_bucketed(st, dom, tflip.FlipParams(apic=True))
    with pytest.raises(ValueError, match="cfl"):
        tflip.flip_step_bucketed(st, dom,
                                 tflip.FlipParams(adaptive_dt=True, cfl=3.0))
    # a CFL violation at run time surfaces in buckets.dropped
    fast = dataclasses.replace(st, vel=st.vel + 10.0)
    out = tflip.flip_step_bucketed(fast, dom,
                                   tflip.FlipParams(ghost_fluid=True))
    assert int(out.buckets.dropped) >= 1_000_000
    with pytest.raises(ValueError, match="ring_only"):
        tflip.make_dam_state_bucketed(
            dom, tflip.FlipParams(ring_only_obstacles=True), obstacle=object(),
            device="cpu")
    # what is still not ported says where it is queued
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tflip.flip_step_bucketed(st, dom, tflip.FlipParams(preconditioner=1))


@pytest.mark.parametrize("params,route", [
    (dict(ghost_fluid=False), ["p2g_mac"]),
    (dict(ghost_fluid=True, radius_factor=1.5), ["p2g_mac",
                                                 "union_levelset"]),
    (dict(ghost_fluid=True), ["p2g_union"]),
])
def test_step_routes_run_through_the_wrappers(monkeypatch, params, route):
    """The step reaches the transfer and the levelset through the kernel
    wrappers on every route (on the CPU they run the plain versions), as
    the TPU branch routes: fused when there is ghost fluid and the radius
    spans one cell, else the transfer alone and, with ghost fluid, the
    levelset for the wider radius."""
    dom = Domain(size=(8,) * 3)
    st = tflip.make_dam_state_bucketed(dom, tflip.FlipParams(), device="cpu")
    seen = []
    for mod, name in ((tflip.p2gk, "p2g_mac"), (tflip.p2gk, "p2g_union"),
                      (tflip.lsk, "union_levelset")):
        orig = getattr(mod, name)
        monkeypatch.setattr(
            mod, name, lambda *a, _o=orig, _n=name, **k: (seen.append(_n),
                                                          _o(*a, **k))[1])
    out = tflip.flip_step_bucketed(st, dom, tflip.FlipParams(**params))
    assert seen == route
    assert int(out.buckets.count()) == int(st.buckets.count())
    if params["ghost_fluid"]:
        assert not torch.equal(out.phi, st.phi)
    else:
        assert torch.equal(out.phi, st.phi)


def test_finalize_runs_through_the_blend_wrapper(monkeypatch):
    dom = Domain(size=(8,) * 3)
    p = tflip.FlipParams()
    st = tflip.flip_step_bucketed(
        tflip.make_dam_state_bucketed(dom, p, device="cpu"), dom, p)
    calls = []
    orig = tflip.blk.flip_update
    monkeypatch.setattr(tflip.blk, "flip_update",
                        lambda *a: (calls.append(1), orig(*a))[1])
    fin = tflip.finalize_buckets(st, dom, p)
    assert calls == [1] and not bool(fin.blend_pending)


def test_make_dam_state_needs_cuda_or_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tflip.make_dam_state_bucketed(Domain(size=(8,) * 3),
                                      tflip.FlipParams())
