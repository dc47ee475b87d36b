"""The port's overflow-safe FLIP runner against mantaflow_tpu's, from one
state.

``flip_run_bucketed_auto`` of both packages runs the 12^3 dam under a strong
gravity (-0.1) at PPC 8, 6 steps in chunks of 3 (the fixture of
tests/test_torch_flip.py:test_run_auto_escalates_without_losing_particles):
PPC 8 leaves no headroom over the dam's eight particles per cell, a step of
the second chunk overflows, and each runner rebins the pre-chunk state at a
higher PPC and redoes the chunk. The JAX side runs its CPU branch, the port
on the CPU (the kernel wrappers' plain versions), both from the JAX
package's initial state. The PPC reached, the step count, ``dropped``, the
particle count, the flags and the valid masks are exact; the grids agree to
abs 1e-4 (the CG exits on a 1e-3 residual and sums in another order) and
the particles to abs 1e-5, as in tests/test_torch_flip.py.
"""

import numpy as np
import pytest
import torch

from mantaflow_tpu.core.domain import Domain as JDomain
from mantaflow_tpu.models import flip as jflip
from mantaflow_tpu_torch.core.domain import Domain
from mantaflow_tpu_torch.models import flip as tflip

RES = 12
PARAMS = dict(gravity=(0.0, -0.1, 0.0), ghost_fluid=True, cg_accuracy=1e-3,
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
    jp = jflip.FlipParams(**PARAMS)
    jst = jflip.make_dam_state_bucketed(jdom, jp, ppc=8)
    init = _jax_to_numpy(jst)
    jout = jflip.flip_run_bucketed_auto(jst, jdom, jp, 6, check_every=3)

    dom = Domain(size=(RES,) * 3)
    tst = tflip.state_from_numpy(init, device="cpu")
    tout = tflip.flip_run_bucketed_auto(tst, dom, tflip.FlipParams(**PARAMS),
                                        6, check_every=3)
    return dict(init=init, jax=_jax_to_numpy(jout),
                torch=tflip.state_to_numpy(tout))


def test_auto_runner_escalates_as_reference(runs):
    got, ref = runs["torch"], runs["jax"]
    n0 = int(runs["init"]["buckets"]["valid"].sum())
    assert got["buckets"]["valid"].shape[0] == ref["buckets"]["valid"].shape[0]
    # the runner escalated: _next_ppc(8 + 4, 8)
    assert ref["buckets"]["valid"].shape[0] == tflip._next_ppc(12, 8) == 16
    assert int(got["ts"]["count"]) == int(ref["ts"]["count"]) == 6
    assert int(got["buckets"]["dropped"]) == int(ref["buckets"]["dropped"]) \
        == 0
    assert int(got["buckets"]["valid"].sum()) == \
        int(ref["buckets"]["valid"].sum()) == n0


def test_auto_runner_exact_parts_match_reference(runs):
    got, ref = runs["torch"], runs["jax"]
    np.testing.assert_array_equal(got["flags"], ref["flags"])
    np.testing.assert_array_equal(got["buckets"]["valid"],
                                  ref["buckets"]["valid"])
    assert bool(got["blend_pending"]) == bool(ref["blend_pending"])
    for k in TS:
        np.testing.assert_allclose(got["ts"][k], ref["ts"][k], atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("field", ["vel", "vel_old", "phi", "pressure"])
def test_auto_runner_grids_match_reference(runs, field):
    np.testing.assert_allclose(runs["torch"][field], runs["jax"][field],
                               atol=1e-4)


def test_auto_runner_particles_match_reference(runs):
    for k in ("px", "py", "pz", "vx", "vy", "vz"):
        np.testing.assert_allclose(runs["torch"]["buckets"][k],
                                   runs["jax"]["buckets"][k], atol=1e-5,
                                   err_msg=k)
