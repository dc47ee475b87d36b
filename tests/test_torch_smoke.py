"""The smoke step of mantaflow_tpu_torch vs mantaflow_tpu: the whole slice.

Three steps at 16^3 under the bench parameters (bench.py:193-197), the JAX
side on use_pallas=True (its Pallas kernels in interpret mode), the port on
the CPU. Grids agree to abs 2e-4 (tests/test_smoke_model.py's tolerance:
the CG exits on a 1e-3 residual), the time state to 1e-6.
"""

import jax
import numpy as np
import pytest
import torch

from mantaflow_tpu.core.domain import Domain as JDomain
from mantaflow_tpu.core.shapes import Sphere as JSphere
from mantaflow_tpu.models import smoke as jsmoke
from mantaflow_tpu_torch.core.domain import Domain
from mantaflow_tpu_torch.core.shapes import Sphere
from mantaflow_tpu_torch.models import smoke as tsmoke

RES = 16
BENCH = dict(buoyancy=(0.0, -6e-4, 0.0), vorticity_confinement=0.1,
             cg_accuracy=1e-3, window=3, adaptive_dt=True, cfl=3.0,
             dt_max=2.0)
SOURCE = dict(center=(RES / 2.0, RES * 0.1, RES / 2.0), radius=RES * 0.14)
TS = ("dt", "time_total", "time_per_frame", "frame", "lock_dt", "count")


def _jax_to_numpy(st):
    d = {k: np.asarray(getattr(st, k))
         for k in ("flags", "vel", "density", "pressure", "source")}
    d["ts"] = {k: np.asarray(getattr(st.ts, k)) for k in TS}
    return d


@pytest.fixture(scope="module")
def runs():
    jdom = JDomain(size=(RES,) * 3)
    jp = jsmoke.SmokeParams(**BENCH, use_pallas=True)
    jst = jsmoke.make_smoke_state(jdom, jp, source_shape=JSphere(**SOURCE))
    init = _jax_to_numpy(jst)
    step = jax.jit(lambda s: jsmoke.smoke_step(s, jdom, jp))
    for _ in range(3):
        jst = step(jst)

    dom = Domain(size=(RES,) * 3)
    tp = tsmoke.SmokeParams(**BENCH, use_pallas=True)
    tst = tsmoke.make_smoke_state(dom, tp, source_shape=Sphere(**SOURCE),
                                  device="cpu")
    tst3 = tsmoke.smoke_run(tst, dom, tp, 3)
    return dict(init=init, jax=_jax_to_numpy(jst), dom=dom, tp=tp, tst=tst,
                torch=tsmoke.state_to_numpy(tst3))


def test_initial_state_matches_reference(runs):
    got = tsmoke.state_to_numpy(runs["tst"])
    for k in ("flags", "vel", "density", "pressure", "source"):
        assert got[k].dtype == runs["init"][k].dtype, k
        np.testing.assert_array_equal(got[k], runs["init"][k], err_msg=k)


@pytest.mark.parametrize("field", ["density", "vel", "pressure"])
def test_three_steps_match_reference(runs, field):
    np.testing.assert_allclose(runs["torch"][field], runs["jax"][field],
                               atol=2e-4)


def test_time_state_matches_reference(runs):
    for k in TS:
        got, ref = runs["torch"]["ts"][k], runs["jax"]["ts"][k]
        assert got.dtype == ref.dtype, k
        np.testing.assert_allclose(got, ref, atol=1e-6, err_msg=k)
    assert int(runs["torch"]["ts"]["count"]) == 3


def test_state_numpy_round_trip(runs):
    """A JAX state crosses to the port and back unchanged, and the port
    steps on from it like the reference does."""
    st = tsmoke.state_from_numpy(runs["init"], device="cpu")
    back = tsmoke.state_to_numpy(st)
    for k in ("flags", "vel", "density", "pressure", "source"):
        np.testing.assert_array_equal(back[k], runs["init"][k])
    for k in TS:
        np.testing.assert_array_equal(back["ts"][k], runs["init"]["ts"][k])
    st = tsmoke.smoke_run(st, runs["dom"], runs["tp"], 3)
    np.testing.assert_allclose(st.density.numpy(), runs["jax"]["density"],
                               atol=2e-4)


def test_make_smoke_state_needs_cuda_or_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsmoke.make_smoke_state(Domain(size=(8, 8, 8)),
                                tsmoke.SmokeParams(**BENCH))
