"""The smoke model of mantaflow_tpu_torch vs mantaflow_tpu in every
configuration the JAX package's SmokeParams accepts on one device.

Three steps from the same initial state, the JAX package's ``smoke_step``
on the CPU (XLA) and the port's on the CPU: the exact-gather advection
(window 0, the JAX package's default) with clamp modes 1 and 2; PcMIC;
PcMGStatic and PcMGDynamic (V-cycles and a CG tail, with the hierarchy the
state carries); the window path without ``use_pallas`` in 3D (the JAX
package's XLA compile of its 3D window path takes minutes, so that side
runs eagerly); and the 2D plume (scenes/plume_2d.py: open "yY" bounds,
window 3, MacCormack, PcNone) at 32^2. The window path with ``use_pallas``
is tests/test_torch_smoke.py's. Grids agree to abs 2e-4
(tests/test_smoke_model.py's tolerance: the CG exits on a 1e-3 residual),
flags and the time state exactly.
"""

import dataclasses

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
from mantaflow_tpu_torch.ops import multigrid as tmg

RES = 16
BENCH = dict(buoyancy=(0.0, -6e-4, 0.0), vorticity_confinement=0.1,
             cg_accuracy=1e-3, adaptive_dt=True, cfl=3.0, dt_max=2.0)
PLUME = dict(buoyancy=(0.0, -4e-3, 0.0), open_bound="yY", window=3)
# name: (params, size (x, y, z), run the JAX step eagerly)
CONFIGS = {
    "exact_clamp2": (dict(BENCH, window=0, clamp_mode=2), (RES,) * 3, False),
    "exact_clamp1": (dict(BENCH, window=0, clamp_mode=1), (RES,) * 3, False),
    "pcmic": (dict(BENCH, window=0, preconditioner=1), (RES,) * 3, False),
    "mg_static": (dict(BENCH, window=0, preconditioner=3), (RES,) * 3, False),
    "mg_dynamic": (dict(BENCH, window=0, preconditioner=2), (RES,) * 3,
                   False),
    "window_fast": (dict(BENCH, window=3), (RES,) * 3, True),
    "plume_2d": (PLUME, (32, 32, 1), False),
}
GRIDS = ("flags", "vel", "density", "pressure", "source")
TS = ("dt", "time_total", "time_per_frame", "frame", "lock_dt", "count")


def _source(size, sphere):
    sx, sy, sz = size
    return sphere(center=(sx / 2.0, sy * 0.1, sz / 2.0), radius=sx * 0.14)


def _jax_to_numpy(st):
    d = {k: np.asarray(getattr(st, k)) for k in GRIDS}
    d["ts"] = {k: np.asarray(getattr(st.ts, k)) for k in TS}
    return d


def _run(name):
    kw, size, eager = CONFIGS[name]
    dim = 3 if size[2] > 1 else 2
    jdom, dom = JDomain(size=size, dim=dim), Domain(size=size, dim=dim)
    jp = jsmoke.SmokeParams(**kw)
    jst = jsmoke.make_smoke_state(jdom, jp,
                                  source_shape=_source(size, JSphere))
    init = _jax_to_numpy(jst)
    jmg_init = jst.mg
    step = (lambda s: jsmoke.smoke_step(s, jdom, jp)) if eager else \
        jax.jit(lambda s: jsmoke.smoke_step(s, jdom, jp))
    for _ in range(3):
        jst = step(jst)
    tp = tsmoke.SmokeParams(**kw)
    tst = tsmoke.make_smoke_state(dom, tp, source_shape=_source(size, Sphere),
                                  device="cpu")
    return dict(init=init, jmg=jmg_init, tst=tst, dom=dom, tp=tp,
                jax=_jax_to_numpy(jst),
                torch=tsmoke.state_to_numpy(tsmoke.smoke_run(tst, dom, tp, 3)))


@pytest.fixture(scope="module", params=list(CONFIGS))
def runs(request):
    return request.param, _run(request.param)


def test_initial_state_matches_reference(runs):
    name, r = runs
    got = tsmoke.state_to_numpy(r["tst"])
    for k in GRIDS:
        assert got[k].dtype == r["init"][k].dtype, k
        np.testing.assert_array_equal(got[k], r["init"][k], err_msg=k)
    # the multigrid configurations carry the hierarchy the JAX package
    # builds
    assert (r["jmg"] is None) == (r["tst"].mg is None)
    if r["jmg"] is not None:
        ref = tmg.mg_from_numpy(r["jmg"], device="cpu")
        for a, b in zip(ref.level_flags, r["tst"].mg.level_flags):
            assert torch.equal(a, b)


def test_three_steps_match_reference(runs):
    name, r = runs
    np.testing.assert_array_equal(r["torch"]["flags"], r["jax"]["flags"])
    for field in ("density", "vel", "pressure"):
        np.testing.assert_allclose(r["torch"][field], r["jax"][field],
                                   atol=2e-4, err_msg=field)
    assert float(np.abs(r["torch"]["density"]).max()) > 0.1
    for k in TS:
        got, ref = r["torch"]["ts"][k], r["jax"]["ts"][k]
        assert got.dtype == ref.dtype, k
        np.testing.assert_array_equal(got, ref, err_msg=k)


def test_multigrid_dynamic_equals_static():
    """Through the smoke model PcMGDynamic runs on the hierarchy the state
    carries, as PcMGStatic does: bit for bit the same steps."""
    dom = Domain(size=(RES,) * 3)
    out = []
    for pc in (3, 2):
        p = tsmoke.SmokeParams(**dict(BENCH, window=0, preconditioner=pc))
        st = tsmoke.make_smoke_state(dom, p, source_shape=_source(
            (RES,) * 3, Sphere), device="cpu")
        out.append(tsmoke.smoke_run(st, dom, p, 2))
    for k in ("vel", "density", "pressure", "cg_iters"):
        assert torch.equal(getattr(out[0], k), getattr(out[1], k)), k


def test_state_round_trip_carries_the_hierarchy():
    dom = Domain(size=(RES,) * 3)
    p = tsmoke.SmokeParams(**dict(BENCH, window=0, preconditioner=3))
    st = tsmoke.make_smoke_state(dom, p, device="cpu")
    back = tsmoke.state_from_numpy(tsmoke.state_to_numpy(st), device="cpu")
    assert len(back.mg.level_flags) == len(st.mg.level_flags) == 2
    for a, b in zip(back.mg.denoms, st.mg.denoms):
        assert torch.equal(a, b)
    st1 = tsmoke.smoke_step(st, dom, p)
    back1 = tsmoke.smoke_step(back, dom, p)
    assert torch.equal(st1.pressure, back1.pressure)
    none = tsmoke.state_from_numpy(tsmoke.state_to_numpy(
        dataclasses.replace(st, mg=None)), device="cpu")
    assert none.mg is None
