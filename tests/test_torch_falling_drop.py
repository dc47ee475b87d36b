"""Why ``test_2045_fallingDrop`` stays out of the port's golden matrix
(``scene/refgolden.py:LEFT_OUT``): the frame-restart experiment.

The scene (tests/ref_scenes/test_2045_fallingDrop.py at 45^3) runs on the
JAX package from the same numpy levelset as the existing
``test_left_out_goldens_track_reference``; the port then restarts from the
JAX package's own state:

- one frame of the port from the JAX package's frame-4 state gives its
  frame 5 to 1e-5 (phi and vel), and its ``reinitMarching`` of the JAX
  package's frame-5 state is the JAX package's bit for bit;
- the port's frame-5 phi differs from the JAX package's by a few ulp, and
  that is enough: ``reinitMarching`` of the two frame-5 states parts by
  more than 0.1 at the narrow band's edge, in the JAX package's own
  reinit as in the port's. The marching order there turns on the last
  bits, so the spikes (0.1-0.24 at frames 6, 8, 13 and 18 of a chained
  run, the 0.061 against the golden's 0.03 at frame 18) come from float
  rounding that no float32 port of XLA's order-2 advection reproduces,
  not from a step the port computes otherwise. The Box SDF is not the
  cause: started from the JAX package's own levelset the port reaches the
  same 0.061.
"""

import numpy as np
import pytest
import torch

import mantaflow_tpu as J  # noqa: E402
import mantaflow_tpu_torch as T  # noqa: E402

F32 = np.float32
RES = 45


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def arr(x):
    x = x.data if hasattr(x, "data") else x
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _grids(m, st):
    s = (J.Solver(name="main", gridSize=m.vec3(RES, RES, RES), dim=3)
         if m is J else T.Solver(name="main", device="cpu",
                                 gridSize=m.vec3(RES, RES, RES), dim=3))
    s.timestep = 0.6
    g = {"s": s, "flags": s.create(m.FlagGrid), "vel": s.create(m.MACGrid),
         "p": s.create(m.RealGrid), "phi": s.create(m.LevelsetGrid)}
    for k in ("flags", "vel", "p", "phi"):
        g[k].from_numpy(st[k])
    return g


def _state(g):
    return {k: arr(g[k]).copy() for k in ("flags", "vel", "p", "phi")}


def _reinit(m, st):
    g = _grids(m, st)
    g["phi"].reinitMarching(flags=g["flags"], velTransport=g["vel"])
    return arr(g["phi"]).copy()


def _frame(m, st):
    """One frame of the scene's loop from ``st``."""
    g = _grids(m, st)
    f, vel, p, phi = g["flags"], g["vel"], g["p"], g["phi"]
    phi.reinitMarching(flags=f, velTransport=vel)
    m.advectSemiLagrange(flags=f, vel=vel, grid=phi, order=2, clampMode=1)
    f.updateFromLevelset(phi)
    m.advectSemiLagrange(flags=f, vel=vel, grid=vel, order=2, clampMode=1)
    m.addGravity(flags=f, vel=vel, gravity=m.vec3(0, -0.0125, 0))
    m.setWallBcs(flags=f, vel=vel)
    m.solvePressure(flags=f, vel=vel, pressure=p, cgMaxIterFac=0.5,
                    cgAccuracy=5e-5, phi=phi)
    m.setWallBcs(flags=f, vel=vel)
    g["s"].step()
    return _state(g)


def _start():
    """The scene's first state: its drop as a numpy levelset (the JAX
    package's Box SDF, computed in numpy), flags from it."""
    z, y, x = np.meshgrid(*[np.arange(RES, dtype=F32) + 0.5] * 3,
                          indexing="ij")
    lo, hi = F32(18.0), F32(27.0)
    d = np.maximum.reduce([lo - x, x - hi, F32(33.75) - y,
                           y - F32(42.75), lo - z, z - hi]).astype(F32)
    s = J.Solver(name="main", gridSize=J.vec3(RES, RES, RES), dim=3)
    f, phi = s.create(J.FlagGrid), s.create(J.LevelsetGrid)
    f.initDomain(boundaryWidth=0)
    phi.from_numpy(d)
    f.updateFromLevelset(phi)
    return {"flags": arr(f).copy(), "vel": np.zeros((3, RES, RES, RES), F32),
            "p": np.zeros((RES, RES, RES), F32), "phi": d}


def test_falling_drop_restarts_from_reference_state():
    st = _start()
    frames = []
    for _ in range(5):
        st = _frame(J, st)
        frames.append(st)
    j4, j5 = frames[3], frames[4]
    t5 = _frame(T, j4)
    np.testing.assert_array_equal(t5["flags"], j5["flags"])
    for k in ("phi", "vel"):
        np.testing.assert_allclose(t5[k], j5[k], atol=1e-5, rtol=0,
                                   err_msg=k)
    # the reinit of one state: the same bit for bit in both packages
    jr = _reinit(J, j5)
    np.testing.assert_array_equal(_reinit(T, j5), jr)
    # the two frame-5 states, a few ulp apart, part in either package's
    # reinit by more than 0.1 at the band's edge
    assert 0 < float(np.abs(t5["phi"] - j5["phi"]).max()) <= 1e-5
    for m in (J, T):
        assert float(np.abs(_reinit(m, t5) - jr).max()) > 0.1
