"""The scene runner (``python -m mantaflow_tpu_torch.scene.run``) and the
slice as a whole: unedited scenes from ``scenes/`` on the port's CPU path
against the JAX package's run of the same file.

- ``scenes/flip06_obstacle.py 1 24`` (narrow-band FLIP, sphere obstacle,
  fractions, adaptive dt, a mesh every step) through the JAX scene API and
  through the runner with ``--device cpu``: flags, particle count and mesh
  triangles exact, phi and the particles within 2e-4 of their scale, the
  grids downstream of the pressure solve within its accuracy.
- ``scenes/smoke_fused_128.py`` cannot shrink (its res is a literal), so
  the port's ``smoke_run`` is held against the JAX package's at the
  scene's parameters on 24^3.
- The runner as its own process: it loads neither ``jax`` nor the JAX
  package, and without ``--device`` and without a GPU it raises.
- The scene's own numpy (``run._SceneNumpy``): ``np.asarray`` and
  ``np.array`` of a state tensor read it from any device; nothing outside
  the scene sees it.
"""

import os
import runpy
import subprocess
import sys

import numpy as np
import pytest
import torch

import mantaflow_tpu  # noqa: F401  (the JAX package, the reference)
from mantaflow_tpu_torch.scene import run as srun

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLIP06 = os.path.join(REPO, "scenes", "flip06_obstacle.py")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def arr(x):
    x = x.data if hasattr(x, "data") else x
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _env(**kw):
    env = dict(os.environ, PYTHONPATH=REPO, **kw)
    env.pop("JAX_PLATFORMS", None)
    return env


def test_port_imports_no_jax():
    code = ("import sys, mantaflow_tpu_torch\n"
            "from mantaflow_tpu_torch.scene import run, refgolden\n"
            "bad = [k for k in sys.modules if k == 'jax' or "
            "k.startswith('jax.') or k == 'mantaflow_tpu' or "
            "k.startswith('mantaflow_tpu.')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, env=_env(),
                   cwd=REPO, timeout=300)


def test_runner_process_runs_a_scene_without_jax(tmp_path):
    scene = tmp_path / "scene.py"
    scene.write_text(
        "import sys\n"
        "from mantaflow_tpu import *\n"
        "import mantaflow_tpu.scene.api as api\n"
        "s = Solver(name='s', gridSize=vec3(8, 8, 8))\n"
        "g = s.create(RealGrid)\n"
        "g.setConst(float(sys.argv[1]))\n"
        "assert api.__name__ == 'mantaflow_tpu_torch.scene.api'\n"
        "assert g.data.device.type == 'cpu'\n"
        "assert not any(k == 'jax' or k.startswith('jax.') "
        "for k in sys.modules)\n"
        "print('sum', g.getL1())\n")
    out = subprocess.run(
        [sys.executable, "-m", "mantaflow_tpu_torch.scene.run", "--device",
         "cpu", str(scene), "0.5"], check=True, env=_env(), cwd=REPO,
        timeout=300, capture_output=True, text=True)
    assert "sum 256.0" in out.stdout


def test_runner_raises_without_a_device():
    out = subprocess.run(
        [sys.executable, "-m", "mantaflow_tpu_torch.scene.run", FLIP06, "1",
         "16"], env=_env(CUDA_VISIBLE_DEVICES=""), cwd=REPO, timeout=300,
        capture_output=True, text=True)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr


def test_in_process_run_keeps_the_jax_package(tmp_path):
    """run_scene inside a process that holds the JAX package: the scene
    gets the port, and every mantaflow_tpu entry is put back after."""
    before = {k: v for k, v in sys.modules.items()
              if k == "mantaflow_tpu" or k.startswith("mantaflow_tpu.")}
    scene = tmp_path / "scene.py"
    scene.write_text("from mantaflow_tpu import *\n"
                     "from mantaflow_tpu.models import smoke\n"
                     "s = Solver(name='s', gridSize=vec3(8, 8, 8))\n"
                     "m = s.create(MACGrid)\n")
    g = srun.run_scene(str(scene), [], "cpu")
    assert type(g["m"]).__module__ == "mantaflow_tpu_torch.scene.api"
    assert g["smoke"].__name__ == "mantaflow_tpu_torch.models.smoke"
    after = {k: v for k, v in sys.modules.items()
             if k == "mantaflow_tpu" or k.startswith("mantaflow_tpu.")}
    assert after == before
    assert sys.modules["mantaflow_tpu"].__name__ == "mantaflow_tpu"


_NUMPY_SCENE = (
    "import numpy as np\n"
    "import numpy.linalg as la\n"
    "from numpy import asarray\n"
    "from mantaflow_tpu.core.domain import Domain\n"
    "from mantaflow_tpu.core.shapes import Sphere\n"
    "from mantaflow_tpu.models import smoke\n"
    "dom = Domain(size=(12, 12, 12), dim=3)\n"
    "params = smoke.SmokeParams(window=3, adaptive_dt=True)\n"
    "state = smoke.make_smoke_state(dom, params, source_shape=Sphere("
    "center=(6, 2, 6), radius=2))\n"
    "state = smoke.smoke_run(state, dom, params, 2)\n"
    "d = np.asarray(state.density)\n"
    "v = np.array(state.vel, dtype=np.float64)\n"
    "a = asarray(state.pressure)\n"
    "host = np.arange(4.0)\n"
    "same = np.asarray(host) is host\n"
    "norm = float(la.norm(d))\n")


def test_scene_numpy_reaches_only_the_scene(tmp_path):
    """The scene's own ``import numpy`` gives the runner's numpy, whose
    asarray and array read a torch tensor; numpy and host arrays pass
    through, and numpy is numpy itself for the port and after the run."""
    import mantaflow_tpu_torch.models.smoke as tsmoke
    real = (np.asarray, np.array)
    scene = tmp_path / "scene.py"
    scene.write_text(_NUMPY_SCENE)
    g = srun.run_scene(str(scene), [], "cpu")
    assert isinstance(g["np"], srun._SceneNumpy)
    assert g["np"].float32 is np.float32 and g["la"] is np.linalg
    assert type(g["d"]) is np.ndarray and g["d"].shape == (12, 12, 12)
    assert g["v"].dtype == np.float64 and g["v"].shape == (3, 12, 12, 12)
    assert type(g["a"]) is np.ndarray and g["same"] and g["norm"] > 0
    np.testing.assert_array_equal(
        g["d"], g["state"].density.detach().cpu().numpy())
    assert (np.asarray, np.array) == real
    assert tsmoke.np is np and sys.modules["numpy"] is np
    assert srun._SceneNumpy.asarray(g["d"]) is g["d"]


def _run_jax_scene(path, argv):
    old = sys.argv
    sys.argv = [path] + [str(a) for a in argv]
    try:
        return runpy.run_path(path, run_name="__main__")
    finally:
        sys.argv = old


def test_flip06_obstacle_matches_reference():
    jg = _run_jax_scene(FLIP06, [1, 24])
    tg = srun.run_scene(FLIP06, [1, 24], "cpu")
    for k in ("flags",):
        np.testing.assert_array_equal(arr(tg[k]), arr(jg[k]))
    n = jg["pp"].pySize()
    assert tg["pp"].pySize() == n
    assert tg["mesh"].numTris() == jg["mesh"].numTris()
    assert tg["s"].frame == jg["s"].frame
    assert tg["s"].timestep == pytest.approx(jg["s"].timestep, rel=1e-6)

    def close(a, b, what, atol=None):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        err = float(np.abs(a - b).max())
        if atol is None:
            atol = 2e-4 * max(float(np.abs(b).max()), 1e-30)
        assert err <= atol, (what, err, atol)
    for k in ("phi", "phiParts", "velOld", "fractions", "phiObs"):
        close(arr(tg[k]), arr(jg[k]), k)
    close(arr(tg["pp"].parts.pos)[:n], arr(jg["pp"].parts.pos)[:n], "pos")
    np.testing.assert_array_equal(arr(tg["pp"].parts.flags)[:n],
                                  arr(jg["pp"].parts.flags)[:n])
    # downstream of the solve: both packages run plain CG on this
    # ghost-fluid system with fractions, but their dots sum in another
    # order (XLA's reductions, the CG kernel's plain version), so the two
    # exit at other iterates inside the scene's accuracy (cgAccuracy 1e-3,
    # measured 5.5e-4 on vel): held to that accuracy
    for k in ("vel", "pressure"):
        close(arr(tg[k]), arr(jg[k]), k, atol=1e-3)
    close(arr(tg["pVel"])[:n], arr(jg["pVel"])[:n], "pvel", atol=1e-3)
    close(tg["mesh"].nodes, jg["mesh"].nodes, "mesh nodes")
    np.testing.assert_array_equal(tg["mesh"].tris, jg["mesh"].tris)


def test_smoke_fused_parameters_match_reference():
    """scenes/smoke_fused_128.py's parameters and source at 24^3: the JAX
    package's step (eager: its jit of the 3D window path without Pallas
    takes minutes on the CPU) against the port's smoke_run, 3 steps."""
    from mantaflow_tpu.core.domain import Domain as JDomain
    from mantaflow_tpu.core.shapes import Sphere as JSphere
    from mantaflow_tpu.models import smoke as jsmoke
    from mantaflow_tpu_torch.core.domain import Domain
    from mantaflow_tpu_torch.core.shapes import Sphere
    from mantaflow_tpu_torch.models import smoke as tsmoke
    res = 24
    kw = dict(buoyancy=(0.0, -6e-4, 0.0), vorticity_confinement=0.1,
              window=3, adaptive_dt=True, cfl=3.0, dt_max=2.0)
    src = dict(center=(res / 2, res * 0.1, res / 2), radius=res * 0.14)
    jdom, dom = JDomain(size=(res,) * 3, dim=3), Domain(size=(res,) * 3,
                                                         dim=3)
    jp, tp = jsmoke.SmokeParams(**kw), tsmoke.SmokeParams(**kw)
    jst = jsmoke.make_smoke_state(jdom, jp, source_shape=JSphere(**src))
    for _ in range(3):
        jst = jsmoke.smoke_step(jst, jdom, jp)
    tst = tsmoke.make_smoke_state(dom, tp, source_shape=Sphere(**src),
                                  device="cpu")
    tst = tsmoke.smoke_run(tst, dom, tp, 3)
    np.testing.assert_array_equal(arr(tst.flags), np.asarray(jst.flags))
    for k in ("vel", "density", "pressure"):
        a, b = arr(getattr(tst, k)), np.asarray(getattr(jst, k))
        scale = max(float(np.abs(b).max()), 1.0)
        assert float(np.abs(a - b).max()) <= 2e-4 * scale, k
    assert float(tst.ts.dt) == pytest.approx(float(jst.ts.dt), rel=1e-5)
