"""The scene runner's stand-ins for ``scenes/zflip.py`` and
``scenes/run.py`` (``mantaflow_tpu_torch/scene/run.py``):

- a scene's ``import jax.numpy`` gives the runner's ``_SceneJnp`` (three
  names on torch tensors), even in a process that holds the real JAX
  (pytest's does), and a name it lacks raises an ``AttributeError`` that
  names it; a runner process loads nothing named ``jax``;
- a scene's ``sys.executable`` is the port's launcher, so ``scenes/run.py
  <tmp> 2 12 1 1``, unedited, starts its three ``zflip.py`` children
  through the runner on the runner's device; a CUDA launcher without a GPU
  raises; nothing is written under ``scenes/``;
- a scene's ``sys.exit(0)`` ends it normally, another code is raised;
- the launcher is written only when a scene reads ``sys.executable``;
- ``tools/scene_cg_sensitivity.py --steps N --locals run_zflip`` reads
  ``run_zflip``'s locals at that step.
"""

import contextlib
import io
import os
import subprocess
import sys

import pytest
import torch

from mantaflow_tpu_torch.scene import run as srun

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = os.path.join(REPO, "scenes")
ZFLIP = os.path.join(SCENES, "zflip.py")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _env():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    return env


def _tree(path):
    return {(os.path.relpath(os.path.join(d, f), path),
             os.path.getmtime(os.path.join(d, f)))
            for d, _, files in os.walk(path) for f in files}


def test_scene_gets_the_jnp_stand_in_with_jax_loaded(tmp_path):
    assert "jax" in sys.modules  # tests/conftest.py loads the real one
    scene = tmp_path / "scene.py"
    scene.write_text(
        "import jax.numpy as jnp\n"
        "from jax import numpy as jnp2\n"
        "from jax.numpy import where\n"
        "import numpy as np\n"
        "m = jnp.asarray(np.array([True, False, True]))\n"
        "out = jnp.where(m, jnp.int32(7), jnp.asarray(np.zeros(3, np.int32)))\n"
        "try:\n"
        "    jnp.zeros(3)\n"
        "except AttributeError as e:\n"
        "    missing = str(e)\n")
    g = srun.run_scene(str(scene), (), "cpu")
    assert isinstance(g["jnp"], srun._SceneJnp)
    assert g["jnp2"] is g["jnp"] and g["where"] == g["jnp"].where
    assert isinstance(g["m"], torch.Tensor) and g["m"].dtype == torch.bool
    assert g["out"].tolist() == [7, 0, 7] and g["out"].dtype == torch.int32
    assert "'zeros'" in g["missing"]
    with pytest.raises(AttributeError, match="'lax'"):
        srun._SceneJax(torch.device("cpu")).lax


def test_zflip_stamps_through_the_stand_in(tmp_path, monkeypatch):
    """zflip.py's obstacle stamp (``scenes/zflip.py:107-111``) calls the
    runner's ``where`` with torch tensors, in a process that holds JAX."""
    calls = []
    where = srun._SceneJnp.where

    def recorded(cond, x, y):
        calls.append((type(cond), type(x), type(y)))
        return where(cond, x, y)
    monkeypatch.setattr(srun._SceneJnp, "where", staticmethod(recorded))
    monkeypatch.chdir(tmp_path)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        srun.run_scene(ZFLIP, ["0", "2", "12", "2", "0"], "cpu")
    assert "zflip method=0 final occupied=" in out.getvalue()
    assert calls and all(c == (torch.Tensor, torch.Tensor, torch.Tensor)
                         for c in calls), calls[:3]


def test_runner_process_loads_no_jax(tmp_path):
    """zflip.py as its own runner process: the runner's ``main`` raises if
    anything named ``jax`` is in ``sys.modules`` after the run."""
    r = subprocess.run(
        [sys.executable, "-m", "mantaflow_tpu_torch.scene.run", "--device",
         "cpu", ZFLIP, "2", "2", "12", "2", "0"], cwd=tmp_path, env=_env(),
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-1].startswith(
        "zflip method=2 final occupied=")


def test_run_py_children_run_through_the_runner(tmp_path, monkeypatch):
    """``scenes/run.py <tmp> 2 12 1 1`` unedited on the CPU: three children,
    each started as ``[sys.executable, zflip.py, ...]`` and so through the
    launcher, each leaving a log that ends in ``zflip method=`` and two
    meshes; nothing under ``scenes/`` changes."""
    before = _tree(SCENES)
    out_root = tmp_path / "out"
    monkeypatch.chdir(tmp_path)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        srun.run_scene(os.path.join(SCENES, "run.py"),
                       [str(out_root), "2", "12", "1", "1"], "cpu")
    text = out.getvalue()
    assert "run.py is done" in text
    launcher = srun.launcher(torch.device("cpu"))
    starts = [ln for ln in text.splitlines() if ln.startswith(launcher)]
    assert len(starts) == 3 and all(ZFLIP in ln for ln in starts), text
    for m, name in ((0, "flip"), (1, "fixed_vol"), (2, "correct19")):
        d = out_root / f"{m}_{name}"
        log = (d / "_log.txt").read_text().strip().splitlines()
        assert log[-1].startswith(f"zflip method={m} final occupied="), log
        assert len(list(d.glob("surface_*.bobj.gz"))) == 2
    assert _tree(SCENES) == before


def test_cuda_launcher_raises_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the launcher runs on it")
    launcher = srun.launcher(torch.device("cuda"))
    with open(launcher) as f:
        assert "--device" not in f.read()
    r = subprocess.run([launcher, ZFLIP, "0", "1", "12", "0", "0"],
                       cwd=tmp_path, env=_env(), capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0 and "no CUDA device" in r.stderr, r.stderr[-2000:]
    assert "zflip method=" not in r.stdout


def test_scene_exit_codes(tmp_path):
    scene = tmp_path / "exits.py"
    scene.write_text("import sys\nA = 1\nsys.exit(int(sys.argv[1]))\n")
    assert srun.run_scene(str(scene), ["0"], "cpu")["A"] == 1
    with pytest.raises(SystemExit) as e:
        srun.run_scene(str(scene), ["3"], "cpu")
    assert e.value.code == 3


def test_launcher_is_made_on_the_first_read(tmp_path, monkeypatch):
    made = []

    def launcher(device):
        made.append(device)
        return "/bin/launcher"
    monkeypatch.setattr(srun, "launcher", launcher)
    scene = tmp_path / "argv.py"
    scene.write_text("import sys\nA = len(sys.argv)\n")
    assert srun.run_scene(str(scene), ["x"], "cpu")["A"] == 2
    assert made == []
    scene.write_text("import sys\nA = sys.executable\nB = sys.executable\n")
    g = srun.run_scene(str(scene), (), "cpu")
    assert g["A"] == g["B"] == "/bin/launcher"
    assert made == [torch.device("cpu")]


def test_sensitivity_tool_reads_run_zflip_locals_at_a_step(tmp_path):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import scene_cg_sensitivity as sens
    finally:
        sys.path.remove(os.path.join(REPO, "tools"))
    snap = sens.run_snapshot("zflip.py", ["0", "3", "12", "0", "0"],
                             steps=2, out_dir=str(tmp_path),
                             locals_of="run_zflip")
    assert int(snap["n0"][1]) == int(snap["pp.count"][1]) > 0
    assert snap["flags"][0] == "exact" and "phi" in snap
