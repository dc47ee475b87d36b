"""The scenes of ``scenes/`` on the port's CPU path against the JAX
package's run of the same file (``tests/test_torch_scenes_*.py``).

``SMOKE`` and ``LIQUID`` list the scenes of ``scenes/`` but five, which
are held elsewhere: ``flip06_obstacle.py``, ``smoke_fused_128.py`` and
``mlflip.py`` in ``tests/test_torch_scene_run.py`` and
``tests/test_torch_ml_examples.py``, ``zflip.py`` and ``run.py`` (which
drives it) in ``tests/test_torch_zflip_*.py`` (``tests/torch_zflip_pairs.py``);
each with the argv of the JAX package's ``tests/test_scenes_run.py``
(``FAST_SCENES``; ``FRAMES=2`` or the whole file where it has none), the
accuracy of its solves, the end of its last printed line, and the
differences kept in ROADMAP C.

``pair(scene)`` runs the JAX package's scene and the port's (``run_scene``
on the CPU), each in its own directory with ``MANTA_OUT`` there and the
process statics reset, and compares their snapshots
(``mantaflow_tpu_torch/scene/snapshot.py``): flags, counts, particle flags
and other integer data exact; a levelset within 2e-4 of its scale; every
other field within the scene's CG accuracy x max(1, scale), since all of
them lie downstream of a solve (2e-4 where the scene solves nothing).
"""

import os
import re
import runpy
import subprocess
import sys

import pytest

import mantaflow_tpu  # noqa: F401  (the JAX package, the reference)
from mantaflow_tpu_torch.scene import run as srun
from mantaflow_tpu_torch.scene import snapshot as snp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES_DIR = os.path.join(REPO, "scenes")
sys.path.insert(0, os.path.join(REPO, "tools"))
import scene_cg_sensitivity as sens  # noqa: E402


class Scene:
    def __init__(self, file, argv=(), env=None, acc=1e-3, last=r".",
                 known=None, cut=None, slow=False, slow_process=False):
        self.file, self.argv, self.env = file, list(argv), dict(env or {})
        #: the scene's CG accuracy (None: it solves nothing)
        self.acc = acc
        #: a pattern the last printed line of a run must match
        self.last = last
        #: differences kept in ROADMAP C: field -> the JAX-vs-port
        #: difference measured on the CPU, held as that field's limit
        self.known = dict(known or {})
        #: compare after this many Solver.step calls
        self.cut = cut
        #: the JAX pair takes over 40 s on one core
        self.slow = slow
        #: the run as its own process takes over 40 s on one core
        self.slow_process = slow_process


_SMOKE = [
    Scene("simpleplume.py", ["4"], last=r"^simpleplume done: density max"),
    Scene("plume_adaptDt.py", ["3"], last=r"^plume_adaptDt done:"),
    # 400 steps: the plume parts through the CG's exit iterate (ROADMAP C)
    Scene("plume_2d.py", last=r"^Frame 399$",
          known={"density": 0.0109, "pressure": 0.0409, "vel": 0.697}),
    # its solves to 1e-4 exit far from the smooth modes' solution: the
    # port against itself with the accuracy x 0.95 parts by 0.36 in vel
    Scene("karman.py", env={"FRAMES": "2"}, acc=1e-4,
          last=r"^(Frame \d+,|  maxAbsVel)",
          known={"pressure": 3.6e-4, "vel": 7.0e-4}),
    Scene("lidDrivenCavity.py", ["6"], last=r"^lidDrivenCavity: done"),
    Scene("fire.py", ["4"], last=r"^fire: done, flame max"),
    Scene("turbulence.py", ["3"], last=r"^turbulence: done",
          known={"strain": 1.75e-3, "vel": 1.77e-3}, slow=True),
    Scene("waveletTurbulence.py", env={"FRAMES": "2"}, acc=1e-2,
          last=r"^(Frame \d+,|  lowres dens sum)"),
    Scene("waveletTurbulenceObs.py", ["2"], acc=1e-2,
          last=r"^waveletTurbulenceObs done:"),
    Scene("waveEquation.py", ["8"], acc=1e-5,
          last=r"^waveEquation done: mass"),
    # particles resting on the cell face y = 5 part by 2e-5 and are
    # indexed in the cells either side (ROADMAP C)
    Scene("benchmark_wave.py", ["0.1"], last=r"^benchmark_wave: \d+ sim steps",
          known={"gIdx": 189}),
    Scene("movingObstacle.py", ["6"], last=r"^movingObstacle: done"),
    Scene("meshload.py", ["3"], last=r"^meshload: done"),
    Scene("guiding_2d.py", ["3"], last=r"^guiding_2d: done"),
    Scene("numpy_array_simple.py", ["4"], last=r"^numpy_array_simple done:"),
    Scene("numpy_write_read.py", ["2"], last=r"^numpy_write_read done"),
]

_LIQUID = [
    Scene("flip01_simple.py", env={"FRAMES": "2"},
          last=r"^(Frame \d+,|  particles=)"),
    Scene("flip02_surface.py", ["4"], last=r"^flip02 done: \d+ particles",
          slow=True),
    # 6 of its 120 frames; particles reseeded in other cells once a
    # near-zero phi flips sign through the CG's exit iterate (ROADMAP C)
    Scene("flip03_levelset.py", cut=6, last=r"^Frame \d+, t",
          known={"gpi": 34, "pVel": 1.19, "phi": 9.3e-3, "phiParts": 0.323,
                 "pp.flags": 1.08e9, "pp.pos": 47.0, "pressure": 2.6e-3,
                 "tmpVec3": 3.0, "vel": 5.8e-3, "velOld": 0.092},
          slow=True, slow_process=True),
    Scene("flip04_adaptDt.py", ["2", "32"],
          last=r"^flip04 done: \d+ particles", slow=True),
    Scene("flip05_nbflip.py", ["2", "32"],
          last=r"^flip05 done: \d+ particles", slow=True),
    Scene("freesurface.py", env={"FRAMES": "2"}, acc=5e-4,
          last=r"^(Frame \d+,|  fluid cells=)"),
    Scene("surfaceTension.py", ["3"], acc=1e-2,
          last=r"^surfaceTension: done, \d+ mesh tris"),
    Scene("apic01_simple.py", ["6"], last=r"^apic01 done: \d+ particles"),
    Scene("idp_apic01_simple.py", ["5"], last=r"^idp_apic01: done"),
    Scene("idp_apic02_3d.py", ["2", "32"],
          last=r"^idp_apic02 done: \d+ particles"),
    Scene("surfaceTurbulence.py", ["2"],
          last=r"^surfaceTurbulence done: \d+ coarse", slow=True),
    Scene("benchmark_dam.py", ["10", "0.1"],
          last=r"^benchmark_dam: \d+ sim steps"),
]

SMOKE = {s.file: s for s in _SMOKE}
LIQUID = {s.file: s for s in _LIQUID}


def params(table):
    """pytest params of a table, the slow pairs marked."""
    return [pytest.param(s, id=s.file[:-3],
                         marks=[pytest.mark.slow] if s.slow else [])
            for s in table.values()]


def process_params(table):
    return [pytest.param(s, id=s.file[:-3],
                         marks=[pytest.mark.slow] if s.slow_process else [])
            for s in table.values()]


def run_jax_scene(scene, out_dir, monkeypatch):
    from mantaflow_tpu.scene import api as japi
    path = os.path.join(SCENES_DIR, scene.file)
    _enter(scene, out_dir, monkeypatch)

    def run():
        old = sys.argv
        sys.argv = [path] + scene.argv
        try:
            return runpy.run_path(path, run_name="__main__")
        finally:
            sys.argv = old
    return sens.run_stopped(japi, scene.cut, run)


def run_port_scene(scene, out_dir, monkeypatch):
    from mantaflow_tpu_torch.scene import api as tapi
    _enter(scene, out_dir, monkeypatch)
    return sens.run_stopped(tapi, scene.cut, lambda: srun.run_scene(
        os.path.join(SCENES_DIR, scene.file), scene.argv, "cpu"))


def _enter(scene, out_dir, monkeypatch):
    os.makedirs(out_dir, exist_ok=True)
    monkeypatch.chdir(out_dir)
    monkeypatch.setenv("MANTA_OUT", str(out_dir))
    for k, v in scene.env.items():
        monkeypatch.setenv(k, v)
    for package in ("mantaflow_tpu", "mantaflow_tpu_torch"):
        sens.reset_statics(package)


def held(scene, tsnap, jsnap):
    """The port's snapshot against the JAX package's: the beyond-limit
    entries (empty when the pair holds) and the comparison."""
    tol = scene.acc if scene.acc is not None else 2e-4
    cmp_ = snp.compare(tsnap, jsnap, tol, limits=scene.known)
    return snp.failures(cmp_), cmp_


def pair(scene, tmp_path, monkeypatch):
    """Run the scene through both packages and hold the port to the JAX
    package's run; every known difference must still show (a field that
    no longer parts leaves ROADMAP C)."""
    jg = run_jax_scene(scene, tmp_path / "jax", monkeypatch)
    jsnap = snp.snapshot(jg)
    del jg
    tg = run_port_scene(scene, tmp_path / "port", monkeypatch)
    tsnap = snp.snapshot(tg)
    del tg
    bad, cmp_ = held(scene, tsnap, jsnap)
    assert not bad, f"{scene.file}: {bad}"
    for k in scene.known:
        assert cmp_[k][0] > 0, f"{scene.file}: {k} no longer parts"
    return cmp_


def run_process(scene, out_dir):
    """The scene through ``python -m mantaflow_tpu_torch.scene.run --device
    cpu`` as its own process (one thread) in ``out_dir``, its
    ``MANTA_OUT``: rc 0 and the last line's pattern."""
    os.makedirs(out_dir, exist_ok=True)
    e = dict(os.environ, PYTHONPATH=REPO, MANTA_OUT=str(out_dir),
             OMP_NUM_THREADS="1", **scene.env)
    e.pop("JAX_PLATFORMS", None)
    r = subprocess.run(
        [sys.executable, "-m", "mantaflow_tpu_torch.scene.run", "--device",
         "cpu", os.path.join(SCENES_DIR, scene.file)] + scene.argv,
        cwd=out_dir, env=e, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, (
        f"{scene.file}:\n{r.stdout[-2000:]}\n{r.stderr[-3000:]}")
    lines = r.stdout.strip().splitlines()
    assert lines and re.search(scene.last, lines[-1]), (
        f"{scene.file}: last line {lines[-1:]!r}")


def cg_exit_moves(scene, argv, tmp_path, env=None, factor=0.7):
    """The port against itself with every solve's accuracy times
    ``factor`` (``tools/scene_cg_sensitivity.py``): the fields that move,
    and by how much."""
    return sens.sensitivity(scene, argv, factor, env=env,
                            out_dir=str(tmp_path))
