#!/usr/bin/env python3
"""How far a scene's final state moves when its CG solves stop at another
iterate within their accuracy.

    python3 tools/scene_cg_sensitivity.py [--factor 0.7] [--steps N]
                                          [--env NAME=VALUE ...]
                                          [--locals FUNCTION] SCENE [ARGS]

Runs ``scenes/SCENE`` twice, unedited, on the port's CPU path through the
scene runner (``scene/run.py:run_scene``, one torch thread), the second
time with the accuracy of every linear solve times ``--factor``
(``ops/pressure.py:solve_pressure_system``, which takes solvePressure,
solvePressureSystem, cgSolveDiffusion and the PD guiding's projections,
and ``ops/waves.py:cg_solve_wave_eq``). ``--steps`` compares after that
many ``Solver.step`` calls. ``--locals run_zflip`` compares the locals of
that function of the scene as it returns (with ``--steps``, as it calls
that step), with the meshes the run wrote
(``zflip.py`` keeps its state there; ``snapshot(..., members=True)``).
Prints as one JSON object each field's max abs
difference between the two runs (the keys of ``scene/snapshot.py``), the
fields that do not move left out. A field that moves by about as much as
it parts between the card and the CPU, or between the port and the JAX
package, parts through the CG's exit iterate: K2, the plain CG and XLA's
reductions sum their dots in other orders.

``stop_after`` and ``reset_statics`` serve either scene API (the port's or
the JAX package's, by the package's name): the scene tests use them for
both packages' runs.
"""

import argparse
import contextlib
import importlib
import inspect
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


class Stopped(Exception):
    """Raised by ``stop_after``'s Solver.step; carries the scene's globals
    and the locals of the function that called the step (``run_zflip``'s,
    where the scene keeps its state in a function)."""

    def __init__(self, scene_globals, caller_locals=None):
        super().__init__("stopped")
        self.scene_globals = scene_globals
        self.caller_locals = caller_locals or {}


@contextlib.contextmanager
def stop_after(api, steps):
    """``api.Solver.step`` raises ``Stopped`` with the scene's globals after
    ``steps`` calls (None: it runs as it is)."""
    orig = api.Solver.step
    count = [0]

    def step(self, frame=-1):
        orig(self, frame)
        count[0] += 1
        if count[0] == steps:
            caller = sys._getframe(1)
            raise Stopped(caller.f_globals, dict(caller.f_locals))
    if steps is not None:
        api.Solver.step = step
    try:
        yield
    finally:
        api.Solver.step = orig


def run_stopped(api, steps, run):
    """run() under ``stop_after(api, steps)``: the scene's globals."""
    with stop_after(api, steps):
        try:
            return run()
        except Stopped as s:
            return s.scene_globals


def reset_statics(package="mantaflow_tpu_torch"):
    """A fresh process's statics in a scene API: the tracer stream and the
    moving obstacles' flag bits."""
    importlib.import_module(
        f"{package}.scene.vortex_api").reset_process_statics()
    importlib.import_module(
        f"{package}.ops.obstacles").MovingObstacleState._next_id_bit = 10


@contextlib.contextmanager
def _scaled_accuracy(factor):
    """Every solve's accuracy times ``factor`` for the duration."""
    from mantaflow_tpu_torch.ops import pressure as prs
    from mantaflow_tpu_torch.ops import waves as wav
    origs = (prs.solve_pressure_system, wav.cg_solve_wave_eq)

    def scaled(fn):
        sig = inspect.signature(fn)

        def run(*a, **kw):
            b = sig.bind(*a, **kw)
            b.apply_defaults()
            b.arguments["cg_accuracy"] *= factor
            return fn(*b.args, **b.kwargs)
        return run
    prs.solve_pressure_system, wav.cg_solve_wave_eq = map(scaled, origs)
    try:
        yield
    finally:
        prs.solve_pressure_system, wav.cg_solve_wave_eq = origs


def run_snapshot(scene, argv, factor=1.0, steps=None, env=None,
                 out_dir=".", locals_of=None):
    """The scene's snapshot after a run on the CPU in ``out_dir`` (which is
    also its MANTA_OUT), every solve's accuracy times ``factor``; of the
    locals of the scene's function ``locals_of`` and the meshes, if
    given."""
    import torch
    from mantaflow_tpu_torch.scene import api as sapi
    from mantaflow_tpu_torch.scene import run as srun
    from mantaflow_tpu_torch.scene import snapshot as snp
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    old_env = {k: os.environ.get(k) for k in [*(env or {}), "MANTA_OUT"]}
    os.environ.update(env or {}, MANTA_OUT=os.path.abspath(out_dir))
    cwd = os.getcwd()
    os.makedirs(out_dir, exist_ok=True)
    os.chdir(out_dir)
    reset_statics()
    path = os.path.join(REPO, "scenes", scene)
    try:
        with _scaled_accuracy(factor), open(os.devnull, "w") as null, \
                contextlib.redirect_stdout(null), \
                snp.returned_locals(locals_of or "", path) as loc, \
                stop_after(sapi, steps):
            try:
                g = srun.run_scene(path, list(argv), "cpu")
            except Stopped as s:
                # stopped inside the function: its locals at that step
                g, loc = s.scene_globals, s.caller_locals
        if locals_of:
            return {**snp.snapshot(loc, members=True),
                    **snp.meshes(os.getcwd())}
        return snp.snapshot(g)
    finally:
        os.chdir(cwd)
        torch.set_num_threads(threads)
        for k, v in old_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def sensitivity(scene, argv, factor=0.7, steps=None, env=None, out_dir=".",
                locals_of=None):
    """``{field: max abs difference}`` between the run as it is and the run
    with every solve's accuracy times ``factor``, the fields that move."""
    from mantaflow_tpu_torch.scene import snapshot as snp
    a = run_snapshot(scene, argv, 1.0, steps, env,
                     os.path.join(out_dir, "as_is"), locals_of)
    b = run_snapshot(scene, argv, factor, steps, env,
                     os.path.join(out_dir, "scaled"), locals_of)
    return {k: d for k, (d, _) in snp.compare(a, b, 0.0).items() if d > 0}


def main():
    sys.path.insert(0, REPO)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--factor", type=float, default=0.7)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--env", action="append", default=[])
    ap.add_argument("--locals", default=None)
    ap.add_argument("--out", default=os.path.join(REPO, "build",
                                                  "cg_sensitivity"))
    ap.add_argument("scene")
    ap.add_argument("args", nargs="*")
    a = ap.parse_args()
    env = dict(e.split("=", 1) for e in a.env)
    print(json.dumps({"scene": a.scene, "argv": a.args, "env": env,
                      "factor": a.factor, "steps": a.steps,
                      "max_abs_diff": sensitivity(a.scene, a.args, a.factor,
                                                  a.steps, env, a.out,
                                                  a.locals)}))


if __name__ == "__main__":
    main()
