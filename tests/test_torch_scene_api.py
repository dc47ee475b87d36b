"""The port's scene API (``mantaflow_tpu_torch/scene/``) against the JAX
package's, function by function.

Each case is one scenario written once against a package ``m`` (the JAX
package, or the port on the CPU): the same seeded numpy inputs go in by
``from_numpy``, the case returns its outputs, and the two packages' outputs
are compared. Tolerances are the reference's own: integers, flags and
counts exact; elementwise work 1e-6 of max(1, |value|); 2e-6 where a
square root enters an SDF (XLA's float32 ``sqrt`` on the CPU is not
correctly rounded, ROADMAP C) or a reduction sums in another order; 1e-5
through the advection (as tests/test_torch_advection_exact.py) and where
``index_add_`` sums particles in another order; outputs of a CG solve 2e-4
of their scale.
A last test checks that every function and class of the star surface is
called by some case.
"""

import inspect
import os
import re
import sys
import types

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import mantaflow_tpu as J  # noqa: E402
import mantaflow_tpu_torch as T  # noqa: E402
from torch_scene_cases import (CASES, F32, arr, base, compare,  # noqa: E402
                               solver_of)

#: the cases of tests/test_torch_scene_api_parts.py (particles and the
#: breadth plugins), in a file of their own so that --dist loadfile spreads
#: the two halves
PARTS = {
    "particles", "pdata_ops", "flip_resampling", "whitewater",
    "surface_turbulence", "apic", "zflip", "turbulence_particles",
    "vortex_systems", "guiding_and_idp", "turbulence_and_waves",
    "improved_levelset"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kind", ["real", "mac", "vec3"])
def test_advect_semi_lagrange_matches_reference(kind):
    outs = []
    for m in (J, T):
        g = base(m)
        grid = {"real": g["dens"], "mac": g["vel"], "vec3": g["v3"]}[kind]
        g["s"].timestep = 0.8
        res = {}
        for order, clamp in ((1, 2), (2, 1), (2, 2)):
            c = g["s"].create(type(grid))
            c.copyFrom(grid)
            m.advectSemiLagrange(flags=g["flags"], vel=g["vel"], grid=c,
                                 order=order, clampMode=clamp)
            res[f"{order}{clamp}"] = arr(c)
        c.copyFrom(grid)
        m.advectSemiLagrange(flags=g["flags"], vel=g["vel"], grid=c,
                             order=2, strength=0.8, orderSpace=2,
                             orderTrace=2)
        res["cubic"] = arr(c)
        outs.append(res)
    # the advection tests' tolerance (tests/test_torch_advection_exact.py)
    compare(outs[0], outs[1], 1e-5)


@pytest.mark.parametrize("name", sorted(set(CASES) - PARTS))
def test_scene_api_matches_reference(name, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    fn, tol = CASES[name]
    kw = {"tmp_path": tmp_path} if "tmp_path" in \
        inspect.signature(fn).parameters else {}
    J.setDebugLevel(1)
    T.setDebugLevel(1)
    compare(fn(J, **kw), fn(T, **kw), tol, name)


def test_star_surface_matches_reference():
    """``from mantaflow_tpu_torch import *`` has the JAX package's names,
    but for the modules each imports (jax, jnp, partial; torch) and the
    port's device resolution."""
    ns_j, ns_t = {}, {}
    exec("from mantaflow_tpu import *", ns_j)
    exec("from mantaflow_tpu_torch import *", ns_t)

    def names(ns):
        # a package's submodules are attributes once imported anywhere
        return {k for k, v in ns.items() if not k.startswith("__")
                and not isinstance(v, types.ModuleType)}
    a = names(ns_j) - {"partial"}
    b = names(ns_t) - {"resolve_device", "default_device"}
    assert a == b
    assert T.VecGrid is T.Vec3Grid and T.__version__ == J.__version__
    assert T.resolve_device("cpu").type == "cpu"


def test_every_api_name_has_a_case():
    """Every function and class of the star surface is called by a case
    (tests/torch_scene_cases.py, this file) or, for ``save``/``load``/checkpoints and ``projectPpmFull``,
    of tests/test_torch_scene_io.py; the runner's own in
    tests/test_torch_scene_run.py)."""
    here = os.path.dirname(__file__)
    text = ""
    for f in ("torch_scene_cases.py", "test_torch_scene_api.py",
              "test_torch_scene_io.py"):
        with open(os.path.join(here, f)) as fh:
            text += fh.read()
    ns = {}
    exec("from mantaflow_tpu_torch import *", ns)
    missing = []
    for k, v in ns.items():
        if k.startswith("_") or not callable(v):
            continue
        mod = getattr(v, "__module__", "") or ""
        if not mod.startswith("mantaflow_tpu_torch.scene"):
            continue
        if not re.search(r"\bm\." + re.escape(k) + r"\b", text) and \
                not re.search(r"\bT\." + re.escape(k) + r"\b", text):
            missing.append(k)
    assert not missing, missing


def test_left_out_goldens_track_reference():
    """The golden scenes the port leaves out (refgolden.LEFT_OUT): the
    falling drop tracks the JAX package to 1e-5 over its first 4 frames,
    before a clamp decision flips (the FLIP dam's transfers and solve are
    held by the ``particles`` and ``pressure_solves`` cases)."""
    from mantaflow_tpu_torch.scene import refgolden
    assert set(refgolden.LEFT_OUT) == {"test_2045_fallingDrop",
                                       "test_9070_fliptight"}

    def drop(m, frames=4):
        s = solver_of(m)(name="main", gridSize=m.vec3(45, 45, 45), dim=3)
        s.timestep = 0.6
        f, vel, p = (s.create(c) for c in (m.FlagGrid, m.MACGrid,
                                           m.RealGrid))
        f.initDomain(boundaryWidth=0)
        z, y, x = np.meshgrid(*[np.arange(45, dtype=F32) + 0.5] * 3,
                              indexing="ij")
        lo, hi = np.float32(18.0), np.float32(27.0)
        d = np.maximum.reduce([lo - x, x - hi, np.float32(33.75) - y,
                               y - np.float32(42.75), lo - z, z - hi])
        phi = s.create(m.LevelsetGrid)
        phi.from_numpy(d.astype(F32))
        f.updateFromLevelset(phi)
        for _ in range(frames):
            phi.reinitMarching(flags=f, velTransport=vel)
            m.advectSemiLagrange(flags=f, vel=vel, grid=phi, order=2,
                                 clampMode=1)
            f.updateFromLevelset(phi)
            m.advectSemiLagrange(flags=f, vel=vel, grid=vel, order=2,
                                 clampMode=1)
            m.addGravity(flags=f, vel=vel, gravity=m.vec3(0, -0.0125, 0))
            m.setWallBcs(flags=f, vel=vel)
            m.solvePressure(flags=f, vel=vel, pressure=p, cgMaxIterFac=0.5,
                            cgAccuracy=5e-5, phi=phi)
            m.setWallBcs(flags=f, vel=vel)
            s.step()
        return {"phi": arr(phi), "vel": arr(vel), "flags": arr(f)}

    compare(drop(J), drop(T), 1e-5, "falling_drop")
