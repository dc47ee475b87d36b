"""``scenes/zflip.py`` on the port's CPU path against the JAX package's
run of the same file and argv (``tests/test_torch_zflip_*.py``).

``zflip.py`` keeps its state in ``run_zflip``'s locals, so each run's
snapshot is taken from them as the function returns
(``scene/snapshot.py:returned_locals``, ``snapshot(..., members=True)``:
the grids, the particles, the obstacle's, the mesh generator's and
CORRECT19's members, the per-frame ``volumes``), together with the
meshes the run wrote (``snapshot.meshes``). ``pair(argv)`` runs both
packages, each in its own directory, and holds the port to the JAX
package under ``snapshot.compare``'s rules (flags, particle flags, counts
and volumes exact; a levelset within 2e-4 of its scale; fields within the
solves' accuracy 1e-3 x max(1, scale)) and the printed ``it N:`` and
``zflip method=`` lines equal.
"""

import contextlib
import io
import os
import re
import runpy
import sys

import pytest

import mantaflow_tpu  # noqa: F401  (the JAX package, the reference)
from mantaflow_tpu_torch.scene import run as srun
from mantaflow_tpu_torch.scene import snapshot as snp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZFLIP = os.path.join(REPO, "scenes", "zflip.py")
sys.path.insert(0, os.path.join(REPO, "tools"))
import scene_cg_sensitivity as sens  # noqa: E402

#: the accuracy of every solve of zflip.py (solvePressure's default and
#: CORRECT19's solvePressureSystem)
ACC = 1e-3
#: the lines of a run that the two packages must print alike
LINE = re.compile(r"^(it \d+:|zflip method=)")
METHODS = {0: "flip", 1: "fixed_vol", 2: "correct19"}
OBSTACLES = {0: "none", 1: "moving", 2: "static"}


def case_id(argv):
    m, frames, res, obs, mesh = (int(a) for a in argv)
    return (f"{METHODS[m]}-{OBSTACLES[obs]}-{'mesh' if mesh else 'nomesh'}"
            f"-{res}-{frames}")


def run(package, argv, out_dir, monkeypatch):
    """One run of zflip.py with ``argv`` in ``out_dir`` through the JAX
    package (``"jax"``) or the port's runner on the CPU: its snapshot
    (locals and meshes) and its printed lines."""
    os.makedirs(out_dir, exist_ok=True)
    monkeypatch.chdir(out_dir)
    for name in ("mantaflow_tpu", "mantaflow_tpu_torch"):
        sens.reset_statics(name)
    buf = io.StringIO()
    with snp.returned_locals("run_zflip", ZFLIP) as loc, \
            contextlib.redirect_stdout(buf):
        if package == "jax":
            old = sys.argv
            sys.argv = [ZFLIP] + [str(a) for a in argv]
            try:
                runpy.run_path(ZFLIP, run_name="__main__")
            finally:
                sys.argv = old
        else:
            srun.run_scene(ZFLIP, argv, "cpu")
    snap = snp.snapshot(loc, members=True)
    snap.update(snp.meshes(str(out_dir)))
    lines = [ln for ln in buf.getvalue().splitlines() if LINE.match(ln)]
    return snap, lines


def pair(argv, tmp_path, monkeypatch, known=None):
    """The port's run against the JAX package's: the comparison. ``known``
    holds the differences kept in ROADMAP C at what was measured; each must
    still show."""
    jsnap, jlines = run("jax", argv, tmp_path / "jax", monkeypatch)
    tsnap, tlines = run("port", argv, tmp_path / "port", monkeypatch)
    assert tlines == jlines and tlines[-1].startswith("zflip method="), (
        tlines, jlines)
    frames, mesh = int(argv[1]), int(argv[4])
    assert len(tsnap["volumes"][1]) == frames
    assert sum(k.endswith(".bobj.gz.count") for k in tsnap) == \
        (frames if mesh else 0)
    cmp_ = snp.compare(tsnap, jsnap, ACC, limits=known)
    bad = snp.failures(cmp_)
    assert not bad, f"zflip.py {' '.join(map(str, argv))}: {bad}"
    for k in known or {}:
        assert cmp_[k][0] > 0, f"{k} no longer parts"
    return cmp_


def params(cases, slow=False):
    return [pytest.param(list(c), id=case_id(c),
                         marks=[pytest.mark.slow] if slow else [])
            for c in cases]
