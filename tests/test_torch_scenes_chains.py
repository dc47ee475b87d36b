"""Every scene of ``tests/torch_scene_pairs.py`` through the port's runner
as its own process (``python -m mantaflow_tpu_torch.scene.run --device
cpu``, the argv of the JAX package's ``tests/test_scenes_run.py``): rc 0
and the scene's last line. Then the two chains, each in one
``MANTA_OUT``:

- ``flip02_surface.py 2`` with ``MANTA_SAVE_PARTS=1`` writes its particles,
  ``flip03_gen.py 2`` meshes them at twice the resolution (the JAX test's
  own check, ``tests/test_scenes_run.py:69-85``);
- ``guiding_3d01_low.py 2`` writes the low-resolution velocities that
  ``guiding_3d02_high.py 1`` loads and guides towards;

as processes, and in process against the JAX package's run of the same
chain (each member's final state by ``torch_scene_pairs``' rules)."""

import os

import pytest
import torch

from mantaflow_tpu_torch.scene import snapshot as snp
from torch_scene_pairs import (LIQUID, SMOKE, Scene, held, process_params,
                               run_jax_scene, run_port_scene, run_process)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("scene", process_params({**SMOKE, **LIQUID}))
def test_scene_runs_as_process(scene, tmp_path):
    run_process(scene, tmp_path)


FLIP02 = Scene("flip02_surface.py", ["2"], env={"MANTA_SAVE_PARTS": "1"},
               last=r"^flip02 done: \d+ particles, \d+ mesh tris")
# the improved particle levelset's largest eigenvalue jumps where the
# cubic's discriminant changes sign, so sums that differ in their last
# bits move a cell by up to a radius there (ROADMAP C)
FLIP03_GEN = Scene("flip03_gen.py", ["2"], acc=None,
                   last=r"^flip03_gen done: 2 meshes written",
                   known={"phi": 2.8e-3})
GUIDE_LOW = Scene("guiding_3d01_low.py", ["2"],
                  last=r"^guiding_3d01_low done: 2 guiding fields")
GUIDE_HIGH = Scene("guiding_3d02_high.py", ["1"],
                   last=r"^guiding_3d02_high done: density max")
CHAINS = {"flip02_to_flip03_gen": (FLIP02, FLIP03_GEN),
          "guiding_3d_low_to_high": (GUIDE_LOW, GUIDE_HIGH)}


def test_flip02_to_flip03_gen_chain(tmp_path):
    for scene in CHAINS["flip02_to_flip03_gen"]:
        run_process(scene, tmp_path)
    for k in (0, 1):
        assert (tmp_path / f"fluidsurface_final_000{k}.bobj.gz").exists()


def test_guiding_3d_low_to_high_chain(tmp_path):
    for scene in CHAINS["guiding_3d_low_to_high"]:
        run_process(scene, tmp_path)
    for k in (0, 1):
        assert (tmp_path / f"plume3DLowRes_000{k}.uni").exists()
    assert (tmp_path / "plume3DHighRes_0000.uni").exists()


@pytest.mark.slow  # 58-79 s on one core
@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_chain_matches_jax(chain, tmp_path, monkeypatch):
    """Each member of the chain, the JAX package's run against the port's,
    each package in its own MANTA_OUT."""
    snaps = {}
    for who, run in (("jax", run_jax_scene), ("port", run_port_scene)):
        snaps[who] = [snp.snapshot(run(s, tmp_path / who, monkeypatch))
                      for s in CHAINS[chain]]
    assert os.listdir(tmp_path / "port")
    for s, t, j in zip(CHAINS[chain], snaps["port"], snaps["jax"]):
        bad, _ = held(s, t, j)
        assert not bad, f"{s.file}: {bad}"


def test_flip03_gen_phi_moves_with_an_ulp_of_the_averages(tmp_path,
                                                           monkeypatch):
    """flip03_gen.py's phi parts beyond 2e-4 of its scale from the JAX
    package's (2.76e-3) and, on the card, from the CPU twin's (2.97e-3;
    ROADMAP C): the improved particle levelset's largest eigenvalue jumps
    where the characteristic cubic's discriminant changes sign. The port
    against itself with the averaged positions moved by about an ulp
    (relative noise of 1.2e-7) parts by more than either."""
    from mantaflow_tpu_torch.ops import flip as fo
    run_port_scene(FLIP02, tmp_path, monkeypatch)
    first = snp.snapshot(run_port_scene(FLIP03_GEN, tmp_path, monkeypatch))
    averaged = fo._averaged_positions

    def moved(*args, **kwargs):
        have, pavg = averaged(*args, **kwargs)
        gen = torch.Generator().manual_seed(0)
        return have, pavg * (1.0 + 1.2e-7 * torch.randn(pavg.shape,
                                                        generator=gen))
    monkeypatch.setattr(fo, "_averaged_positions", moved)
    for f in tmp_path.glob("fluidsurface_final_*"):
        f.unlink()  # flip03_gen.py loads a mesh file it finds
    again = snp.snapshot(run_port_scene(FLIP03_GEN, tmp_path, monkeypatch))
    cmp_ = snp.compare(again, first, 0.0)
    assert cmp_["phi"][0] >= 2.97e-3, cmp_["phi"]
    assert cmp_["pp.pos"][0] == 0.0
