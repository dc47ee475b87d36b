"""The reference-binary golden scenes on the port, on the CPU (part 1 of 4).

Every ``tests/ref_scenes/test_*.py`` runs unedited through the scene
runner's alias on the port (``mantaflow_tpu_torch.scene.refgolden``), each
against its own thresholds and the goldens the reference binary wrote; the
matrix is split over four files so that ``--dist loadfile`` spreads it.
The scenes the port leaves out, and why, are
``refgolden.LEFT_OUT`` (held in ``tests/test_torch_scene_api.py``).
"""

import pytest
import torch

from mantaflow_tpu_torch.scene import refgolden

# 174 s on one CPU thread (its 40^4 -> 80^4 chain is also held against the
# JAX package by tests/test_torch_scene_paths.py); it runs with -m slow and
# on the card
SLOW = {"test_0042_interpol4d"}
SCENES = [pytest.param(n, marks=pytest.mark.slow) if n in SLOW else n
          for n in refgolden.scene_names()[0::4]]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", SCENES)
def test_ref_golden_on_port(name):
    refgolden.run_ref_scene(name, "cpu")
