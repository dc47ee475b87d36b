"""Card cases of this slice's repairs and of the sharded steps; they need
a CUDA device and import no JAX, so they run on the card with
``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_card_repairs.py -m gpu``; without one they skip.

- A scene that reads ``np.asarray`` / ``np.array`` of CUDA state tensors
  runs through the scene runner (``scene/run.py:_SceneNumpy``).
- The APIC p2g, an IDP step and a VIC integration repeat bit for bit
  (``tools/scatter_order.py --witness`` at 48^3 and 32^3, 3 runs each).
- The bench smoke's configuration at 32^3 over 4 shards on the card
  matches the one-device run to 1e-5 over 2 steps, with 8 slab launches
  of the window kernel per shard a step and no CG kernel.
"""

import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = [pytest.mark.gpu,
              pytest.mark.skipif(not torch.cuda.is_available(),
                                 reason="needs a CUDA device")]

SCENE = (
    "import numpy as np\n"
    "from mantaflow_tpu.core.domain import Domain\n"
    "from mantaflow_tpu.core.shapes import Sphere\n"
    "from mantaflow_tpu.models import smoke\n"
    "dom = Domain(size=(12, 12, 12), dim=3)\n"
    "params = smoke.SmokeParams(window=3, adaptive_dt=True)\n"
    "state = smoke.make_smoke_state(dom, params, source_shape=Sphere("
    "center=(6, 2, 6), radius=2))\n"
    "state = smoke.smoke_run(state, dom, params, 2)\n"
    "d = np.asarray(state.density)\n"
    "v = np.array(state.vel, dtype=np.float64)\n")


def test_scene_numpy_reads_card_tensors(tmp_path):
    from mantaflow_tpu_torch.scene import run as srun
    scene = tmp_path / "scene.py"
    scene.write_text(SCENE)
    g = srun.run_scene(str(scene), [], "cuda")
    assert g["state"].density.is_cuda
    np.testing.assert_array_equal(g["d"], g["state"].density.cpu().numpy())
    assert g["v"].shape == (3, 12, 12, 12) and g["v"].dtype == np.float64


def test_float_scatters_repeat_on_the_card():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import scatter_order
    got = scatter_order.witness(torch.device("cuda"), res=48, runs=3,
                                small=32)
    assert all(v["distinct_results"] == 1 for v in got.values()), got


def test_smoke_slabs_on_card_match_one_device():
    from mantaflow_tpu_torch.core.domain import Domain
    from mantaflow_tpu_torch.core.shapes import Sphere
    from mantaflow_tpu_torch.models import smoke
    from mantaflow_tpu_torch.ops import advection_kernels as advk
    from mantaflow_tpu_torch.ops import pressure_kernels as prk
    from mantaflow_tpu_torch.parallel import sharding as shd
    res = 32
    dom = Domain(size=(res,) * 3, dim=3)
    params = smoke.SmokeParams(vorticity_confinement=0.1, window=3,
                               use_pallas=True, adaptive_dt=True, dt_max=2.0)
    st = smoke.make_smoke_state(dom, params, source_shape=Sphere(
        center=(16.0, 3.2, 16.0), radius=4.48), device="cuda")
    one = smoke.smoke_run(st, dom, params, 2)
    torch.cuda.synchronize()
    slab0, k2_0 = advk.window_pass_slab.launches, prk.cg_solve.launches
    got = smoke.smoke_run(shd.shard_smoke_state(st, shd.make_mesh(4)), dom,
                          params, 2)
    torch.cuda.synchronize()
    assert advk.window_pass_slab.launches - slab0 == 2 * 8 * 4
    assert prk.cg_solve.launches == k2_0
    whole = shd.unshard_smoke_state(got)
    for k in ("vel", "density", "pressure"):
        err = float((getattr(whole, k) - getattr(one, k)).abs().max())
        assert err <= 1e-5, (k, err)
