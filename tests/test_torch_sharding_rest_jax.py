"""Three of ``tests/test_torch_sharding_rest.py``'s sharded smokes from
one start against the JAX package's one-device run (its GSPMD layout
gives one device's results): PcMGStatic over 3 shards, the closed box
with zero-pressure fixing over 4, and 20 planes over 3, at 16³."""

import numpy as np
import pytest
import torch

from mantaflow_tpu_torch.ops import pressure as prs
from test_torch_sharding_rest import _err, _held, _mesh, _smoke_pair


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


JAX_HELD = {
    "mgstatic_over_3": ((16, 16, 16), 3, dict(
        window=3, use_pallas=True, vorticity_confinement=0.1,
        preconditioner=prs.PcMGStatic)),
    "closed_box_fixing_over_4": ((16, 16, 16), 4, dict(
        window=3, use_pallas=True, cg_accuracy=1e-8)),
    "20z_over_3": ((16, 16, 20), 3, dict(window=3, use_pallas=True)),
}


@pytest.mark.parametrize("name", sorted(JAX_HELD))
def test_smoke_on_slabs_matches_jax_one_device(name):
    """The sharded port to 1e-5 of the JAX package, as
    ``tests/test_torch_sharding_api.py`` holds the divisible smoke, and to
    1e-6 of its own one-device run."""
    from mantaflow_tpu.core.domain import Domain as JDomain
    from mantaflow_tpu.core.shapes import Sphere as JSphere
    from mantaflow_tpu.models import smoke as jsmoke
    size, n, kw = JAX_HELD[name]
    res = size[0]
    src = dict(center=(res / 2, res * 0.15, size[2] / 2), radius=res * 0.15)
    jdom = JDomain(size=size, dim=3)
    jp = jsmoke.SmokeParams(buoyancy=(0.0, -6e-4, 0.0), **kw)
    jst = jsmoke.make_smoke_state(jdom, jp, source_shape=JSphere(**src))
    for _ in range(2):
        jst = jsmoke.smoke_step(jst, jdom, jp)
    one, sh = _smoke_pair(size, n, **kw)
    w = _held(one, sh)
    assert [p.shape[0] for p in sh.density.parts] == \
        [z for _, z in _mesh(n).spans(size[2])]
    for k in ("vel", "density", "pressure"):
        assert _err(getattr(w, k), torch.tensor(
            np.asarray(getattr(jst, k)))) <= 1e-5, k
