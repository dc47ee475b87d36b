"""The last single-device names of the port against the JAX package's:
``core/mac.py``'s ``zeros`` and ``neg_divergence`` (2D and 3D, made from a
numpy seed; the divergence to abs 1e-6, the same three subtractions) and
``models/smoke.py``'s ``smoke_step_jit`` (two steps of the closure against
the JAX package's jitted closure at tests/test_smoke_model.py's 2e-4)."""

import numpy as np
import pytest
import torch

from mantaflow_tpu.core import mac as jmac
from mantaflow_tpu.core.domain import Domain as JDomain
from mantaflow_tpu.core.shapes import Sphere as JSphere
from mantaflow_tpu.models import smoke as jsmoke
from mantaflow_tpu_torch.core import mac
from mantaflow_tpu_torch.core.domain import Domain
from mantaflow_tpu_torch.core.shapes import Sphere
from mantaflow_tpu_torch.models import smoke


@pytest.mark.parametrize("shape", [(6, 7, 8), (1, 9, 11)])
def test_zeros_matches_reference(shape):
    got = mac.zeros(shape, device="cpu")
    ref = np.asarray(jmac.zeros(shape))
    assert got.dtype == torch.float32 and got.numpy().dtype == ref.dtype
    np.testing.assert_array_equal(got.numpy(), ref)
    assert mac.zeros(shape, torch.float64, device="cpu").dtype == \
        torch.float64


@pytest.mark.parametrize("shape", [(6, 7, 8), (1, 9, 11)])
def test_neg_divergence_matches_reference(shape):
    vel = np.random.RandomState(1).randn(3, *shape).astype(np.float32)
    if shape[0] == 1:
        vel[2] = 0.0
    got = mac.neg_divergence(torch.from_numpy(vel)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmac.neg_divergence(vel)),
                               atol=1e-6, rtol=0)


def test_smoke_step_jit_matches_reference():
    res = 12
    kw = dict(buoyancy=(0.0, -6e-4, 0.0), vorticity_confinement=0.1)
    src = dict(center=(res / 2, res * 0.15, res / 2), radius=res * 0.15)
    jdom, dom = JDomain(size=(res,) * 3, dim=3), Domain(size=(res,) * 3,
                                                         dim=3)
    jp, tp = jsmoke.SmokeParams(**kw), smoke.SmokeParams(**kw)
    jstep = jsmoke.smoke_step_jit(jdom, jp)
    jst = jstep(jstep(jsmoke.make_smoke_state(jdom, jp,
                                              source_shape=JSphere(**src))))
    step = smoke.smoke_step_jit(dom, tp)
    st = step(step(smoke.make_smoke_state(dom, tp, source_shape=Sphere(**src),
                                          device="cpu")))
    for k in ("vel", "density", "pressure"):
        np.testing.assert_allclose(getattr(st, k).numpy(),
                                   np.asarray(getattr(jst, k)), atol=2e-4,
                                   rtol=0, err_msg=k)
    assert int(st.ts.count) == int(jst.ts.count) == 2
