"""Forces and boundary conditions of mantaflow_tpu_torch vs mantaflow_tpu.

Inputs come from a numpy seed; flags hold walls, an obstacle block, stick
cells, empty cells and an outflow band, so every branch of the gates is
taken. Tolerance abs 1e-6 (elementwise float32; vorticity confinement uses
rsqrt, whose last bit may differ between backends: 1e-5 there).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mantaflow_tpu.core import flags as jfl
from mantaflow_tpu.core.domain import Domain as JDomain
from mantaflow_tpu.ops import extforces as jext
from mantaflow_tpu_torch.core import flags as tfl
from mantaflow_tpu_torch.core.domain import Domain
from mantaflow_tpu_torch.ops import extforces as text


@pytest.fixture(scope="module")
def system():
    size = (14, 12, 10)
    jdom = JDomain(size=size)
    flags = jfl.fill_grid(jfl.init_domain(jdom, 1), jfl.TypeFluid)
    flags = jfl.set_open_bound(flags, jdom, 1, "Y")
    flags = np.array(flags)
    flags[4:6, 3:5, 5:8] = jfl.TypeObstacle
    flags[6, 6, 6] = jfl.TypeObstacle | jfl.TypeStick
    flags[3:5, 7:9, 3:5] = jfl.TypeEmpty
    rng = np.random.RandomState(11)
    vel = rng.randn(3, *jdom.shape).astype(np.float32)
    dens = rng.rand(*jdom.shape).astype(np.float32)
    return jdom, Domain(size=size), flags, vel, dens


def _close(ref, got, tol=1e-6):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=tol)


def test_set_wall_bcs(system):
    jdom, dom, flags, vel, _ = system
    _close(jext.set_wall_bcs(jnp.asarray(flags), jnp.asarray(vel), jdom),
           text.set_wall_bcs(torch.tensor(flags), torch.tensor(vel), dom))


@pytest.mark.parametrize("dt", [1.0, 0.37])
def test_add_buoyancy(system, dt):
    jdom, dom, flags, vel, dens = system
    g = (0.0, -6e-4, 0.0)
    ref = jext.add_buoyancy(jnp.asarray(flags), jnp.asarray(dens),
                            jnp.asarray(vel), g, jnp.float32(dt), jdom)
    got = text.add_buoyancy(torch.tensor(flags), torch.tensor(dens),
                            torch.tensor(vel), g,
                            torch.tensor(dt, dtype=torch.float32), dom)
    _close(ref, got)


def test_vorticity_confinement(system):
    jdom, dom, flags, vel, _ = system
    ref = jext.vorticity_confinement(jnp.asarray(vel), jnp.asarray(flags),
                                     jdom, 0.1)
    got = text.vorticity_confinement(torch.tensor(vel), torch.tensor(flags),
                                     dom, 0.1)
    _close(ref, got, 1e-5)


def test_reset_outflow_and_dissolve(system):
    jdom, dom, flags, _, dens = system
    jf, _, jd = jext.reset_outflow_grids(jnp.asarray(flags), jdom, None,
                                         jnp.asarray(dens))
    tf, tphi, td = text.reset_outflow_grids(torch.tensor(flags), dom, None,
                                            torch.tensor(dens))
    assert tphi is None
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    _close(jd, td)
    for log_falloff in (True, False):
        ref, _ = jext.dissolve_smoke(jf, jd, jdom, None, 4, log_falloff)
        got, heat = text.dissolve_smoke(tf, td, dom, None, 4, log_falloff)
        assert heat is None
        _close(ref, got)
