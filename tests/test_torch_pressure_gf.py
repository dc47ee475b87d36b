"""The ghost-fluid pressure projection of mantaflow_tpu_torch vs
mantaflow_tpu.

A walled 16^3 pool: fluid below a wavy free surface, empty above, with the
levelset phi of that surface (its ghost-fluid terms enter the stencil's
diagonal and the velocity correction, pressure.cpp:115-224). The assembled
system and the correction repeat the reference's float32 expressions, so
they agree to 1e-6. The solve runs the port's plain CG (the CG kernel's
plain version, in its full-stencil mode on the card) against the JAX
package's XLA CG: iterations within +-10 and max|dp|/max|p| < 5e-3
(tests/test_pressure_pallas.py's tolerances), and velocities to 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mantaflow_tpu.core import flags as jfl
from mantaflow_tpu.core.domain import Domain as JDomain
from mantaflow_tpu.ops import pressure as jprs
from mantaflow_tpu_torch.core.domain import Domain
from mantaflow_tpu_torch.ops import pressure as tprs

N = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs test files in parallel worker processes; torch's own
    thread pool in each would oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pool():
    jdom, dom = JDomain(size=(N,) * 3), Domain(size=(N,) * 3)
    zc, yc, xc = np.meshgrid(*(np.arange(N) + 0.5,) * 3, indexing="ij")
    phi = (yc - 7.3 - 1.5 * np.sin(xc * 0.7) * np.cos(zc * 0.5))
    phi = phi.astype(np.float32)
    flags = np.array(jfl.init_domain(jdom, 0))
    inner = (flags & jfl.TypeObstacle) == 0
    flags[inner & (phi <= 0)] = jfl.TypeFluid
    rng = np.random.RandomState(11)
    vel = (rng.randn(3, N, N, N) * 0.1).astype(np.float32)
    return jdom, dom, flags, phi, vel


@pytest.mark.parametrize("gf_clamp", [1e-4, 0.2])
def test_ghost_fluid_terms_match_reference(pool, gf_clamp):
    _, _, _, phi, _ = pool
    nb = np.roll(phi, -1, axis=2)
    np.testing.assert_allclose(
        tprs._theta(torch.tensor(phi), torch.tensor(nb)).numpy(),
        np.asarray(jprs._theta(jnp.asarray(phi), jnp.asarray(nb))),
        atol=1e-6)
    np.testing.assert_allclose(
        tprs._ghost_fluid(torch.tensor(phi), torch.tensor(nb),
                          gf_clamp).numpy(),
        np.asarray(jprs._ghost_fluid(jnp.asarray(phi), jnp.asarray(nb),
                                     gf_clamp)), atol=1e-6)


def test_rhs_and_stencil_match_reference(pool):
    jdom, dom, flags, phi, vel = pool
    np.testing.assert_allclose(
        tprs.make_rhs(torch.tensor(flags), torch.tensor(vel), dom,
                      phi=torch.tensor(phi)).numpy(),
        np.asarray(jprs.make_rhs(jnp.asarray(flags), jnp.asarray(vel), jdom,
                                 phi=jnp.asarray(phi))), atol=1e-6)
    got = tprs.make_laplace_stencil(torch.tensor(flags), dom,
                                    phi=torch.tensor(phi))
    ref = jprs.make_laplace_stencil(jnp.asarray(flags), jdom,
                                    phi=jnp.asarray(phi))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6)
    # the ghost-fluid terms do change the diagonal at the surface
    plain = tprs.make_laplace_stencil(torch.tensor(flags), dom)
    assert not torch.equal(got[0], plain[0])


def test_correct_velocity_matches_reference(pool):
    jdom, dom, flags, phi, vel = pool
    p = np.random.RandomState(2).randn(N, N, N).astype(np.float32)
    ref = jprs.correct_velocity(jnp.asarray(flags), jnp.asarray(vel),
                                jnp.asarray(p), jdom, phi=jnp.asarray(phi))
    got = tprs.correct_velocity(torch.tensor(flags), torch.tensor(vel),
                                torch.tensor(p), dom, phi=torch.tensor(phi))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def test_solve_pressure_ghost_fluid_matches_reference(pool):
    jdom, dom, flags, phi, vel = pool
    rv, rp, _, rit, _ = jprs.solve_pressure(
        jnp.asarray(vel), jnp.asarray(flags), jdom, cg_accuracy=1e-4,
        phi=jnp.asarray(phi), max_iter=400)
    gv, gp, _, git, grn = tprs.solve_pressure(
        torch.tensor(vel), torch.tensor(flags), dom, cg_accuracy=1e-4,
        phi=torch.tensor(phi), max_iter=400)
    assert float(grn) < 1e-4
    assert abs(int(git) - int(rit)) <= 10
    scale = float(np.abs(np.asarray(rp)).max())
    assert float(np.abs(gp.numpy() - np.asarray(rp)).max()) / scale < 5e-3
    np.testing.assert_allclose(gv.numpy(), np.asarray(rv), atol=1e-4)
