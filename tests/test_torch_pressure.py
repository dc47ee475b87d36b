"""Pressure projection of mantaflow_tpu_torch vs mantaflow_tpu.

The system is 24^3, walled, with an obstacle sphere and an empty
(Dirichlet) slab set in the flags. The port's ``cg_solve`` runs its plain
CG on CPU tensors; it is held against the JAX package's XLA CG
(``solve_pressure_system``) and its Pallas CG (``cg_solve_pallas`` in
interpret mode) in both stencil modes, with the reference's tolerances
(tests/test_pressure_pallas.py): iterations within +-10 and
max|dp|/max|p| < 5e-3, since float reduction order shifts the trajectory.
The kernel itself is tested on the card by tests/test_torch_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mantaflow_tpu.core import flags as jfl
from mantaflow_tpu.core.domain import Domain as JDomain
from mantaflow_tpu.ops import pressure as jprs
from mantaflow_tpu.ops import pressure_pallas as jprp
from mantaflow_tpu_torch.core import flags as tfl
from mantaflow_tpu_torch.core.domain import Domain
from mantaflow_tpu_torch.ops import pressure as tprs
from mantaflow_tpu_torch.ops import pressure_kernels as tprk

N = 24
ACC = 1e-4
MAX_ITER = int(1.5 * N) * 12


def _obstacle_slab_flags(n):
    jdom = JDomain(size=(n, n, n))
    flags = np.array(jfl.fill_grid(jfl.init_domain(jdom, 1), jfl.TypeFluid))
    zc, yc, xc = np.meshgrid(*(np.arange(n) + 0.5,) * 3, indexing="ij")
    obs = np.sqrt((xc - 0.3 * n) ** 2 + (yc - 0.2 * n) ** 2
                  + (zc - 0.5 * n) ** 2) < 0.12 * n
    flags[obs] = jfl.TypeObstacle
    flags[(yc > 0.8 * n) & ((flags & jfl.TypeFluid) != 0)] = jfl.TypeEmpty
    return flags


@pytest.fixture(scope="module")
def system():
    flags = _obstacle_slab_flags(N)
    vel = (np.random.RandomState(7).randn(3, N, N, N) * 0.1).astype(np.float32)
    jdom, dom = JDomain(size=(N,) * 3), Domain(size=(N,) * 3)
    jrhs = jprs.make_rhs(jnp.asarray(flags), jnp.asarray(vel), jdom)
    jst = jprs.make_laplace_stencil(jnp.asarray(flags), jdom)
    trhs = tprs.make_rhs(torch.tensor(flags), torch.tensor(vel), dom)
    tst = tprs.make_laplace_stencil(torch.tensor(flags), dom)
    return dict(flags=flags, vel=vel, jdom=jdom, dom=dom, jrhs=jrhs, jst=jst,
                trhs=trhs, tst=tst)


def _agree(p, it, p_ref, it_ref):
    assert abs(int(it) - int(it_ref)) <= 10
    p_ref = np.asarray(p_ref)
    scale = float(np.max(np.abs(p_ref))) + 1e-30
    assert float(np.max(np.abs(p.numpy() - p_ref))) / scale < 5e-3


def test_rhs_and_stencil_match_reference(system):
    np.testing.assert_allclose(system["trhs"].numpy(),
                               np.asarray(system["jrhs"]), atol=1e-6)
    for a, b in zip(system["tst"], system["jst"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # unit mode's derived off-diagonals equal the assembled ones here
    fluid = tfl.is_fluid(torch.tensor(system["flags"]))
    for a, b in zip(tprk.unit_offdiagonals(fluid, system["dom"]),
                    system["tst"][1:]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_plain_cg_matches_xla_cg(system):
    p_ref, it_ref, rn_ref = jprs.solve_pressure_system(
        system["jrhs"], jnp.asarray(system["flags"]), system["jdom"],
        system["jst"], cg_accuracy=ACC, max_iter=MAX_ITER)
    p, it, rn = tprs.solve_pressure_system(
        system["trhs"], torch.tensor(system["flags"]), system["dom"],
        system["tst"], cg_accuracy=ACC, max_iter=MAX_ITER)
    assert float(rn_ref) < ACC and float(rn) < ACC
    _agree(p, it, p_ref, it_ref)


@pytest.mark.parametrize("unit", [False, True])
def test_cg_solve_matches_pallas_cg(system, unit):
    jfluid = jfl.is_fluid(jnp.asarray(system["flags"]))
    p_ref, it_ref, _ = jprp.cg_solve_pallas(
        system["jrhs"], system["jst"], system["jdom"], ACC, MAX_ITER,
        fluid=jfluid, unit_stencil=unit, interpret=True)
    p, it, rn = tprk.cg_solve(
        system["trhs"], system["tst"], system["dom"], ACC, MAX_ITER,
        fluid=tfl.is_fluid(torch.tensor(system["flags"])), unit_stencil=unit)
    assert float(rn) < ACC
    assert it.dtype == torch.int32 and rn.dtype == torch.float32
    _agree(p, it, p_ref, it_ref)
    assert tprk.cg_solve.launches == 0  # CPU tensors never launch


def test_solve_pressure_projects_like_reference(system):
    jvel, jp, _, jit, _ = jprs.solve_pressure(
        jnp.asarray(system["vel"]), jnp.asarray(system["flags"]),
        system["jdom"], cg_accuracy=1e-3, use_pallas_cg=False)
    tvel, tp, _, tit, _ = tprs.solve_pressure(
        torch.tensor(system["vel"]), torch.tensor(system["flags"]),
        system["dom"], cg_accuracy=1e-3)
    _agree(tp, tit, jp, jit)
    np.testing.assert_allclose(tvel.numpy(), np.asarray(jvel), atol=2e-4)


def test_fixed_pressure_closed_domain():
    n = 16
    jdom, dom = JDomain(size=(n,) * 3), Domain(size=(n,) * 3)
    flags = np.array(jfl.fill_grid(jfl.init_domain(jdom, 1), jfl.TypeFluid))
    vel = (np.random.RandomState(3).randn(3, n, n, n) * 0.1).astype(np.float32)
    jf, tf = jnp.asarray(flags), torch.tensor(flags)
    jrhs, jst = jprs._fix_pressure(
        jf, jprs.make_rhs(jf, jnp.asarray(vel), jdom),
        jprs.make_laplace_stencil(jf, jdom), jdom)
    trhs, tst = tprs._fix_pressure(
        tf, tprs.make_rhs(tf, torch.tensor(vel), dom),
        tprs.make_laplace_stencil(tf, dom), dom)
    np.testing.assert_allclose(trhs.numpy(), np.asarray(jrhs), atol=1e-6)
    for a, b in zip(tst, jst):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    max_iter = int(1.5 * n) * 12
    p_ref, it_ref, _ = jprs.solve_pressure_system(
        jrhs, jf, jdom, jst, cg_accuracy=ACC, max_iter=max_iter)
    p, it, _ = tprk.cg_solve(trhs, tst, dom, ACC, max_iter)
    _agree(p, it, p_ref, it_ref)
