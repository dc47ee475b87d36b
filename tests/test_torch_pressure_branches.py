"""Every branch of the pressure module of mantaflow_tpu_torch vs
mantaflow_tpu (ops/pressure.py).

The systems: 24^3, walled, with an obstacle sphere and an empty (Dirichlet)
slab (tests/test_torch_pressure.py's), and the closed 24^3 smoke box (walls
only, the velocity's wall faces zeroed), on which the JAX package's
multigrid converges. Each branch goes through ``solve_pressure`` of both
packages, the JAX one on the CPU (its XLA CG), the port's on the CPU (the CG
kernel's plain version, or ``cg_loop``), with the reference's tolerances
(tests/test_pressure_pallas.py): iterations within +-10, max|dp|/max|p| <
5e-3, velocities abs 2e-4; multigrid: V-cycles and CG-tail iterations within
+-1. The parts (``make_rhs``, ``make_laplace_stencil``, ``correct_velocity``)
agree to abs 1e-6. Which solves reach the CG kernel's wrapper, and when the
automatic switch to multigrid fires, is held against the JAX package's
decision on one TPU chip.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mantaflow_tpu.core import flags as jfl
from mantaflow_tpu.core.domain import Domain as JDomain
from mantaflow_tpu.ops import extforces as jext
from mantaflow_tpu.ops import flip as jflip
from mantaflow_tpu.ops import multigrid as jmg
from mantaflow_tpu.ops import pressure as jprs
from mantaflow_tpu_torch.core import flags as tfl
from mantaflow_tpu_torch.core.domain import Domain
from mantaflow_tpu_torch.ops import flip as tflip
from mantaflow_tpu_torch.ops import multigrid as tmg
from mantaflow_tpu_torch.ops import pressure as tprs
from mantaflow_tpu_torch.ops import pressure_kernels as tprk

N = 24


def _flags(n, closed):
    jdom = JDomain(size=(n,) * 3)
    flags = np.array(jfl.fill_grid(jfl.init_domain(jdom, 1), jfl.TypeFluid))
    if closed:
        return flags
    zc, yc, xc = np.meshgrid(*(np.arange(n) + 0.5,) * 3, indexing="ij")
    obs = np.sqrt((xc - 0.3 * n) ** 2 + (yc - 0.2 * n) ** 2
                  + (zc - 0.5 * n) ** 2) < 0.12 * n
    flags[obs] = jfl.TypeObstacle
    flags[(yc > 0.8 * n) & ((flags & jfl.TypeFluid) != 0)] = jfl.TypeEmpty
    return flags


def _system(closed, n=N):
    jdom, dom = JDomain(size=(n,) * 3), Domain(size=(n,) * 3)
    flags = _flags(n, closed)
    vel = (np.random.RandomState(7).randn(3, n, n, n) * 0.1).astype(np.float32)
    if closed:
        vel = np.array(jext.set_wall_bcs(jnp.asarray(flags), jnp.asarray(vel),
                                         jdom))
    return dict(jdom=jdom, dom=dom, flags=flags, vel=vel, n=n)


@pytest.fixture(scope="module")
def open_sys():
    return _system(False)


@pytest.fixture(scope="module")
def closed_sys():
    return _system(True)


def _fields(n, seed):
    """Face fractions in [0.3, 1], an obstacle velocity, a per-cell
    correction, a levelset with its surface below the top and its
    curvature."""
    rng = np.random.RandomState(seed)
    fractions = (0.3 + 0.7 * rng.rand(3, n, n, n)).astype(np.float32)
    obvel = (rng.randn(3, n, n, n) * 0.05).astype(np.float32)
    corr = (rng.randn(n, n, n) * 0.01).astype(np.float32)
    zc, yc, xc = np.meshgrid(*(np.arange(n) + 0.5,) * 3, indexing="ij")
    phi = (yc - 0.7 * n + 1.5 * np.sin(xc / 3.0) + 0.3).astype(np.float32)
    return fractions, obvel, corr, phi


def _branch_kwargs(branch, s, to):
    """The solve_pressure keywords of one branch, as tensors (``to`` turns
    a numpy array into the package's array) and the flags it runs on."""
    n = s["n"]
    fractions, obvel, corr, phi = _fields(n, 11)
    flags = s["flags"]
    if branch == "l2":
        return flags, dict(cg_accuracy=1e-6, use_l2_norm=True, max_iter=400)
    if branch == "compatibility":
        return flags, dict(cg_accuracy=1e-4, enforce_compatibility=True,
                           max_iter=400)
    if branch == "fractions_obvel":
        return flags, dict(cg_accuracy=1e-4, fractions=to(fractions),
                           obvel=to(obvel))
    if branch == "per_cell_corr":
        return flags, dict(cg_accuracy=1e-4, per_cell_corr=to(corr))
    if branch == "phi_curv":
        jdom = s["jdom"]
        flags = np.array(jfl.update_from_levelset(
            jfl.fill_grid(jfl.init_domain(jdom, 1), jfl.TypeEmpty),
            jnp.asarray(phi), 1e10))
        curv = np.array(jflip.get_curvature(jnp.asarray(phi), jdom))
        return flags, dict(cg_accuracy=1e-4, phi=to(phi), curv=to(curv),
                           surf_tens=0.05, max_iter=400)
    if branch == "fixed":
        return flags, dict(cg_accuracy=1e-4, zero_pressure_fixing=True)
    if branch == "pcmic":
        # PcNone's budget is int(0.5 * 24) = 12 iterations: too few
        return flags, dict(cg_accuracy=1e-4, cg_max_iter_fac=0.5,
                           preconditioner=jprs.PcMIC)
    if branch == "no_kernel":
        return flags, dict(cg_accuracy=1e-4, use_pallas_cg=False,
                           max_iter=400)
    raise ValueError(branch)


OPEN_BRANCHES = ["l2", "compatibility", "fractions_obvel", "per_cell_corr",
                 "phi_curv", "pcmic", "no_kernel"]
CLOSED_BRANCHES = ["fixed", "compatibility"]
# which branches the port hands to the CG kernel's wrapper (the JAX
# package's Pallas CG on one TPU chip; 2D and fraction systems included)
KERNEL_BRANCHES = {"fractions_obvel", "per_cell_corr", "phi_curv", "pcmic",
                   "fixed"}


def _solve_both(s, branch):
    jflags, jkw = _branch_kwargs(branch, s, jnp.asarray)
    tflags, tkw = _branch_kwargs(branch, s, torch.tensor)
    # the JAX package's CPU solve is its XLA CG, as the port's cg_loop;
    # the port's CG-kernel route runs the plain CG on the CPU
    ref = jprs.solve_pressure(jnp.asarray(s["vel"]), jnp.asarray(jflags),
                              s["jdom"], **jkw)
    calls = []
    orig = tprk.cg_solve

    def rec(*a, **k):
        calls.append(a[4])
        return orig(*a, **k)
    tprk.cg_solve = rec
    try:
        got = tprs.solve_pressure(torch.tensor(s["vel"]),
                                  torch.tensor(tflags), s["dom"], **tkw)
    finally:
        tprk.cg_solve = orig
    return ref, got, calls


def _agree(got, ref, vel_tol=2e-4):
    gv, gp, grhs, git, _ = got
    rv, rp, rrhs, rit, _ = ref
    assert abs(int(git) - int(rit)) <= 10
    rp = np.asarray(rp)
    scale = float(np.abs(rp).max()) + 1e-30
    assert float(np.abs(gp.numpy() - rp).max()) / scale < 5e-3
    np.testing.assert_allclose(grhs.numpy(), np.asarray(rrhs), atol=1e-6)
    np.testing.assert_allclose(gv.numpy(), np.asarray(rv), atol=vel_tol)


@pytest.mark.parametrize("branch", OPEN_BRANCHES)
def test_branch_matches_reference(open_sys, branch):
    ref, got, calls = _solve_both(open_sys, branch)
    _agree(got, ref)
    assert bool(calls) == (branch in KERNEL_BRANCHES)
    if branch == "pcmic":
        # 12 times PcNone's budget, and the solve needs more than PcNone's
        assert calls == [12 * int(0.5 * N)]
        assert int(got[3]) > int(0.5 * N)
    if branch in ("l2", "compatibility", "no_kernel"):
        assert float(got[4]) < _branch_kwargs(branch, open_sys,
                                              np.asarray)[1]["cg_accuracy"]


@pytest.mark.parametrize("branch", CLOSED_BRANCHES)
def test_closed_box_branch_matches_reference(closed_sys, branch):
    ref, got, calls = _solve_both(closed_sys, branch)
    _agree(got, ref)
    assert bool(calls) == (branch in KERNEL_BRANCHES)


def test_pcmic_equals_pcnone_with_its_budget(open_sys):
    """PcMIC is plain CG with 12 times the budget: the same solve as PcNone
    given that budget."""
    vel, flags = torch.tensor(open_sys["vel"]), torch.tensor(open_sys["flags"])
    mic = tprs.solve_pressure(vel, flags, open_sys["dom"], cg_accuracy=1e-4,
                              preconditioner=tprs.PcMIC)
    none = tprs.solve_pressure(vel, flags, open_sys["dom"], cg_accuracy=1e-4,
                               max_iter=12 * int(1.5 * N))
    assert int(mic[3]) == int(none[3])
    assert torch.equal(mic[1], none[1])


@pytest.mark.parametrize("pc", ["static", "dynamic"])
def test_multigrid_solve_matches_reference(closed_sys, pc):
    s = closed_sys
    jf, tf = jnp.asarray(s["flags"]), torch.tensor(s["flags"])
    jst = jprs.make_laplace_stencil(jf, s["jdom"])
    tst = tprs.make_laplace_stencil(tf, s["dom"])
    jkw = dict(cg_accuracy=1e-4, preconditioner=jprs.PcMGDynamic)
    tkw = dict(jkw)
    if pc == "static":
        jkw.update(preconditioner=jprs.PcMGStatic,
                   mg_hierarchy=jmg.build_mg_hierarchy(jf, s["jdom"], jst))
        tkw.update(preconditioner=tprs.PcMGStatic,
                   mg_hierarchy=tmg.build_mg_hierarchy(tf, s["dom"], tst))
    ref = jprs.solve_pressure(jnp.asarray(s["vel"]), jf, s["jdom"], **jkw)
    got = tprs.solve_pressure(torch.tensor(s["vel"]), tf, s["dom"], **tkw)
    _agree(got, ref)
    # the V-cycles alone, then the tail: each within +-1
    jrhs = jprs.make_rhs(jf, jnp.asarray(s["vel"]), s["jdom"])
    trhs = tprs.make_rhs(tf, torch.tensor(s["vel"]), s["dom"])
    _, jcyc, _ = jprs.mg_richardson(
        jrhs, jf, s["jdom"], jst, jmg.make_mg_preconditioner(jf, s["jdom"], jst),
        1e-4)
    _, tcyc, _ = tprs.mg_richardson(
        trhs, tf, s["dom"], tst, tmg.make_mg_preconditioner(tf, s["dom"], tst),
        1e-4)
    assert abs(int(tcyc) - int(jcyc)) <= 1
    assert 1 <= int(tcyc) < 20
    assert abs((int(got[3]) - int(tcyc)) - (int(ref[3]) - int(jcyc))) <= 1


def test_precond_apply_matches_reference(open_sys):
    """A caller's preconditioner (diagonal scaling) runs the XLA-form CG."""
    s = open_sys
    jf, tf = jnp.asarray(s["flags"]), torch.tensor(s["flags"])
    ja0 = jprs.make_laplace_stencil(jf, s["jdom"])[0]
    ta0 = tprs.make_laplace_stencil(tf, s["dom"])[0]
    ref = jprs.solve_pressure(
        jnp.asarray(s["vel"]), jf, s["jdom"], cg_accuracy=1e-4,
        precond_apply=lambda r: r / jnp.where(ja0 > 0, ja0, 1.0))
    got = tprs.solve_pressure(
        torch.tensor(s["vel"]), tf, s["dom"], cg_accuracy=1e-4,
        precond_apply=lambda r: r / torch.where(ta0 > 0, ta0, 1.0))
    _agree(got, ref)


def test_parts_match_reference_with_every_argument(open_sys):
    s = open_sys
    n = s["n"]
    fractions, obvel, corr, phi = _fields(n, 5)
    curv = np.array(jflip.get_curvature(jnp.asarray(phi), s["jdom"]))
    flags = s["flags"]
    for kw in (dict(per_cell_corr=corr),
               dict(fractions=fractions),
               dict(fractions=fractions, obvel=obvel),
               dict(phi=phi, curv=curv, surf_tens=0.1, gf_clamp=1e-3),
               dict(enforce_compatibility=True)):
        ref = jprs.make_rhs(jnp.asarray(flags), jnp.asarray(s["vel"]),
                            s["jdom"], **{k: jnp.asarray(v) if isinstance(
                                v, np.ndarray) else v for k, v in kw.items()})
        got = tprs.make_rhs(torch.tensor(flags), torch.tensor(s["vel"]),
                            s["dom"], **{k: torch.tensor(v) if isinstance(
                                v, np.ndarray) else v for k, v in kw.items()})
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6,
                                   err_msg=str(list(kw)))
    for kw in (dict(fractions=fractions), dict(fractions=fractions, phi=phi)):
        ref = jprs.make_laplace_stencil(jnp.asarray(flags), s["jdom"],
                                        **{k: jnp.asarray(v)
                                           for k, v in kw.items()})
        got = tprs.make_laplace_stencil(torch.tensor(flags), s["dom"],
                                        **{k: torch.tensor(v)
                                           for k, v in kw.items()})
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6)
    p = np.random.RandomState(2).randn(n, n, n).astype(np.float32)
    ref = jprs.correct_velocity(jnp.asarray(flags), jnp.asarray(s["vel"]),
                                jnp.asarray(p), s["jdom"],
                                phi=jnp.asarray(phi), curv=jnp.asarray(curv),
                                surf_tens=0.1)
    got = tprs.correct_velocity(torch.tensor(flags), torch.tensor(s["vel"]),
                                torch.tensor(p), s["dom"],
                                phi=torch.tensor(phi),
                                curv=torch.tensor(curv), surf_tens=0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("kind", ["scalar", "mac"])
def test_cg_solve_diffusion_matches_reference(open_sys, kind):
    s = open_sys
    n = s["n"]
    rng = np.random.RandomState(9)
    grid = rng.rand(*((3, n, n, n) if kind == "mac" else (n, n, n))
                    ).astype(np.float32)
    ref = np.asarray(jprs.cg_solve_diffusion(
        jnp.asarray(s["flags"]), jnp.asarray(grid), s["jdom"], alpha=0.5))
    calls = []
    orig = tprk.cg_solve
    tprk.cg_solve = lambda *a, **k: (calls.append(1), orig(*a, **k))[1]
    try:
        got = tprs.cg_solve_diffusion(torch.tensor(s["flags"]),
                                      torch.tensor(grid), s["dom"], alpha=0.5)
    finally:
        tprk.cg_solve = orig
    assert len(calls) == (3 if kind == "mac" else 1)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-3)
    assert not bool(got[..., ~tfl.is_fluid(torch.tensor(s["flags"]))].any())


# (solve_pressure keywords, fires): the JAX package's rule on one TPU chip,
# where its Pallas CG takes what the port's CG kernel takes
DECISIONS = {
    "tight_default": (dict(cg_accuracy=1e-4), False),
    "tight_no_kernel": (dict(cg_accuracy=1e-4, use_pallas_cg=False), True),
    "tight_compatibility": (dict(cg_accuracy=1e-4,
                                 enforce_compatibility=True), True),
    "loose_no_kernel": (dict(cg_accuracy=1e-3, use_pallas_cg=False), False),
    "mic_no_kernel": (dict(cg_accuracy=1e-4, use_pallas_cg=False,
                           preconditioner=1), True),
    "l2_no_kernel": (dict(cg_accuracy=1e-4, use_pallas_cg=False,
                          use_l2_norm=True), False),
    "fixed_no_kernel": (dict(cg_accuracy=1e-4, use_pallas_cg=False,
                             zero_pressure_fixing=True), False),
    "phi_no_kernel": (dict(cg_accuracy=1e-4, use_pallas_cg=False,
                           phi="phi"), False),
    "fractions_no_kernel": (dict(cg_accuracy=1e-4, use_pallas_cg=False,
                                 fractions="fractions"), False),
    "precond_no_kernel": (dict(cg_accuracy=1e-4, use_pallas_cg=False,
                               precond_apply="precond"), False),
    "hierarchy_no_kernel": (dict(cg_accuracy=1e-4, use_pallas_cg=False,
                                 mg_hierarchy="hierarchy"), True),
}


@pytest.mark.parametrize("case", list(DECISIONS))
def test_auto_multigrid_decision_matches_reference(open_sys, monkeypatch,
                                                   case):
    """The preconditioner and the CG route solve_pressure hands to
    solve_pressure_system, against the JAX package's at the same size gate
    (lowered to 16 in both) with its use_pallas_cg resolved as on one TPU
    chip (None: True)."""
    kw, fires = DECISIONS[case]
    s = open_sys
    n = s["n"]
    fractions, _, _, phi = _fields(n, 3)
    monkeypatch.setenv("MANTA_AUTO_MG_MIN_SIZE", "16")
    monkeypatch.setattr(tprs, "AUTO_MG_MIN_SIZE", 16)
    seen = {}

    def recorder(pkg):
        def rec(rhs, flags, dom, stencil, cg_accuracy, cg_max_iter_fac,
                preconditioner, use_l2_norm, precond_apply, max_iter,
                mg_hierarchy, use_pallas=False, pallas_unit_stencil=False):
            seen[pkg] = (preconditioner, bool(use_pallas))
            return rhs * 0, 0, 0.0
        return rec
    monkeypatch.setattr(jprs, "solve_pressure_system", recorder("jax"))
    monkeypatch.setattr(tprs, "solve_pressure_system", recorder("torch"))
    extra = {"phi": phi, "fractions": fractions,
             "precond": lambda r: r, "hierarchy": object()}
    for pkg, to, mod in (("jax", jnp.asarray, jprs),
                         ("torch", torch.tensor, tprs)):
        args = {k: (to(extra[v]) if isinstance(extra.get(v), np.ndarray)
                    else extra[v]) if isinstance(v, str) else v
                for k, v in kw.items()}
        if pkg == "jax":
            args.setdefault("use_pallas_cg", True)
        mod.solve_pressure(to(s["vel"]), to(s["flags"]),
                           s["jdom"] if pkg == "jax" else s["dom"], **args)
    assert seen["torch"] == seen["jax"]
    mg = seen["torch"][0] in (tprs.PcMGStatic, tprs.PcMGDynamic)
    assert mg == fires
    if fires:
        assert seen["torch"][0] == (tprs.PcMGStatic if "mg_hierarchy" in kw
                                    else tprs.PcMGDynamic)


def test_auto_multigrid_equals_explicit_multigrid(closed_sys, monkeypatch):
    monkeypatch.setattr(tprs, "AUTO_MG_MIN_SIZE", 16)
    vel, flags = torch.tensor(closed_sys["vel"]), torch.tensor(
        closed_sys["flags"])
    auto = tprs.solve_pressure(vel, flags, closed_sys["dom"],
                               cg_accuracy=1e-4, use_pallas_cg=False)
    mg = tprs.solve_pressure(vel, flags, closed_sys["dom"], cg_accuracy=1e-4,
                             preconditioner=tprs.PcMGDynamic,
                             use_pallas_cg=False)
    assert int(auto[3]) == int(mg[3])
    assert torch.equal(auto[1], mg[1])


def test_laplacian_and_curvature_match_reference(open_sys):
    s = open_sys
    phi = _fields(s["n"], 4)[3]
    for name in ("get_laplacian", "get_curvature"):
        ref = getattr(jflip, name)(jnp.asarray(phi), s["jdom"])
        got = getattr(tflip, name)(torch.tensor(phi), s["dom"])
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                                   err_msg=name)
    d2 = JDomain(size=(20, 16, 1), dim=2)
    phi2 = np.random.RandomState(0).rand(1, 16, 20).astype(np.float32)
    for name in ("get_laplacian", "get_curvature"):
        ref = getattr(jflip, name)(jnp.asarray(phi2), d2)
        got = getattr(tflip, name)(torch.tensor(phi2),
                                   Domain(size=(20, 16, 1), dim=2))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
