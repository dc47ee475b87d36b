"""Multigrid of mantaflow_tpu_torch vs mantaflow_tpu (ops/multigrid.py).

A walled 32^3 system with an obstacle sphere and an empty (Dirichlet) slab,
and a 32x32 2D one, three levels each (32 -> 16 -> 8). The hierarchy's
flags and masks equal the JAX package's exactly, its stencils and
prolongation denominators to 1e-7; one V-cycle agrees to abs 1e-5 (the
same float32 ops; XLA may fuse a product and a sum). The multigrid solver
(``mg_richardson``) takes as many cycles as the JAX package's on the closed
smoke system (walls only, the velocity's wall faces zeroed), where it
converges in a few; with the slab's Dirichlet cells the JAX package's
V-cycles diverge, and with the obstacle alone they stall, so those systems
only hold the V-cycle. ``mg_from_numpy`` turns the JAX package's hierarchy
into one equal to the port's own build.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mantaflow_tpu.core import flags as jfl
from mantaflow_tpu.core.domain import Domain as JDomain
from mantaflow_tpu.ops import extforces as jext
from mantaflow_tpu.ops import multigrid as jmg
from mantaflow_tpu.ops import pressure as jprs
from mantaflow_tpu_torch.core import flags as tfl
from mantaflow_tpu_torch.core.domain import Domain
from mantaflow_tpu_torch.ops import multigrid as tmg
from mantaflow_tpu_torch.ops import pressure as tprs

SIZES = {"3d": (32, 32, 32), "2d": (32, 32, 1)}


def _system(size, closed=False):
    sx, sy, sz = size
    is3d = sz > 1
    jdom = JDomain(size=size, dim=3 if is3d else 2)
    flags = np.array(jfl.fill_grid(jfl.init_domain(jdom, 1), jfl.TypeFluid))
    zc, yc, xc = np.meshgrid(np.arange(sz) + 0.5, np.arange(sy) + 0.5,
                             np.arange(sx) + 0.5, indexing="ij")
    r2 = (xc - 0.3 * sx) ** 2 + (yc - 0.2 * sy) ** 2
    if is3d:
        r2 = r2 + (zc - 0.5 * sz) ** 2
    vel = (np.random.RandomState(7).randn(3, sz, sy, sx) * 0.1
           ).astype(np.float32)
    if closed:
        vel = np.array(jext.set_wall_bcs(jnp.asarray(flags),
                                         jnp.asarray(vel), jdom))
    else:
        flags[np.sqrt(r2) < 0.12 * sx] = jfl.TypeObstacle
        flags[(yc > 0.8 * sy) & ((flags & jfl.TypeFluid) != 0)] = \
            jfl.TypeEmpty
    dom = Domain(size=size, dim=jdom.dim)
    jf, tf = jnp.asarray(flags), torch.tensor(flags)
    return dict(
        jdom=jdom, dom=dom, flags=flags, jf=jf, tf=tf,
        jrhs=jprs.make_rhs(jf, jnp.asarray(vel), jdom),
        trhs=tprs.make_rhs(tf, torch.tensor(vel), dom),
        jst=jprs.make_laplace_stencil(jf, jdom),
        tst=tprs.make_laplace_stencil(tf, dom))


@pytest.fixture(scope="module", params=list(SIZES))
def system(request):
    s = _system(SIZES[request.param])
    s["jh"] = jmg.build_mg_hierarchy(s["jf"], s["jdom"], s["jst"])
    s["th"] = tmg.build_mg_hierarchy(s["tf"], s["dom"], s["tst"])
    return s


def test_levels_match_reference(system):
    assert [d.size for d in tmg._levels(system["dom"])] == \
        [d.size for d in jmg._levels(system["jdom"])]
    assert len(system["th"].level_flags) == 3


def test_hierarchy_matches_reference(system):
    jh, th = system["jh"], system["th"]
    for name in ("level_flags", "masks"):
        assert len(getattr(th, name)) == len(getattr(jh, name))
        for g, r in zip(getattr(th, name), getattr(jh, name)):
            assert g.dtype == torch.from_numpy(np.array(r)).dtype
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    for gs, rs in zip(th.level_stencils, jh.level_stencils):
        for g, r in zip(gs, rs):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-7)
    assert len(th.denoms) == len(jh.denoms)
    for g, r in zip(th.denoms, jh.denoms):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-7)


def test_transfers_match_reference(system):
    dom, jdom = system["dom"], system["jdom"]
    sz, sy, sx = dom.shape
    coarse = (np.random.RandomState(3).rand(max(sz // 2, 1), sy // 2, sx // 2)
              .astype(np.float32))
    fine = np.random.RandomState(4).rand(*dom.shape).astype(np.float32)
    np.testing.assert_allclose(
        tmg._p0(torch.tensor(coarse), dom).numpy(),
        np.asarray(jmg._p0(jnp.asarray(coarse), jdom)), atol=1e-6)
    np.testing.assert_allclose(
        tmg._p0t(torch.tensor(fine), dom).numpy(),
        np.asarray(jmg._p0t(jnp.asarray(fine), jdom)), atol=1e-5)


def test_one_vcycle_matches_reference(system):
    japply = jmg.make_mg_preconditioner(system["jf"], system["jdom"],
                                        system["jst"], hierarchy=system["jh"])
    tapply = tmg.make_mg_preconditioner(system["tf"], system["dom"],
                                        system["tst"], hierarchy=system["th"])
    ref = np.asarray(japply(system["jrhs"]))
    got = tapply(system["trhs"]).numpy()
    assert float(np.abs(ref).max()) > 0
    np.testing.assert_allclose(got, ref, atol=1e-5)
    # built per call (PcMGDynamic) it is the same V-cycle
    dyn = tmg.make_mg_preconditioner(system["tf"], system["dom"],
                                     system["tst"])
    assert torch.equal(dyn(system["trhs"]), tapply(system["trhs"]))


@pytest.mark.parametrize("dim", list(SIZES))
def test_mg_richardson_matches_reference(dim):
    acc = 1e-3
    system = _system(SIZES[dim], closed=True)
    japply = jmg.make_mg_preconditioner(system["jf"], system["jdom"],
                                        system["jst"])
    tapply = tmg.make_mg_preconditioner(system["tf"], system["dom"],
                                        system["tst"])
    jx, jit, jrn = jprs.mg_richardson(system["jrhs"], system["jf"],
                                      system["jdom"], system["jst"], japply,
                                      acc)
    tx, tit, trn = tprs.mg_richardson(system["trhs"], system["tf"],
                                      system["dom"], system["tst"], tapply,
                                      acc)
    assert int(tit) == int(jit) and 1 <= int(tit) < 20
    assert float(trn) < acc
    scale = float(np.abs(np.asarray(jx)).max())
    assert float(np.abs(tx.numpy() - np.asarray(jx)).max()) / scale < 1e-4


def test_mg_from_numpy_equals_own_build(system):
    jh = system["jh"]
    as_numpy = {
        "level_flags": tuple(np.asarray(a) for a in jh.level_flags),
        "level_stencils": tuple(tuple(np.asarray(a) for a in st)
                                for st in jh.level_stencils),
        "masks": tuple(np.asarray(a) for a in jh.masks),
        "denoms": tuple(np.asarray(a) for a in jh.denoms)}
    th = system["th"]
    for h in (tmg.mg_from_numpy(as_numpy, device="cpu"),
              tmg.mg_from_numpy(jh, device="cpu")):
        for name in ("level_flags", "masks"):
            for g, r in zip(getattr(h, name), getattr(th, name)):
                assert torch.equal(g, r)
        for gs, rs in zip(h.level_stencils, th.level_stencils):
            for g, r in zip(gs, rs):
                torch.testing.assert_close(g, r, atol=1e-7, rtol=0)
        for g, r in zip(h.denoms, th.denoms):
            torch.testing.assert_close(g, r, atol=1e-7, rtol=0)
    back = tmg.mg_to_numpy(th)
    assert all(np.array_equal(a, b.numpy())
               for a, b in zip(back["level_flags"], th.level_flags))


def test_coarsen_flags_prefers_obstacles():
    dom = Domain(size=(4, 4, 4))
    flags = torch.full(dom.shape, tfl.TypeEmpty, dtype=torch.int32)
    flags[0, 0, 0] = tfl.TypeObstacle
    flags[0, 0, 1] = tfl.TypeFluid
    flags[2, 2, 2] = tfl.TypeFluid
    out = tmg._coarsen_flags(flags, dom)
    assert out[0, 0, 0] == tfl.TypeObstacle
    assert out[1, 1, 1] == tfl.TypeFluid
    assert out[0, 1, 1] == tfl.TypeEmpty
