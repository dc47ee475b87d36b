"""The rest of the multi-device module on the CPU: what the port once
refused on a sharded state, each held against the port's one-device run
of the same state (whose paths ``tests/test_torch_multigrid.py``,
``test_torch_pressure_branches.py`` and ``test_torch_smoke_configs.py``
hold against the JAX package):

- PcMGStatic and PcMGDynamic smoke steps over 3, 4 and 8 shards, and the
  V-cycle with two cut levels (``min_size`` 4) on a hierarchy built whole
  and cut;
- zero-pressure fixing in a closed box over all shards, the pinned cell
  the preferred top-centre one (on a slab's first plane, so that its
  column reaches the shard below) or the first fluid cell;
- z extents the mesh does not divide (20 planes over 3 shards, 5 over 8,
  which leaves empty slabs), the 2D smoke and the 2D flat dam on 4 shards
  (one plane on shard 0, three empty slabs), the flat dam over 3;
- the bucketed path still raising where the JAX package's does.

``tests/test_torch_sharding_rest_jax.py`` holds three of these against
the JAX package's one-device run.
"""

import numpy as np
import pytest
import torch

from mantaflow_tpu_torch.core import flags as fl
from mantaflow_tpu_torch.core.domain import Domain
from mantaflow_tpu_torch.core.shapes import Sphere
from mantaflow_tpu_torch.models import flip, smoke
from mantaflow_tpu_torch.ops import multigrid as mg
from mantaflow_tpu_torch.ops import pressure as prs
from mantaflow_tpu_torch.parallel import sharding as shd


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(n):
    return shd.make_mesh(n, devices=["cpu"])


def _err(a, b):
    return float((a.double() - b.double()).abs().max())


def _smoke_pair(size, n, steps=2, dim=3, **kw):
    """The smoke from one start, on one device and over ``n`` shards."""
    dom = Domain(size=size, dim=dim)
    res = size[0]
    src = Sphere(center=(res / 2, res * 0.15, size[2] / 2),
                 radius=res * 0.15)
    tp = smoke.SmokeParams(buoyancy=(0.0, -6e-4, 0.0), **kw)
    st = smoke.make_smoke_state(dom, tp, source_shape=src, device="cpu")
    one = smoke.smoke_run(st, dom, tp, steps)
    sh = smoke.smoke_run(shd.shard_smoke_state(st, _mesh(n)), dom, tp, steps)
    return one, sh


def _held(one, sh, tol=1e-6):
    w = shd.unshard_smoke_state(sh)
    assert torch.equal(w.flags, one.flags)
    for k in ("vel", "density", "pressure"):
        assert _err(getattr(w, k), getattr(one, k)) <= tol, k
    assert int(sh.cg_iters) == int(one.cg_iters)
    assert float(w.density.max()) > 0.1
    return w


# -- multigrid ----------------------------------------------------------------

@pytest.mark.parametrize("n", [3, 4, 8])
@pytest.mark.parametrize("pc", [prs.PcMGStatic, prs.PcMGDynamic],
                         ids=["mgstatic", "mgdynamic"])
def test_multigrid_smoke_on_slabs_matches_one_device(pc, n):
    one, sh = _smoke_pair((16, 16, 16), n, window=3, use_pallas=True,
                          vorticity_confinement=0.1, preconditioner=pc)
    w = _held(one, sh)
    # the state's hierarchy came back whole, as it went in
    for a, b in zip(w.mg.level_stencils[0], one.mg.level_stencils[0]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n", [2, 3, 4])
def test_vcycle_with_cut_levels_matches_one_device(n):
    """16^3 with ``min_size`` 4: three levels, the two finest cut (over 3
    shards into 6, 6, 4 planes, then 3, 3, 2), so that the transfers
    between cut levels run on the slabs; the cut hierarchy back whole, and
    one V-cycle, built on the whole flags and given the cut hierarchy,
    against the whole ones."""
    dom = Domain(size=(16, 16, 16), dim=3)
    flags = fl.fill_grid(fl.init_domain(dom, 1, device="cpu"), fl.TypeFluid)
    flags[6:11, 3:6, 5:9] = fl.TypeObstacle
    sten = prs.make_laplace_stencil(flags, dom)
    whole = mg.build_mg_hierarchy(flags, dom, sten, min_size=4)
    mesh = _mesh(n)
    F = shd.Slabs.of(flags, mesh)
    S = tuple(shd.Slabs.of(a, mesh) for a in sten)
    cut = mg.shard_mg_hierarchy(whole, dom, mesh, min_size=4)
    assert mg._sharded_levels(mg._levels(dom, 4), mesh) == 2
    back = mg.unshard_mg_hierarchy(cut)
    for name in ("level_flags", "masks", "denoms"):
        for a, b in zip(getattr(back, name), getattr(whole, name)):
            assert torch.equal(a, b), name
    for sa, sb in zip(back.level_stencils, whole.level_stencils):
        assert all(torch.equal(a, b) for a, b in zip(sa, sb))
    r = torch.tensor(np.random.RandomState(n).randn(16, 16, 16)
                     .astype(np.float32))
    r = torch.where(fl.is_fluid(flags), r, 0.0)
    ref = mg.make_mg_preconditioner(flags, dom, sten, min_size=4)(r)
    got = mg.make_mg_preconditioner_slabs(F, dom, S, min_size=4)(
        shd.Slabs.of(r, mesh))
    assert _err(got.whole(), ref) <= 1e-6
    again = mg.make_mg_preconditioner_slabs(F, dom, S, min_size=4,
                                            hierarchy=cut)(
        shd.Slabs.of(r, mesh))
    assert torch.equal(again.whole(), got.whole())


# -- zero-pressure fixing -----------------------------------------------------

def _closed_box(res, block_top=False, empty=False):
    dom = Domain(size=(res,) * 3, dim=3)
    flags = fl.fill_grid(fl.init_domain(dom, 1, device="cpu"), fl.TypeFluid)
    sz, sy, sx = dom.shape
    if block_top:  # the three preferred top-centre cells are obstacles
        flags[sz // 2, sy - 3:, sx // 2] = fl.TypeObstacle
    if empty:
        flags[3, 3, 3] = fl.TypeEmpty
    return dom, flags


@pytest.mark.parametrize("n", [3, 4, 8])
@pytest.mark.parametrize("case", ["preferred", "first_fluid", "no_fix"])
def test_zero_pressure_fixing_on_slabs(case, n):
    """``_fix_pressure_slabs``'s system equals ``_fix_pressure``'s bit for
    bit, and so does the solve that follows, within 1e-6."""
    dom, flags = _closed_box(16, block_top=case == "first_fluid",
                             empty=case == "no_fix")
    vel = torch.tensor(np.random.RandomState(7).randn(3, 16, 16, 16)
                       .astype(np.float32) * 0.1)
    rhs = prs.make_rhs(flags, vel, dom)
    sten = prs.make_laplace_stencil(flags, dom)
    r1, s1 = prs._fix_pressure(flags, rhs, sten, dom)
    mesh = _mesh(n)
    r2, s2 = prs._fix_pressure_slabs(
        shd.Slabs.of(flags, mesh), shd.Slabs.of(rhs, mesh),
        tuple(shd.Slabs.of(a, mesh) for a in sten), dom)
    assert torch.equal(r2.whole(), r1)
    assert all(torch.equal(a.whole(), b) for a, b in zip(s2, s1))
    changed = sum(int((a != b).sum()) for a, b in zip(s1, sten))
    assert (changed == 0) == (case == "no_fix")
    v1, p1, _, i1, _ = prs.solve_pressure(vel, flags, dom, 1e-4,
                                          zero_pressure_fixing=True)
    v2, p2, _, i2, _ = prs.solve_pressure_slabs(
        shd.Slabs.of(vel, mesh), shd.Slabs.of(flags, mesh), dom, 1e-4,
        zero_pressure_fixing=True)
    assert int(i1) == int(i2)
    assert _err(p2.whole(), p1) <= 1e-6 and _err(v2.whole(), v1) <= 1e-6


def test_closed_box_smoke_fixes_its_pressure_on_slabs():
    """The smoke in its closed box (no empty or outflow cell) with
    ``cg_accuracy`` < 1e-7, which fixes the pressure, over 4 shards."""
    one, sh = _smoke_pair((16, 16, 16), 4, window=3, use_pallas=True,
                          cg_accuracy=1e-8)
    w = _held(one, sh)
    assert int(fl.is_empty(w.flags).sum()) == 0


@pytest.mark.parametrize("n", [3, 4])
def test_multigrid_with_fixing_on_slabs(n):
    dom, flags = _closed_box(16)
    vel = torch.tensor(np.random.RandomState(8).randn(3, 16, 16, 16)
                       .astype(np.float32) * 0.1)
    mesh = _mesh(n)
    for pc in (prs.PcMGStatic, prs.PcMGDynamic):
        v1, p1, _, i1, _ = prs.solve_pressure(vel, flags, dom, 1e-4,
                                              preconditioner=pc,
                                              zero_pressure_fixing=True)
        v2, p2, _, i2, _ = prs.solve_pressure_slabs(
            shd.Slabs.of(vel, mesh), shd.Slabs.of(flags, mesh), dom, 1e-4,
            preconditioner=pc, zero_pressure_fixing=True)
        assert int(i1) == int(i2)
        assert _err(p2.whole(), p1) <= 1e-6 and _err(v2.whole(), v1) <= 1e-6


# -- any z extent, 2D ---------------------------------------------------------

@pytest.mark.parametrize("size,n", [((20, 20, 20), 3), ((16, 16, 5), 8)],
                         ids=["20z_over_3", "5z_over_8"])
@pytest.mark.parametrize("window", [0, 3])
def test_uneven_slabs_smoke_matches_one_device(size, n, window):
    kw = dict(window=window, use_pallas=window > 0,
              vorticity_confinement=0.1)
    one, sh = _smoke_pair(size, n, **kw)
    planes = [p.shape[0] for p in sh.density.parts]
    assert planes == [z for _, z in _mesh(n).spans(size[2])]
    assert (0 in planes) == (n == 8)
    _held(one, sh)


@pytest.mark.parametrize("window", [0, 2])
def test_2d_smoke_on_4_shards_matches_one_device(window):
    one, sh = _smoke_pair((32, 32, 1), 4, steps=3, dim=2, window=window,
                          open_bound="yY")
    assert [p.shape[0] for p in sh.density.parts] == [1, 0, 0, 0]
    _held(one, sh)


@pytest.mark.parametrize("size,n,dim", [((32, 32, 1), 4, 2),
                                        ((20, 20, 20), 3, 3)],
                         ids=["2d_over_4", "20z_over_3"])
def test_flat_dam_on_uneven_slabs_matches_one_device(size, n, dim):
    dom = Domain(size=size, dim=dim)
    tp = flip.FlipParams(gravity=(0.0, -0.003, 0.0), ghost_fluid=True,
                         cg_accuracy=1e-4)
    st = flip.make_dam_state(dom, tp, discretization=2, device="cpu")
    one = flip.flip_run(st, dom, tp, 3)
    sh = flip.flip_run(shd.shard_flip_state(st, _mesh(n)), dom, tp, 3)
    w = shd.unshard_flip_state(sh)
    assert torch.equal(w.flags, one.flags)
    assert int(w.parts.count) == int(one.parts.count)
    assert torch.equal(w.parts.flags, one.parts.flags)
    # the slab CG's dots sum per shard in float64: the ghost-fluid solve
    # to 1e-4 exits at another iterate (tests/test_torch_sharding_api.py)
    for k in ("vel", "phi", "pressure", "pvel"):
        assert _err(getattr(w, k), getattr(one, k)) <= 1e-5, k
    assert _err(w.parts.pos, one.parts.pos) <= 1e-5


# -- the bucketed path --------------------------------------------------------

@pytest.mark.parametrize("sz,n,match", [(20, 3, "not divisible"),
                                        (8, 8, "1 plane")])
def test_bucketed_path_raises_where_jax_does(sz, n, match):
    from mantaflow_tpu.core.domain import Domain as JDomain
    from mantaflow_tpu.ops import flip_bucket_pallas as jfbp
    from mantaflow_tpu.parallel import sharding as jshd
    jdom = JDomain(size=(8, 8, sz), dim=3)
    with pytest.raises(ValueError, match=match):
        jfbp.advect_blend_zshard_spmd(None, None, None, None, None, None,
                                      0.97, jdom, jshd.make_mesh(n, ("z",)))
    dom = Domain(size=(8, 8, sz), dim=3)
    tp = flip.FlipParams(gravity=(0.0, -0.003, 0.0))
    st = flip.make_dam_state_bucketed(dom, tp, discretization=2, ppc=12,
                                      device="cpu")
    with pytest.raises(ValueError, match=match):
        shd.shard_flip_bucket_state(st, _mesh(n))
