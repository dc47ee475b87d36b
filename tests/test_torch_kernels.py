"""The hand-written CUDA kernels of mantaflow_tpu_torch vs their plain
PyTorch versions, on the card.

Cases marked ``gpu`` need a CUDA device and skip without one; run them on a
machine with a GPU (the JAX package is not needed there, hence no conftest):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -m gpu

Tolerances: the window kernel blends the same 8 corners in the same order as
``window_interp``, so abs 1e-6; the CG kernel reduces in another order than
the plain CG, so iterations within +-10 and max|dp|/max|p| < 5e-3
(tests/test_pressure_pallas.py's tolerances), on a 37x29x23 system, a 2D
one, a grid larger than the kernel keeps on chip, at max_iter, and two
solves bitwise equal; a fraction-weighted and a diffusion system; PcMIC's
12-fold budget; the way its tally counts a solve (the packed stencil for
integer stencils, floats for fractions and ghost fluid), and the two ways
bit for bit equal on one system. On the CPU, the stencil's row codes
(``pack_stencil``) give every coefficient back exactly, and refuse values
they do not hold. The pressure branches that run without the CG kernel
(``pressure.cg_loop``: the l2 exit, compatibility, multigrid) and the smoke
model in its configurations (the exact gathers, multigrid, PcMIC, the 2D
plume) on the card against the CPU, within the CPU tests' tolerances. The
unmarked cases run on the CPU: a wrapper never hands a tensor it cannot
launch on to the plain version; the CG's launch plan (rows per block, what
stays on chip) is host code.
"""

import numpy as np
import pytest
import torch

from mantaflow_tpu_torch.core import flags as fl
from mantaflow_tpu_torch.core.domain import Domain
from mantaflow_tpu_torch.core.shapes import Sphere
from mantaflow_tpu_torch.models import flip, smoke
from mantaflow_tpu_torch.ops import advection_kernels as advk
from mantaflow_tpu_torch.ops import pressure as prs
from mantaflow_tpu_torch.ops import pressure_kernels as prk
from mantaflow_tpu_torch.ops.advection_fast import window_interp

K = 3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _window_fixture(device):
    """tests/test_advection_pallas.py's fixture: 12x16x24, displacements of
    3.8 > k."""
    rng = np.random.RandomState(0)
    Z, Y, X = 12, 16, 24
    src = rng.rand(Z, Y, X).astype(np.float32)
    ok = rng.rand(Z, Y, X) > 0.3
    zz, yy, xx = np.meshgrid(np.arange(Z), np.arange(Y), np.arange(X),
                             indexing="ij")
    disp = (rng.rand(3, Z, Y, X) * 2 - 1) * 3.8
    pos = [torch.tensor((g + 0.5 + d).astype(np.float32), device=device)
           for g, d in ((xx, disp[0]), (yy, disp[1]), (zz, disp[2]))]
    return (Domain(size=(X, Y, Z)), torch.tensor(src, device=device),
            torch.tensor(ok, device=device), pos)


def _obstacle_slab_system(n, device, size=None):
    """A walled n^3 system (or of ``size`` (x, y, z)) with an obstacle
    sphere and an empty slab."""
    dom, flags = _obstacle_slab_flags(n, device, size)
    nx, ny, nz = dom.size
    vel = torch.tensor(np.random.RandomState(7).randn(3, nz, ny, nx)
                       .astype(np.float32) * 0.1, device=device)
    return (dom, prs.make_rhs(flags, vel, dom),
            prs.make_laplace_stencil(flags, dom), fl.is_fluid(flags))


def _obstacle_slab_flags(n, device, size=None):
    nx, ny, nz = size or (n, n, n)
    dom = Domain(size=(nx, ny, nz))
    flags = fl.fill_grid(fl.init_domain(dom, 1, device=device), fl.TypeFluid)
    zc, yc, xc = torch.meshgrid(
        *(torch.arange(m, device=device) + 0.5 for m in (nz, ny, nx)),
        indexing="ij")
    obs = ((xc - 0.3 * nx) ** 2 + (yc - 0.2 * ny) ** 2
           + (zc - 0.5 * nz) ** 2).sqrt() < 0.12 * min(nx, ny, nz)
    flags = torch.where(obs, fl.TypeObstacle, flags)
    return dom, torch.where((yc > 0.8 * ny) & fl.is_fluid(flags),
                            fl.TypeEmpty, flags)


def _check_cg(dom, rhs, stencil, fluid, acc, max_iter, unit=False):
    """The kernel against the plain CG: iterations within +-10, max|dp| /
    max|p| < 5e-3, exit below the accuracy or at max_iter; returns the
    kernel's (p, iterations)."""
    p_ref, it_ref, _ = prs.cg_plain(rhs, stencil, dom, acc, max_iter, fluid)
    before = prk.cg_solve.launches
    p, it, rn = prk.cg_solve(rhs, stencil, dom, acc, max_iter, fluid=fluid,
                             unit_stencil=unit)
    torch.cuda.synchronize()
    assert prk.cg_solve.launches == before + 1
    assert p.device.type == "cuda" and it.dtype == torch.int32
    assert int(it) == max_iter or float(rn) < acc
    assert abs(int(it) - int(it_ref)) <= 10
    scale = float(p_ref.abs().max())
    assert float((p - p_ref).abs().max()) <= 5e-3 * scale
    return p, int(it)


@pytest.mark.gpu
@pytest.mark.parametrize("want_minmax,with_ok",
                         [(False, False), (True, False), (True, True)])
def test_window_kernel_matches_plain(cuda, want_minmax, with_ok):
    dom, src, ok, pos = _window_fixture(cuda)
    ok = ok if with_ok else None
    before = advk.window_pass.launches
    got = advk.window_pass(src, *pos, dom, K, ok_mask=ok,
                           want_minmax=want_minmax)
    ref = window_interp(src, *pos, dom, K, ok_mask=ok, want_minmax=want_minmax)
    torch.cuda.synchronize()
    assert advk.window_pass.launches == before + 1
    if not want_minmax:
        got, ref = (got,), (ref,)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        if r.dtype == torch.bool:
            assert torch.equal(g, r)
        else:
            assert float((g - r).abs().max()) < 1e-6


@pytest.mark.gpu
def test_window_kernel_2d_matches_plain(cuda):
    rng = np.random.RandomState(4)
    Y, X = 10, 14
    dom = Domain(size=(X, Y, 1), dim=2)
    yy, xx = np.meshgrid(np.arange(Y), np.arange(X), indexing="ij")
    args = [rng.rand(1, Y, X),
            (xx + 0.5 + rng.uniform(-2.5, 2.5, (Y, X)))[None],
            (yy + 0.5 + rng.uniform(-2.5, 2.5, (Y, X)))[None],
            np.full((1, Y, X), 0.5)]
    args = [torch.tensor(a.astype(np.float32), device=cuda) for a in args]
    ok = torch.tensor(rng.rand(1, Y, X) > 0.3, device=cuda)
    got = advk.window_pass(*args, dom, 2, ok_mask=ok, want_minmax=True)
    ref = window_interp(*args, dom, 2, ok_mask=ok, want_minmax=True)
    for g, r in zip(got, ref):
        if r.dtype == torch.bool:
            assert torch.equal(g, r)
        else:
            assert float((g - r).abs().max()) < 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize("unit", [False, True])
def test_cg_kernel_matches_plain(cuda, unit):
    n, acc = 24, 1e-4
    max_iter = int(1.5 * n) * 12
    dom, rhs, stencil, fluid = _obstacle_slab_system(n, cuda)
    p_ref, it_ref, _ = prs.cg_plain(rhs, stencil, dom, acc, max_iter, fluid)
    before = prk.cg_solve.launches
    p, it, rn = prk.cg_solve(rhs, stencil, dom, acc, max_iter, fluid=fluid,
                             unit_stencil=unit)
    assert prk.cg_solve.launches == before + 1
    assert p.device.type == "cuda" and it.dtype == torch.int32
    assert float(rn) < acc
    assert abs(int(it) - int(it_ref)) <= 10
    scale = float(p_ref.abs().max())
    assert float((p - p_ref).abs().max()) / scale < 5e-3


@pytest.mark.gpu
@pytest.mark.parametrize("unit", [False, True])
def test_cg_kernel_odd_shape_matches_plain(cuda, unit):
    """37x29x23: rows that neither the warps nor the blocks divide."""
    dom, rhs, stencil, fluid = _obstacle_slab_system(0, cuda, (37, 29, 23))
    _, it = _check_cg(dom, rhs, stencil, fluid, 1e-4, 500, unit)
    assert it > 0


@pytest.mark.gpu
def test_cg_kernel_2d_matches_plain(cuda):
    dom = Domain(size=(40, 28, 1), dim=2)
    flags = fl.fill_grid(fl.init_domain(dom, 1, device=cuda), fl.TypeFluid)
    yc = torch.arange(28, device=cuda).reshape(1, 28, 1) + 0.5
    flags = torch.where((yc > 20) & fl.is_fluid(flags), fl.TypeEmpty, flags)
    vel = torch.tensor(np.random.RandomState(3).randn(3, 1, 28, 40)
                       .astype(np.float32) * 0.1, device=cuda)
    vel[2] = 0.0
    _check_cg(dom, prs.make_rhs(flags, vel, dom),
              prs.make_laplace_stencil(flags, dom), fl.is_fluid(flags),
              1e-4, 400)


@pytest.mark.gpu
def test_cg_kernel_zero_rhs_takes_no_iteration(cuda):
    dom, rhs, stencil, fluid = _obstacle_slab_system(16, cuda)
    p, it, rn = prk.cg_solve(torch.zeros_like(rhs), stencil, dom, 1e-3, 50,
                             fluid=fluid)
    assert int(it) == 0 and float(rn) == 0.0
    assert not bool(p.any())


@pytest.mark.gpu
@pytest.mark.parametrize("unit", [False, True])
def test_cg_kernel_stops_at_max_iter(cuda, unit):
    dom, rhs, stencil, fluid = _obstacle_slab_system(24, cuda)
    _, it = _check_cg(dom, rhs, stencil, fluid, 1e-9, 7, unit)
    assert it == 7


@pytest.mark.gpu
def test_cg_kernel_over_capacity_matches_plain(cuda):
    """A grid whose blocks own more cells than they keep on chip: the rest
    go through the device-memory scratch."""
    size = (256, 96, 96)
    plan = prk.cg_plan((96, 96, 256), prk._sm_count(cuda.index or 0))
    assert plan.overflow > 0
    dom, rhs, stencil, fluid = _obstacle_slab_system(0, cuda, size)
    _, counts = _tallied(
        lambda: _check_cg(dom, rhs, stencil, fluid, 1e-4, 2000))
    # the on-chip cells packed, the rest read as floats
    assert counts == (1, 0)


def _tallied(fn):
    """fn()'s result and what it added to the kernel's tally (packed
    solves, the rest)."""
    before = prk.cg_tally()
    out = fn()
    torch.cuda.synchronize()
    after = prk.cg_tally()
    return out, (after[0] - before[0], after[1] - before[1])


@pytest.mark.gpu
@pytest.mark.parametrize("name,packed", [
    ("obstacle_slab", True), ("2d", True), ("dam", True), ("fixed", True),
    ("fractions", False), ("ghost_fluid", False)])
def test_cg_kernel_picks_its_stencil_from_the_values(cuda, name, packed):
    """Integer stencils run packed, face fractions and the ghost-fluid
    diagonal as floats (the tally counts the one solve on its way); both
    match the plain CG and repeat bit for bit."""
    dom, rhs, stencil = _stencil_case(name, cuda)
    (p, it), counts = _tallied(
        lambda: _check_cg(dom, rhs, stencil, None, 1e-4, 500))
    assert counts == ((1, 0) if packed else (0, 1))
    again = prk.cg_solve(rhs, stencil, dom, 1e-4, 500)
    assert torch.equal(again[0], p) and int(again[1]) == it


@pytest.mark.gpu
@pytest.mark.parametrize("size", [(37, 29, 23), (256, 96, 96)])
def test_cg_kernel_packed_and_float_stencils_agree_bit_for_bit(cuda, size):
    """The same system packed, and read as floats for one link stored as
    -0.0 (a wall cell's, multiplied by zeros): p, the iterations and the
    residual equal bit for bit, on chip and, over capacity, with the
    blocks' further cells in device memory."""
    dom, flags = _obstacle_slab_flags(0, cuda, size)
    nx, ny, nz = dom.size
    vel = torch.tensor(np.random.RandomState(7).randn(3, nz, ny, nx)
                       .astype(np.float32) * 0.1, device=cuda)
    rhs = prs.make_rhs(flags, vel, dom)
    stencil = prs.make_laplace_stencil(flags, dom)
    ai = stencil[1].clone()
    ai[0, 0, 0] = -0.0
    negzero = (stencil[0], ai) + stencil[2:]
    a, na = _tallied(lambda: prk.cg_solve(rhs, stencil, dom, 1e-4, 2000))
    b, nb = _tallied(lambda: prk.cg_solve(rhs, negzero, dom, 1e-4, 2000))
    assert na == (1, 0) and nb == (0, 1)
    assert int(a[1]) > 0
    for u, v in zip(a, b):
        assert torch.equal(u, v)


@pytest.mark.gpu
@pytest.mark.parametrize("unit", [False, True])
def test_cg_kernel_is_deterministic(cuda, unit):
    dom, rhs, stencil, fluid = _obstacle_slab_system(0, cuda, (37, 29, 23))
    runs = [prk.cg_solve(rhs, stencil, dom, 1e-4, 500, fluid=fluid,
                         unit_stencil=unit) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("nrows,blocks", [(16384, 132), (667, 132),
                                          (5, 132), (36864, 7)])
def test_cg_row_partition_covers_every_row_once(nrows, blocks):
    ranges = [prk.row_range(b, nrows, blocks) for b in range(blocks)]
    assert ranges[0][0] == 0 and ranges[-1][1] == nrows
    assert all(ranges[b][1] == ranges[b + 1][0] for b in range(blocks - 1))
    sizes = [e - f for f, e in ranges]
    assert max(sizes) - min(sizes) <= 1
    assert max(sizes) == prk.cg_plan((1, nrows, 3), blocks).max_rows


@pytest.mark.parametrize("shape,onchip,overflow", [
    ((128, 128, 128), 16000, 0),        # the 128^3 paths: all on chip
    ((192, 192, 192), 16384, 37376),    # over capacity
    ((23, 29, 37), 222, 0),
    ((1, 28, 40), 40, 0)])              # 2D: fewer rows than blocks
def test_cg_plan_keeps_what_fits_on_chip(shape, onchip, overflow):
    plan = prk.cg_plan(shape, 132)
    assert (plan.onchip, plan.overflow) == (onchip, overflow)
    # r, s, tmp and the row code: 14 bytes a cell of an H100 block's 227 KB
    assert plan.onchip <= prk.CG_ONCHIP_CELLS
    assert plan.smem_bytes + prk.CG_STATIC_SMEM_BYTES <= 232448


@pytest.mark.parametrize("shape,onchip", [
    ((128, 128, 128), 16000),           # the dams
    ((112, 168, 112), 16016),           # the plumes
    ((192, 192, 192), 16384)])          # the most a block keeps on chip
def test_cg_plan_shared_memory_holds_the_row_codes(shape, onchip):
    plan = prk.cg_plan(shape, 132)
    assert plan.onchip == onchip
    assert plan.smem_bytes == 14 * onchip
    assert plan.smem_bytes + prk.CG_STATIC_SMEM_BYTES <= 232448


def _stencil_case(name, device):
    """(dom, rhs, stencil) of a system the packing tests take, its rhs from
    a random velocity."""
    dom, flags, stencil, rhs_kw = _stencil_parts(name, device)
    nx, ny, nz = dom.size
    vel = torch.tensor(np.random.RandomState(5).randn(3, nz, ny, nx)
                       .astype(np.float32) * 0.1, device=device)
    if not dom.is3d:
        vel[2] = 0.0
    rhs = prs.make_rhs(flags, vel, dom, **rhs_kw)
    if name == "fixed":
        rhs, _ = prs._fix_pressure(flags, rhs, stencil, dom)
    return dom, rhs, stencil


def _stencil_parts(name, device):
    if name == "plume112":
        # the plume cells' grid: walls of width 0, fluid inside
        dom = Domain(size=(112, 168, 112))
        flags = fl.fill_grid(fl.init_domain(dom, 0, device=device),
                             fl.TypeFluid)
        return dom, flags, prs.make_laplace_stencil(flags, dom), {}
    if name == "dam":
        dom = Domain(size=(24, 24, 24))
        flags = flip._dam_flags(dom, (0.4, 0.6, 1.0), 0, None, device)
        assert bool(fl.is_empty(flags).any())
        return dom, flags, prs.make_laplace_stencil(flags, dom), {}
    if name == "obstacle_slab":
        dom, flags = _obstacle_slab_flags(0, device, (37, 29, 23))
        return dom, flags, prs.make_laplace_stencil(flags, dom), {}
    if name == "fixed":
        # no empty cell: one fluid cell's pressure pinned to zero
        dom = Domain(size=(16, 20, 12))
        flags = fl.fill_grid(fl.init_domain(dom, 1, device=device),
                             fl.TypeFluid)
        rhs = torch.zeros(dom.shape, device=device)
        stencil = prs.make_laplace_stencil(flags, dom)
        _, fixed = prs._fix_pressure(flags, rhs, stencil, dom)
        assert not torch.equal(fixed[0], stencil[0])
        return dom, flags, fixed, {}
    if name == "2d":
        dom = Domain(size=(40, 28, 1), dim=2)
        flags = fl.fill_grid(fl.init_domain(dom, 1, device=device),
                             fl.TypeFluid)
        yc = torch.arange(28, device=device).reshape(1, 28, 1) + 0.5
        flags = torch.where((yc > 20) & fl.is_fluid(flags), fl.TypeEmpty,
                            flags)
        return dom, flags, prs.make_laplace_stencil(flags, dom), {}
    if name == "fractions":
        dom, flags, _, fractions, obvel = _fraction_system(24, device)
        return (dom, flags,
                prs.make_laplace_stencil(flags, dom, fractions=fractions),
                {"fractions": fractions, "obvel": obvel})
    if name == "ghost_fluid":
        dom = Domain(size=(24, 24, 24))
        flags = flip._dam_flags(dom, (0.4, 0.6, 1.0), 0, None, device)
        yc = torch.arange(24, device=device).reshape(1, 24, 1) + 0.5
        phi = (yc - 0.6 * 24 + 0.3).expand(dom.shape).contiguous()
        return (dom, flags, prs.make_laplace_stencil(flags, dom, phi=phi),
                {"phi": phi})
    if name == "negative_zero":
        # the plain stencil with one +0.0 link written as -0.0: the same
        # system, not bit for bit a value of the row code
        dom, flags = _obstacle_slab_flags(0, device, (37, 29, 23))
        a0, ai, aj, ak = prs.make_laplace_stencil(flags, dom)
        assert float(ai[0, 0, 0]) == 0.0
        ai = ai.clone()
        ai[0, 0, 0] = -0.0
        return dom, flags, (a0, ai, aj, ak), {}
    raise KeyError(name)


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("name", ["plume112", "dam", "obstacle_slab",
                                  "fixed", "2d"])
def test_pack_stencil_round_trip_is_exact(name):
    """The row codes the CG kernel keeps in shared memory give back every
    coefficient bit for bit (their links to outside the grid are 0); each
    cell's lower-link bits are its -x/-y/-z neighbour's own links."""
    dom, _, stencil = _stencil_case(name, "cpu")
    code, ok = prk.pack_stencil(stencil, dom)
    assert bool(ok) and code.dtype == torch.int32 and code.shape == dom.shape
    assert int(code.max()) < 1 << 9
    for a, b in zip(stencil, prk.unpack_stencil(code)):
        assert torch.equal(_bits(a), _bits(b))
    for ax, own, lower in zip((2, 1, 0), prk.CODE_LINKS,
                              prk.CODE_LOWER_LINKS):
        n = dom.shape[ax]
        got = (code & lower) != 0
        assert not bool(got.narrow(ax, 0, 1).any())
        assert torch.equal(got.narrow(ax, 1, n - 1),
                           ((code & own) != 0).narrow(ax, 0, n - 1))


@pytest.mark.parametrize("name", ["fractions", "ghost_fluid",
                                  "negative_zero"])
def test_pack_stencil_refuses_other_values(name):
    """Face fractions, the ghost-fluid diagonal and a -0.0 link are not
    values of the row code: the kernel reads such a stencil as floats."""
    dom, _, stencil = _stencil_case(name, "cpu")
    _, ok = prk.pack_stencil(stencil, dom)
    assert not bool(ok)


@pytest.mark.gpu
def test_kernels_refuse_what_they_cannot_take(cuda):
    dom, src, _, pos = _window_fixture(cuda)
    with pytest.raises(ValueError, match="contiguous float32"):
        advk.window_pass(src.double(), *pos, dom, K)
    with pytest.raises(ValueError, match="contiguous float32"):
        advk.window_pass(src.transpose(1, 2).contiguous().transpose(1, 2),
                         *pos, dom, K)
    cdom, rhs, stencil, _ = _obstacle_slab_system(8, cuda)
    with pytest.raises(ValueError, match="contiguous float32"):
        prk.cg_solve(rhs[:, :, :4], stencil, cdom, 1e-3, 10)


@pytest.mark.gpu
def test_smoke_steps_on_card_match_cpu(cuda):
    res = 16
    dom = Domain(size=(res,) * 3)
    params = smoke.SmokeParams(buoyancy=(0.0, -6e-4, 0.0),
                               vorticity_confinement=0.1, cg_accuracy=1e-3,
                               window=3, use_pallas=True, adaptive_dt=True,
                               cfl=3.0, dt_max=2.0)
    src = Sphere(center=(res / 2.0, res * 0.1, res / 2.0), radius=res * 0.14)
    states = [smoke.smoke_run(smoke.make_smoke_state(dom, params, src,
                                                     device=d), dom, params, 3)
              for d in (cuda, "cpu")]
    for name in ("density", "vel"):
        diff = getattr(states[0], name).cpu() - getattr(states[1], name)
        assert float(diff.abs().max()) < 2e-4, name
    assert int(states[0].ts.count) == 3


def _zshard_fixture(device):
    """tests/test_advection_pallas.py's 32^3 z-shard fixture."""
    res = 32
    rng = np.random.RandomState(5)
    src = rng.rand(res, res, res).astype(np.float32)
    zz, yy, xx = np.meshgrid(np.arange(res), np.arange(res), np.arange(res),
                             indexing="ij")
    disp = np.stack([np.sin(yy * 0.2) * 2.5, np.cos(zz * 0.3) * 2.5,
                     np.sin(xx * 0.15) * 2.5]).astype(np.float32)
    pos = [torch.tensor((g + d).astype(np.float32), device=device)
           for g, d in ((xx, disp[0]), (yy, disp[1]), (zz, disp[2]))]
    ok = torch.tensor(rng.rand(res, res, res) > 0.3, device=device)
    return (Domain(size=(res,) * 3), torch.tensor(src, device=device), ok,
            pos)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("want_minmax,with_ok",
                         [(False, False), (True, False), (True, True)])
def test_window_slab_kernel_matches_plain(cuda, n, want_minmax, with_ok):
    """The window kernel's z-slab instance, one launch a shard: each slab
    against its plain version on the slab's own haloed inputs (abs 1e-6,
    the one-domain instance's bound), the joined slabs against the
    one-domain kernel bit for bit (the same arithmetic in the same
    order)."""
    from mantaflow_tpu_torch.parallel import sharding as shd
    dom, src, ok, pos = _zshard_fixture(cuda)
    ok = ok if with_ok else None
    mesh = shd.make_zmesh(n, devices=[cuda])
    calls = []
    slab = advk.window_pass_slab

    def recorded(*a, **k):
        calls.append((a, k))
        return slab(*a, **k)
    recorded.launches = 0
    before = advk.window_pass.launches
    advk.window_pass_slab = recorded
    try:
        got = advk.window_pass_zshard(src, *pos, dom, K, mesh, ok_mask=ok,
                                      want_minmax=want_minmax)
    finally:
        advk.window_pass_slab = slab
    torch.cuda.synchronize()
    # the wrapper counts on its module's name, recorded here
    assert (advk.window_pass.launches, recorded.launches) == (before, n)
    one = advk.window_pass(src, *pos, dom, K, ok_mask=ok,
                           want_minmax=want_minmax)
    if not want_minmax:
        got, one = (got,), (one,)
    for g, r in zip(got, one):
        assert torch.equal(g, r)
    for a, k in calls:
        # the slab's inputs, without the output views it wrote into
        src_h, px, py, pz, dom_, k_, z_base, ok_h, mm = a[:9]
        kern = slab(src_h, px, py, pz, dom_, k_, z_base, ok_h, mm)
        ref = advk.window_slab_plain(src_h, px, py, pz, dom_, k_, z_base,
                                     ok_h, mm)
        if not mm:
            kern, ref = (kern,), (ref,)
        for g, r in zip(kern, ref):
            if r.dtype == torch.bool:
                assert torch.equal(g, r)
            else:
                assert float((g - r).abs().max()) < 1e-6


@pytest.mark.gpu
def test_zshard_smoke_steps_on_card(cuda):
    """Three bench smoke steps at 16^3 over 4 z-slabs of 4 planes (each
    exactly the halo's k+1) on the card: bit for bit the one-domain steps
    on the card, and the CPU's to abs 2e-4."""
    from mantaflow_tpu_torch.parallel import sharding as shd
    res = 16
    dom = Domain(size=(res,) * 3)
    params = smoke.SmokeParams(buoyancy=(0.0, -6e-4, 0.0),
                               vorticity_confinement=0.1, cg_accuracy=1e-3,
                               window=3, use_pallas=True, adaptive_dt=True,
                               cfl=3.0, dt_max=2.0)
    src = Sphere(center=(res / 2.0, res * 0.1, res / 2.0), radius=res * 0.14)
    out = {}
    for name, d, zs in (("card", cuda, shd.make_zmesh(4, devices=[cuda])),
                        ("one", cuda, None),
                        ("cpu", "cpu", shd.make_zmesh(4, devices=["cpu"]))):
        st = smoke.make_smoke_state(dom, params, src, device=d)
        for _ in range(3):
            st = smoke.smoke_step(st, dom, params, zshard=zs)
        out[name] = st
    for name in ("density", "vel", "pressure"):
        card = getattr(out["card"], name)
        assert torch.equal(card, getattr(out["one"], name)), name
        diff = card.cpu() - getattr(out["cpu"], name)
        assert float(diff.abs().max()) < 2e-4, name


@pytest.mark.parametrize("which", ["window_pass", "cg_solve"])
def test_wrapper_raises_off_cpu_and_cuda(which):
    """A tensor on another device is refused, not computed on the CPU."""
    dom = Domain(size=(4, 4, 4))
    t = torch.empty(dom.shape, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        if which == "window_pass":
            advk.window_pass(t, t, t, t, dom, K)
        else:
            prk.cg_solve(t, (t, t, t, t), dom, 1e-3, 10)


def _fraction_system(n, device):
    """tests/test_torch_pressure_branches.py's: the obstacle-slab flags
    with face fractions in [0.3, 1] and an obstacle velocity."""
    dom, flags = _obstacle_slab_flags(n, device)
    rng = np.random.RandomState(11)
    fractions = torch.tensor((0.3 + 0.7 * rng.rand(3, n, n, n))
                             .astype(np.float32), device=device)
    obvel = torch.tensor((rng.randn(3, n, n, n) * 0.05).astype(np.float32),
                         device=device)
    vel = torch.tensor((rng.randn(3, n, n, n) * 0.1).astype(np.float32),
                       device=device)
    return dom, flags, vel, fractions, obvel


@pytest.mark.gpu
def test_cg_kernel_fraction_system_matches_plain(cuda):
    dom, flags, vel, fractions, obvel = _fraction_system(24, cuda)
    rhs = prs.make_rhs(flags, vel, dom, fractions=fractions, obvel=obvel)
    stencil = prs.make_laplace_stencil(flags, dom, fractions=fractions)
    _check_cg(dom, rhs, stencil, fl.is_fluid(flags), 1e-4, 400)


@pytest.mark.gpu
def test_diffusion_solves_on_card_match_cpu(cuda):
    dom, flags, _, _, _ = _fraction_system(24, cuda)
    grid = torch.tensor(np.random.RandomState(9).rand(3, 24, 24, 24)
                        .astype(np.float32), device=cuda)
    before = prk.cg_solve.launches
    got = prs.cg_solve_diffusion(flags, grid, dom, alpha=0.5)
    torch.cuda.synchronize()
    assert prk.cg_solve.launches == before + 3
    ref = prs.cg_solve_diffusion(flags.cpu(), grid.cpu(), dom, alpha=0.5)
    assert float((got.cpu() - ref).abs().max()) < 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("branch", ["l2", "compatibility", "multigrid",
                                    "no_kernel"])
def test_loop_cg_on_card_matches_cpu(cuda, branch):
    """The XLA-form CG (``cg_loop``: no kernel launch) on the card against
    the CPU: iterations within +-10, max|dp|/max|p| < 5e-3."""
    n = 24
    dom = Domain(size=(n,) * 3)
    flags = fl.fill_grid(fl.init_domain(dom, 1, device=cuda), fl.TypeFluid)
    vel = torch.tensor(np.random.RandomState(7).randn(3, n, n, n)
                       .astype(np.float32) * 0.1, device=cuda)
    from mantaflow_tpu_torch.ops import extforces as ext
    vel = ext.set_wall_bcs(flags, vel, dom)
    kw = {"l2": dict(cg_accuracy=1e-6, use_l2_norm=True, max_iter=400),
          "compatibility": dict(cg_accuracy=1e-4, max_iter=400,
                                enforce_compatibility=True),
          "multigrid": dict(cg_accuracy=1e-4,
                            preconditioner=prs.PcMGDynamic),
          "no_kernel": dict(cg_accuracy=1e-4, use_pallas_cg=False,
                            max_iter=400)}[branch]
    before = prk.cg_solve.launches
    gv, gp, _, git, grn = prs.solve_pressure(vel, flags, dom, **kw)
    torch.cuda.synchronize()
    assert prk.cg_solve.launches == before
    cv, cp, _, cit, _ = prs.solve_pressure(vel.cpu(), flags.cpu(), dom, **kw)
    assert abs(int(git) - int(cit)) <= 10
    assert float(grn) < kw["cg_accuracy"]
    assert float((gp.cpu() - cp).abs().max()) <= 5e-3 * float(cp.abs().max())
    assert float((gv.cpu() - cv).abs().max()) < 2e-4


@pytest.mark.gpu
def test_pcmic_budget_on_card(cuda):
    """PcMIC: one kernel launch with 12 times PcNone's budget, the same
    solve bit for bit as PcNone given that budget."""
    n = 24
    dom, rhs, stencil, _ = _obstacle_slab_system(n, cuda)
    flags = _obstacle_slab_flags(n, cuda)[1]
    budgets = []
    orig = prk.cg_solve

    def rec(*a, **k):
        budgets.append(a[4])
        return orig(*a, **k)
    rec.launches = 0  # the wrapper counts on its module's name
    prk.cg_solve = rec
    try:
        mic = prs.solve_pressure_system(rhs, flags, dom, stencil, 1e-4, 0.5,
                                        prs.PcMIC, use_pallas=True)
        none = prs.solve_pressure_system(rhs, flags, dom, stencil, 1e-4,
                                         0.5, prs.PcNone,
                                         max_iter=12 * int(0.5 * n),
                                         use_pallas=True)
    finally:
        prk.cg_solve = orig
    assert budgets == [12 * int(0.5 * n)] * 2 and rec.launches == 2
    assert int(mic[1]) > int(0.5 * n)
    for a, b in zip(mic, none):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("config", ["exact_clamp1", "exact_clamp2",
                                    "multigrid", "pcmic", "plume_2d"])
def test_smoke_configs_on_card_match_cpu(cuda, config):
    size = (32, 32, 1) if config == "plume_2d" else (16, 16, 16)
    dom = Domain(size=size, dim=2 if size[2] == 1 else 3)
    base = dict(buoyancy=(0.0, -6e-4, 0.0), vorticity_confinement=0.1,
                cg_accuracy=1e-3, adaptive_dt=True, cfl=3.0, dt_max=2.0)
    kw = {"exact_clamp1": dict(base, window=0, clamp_mode=1),
          "exact_clamp2": dict(base, window=0, clamp_mode=2),
          "multigrid": dict(base, window=0, preconditioner=prs.PcMGStatic),
          "pcmic": dict(base, window=0, preconditioner=prs.PcMIC),
          "plume_2d": dict(buoyancy=(0.0, -4e-3, 0.0), open_bound="yY",
                           window=3)}[config]
    params = smoke.SmokeParams(**kw)
    src = Sphere(center=(size[0] / 2.0, size[1] * 0.1, size[2] / 2.0),
                 radius=size[0] * 0.14)
    w0, c0 = advk.window_pass.launches, prk.cg_solve.launches
    states = [smoke.smoke_run(smoke.make_smoke_state(dom, params, src,
                                                     device=d), dom, params, 3)
              for d in (cuda, "cpu")]
    torch.cuda.synchronize()
    assert advk.window_pass.launches - w0 == \
        (6 * 3 if config == "plume_2d" else 0)
    assert prk.cg_solve.launches - c0 == (0 if config == "multigrid" else 3)
    assert torch.equal(states[0].flags.cpu(), states[1].flags)
    for name in ("density", "vel"):
        diff = getattr(states[0], name).cpu() - getattr(states[1], name)
        assert float(diff.abs().max()) < 2e-4, name
