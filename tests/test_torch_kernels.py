"""The hand-written CUDA kernels of mantaflow_tpu_torch vs their plain
PyTorch versions, on the card.

Cases marked ``gpu`` need a CUDA device and skip without one; run them on a
machine with a GPU (the JAX package is not needed there, hence no conftest):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -m gpu

Tolerances: the window kernel blends the same 8 corners in the same order as
``window_interp``, so abs 1e-6; the CG kernel reduces in another order than
the plain CG, so iterations within +-10 and max|dp|/max|p| < 5e-3
(tests/test_pressure_pallas.py's tolerances). The unmarked cases run on the
CPU: a wrapper never hands a tensor it cannot launch on to the plain version.
"""

import numpy as np
import pytest
import torch

from mantaflow_tpu_torch.core import flags as fl
from mantaflow_tpu_torch.core.domain import Domain
from mantaflow_tpu_torch.core.shapes import Sphere
from mantaflow_tpu_torch.models import smoke
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


def _obstacle_slab_system(n, device):
    """A walled n^3 system with an obstacle sphere and an empty slab."""
    dom = Domain(size=(n, n, n))
    flags = fl.fill_grid(fl.init_domain(dom, 1, device=device), fl.TypeFluid)
    zc, yc, xc = torch.meshgrid(*(torch.arange(n, device=device) + 0.5,) * 3,
                                indexing="ij")
    obs = ((xc - 0.3 * n) ** 2 + (yc - 0.2 * n) ** 2
           + (zc - 0.5 * n) ** 2).sqrt() < 0.12 * n
    flags = torch.where(obs, fl.TypeObstacle, flags)
    flags = torch.where((yc > 0.8 * n) & fl.is_fluid(flags), fl.TypeEmpty,
                        flags)
    vel = torch.tensor(np.random.RandomState(7).randn(3, n, n, n)
                       .astype(np.float32) * 0.1, device=device)
    return (dom, prs.make_rhs(flags, vel, dom),
            prs.make_laplace_stencil(flags, dom), fl.is_fluid(flags))


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
                               window=3, adaptive_dt=True,
                               cfl=3.0, dt_max=2.0)
    src = Sphere(center=(res / 2.0, res * 0.1, res / 2.0), radius=res * 0.14)
    states = [smoke.smoke_run(smoke.make_smoke_state(dom, params, src,
                                                     device=d), dom, params, 3)
              for d in (cuda, "cpu")]
    for name in ("density", "vel"):
        diff = getattr(states[0], name).cpu() - getattr(states[1], name)
        assert float(diff.abs().max()) < 2e-4, name
    assert int(states[0].ts.count) == 3


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
