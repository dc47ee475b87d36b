"""The exact-gather advection's CUDA passes (``csrc/advect_exact.cu``,
launched by ``ops/advection_exact_kernels.py``) against their plain
versions, ``ops/advection.py``'s ``advect_real_plain`` and
``advect_mac_plain``.

Cases marked ``gpu`` need a CUDA device and skip without one; run them on a
machine with a GPU:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_advect_exact_kernel.py -m gpu

The unmarked cases run on the CPU: a driver call on CPU tensors, and every
form the kernels do not compute (2D, cubic lookups, the midpoint trace,
clamp mode 1), takes the plain version, output equal, and is counted
``advection.exact_plain``. The ``gpu`` cases hold the kernels to the plain
version on the card bit for bit, every cell with the boundary ring: the
passes compute the plain version's float32 terms in its order. The domains
are walled with open "yY" bounds (outflow cells), an obstacle sphere, an
empty patch and a fluid patch on the boundary ring; the velocity is drawn
from a seed at a CFL of about 3; dt a number and a 0-dim CUDA tensor. Views
(non-contiguous grids, as a sharded stage hands over) take the kernels too.
"""

import numpy as np
import pytest
import torch

from mantaflow_tpu_torch.core import flags as fl
from mantaflow_tpu_torch.core.domain import Domain
from mantaflow_tpu_torch.ops import advection as adv
from mantaflow_tpu_torch.ops import advection_exact_kernels as advx
from mantaflow_tpu_torch.utils import trace

CFL = 3.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _case(size, device, seed=0):
    """Flags, a MAC velocity of up to CFL cells a unit of time, a scalar
    grid and a centred Vec3 grid on ``device``."""
    sx, sy, sz = size
    is3d = sz > 1
    dom = Domain(size=size, dim=3 if is3d else 2)
    flags = fl.fill_grid(fl.init_domain(dom, 1, device="cpu"), fl.TypeFluid)
    flags = fl.set_open_bound(flags, dom, 1, "yY",
                              fl.TypeOutflow | fl.TypeEmpty)
    zc, yc, xc = torch.meshgrid(
        *(torch.arange(n, dtype=torch.float32) + 0.5 for n in (sz, sy, sx)),
        indexing="ij")
    r2 = (xc - 0.4 * sx) ** 2 + (yc - 0.45 * sy) ** 2
    if is3d:
        r2 = r2 + (zc - 0.5 * sz) ** 2
    flags = torch.where(r2.sqrt() < 0.15 * min(sx, sy), fl.TypeObstacle,
                        flags)
    patch = (xc > 0.7 * sx) & (yc > 0.6 * sy) & (yc < 0.8 * sy)
    flags = torch.where(patch & fl.is_fluid(flags), fl.TypeEmpty, flags)
    if is3d:  # fluid on the boundary ring: the correction runs there
        flags[0, sy // 3:sy // 2, sx // 3:sx // 2] = fl.TypeFluid
    rng = np.random.RandomState(seed)
    vel = (rng.rand(3, sz, sy, sx) * 2 - 1).astype(np.float32) * CFL
    if not is3d:
        vel[2] = 0.0
    grid = rng.rand(sz, sy, sx).astype(np.float32)
    vec = rng.rand(3, sz, sy, sx).astype(np.float32)
    return (dom, flags.contiguous().to(device),
            *(torch.tensor(a, device=device) for a in (vel, grid, vec)))


def _plain(fn, flags, vel, grid, vec, dt, kw):
    """The plain version of the driver ``fn`` on the case's grids."""
    if fn == "real":
        return adv.advect_real_plain(flags, vel, grid, dt, **kw)
    if fn == "vec3":
        return torch.stack([adv.advect_real_plain(flags, vel, vec[c], dt,
                                                  **kw) for c in range(3)])
    return adv.advect_mac_plain(flags, vel, vel, dt, **kw)


def _driver(fn, flags, vel, grid, vec, dt, kw):
    if fn == "real":
        return adv.advect_real(flags, vel, grid, dt, **kw)
    if fn == "vec3":
        return adv.advect_vec3(flags, vel, vec, dt, **kw)
    return adv.advect_mac(flags, vel, vel, dt, **kw)


CALLS = {"real": 1, "vec3": 3, "mac": 1}  # driver calls a function makes


def _counts():
    c = trace.counters()
    return (c.get("advection.exact_kernel", 0),
            c.get("advection.exact_plain", 0))


def _launches():
    return (advx.forward.launches, advx.backward.launches,
            advx.outflow.launches)


# (name, size, keywords): the routed forms on the CPU and the forms the
# kernels do not compute
CPU_FORMS = [
    ("o1", (16, 16, 16), dict(order=1)),
    ("o2", (16, 16, 16), dict(order=2, clamp_mode=2)),
    ("2d", (20, 16, 1), dict(order=2, clamp_mode=2)),
    ("space2", (16, 16, 16), dict(order=2, clamp_mode=2, order_space=2)),
    ("trace2", (16, 16, 16), dict(order=2, clamp_mode=2, order_trace=2)),
    ("clamp1", (16, 16, 16), dict(order=2, clamp_mode=1)),
]


@pytest.mark.parametrize("fn", list(CALLS))
@pytest.mark.parametrize("name,size,kw", CPU_FORMS,
                         ids=[f[0] for f in CPU_FORMS])
def test_cpu_calls_take_the_plain_path(fn, name, size, kw):
    _, flags, vel, grid, vec = _case(size, "cpu")
    before, launched = _counts(), _launches()
    got = _driver(fn, flags, vel, grid, vec, 1.0, kw)
    after = _counts()
    assert after[0] == before[0]
    assert after[1] == before[1] + CALLS[fn]
    assert _launches() == launched
    assert torch.equal(got, _plain(fn, flags, vel, grid, vec, 1.0, kw))


def test_routes_refuses_what_the_kernels_do_not_compute():
    _, flags, vel, grid, _ = _case((16, 16, 16), "cpu")
    args = (flags, vel, grid, 1.0)
    assert not advx.routes(*args, 2, 1.0, 1, 2, 1, mac=False)  # the CPU
    for order, space, clamp, tr in ((2, 2, 2, 1), (2, 1, 2, 2), (2, 1, 1, 1),
                                    (3, 1, 2, 1)):
        assert not advx.routes(*args, order, 1.0, space, clamp, tr,
                               mac=False)


def _same(got, ref):
    assert got.shape == ref.shape and got.dtype == ref.dtype
    diff = got != ref
    assert not bool(diff.any()), (
        f"{int(diff.sum())} cells differ, at {diff.nonzero()[:4].tolist()}, "
        f"max {float((got - ref).abs().max())}")


@pytest.mark.gpu
@pytest.mark.parametrize("fn", list(CALLS))
@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("dt_kind", ["float", "tensor"])
@pytest.mark.parametrize("size", [(24, 24, 24), (32, 48, 32)],
                         ids=["24", "32x48x32"])
def test_kernels_match_plain(cuda, fn, order, dt_kind, size):
    _, flags, vel, grid, vec = _case(size, cuda, seed=sum(size) + order)
    dt = 0.9 if dt_kind == "float" else torch.tensor(0.9, device=cuda)
    kw = dict(order=order, clamp_mode=2)
    before, launched = _counts(), _launches()
    # no host sync on the kernels' path, dt on the card included
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = _driver(fn, flags, vel, grid, vec, dt, kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ref = _plain(fn, flags, vel, grid, vec, dt, kw)
    torch.cuda.synchronize()
    after = _counts()
    assert after == (before[0] + CALLS[fn], before[1])
    mac = fn == "mac"
    want = (CALLS[fn], CALLS[fn] * (order == 2), int(mac))
    assert tuple(b - a for a, b in zip(launched, _launches())) == want
    _same(got, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("name,size,kw", CPU_FORMS[2:],
                         ids=[f[0] for f in CPU_FORMS[2:]])
def test_other_forms_stay_plain_on_the_card(cuda, name, size, kw):
    _, flags, vel, grid, vec = _case(size, cuda)
    before, launched = _counts(), _launches()
    for fn in CALLS:
        _driver(fn, flags, vel, grid, vec, 1.0, kw)
    assert _launches() == launched
    assert _counts() == (before[0], before[1] + sum(CALLS.values()))


def _view(t):
    """``t`` as a non-contiguous view of a grid one cell wider each side
    in x, as a sharded stage's slab is a view of its extended slab."""
    pad = torch.zeros(t.shape[:-1] + (t.shape[-1] + 2,), dtype=t.dtype,
                      device=t.device)
    pad[..., 1:-1] = t
    return pad.narrow(-1, 1, t.shape[-1])


@pytest.mark.gpu
@pytest.mark.parametrize("fn", list(CALLS))
@pytest.mark.parametrize("order", [1, 2])
def test_views_take_the_kernels(cuda, fn, order):
    _, flags, vel, grid, vec = _case((24, 24, 24), cuda, seed=7 + order)
    flags, vel, grid, vec = (_view(t) for t in (flags, vel, grid, vec))
    assert not any(t.is_contiguous() for t in (flags, vel, grid, vec))
    kw = dict(order=order, clamp_mode=2)
    before, launched = _counts(), _launches()
    got = _driver(fn, flags, vel, grid, vec, 0.9, kw)
    ref = _plain(fn, flags, vel, grid, vec, 0.9, kw)
    torch.cuda.synchronize()
    assert _counts() == (before[0] + CALLS[fn], before[1])
    want = (CALLS[fn], CALLS[fn] * (order == 2), int(fn == "mac"))
    assert tuple(b - a for a, b in zip(launched, _launches())) == want
    _same(got, ref)
