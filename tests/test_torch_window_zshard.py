"""The z-sharded window advection and smoke step of mantaflow_tpu_torch vs
mantaflow_tpu.

``window_pass_zshard`` cuts the grids into the z-slabs of a ``ZMesh``,
haloes each slab's source by k+1 planes and runs the window kernel's z-slab
form once per shard (on the CPU its plain version, ``window_slab_plain``).
Fixtures: tests/test_advection_pallas.py's 32^3 z-shard fixture (smooth
displacements of up to 2.5 cells, an ok mask) and the bench smoke at 16^3
(tests/test_smoke_model.py's z-sharded Pallas step: 4 shards of 4 planes,
each slab exactly the k+1 = 4 planes its halo needs). Tolerances: the slab
form against the JAX package's window_pass (Pallas, interpret mode) to abs
1e-6, the JAX tests' own bound; against the port's one-domain window pass
exactly (the same taps, the same order); two smoke steps against the JAX
package's one-device Pallas step to abs 1e-5 (tests/test_smoke_model.py:
155-158) and against the port's one-domain step exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mantaflow_tpu.core.domain import Domain as JDomain
from mantaflow_tpu.core.shapes import Sphere as JSphere
from mantaflow_tpu.models import smoke as jsmoke
from mantaflow_tpu.ops import advection_pallas as jadvp
from mantaflow_tpu_torch.core import flags as fl
from mantaflow_tpu_torch.core.domain import Domain
from mantaflow_tpu_torch.core.shapes import Sphere
from mantaflow_tpu_torch.models import smoke as tsmoke
from mantaflow_tpu_torch.ops import advection_kernels as advk
from mantaflow_tpu_torch.parallel import sharding as shd

K = 3
RES = 32
SMOKE_RES = 16
BENCH = dict(buoyancy=(0.0, -6e-4, 0.0), vorticity_confinement=0.1,
             cg_accuracy=1e-3, window=3, adaptive_dt=True, cfl=3.0,
             dt_max=2.0, use_pallas=True)
SOURCE = dict(center=(SMOKE_RES / 2.0, SMOKE_RES * 0.1, SMOKE_RES / 2.0),
              radius=SMOKE_RES * 0.14)
OUTS = ("out", "min", "max", "have")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs test files in parallel worker processes; torch's own
    thread pool in each would oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fixture32():
    """tests/test_advection_pallas.py's z-shard fixture, and the JAX
    package's one-device window_pass on it (interpret mode)."""
    rng = np.random.RandomState(5)
    src = rng.rand(RES, RES, RES).astype(np.float32)
    zz, yy, xx = np.meshgrid(np.arange(RES), np.arange(RES), np.arange(RES),
                             indexing="ij")
    disp = np.stack([np.sin(yy * 0.2) * 2.5, np.cos(zz * 0.3) * 2.5,
                     np.sin(xx * 0.15) * 2.5]).astype(np.float32)
    pos = [(g + d).astype(np.float32) for g, d in ((xx, disp[0]),
                                                    (yy, disp[1]),
                                                    (zz, disp[2]))]
    ok = rng.rand(RES, RES, RES) > 0.3
    jdom = JDomain(size=(RES,) * 3)
    ref = jadvp.window_pass(jnp.asarray(src), *map(jnp.asarray, pos), jdom,
                            K, ok_mask=jnp.asarray(ok), want_minmax=True,
                            dyn=True)
    return dict(dom=Domain(size=(RES,) * 3), src=torch.tensor(src),
                pos=[torch.tensor(p) for p in pos], ok=torch.tensor(ok),
                ref=[np.asarray(r) for r in ref], jdom=jdom, np_src=src,
                np_pos=pos, np_ok=ok)


def _cpu_mesh(n):
    return shd.make_zmesh(n, devices=["cpu"])


@pytest.mark.parametrize("n", [2, 4, 8])
def test_slab_form_matches_jax_window_pass(fixture32, n):
    f = fixture32
    got = advk.window_pass_zshard(f["src"], *f["pos"], f["dom"], K,
                                  _cpu_mesh(n), ok_mask=f["ok"],
                                  want_minmax=True)
    for g, r, name in zip(got, f["ref"], OUTS):
        d = float(np.max(np.abs(g.numpy().astype(np.float32)
                                - r.astype(np.float32))))
        assert d < 1e-6, f"{name}: {d}"


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("ok,minmax", [(False, False), (False, True),
                                       (True, True)])
def test_slab_form_equals_one_domain_pass(fixture32, n, ok, minmax):
    """Each slab launch's plain version, from the haloed slab alone, equals
    the one-domain pass on the slab's planes bit for bit."""
    f = fixture32
    okm = f["ok"] if ok else None
    ref = advk.window_pass(f["src"], *f["pos"], f["dom"], K, ok_mask=okm,
                           want_minmax=minmax)
    got = advk.window_pass_zshard(f["src"], *f["pos"], f["dom"], K,
                                  _cpu_mesh(n), ok_mask=okm,
                                  want_minmax=minmax)
    if not minmax:
        got, ref = (got,), (ref,)
    for g, r, name in zip(got, ref, OUTS):
        assert torch.equal(g, r), name
    # a slab alone, haloed by hand: the end shards' source takes its end
    # plane, its mask zeros
    lz, h = RES // n, K + 1
    for i in (0, n - 1):
        lo, hi = i * lz - h, (i + 1) * lz + h
        idx = torch.arange(lo, hi).clamp(0, RES - 1)
        src_h = f["src"][idx]
        ok_h = None
        if okm is not None:
            inside = ((torch.arange(lo, hi) >= 0)
                      & (torch.arange(lo, hi) < RES))[:, None, None]
            ok_h = okm[idx] & inside
        one = advk.window_slab_plain(
            src_h, *(p[i * lz:(i + 1) * lz] for p in f["pos"]), f["dom"], K,
            i * lz, ok_h, minmax)
        for g, r in zip(one if minmax else (one,), ref):
            assert torch.equal(g, r[i * lz:(i + 1) * lz])


def test_slab_form_guards(fixture32):
    """A slab of fewer than k+1 planes cannot hold its halo
    (advection_pallas.py:545-546); a 2D domain has no z-slabs; a slab
    outside the domain is refused."""
    f = fixture32
    with pytest.raises(ValueError, match="< halo 4"):
        advk.window_pass_zshard(f["src"], *f["pos"], f["dom"], K,
                                _cpu_mesh(16))
    with pytest.raises(ValueError, match="3D domain"):
        advk.window_pass_zshard(f["src"][:1], *(p[:1] for p in f["pos"]),
                                Domain(size=(RES, RES, 1), dim=2), K,
                                _cpu_mesh(1))
    with pytest.raises(ValueError, match="outside the domain"):
        advk.window_pass_slab(f["src"][:16], *(p[:8] for p in f["pos"]),
                              f["dom"], K, 28)


@pytest.mark.parametrize("h", [1, 4])
def test_halo_z_edge_repeats_end_planes(h):
    """halo_z with edge=True: the neighbours' planes inside, the end plane
    repeated past the domain's ends (zeros without it)."""
    whole = torch.arange(8 * 3 * 2, dtype=torch.float32).reshape(8, 3, 2)
    slabs = shd.scatter_z(whole, _cpu_mesh(2), 0)
    for edge in (False, True):
        lo_end, hi_end = ((whole[:1], whole[-1:]) if edge
                          else (torch.zeros(1, 3, 2),) * 2)
        a, b = shd.halo_z(slabs, h, 0, edge=edge)
        assert torch.equal(a, torch.cat([lo_end.expand(h, 3, 2),
                                         whole[:4 + h]]))
        assert torch.equal(b, torch.cat([whole[4 - h:],
                                         hi_end.expand(h, 3, 2)]))


def _velocity(dom, seed, scale=0.6):
    rng = np.random.RandomState(seed)
    return torch.tensor((rng.randn(3, *dom.shape) * scale).astype(np.float32))


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("outflow", [False, True])
def test_advection_with_zshard_equals_one_domain(order, outflow):
    """advect_real_pl and advect_mac_pl with zshard (4 shards of 4 planes)
    against without, exactly: order 1 and 2, with open bounds (the outflow
    extrapolation) and without."""
    dom = Domain(size=(SMOKE_RES,) * 3)
    flags = fl.fill_grid(fl.init_domain(dom, 1, device="cpu"), fl.TypeFluid)
    if outflow:
        flags = fl.set_open_bound(flags, dom, 1, "yY")
    vel = _velocity(dom, 11)
    dens = torch.tensor(np.random.RandomState(12).rand(*dom.shape)
                        .astype(np.float32))
    dt = torch.tensor(1.7)
    mesh = _cpu_mesh(4)
    for zshard in (None, mesh):
        got = (advk.advect_real_pl(flags, vel, dens, dt, dom, K, order=order,
                                   zshard=zshard),
               advk.advect_mac_pl(flags, vel, vel, dt, dom, K, order=order,
                                  has_outflow=outflow, zshard=zshard))
        if zshard is None:
            ref = got
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert not torch.equal(ref[0], dens)


def test_advection_refuses_zshard_in_2d():
    dom = Domain(size=(16, 16, 1), dim=2)
    flags = fl.fill_grid(fl.init_domain(dom, 1, device="cpu"), fl.TypeFluid)
    vel = torch.zeros((3,) + dom.shape)
    with pytest.raises(ValueError, match="3D domain"):
        advk.advect_real_pl(flags, vel, vel[0], 1.0, dom, K,
                            zshard=_cpu_mesh(2))
    with pytest.raises(ValueError, match="3D domain"):
        advk.advect_mac_pl(flags, vel, vel, 1.0, dom, K, zshard=_cpu_mesh(2))


def _jax_state_numpy(st):
    return {k: np.asarray(getattr(st, k)) for k in ("vel", "density",
                                                    "pressure")}


@pytest.fixture(scope="module")
def smoke_runs():
    """Two bench smoke steps at 16^3: the JAX package's one-device Pallas
    step, and the port's one-domain and z-sharded (4 shards) steps."""
    jdom = JDomain(size=(SMOKE_RES,) * 3)
    jp = jsmoke.SmokeParams(**BENCH)
    jst = jsmoke.make_smoke_state(jdom, jp, source_shape=JSphere(**SOURCE))
    step = jax.jit(lambda s: jsmoke.smoke_step(s, jdom, jp))
    jst = step(step(jst))
    dom = Domain(size=(SMOKE_RES,) * 3)
    tp = tsmoke.SmokeParams(**BENCH)
    st0 = tsmoke.make_smoke_state(dom, tp, source_shape=Sphere(**SOURCE),
                                  device="cpu")
    mesh = _cpu_mesh(4)
    one, sh = st0, st0
    calls = []
    slab = advk.window_pass_slab

    def counted(*a, **k):
        calls.append(a[6])
        return slab(*a, **k)
    advk.window_pass_slab = counted
    try:
        for _ in range(2):
            one = tsmoke.smoke_step(one, dom, tp)
            sh = tsmoke.smoke_step(sh, dom, tp, zshard=mesh)
    finally:
        advk.window_pass_slab = slab
    return dict(jax=_jax_state_numpy(jst), one=one, sh=sh, calls=calls,
                dom=dom, tp=tp, st0=st0)


@pytest.mark.parametrize("field", ["density", "vel", "pressure"])
def test_zshard_smoke_steps_match_reference(smoke_runs, field):
    got = getattr(smoke_runs["sh"], field).numpy()
    np.testing.assert_allclose(got, smoke_runs["jax"][field], atol=1e-5,
                               rtol=0)


def test_zshard_smoke_steps_equal_one_domain(smoke_runs):
    one, sh = smoke_runs["one"], smoke_runs["sh"]
    for k in ("flags", "vel", "density", "pressure", "cg_iters"):
        assert torch.equal(getattr(sh, k), getattr(one, k)), k
    for k in ("dt", "time_total", "count"):
        assert torch.equal(getattr(sh.ts, k), getattr(one.ts, k)), k
    # 8 passes a step, each one slab call per shard, at the shards' offsets
    assert smoke_runs["calls"] == [0, 4, 8, 12] * 16


def test_smoke_step_refuses_zshard_off_the_pallas_window_path(smoke_runs):
    dom, st0, tp = smoke_runs["dom"], smoke_runs["st0"], smoke_runs["tp"]
    for p in (dataclasses.replace(tp, window=0),
              dataclasses.replace(tp, use_pallas=False)):
        with pytest.raises(ValueError, match="zshard needs"):
            tsmoke.smoke_step(st0, dom, p, zshard=_cpu_mesh(4))


@pytest.mark.slow
def test_slab_form_matches_jax_zshard_kernel_on_mesh(fixture32):
    """Against the JAX package's own window_pass_zshard under shard_map on
    4 and 8 devices of the CPU mesh (its ppermute halo exchange)."""
    from jax.sharding import Mesh, PartitionSpec as P
    f = fixture32
    for n in (4, 8):
        mesh = Mesh(np.array(jax.devices()[:n]), ("z",))
        fn = jax.shard_map(
            lambda s, a, b, c, o, n=n: jadvp.window_pass_zshard(
                s, a, b, c, f["jdom"], K, "z", n, ok_mask=o,
                want_minmax=True),
            mesh=mesh, in_specs=(P("z"),) * 5, out_specs=(P("z"),) * 4,
            check_vma=False)
        ref = jax.jit(fn)(jnp.asarray(f["np_src"]),
                          *map(jnp.asarray, f["np_pos"]),
                          jnp.asarray(f["np_ok"]))
        got = advk.window_pass_zshard(f["src"], *f["pos"], f["dom"], K,
                                      _cpu_mesh(n), ok_mask=f["ok"],
                                      want_minmax=True)
        for g, r, name in zip(got, ref, OUTS):
            d = float(np.max(np.abs(g.numpy().astype(np.float32)
                                    - np.asarray(r).astype(np.float32))))
            assert d < 1e-6, f"{n} shards, {name}: {d}"
