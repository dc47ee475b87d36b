"""The port's multi-device API (``mantaflow_tpu_torch/parallel``) against
the JAX package's ``parallel/sharding.py`` and its one-device steps.

- ``make_mesh``, the partition specs and ``pad_to_multiple`` read as the
  JAX package's (its meshes over the conftest's 8 CPU devices);
- the smoke step on a state from ``shard_smoke_state`` (window 2, window 3
  with ``use_pallas``, the exact gathers) over 4 and 8 CPU shards at 16^3:
  after 2 steps within 1e-5 of the JAX package's one-device
  ``smoke_step`` (tests/test_smoke_model.py's bound), within 1e-6 of the
  port's one-device step (the solve's dots sum in another order), and
  bit for bit itself when run again;
- the flat FLIP and APIC steps on a state from ``shard_flip_state`` with
  tests/test_flip_sharded.py:19-56's sphere obstacle and ghost fluid at
  32^3: after 3 steps flags and the particle count equal to the JAX
  package's one-device ``flip_step``, positions and phi within its 2e-5,
  no particle inside the sphere; the grids and particle velocities within
  1e-4 (the bound tests/test_torch_flat_flip.py holds the one-device
  port's grids to: the ghost-fluid solve to 1e-4 moves by up to 2.8e-5
  when its dots sum in another order); 8 shards within 2e-5 of 4, and a
  run repeated bit for bit;
- the slab CG against the port's one-device plain CG, the layout (z
  only, any z extent in GSPMD's padded layout for grid states, the
  bucket state's guards), multigrid and uneven slabs against one device
  (``tests/test_torch_sharding_rest.py`` covers them in full) and the dry
  run (``parallel/dryrun.py``) at 4 shards with its five OK lines.

Compared against the JAX package's one-device step, never its 8-device
SPMD compile, which takes minutes (tests/conftest.py marks those slow).
"""

import numpy as np
import pytest
import torch

import jax
from mantaflow_tpu.core.domain import Domain as JDomain
from mantaflow_tpu.core.shapes import Sphere as JSphere
from mantaflow_tpu.models import flip as jflip
from mantaflow_tpu.models import smoke as jsmoke
from mantaflow_tpu.parallel import sharding as jshd
from mantaflow_tpu_torch.core import flags as fl
from mantaflow_tpu_torch.core.domain import Domain
from mantaflow_tpu_torch.core.shapes import Sphere
from mantaflow_tpu_torch.models import flip
from mantaflow_tpu_torch.models import smoke
from mantaflow_tpu_torch.ops import pressure as prs
from mantaflow_tpu_torch.parallel import dryrun
from mantaflow_tpu_torch.parallel import sharding as shd
from mantaflow_tpu_torch.parallel.slabs import per_slab, slab_stage


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(n, axes=("z", "y")):
    return shd.make_mesh(n, axes, devices=["cpu"])


def _close(a, b, tol, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, what
    err = float(np.abs(a - b).max())
    assert err <= tol, f"{what}: {err} > {tol}"


# -- the mesh, the specs ------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_make_mesh_shape_matches_reference(n):
    jm = jshd.make_mesh(n)
    m = _mesh(n)
    assert m.shape == dict(jm.shape)
    assert m.axis_names == tuple(jm.axis_names)
    assert m.n == n and m.devices == (torch.device("cpu"),)
    m1, jm1 = _mesh(n, ("z",)), jshd.make_mesh(n, ("z",))
    assert m1.shape == dict(jm1.shape)
    for fn in ("scalar_grid_spec", "mac_grid_spec", "particle_spec"):
        for a, b in ((m, jm), (m1, jm1)):
            assert getattr(shd, fn)(a) == tuple(getattr(jshd, fn)(b)), fn


def test_pad_to_multiple_matches_reference():
    for n in range(0, 40):
        for m in (1, 3, 8):
            assert shd.pad_to_multiple(n, m) == jshd.pad_to_multiple(n, m)


def test_mesh_takes_the_zshard_paths_and_its_guards():
    """A bucket state's slabs (``planes``) keep the JAX package's guards; a
    grid state takes any extent in GSPMD's padded layout (``spans``)."""
    m = _mesh(8)
    assert isinstance(m, shd.ZMesh) and m.device(9) == torch.device("cpu")
    with pytest.raises(ValueError, match="not divisible"):
        m.planes(12)
    with pytest.raises(ValueError, match="1 plane"):
        m.planes(8)
    assert m.spans(12) == [(0, 2), (2, 2), (4, 2), (6, 2), (8, 2), (10, 2),
                           (12, 0), (12, 0)]
    assert m.spans(8) == [(i, 1) for i in range(8)]
    assert _mesh(3).spans(128) == [(0, 43), (43, 43), (86, 42)]
    whole = torch.arange(12 * 2 * 3, dtype=torch.float32).reshape(12, 2, 3)
    parts = shd.scatter_z(whole, m, 0)
    assert [p.shape[0] for p in parts] == [2] * 6 + [0, 0]
    assert torch.equal(shd.gather_z(parts, m, 0), whole)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            shd.make_mesh(4)


@pytest.mark.parametrize("edge", [False, True])
def test_deep_halo_continues_into_the_next_shards(edge):
    """halo_z deeper than a slab: the planes of the shards beyond, then the
    domain's end (zeros, or with ``edge`` the end plane)."""
    rng = np.random.RandomState(5)
    whole = torch.tensor(rng.randn(3, 8, 5, 4).astype(np.float32))
    slabs = shd.scatter_z(whole, _mesh(4), 1)
    end = ((whole.narrow(1, 0, 1), whole.narrow(1, 7, 1)) if edge else
           (torch.zeros_like(whole.narrow(1, 0, 1)),) * 2)
    padded = torch.cat([end[0].expand(3, 5, 5, 4), whole,
                        end[1].expand(3, 5, 5, 4)], 1)
    for i, e in enumerate(shd.halo_z(slabs, 5, 1, edge=edge)):
        assert torch.equal(e, padded.narrow(1, 2 * i, 12))


def test_slab_stage_stops_at_the_domain_ends():
    """A stage whose index masks mark the domain's end planes: the same on
    nonzero boundary planes as on the whole grid, at every reach."""
    rng = np.random.RandomState(2)
    dom = Domain(size=(6, 5, 16), dim=3)
    vel = torch.tensor(rng.randn(3, 16, 5, 6).astype(np.float32))
    flags = torch.tensor(rng.choice([1, 2, 4], size=(16, 5, 6)).astype(
        np.int32))
    from mantaflow_tpu_torch.ops import extforces as ext
    ref = ext.vorticity_confinement(ext.set_wall_bcs(flags, vel, dom),
                                    flags, dom, 0.3)
    for n in (2, 4, 8):
        mesh = _mesh(n)
        v = slab_stage(lambda sd, f, v_: ext.set_wall_bcs(f, v_, sd), 1, dom,
                       shd.Slabs.of(flags, mesh), shd.Slabs.of(vel, mesh))
        v = slab_stage(lambda sd, v_, f: ext.vorticity_confinement(
            v_, f, sd, 0.3), 4, dom, v, shd.Slabs.of(flags, mesh))
        assert torch.equal(v.whole(), ref), n


# -- the smoke ----------------------------------------------------------------

SMOKE = {"window2": dict(window=2),
         "window3_pallas": dict(window=3, use_pallas=True),
         "exact": dict(window=0)}


@pytest.fixture(scope="module")
def smoke_runs():
    """Per configuration: the JAX package's 2 one-device steps, the port's,
    and the port's start state."""
    res = 16
    out = {}
    for name, kw in SMOKE.items():
        src = dict(center=(res / 2, res * 0.15, res / 2), radius=res * 0.15)
        jdom, dom = JDomain(size=(res,) * 3, dim=3), Domain(size=(res,) * 3,
                                                            dim=3)
        jp = jsmoke.SmokeParams(buoyancy=(0.0, -6e-4, 0.0), **kw)
        tp = smoke.SmokeParams(buoyancy=(0.0, -6e-4, 0.0), **kw)
        jst = jsmoke.make_smoke_state(jdom, jp, source_shape=JSphere(**src))
        for _ in range(2):
            jst = jsmoke.smoke_step(jst, jdom, jp)
        st = smoke.make_smoke_state(dom, tp, source_shape=Sphere(**src),
                                    device="cpu")
        out[name] = dict(dom=dom, tp=tp, st=st, jax=jst,
                         one=smoke.smoke_run(st, dom, tp, 2))
    return out


@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("name", sorted(SMOKE))
def test_smoke_on_slabs_matches_reference(smoke_runs, name, n):
    r = smoke_runs[name]
    sst = shd.shard_smoke_state(r["st"], _mesh(n))
    assert all(p.shape[0] == 16 // n for p in sst.density.parts)
    got = smoke.smoke_run(sst, r["dom"], r["tp"], 2)
    again = smoke.smoke_run(sst, r["dom"], r["tp"], 2)
    whole = shd.unshard_smoke_state(got)
    for k in ("vel", "density", "pressure"):
        grid = getattr(whole, k)
        _close(grid, np.asarray(getattr(r["jax"], k)), 1e-5, f"{k} vs JAX")
        _close(grid, getattr(r["one"], k), 1e-6, f"{k} vs one device")
        assert torch.equal(getattr(again, k).whole(), grid), k
    assert torch.equal(whole.flags, r["one"].flags)
    assert int(got.ts.count) == 2
    assert float(whole.density.max()) > 0.1


def test_smoke_step_jit_and_the_sharded_guards(smoke_runs):
    r = smoke_runs["exact"]
    step = smoke.smoke_step_jit(r["dom"], r["tp"])
    assert torch.equal(step(step(r["st"])).vel, r["one"].vel)
    sst = shd.shard_smoke_state(r["st"], _mesh(4))
    with pytest.raises(ValueError, match="another mesh"):
        smoke.smoke_step(sst, r["dom"], r["tp"], zshard=_mesh(2))
    with pytest.raises(ValueError, match="sharded already"):
        shd.shard_smoke_state(sst, _mesh(4))
    # multigrid on the slabs (its hierarchy built there) and a z extent
    # the mesh does not divide: the one-device step's results
    mg = smoke.SmokeParams(preconditioner=prs.PcMGStatic)
    got = shd.unshard_smoke_state(smoke.smoke_run(sst, r["dom"], mg, 2))
    ref = smoke.smoke_run(r["st"], r["dom"], mg, 2)
    for k in ("vel", "pressure"):
        _close(getattr(got, k), getattr(ref, k), 1e-6, f"multigrid {k}")
    three = shd.shard_smoke_state(r["st"], _mesh(3))
    assert [p.shape[0] for p in three.density.parts] == [6, 6, 4]
    got = shd.unshard_smoke_state(smoke.smoke_run(three, r["dom"], r["tp"],
                                                  2))
    for k in ("vel", "density", "pressure"):
        _close(getattr(got, k), getattr(r["one"], k), 1e-6, f"3 shards {k}")


def test_slab_cg_matches_the_plain_cg():
    """cg_slabs on a ghost-fluid system with an obstacle against cg_loop
    (the port's one-device plain CG): the same iterations, the pressure
    within 1e-6 (the dots sum per shard)."""
    res = 16
    dom = Domain(size=(res,) * 3, dim=3)
    tp = flip.FlipParams(gravity=(0.0, -0.003, 0.0), ghost_fluid=True)
    st = flip.flip_step(flip.make_dam_state(
        dom, tp, obstacle=Sphere(center=(11.2, 4.8, 8.0), radius=2.4),
        device="cpu"), dom, tp)
    vel = torch.tensor(np.random.RandomState(4).randn(
        3, res, res, res).astype(np.float32) * 0.01)
    rhs = prs.make_rhs(st.flags, vel, dom, phi=st.phi)
    sten = prs.make_laplace_stencil(st.flags, dom, phi=st.phi)
    p1, i1, _ = prs.cg_loop(rhs, fl.is_fluid(st.flags), dom, sten, 1e-5, 500)
    mesh = _mesh(4)
    F, P = shd.Slabs.of(st.flags, mesh), shd.Slabs.of(st.phi, mesh)
    R = slab_stage(lambda sd, f, v, ph: prs.make_rhs(f, v, sd, phi=ph), 1,
                   dom, F, shd.Slabs.of(vel, mesh), P)
    S = slab_stage(lambda sd, f, ph: prs.make_laplace_stencil(f, sd, phi=ph),
                   1, dom, F, P)
    assert torch.equal(R.whole(), rhs)
    assert all(torch.equal(a.whole(), b) for a, b in zip(S, sten))
    p2, i2, _ = prs.cg_slabs(R, per_slab(fl.is_fluid, F), S, dom, 1e-5, 500)
    assert int(i2) == int(i1) > 5
    _close(p2.whole(), p1, 1e-6, "pressure")


# -- the flat FLIP ------------------------------------------------------------

@pytest.fixture(scope="module")
def flip_runs():
    """tests/test_flip_sharded.py:19-56's set-up, FLIP and APIC: the JAX
    package's 3 one-device steps, the port's start state."""
    res = 32
    out = {}
    for apic in (False, True):
        kw = dict(gravity=(0.0, -0.003, 0.0), ghost_fluid=True,
                  cg_accuracy=1e-4, apic=apic)
        obs = dict(center=(res * 0.7, res * 0.3, res * 0.5),
                   radius=res * 0.15)
        jdom, dom = JDomain(size=(res,) * 3, dim=3), Domain(size=(res,) * 3,
                                                            dim=3)
        jp, tp = jflip.FlipParams(**kw), flip.FlipParams(**kw)
        jst = jflip.make_dam_state(jdom, jp, discretization=2,
                                   obstacle=JSphere(**obs))
        step = jax.jit(lambda s, d=jdom, p=jp: jflip.flip_step(s, d, p))
        for _ in range(3):
            jst = step(jst)
        out["apic" if apic else "flip"] = dict(
            dom=dom, tp=tp, res=res, jax=jst,
            st=flip.make_dam_state(dom, tp, discretization=2,
                                   obstacle=Sphere(**obs), device="cpu"))
    return out


@pytest.mark.parametrize("name", ["flip", "apic"])
def test_flat_flip_on_slabs_matches_reference(flip_runs, name):
    r = flip_runs[name]
    res, jst = r["res"], r["jax"]
    runs = {}
    for n in (4, 8):
        sst = shd.shard_flip_state(r["st"], _mesh(n))
        assert len(sst.parts.pos.parts) == n
        runs[n] = flip.flip_run(sst, r["dom"], r["tp"], 3)
    got = shd.unshard_flip_state(runs[4])
    assert torch.equal(got.flags, torch.from_numpy(np.array(jst.flags)))
    assert int(got.parts.count) == int(jst.parts.count)
    assert torch.equal(got.parts.flags,
                       torch.from_numpy(np.array(jst.parts.flags)))
    _close(got.parts.pos, np.asarray(jst.parts.pos), 2e-5, "pos")
    _close(got.phi, np.asarray(jst.phi), 2e-5, "phi")
    for k in ("vel", "vel_old", "pressure", "pvel", "cpx"):
        _close(getattr(got, k), np.asarray(getattr(jst, k)), 1e-4, k)
    # 8 shards against 4: the p2g's partial sums add in another order
    eight = shd.unshard_flip_state(runs[8])
    assert torch.equal(eight.flags, got.flags)
    for k in ("vel", "phi", "pvel"):
        _close(getattr(eight, k), getattr(got, k), 2e-5, f"{k} 8 vs 4")
    again = flip.flip_run(shd.shard_flip_state(r["st"], _mesh(4)), r["dom"],
                          r["tp"], 3)
    for k in ("vel", "phi", "pressure"):
        assert torch.equal(getattr(again, k).whole(), getattr(got, k)), k
    assert torch.equal(again.parts.pos.whole(), got.parts.pos)
    # the obstacle takes part: obstacle cells, no particle in the sphere
    assert int((got.flags & fl.TypeObstacle != 0).sum()) > 0
    p, act = got.parts.pos.numpy(), got.parts.active_mask().numpy()
    d = np.sqrt((p[:, 0] - res * 0.7) ** 2 + (p[:, 1] - res * 0.3) ** 2
                + (p[:, 2] - res * 0.5) ** 2)
    assert int((d[act] < res * 0.15 - 1.5).sum()) == 0


# -- the dry run --------------------------------------------------------------

def test_dryrun_runs_its_five_checks():
    lines = dryrun.dryrun(4, "cpu")
    assert [ln.split(" OK")[0] for ln in lines] == [
        "dryrun_multichip smoke", "dryrun_multichip smoke-pallas-zshard",
        "dryrun_multichip flip", "dryrun_multichip flip-bucketed",
        "dryrun_multichip flip-bucketed-pallas-zshard"]
    assert "mesh={'z': 2, 'y': 2}" in lines[0]
