"""The z-sharded bucketed FLIP step of mantaflow_tpu_torch vs mantaflow_tpu.

The port's z mesh runs in one process: shards are z-slabs of the bucket
fields, on the CPU all on the CPU, 8 of them at 16^3 as the JAX package's
tests run its 8-device CPU mesh. Fixtures and tolerances are those of
tests/test_flip_sharded.py:
- the rebin of the boundary-crossing fixture (:145-162) at 2, 4 and 8
  shards against JAX ``flip_bucket.rebin``: bitwise, ``dropped`` included;
- the fused transfer against JAX ``p2g_mac`` and
  ``union_levelset_bucketed``: abs 1e-5;
- the advection with the blend against the JAX CPU branch: abs 1e-6;
- two steps of the 16^3 dam with a sphere obstacle (:98-130) against JAX's
  one-device ``flip_step_bucketed``: vel, phi and positions abs 2e-5, flags
  exact, counts equal, nothing dropped; and against the port's one-device
  step exactly.
The case against the JAX package's own sharded kernels on its 8-device
mesh is slow (its shard_map programs take minutes to compile here).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mantaflow_tpu.core.domain import Domain as JDomain
from mantaflow_tpu.core.shapes import Sphere as JSphere
from mantaflow_tpu.models import flip as jflip
from mantaflow_tpu.ops import flip_bucket as jfb
from mantaflow_tpu_torch.core import flags as fl
from mantaflow_tpu_torch.core.domain import Domain
from mantaflow_tpu_torch.core.shapes import Sphere
from mantaflow_tpu_torch.models import flip as tflip
from mantaflow_tpu_torch.ops import advect_bucket_kernels as advk
from mantaflow_tpu_torch.ops import flip_bucket as fb
from mantaflow_tpu_torch.ops import p2g_kernels as p2gk
from mantaflow_tpu_torch.ops import rebin_kernels as rbk
from mantaflow_tpu_torch.parallel import sharding as shd

RES = 16
FIELDS = ("px", "py", "pz", "vx", "vy", "vz", "valid")
BUCKETS = FIELDS + ("dropped",)
TS = ("dt", "time_total", "time_per_frame", "frame", "lock_dt", "count")
# tests/test_flip_sharded.py:100-105
OBSTACLE_DAM = dict(gravity=(0.0, -0.003, 0.0), ghost_fluid=True,
                    cg_accuracy=1e-4)
SPHERE = dict(center=(RES * 0.7, RES * 0.3, RES * 0.5), radius=RES * 0.2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs test files in parallel worker processes; torch's own
    thread pool in each would oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpu_mesh(n):
    return shd.make_zmesh(n, devices=["cpu"])


def _to_torch_buckets(jbk):
    return fb.Buckets(**{k: torch.tensor(np.asarray(getattr(jbk, k)))
                         for k in BUCKETS})


def _jax_to_numpy(st):
    d = {k: np.asarray(getattr(st, k))
         for k in ("flags", "vel", "vel_old", "pressure", "phi")}
    d["buckets"] = {k: np.asarray(getattr(st.buckets, k)) for k in BUCKETS}
    d["ts"] = {k: np.asarray(getattr(st.ts, k)) for k in TS}
    d["blend_pending"] = np.asarray(st.blend_pending)
    return d


@pytest.fixture(scope="module")
def crossing():
    """tests/test_flip_sharded.py:145-162: the 16^3 dam at PPC 12 with
    every particle displaced by up to 0.9 cells (seed 7), many across slab
    faces; the JAX rebin of it (a few cells overflow) and its transfer."""
    jdom = JDomain(size=(RES,) * 3)
    st = jflip.make_dam_state_bucketed(
        jdom, jflip.FlipParams(gravity=(0.0, -0.003, 0.0), ghost_fluid=True),
        discretization=2, ppc=12)
    bk = st.buckets
    d = np.random.default_rng(7).uniform(-0.9, 0.9, size=(3,)
                                         + bk.px.shape).astype(np.float32)
    bk = dataclasses.replace(bk, **{
        f: jnp.clip(getattr(bk, f) + jnp.where(bk.valid, d[i], 0.0), 1.01,
                    RES - 1.01) for i, f in enumerate(("px", "py", "pz"))})
    ref = jax.jit(lambda b: jfb.rebin(b, jdom))(bk)
    vel, weight, phi = jax.jit(lambda b: jfb.p2g_mac(b, jdom) + (
        jfb.union_levelset_bucketed(b, jdom, 1.0),))(ref)
    return dict(jdom=jdom, jbk=bk, ref=ref, bk=_to_torch_buckets(bk),
                transfer=[np.asarray(a) for a in (vel, weight, phi)])


@pytest.mark.parametrize("h", [1, 2])
@pytest.mark.parametrize("dim", [0, 1])
def test_halo_z_gives_neighbour_planes_and_zero_ends(h, dim):
    rng = np.random.RandomState(3)
    whole = torch.tensor(rng.randn(3, 8, 5, 4).astype(np.float32))
    whole = whole if dim == 1 else whole[0]
    mesh = _cpu_mesh(4)
    slabs = shd.scatter_z(whole, mesh, dim)
    assert all(s.is_contiguous() and s.shape[dim] == 2 for s in slabs)
    ext = shd.halo_z(slabs, h, dim)
    padded = torch.cat([torch.zeros_like(whole.narrow(dim, 0, h)), whole,
                        torch.zeros_like(whole.narrow(dim, 0, h))], dim)
    for i, e in enumerate(ext):
        assert torch.equal(e, padded.narrow(dim, 2 * i, 2 + 2 * h))
    assert torch.equal(shd.gather_z(slabs, mesh, dim), whole)
    valid = shd.halo_z([s > 0 for s in slabs], h, dim)
    assert valid[0].dtype == torch.bool
    assert not bool(valid[0].narrow(dim, 0, h).any())


def test_zmesh_guards_and_psum():
    mesh = _cpu_mesh(4)
    assert mesh.lead == torch.device("cpu")
    assert mesh.device(5) == torch.device("cpu") and mesh.planes(16) == 4
    with pytest.raises(ValueError, match="not divisible"):
        mesh.planes(10)
    with pytest.raises(ValueError, match="1 plane"):
        _cpu_mesh(8).planes(8)
    with pytest.raises(ValueError, match="one type"):
        shd.make_zmesh(2, devices=["cpu", "meta"])
    total = shd.psum([torch.tensor(i, dtype=torch.int32) for i in range(4)],
                     mesh.lead)
    assert int(total) == 6 and total.dim() == 0


def test_make_zmesh_needs_cuda_or_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        shd.make_zmesh(4)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_rebin_zshard_matches_reference_bitwise(crossing, n):
    mesh = _cpu_mesh(n)
    got = shd.unshard_buckets(
        rbk.rebin_zshard(shd.shard_buckets(crossing["bk"], mesh),
                         Domain(size=(RES,) * 3), mesh))
    ref = crossing["ref"]
    assert int(got.dropped) == int(ref.dropped) > 0
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)),
                                      err_msg=f)


def test_slab_xy_pass_parks_at_global_centres(crossing):
    """An x pass on the top slab parks its empty slots at global z
    centres, as flip_bucket_pallas._park_invalid(..., z_base) does."""
    mesh = _cpu_mesh(4)
    top = shd.shard_buckets(crossing["bk"], mesh).slabs[3]
    out = rbk.rebin_pass(top, Domain(size=(RES, RES, 4)), 0, z_base=12)
    z = torch.arange(4 * RES * RES) // (RES * RES) + 12
    assert torch.equal(out.pz[~out.valid],
                       (z.to(torch.float32) + 0.5).expand_as(out.pz)
                       [~out.valid])
    with pytest.raises(ValueError, match="halo"):
        rbk.rebin_pass(top, Domain(size=(RES, RES, 4)), 2, z_base=12)


def test_zpass_halo_counts_each_slab_overflow(crossing):
    """The z pass of each slab adds its own overflow; the slabs' sum is
    the one-domain z pass's."""
    mesh = _cpu_mesh(8)
    dom = Domain(size=(RES,) * 3)
    whole = fb._rebin_axis(fb._rebin_axis(crossing["bk"], dom, 0), dom, 1)
    one = fb._rebin_axis(whole, dom, 2)
    sbk = shd.shard_buckets(whole, mesh)
    local = Domain(size=(RES, RES, 2))
    drops = [int(rbk.rebin_zpass_halo(e, local, 2 * i, RES).dropped)
             for i, e in enumerate(rbk.halo_buckets(sbk.slabs, 1, local))]
    assert sum(drops) == int(one.dropped) - int(whole.dropped) > 0


def test_zshard_transfer_matches_reference(crossing):
    mesh = _cpu_mesh(8)
    dom = Domain(size=(RES,) * 3)
    sbk = shd.shard_buckets(_to_torch_buckets(crossing["ref"]), mesh)
    outs = p2gk.p2g_union_zshard(sbk, dom, 1.0, mesh)
    for got, ref in zip(outs, crossing["transfer"]):
        got = shd.gather_z(got, mesh, ref.ndim - 3).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-5)
    with pytest.raises(ValueError, match="rw == 1"):
        p2gk.p2g_union_zshard(sbk, dom, 2.5, mesh)


@pytest.fixture(scope="module")
def dam_steps():
    """Two steps of the 16^3 dam with a sphere obstacle
    (tests/test_flip_sharded.py:98-130): JAX's one-device step, the port's
    one-device step and the port's z-sharded step at 8 shards."""
    jdom = JDomain(size=(RES,) * 3)
    jp = jflip.FlipParams(**OBSTACLE_DAM)
    jst = jflip.make_dam_state_bucketed(jdom, jp, discretization=2,
                                        obstacle=JSphere(**SPHERE), ppc=14)
    init = _jax_to_numpy(jst)
    step = jax.jit(lambda s: jflip.flip_step_bucketed(s, jdom, jp))
    jsteps = [jst]
    for _ in range(2):
        jsteps.append(step(jsteps[-1]))

    dom = Domain(size=(RES,) * 3)
    tp = tflip.FlipParams(**OBSTACLE_DAM)
    mesh = _cpu_mesh(8)
    one = tflip.state_from_numpy(init, device="cpu")
    sh = shd.shard_flip_bucket_state(one, mesh)
    for _ in range(2):
        one = tflip.flip_step_bucketed(one, dom, tp)
        sh = tflip.flip_step_bucketed(sh, dom, tp, zshard=mesh)
    return dict(init=init, jsteps=jsteps, jax=_jax_to_numpy(jsteps[-1]),
                jdom=jdom, jp=jp, dom=dom, tp=tp, mesh=mesh, one=one, sh=sh,
                torch=tflip.state_to_numpy(sh))


@pytest.mark.parametrize("ring_only", [False, True])
def test_zshard_advection_matches_reference(dam_steps, ring_only):
    """The z-sharded advection with the blend of the first step's pending
    velocities, against the JAX CPU branch (flip_update_bucketed, then
    advect_bucketed)."""
    jst = dam_steps["jsteps"][1]
    jdom = dam_steps["jdom"]
    blended = jfb.flip_update_bucketed(jst.buckets, jst.vel, jst.vel_old,
                                       0.97, jdom)
    jref = jfb.advect_bucketed(blended, jst.flags, jst.vel, jst.ts.dt, jdom,
                               2, stop_in_obstacle=True,
                               ring_only=ring_only)
    d = _jax_to_numpy(jst)
    st = shd.shard_flip_bucket_state(tflip.state_from_numpy(d, device="cpu"),
                                     dam_steps["mesh"])
    got = advk.advect_blend_zshard(st.buckets, st.flags, st.vel, st.vel_old,
                                   st.ts.dt, st.blend_pending, 0.97,
                                   dam_steps["dom"], dam_steps["mesh"], 2,
                                   ring_only=ring_only)
    got = shd.unshard_buckets(got)
    for f in FIELDS[:6]:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(jref, f)), atol=1e-6,
                                   err_msg=f)


@pytest.mark.parametrize("field", ["vel", "phi"])
def test_zshard_steps_grids_match_reference(dam_steps, field):
    np.testing.assert_allclose(dam_steps["torch"][field],
                               dam_steps["jax"][field], atol=2e-5)


def test_zshard_steps_particles_match_reference(dam_steps):
    got, ref = dam_steps["torch"], dam_steps["jax"]
    np.testing.assert_array_equal(got["flags"], ref["flags"])
    assert (got["flags"] & fl.TypeObstacle).sum() > 0
    assert int(got["buckets"]["dropped"]) == 0
    assert got["buckets"]["valid"].sum() == ref["buckets"]["valid"].sum() \
        == dam_steps["init"]["buckets"]["valid"].sum()
    for f in ("px", "py", "pz"):
        np.testing.assert_allclose(got["buckets"][f], ref["buckets"][f],
                                   atol=2e-5, err_msg=f)
    for k in TS:
        np.testing.assert_allclose(got["ts"][k], ref["ts"][k], atol=1e-6)


def test_zshard_steps_equal_one_device_steps(dam_steps):
    got, one = dam_steps["torch"], tflip.state_to_numpy(dam_steps["one"])
    for k in ("flags", "vel", "vel_old", "pressure", "phi"):
        np.testing.assert_array_equal(got[k], one[k], err_msg=k)
    for k in BUCKETS:
        np.testing.assert_array_equal(got["buckets"][k], one["buckets"][k],
                                      err_msg=k)
    sh = dam_steps["sh"]
    assert isinstance(sh.buckets, shd.ShardedBuckets)
    assert all(s.px.is_contiguous() and s.ncells == 2 * RES * RES
               for s in sh.buckets.slabs)
    assert int(sh.buckets.count()) == int(dam_steps["one"].buckets.count())


def test_zshard_state_helpers_match_one_device(dam_steps):
    """Counts, fluid marks, occupancy, particles and finalize of a sharded
    state are those of the one-device state."""
    sh, one, dom, tp = (dam_steps[k] for k in ("sh", "one", "dom", "tp"))
    assert torch.equal(fb.counts_bucketed(sh.buckets, dom),
                       fb.counts_bucketed(one.buckets, dom))
    assert torch.equal(fb.mark_fluid_cells_bucketed(sh.buckets, sh.flags,
                                                    dom),
                       fb.mark_fluid_cells_bucketed(one.buckets, one.flags,
                                                    dom))
    assert fb.max_cell_occupancy(sh.buckets, dom) == \
        fb.max_cell_occupancy(one.buckets, dom)
    (pa, va), (pb, vb) = (fb.to_particles(b.buckets, dom) for b in (sh, one))
    assert torch.equal(pa.pos, pb.pos) and torch.equal(va, vb)
    fa = tflip.finalize_buckets(sh, dom, tp)
    fb_one = tflip.finalize_buckets(one, dom, tp)
    assert isinstance(fa.buckets, shd.ShardedBuckets)
    a, b = tflip.state_to_numpy(fa), tflip.state_to_numpy(fb_one)
    for k in FIELDS:
        np.testing.assert_array_equal(a["buckets"][k], b["buckets"][k])
    assert not bool(fa.blend_pending)


def test_zshard_state_round_trip(dam_steps):
    """The JAX initial state crosses to the port, is sharded and comes back
    unchanged."""
    st = tflip.state_from_numpy(dam_steps["init"], device="cpu")
    sh = shd.shard_flip_bucket_state(st, dam_steps["mesh"])
    back = tflip.state_to_numpy(sh)
    again = tflip.state_to_numpy(shd.unshard_flip_bucket_state(sh))
    for d in (back, again):
        for k in ("flags", "vel", "vel_old", "pressure", "phi",
                  "blend_pending"):
            np.testing.assert_array_equal(d[k], dam_steps["init"][k])
        for k in BUCKETS:
            np.testing.assert_array_equal(d["buckets"][k],
                                          dam_steps["init"]["buckets"][k])
        for k in TS:
            np.testing.assert_array_equal(d["ts"][k],
                                          dam_steps["init"]["ts"][k])
    with pytest.raises(ValueError, match="sharded already"):
        shd.shard_flip_bucket_state(sh, dam_steps["mesh"])


def test_zshard_step_guards(dam_steps):
    one, sh, dom, tp, mesh = (dam_steps[k] for k in
                              ("one", "sh", "dom", "tp", "mesh"))
    with pytest.raises(ValueError, match="pass zshard"):
        tflip.flip_step_bucketed(sh, dom, tp)
    with pytest.raises(ValueError, match="sharded state"):
        tflip.flip_step_bucketed(one, dom, tp, zshard=mesh)
    with pytest.raises(ValueError, match="another mesh"):
        tflip.flip_step_bucketed(sh, dom, tp, zshard=_cpu_mesh(4))
    with pytest.raises(ValueError, match="not divisible"):
        shd.shard_flip_bucket_state(one, _cpu_mesh(3))


@pytest.mark.parametrize("route", ["no_ghost_fluid", "wide_radius"])
def test_zshard_unfused_routes_equal_one_device(route, monkeypatch):
    """Without ghost fluid, or with a levelset window wider than one cell,
    the transfer (and the levelset) run on the lead over the joined
    buckets; two steps equal the one-device steps (which
    tests/test_torch_flip_routes.py holds against JAX)."""
    kw = dict(gravity=(0.0, -0.003, 0.0), cg_accuracy=1e-4)
    kw.update(ghost_fluid=False, ring_only_obstacles=True)
    if route == "wide_radius":
        kw.update(ghost_fluid=True, radius_factor=2.5,
                  ring_only_obstacles=False)
    dom = Domain(size=(RES,) * 3)
    tp = tflip.FlipParams(**kw)
    mesh = _cpu_mesh(4)
    one = tflip.make_dam_state_bucketed(dom, tp, ppc=12, device="cpu")
    sh = shd.shard_flip_bucket_state(one, mesh)
    seen = []
    for name in ("p2g_union_zshard", "p2g_mac", "p2g_union"):
        orig = getattr(p2gk, name)
        monkeypatch.setattr(
            p2gk, name, lambda *a, _o=orig, _n=name, **k: (seen.append(_n),
                                                          _o(*a, **k))[1])
    for _ in range(2):
        one = tflip.flip_step_bucketed(one, dom, tp)
        sh = tflip.flip_step_bucketed(sh, dom, tp, zshard=mesh)
    assert seen == ["p2g_mac"] * 4
    a, b = tflip.state_to_numpy(sh), tflip.state_to_numpy(one)
    for k in ("flags", "vel", "pressure", "phi"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for k in BUCKETS:
        np.testing.assert_array_equal(a["buckets"][k], b["buckets"][k])


@pytest.mark.slow
def test_zshard_kernels_match_jax_mesh_kernels(crossing):
    """Against the JAX package's own z-sharded kernels (rebin_zshard_spmd,
    p2g_union_zshard_spmd) on its 8-device CPU mesh, interpret mode."""
    from jax.sharding import Mesh

    from mantaflow_tpu.ops import flip_bucket_pallas as fbp
    from mantaflow_tpu.ops import flip_bucket_pallas2 as fbp2

    jmesh = Mesh(np.array(jax.devices()[:8]).reshape(8), ("z",))
    jdom = crossing["jdom"]
    jsh = jax.jit(lambda b: fbp.rebin_zshard_spmd(b, jdom, jmesh))(
        crossing["jbk"])
    mesh = _cpu_mesh(8)
    dom = Domain(size=(RES,) * 3)
    got = rbk.rebin_zshard(shd.shard_buckets(crossing["bk"], mesh), dom,
                           mesh)
    whole = shd.unshard_buckets(got)
    assert int(whole.dropped) == int(jsh.dropped)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(whole, f).numpy(),
                                      np.asarray(getattr(jsh, f)),
                                      err_msg=f)
    jouts = jax.jit(lambda b: fbp2.p2g_union_zshard_spmd(b, jdom, 1.0,
                                                         jmesh))(jsh)
    outs = p2gk.p2g_union_zshard(got, dom, 1.0, mesh)
    for o, j in zip(outs, jouts):
        j = np.asarray(j)
        np.testing.assert_allclose(shd.gather_z(o, mesh, j.ndim - 3).numpy(),
                                   j, atol=1e-5)


def test_zshard_obstacle_probes_read_neighbour_planes():
    """A sphere obstacle cut by the slab faces: the z-sharded advection at
    a large dt, where the probes and the bisection cross slab faces,
    equals the one-device advection."""
    dom = Domain(size=(RES,) * 3)
    p = tflip.FlipParams(**OBSTACLE_DAM)
    st = tflip.make_dam_state_bucketed(dom, p, ppc=14, device="cpu",
                                       obstacle=Sphere(**SPHERE))
    vel = torch.tensor(np.random.RandomState(5).randn(3, RES, RES, RES)
                       .astype(np.float32) * 0.3)
    args = (st.flags, vel, vel * 0.8, torch.tensor(2.5), torch.tensor(True),
            0.97, dom)
    one = advk.advect_blend(st.buckets, *args, ring_only=False)
    mesh = _cpu_mesh(8)
    got = shd.unshard_buckets(advk.advect_blend_zshard(
        shd.shard_buckets(st.buckets, mesh), *args, mesh, ring_only=False))
    for f in FIELDS[:6]:
        assert torch.equal(getattr(got, f), getattr(one, f)), f
    moved = int((one.pz.to(torch.int32) != st.buckets.pz.to(torch.int32))
                [st.buckets.valid].sum())
    assert moved > 0
    assert bool(fl.is_obstacle(st.flags)[2:14].any())
