"""The bucketed FLIP step's routes without the fused levelset, of
mantaflow_tpu_torch vs mantaflow_tpu: the transfer alone, the union
levelset for any particle radius, the standalone blend, obstacle shapes in
the dam set-up, and the two dam paths that use them.

Inputs come from the JAX package's own set-up (sampled from its seed) or a
numpy seed and cross as numpy arrays. The JAX side runs its Pallas kernels
in interpret mode where it has one (``p2g_mac_pallas``,
``union_levelset_pallas``, ``flip_update_pallas``, as
tests/test_flip_bucket.py runs them) and its CPU branch for whole steps;
the port runs on the CPU through the kernel wrappers, which take the plain
versions there. Tolerances: the inside tests, flags, valid masks and the
sampled particles are exact; the transfer to abs 1e-5 (the Pallas kernel
sums the slots in another order), the levelset (a min) and the blend to
abs 1e-6; grids after three steps to abs 1e-4 and particles to 1e-5 (the
CG exits on a 1e-3 residual and sums in another order), as
tests/test_torch_flip.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mantaflow_tpu.core import shapes as jshapes
from mantaflow_tpu.core.domain import Domain as JDomain
from mantaflow_tpu.models import flip as jflip
from mantaflow_tpu.ops import flip_bucket as jfb
from mantaflow_tpu.ops import flip_bucket_pallas2 as jfbp2
from mantaflow_tpu_torch.core import flags as tfl
from mantaflow_tpu_torch.core import shapes as tshapes
from mantaflow_tpu_torch.core.domain import Domain
from mantaflow_tpu_torch.models import flip as tflip
from mantaflow_tpu_torch.ops import blend_kernels as blk
from mantaflow_tpu_torch.ops import flip_bucket as tfb
from mantaflow_tpu_torch.ops import levelset_kernels as lsk
from mantaflow_tpu_torch.ops import p2g_kernels as p2gk

FIELDS = ("px", "py", "pz", "vx", "vy", "vz")
BUCKETS = FIELDS + ("valid", "dropped")
GRIDS = ("flags", "vel", "vel_old", "pressure", "phi")
TS = ("dt", "time_total", "time_per_frame", "frame", "lock_dt", "count")
# scenes/flip01_simple.py's solve (no particle levelset) on the bench dam,
# and the obstacle dam at scenes/flip03_gen.py's particle radius
PATHS = {
    "no_ghost_fluid": (dict(gravity=(0.0, -0.003, 0.0), ghost_fluid=False,
                            cg_accuracy=1e-3, ring_only_obstacles=True),
                       None, 10),
    "obstacle_wide_radius": (dict(gravity=(0.0, -0.003, 0.0),
                                  ghost_fluid=True, radius_factor=2.5,
                                  cg_accuracy=1e-3),
                             dict(center=(11.2, 4.48, 8.0), radius=2.4), 14),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs test files in parallel worker processes; torch's own
    thread pool in each would oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_to_numpy(st):
    d = {k: np.asarray(getattr(st, k)) for k in GRIDS}
    d["buckets"] = {k: np.asarray(getattr(st.buckets, k)) for k in BUCKETS}
    d["ts"] = {k: np.asarray(getattr(st.ts, k)) for k in TS}
    d["blend_pending"] = np.asarray(st.blend_pending)
    return d


# -- shapes ------------------------------------------------------------------

SHAPES = {
    "sphere": ("Sphere", dict(center=(11.2, 4.48, 8.0), radius=2.4)),
    "sphere_on_centres": ("Sphere", dict(center=(8.5, 6.5, 7.5), radius=3.0)),
    "sphere_scaled": ("Sphere", dict(center=(7.3, 8.1, 6.9), radius=3.3,
                                     scale=(1.0, 0.5, 2.0))),
    "box": ("Box", dict(p0=(2.5, 3.0, 1.2), p1=(9.5, 7.7, 12.0))),
    "box_center_size": ("Box", dict(center=(8.0, 8.0, 8.0),
                                    size=(3.5, 2.0, 4.5))),
}


@pytest.mark.parametrize("which", sorted(SHAPES))
def test_inside_grid_matches_reference(which):
    kind, kw = SHAPES[which]
    size = (16, 14, 12)
    want = np.asarray(getattr(jshapes, kind)(**kw).inside_grid(
        JDomain(size=size)))
    got = getattr(tshapes, kind)(**kw).inside_grid(Domain(size=size), "cpu")
    assert got.dtype == torch.bool and 0 < want.sum() < want.size
    np.testing.assert_array_equal(got.numpy(), want)


def test_box_inside_2d_matches_reference():
    kw = dict(p0=(2.5, 3.0, 0.0), p1=(9.5, 7.7, 0.0), dim=2)
    want = np.asarray(jshapes.Box(**kw).inside_grid(
        JDomain(size=(16, 14, 1), dim=2)))
    got = tshapes.Box(**kw).inside_grid(Domain(size=(16, 14, 1), dim=2),
                                        "cpu")
    assert want.any()
    np.testing.assert_array_equal(got.numpy(), want)


# -- the dam with an obstacle -------------------------------------------------


@pytest.fixture(scope="module")
def runs():
    """Both dam paths at 16^3: the initial states built by the JAX package
    and by the port from the same arguments, and three steps of the JAX
    package (CPU branch) and of the port on the CPU, the port from the JAX
    initial state carried across with ``state_from_numpy``."""
    out = {}
    for name, (kw, obs, ppc) in PATHS.items():
        jdom, dom = JDomain(size=(16,) * 3), Domain(size=(16,) * 3)
        jp, tp = jflip.FlipParams(**kw), tflip.FlipParams(**kw)
        jst = jflip.make_dam_state_bucketed(
            jdom, jp, ppc=ppc, obstacle=obs and jshapes.Sphere(**obs))
        tst = tflip.make_dam_state_bucketed(
            dom, tp, ppc=ppc, obstacle=obs and tshapes.Sphere(**obs),
            device="cpu")
        init = _jax_to_numpy(jst)
        step = jax.jit(lambda s, d=jdom, p=jp: jflip.flip_step_bucketed(
            s, d, p))
        tst3 = tflip.state_from_numpy(init, device="cpu")
        for _ in range(3):
            jst = step(jst)
            tst3 = tflip.flip_step_bucketed(tst3, dom, tp)
        out[name] = dict(
            dom=dom, tp=tp, init=init, tinit=tflip.state_to_numpy(tst),
            jax=_jax_to_numpy(jst), tst3=tst3,
            torch=tflip.state_to_numpy(tst3),
            jfin=_jax_to_numpy(jflip.finalize_buckets(jst, jdom, jp)))
    return out


@pytest.mark.parametrize("path", sorted(PATHS))
def test_initial_state_matches_reference(runs, path):
    got, want = runs[path]["tinit"], runs[path]["init"]
    for k in GRIDS + ("blend_pending",):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in BUCKETS:
        np.testing.assert_array_equal(got["buckets"][k], want["buckets"][k],
                                      err_msg=k)


def test_obstacle_is_stamped_and_holds_no_particle(runs):
    r = runs["obstacle_wide_radius"]
    obs = tfl.is_obstacle(torch.tensor(r["tinit"]["flags"])).numpy()
    ring = np.ones_like(obs)
    ring[1:-1, 1:-1, 1:-1] = False
    assert (obs & ~ring).sum() > 20      # interior obstacle cells exist
    for state in (r["tinit"], r["torch"]):
        occupied = state["buckets"]["valid"].any(axis=0).reshape(obs.shape)
        assert not (obs & occupied).any()
    np.testing.assert_array_equal(
        tfl.is_obstacle(torch.tensor(r["torch"]["flags"])).numpy(), obs)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_three_steps_exact_parts_match_reference(runs, path):
    got, ref = runs[path]["torch"], runs[path]["jax"]
    np.testing.assert_array_equal(got["flags"], ref["flags"])
    np.testing.assert_array_equal(got["buckets"]["valid"],
                                  ref["buckets"]["valid"])
    assert int(got["buckets"]["dropped"]) == int(ref["buckets"]["dropped"]) \
        == 0
    assert got["buckets"]["valid"].sum() == \
        runs[path]["init"]["buckets"]["valid"].sum()
    assert bool(got["blend_pending"])
    for k in TS:
        np.testing.assert_allclose(got["ts"][k], ref["ts"][k], atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("field", ["vel", "vel_old", "phi", "pressure"])
@pytest.mark.parametrize("path", sorted(PATHS))
def test_three_steps_grids_match_reference(runs, path, field):
    np.testing.assert_allclose(runs[path]["torch"][field],
                               runs[path]["jax"][field], atol=1e-4)


def test_phi_untouched_without_ghost_fluid(runs):
    r = runs["no_ghost_fluid"]
    np.testing.assert_array_equal(r["torch"]["phi"], r["init"]["phi"])
    wide = runs["obstacle_wide_radius"]["torch"]["phi"]
    assert wide.max() > 2.0     # the radius of radius_factor 2.5 is 2.17


@pytest.mark.parametrize("path", sorted(PATHS))
def test_three_steps_particles_match_reference(runs, path):
    for k in FIELDS:
        np.testing.assert_allclose(runs[path]["torch"]["buckets"][k],
                                   runs[path]["jax"]["buckets"][k],
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_finalize_buckets_matches_reference(runs, path):
    r = runs[path]
    fin = tflip.finalize_buckets(r["tst3"], r["dom"], r["tp"])
    assert not bool(fin.blend_pending)
    for k in ("vx", "vy", "vz"):
        np.testing.assert_allclose(getattr(fin.buckets, k).numpy(),
                                   r["jfin"]["buckets"][k], atol=1e-5)
    parts, pvel = tfb.to_particles(fin.buckets, r["dom"])
    assert int(parts.count) == r["init"]["buckets"]["valid"].sum()
    assert bool(torch.isfinite(pvel).all())


def test_finalize_then_step_equals_pending_step(runs):
    """The standalone blend applies what the blend fused into the next
    step's advection applies: both orders move the particles alike."""
    r = runs["obstacle_wide_radius"]
    a = tflip.flip_step_bucketed(r["tst3"], r["dom"], r["tp"])
    fin = tflip.finalize_buckets(r["tst3"], r["dom"], r["tp"])
    b = tflip.flip_step_bucketed(fin, r["dom"], r["tp"])
    for k in FIELDS + ("valid",):
        assert torch.equal(getattr(a.buckets, k), getattr(b.buckets, k)), k


# -- the plain versions vs the Pallas kernels in interpret mode ---------------


def _fixture_buckets(which):
    """tests/test_flip_bucket.py's dam16 and corner24 bucket sets with
    made-up particle velocities, as a JAX Buckets and the port's."""
    if which == "dam16":
        size, frac, ppc = (16,) * 3, (0.4, 0.6, 1.0), 14
    else:
        size, frac, ppc = (24,) * 3, (0.3, 0.3, 0.35), 12
    jdom = JDomain(size=size)
    jp = jflip.FlipParams(gravity=(0.0, -0.003, 0.0), ghost_fluid=True)
    st = jflip.make_dam_state(jdom, jp, dam_frac=frac, discretization=2)
    bk = jfb.bin_from_particles(st.parts, st.pvel, jdom, ppc=ppc)
    bk = dataclasses.replace(
        bk, vx=jnp.where(bk.valid, bk.px * 0.01, 0.0),
        vy=jnp.where(bk.valid, bk.py * 0.02 - 0.05, 0.0),
        vz=jnp.where(bk.valid, bk.pz * 0.005, 0.0))
    tbk = tfb.Buckets(**{k: torch.tensor(np.asarray(getattr(bk, k)))
                         for k in BUCKETS})
    return jdom, bk, Domain(size=size), tbk


@pytest.fixture(scope="module", params=["dam16", "corner24"])
def both(request):
    return _fixture_buckets(request.param)


@pytest.fixture(scope="module")
def dam16():
    return _fixture_buckets("dam16")


def test_p2g_mac_matches_pallas_kernel(both):
    jdom, jbk, dom, tbk = both
    v_pl, w_pl = jfbp2.p2g_mac_pallas(jbk, jdom, interpret=True)
    v, w = p2gk.p2g_mac(tbk, dom)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_pl), atol=1e-5)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_pl), atol=1e-5)
    assert float(w.max()) > 1.0


def _levelset_vs_pallas(buckets, radius_factor, rw):
    jdom, jbk, dom, tbk = buckets
    assert tfb.levelset_radius(dom, radius_factor)[1] == rw
    phi_pl = jfbp2.union_levelset_pallas(jbk, jdom, radius_factor,
                                         interpret=True)
    phi = lsk.union_levelset(tbk, dom, radius_factor)
    np.testing.assert_allclose(phi.numpy(), np.asarray(phi_pl), atol=1e-6)
    assert float(phi.min()) < 0.0 < float(phi.max())


@pytest.mark.parametrize("radius_factor,rw", [(1.0, 1), (1.5, 2)])
def test_union_levelset_matches_pallas_kernel(both, radius_factor, rw):
    _levelset_vs_pallas(both, radius_factor, rw)


def test_union_levelset_three_cell_window_matches_pallas_kernel(dam16):
    """radius_factor 2.5 (scenes/flip03_gen.py): 343 source cells per
    destination; on the smaller fixture only, for the interpreter's time."""
    _levelset_vs_pallas(dam16, 2.5, 3)


def test_flip_update_matches_pallas_kernel(both):
    jdom, jbk, dom, tbk = both
    rng = np.random.RandomState(0)
    vel = rng.randn(3, *dom.shape).astype(np.float32) * np.float32(0.01)
    vold = rng.randn(3, *dom.shape).astype(np.float32) * np.float32(0.01)
    b_pl = jfbp2.flip_update_pallas(jbk, jnp.asarray(vel), jnp.asarray(vold),
                                    0.97, jdom, interpret=True)
    got = blk.flip_update(tbk, torch.tensor(vel), torch.tensor(vold), 0.97,
                          dom)
    for f in ("vx", "vy", "vz"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(b_pl, f)), atol=1e-6)
        assert torch.equal(getattr(got, f)[~tbk.valid],
                           getattr(tbk, f)[~tbk.valid])
    assert not torch.equal(got.vx, tbk.vx)
