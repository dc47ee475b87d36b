"""The flat-layout FLIP and APIC of mantaflow_tpu_torch vs mantaflow_tpu:
the particle advection, the transfers, the fluid marking, the union
levelset, the particle channel ops and the whole step.

Inputs are made from a numpy seed (or by the JAX package's own set-up) and
cross as numpy arrays; the JAX side runs on the CPU (no Pallas kernel lies
on this layout), the port on the CPU, where the extrapolation layers and the
CG run their plain versions. Tolerances: flags, counts, particle flags and
the sampled positions exact; the advected positions to abs 1e-5; the
transfers to abs 1e-5 (scatter-adds sum in another order than XLA's); the
levelset (a min) to abs 1e-6; after three whole steps grids to abs 1e-4 and
positions, velocities and the APIC rows to abs 1e-5, as
tests/test_torch_flip.py (the CG exits on a residual of 1e-3 and sums in
another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mantaflow_tpu.core import interp as ji
from mantaflow_tpu.core import particles as jcp
from mantaflow_tpu.core import shapes as jshapes
from mantaflow_tpu.core.domain import Domain as JDomain
from mantaflow_tpu.models import flip as jflip
from mantaflow_tpu.ops import apic as jao
from mantaflow_tpu.ops import flip as jfo
from mantaflow_tpu_torch.core import particles as tcp
from mantaflow_tpu_torch.core import shapes as tshapes
from mantaflow_tpu_torch.core.domain import Domain
from mantaflow_tpu_torch.models import flip as tflip
from mantaflow_tpu_torch.ops import apic as tao
from mantaflow_tpu_torch.ops import extrapolation as txtr
from mantaflow_tpu_torch.ops import extrapolation_kernels as txk
from mantaflow_tpu_torch.ops import flip as tfo
from mantaflow_tpu_torch.ops import pressure_kernels as tprk

GRIDS = ("flags", "vel", "vel_old", "pressure", "phi")
CHANNELS = ("pvel", "cpx", "cpy", "cpz")
TS = ("dt", "time_total", "time_per_frame", "frame", "lock_dt", "count")
SPHERE = dict(center=(11.2, 4.48, 8.0), radius=2.4)
# (size, dim, FlipParams, obstacle, discretization): the bench's FLIP dam
# (bench.py:84-86), the APIC ghost-fluid dam (tests/test_flip_model.py:24),
# the dam with a sphere obstacle at scenes/flip03_gen.py's particle radius
# (a levelset window of 3 cells), the 2D dam (tests/test_flip_model.py:8)
CONFIGS = {
    "bench_dam": ((16, 16, 16), 3, dict(gravity=(0.0, -0.003, 0.0),
                                        ghost_fluid=True, cg_accuracy=1e-3),
                  None, 2),
    "apic_gf_dam": ((16, 16, 16), 3, dict(gravity=(0.0, -0.003, 0.0),
                                          apic=True, ghost_fluid=True),
                    None, 2),
    "obstacle_dam": ((16, 16, 16), 3, dict(gravity=(0.0, -0.003, 0.0),
                                           ghost_fluid=True,
                                           radius_factor=2.5,
                                           cg_accuracy=1e-3), SPHERE, 2),
    "dam_2d": ((40, 40, 1), 2, dict(gravity=(0.0, -0.002, 0.0)), None, 3),
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
    d = {k: np.asarray(getattr(st, k)) for k in GRIDS + CHANNELS}
    d["parts"] = {k: np.asarray(getattr(st.parts, k))
                  for k in ("pos", "flags", "count")}
    d["ts"] = {k: np.asarray(getattr(st.ts, k)) for k in TS}
    return d


def _states_equal(got, ref):
    for k in GRIDS + CHANNELS:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for sub in ("parts", "ts"):
        for k, v in ref[sub].items():
            assert got[sub][k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[sub][k], v, err_msg=k)


# -- the whole step ------------------------------------------------------------


@pytest.fixture(scope="module")
def runs():
    """Every configuration: the initial states of both packages'
    make_dam_state, and three steps of each from its own."""
    out = {}
    for name, (size, dim, kw, obs, disc) in CONFIGS.items():
        jdom, dom = JDomain(size=size, dim=dim), Domain(size=size, dim=dim)
        jp, tp = jflip.FlipParams(**kw), tflip.FlipParams(**kw)
        jst = jflip.make_dam_state(jdom, jp, discretization=disc,
                                   obstacle=obs and jshapes.Sphere(**obs))
        tst = tflip.make_dam_state(dom, tp, discretization=disc,
                                   obstacle=obs and tshapes.Sphere(**obs),
                                   device="cpu")
        init = _jax_to_numpy(jst)
        step = jax.jit(lambda s, d=jdom, p=jp: jflip.flip_step(s, d, p))
        for _ in range(3):
            jst = step(jst)
        out[name] = dict(dom=dom, tp=tp, tst=tst, init=init,
                         jax=_jax_to_numpy(jst),
                         torch=tflip.flat_state_to_numpy(
                             tflip.flip_run(tst, dom, tp, 3)))
    return out


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_initial_state_matches_reference(runs, name):
    """make_dam_state: the sampled positions bit for bit, and every other
    field."""
    _states_equal(tflip.flat_state_to_numpy(runs[name]["tst"]),
                  runs[name]["init"])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_three_steps_match_reference(runs, name):
    got, ref = runs[name]["torch"], runs[name]["jax"]
    np.testing.assert_array_equal(got["flags"], ref["flags"])
    for k in ("flags", "count"):
        np.testing.assert_array_equal(got["parts"][k], ref["parts"][k])
    for k in TS:
        np.testing.assert_array_equal(got["ts"][k], ref["ts"][k], err_msg=k)
    for k in ("vel", "vel_old", "pressure", "phi"):
        np.testing.assert_allclose(got[k], ref[k], atol=1e-4, rtol=0,
                                   err_msg=k)
    np.testing.assert_allclose(got["parts"]["pos"], ref["parts"]["pos"],
                               atol=1e-5, rtol=0)
    for k in CHANNELS:
        np.testing.assert_allclose(got[k], ref[k], atol=1e-5, rtol=0,
                                   err_msg=k)
    # the step moved something, and APIC filled its rows
    assert not np.array_equal(got["parts"]["pos"], runs[name]["init"]
                              ["parts"]["pos"])
    assert np.abs(got["cpx"]).max() > 0 if runs[name]["tp"].apic \
        else np.abs(got["cpx"]).max() == 0


@pytest.mark.parametrize("name", ["bench_dam", "apic_gf_dam"])
def test_state_numpy_round_trip(runs, name):
    """flat_state_from_numpy o flat_state_to_numpy is the identity, from
    the port's state and from the JAX package's."""
    st = runs[name]["tst"]
    d = tflip.flat_state_to_numpy(st)
    _states_equal(tflip.flat_state_to_numpy(
        tflip.flat_state_from_numpy(d, device="cpu")), d)
    ref = runs[name]["jax"]
    _states_equal(tflip.flat_state_to_numpy(
        tflip.flat_state_from_numpy(ref, device="cpu")), ref)


@pytest.mark.parametrize("kw,layers", [
    (dict(ghost_fluid=True), 10), (dict(ghost_fluid=True, apic=True), 10),
    (dict(ghost_fluid=False), 6)])
def test_step_runs_through_the_kernel_wrappers(monkeypatch, kw, layers):
    """With the layer kernel's route taken (as on a GPU, where
    ``_use_kernel`` is true), a step reaches the extrapolation
    layers and the CG through their kernel wrappers (which run the plain
    versions on CPU tensors): 2 + 4 layers for the velocities, 4 more for
    the levelset with ghost fluid, one solve; and the result is the plain
    loops' result."""
    dom = Domain(size=(10,) * 3)
    p = tflip.FlipParams(gravity=(0.0, -0.003, 0.0), **kw)
    st = tflip.flip_step(tflip.make_dam_state(dom, p, device="cpu"), dom, p)
    plain = tflip.flip_step(st, dom, p)
    calls = {"extrap_layer": 0, "cg_solve": 0}
    for mod, name in ((txk, "extrap_layer"), (tprk, "cg_solve")):
        orig = getattr(mod, name)

        def counted(*a, _o=orig, _n=name, **k):
            calls[_n] += 1
            return _o(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    monkeypatch.setattr(txtr, "_use_kernel", lambda t: True)
    got = tflip.flip_step(st, dom, p)
    assert calls == {"extrap_layer": layers, "cg_solve": 1}
    for k in GRIDS + CHANNELS:
        assert torch.equal(getattr(got, k), getattr(plain, k)), k
    assert torch.equal(got.parts.pos, plain.parts.pos)


def test_make_dam_state_needs_cuda_or_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tflip.make_dam_state(Domain(size=(8,) * 3), tflip.FlipParams())


# -- particles for the module tests ----------------------------------------------

SIZES = {"3d": ((12, 12, 12), 3), "2d": ((14, 12, 1), 2)}


def _case(dim, seed=0, n=700, cap=768, margin=0.2):
    """Particles over the dam's flags with a sphere obstacle (3D): live
    ones at random positions in [margin, n - margin), a few of them marked
    deleted, then dead slots; random particle velocities, APIC rows, a
    random MAC field and a type channel. Returns both packages' inputs."""
    size, d = SIZES[dim]
    jdom, dom = JDomain(size=size, dim=d), Domain(size=size, dim=d)
    obs = jshapes.Sphere(center=(7.0, 4.0, 6.5), radius=2.2) if d == 3 \
        else None
    flags = np.asarray(jflip.make_dam_state(
        jdom, jflip.FlipParams(), obstacle=obs).flags)
    rng = np.random.default_rng(seed)
    pos = np.zeros((cap, 3), np.float32)
    pos[:n] = rng.uniform(margin, np.array(size) - margin,
                          (n, 3)).astype(np.float32)
    if d == 2:
        pos[:, 2] = 0.5
    pflags = np.zeros(cap, np.int32)
    pflags[rng.choice(n, 20, replace=False)] = jcp.PDELETE
    pflags[n:] = jcp.PINVALID | jcp.PDELETE
    ptype = rng.choice([1, 2, 4], cap).astype(np.int32)
    arrays = dict(
        pos=pos, pflags=pflags, ptype=ptype, flags=flags,
        pvel=rng.uniform(-1, 1, (cap, 3)).astype(np.float32),
        cps=[rng.uniform(-0.5, 0.5, (cap, 3)).astype(np.float32)
             for _ in range(3)],
        vel=rng.uniform(-1, 1, (3,) + dom.shape).astype(np.float32),
        vel_old=rng.uniform(-1, 1, (3,) + dom.shape).astype(np.float32))
    if d == 2:
        arrays["vel"][2] = 0.0
        arrays["vel_old"][2] = 0.0
    jparts = jcp.Particles(pos=jnp.asarray(pos), flags=jnp.asarray(pflags),
                           count=jnp.int32(n))
    tparts = tcp.Particles(pos=torch.from_numpy(pos),
                           flags=torch.from_numpy(pflags),
                           count=torch.tensor(n, dtype=torch.int32))
    return jdom, dom, jparts, tparts, arrays


def _j(a):
    return jnp.asarray(a)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=tol, rtol=0)


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("delete", [True, False])
def test_advect_in_grid_matches_reference(mode, delete):
    """advect_in_grid on a 12^3 dam with a sphere obstacle, Euler, RK2 and
    RK4, deleting or stopping in obstacles, at a dt that carries many
    particles into the obstacle and out of the domain."""
    jdom, dom, jparts, tparts, a = _case("3d", seed=mode)
    kw = dict(integration_mode=mode, delete_in_obstacle=delete,
              stop_in_obstacle=True)
    ref = jcp.advect_in_grid(jparts, _j(a["flags"]), _j(a["vel"]), 1.7,
                             jdom, **kw)
    got = tcp.advect_in_grid(tparts, _t(a["flags"]), _t(a["vel"]), 1.7,
                             dom, **kw)
    np.testing.assert_array_equal(got.flags.numpy(), np.asarray(ref.flags))
    _close(got.pos, ref.pos, 1e-5)
    moved = (got.pos != tparts.pos).any(dim=1)
    assert 0 < int(moved.sum()) < int(tparts.count)
    if delete:
        newly = (got.flags != tparts.flags).sum()
        assert int(newly) > 0


@pytest.mark.parametrize("dim", sorted(SIZES))
def test_advect_in_grid_options_match_reference(dim):
    """The other options: no obstacle handling, skip_new, an excluded
    particle type, a 0-dim dt, and the 2D domain."""
    jdom, dom, jparts, tparts, a = _case(dim, seed=5)
    newf = a["pflags"].copy()
    newf[:50] |= jcp.PNEW
    jparts = dataclasses.replace(jparts, flags=_j(newf))
    tparts = dataclasses.replace(tparts, flags=_t(newf))
    for kw in (dict(delete_in_obstacle=False, stop_in_obstacle=False),
               dict(skip_new=True, integration_mode=2,
                    delete_in_obstacle=False),
               dict(integration_mode=1, exclude=2)):
        jkw, tkw = dict(kw), dict(kw)
        if "exclude" in kw:
            jkw["ptype"], tkw["ptype"] = _j(a["ptype"]), _t(a["ptype"])
        ref = jcp.advect_in_grid(jparts, _j(a["flags"]), _j(a["vel"]),
                                 jnp.float32(1.3), jdom, **jkw)
        got = tcp.advect_in_grid(tparts, _t(a["flags"]), _t(a["vel"]),
                                 torch.tensor(1.3), dom, **tkw)
        np.testing.assert_array_equal(got.flags.numpy(),
                                      np.asarray(ref.flags))
        _close(got.pos, ref.pos, 1e-5)


@pytest.mark.parametrize("dim", sorted(SIZES))
def test_flip_transfers_match_reference(dim):
    """map_parts_to_mac (its stomped weight too), map_mac_to_parts and
    flip_velocity_update, with and without a type exclusion; the per-
    component MAC weights exact."""
    jdom, dom, jparts, tparts, a = _case(dim, seed=2)
    fl_j, fl_t = _j(a["flags"]), _t(a["flags"])
    for c in range(3):
        for g, r in zip(tfo._mac_axis_weights(tparts.pos, dom.shape, c),
                        jfo._mac_axis_weights(jparts.pos, jdom.shape, c)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    for excl in ({}, dict(exclude=4)):
        jx = dict(excl, ptype=_j(a["ptype"])) if excl else {}
        tx = dict(excl, ptype=_t(a["ptype"])) if excl else {}
        rv, rw = jfo.map_parts_to_mac(jparts, _j(a["pvel"]), fl_j, jdom, **jx)
        gv, gw = tfo.map_parts_to_mac(tparts, _t(a["pvel"]), fl_t, dom, **tx)
        _close(gv, rv, 1e-5)
        _close(gw, rw, 1e-5)
        np.testing.assert_array_equal(gw.numpy() > 0, np.asarray(rw) > 0)
        for old in (False, True):
            _close(tfo.map_mac_to_parts(_t(a["vel"]), tparts,
                                        old_pvel=_t(a["pvel"]) if old
                                        else None, **tx),
                   jfo.map_mac_to_parts(_j(a["vel"]), jparts,
                                        old_pvel=_j(a["pvel"]) if old
                                        else None, **jx), 1e-5)
        _close(tfo.flip_velocity_update(tparts, _t(a["pvel"]), fl_t,
                                        _t(a["vel"]), _t(a["vel_old"]), 0.97,
                                        **tx),
               jfo.flip_velocity_update(jparts, _j(a["pvel"]), fl_j,
                                        _j(a["vel"]), _j(a["vel_old"]), 0.97,
                                        **jx), 1e-5)


@pytest.mark.parametrize("dim", sorted(SIZES))
def test_apic_transfers_match_reference(dim):
    """apic_map_parts_to_mac (the raw mass) and apic_map_mac_to_parts,
    keeping the old rows of inactive particles or zeroing them."""
    jdom, dom, jparts, tparts, a = _case(dim, seed=3)
    fl_j, fl_t = _j(a["flags"]), _t(a["flags"])
    rv, rm = jao.apic_map_parts_to_mac(jparts, _j(a["pvel"]),
                                       *map(_j, a["cps"]), fl_j, jdom)
    gv, gm = tao.apic_map_parts_to_mac(tparts, _t(a["pvel"]),
                                       *map(_t, a["cps"]), fl_t, dom)
    _close(gv, rv, 1e-5)
    _close(gm, rm, 1e-5)
    old_j = (_j(a["pvel"]), *map(_j, a["cps"]))
    old_t = (_t(a["pvel"]), *map(_t, a["cps"]))
    for old in (False, True):
        ref = jao.apic_map_mac_to_parts(jparts, _j(a["vel"]), fl_j, jdom,
                                        old=old_j if old else None)
        got = tao.apic_map_mac_to_parts(tparts, _t(a["vel"]), fl_t, dom,
                                        old=old_t if old else None)
        for g, r in zip(got, ref):
            _close(g, r, 1e-5)
    ref = jao.apic_map_parts_to_mac(jparts, _j(a["pvel"]), *map(_j, a["cps"]),
                                    fl_j, jdom, ptype=_j(a["ptype"]),
                                    exclude=1)
    got = tao.apic_map_parts_to_mac(tparts, _t(a["pvel"]), *map(_t, a["cps"]),
                                    fl_t, dom, ptype=_t(a["ptype"]),
                                    exclude=1)
    for g, r in zip(got, ref):
        _close(g, r, 1e-5)


@pytest.mark.parametrize("dim", sorted(SIZES))
@pytest.mark.parametrize("phi_obs", [False, True])
def test_counts_and_fluid_marking_match_reference(dim, phi_obs):
    """particle_counts and mark_fluid_cells, with the obstacle band
    (knSetNbObstacle) from a sphere's levelset: exact. Some particles lie
    outside the grid (by truncation toward zero, those in (-1, 0) count
    in cell 0, as in the reference)."""
    jdom, dom, jparts, tparts, a = _case(dim, seed=4, margin=-0.8)
    np.testing.assert_array_equal(
        tfo.particle_counts(tparts, dom).numpy(),
        np.asarray(jfo.particle_counts(jparts, jdom)))
    np.testing.assert_array_equal(
        tfo.particle_counts(tparts, dom, _t(a["ptype"]), 2).numpy(),
        np.asarray(jfo.particle_counts(jparts, jdom, _j(a["ptype"]), 2)))
    phi = None
    if phi_obs:
        phi = np.asarray(jshapes.Sphere(center=(6.0, 5.0, 6.0),
                                        radius=3.1).compute_levelset(jdom))
    got = tfo.mark_fluid_cells(tparts, _t(a["flags"]), dom,
                               phi_obs=None if phi is None else _t(phi))
    ref = jfo.mark_fluid_cells(jparts, _j(a["flags"]), jdom,
                               phi_obs=None if phi is None else _j(phi))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("dim", sorted(SIZES))
@pytest.mark.parametrize("radius_factor", [1.0, 2.5])
def test_union_particle_levelset_matches_reference(dim, radius_factor):
    """Both branches: the one-cell window (radius_factor 1) and the wider
    one (2.5, three cells), with particles outside the grid and an
    excluded type."""
    jdom, dom, jparts, tparts, a = _case(dim, seed=6, n=300, margin=-0.6)
    fl_j, fl_t = _j(a["flags"]), _t(a["flags"])
    _close(tfo.union_particle_levelset(tparts, fl_t, dom, radius_factor),
           jfo.union_particle_levelset(jparts, fl_j, jdom, radius_factor),
           1e-6)
    _close(tfo.union_particle_levelset(tparts, fl_t, dom, radius_factor,
                                       ptype=_t(a["ptype"]), exclude=4),
           jfo.union_particle_levelset(jparts, fl_j, jdom, radius_factor,
                                       ptype=_j(a["ptype"]), exclude=4),
           1e-6)


@pytest.mark.parametrize("dim", sorted(SIZES))
def test_particle_api_ops_match_reference(dim):
    """map_parts_to_grid (scalar and vector), map_grid_to_parts,
    mark_isolated_fluid_cell, set_part_type, add_force_pvel, euler_step,
    update_velocity_from_delta_pos, project_out_of_bnd and
    push_out_of_obs."""
    jdom, dom, jparts, tparts, a = _case(dim, seed=7, margin=-0.4)
    fl_j, fl_t = _j(a["flags"]), _t(a["flags"])
    pv_j, pv_t = _j(a["pvel"]), _t(a["pvel"])
    for src in (a["pvel"][:, 0], a["pvel"]):
        _close(tfo.map_parts_to_grid(tparts, _t(src), fl_t, dom),
               jfo.map_parts_to_grid(jparts, _j(src), fl_j, jdom), 1e-5)
    for grid in (a["vel"][0], a["vel"]):
        _close(tfo.map_grid_to_parts(_t(grid), tparts),
               jfo.map_grid_to_parts(_j(grid), jparts), 1e-6)
    np.testing.assert_array_equal(
        tfo.mark_isolated_fluid_cell(fl_t, dom, 4).numpy(),
        np.asarray(jfo.mark_isolated_fluid_cell(fl_j, jdom, 4)))
    np.testing.assert_array_equal(
        tfo.set_part_type(tparts, _t(a["ptype"]), 8, 3, fl_t, dom,
                          1).numpy(),
        np.asarray(jfo.set_part_type(jparts, _j(a["ptype"]), 8, 3, fl_j,
                                     jdom, 1)))
    for ex in ({}, dict(exclude=2)):
        jx = dict(ex, ptype=_j(a["ptype"])) if ex else {}
        tx = dict(ex, ptype=_t(a["ptype"])) if ex else {}
        _close(tfo.add_force_pvel(pv_t, (0.1, -0.3, 0.2), 0.7, **tx),
               jfo.add_force_pvel(pv_j, (0.1, -0.3, 0.2), 0.7, **jx), 1e-6)
        gs = tfo.euler_step(tparts, pv_t, 0.7, **tx)
        rs = jfo.euler_step(jparts, pv_j, 0.7, **jx)
        _close(gs.pos, rs.pos, 1e-6)
        _close(tfo.update_velocity_from_delta_pos(gs, pv_t, tparts.pos, 0.7,
                                                  **tx),
               jfo.update_velocity_from_delta_pos(rs, pv_j, jparts.pos, 0.7,
                                                  **jx), 1e-5)
        _close(tcp.project_out_of_bnd(tparts, dom, 1.5, "xYz", **tx).pos,
               jcp.project_out_of_bnd(jparts, jdom, 1.5, "xYz", **jx).pos,
               0)
    phi_obs = np.asarray(jshapes.Sphere(center=(6.0, 5.0, 6.0), radius=3.1)
                         .compute_levelset(jdom))
    for kw in (dict(), dict(shift=0.3, thresh=0.5, exclude=4)):
        jx, tx = dict(kw), dict(kw)
        if "exclude" in kw:
            jx["ptype"], tx["ptype"] = _j(a["ptype"]), _t(a["ptype"])
        _close(tcp.push_out_of_obs(tparts, fl_t, _t(phi_obs), dom, **tx).pos,
               jcp.push_out_of_obs(jparts, fl_j, _j(phi_obs), jdom, **jx).pos,
               1e-5)


@pytest.mark.parametrize("dim", sorted(SIZES))
def test_samplers_match_reference(dim):
    """The level-set and shape samplers: positions bit for bit."""
    size, d = SIZES[dim]
    jdom, dom = JDomain(size=size, dim=d), Domain(size=size, dim=d)
    flags = np.asarray(jflip.make_dam_state(jdom, jflip.FlipParams()).flags)
    kw = dict(center=(6.0, 5.5, 6.0 if d == 3 else 0.5), radius=3.3)
    phi = np.asarray(jshapes.Sphere(**kw).compute_levelset(jdom))
    for refill in (False, True):
        np.testing.assert_array_equal(
            tcp.sample_levelset_positions(phi, flags, dom, 2, 0.05,
                                          refill_empty=refill),
            jcp.sample_levelset_positions(phi, flags, jdom, 2, 0.05,
                                          refill_empty=refill))
    ref = jcp.sample_shape_positions(jshapes.Sphere(**kw), flags, jdom, 2,
                                     0.05)
    np.testing.assert_array_equal(
        tcp.sample_shape_positions(tshapes.Sphere(**kw), flags, dom, 2, 0.05),
        ref)
    # the JAX package's exclude_phi branch writes into a read-only array
    # (``keep &= ...`` on np.asarray of a JAX array) and raises: the
    # reference is its shape sample filtered by its interpol of exclude_phi
    exclude = phi + 2.0
    ev = np.asarray(ji.interpol(jnp.asarray(exclude), *ref.T))
    np.testing.assert_array_equal(
        tcp.sample_shape_positions(tshapes.Sphere(**kw), flags, dom, 2, 0.05,
                                   exclude_phi=exclude), ref[ev > 0.0])
    assert 0 < (ev > 0.0).sum() < len(ref)
    got = tcp.sample_levelset_with_particles(phi, flags, dom, 2, 0.05,
                                             device="cpu")
    ref = jcp.sample_levelset_with_particles(phi, flags, jdom, 2, 0.05)
    np.testing.assert_array_equal(got.pos.numpy(), np.asarray(ref.pos))
    assert int(got.count) == int(ref.count)
