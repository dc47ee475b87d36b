"""BFS extrapolation of mantaflow_tpu_torch vs mantaflow_tpu.

A walled 16x14x12 domain (and a 16x14 2D one) with a fluid block, an
obstacle block, random velocities, an obstacle levelset and a p2g-like
weight grid whose boundary ring keeps raw float weights (the float-ring
quirk of extrapolateMACFromWeight: a ring weight in [d, d+1) counts as a
layer-d neighbour). The port's functions run their plain layer loops on the
CPU and are held against the JAX package's XLA forms. The layer kernel's
plain version (``extrap_layer_plain``, what the CUDA kernel computes, 2D
included) is held, through the kernel route's layer loops (``_use_kernel``
made true, as off the CPU), against the same XLA forms, and in 3D against
the Pallas layer kernel in interpret mode.

Every update is a mean of the same neighbour values in the same order, so
results are exact, but for the obstacle-normal projection of ``phi_obs``
(``_unproject_normal_comp``): XLA contracts its dot product and its
subtraction into fused multiply-adds on the CPU, so those values (and what
the extrapolation copies of them) agree to abs 1e-6, a few float32 ulps
of the O(1) velocities.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mantaflow_tpu.core import flags as jfl
from mantaflow_tpu.core.domain import Domain as JDomain
from mantaflow_tpu.ops import extrapolation as jxtr
from mantaflow_tpu.ops import extrapolation_pallas as jxp
from mantaflow_tpu_torch.core.domain import Domain
from mantaflow_tpu_torch.core.masks import interior_mask
from mantaflow_tpu_torch.ops import extrapolation as txtr
from mantaflow_tpu_torch.ops import extrapolation_kernels as txk

SIZE = (16, 14, 12)
SIZE_2D = (16, 14, 1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs test files in parallel worker processes; torch's own
    thread pool in each would oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fields(size, dim):
    jdom, dom = JDomain(size=size, dim=dim), Domain(size=size, dim=dim)
    rng = np.random.RandomState(5)
    flags = np.array(jfl.init_domain(jdom, 0))
    sz, sy, sx = jdom.shape
    block = np.zeros(jdom.shape, bool)
    block[slice(1, 7) if dim == 3 else 0, 1:9, 2:8] = True
    flags[block] = jfl.TypeFluid
    vel = rng.randn(3, sz, sy, sx).astype(np.float32)
    if dim == 2:
        vel[2] = 0.0
    weight = np.where(rng.rand(3, sz, sy, sx) < 0.3,
                      rng.rand(3, sz, sy, sx) * 3, 0.0).astype(np.float32)
    weight[:, :, :, 0] = np.float32(2.5)   # ring weights in [2, 3)
    weight[:, :, 0] = np.float32(0.75)     # in (0, 1): int 0, not 0.0
    if dim == 3:
        weight[:, 0] = np.float32(1.25)
    phi = (rng.randn(sz, sy, sx) * 2).astype(np.float32)
    return jdom, dom, flags, vel, weight, phi


@pytest.fixture(scope="module")
def fields():
    return _fields(SIZE, 3)


@pytest.fixture(scope="module")
def fields_2d():
    return _fields(SIZE_2D, 2)


def _obstacle_case(f):
    """``f``'s flags with an obstacle block beside the fluid, and an
    obstacle levelset: the distance to a sphere around that block."""
    jdom = f[0]
    flags = f[2].copy()
    sz, sy, sx = jdom.shape
    z0, z1 = (0, sz) if sz == 1 else (2, 6)
    flags[z0:z1, 2:8, 9:12] = jfl.TypeObstacle
    zz, yy, xx = np.meshgrid(np.arange(sz) + 0.5, np.arange(sy) + 0.5,
                             np.arange(sx) + 0.5, indexing="ij")
    cz = 0.5 if sz == 1 else 4.0
    phi_obs = (np.sqrt((xx - 10.5) ** 2 + (yy - 5.0) ** 2 + (zz - cz) ** 2)
               - 3.0).astype(np.float32)
    return flags, phi_obs


def test_extrapolate_mac_simple_matches_reference(fields):
    jdom, dom, flags, vel, _, _ = fields
    ref = jxtr.extrapolate_mac_simple(jnp.asarray(flags), jnp.asarray(vel),
                                      jdom, 4)
    got = txtr.extrapolate_mac_simple(torch.tensor(flags), torch.tensor(vel),
                                      dom, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("distance", [1, 2, 3])
def test_extrapolate_mac_from_weight_matches_reference(fields, distance):
    jdom, dom, _, vel, weight, _ = fields
    rv, rw = jxtr.extrapolate_mac_from_weight(jnp.asarray(vel),
                                              jnp.asarray(weight), jdom,
                                              distance)
    gv, gw = txtr.extrapolate_mac_from_weight(torch.tensor(vel),
                                              torch.tensor(weight), dom,
                                              distance)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(gw.numpy(), np.asarray(rw))


@pytest.mark.parametrize("inside", [True, False])
def test_extrapolate_ls_simple_matches_reference(fields, inside):
    jdom, dom, _, _, _, phi = fields
    ref = jxtr.extrapolate_ls_simple(jnp.asarray(phi), jdom, 4, inside=inside)
    got = txtr.extrapolate_ls_simple(torch.tensor(phi), dom, 4,
                                     inside=inside)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_kernel_route_mac_layers_match_reference(fields):
    """The layer loops the CUDA route takes (three pairs per launch, int
    cast of float markers), on the plain layer, reproduce the XLA loops of
    extrapolate_mac_from_weight, ring quirk included."""
    jdom, dom, _, vel, weight, _ = fields
    rv, rw = jxtr.extrapolate_mac_from_weight(jnp.asarray(vel),
                                              jnp.asarray(weight), jdom, 2)
    inter = interior_mask(dom, 1, "cpu")
    w = torch.tensor(weight)
    marks = [torch.where(inter & (w[c] > 0.0), 1.0,
                         torch.where(inter, 0.0, w[c])) for c in range(3)]
    before = txk.extrap_layer.launches
    vs, ms = txk.extrap_layers(list(torch.tensor(vel)), marks, dom, 1, 2)
    assert txk.extrap_layer.launches == before  # the CPU runs no kernel
    np.testing.assert_array_equal(torch.stack(vs).numpy(), np.asarray(rv))
    np.testing.assert_array_equal(torch.stack(ms).numpy(), np.asarray(rw))


@pytest.mark.parametrize("inside", [True, False])
def test_kernel_route_ls_layers_match_reference(fields, inside):
    """extrap_ls_layers (a marker-only first layer, then value layers with
    the direction offset) reproduces extrapolateLsSimple's loop."""
    jdom, dom, _, _, _, phi = fields
    ref = jxtr.extrapolate_ls_simple(jnp.asarray(phi), jdom, 4, inside=inside)
    inter = interior_mask(dom, 1, "cpu")
    p = torch.tensor(phi)
    direction = -1.0 if inside else 1.0
    tmp = (inter & ((p > 0.0) if inside else (p < 0.0))).to(torch.float32)
    got, marker = txk.extrap_ls_layers(p, tmp, dom, direction, 4)
    got = torch.where((marker.to(torch.int32) == 0) & inter,
                      direction * 6.0, got)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("n_pairs,d,direction,update_values",
                         [(3, 1, 0.0, True), (3, 2, 0.0, True),
                          (1, 1, -1.0, False), (1, 3, 1.0, True)])
def test_layer_plain_matches_pallas_kernel(fields, n_pairs, d, direction,
                                           update_values):
    """One layer of extrap_layer_plain == one call of the Pallas layer
    kernel (interpret mode), on float markers with ring weights."""
    jdom, dom, _, vel, weight, _ = fields
    ms, vs = list(weight[:n_pairs]), list(vel[:n_pairs])
    call = jxp._layer_call(jdom.shape, True, n_pairs)
    sc = jnp.array([d, int(direction * 1000), int(update_values)], jnp.int32)
    flat = []
    for m, v in zip(ms, vs):
        flat += [jnp.asarray(m)] * 3 + [jnp.asarray(v)] * 3
    out = call(sc, *flat)
    gm, gv = txk.extrap_layer_plain([torch.tensor(m) for m in ms],
                                    [torch.tensor(v) for v in vs], dom, d,
                                    direction, update_values)
    for c in range(n_pairs):
        np.testing.assert_array_equal(gm[c].numpy(), np.asarray(out[2 * c]))
        np.testing.assert_array_equal(gv[c].numpy(),
                                      np.asarray(out[2 * c + 1]))


@pytest.mark.parametrize("route", ["plain", "kernel"])
@pytest.mark.parametrize("which", ["mac_simple", "mac_from_weight",
                                   "ls_outside", "ls_inside"])
def test_2d_extrapolations_match_reference(fields_2d, monkeypatch, route,
                                           which):
    """The three extrapolations on a 2D domain, on the CPU's plain loops
    and on the kernel's route (the layer kernel's 2D instance: two pairs a
    launch for the MAC components, one for the levelset), against the JAX
    package's 2D XLA loops, exactly. extrapolateMACFromWeight's ring holds
    weights in (0, 1), which the kernel's int(marker) == 0 self test would
    take for 0 where the loop's w == 0.0 does not: they agree because only
    interior cells update, and those markers are integral."""
    jdom, dom, flags, vel, weight, phi = fields_2d
    calls = []
    if route == "kernel":
        orig = txk.extrap_layer

        def counted(ms, *a, **k):
            calls.append(len(ms))
            return orig(ms, *a, **k)
        monkeypatch.setattr(txtr, "_use_kernel", lambda t: True)
        monkeypatch.setattr(txk, "extrap_layer", counted)
    if which == "mac_simple":
        ref = (jxtr.extrapolate_mac_simple(jnp.asarray(flags),
                                           jnp.asarray(vel), jdom, 4),)
        got = (txtr.extrapolate_mac_simple(torch.tensor(flags),
                                           torch.tensor(vel), dom, 4),)
        want = [2] * 4
    elif which == "mac_from_weight":
        ref = jxtr.extrapolate_mac_from_weight(jnp.asarray(vel),
                                               jnp.asarray(weight), jdom, 3)
        got = txtr.extrapolate_mac_from_weight(torch.tensor(vel),
                                               torch.tensor(weight), dom, 3)
        want = [2] * 3
        inter = interior_mask(dom, 1, "cpu")
        w = torch.tensor(weight)[:2]
        marks = torch.where(inter & (w > 0.0), 1.0, torch.where(inter, 0.0, w))
        assert torch.equal(marks[:, inter], marks[:, inter].round())
        assert bool(((marks > 0) & (marks < 1)).any())
    else:
        inside = which == "ls_inside"
        ref = (jxtr.extrapolate_ls_simple(jnp.asarray(phi), jdom, 4,
                                          inside=inside),)
        got = (txtr.extrapolate_ls_simple(torch.tensor(phi), dom, 4,
                                          inside=inside),)
        want = [1] * 4
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert calls == (want if route == "kernel" else [])


@pytest.mark.parametrize("route", ["plain", "kernel"])
@pytest.mark.parametrize("dim", [3, 2])
@pytest.mark.parametrize("kw", [dict(into_obs=True), dict(phi_obs=True),
                                dict(phi_obs=True, into_obs=True)],
                         ids=["into_obs", "phi_obs", "both"])
def test_mac_simple_obstacle_options_match_reference(fields, fields_2d,
                                                     monkeypatch, route, dim,
                                                     kw):
    """extrapolate_mac_simple's into_obs (no extrapolation out of obstacle
    faces) and phi_obs (the obstacle-normal component removed near the
    obstacle), exactly."""
    f = fields if dim == 3 else fields_2d
    jdom, dom, _, vel, _, _ = f
    flags, phi_obs = _obstacle_case(f)
    if route == "kernel":
        monkeypatch.setattr(txtr, "_use_kernel", lambda t: True)
    jkw, tkw = {}, {}
    if kw.get("into_obs"):
        jkw["into_obs"] = tkw["into_obs"] = True
    if kw.get("phi_obs"):
        jkw["phi_obs"] = jnp.asarray(phi_obs)
        tkw["phi_obs"] = torch.tensor(phi_obs)
    ref = jxtr.extrapolate_mac_simple(jnp.asarray(flags), jnp.asarray(vel),
                                      jdom, 3, **jkw)
    got = txtr.extrapolate_mac_simple(torch.tensor(flags), torch.tensor(vel),
                                      dom, 3, **tkw)
    if "phi_obs" in tkw:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6,
                                   rtol=0)
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    plain = txtr.extrapolate_mac_simple(torch.tensor(flags),
                                        torch.tensor(vel), dom, 3)
    assert not torch.equal(got, plain)


@pytest.mark.parametrize("dim", [3, 2])
@pytest.mark.parametrize("max_dist", [2, 4])
def test_unproject_normal_comp_matches_reference(fields, fields_2d, dim,
                                                 max_dist):
    f = fields if dim == 3 else fields_2d
    jdom, dom, _, vel, _, _ = f
    flags, phi_obs = _obstacle_case(f)
    ref = jxtr._unproject_normal_comp(jnp.asarray(flags), jnp.asarray(vel),
                                      jnp.asarray(phi_obs), jdom, max_dist)
    got = txtr._unproject_normal_comp(torch.tensor(flags), torch.tensor(vel),
                                      torch.tensor(phi_obs), dom, max_dist)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=0)
    assert not torch.equal(got, torch.tensor(vel))


@pytest.mark.parametrize("route", ["plain", "kernel"])
@pytest.mark.parametrize("dim", [3, 2])
@pytest.mark.parametrize("inside", [False, True])
def test_extrapolate_vec3_simple_matches_reference(fields, fields_2d,
                                                   monkeypatch, route, dim,
                                                   inside):
    """extrapolateVec3Simple, all three components in 2D too; on the
    kernel's route a marker-only first layer, then one three-pair launch a
    layer."""
    f = fields if dim == 3 else fields_2d
    jdom, dom, _, vel, _, phi = f
    calls = []
    if route == "kernel":
        orig = txk.extrap_layer

        def counted(ms, *a, **k):
            calls.append(len(ms))
            return orig(ms, *a, **k)
        monkeypatch.setattr(txtr, "_use_kernel", lambda t: True)
        monkeypatch.setattr(txk, "extrap_layer", counted)
    ref = jxtr.extrapolate_vec3_simple(jnp.asarray(vel), jnp.asarray(phi),
                                       jdom, 4, inside=inside)
    got = txtr.extrapolate_vec3_simple(torch.tensor(vel), torch.tensor(phi),
                                       dom, 4, inside=inside)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert not torch.equal(got, torch.tensor(vel))
    assert calls == ([1, 3, 3, 3] if route == "kernel" else [])


def test_unported_options_raise(fields):
    """What the layer wrapper does not take: no pair, or more than three."""
    _, dom, _, _, _, phi = fields
    for n in (0, 4):
        with pytest.raises(ValueError, match="1, 2 or 3"):
            txk.extrap_layer([torch.tensor(phi)] * n,
                             [torch.tensor(phi)] * n, dom, 1)
