"""BFS extrapolation of mantaflow_tpu_torch vs mantaflow_tpu.

A walled 16x14x12 domain with a fluid block, random velocities and a
p2g-like weight grid whose boundary ring keeps raw float weights (the
float-ring quirk of extrapolateMACFromWeight: a ring weight in [d, d+1)
counts as a layer-d neighbour). The port's functions run their plain layer
loops on the CPU and are held against the JAX package's XLA forms. The
layer kernel's plain version (``extrap_layer_plain``, what the CUDA kernel
computes) is held, through the kernel route's layer loops, against the same XLA
forms and against the Pallas layer kernel in interpret mode.

Every update is a mean of the same neighbour values in the same order, so
results are exact.
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


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs test files in parallel worker processes; torch's own
    thread pool in each would oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fields():
    jdom, dom = JDomain(size=SIZE), Domain(size=SIZE)
    rng = np.random.RandomState(5)
    flags = np.array(jfl.init_domain(jdom, 0))
    sz, sy, sx = jdom.shape
    block = np.zeros(jdom.shape, bool)
    block[1:7, 1:9, 2:8] = True
    flags[block] = jfl.TypeFluid
    vel = rng.randn(3, sz, sy, sx).astype(np.float32)
    weight = np.where(rng.rand(3, sz, sy, sx) < 0.3,
                      rng.rand(3, sz, sy, sx) * 3, 0.0).astype(np.float32)
    weight[:, :, :, 0] = np.float32(2.5)   # ring weights in [2, 3)
    weight[:, 0] = np.float32(1.25)
    phi = (rng.randn(sz, sy, sx) * 2).astype(np.float32)
    return jdom, dom, flags, vel, weight, phi


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


@pytest.mark.parametrize("which", ["mac_simple", "mac_from_weight",
                                   "ls_simple"])
def test_2d_off_cpu_raises_not_ported(which):
    """A 2D domain off the CPU has no layer kernel: the extrapolations
    refuse it rather than running the plain loop there."""
    dom = Domain(size=(8, 6, 1), dim=2)
    vel = torch.empty((3,) + dom.shape, device="meta")
    calls = {
        "mac_simple": lambda: txtr.extrapolate_mac_simple(
            torch.empty(dom.shape, dtype=torch.int32, device="meta"), vel,
            dom),
        "mac_from_weight": lambda: txtr.extrapolate_mac_from_weight(
            vel, vel, dom),
        "ls_simple": lambda: txtr.extrapolate_ls_simple(vel[0], dom),
    }
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        calls[which]()


def test_unported_options_raise(fields):
    _, dom, flags, vel, _, phi = fields
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        txtr.extrapolate_mac_simple(torch.tensor(flags), torch.tensor(vel),
                                    dom, phi_obs=torch.tensor(phi))
    with pytest.raises(ValueError, match="1 or 3"):
        txk.extrap_layer([torch.tensor(phi)] * 2, [torch.tensor(phi)] * 2,
                         dom, 1)
