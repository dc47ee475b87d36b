"""The rest of the forces and boundary conditions of mantaflow_tpu_torch vs
mantaflow_tpu (ops/extforces.py), with every argument of the JAX
signatures: exclusion and region masks, set (not added) forces, buoyancy
coefficients, obstacle velocities, the fraction walls, inflow faces, the
levelset and heat channels.

The fixture is tests/test_torch_forces.py's (walls, an open "Y" side, an
obstacle block, a stick cell, empty cells), in 3D and in 2D, from a numpy
seed. Tolerance abs 1e-6 (elementwise float32), 1e-5 where a square root
or a reciprocal square root may differ in its last bit between backends.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mantaflow_tpu.core import flags as jfl
from mantaflow_tpu.core.domain import Domain as JDomain
from mantaflow_tpu.ops import extforces as jext
from mantaflow_tpu_torch.core.domain import Domain
from mantaflow_tpu_torch.ops import extforces as text

SIZES = {"3d": (14, 12, 10), "2d": (14, 12, 1)}


@pytest.fixture(scope="module", params=list(SIZES))
def system(request):
    size = SIZES[request.param]
    is3d = size[2] > 1
    jdom = JDomain(size=size, dim=3 if is3d else 2)
    flags = jfl.fill_grid(jfl.init_domain(jdom, 1), jfl.TypeFluid)
    flags = np.array(jfl.set_open_bound(flags, jdom, 1, "Y"))
    z0 = 4 if is3d else 0
    flags[z0:z0 + 2, 3:5, 5:8] = jfl.TypeObstacle
    flags[6 if is3d else 0, 6, 6] = jfl.TypeObstacle | jfl.TypeStick
    flags[(3 if is3d else 0):(5 if is3d else 1), 7:9, 3:5] = jfl.TypeEmpty
    rng = np.random.RandomState(11)
    shape = jdom.shape

    def r(*s):
        return rng.randn(*s).astype(np.float32)
    f = dict(flags=flags, vel=r(3, *shape), dens=np.abs(r(*shape)),
             heat=r(*shape), phi=r(*shape), field=r(3, *shape),
             obvel=r(3, *shape) * 0.1, mask=r(*shape))
    return jdom, Domain(size=size, dim=jdom.dim), f


def _both(system, name, args, kwargs=None, tol=1e-6):
    """``name`` of both packages on the same inputs; ``args`` and
    ``kwargs`` name fixture fields (strings) or pass values as they are."""
    jdom, dom, f = system
    kwargs = kwargs or {}

    def conv(v, to):
        return to(f[v]) if isinstance(v, str) and v in f else v
    ja = [jdom if a == "dom" else conv(a, jnp.asarray) for a in args]
    ta = [dom if a == "dom" else conv(a, torch.tensor) for a in args]
    ref = getattr(jext, name)(*ja, **{k: conv(v, jnp.asarray)
                                      for k, v in kwargs.items()})
    got = getattr(text, name)(*ta, **{k: conv(v, torch.tensor)
                                      for k, v in kwargs.items()})
    if not isinstance(ref, tuple):
        ref, got = (ref,), (got,)
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        if r is None:
            assert g is None
            continue
        r = np.asarray(r)
        assert g.numpy().dtype == r.dtype
        np.testing.assert_allclose(g.numpy(), r, atol=tol, err_msg=name)


@pytest.mark.parametrize("additive", [True, False])
@pytest.mark.parametrize("exclude", [None, "mask"])
def test_apply_force(system, additive, exclude):
    _both(system, "apply_force", ["flags", "vel", (0.1, -0.2, 0.3), "dom"],
          dict(exclude=exclude, additive=additive))


@pytest.mark.parametrize("scale", [True, False])
def test_add_gravity_with_exclusion(system, scale):
    _both(system, "add_gravity",
          ["flags", "vel", (0.0, -9.81, 0.5), 0.4, "dom"],
          dict(exclude="mask", scale=scale))


@pytest.mark.parametrize("coefficient,scale", [(2.5, True), (0.5, False)])
def test_add_buoyancy_coefficient(system, coefficient, scale):
    _both(system, "add_buoyancy",
          ["flags", "dens", "vel", (0.0, -6e-4, 1e-4), 0.7, "dom"],
          dict(coefficient=coefficient, scale=scale))


def test_set_wall_bcs_with_obstacle_velocity(system):
    _both(system, "set_wall_bcs", ["flags", "vel", "dom"], dict(obvel="obvel"))


def test_set_wall_bcs_frac(system):
    _both(system, "set_wall_bcs_frac", ["flags", "vel", "dom", "phi"],
          dict(obvel="obvel"), tol=1e-5)


def test_set_initial_velocity(system):
    _both(system, "set_initial_velocity", ["flags", "vel", "field", "dom"])


def test_vorticity_confinement_per_cell_strength(system):
    _, _, f = system
    f["strength"] = np.abs(f["mask"]) * 0.05
    _both(system, "vorticity_confinement", ["vel", "flags", "dom", 0.1],
          dict(strength_cell="strength"), tol=1e-5)


@pytest.mark.parametrize("additive,is_mac", [(True, False), (False, False),
                                             (True, True)])
@pytest.mark.parametrize("region", [None, "mask"])
def test_apply_force_field(system, additive, is_mac, region):
    _both(system, "apply_force_field", ["flags", "vel", "field", "dom"],
          dict(region=region, additive=additive, is_mac=is_mac))


@pytest.mark.parametrize("direction", ["x", "yY", "X"])
def test_set_inflow_bcs(system, direction):
    _both(system, "set_inflow_bcs", ["vel", "dom", direction,
                                     (0.5, -0.25, 0.125)])


def test_reset_outflow_grids_with_levelset(system):
    _both(system, "reset_outflow_grids", ["flags", "dom"],
          dict(phi="phi", real="dens"))
    _both(system, "reset_outflow_grids", ["flags", "dom"], dict(phi="phi"))


@pytest.mark.parametrize("log_falloff", [True, False])
def test_dissolve_smoke_with_heat(system, log_falloff):
    _both(system, "dissolve_smoke", ["flags", "dens", "dom", "heat", 3,
                                     log_falloff])
