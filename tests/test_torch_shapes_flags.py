"""Shapes, flag-grid setup and masks of mantaflow_tpu_torch vs mantaflow_tpu.

Every case builds its inputs once with numpy, runs the JAX function on the
CPU and the port's counterpart with device="cpu", and compares. Flags,
inside tests and stamped grids must be equal; SDFs through a square root
(Sphere, Cylinder) agree to 2e-6, a float32 ulp of values up to ~20: XLA's
float32 square root on the CPU is not correctly rounded (about 0.7 % of
inputs differ from the IEEE result by an ulp), torch's is.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mantaflow_tpu.core import flags as jfl
from mantaflow_tpu.core import masks as jmasks
from mantaflow_tpu.core import shapes as jsh
from mantaflow_tpu.core.domain import Domain as JDomain
from mantaflow_tpu.scene.api import _wall_sdf as j_wall_sdf
from mantaflow_tpu_torch.core import flags as tfl
from mantaflow_tpu_torch.core import masks as tmasks
from mantaflow_tpu_torch.core import shapes as tsh
from mantaflow_tpu_torch.core.domain import Domain

CPU = "cpu"
SDF_TOL = 2e-6


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _doms(size):
    dim = 2 if size[2] == 1 else 3
    return JDomain(size=size, dim=dim), Domain(size=size, dim=dim)


def _shape_pairs(n):
    """(name, JAX shape, port shape) over every shape class, with the
    scenes' own parameters scaled to an n-cell grid."""
    c = (n * 0.5, n * 0.5, n * 0.5)
    specs = [
        ("box", "Box", dict(p0=(n * 0.2, n * 0.2, n * 0.3),
                            p1=(n * 0.9, n * 0.8, n * 0.9))),
        ("box_2d", "Box", dict(center=(n * 0.4, n * 0.5, 0.5),
                               size=(n * 0.2, n * 0.1, 1.0), dim=2)),
        ("sphere", "Sphere", dict(center=(n * 0.3, n * 0.4, n * 0.5),
                                  radius=n * 0.2, scale=(1.0, 0.5, 1.5))),
        ("cylinder_y", "Cylinder", dict(center=c, radius=n * 0.2,
                                        z=(0.0, n * 0.3, 0.0))),
        ("cylinder_z_long", "Cylinder", dict(center=(n * 0.25, n * 0.5,
                                                     n * 0.5),
                                             radius=n * 0.2,
                                             z=(0.0, 0.0, float(n)))),
        ("cylinder_tilted", "Cylinder", dict(center=c, radius=n * 0.15,
                                             z=(n * 0.1, n * 0.2, -n * 0.25))),
        ("slope", "Slope", dict(anglexy=0.3, angleyz=-0.2, origin=n * 0.4,
                                gs=(n, n, n))),
        ("null", "NullShape", {}),
    ]
    return [(name, getattr(jsh, cls)(**kw), getattr(tsh, cls)(**kw))
            for name, cls, kw in specs]


SHAPES = [p[0] for p in _shape_pairs(16)]


def _pair(name, n):
    return next((j, t) for nm, j, t in _shape_pairs(n) if nm == name)


@pytest.mark.parametrize("name", SHAPES)
@pytest.mark.parametrize("size", [(20, 18, 16), (20, 18, 1)])
def test_shape_sdf_and_inside(name, size):
    jdom, dom = _doms(size)
    js, ts = _pair(name, size[0])
    np.testing.assert_array_equal(_np(ts.inside_grid(dom, CPU)),
                                  np.asarray(js.inside_grid(jdom)))
    ref = np.asarray(js.compute_levelset(jdom))
    got = _np(ts.compute_levelset(dom, CPU))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=SDF_TOL)
    # off the cell centres (the per-face tests of apply_to_mac_grid)
    rng = np.random.RandomState(3)
    p = (rng.rand(3, 500) * size[0]).astype(np.float32)
    np.testing.assert_array_equal(
        _np(ts.is_inside(*map(torch.from_numpy, p))),
        np.asarray(js.is_inside(*map(jnp.asarray, p))))
    assert ts.get_center() == js.get_center()
    assert ts.get_extent() == js.get_extent()


def test_box_center_setter_moves_the_box():
    jb = jsh.Box(p0=(2.0, 3.0, 4.0), p1=(6.0, 9.0, 8.0))
    tb = tsh.Box(p0=(2.0, 3.0, 4.0), p1=(6.0, 9.0, 8.0))
    assert tb.center == jb.center == (4.0, 6.0, 6.0)
    jb.center = tb.center = (10.0, 11.5, 7.25)
    assert (tb.p0, tb.p1) == (jb.p0, jb.p1)
    assert tb.get_extent() == jb.get_extent() == (4.0, 6.0, 4.0)


@pytest.mark.parametrize("name", SHAPES)
@pytest.mark.parametrize("respect", [False, True])
def test_apply_to_grids(name, respect):
    size = (18, 16, 14)
    jdom, dom = _doms(size)
    js, ts = _pair(name, size[0])
    rng = np.random.RandomState(4)
    grid = rng.rand(*jdom.shape).astype(np.float32)
    vec = rng.rand(3, *jdom.shape).astype(np.float32)
    flags = np.array(jfl.fill_grid(jfl.init_domain(jdom, 1)))
    flags[:, 5:8, 4:9] = jfl.TypeObstacle
    jrf = jnp.asarray(flags) if respect else None
    trf = torch.from_numpy(flags) if respect else None
    val3 = (0.4, -0.3, 0.2)
    cases = [
        (js.apply_to_grid(jnp.asarray(grid), 0.432, jdom, jrf),
         ts.apply_to_grid(torch.from_numpy(grid), 0.432, dom, trf)),
        (js.apply_to_grid(jnp.asarray(vec), val3, jdom, jrf),
         ts.apply_to_grid(torch.from_numpy(vec), val3, dom, trf)),
        (js.apply_to_mac_grid(jnp.asarray(vec), val3, jdom, jrf),
         ts.apply_to_mac_grid(torch.from_numpy(vec), val3, dom, trf)),
    ]
    for ref, got in cases:
        np.testing.assert_array_equal(_np(got), np.asarray(ref))
    # the feathered stamp multiplies the SDF's weights: 2 ulps of its SDF
    for sigma, shift in ((1.0, 0.0), (2.5, 0.7)):
        ref = js.apply_to_grid_smooth(jnp.asarray(grid), 2.0, jdom, sigma,
                                      shift, jrf)
        got = ts.apply_to_grid_smooth(torch.from_numpy(grid), 2.0, dom,
                                      sigma, shift, trf)
        np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=0,
                                   atol=SDF_TOL)


SPECS = [
    # (boundary_width, wall, open_s, inflow, outflow)
    (0, "xXyYzZ", "      ", "xX", "      "),      # karman.py
    (1, "xXyYzZ", "      ", "      ", "      "),   # the default
    (0, "xXyYzZ", "yY", "x", "X"),                 # mixed
    (1, "xXyz", "Z", "      ", "y"),               # partial walls
    (2, "yYzZ", "  x", "X", "      "),             # later positions
    (0, "", "", "", ""),                           # no walls at all
]


@pytest.mark.parametrize("spec", SPECS, ids=[f"spec{i}" for i in
                                             range(len(SPECS))])
@pytest.mark.parametrize("size", [(16, 12, 10), (14, 12, 1)])
def test_init_domain_spec_strings(spec, size):
    jdom, dom = _doms(size)
    bw, wall, open_s, inflow, outflow = spec
    assert tfl._parse_boundary_types(dom, wall, open_s, inflow, outflow) \
        == jfl._parse_boundary_types(jdom, wall, open_s, inflow, outflow)
    ref = jfl.init_domain(jdom, bw, wall, open_s, inflow, outflow)
    got = tfl.init_domain(dom, bw, wall, open_s, inflow, outflow,
                          device=CPU)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), np.asarray(ref))
    np.testing.assert_array_equal(
        _np(tfl.fill_grid(got)), np.asarray(jfl.fill_grid(ref)))


def test_init_domain_keeps_its_positional_width():
    """The callers before the spec strings pass (dom, bw, device=...)."""
    jdom, dom = _doms((12, 10, 8))
    np.testing.assert_array_equal(
        _np(tfl.init_domain(dom, 1, device=CPU)),
        np.asarray(jfl.init_domain(jdom, 1)))


@pytest.mark.parametrize("wall", ["xXyYzZ", "yYzZ", "xY", ""])
@pytest.mark.parametrize("size,bw", [((16, 12, 10), 0), ((16, 12, 10), 2),
                                     ((14, 12, 1), 1)])
def test_wall_sdf(wall, size, bw):
    jdom, dom = _doms(size)
    np.testing.assert_array_equal(
        _np(tfl._wall_sdf(dom, bw, wall, device=CPU)),
        np.asarray(j_wall_sdf(jdom, bw, wall)))


@pytest.mark.parametrize("flag", [jfl.TypeFluid, jfl.TypeObstacle,
                                  jfl.TypeInflow | jfl.TypeEmpty])
@pytest.mark.parametrize("bnd", [0, 1, 3])
def test_count_cells(flag, bnd):
    jdom, dom = _doms((16, 12, 10))
    ref = jfl.fill_grid(jfl.init_domain(jdom, 1, "yYzZ", "      ", "xX"))
    got = tfl.fill_grid(tfl.init_domain(dom, 1, "yYzZ", "      ", "xX",
                                        device=CPU))
    r = int(jfl.count_cells(ref, flag, bnd, jdom))
    assert int(tfl.count_cells(got, flag, bnd, dom)) == r
    assert r > 0 or bnd == 3


def test_set_open_bound_type():
    jdom, dom = _doms((14, 12, 10))
    btype = jfl.TypeOpen | jfl.TypeEmpty
    ref = jfl.set_open_bound(jfl.init_domain(jdom, 1), jdom, 1, "xYz", btype)
    got = tfl.set_open_bound(tfl.init_domain(dom, 1, device=CPU), dom, 1,
                             "xYz", btype)
    np.testing.assert_array_equal(_np(got), np.asarray(ref))


@pytest.mark.parametrize("axis", ["x", "y", "z"])
@pytest.mark.parametrize("d", [-2, -1, 0, 1, 3])
def test_shift_clamp(axis, d):
    rng = np.random.RandomState(9)
    for shape in ((5, 6, 7), (3, 5, 6, 7)):
        a = rng.rand(*shape).astype(np.float32)
        np.testing.assert_array_equal(
            _np(tmasks.shift_clamp(torch.from_numpy(a), d, axis)),
            np.asarray(jmasks.shift_clamp(jnp.asarray(a), d, axis)))


def test_flag_constants_predicates_and_levelset_update():
    names = [n for n in dir(jfl) if n.startswith("Type")]
    assert names and all(getattr(tfl, n) == getattr(jfl, n) for n in names)
    jdom, dom = _doms((14, 12, 10))
    ref = jfl.init_domain(jdom, 1, "yYzZ", "  y", "xX", "Z")
    got = tfl.init_domain(dom, 1, "yYzZ", "  y", "xX", "Z", device=CPU)
    for pred in ("is_fluid", "is_obstacle", "is_empty", "is_inflow",
                 "is_outflow", "is_open", "is_stick"):
        np.testing.assert_array_equal(_np(getattr(tfl, pred)(got)),
                                      np.asarray(getattr(jfl, pred)(ref)))
    phi = np.random.RandomState(2).randn(*jdom.shape).astype(np.float32)
    phi[0, 0, 0] = 2e10  # beyond the invalid time: left alone
    np.testing.assert_array_equal(
        _np(tfl.update_from_levelset(got, torch.from_numpy(phi), 1e10)),
        np.asarray(jfl.update_from_levelset(ref, jnp.asarray(phi), 1e10)))
    assert tmasks._AXIS_OF == jmasks._AXIS_OF
