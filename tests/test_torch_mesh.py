"""Triangle meshes of mantaflow_tpu_torch vs mantaflow_tpu.

The fixtures are ``tests/test_mesh.py``'s: sphere levelsets at 16³-32³,
a sphere joined with a small blob, a random 10³ field, and the
reference-binary goldens ``tests/testdata_ref/mc_blob_phi.uni`` /
``mc_blob_ref.obj`` (read with the JAX package's reader). The host
functions are the JAX package's numpy code, so their results are equal;
the device functions (node advection and collision) are torch
interpolations held against the JAX package's at 1e-6 (the JAX package's
trilinear lookups contract multiply-adds on the CPU).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mantaflow_tpu.core import mesh as jmesh
from mantaflow_tpu.core.domain import Domain as JDomain
from mantaflow_tpu_torch.core import mesh as tmesh
from mantaflow_tpu_torch.core.domain import Domain

CPU = "cpu"
TESTDATA_REF = os.path.join(os.path.dirname(__file__), "testdata_ref")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _sphere_phi(n, c, r):
    z, y, x = np.mgrid[0:n, 0:n, 0:n].astype(np.float32) + 0.5
    return (np.sqrt((x - c[0]) ** 2 + (y - c[1]) ** 2 + (z - c[2]) ** 2)
            - r).astype(np.float32)


def _two_blobs(n=24):
    return np.minimum(_sphere_phi(n, (8, 12, 12), 4.0),
                      _sphere_phi(n, (18, 12, 12), 1.2))


def _equal_meshes(a, b):
    assert a[0].dtype == b[0].dtype and a[1].dtype == b[1].dtype
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def test_mc_table_is_the_reference_copy():
    import mantaflow_tpu.core as jcore
    ref = os.path.join(os.path.dirname(jcore.__file__), "mcubes_table_ref.npy")
    got = os.path.join(os.path.dirname(tmesh.__file__), "mcubes_table_ref.npy")
    with open(ref, "rb") as f, open(got, "rb") as g:
        assert f.read() == g.read()
    np.testing.assert_array_equal(tmesh._load_mc_table(),
                                  jmesh._load_mc_table())
    np.testing.assert_array_equal(tmesh._gen_mc_table(),
                                  jmesh._gen_mc_table())


@pytest.mark.parametrize("field", ["sphere", "blobs", "random", "iso"])
def test_marching_cubes_and_tets_match_reference(field):
    if field == "random":
        phi, iso = np.random.RandomState(7).randn(10, 10, 10).astype(
            np.float32), 0.0
    elif field == "blobs":
        phi, iso = _two_blobs(), 0.0
    elif field == "iso":
        phi, iso = _sphere_phi(20, (10.3, 9.7, 10.1), 5.0), 0.6
    else:
        phi, iso = _sphere_phi(32, (16, 16, 16), 9.0), 0.0
    _equal_meshes(tmesh.marching_cubes(phi, iso),
                  jmesh.marching_cubes(phi, iso))
    _equal_meshes(tmesh.marching_tets(phi, iso),
                  jmesh.marching_tets(phi, iso))


def test_marching_cubes_matches_reference_binary():
    """The reference-binary goldens through the port: the same vertex set
    and oriented triangles as the binary's createMesh (the checks of
    tests/test_mesh.py:218-247)."""
    from mantaflow_tpu.io.uni import read_grid_uni, read_mesh_obj
    phi, _ = read_grid_uni(os.path.join(TESTDATA_REF, "mc_blob_phi.uni"))
    nodes, tris = tmesh.marching_cubes(np.asarray(phi))
    rn, rt = read_mesh_obj(os.path.join(TESTDATA_REF, "mc_blob_ref.obj"))
    assert len(nodes) == len(rn) and len(tris) == len(rt)
    cand = (nodes - 16.0) / 32.0
    d2 = ((cand[None, :, :] - rn[:, None, :]) ** 2).sum(-1)
    assert np.sqrt(d2.min(axis=1)).max() * 32 < 5e-3
    ours_of_ref = d2.argmin(axis=1)
    assert len(set(ours_of_ref.tolist())) == len(rn)
    ref_of_ours = np.empty(len(nodes), int)
    ref_of_ours[ours_of_ref] = np.arange(len(rn))

    def cyc(t):
        i = int(np.argmin(t))
        return (t[i], t[(i + 1) % 3], t[(i + 2) % 3])

    assert set(cyc(t) for t in ref_of_ours[tris]) == \
        set(cyc(t) for t in np.asarray(rt))


def test_marching_cubes_watertight():
    nodes, tris = tmesh.marching_cubes(_sphere_phi(32, (16, 16, 16), 9.0))
    edges = np.sort(np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]],
                                    tris[:, [2, 0]]]), axis=1)
    _, cnt = np.unique(edges, axis=0, return_counts=True)
    assert (cnt == 2).all()


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_advect_mesh_nodes_matches_reference(mode):
    n = 16
    jdom, dom = JDomain(size=(n,) * 3), Domain(size=(n,) * 3)
    nodes, _ = jmesh.marching_cubes(_sphere_phi(n, (8, 8, 8), 4.0))
    vel = (np.random.RandomState(2).randn(3, n, n, n) * 0.5).astype(
        np.float32)
    ref = np.asarray(jmesh.advect_mesh_nodes(nodes, jnp.asarray(vel), 0.8,
                                             jdom, mode))
    got = tmesh.advect_mesh_nodes(nodes, torch.from_numpy(vel), 0.8, dom,
                                  mode)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), ref, rtol=0, atol=1e-6)


def test_collide_mesh_nodes_matches_reference():
    """Nodes inside, at and outside a sphere, and outside the bnd=1 box;
    the gradient's one-sided edges (a sphere cut by the domain's side)."""
    n = 32
    jdom, dom = JDomain(size=(n,) * 3), Domain(size=(n,) * 3)
    phi = _sphere_phi(n, (16, 16, 3), 6.0)
    rng = np.random.RandomState(5)
    nodes = np.concatenate([
        rng.rand(200, 3).astype(np.float32) * n,
        np.array([[18.0, 16.0, 3.0], [22.5, 16.0, 3.0], [16.0, 16.0, 0.5],
                  [0.5, 0.5, 0.5], [28.0, 16.0, 16.0]], np.float32)])
    rp, rh = jmesh.collide_mesh_nodes(nodes, jnp.asarray(phi), jdom)
    gp, gh = tmesh.collide_mesh_nodes(nodes, torch.from_numpy(phi), dom)
    np.testing.assert_array_equal(_np(gh), np.asarray(rh))
    np.testing.assert_allclose(_np(gp), np.asarray(rp), rtol=0, atol=1e-6)
    assert int(_np(gh).sum()) >= 3
    # torch.gradient's edges are jnp.gradient's
    for ax in range(3):
        np.testing.assert_allclose(
            _np(torch.gradient(torch.from_numpy(phi), dim=ax,
                               edge_order=1)[0]),
            np.asarray(jnp.gradient(jnp.asarray(phi), axis=ax)), rtol=0,
            atol=1e-6)
    e = tmesh.collide_mesh_nodes(np.zeros((0, 3), np.float32),
                                 torch.from_numpy(phi), dom)
    assert e[0].shape == (0, 3) and e[1].shape == (0,)


@pytest.mark.parametrize("sigma,parent", [(2.0, None), (1.0, (48, 48, 48))])
def test_mesh_sdf_matches_reference(sigma, parent):
    n = 24
    jdom, dom = JDomain(size=(n,) * 3), Domain(size=(n,) * 3)
    nodes, tris = jmesh.marching_cubes(_sphere_phi(n, (12, 12, 12), 5.0))
    if parent is not None:
        nodes = nodes * 2.0  # a mesh of the parent grid's size
    ref = np.asarray(jmesh.mesh_sdf(nodes, tris, jdom, sigma,
                                    parent_size=parent))
    got = tmesh.mesh_sdf(nodes, tris, dom, sigma, parent_size=parent,
                         device=CPU)
    np.testing.assert_array_equal(_np(got), ref)
    empty = tmesh.mesh_sdf(nodes, tris[:0], dom, device=CPU)
    np.testing.assert_array_equal(
        _np(empty), np.asarray(jmesh.mesh_sdf(nodes, tris[:0], jdom)))


def test_mesh_to_levelset_and_parity_match_reference():
    n = 24
    jdom, dom = JDomain(size=(n,) * 3), Domain(size=(n,) * 3)
    nodes, tris = jmesh.marching_tets(_sphere_phi(n, (12, 12, 12), 5.0))
    ref = np.asarray(jmesh.mesh_to_levelset(nodes, tris, jdom))
    got = tmesh.mesh_to_levelset(nodes, tris, dom, device=CPU)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_np(got), ref)
    np.testing.assert_array_equal(tmesh._voxelize_parity(nodes, tris, dom),
                                  jmesh._voxelize_parity(nodes, tris, jdom))
    np.testing.assert_array_equal(
        _np(tmesh.mesh_to_levelset(nodes, tris[:0], dom, device=CPU)),
        np.asarray(jmesh.mesh_to_levelset(nodes, tris[:0], jdom)))


def test_topology_ops_match_reference():
    nodes, tris = jmesh.marching_cubes(_two_blobs())
    for name, args in (("smooth_mesh", (1.0, 2)),
                       ("subdivide_mesh", (0.7,)),
                       ("collapse_edges", (0.8, 0.01)),
                       ("collapse_edges", (0.0, 0.0)),
                       ("kill_small_components", (300,))):
        ref = getattr(jmesh, name)(nodes, tris, *args)
        got = getattr(tmesh, name)(nodes, tris, *args)
        if name == "smooth_mesh":
            np.testing.assert_array_equal(got, ref)
        else:
            _equal_meshes(got, ref)
    # the small blob goes, and a subdivision adds nodes
    assert 0 < len(tmesh.kill_small_components(nodes, tris, 300)[1]) \
        < len(tris)
    assert len(tmesh.subdivide_mesh(nodes, tris, 0.7)[0]) > len(nodes)


def test_case_tables_match_reference():
    assert tmesh._TETS == jmesh._TETS
    assert tmesh._MC_EDGES == jmesh._MC_EDGES
    assert tmesh._MC_FACES == jmesh._MC_FACES
    np.testing.assert_array_equal(tmesh._CORNER_OFF, jmesh._CORNER_OFF)
