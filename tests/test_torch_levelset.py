"""Levelset ops and the native fast march of mantaflow_tpu_torch vs
mantaflow_tpu.

The inputs are the JAX package's own: the basin+drop levelset of
``tests/test_levelset.py:test_value_transport_matches_native_fmm`` at 24³,
a 24² slice of it in 2D, and sinusoidal velocities. The JAX functions run
eagerly on the CPU, the port's with device="cpu".

Tolerances: the CSG ops, the flag initialisation and the hole filling are
exact. The redistancing takes square roots, and XLA's float32 square root
on the CPU is not correctly rounded (about 0.7 % of inputs differ from the
IEEE result by an ulp) where torch's is; so phi agrees to 2e-6 (ulps of
values up to 5), the velocity transport on the same phi to 1e-6, and the
transported velocity after the port's own redistancing to 2e-4 (a weight
|ret - phi(nb)| / sum is a difference of near-equal values, which turns an
ulp of phi into up to ~1e-5 relative). The native copy is exact: its
source bytes are the JAX package's and it computes the same serial march.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mantaflow_tpu.core import flags as jfl
from mantaflow_tpu.core import shapes as jsh
from mantaflow_tpu.core.domain import Domain as JDomain
from mantaflow_tpu.ops import levelset as jls
from mantaflow_tpu_torch import native as tnative
from mantaflow_tpu_torch.core.domain import Domain
from mantaflow_tpu_torch.ops import levelset as tls

RES = 24
PHI_TOL = 2e-6
VT_TOL = 1e-6
VEL_TOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs test files in parallel worker processes; torch's own
    thread pool in each would oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _t(a):
    return torch.from_numpy(np.array(a))


def _scene(dim):
    """The basin+drop levelset and its flags (bw 1), and a velocity field
    (tests/test_levelset.py:132-150); in 2D the slice through the drop."""
    size = (RES, RES, RES if dim == 3 else 1)
    jdom = JDomain(size=size, dim=dim)
    gs = np.array([RES, RES, RES], np.float64)
    zc = 0.5 if dim == 2 else gs[2] * 0.5
    basin = jsh.Box(p0=(0.0, 0.0, 0.0), p1=(gs[0], gs[1] * 0.25,
                                            gs[2] if dim == 3 else 1.0),
                    dim=dim)
    drop = jsh.Sphere(center=(gs[0] * 0.5, gs[1] * 0.6, zc),
                      radius=RES * 0.15)
    phi = jnp.minimum(jnp.full(jdom.shape, 1e10, jnp.float32),
                      basin.compute_levelset(jdom))
    phi = jnp.minimum(phi, drop.compute_levelset(jdom))
    flags = jfl.update_from_levelset(jfl.init_domain(jdom, 1), phi, 1e10)
    t = np.arange(RES, dtype=np.float32)
    zz, yy, xx = np.meshgrid(t[:jdom.shape[0]], t, t, indexing="ij")
    vel = np.stack([np.sin(0.4 * xx) * np.cos(0.3 * yy),
                    np.cos(0.25 * zz) * np.sin(0.35 * xx),
                    np.sin(0.3 * yy) * np.cos(0.2 * zz)]).astype(np.float32)
    if dim == 2:
        vel[2] = 0.0
    return (jdom, Domain(size=size, dim=dim), np.array(phi),
            np.array(flags), vel)


@pytest.fixture(scope="module", params=[3, 2], ids=["3d", "2d"])
def scene(request):
    return _scene(request.param)


def _distorted(phi):
    """Garbage away from the interface (tests/test_levelset.py:21-22)."""
    return np.where(np.abs(phi) > 1.0, phi * 7.0, phi).astype(np.float32)


def test_eikonal_update_matches_reference(scene):
    jdom, dom, phi, flags, _ = scene
    d = np.abs(_distorted(phi))
    frozen = np.abs(phi) < 1.0
    for _ in range(2):
        ref = np.array(jls._eikonal_update(jnp.asarray(d),
                                           jnp.asarray(frozen), jdom, 32.0))
        got = _np(tls._eikonal_update(_t(d), _t(frozen), dom, 32.0))
        np.testing.assert_allclose(got, ref, rtol=0, atol=PHI_TOL)
        d = ref


@pytest.mark.parametrize("max_time,ignore_walls,obstacle_type", [
    (4.0, False, jfl.TypeObstacle), (2.5, False, jfl.TypeObstacle),
    (6.0, True, jfl.TypeObstacle), (6.0, True, jfl.TypeReserved)])
def test_reinit_matches_reference(scene, max_time, ignore_walls,
                                  obstacle_type):
    jdom, dom, phi, flags, _ = scene
    phi = _distorted(phi)
    ref = np.array(jls.reinit(jnp.asarray(phi), jnp.asarray(flags), jdom,
                              max_time, ignore_walls, obstacle_type))
    got = _np(tls.reinit(_t(phi), _t(flags), dom, max_time, ignore_walls,
                         obstacle_type))
    np.testing.assert_allclose(got, ref, rtol=0, atol=PHI_TOL)
    np.testing.assert_array_equal(got < 0, ref < 0)


@pytest.mark.parametrize("max_time,ignore_walls", [(4.0, False),
                                                   (3.0, True)])
def test_value_transport_matches_reference(scene, max_time, ignore_walls):
    """On the same (JAX-redistanced) phi, so that only the transport's own
    arithmetic is compared."""
    jdom, dom, phi, flags, vel = scene
    rphi = np.array(jls.reinit(jnp.asarray(phi), jnp.asarray(flags), jdom,
                               max_time))
    ref = np.array(jls.value_transport_mac(
        jnp.asarray(rphi), jnp.asarray(flags), jnp.asarray(vel), jdom,
        max_time, ignore_walls))
    got = _np(tls.value_transport_mac(_t(rphi), _t(flags), _t(vel), dom,
                                      max_time, ignore_walls))
    np.testing.assert_allclose(got, ref, rtol=0, atol=VT_TOL)
    assert np.abs(got - vel).max() > 0.1  # something was transported


def test_reinit_marching_matches_reference(scene):
    jdom, dom, phi, flags, vel = scene
    jp, jv = jls.reinit_marching(jnp.asarray(phi), jnp.asarray(flags), jdom,
                                 jnp.asarray(vel))
    tp, tv = tls.reinit_marching(_t(phi), _t(flags), dom, _t(vel))
    np.testing.assert_allclose(_np(tp), np.array(jp), rtol=0, atol=PHI_TOL)
    np.testing.assert_allclose(_np(tv), np.array(jv), rtol=0, atol=VEL_TOL)
    jp, jv = jls.reinit_marching(jnp.asarray(phi), jnp.asarray(flags), jdom)
    tp, tv = tls.reinit_marching(_t(phi), _t(flags), dom)
    assert jv is None and tv is None
    np.testing.assert_allclose(_np(tp), np.array(jp), rtol=0, atol=PHI_TOL)


def test_csg_flags_and_holes_match_reference(scene):
    jdom, dom, phi, flags, _ = scene
    other = np.ascontiguousarray(phi[..., ::-1]) - 1.5
    for name in ("join", "subtract"):
        np.testing.assert_array_equal(
            _np(getattr(tls, name)(_t(phi), _t(other))),
            np.array(getattr(jls, name)(jnp.asarray(phi),
                                        jnp.asarray(other))))
    for ignore_walls in (False, True):
        got = tls.init_from_flags(_t(flags), dom, ignore_walls)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(
            _np(got), np.array(jls.init_from_flags(jnp.asarray(flags), jdom,
                                                   ignore_walls)))
    # a ring: the drop with a pocket cut out of it, then its hole filled
    c = (RES * 0.5, RES * 0.6, RES * 0.5 if dom.is3d else 0.5)
    pocket = np.array(jsh.Sphere(center=c, radius=1.6).compute_levelset(jdom))
    ring = np.where(pocket < 0, 0.7, phi).astype(np.float32)
    for depth in (3, 10):
        ref = np.array(jls.fill_holes(jnp.asarray(ring), jdom, depth))
        got = _np(tls.fill_holes(_t(ring), dom, depth))
        np.testing.assert_array_equal(got, ref)
    assert (got < 0).sum() > (ring < 0).sum()


# ---------------------------------------------------------------------------
# the native fast march


def test_native_source_is_the_reference_copy():
    import mantaflow_tpu
    from pathlib import Path
    ref = Path(mantaflow_tpu.__file__).parent / "native" / "fastmarch.cpp"
    assert tnative.SOURCE.read_bytes() == ref.read_bytes()
    # built beside the kernels' build directory, never into the package
    lib = tnative.library_path()
    assert lib.parent == tnative.BUILD_DIR
    assert tnative.BUILD_DIR.parent.name == "build"
    assert tnative.SOURCE.parent not in lib.parents
    assert not list(tnative.SOURCE.parent.glob("*.so"))


@pytest.mark.parametrize("with_vel,ignore_walls,correct", [
    (True, False, True), (False, False, True), (True, True, False)])
def test_native_reinit_march_matches_reference_native(scene, with_vel,
                                                      ignore_walls, correct):
    """Bit for bit the JAX package's native library on the same inputs."""
    from mantaflow_tpu import native as jnative
    if jnative.get_lib() is None:
        pytest.skip("the JAX package's native library is unavailable")
    jdom, dom, phi, flags, vel = scene
    phi = _distorted(phi)
    v = vel if with_vel else None
    rp, rv = jnative.reinit_march(phi, flags, v, 4.0, ignore_walls, correct)
    gp, gv = tnative.reinit_march(phi, flags, v, 4.0, ignore_walls, correct)
    np.testing.assert_array_equal(gp, rp)
    if with_vel:
        np.testing.assert_array_equal(gv, rv)
    else:
        assert gv is None and rv is None


def test_value_transport_matches_native_fmm():
    """tests/test_levelset.py's basin+drop through the port: the
    data-parallel transport on the native march's phi tracks the native
    march's own transport within that test's bounds."""
    jdom, dom, phi, flags, vel0 = _scene(3)
    phi_ref, vel_ref = tnative.reinit_march(phi, flags, vel0.copy(),
                                            max_time=4.0)
    got = _np(tls.value_transport_mac(_t(phi_ref), _t(flags), _t(vel0),
                                      dom, 4.0))
    band = (phi_ref > 0) & (phi_ref <= 4.0)
    band[[0, -1], :, :] = band[:, [0, -1], :] = band[:, :, [0, -1]] = False
    d = np.abs(got - vel_ref)[:, band]
    assert float(d.mean()) < 5e-3
    assert float((d > 0.05).mean()) < 0.02


def test_native_build_failure_raises(monkeypatch, tmp_path):
    bad = tmp_path / "fastmarch.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SOURCE", bad)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "_LIB", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tnative.reinit_march(np.zeros((4, 4, 4), np.float32),
                             np.zeros((4, 4, 4), np.int32))
    assert not list((tmp_path / "build").glob("*.so"))


def test_native_load_failure_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(tnative, "_LIB", None)
    tnative.library_path().write_bytes(b"not a shared library")
    with pytest.raises(RuntimeError, match="cannot load"):
        tnative.get_lib()


def test_native_without_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="native fastmarch"):
        tnative.get_lib()


def test_invalid_time_marker():
    for t in (1.0, 4.0, 6.5):
        assert tls.InvalidTime(t) == jls.InvalidTime(t)


def test_sqrt_and_third_round_as_ieee():
    """The helpers the card relies on to compute what the CPU does: the
    square root correctly rounded, the division by 3 a true division."""
    x = np.random.RandomState(3).rand(100000).astype(np.float32) * 10
    np.testing.assert_array_equal(_np(tls._sqrt(_t(x))), np.sqrt(x))
    np.testing.assert_array_equal(_np(tls._third(_t(x))),
                                  x / np.float32(3.0))
