"""K3's two forms beside the step's: the advection without the blend
(``advect_bucket_kernels.advect``, the port of ``advect_pallas``) and
``stop_in_obstacle=False`` on every form, through their plain versions on
the CPU, against the JAX package's ``advect_bucketed`` and
``advect_pallas(interpret=True)``.

Fixtures: the 16^3 dam and the 24^3 corner dam of tests/test_flip_bucket.py
(made-up particle velocities), the corner dam with a stamped sphere
obstacle and displacements that reach it and the domain's walls, so that
stopping changes the result. Tolerance: abs 1e-6, the JAX tests'
Pallas-vs-XLA tolerance for the advection; the velocities the form
without the blend passes through are the inputs bit for bit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mantaflow_tpu.core.domain import Domain as JDomain
from mantaflow_tpu.core.shapes import Sphere as JSphere
from mantaflow_tpu.models import flip as jflip
from mantaflow_tpu.ops import flip_bucket as jfb
from mantaflow_tpu_torch.core import flags as tfl
from mantaflow_tpu_torch.core.domain import Domain
from mantaflow_tpu_torch.models import flip as tflip
from mantaflow_tpu_torch.ops import advect_bucket_kernels as tadv
from mantaflow_tpu_torch.ops import flip_bucket as tfb

FIELDS = ("px", "py", "pz", "vx", "vy", "vz")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fixture(res, frac, ppc, sphere):
    jdom, dom = JDomain(size=(res,) * 3), Domain(size=(res,) * 3)
    kw = dict(gravity=(0.0, -0.003, 0.0), ghost_fluid=True)
    jst = jflip.make_dam_state_bucketed(jdom, jflip.FlipParams(**kw),
                                        dam_frac=frac, ppc=ppc)
    tst = tflip.make_dam_state_bucketed(dom, tflip.FlipParams(**kw),
                                        dam_frac=frac, ppc=ppc, device="cpu")
    jflags, tflags = jst.flags, tst.flags
    if sphere:
        inside = np.asarray(JSphere(center=(5.0, 4.0, 4.5), radius=3.0)
                            .inside_grid(jdom))
        jflags = jnp.where(inside, 2, jflags)
        tflags = torch.where(torch.tensor(inside), tfl.TypeObstacle, tflags)

    def made_up(bk, where):
        return dataclasses.replace(
            bk, vx=where(bk.valid, bk.px * 0.01, 0.0),
            vy=where(bk.valid, bk.py * 0.02 - 0.05, 0.0),
            vz=where(bk.valid, bk.pz * 0.005, 0.0))
    vel = np.random.RandomState(7).randn(3, res, res, res).astype(np.float32)
    return (jdom, dom, jflags, tflags, made_up(jst.buckets, jnp.where),
            made_up(tst.buckets, torch.where), vel)


@pytest.fixture(scope="module")
def fixtures():
    return {"dam16": _fixture(16, (0.4, 0.6, 1.0), 14, False),
            "corner24_sphere": _fixture(24, (0.3, 0.3, 0.35), 12, True)}


def _assert_close(got, ref, atol=1e-6, fields=FIELDS):
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    for f in fields:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=0,
                                   atol=atol, err_msg=f)


@pytest.mark.parametrize("name", ["dam16", "corner24_sphere"])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_no_stop_matches_reference(fixtures, name, mode):
    """advect_bucketed(stop_in_obstacle=False): no stage zeroed, no
    bisection, the clamp to [0, n-1] kept; displacements of up to a cell
    (dt 4 on a velocity of ~0.25-1) so that walls and the sphere are
    reached."""
    jdom, dom, jflags, tflags, jbk, tbk, vel = fixtures[name]
    for dt in (0.5, 4.0):
        ref = jfb.advect_bucketed(jbk, jflags, jnp.asarray(vel), dt, jdom,
                                  mode, stop_in_obstacle=False)
        got = tfb.advect_bucketed(tbk, tflags, torch.tensor(vel),
                                  torch.tensor(dt), dom, mode,
                                  stop_in_obstacle=False)
        _assert_close(got, ref)
    # the flag has teeth: stopping moves some particle elsewhere
    stop = tfb.advect_bucketed(tbk, tflags, torch.tensor(vel),
                               torch.tensor(4.0), dom, mode)
    assert not torch.equal(stop.px, got.px) or \
        not torch.equal(stop.py, got.py)


@pytest.mark.parametrize("stop", [True, False])
def test_no_blend_form_matches_pallas_interpret(fixtures, stop):
    """advect (the form without the blend) against advect_pallas in
    interpret mode, Euler (the interpreted RK4 compile takes minutes; the
    modes are held against advect_bucketed above), positions moved and
    velocities passed through."""
    from mantaflow_tpu.ops import flip_bucket_pallas as fbp
    jdom, dom, jflags, tflags, jbk, tbk, vel = fixtures["corner24_sphere"]
    ref = fbp.advect_pallas(jbk, jflags, jnp.asarray(vel * 4), 1.0, jdom, 0,
                            stop_in_obstacle=stop, interpret=True)
    got = tadv.advect(tbk, tflags, torch.tensor(vel * 4), torch.tensor(1.0),
                      dom, 0, stop_in_obstacle=stop)
    _assert_close(got, ref)
    for f in ("vx", "vy", "vz"):
        assert torch.equal(getattr(got, f), getattr(tbk, f))


@pytest.mark.parametrize("mode", [0, 2])
@pytest.mark.parametrize("pending", [True, False])
def test_blend_forms_without_stop_match_reference(fixtures, mode, pending):
    """advect_blend and advect_blend_live with stop_in_obstacle=False: the
    JAX package's blend where pending, then advect_bucketed without
    stopping."""
    jdom, dom, jflags, tflags, jbk, tbk, vel = fixtures["corner24_sphere"]
    vold = vel * np.float32(0.85)
    ref = jfb.flip_update_bucketed(jbk, jnp.asarray(vel), jnp.asarray(vold),
                                   0.97, jdom) if pending else jbk
    ref = jfb.advect_bucketed(ref, jflags, jnp.asarray(vel), 2.0, jdom, mode,
                              stop_in_obstacle=False)
    for fn in (tadv.advect_blend, tadv.advect_blend_live):
        got = fn(tbk, tflags, torch.tensor(vel), torch.tensor(vold),
                 torch.tensor(2.0), torch.tensor(pending), 0.97, dom, mode,
                 stop_in_obstacle=False)
        _assert_close(got, ref)


def test_slab_plain_without_stop_equals_whole(fixtures):
    """The z-slab plain form with stop_in_obstacle=False over 3 slabs of
    8 planes equals the one-domain plain form on each slab's cells (no
    obstacle mask is needed)."""
    _, dom, _, tflags, _, tbk, vel = fixtures["corner24_sphere"]
    v = torch.tensor(vel)
    args = (v, v * 0.85, torch.tensor(2.0), torch.tensor(True), 0.97)
    whole = tadv.advect_blend_plain(tbk, tflags, *args, dom, 2,
                                    stop_in_obstacle=False)
    per = 24 * 24 * 8
    for s in range(3):
        z0 = 8 * s
        sl = dataclasses.replace(tbk, **{
            f: getattr(tbk, f)[:, s * per:(s + 1) * per].contiguous()
            for f in FIELDS + ("valid",)})
        lo, hi = z0 - 2, z0 + 10
        pad = (max(0, -lo), max(0, hi - 24))

        def halo(g):
            g = g[:, max(lo, 0):min(hi, 24)]
            return torch.nn.functional.pad(g, (0, 0, 0, 0) + pad)
        got = tadv.advect_blend_slab(sl, None, halo(args[0]), halo(args[1]),
                                     *args[2:], dom, z0, 2,
                                     stop_in_obstacle=False)
        for f in FIELDS:
            assert torch.equal(getattr(got, f),
                               getattr(whole, f)[:, s * per:(s + 1) * per])


FORMS = ("advect", "advect_blend_plain", "advect_blend", "advect_blend_live",
         "advect_blend_slab_plain", "advect_blend_slab",
         "advect_blend_slab_live", "advect_blend_zshard")


@pytest.mark.parametrize("name", FORMS)
def test_form_flags_are_keywords(fixtures, name):
    """``ring_only`` and ``stop_in_obstacle`` are keyword-only on every
    form, so that a call in the JAX package's positional order (mode,
    stop_in_obstacle, ring_only) raises instead of swapping the flags."""
    import inspect
    params = inspect.signature(getattr(tadv, name)).parameters
    for flag in ("ring_only", "stop_in_obstacle"):
        assert params[flag].kind is inspect.Parameter.KEYWORD_ONLY, flag
    if name in ("advect", "advect_blend"):
        _, dom, _, tflags, _, tbk, vel = fixtures["corner24_sphere"]
        v = torch.tensor(vel)
        lead = ((tbk, tflags, v, torch.tensor(1.0), dom) if name == "advect"
                else (tbk, tflags, v, v * 0.85, torch.tensor(1.0),
                      torch.tensor(True), 0.97, dom))
        with pytest.raises(TypeError):
            getattr(tadv, name)(*lead, 0, False, True)
