"""The step's bucket advection (``ops/advect_bucket_kernels.py:
advect_blend_live``; on the CPU its plain version) against the JAX
package's Pallas kernel, ``advect_blend_pallas`` in interpret mode, as
tests/test_flip_bucket.py runs it: on the 16^3 dam and the 24^3 corner dam
of tests/test_torch_advect_live.py, the Euler stage, pending true and
false through one compiled call, with the bounds test alone and with a
stamped sphere obstacle. The RK2 and RK4 stages are held against the JAX
CPU branch there: the interpreter takes minutes to compile them. The
live slots to abs 1e-6 (the JAX tests' Pallas-vs-XLA tolerance). A file
of its own, so that a parallel test run spreads the interpreter's time.
"""

import pytest
import torch

from mantaflow_tpu_torch.ops import advect_bucket_kernels as advk
from test_torch_advect_live import (FIXTURES, _args, _assert_live_close,
                                    _fixture, _jax_inputs)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs test files in parallel worker processes; torch's own
    thread pool in each would oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=sorted(FIXTURES))
def cpu_fixture(request):
    return (request.param,) + _fixture(request.param, "cpu")


@pytest.mark.parametrize("ring_only", [True, False])
def test_step_form_matches_pallas_kernel(cpu_fixture, ring_only):
    import jax
    import jax.numpy as jnp
    from mantaflow_tpu.ops import flip_bucket_pallas as jfbp
    which, *fx = cpu_fixture
    jdom, jbk, jflags, jvel = _jax_inputs(fx, ring_only)
    kernel = jax.jit(lambda p: jfbp.advect_blend_pallas(
        jbk, jflags, jvel, jvel * 0.85, 0.5, p, 0.97, jdom, 0,
        ring_only=ring_only, interpret=True))
    for pending in (True, False):
        args, kw = _args(fx, 0, pending, ring_only)
        got = advk.advect_blend_live(*args, **kw)
        _assert_live_close(got, kernel(jnp.asarray(pending)), fx[3].valid)
