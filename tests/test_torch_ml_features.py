"""The ML toolbox's feature extraction and region analysis
(mantaflow_tpu_torch/ml/features.py) against the JAX package's, and the
toolbox's import boundary.

Inputs are made from a seed with numpy at 16^3. The extractors interpolate
with the same float32 operations: held to 1e-6. Region labels, counts and
the grown flags are integers: exactly equal.
"""

import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mantaflow_tpu.core import particles as jcp
from mantaflow_tpu.core.domain import Domain as JDomain
from mantaflow_tpu.ml import features as jft
from mantaflow_tpu_torch.core import particles as tcp
from mantaflow_tpu_torch.core.domain import Domain
from mantaflow_tpu_torch.ml import features as tft

RES = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(0)
    n = 300
    pos = rng.uniform(-0.5, RES + 0.5, (n, 3)).astype(np.float32)
    vel = rng.randn(3, RES, RES, RES).astype(np.float32)
    phi = rng.randn(RES, RES, RES).astype(np.float32)
    flags = rng.choice([1, 2, 4], size=(RES,) * 3).astype(np.int32)
    ptype = rng.choice([0, 1, 4], size=n + 20).astype(np.int32)
    jparts = jcp.make_particles(pos, capacity=n + 20)
    tparts = tcp.make_particles(pos, capacity=n + 20, device="cpu")
    # one deleted particle
    jparts = jparts.__class__(pos=jparts.pos,
                              flags=jparts.flags.at[3].set(jcp.PDELETE),
                              count=jparts.count)
    tparts.flags[3] = tcp.PDELETE
    return dict(vel=vel, phi=phi, flags=flags, ptype=ptype, jparts=jparts,
                tparts=tparts)


@pytest.mark.parametrize("kind", ["vel", "phi", "geo"])
@pytest.mark.parametrize("with_ptype", [False, True])
def test_extractors_match_reference(inputs, kind, with_ptype):
    grid = {"vel": inputs["vel"], "phi": inputs["phi"],
            "geo": inputs["flags"]}[kind]
    kw = dict(scale=0.5, window=1)
    if with_ptype:
        jkw = dict(kw, ptype=jnp.asarray(inputs["ptype"]), exclude=4 | 2)
        tkw = dict(kw, ptype=torch.tensor(inputs["ptype"]), exclude=4 | 2)
    else:
        jkw = tkw = kw
    jfn = getattr(jft, f"extract_feature_{kind}")
    tfn = getattr(tft, f"extract_feature_{kind}")
    want = np.asarray(jfn(inputs["jparts"], jnp.asarray(grid),
                          JDomain(size=(RES,) * 3), **jkw))
    got = tfn(inputs["tparts"], torch.tensor(grid), Domain(size=(RES,) * 3),
              **tkw).numpy()
    assert got.shape == want.shape == (320, 27 * (3 if kind == "vel" else 1))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert not got[3].any() and not got[300:].any()


def _flag_cases():
    rng = np.random.RandomState(1)
    rand3 = rng.choice([1, 2, 4], size=(RES,) * 3,
                       p=[0.45, 0.1, 0.45]).astype(np.int32)
    k, j, i = np.indices((RES,) * 3)
    checker = np.where((i + j + k) % 2 == 0, 1, 4).astype(np.int32)
    rand2 = rng.choice([1, 4], size=(1, RES, RES)).astype(np.int32)
    full = np.ones((4, 5, 6), np.int32)  # no background: ids from 0
    return {"random_3d": (rand3, (RES,) * 3, 3),
            "checkerboard": (checker, (RES,) * 3, 3),
            "random_2d": (rand2, (RES, RES, 1), 2),
            "all_member": (full, (6, 5, 4), 3)}


@pytest.mark.parametrize("case", sorted(_flag_cases()))
@pytest.mark.parametrize("ctype", [1, 4])
def test_regions_and_counts_exact(case, ctype):
    flags, size, dim = _flag_cases()[case]
    jdom, dom = JDomain(size=size, dim=dim), Domain(size=size, dim=dim)
    jl, jn = jft.get_regions(jnp.asarray(flags), jdom, ctype)
    tl, tn = tft.get_regions(torch.tensor(flags), dom, ctype)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert int(tn) == int(jn)
    assert tl.dtype == torch.int32
    np.testing.assert_array_equal(
        tft.get_regional_counts(torch.tensor(flags), dom, ctype).numpy(),
        np.asarray(jft.get_regional_counts(jnp.asarray(flags), jdom,
                                           ctype)))


@pytest.mark.parametrize("depth", [1, 3])
def test_extend_region_exact(depth):
    flags, size, dim = _flag_cases()["random_3d"]
    got = tft.extend_region(torch.tensor(flags), Domain(size=size), 4, 2,
                            depth)
    want = jft.extend_region(jnp.asarray(flags), JDomain(size=size), 4, 2,
                             depth)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ml_imports_no_jax():
    """No module of the port's ml/ imports jax, flax, optax or the JAX
    package."""
    root = pathlib.Path(tft.__file__).resolve().parent
    banned = ("jax", "flax", "optax", "mantaflow_tpu")
    files = sorted(root.glob("*.py"))
    assert len(files) >= 10
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in banned, f"{path.name} imports {name}"
