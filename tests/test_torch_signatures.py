"""The port's public functions take the JAX package's positional calls.

For each module the two packages share (the ``*_pallas*`` kernel files and
``native/`` left out), every public function of the JAX package that the
port also has must accept the JAX package's positional parameters, under
the same names in the same order, and require no parameter the JAX
package's function does not: a scene or a caller written against the JAX
package then calls the port unchanged.
"""

from __future__ import annotations

import importlib
import inspect
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
_POSITIONAL = (inspect.Parameter.POSITIONAL_ONLY,
               inspect.Parameter.POSITIONAL_OR_KEYWORD)


def _modules(pkg: str) -> set:
    out = set()
    for f in (ROOT / pkg).rglob("*.py"):
        rel = f.relative_to(ROOT / pkg).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        if not parts or "_pallas" in rel.name or parts[0] == "native":
            continue
        out.add(".".join(parts))
    return out


PAIRS = sorted(_modules("mantaflow_tpu") & _modules("mantaflow_tpu_torch"))


def test_the_pairs_cover_the_packages():
    assert len(PAIRS) >= 60
    for name in ("core.masks", "ops.pressure", "parallel.sharding",
                 "scene.api", "scene.zflip_api"):
        assert name in PAIRS


def _mismatch(fj, fp):
    """Why ``fp`` cannot stand where ``fj`` is called, or None."""
    try:
        sj, sp = inspect.signature(fj), inspect.signature(fp)
    except (TypeError, ValueError):
        return None
    jpos = [p for p in sj.parameters.values() if p.kind in _POSITIONAL]
    jreq = [p.name for p in jpos if p.default is p.empty]
    ppar = list(sp.parameters.values())
    ppos = [p.name for p in ppar if p.kind in _POSITIONAL]
    preq = [p.name for p in ppar if p.default is p.empty
            and p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]
    if preq != jreq[:len(preq)]:
        return f"requires {preq}, the JAX package {jreq}"
    if any(p.kind == p.VAR_POSITIONAL for p in ppar):
        return None
    if ppos[:len(jpos)] != [p.name for p in jpos]:
        return f"positional {ppos}, the JAX package {[p.name for p in jpos]}"
    return None


@pytest.mark.parametrize("name", PAIRS)
def test_port_functions_take_the_jax_calls(name):
    jmod = importlib.import_module("mantaflow_tpu." + name)
    pmod = importlib.import_module("mantaflow_tpu_torch." + name)
    bad = []
    for fname, fj in vars(jmod).items():
        if fname.startswith("_") or not inspect.isfunction(fj) \
                or fj.__module__ != jmod.__name__:
            continue
        fp = getattr(pmod, fname, None)
        if fp is None or not callable(fp):
            continue
        why = _mismatch(fj, fp)
        if why:
            bad.append(f"{fname}: {why}")
    assert not bad, bad


def test_the_check_sees_a_required_device():
    def jax_fn(dom, bnd):
        pass

    def port_fn(dom, bnd, device):
        pass

    def port_ok(dom, bnd, device=None):
        pass
    assert _mismatch(jax_fn, port_fn)
    assert _mismatch(jax_fn, port_ok) is None


def test_masks_take_the_runner_device():
    import torch
    import mantaflow_tpu_torch as port
    from mantaflow_tpu_torch.core.domain import Domain
    from mantaflow_tpu_torch.core.masks import axis_index, interior_mask
    dom = Domain((6, 5, 4))
    old = port.default_device[0]
    port.default_device[0] = torch.device("cpu")
    try:
        m = interior_mask(dom, 1)
        assert m.device.type == "cpu" and int(m.sum()) == 4 * 3 * 2
        assert torch.equal(axis_index(dom, "y").flatten(),
                           torch.arange(5, dtype=torch.int32))
    finally:
        port.default_device[0] = old
