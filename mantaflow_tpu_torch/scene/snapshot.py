"""A scene's final state as host arrays, and the rules that hold two runs
of one scene against each other.

``snapshot(globals)`` walks a scene's globals (what ``run.run_scene``
returns, or ``runpy.run_path`` for the JAX package's run of the same
file) and returns ``{key: (kind, array)}``. Objects are recognised by the
names of their classes, which both scene APIs share, and arrays are read
through ``numpy.asarray`` (a torch tensor through ``.detach().cpu()``), so
this module imports neither package. The kinds:

- ``exact``: FlagGrid, IntGrid and Grid4Int data, integer particle data,
  particle flags, the counts (``pySize()``, a mesh's ``numTris()``, a
  tracer system's length), the solver's frame and integer numpy arrays;
- ``levelset``: LevelsetGrid data;
- ``field``: every other grid, particle array (its first ``pySize()``
  rows), mesh nodes, float numpy array and the solver's time step.

``snapshot(scope, members=True)`` also reads a function's locals, as
``returned_locals`` catches them where the scene keeps its state there
(``zflip.py``'s ``run_zflip``): a list of numbers (``exact`` if integer),
a Python int (``exact``) or float (``field``), and the attributes of each
object whose class the scene itself defines (under ``name.attr``).

``compare(a, b, field_tol, ...)`` holds snapshot ``a`` against ``b``: the
exact kinds equal; a levelset within ``levelset_tol`` of its scale (the
largest magnitude below the far-field sentinel 1e9); a field within
``field_tol`` x max(1, its scale). ``limits`` gives a key its own absolute
limit. A key in only one snapshot is a difference too.
"""

from __future__ import annotations

import contextlib
import sys

import numpy as np

#: a levelset's far-field value (``phi.setConst(1e10)``) lies above this;
#: it counts in the difference, not in the scale
FAR_FIELD = 1e9


def _host(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu()
    return np.asarray(x)


def _names(obj) -> set:
    return {c.__name__ for c in type(obj).__mro__}


def _float_or_exact(a: np.ndarray) -> str:
    return "field" if a.dtype.kind in "fc" else "exact"


def _scene_object(v) -> bool:
    """An instance of a class that the scene file itself defines."""
    return type(v).__module__ == "__main__" and hasattr(v, "__dict__")


def snapshot(scene_globals: dict, members: bool = False) -> dict:
    """``{key: (kind, array)}`` of every grid, particle system, particle
    datum, mesh, tracer system, solver and numpy array in the globals;
    with ``members``, also the numbers and the scene's own objects (the
    module's docstring)."""
    out = {}
    if members:
        for name, v in sorted(scene_globals.items()):
            if _scene_object(v):
                inner = {k: w for k, w in vars(v).items()
                         if not _scene_object(w)}
                for k, kv in snapshot(inner, members=True).items():
                    out[f"{name}.{k}"] = kv
    _put_all(out, scene_globals, members)
    return out


def _put_all(out: dict, scene_globals: dict, members: bool):
    def put(key, kind, arr):
        out[key] = (kind, np.array(arr))  # a copy: the scene runs on

    for name, v in sorted(scene_globals.items()):
        if name.startswith("__"):
            continue
        if members and not isinstance(v, bool):
            if isinstance(v, int):
                put(name, "exact", np.asarray(v))
                continue
            if isinstance(v, float):
                put(name, "field", np.asarray(v))
                continue
            if isinstance(v, list) and v and all(
                    isinstance(x, (int, float)) and not isinstance(x, bool)
                    for x in v):
                a = np.asarray(v)
                put(name, _float_or_exact(a), a)
                continue
        names = _names(v)
        if "GridBase" in names or "Grid4Base" in names:
            a = _host(v.data)
            if "LevelsetGrid" in names:
                put(name, "levelset", a)
            else:
                put(name, _float_or_exact(a), a)
        elif "BasicParticleSystem" in names:
            n = v.pySize()
            put(f"{name}.count", "exact", np.asarray(n))
            put(f"{name}.pos", "field", _host(v.parts.pos)[:n])
            put(f"{name}.flags", "exact", _host(v.parts.flags)[:n])
        elif "PdataBase" in names:
            a = _host(v.data)[:v.parent.pySize()]
            put(name, _float_or_exact(a), a)
        elif "TurbulenceParticleSystem" in names:
            pos = _host(v.pos)
            put(f"{name}.count", "exact", np.asarray(len(pos)))
            put(f"{name}.pos", "field", pos)
            for t in ("tex0", "tex1"):
                put(f"{name}.{t}", "field", _host(getattr(v, t)))
        elif "Mesh" in names:
            put(f"{name}.count", "exact", np.asarray(v.numTris()))
            put(f"{name}.nodes", "field", _host(v.nodes))
        elif "Solver" in names:
            put(f"{name}.frame", "exact", np.asarray(v.frame))
            put(f"{name}.timestep", "field", np.asarray(float(v.timestep)))
        elif isinstance(v, np.ndarray) and v.dtype.kind in "biuf":
            put(name, _float_or_exact(v), v)


@contextlib.contextmanager
def returned_locals(func_name: str, filename: str | None = None):
    """Yields a dict that receives the locals of the frame of the function
    ``func_name`` (defined in ``filename``, if given) as it returns, for a
    scene that keeps its state in a function (``zflip.py:run_zflip``). A
    ``sys.monitoring`` tool watches each function's first start once and
    only that function's returns after."""
    mon = sys.monitoring
    tool = next((i for i in range(6) if mon.get_tool(i) is None), None)
    if tool is None:
        raise RuntimeError("no free sys.monitoring tool id")
    got = {}
    watched = []

    def ours(code):
        return code.co_name == func_name and (
            filename is None or code.co_filename == filename)

    def start(code, offset):
        if ours(code):
            mon.set_local_events(tool, code, mon.events.PY_RETURN)
            watched.append(code)
        return mon.DISABLE

    def returned(code, offset, value):
        if ours(code):
            got.clear()
            got.update(sys._getframe(1).f_locals)

    mon.use_tool_id(tool, "scene snapshot")
    try:
        mon.register_callback(tool, mon.events.PY_START, start)
        mon.register_callback(tool, mon.events.PY_RETURN, returned)
        mon.set_events(tool, mon.events.PY_START)
        yield got
    finally:
        mon.set_events(tool, 0)
        for code in watched:
            mon.set_local_events(tool, code, 0)
        mon.register_callback(tool, mon.events.PY_START, None)
        mon.register_callback(tool, mon.events.PY_RETURN, None)
        mon.free_tool_id(tool)
        mon.restart_events()


def meshes(out_dir: str, pattern: str = "surface_*.bobj.gz") -> dict:
    """The ``.bobj.gz`` meshes a run wrote into ``out_dir`` as snapshot
    entries: each file's triangle count (``exact``) and nodes (``field``,
    in the file's world space)."""
    import glob
    import gzip
    import os
    import struct
    out = {}
    for path in sorted(glob.glob(os.path.join(out_dir, pattern))):
        with gzip.open(path, "rb") as f:
            (nv,) = struct.unpack("i", f.read(4))
            nodes = np.frombuffer(f.read(nv * 12), np.float32)
            (nn,) = struct.unpack("i", f.read(4))
            f.read(nn * 12)
            (nt,) = struct.unpack("i", f.read(4))
        key = os.path.basename(path)
        out[f"{key}.count"] = ("exact", np.asarray(nt))
        out[f"{key}.nodes"] = ("field", nodes.reshape(nv, 3).copy())
    return out


def save(path: str, snap: dict):
    """The snapshot as an npz: each array under ``kind:key``."""
    np.savez(path, **{f"{kind}:{key}": a for key, (kind, a) in snap.items()})


def load(path: str) -> dict:
    with np.load(path) as z:
        return {k.split(":", 1)[1]: (k.split(":", 1)[0], z[k])
                for k in z.files}


def compare(a: dict, b: dict, field_tol: float, levelset_tol: float = 2e-4,
            limits: dict | None = None) -> dict:
    """``{key: (max abs diff, limit)}`` of snapshot ``a`` against ``b``,
    with the rules of the module's docstring; the diff is inf where the
    shapes or the kinds differ or a key is missing."""
    limits = limits or {}
    out = {}
    for key in sorted(set(a) | set(b)):
        if key not in a or key not in b or a[key][0] != b[key][0] \
                or a[key][1].shape != b[key][1].shape:
            out[key] = (float("inf"), 0.0)
            continue
        kind, x = a[key]
        y = b[key][1]
        if kind == "exact":
            d = 0.0 if np.array_equal(x, y) else float(np.abs(
                x.astype(np.float64) - y.astype(np.float64)).max())
            out[key] = (d, limits.get(key, 0.0))
            continue
        x, y = x.astype(np.float64), y.astype(np.float64)
        if not (np.isfinite(x).all() and np.isfinite(y).all()):
            out[key] = (float("inf"), 0.0)
            continue
        d = float(np.abs(x - y).max()) if x.size else 0.0
        ay = np.abs(y)
        if kind == "levelset":
            near = ay[ay < FAR_FIELD]
            lim = levelset_tol * (float(near.max()) if near.size else 1.0)
        else:
            lim = field_tol * max(1.0, float(ay.max()) if ay.size else 0.0)
        out[key] = (d, limits.get(key, lim))
    return out


def failures(cmp: dict) -> dict:
    """The entries of a ``compare`` result beyond their limit."""
    return {k: v for k, v in cmp.items() if not v[0] <= v[1]}
