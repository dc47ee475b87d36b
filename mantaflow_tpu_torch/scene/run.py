"""Run an unedited mantaflow_tpu scene file against the port.

Usage::

    python -m mantaflow_tpu_torch.scene.run [--device cuda|cpu] SCENE.py [args]

The port's counterpart of ``python scenes/X.py``, whose import line ties
the scene to the JAX package: ``mantaflow_tpu`` and every
``mantaflow_tpu.<sub>`` are mapped onto the port's module of the same name
(a meta-path finder plus ``sys.modules`` entries), and the file runs as
``runpy.run_path(..., run_name="__main__")`` runs it, with its own
``sys.argv``. The device is CUDA unless ``--device cpu`` is given;
without a GPU and without ``--device`` the run raises (the port never
falls back to the CPU).

Run as its own process, the runner raises if ``jax`` or the JAX package
ends up in ``sys.modules``. In-process (``run_scene``), it checks that
every ``mantaflow_tpu*`` module the scene imported is the port's, and puts
back whatever ``mantaflow_tpu*`` entries were there before, so a process
that also holds the JAX package keeps it.

Every scene of ``scenes/`` runs unedited. Two imports of a scene's own
module are the runner's, through the scene's ``__builtins__``:

- ``import jax.numpy`` (``zflip.py``) gives ``_SceneJnp``, three names
  backed by torch on the runner's device (``asarray``, ``where``,
  ``int32``; any other raises an ``AttributeError`` that names it). The
  stand-in is returned before any real import is tried, so a process that
  holds JAX does not hand it to the scene, and nothing named ``jax``
  enters ``sys.modules``.
- ``import sys`` gives ``_SceneSys``: Python's ``sys`` but for
  ``executable``, a launcher of the port's (``launcher(device)``, a shell
  script under ``build/scene_launch/``, written when the scene first reads
  ``sys.executable``) that runs its arguments as
  ``python -m mantaflow_tpu_torch.scene.run [--device cpu] SCENE ARGS``
  with the repo on ``PYTHONPATH``. ``scenes/run.py`` starts each method as
  ``[sys.executable, zflip.py, ...]`` with ``cwd`` its output directory:
  each child runs ``zflip.py`` through the runner on the runner's device,
  with no JAX loaded; a CUDA child started without a GPU raises.

A scene that ends with ``sys.exit(0)`` (``run.py``) ends normally; any
other exit code is raised on.

A scene reads its results as a JAX scene does, ``np.asarray(state.density)``
of a state field on any device. The scene's own module gets its ``numpy``
from ``_SceneNumpy`` (``import numpy`` there resolves through the scene's
``__builtins__``): numpy itself, but for ``asarray`` and ``array``, which
first take a torch tensor to the host (``.detach().cpu()``). Numpy stays as
it is everywhere else, the port's modules and the scene's other imports
included, and numpy or host arrays pass through unchanged.
"""

from __future__ import annotations

import builtins
import contextlib
import hashlib
import importlib
import importlib.abc
import importlib.util
import io
import os
import shlex
import sys
import types

import numpy

ALIAS = "mantaflow_tpu"
PORT = "mantaflow_tpu_torch"


def _is_alias(name: str) -> bool:
    return name == ALIAS or name.startswith(ALIAS + ".")


def _port_name(name: str) -> str:
    return PORT + name[len(ALIAS):]


class _AliasLoader(importlib.abc.Loader):
    def create_module(self, spec):
        return importlib.import_module(_port_name(spec.name))

    def exec_module(self, module):
        pass  # the port's module has run already


class _AliasFinder(importlib.abc.MetaPathFinder):
    """Resolves ``mantaflow_tpu[.sub]`` to the port's module of that name."""

    def find_spec(self, fullname, path=None, target=None):
        if not _is_alias(fullname):
            return None
        if importlib.util.find_spec(_port_name(fullname)) is None:
            return None
        return importlib.util.spec_from_loader(fullname, _AliasLoader())


@contextlib.contextmanager
def _aliased(device, isolate=()):
    """Maps the JAX package's names onto the port for the duration, with
    ``device`` as the port's default device; restores every entry after.
    Modules under the ``isolate`` prefixes are imported afresh inside and
    put back as they were after (scene modules that import each other)."""
    import mantaflow_tpu_torch as port

    def ours(k):
        return _is_alias(k) or any(k == p or k.startswith(p + ".")
                                   for p in isolate)
    saved = {k: v for k, v in sys.modules.items() if ours(k)}
    for k in saved:
        del sys.modules[k]
    for k, mod in list(sys.modules.items()):
        if k == PORT or k.startswith(PORT + "."):
            sys.modules[ALIAS + k[len(PORT):]] = mod
    finder = _AliasFinder()
    sys.meta_path.insert(0, finder)
    old_device = port.default_device[0]
    port.default_device[0] = device
    try:
        yield
    finally:
        port.default_device[0] = old_device
        sys.meta_path.remove(finder)
        for k in [k for k in sys.modules if ours(k)]:
            del sys.modules[k]
        sys.modules.update(saved)


def _check_port_only(scene_globals):
    """Every mantaflow_tpu* module in reach of the scene is the port's."""
    for k, mod in sys.modules.items():
        if _is_alias(k) and not mod.__name__.startswith(PORT):
            raise RuntimeError(f"scene run imported the JAX package's {k}")
    for k, v in scene_globals.items():
        mod = getattr(v, "__module__", None) or ""
        if isinstance(mod, str) and _is_alias(mod) and \
                not mod.startswith(PORT):
            raise RuntimeError(f"scene global {k} comes from {mod}")


def _host(x):
    """A torch tensor as a host tensor numpy can read; anything else as
    it is."""
    import torch
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    return x


class _SceneNumpy(types.ModuleType):
    """numpy as a scene's own module sees it: every name is numpy's, but
    ``asarray`` and ``array`` take a torch tensor on any device, as the
    JAX package's scenes call them on a state field."""

    def __init__(self):
        super().__init__("numpy", numpy.__doc__)

    def __getattr__(self, name):
        return getattr(numpy, name)

    @staticmethod
    def asarray(a, *args, **kwargs):
        return numpy.asarray(_host(a), *args, **kwargs)

    @staticmethod
    def array(a, *args, **kwargs):
        return numpy.array(_host(a), *args, **kwargs)


class _SceneJnp(types.ModuleType):
    """``jax.numpy`` as a scene's own module sees it: the names the files
    of ``scenes/`` call, on torch tensors on the runner's device."""

    NAMES = ("asarray", "where", "int32")

    def __init__(self, device):
        super().__init__("jax.numpy")
        self._device = device

    def __getattr__(self, name):
        raise AttributeError(
            f"the scene runner's jax.numpy has no {name!r} (it has "
            f"{', '.join(self.NAMES)})")

    def asarray(self, a, dtype=None):
        import torch
        return torch.as_tensor(a, dtype=dtype, device=self._device)

    @staticmethod
    def where(cond, x, y):
        """``torch.where``; a 0-dim host tensor (``int32(...)``) meets a
        tensor on the card as the scalar it holds, read on the host."""
        import torch

        def scalar(v):
            if isinstance(v, torch.Tensor) and v.dim() == 0 \
                    and v.device.type == "cpu" \
                    and cond.device.type != "cpu":
                return v.item()
            return v
        return torch.where(cond, scalar(x), scalar(y))

    @staticmethod
    def int32(v):
        import torch
        return torch.tensor(v, dtype=torch.int32)


class _SceneJax(types.ModuleType):
    """``jax`` as a scene's own module sees it: ``numpy`` alone."""

    def __init__(self, device):
        super().__init__("jax")
        self.numpy = _SceneJnp(device)

    def __getattr__(self, name):
        raise AttributeError(
            f"the scene runner's jax has no {name!r} (it has numpy)")


class _SceneSys(types.ModuleType):
    """``sys`` as a scene's own module sees it: Python's, but for
    ``executable``, the port's launcher on the runner's device, made on
    the first read (a scene that starts no child writes none)."""

    def __init__(self, device):
        super().__init__("sys")
        self._device = device

    def __getattr__(self, name):
        if name == "executable":
            self.executable = launcher(self._device)
            return self.executable
        return getattr(sys, name)

    def __setattr__(self, name, value):
        if name == "executable" or name.startswith("_"):
            super().__setattr__(name, value)
        else:
            setattr(sys, name, value)


REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def launcher(device) -> str:
    """The path of an executable that runs ``SCENE ARGS`` through this
    runner on ``device`` in a fresh interpreter (``sys.executable``), with
    the repo on ``PYTHONPATH``: a shell script under the repo's
    ``build/scene_launch/``, named by a hash of its text. A CUDA launcher
    names no device, so its run raises without a GPU."""
    flag = ""
    if device.type == "cpu":
        flag = " --device cpu"
    elif device.index is not None:
        flag = f" --device {device}"
    text = ("#!/bin/sh\n"
            "# Runs a scene file through mantaflow_tpu_torch.scene.run: "
            "the sys.executable\n# that the runner hands a scene module.\n"
            f"PYTHONPATH={shlex.quote(REPO)}${{PYTHONPATH:+:$PYTHONPATH}}\n"
            "export PYTHONPATH\n"
            f"exec {shlex.quote(sys.executable)} -m "
            f"mantaflow_tpu_torch.scene.run{flag} \"$@\"\n")
    name = "python-" + hashlib.sha256(text.encode()).hexdigest()[:16]
    path = os.path.join(REPO, "build", "scene_launch", name)
    if not os.path.exists(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(text)
        os.chmod(tmp, 0o755)
        os.replace(tmp, path)
    return path


def _scene_builtins(device):
    """The builtins of a scene's module: ``import numpy`` (and
    ``numpy.<sub>``, ``from numpy import ...``) there gives the scene's
    numpy, ``import jax.numpy`` the runner's stand-in (never the real
    one), ``import sys`` the scene's ``sys``; every other import is
    Python's own."""
    scene_np = _SceneNumpy()
    scene_jax = _SceneJax(device)
    scene_sys = _SceneSys(device)
    real_import = builtins.__import__

    def scene_import(name, globals=None, locals=None, fromlist=(), level=0):
        if level == 0 and (name == "jax" or name.startswith("jax.")):
            if name not in ("jax", "jax.numpy"):
                raise ImportError(f"the scene runner has no {name}")
            if name == "jax.numpy" and fromlist:
                return scene_jax.numpy
            return scene_jax
        if level == 0 and name == "sys":
            return scene_sys
        mod = real_import(name, globals, locals, fromlist, level)
        if level == 0 and name == "numpy":
            return scene_np
        if level == 0 and name.startswith("numpy.") and not fromlist:
            return scene_np
        return mod
    return {**vars(builtins), "__import__": scene_import}


def _run_main(path: str, scene_builtins: dict) -> dict:
    """``runpy.run_path(path, run_name="__main__")`` with the scene's
    builtins, where ``sys.exit(0)`` ends the file normally: its globals."""
    mod = types.ModuleType("__main__")
    mod.__dict__.update(__file__=path, __builtins__=scene_builtins,
                        __loader__=None, __spec__=None, __package__=None,
                        __cached__=None)
    with io.open_code(path) as f:
        code = compile(f.read(), path, "exec")
    old_main = sys.modules.get("__main__")
    sys.modules["__main__"] = mod
    try:
        exec(code, mod.__dict__)
    except SystemExit as e:
        if e.code not in (0, None):
            raise
    finally:
        sys.modules["__main__"] = old_main
    return dict(mod.__dict__)


def run_scene(path: str, argv=(), device=None) -> dict:
    """Run the scene file at ``path`` with ``sys.argv = [path, *argv]`` on
    ``device`` (None: CUDA, raising without a GPU); returns its globals."""
    from mantaflow_tpu_torch import resolve_device
    device = resolve_device(device)
    old_argv = sys.argv
    sys.argv = [str(path)] + [str(a) for a in argv]
    try:
        with _aliased(device):
            out = _run_main(str(path), _scene_builtins(device))
            _check_port_only(out)
    finally:
        sys.argv = old_argv
    return out


def main(args=None):
    args = list(sys.argv[1:] if args is None else args)
    device = None
    if args and args[0].startswith("--device"):
        if "=" in args[0]:
            device = args.pop(0).split("=", 1)[1]
        else:
            args.pop(0)
            device = args.pop(0)
    if not args:
        raise SystemExit(__doc__)
    run_scene(args[0], args[1:], device)
    bad = [k for k in sys.modules
           if k == "jax" or k.startswith("jax.")
           or (_is_alias(k) and not sys.modules[k].__name__.startswith(PORT))]
    if bad:
        raise RuntimeError(f"the scene run loaded {sorted(bad)[:5]}")


if __name__ == "__main__":
    main()
