"""Scene-level save/load on the port: extension dispatch like the
reference's fileio/mantaio.cpp (:20,:42), plus state checkpoints in the JAX
package's npz layout (``leaf_<i>`` in pytree leaf order), so a checkpoint
written by either package loads into the other's state."""

from __future__ import annotations

import dataclasses as _dc

import numpy as np
import torch

from ..io import uni as uio
from .api import (FlagGrid, GridBase, IntGrid, LevelsetGrid, MACGrid,
                  RealGrid, Vec3Grid, _np)


def _grid_type_of(grid: GridBase) -> int:
    if isinstance(grid, FlagGrid):
        return uio.TypeInt | uio.TypeFlags
    if isinstance(grid, LevelsetGrid):
        return uio.TypeReal | uio.TypeLevelset
    if isinstance(grid, MACGrid):
        return uio.TypeVec3 | uio.TypeMAC
    if isinstance(grid, Vec3Grid):
        return uio.TypeVec3
    if isinstance(grid, IntGrid):
        return uio.TypeInt
    return uio.TypeReal


def _vdb_class_of(grid) -> str:
    """iovdb.cpp:146-166 grid-class mapping: levelsets -> LEVEL_SET, MAC ->
    STAGGERED, other reals -> FOG_VOLUME."""
    from ..io import vdb
    if isinstance(grid, LevelsetGrid):
        return vdb.CLASS_LEVEL_SET
    if isinstance(grid, MACGrid):
        return vdb.CLASS_STAGGERED
    if isinstance(grid, IntGrid):
        return vdb.CLASS_UNKNOWN
    return vdb.CLASS_FOG


def _write_vdb(name: str, arr, grid=None):
    """Native OpenVDB writer (``io/vdb.py``); the reference gates this path
    on the OPENVDB=1 build flag, here it is always available."""
    from ..io import vdb
    gname = getattr(grid, "name", "") or "density"
    vdb.write_vdb(name, [{
        "name": gname,
        "data": arr,
        "grid_class": _vdb_class_of(grid) if grid is not None
        else vdb.CLASS_FOG,
    }])


def _read_vdb(name: str, shape):
    from ..io import vdb
    grids = vdb.read_vdb(name)
    if not grids:
        raise ValueError(f"{name}: no grids in file")
    data = grids[0]["data"]
    want = tuple(shape)
    got = data.shape[-3:]
    if got != want:  # leaf-padded tail was all-inactive: crop/pad back
        pads = [(0, max(0, w - g)) for w, g in zip(want, got)]
        if data.ndim == 4:
            pads = [(0, 0)] + pads
        data = np.pad(data, pads)[..., :want[0], :want[1], :want[2]]
    return data


def _grid_save(self: GridBase, name: str):
    arr = _np(self.data)
    if name.endswith(".uni"):
        uio.write_grid_uni(name, arr, _grid_type_of(self))
    elif name.endswith(".raw"):
        uio.write_grid_raw(name, arr)
    elif name.endswith(".npz"):
        np.savez_compressed(name, data=arr)
    elif name.endswith(".txt"):
        uio.write_grid_txt(name, arr)
    elif name.endswith(".vol"):
        uio.write_grid_vol(name, arr)
    elif name.endswith(".vdb"):
        _write_vdb(name, arr, self)
    else:
        raise ValueError(f"save: unknown extension for {name}")


def _grid_load(self: GridBase, name: str):
    if name.endswith(".uni"):
        data, _ = uio.read_grid_uni(name)
    elif name.endswith(".raw"):
        ch = 3 if self.channels == 3 else 1
        data = uio.read_grid_raw(name, self.dom.shape,
                                 _np(self.data).dtype, ch)
    elif name.endswith(".npz"):
        data = np.load(name)["data"]
    elif name.endswith(".vol"):
        data = uio.read_grid_vol(name)
    elif name.endswith(".vdb"):
        data = _read_vdb(name, self.dom.shape)
    else:
        raise ValueError(f"load: unknown extension for {name}")
    self.from_numpy(np.asarray(data))


GridBase.save = _grid_save
GridBase.load = _grid_load


def _parts_save(self, name: str):
    m = int(self.parts.count)
    pos = _np(self.parts.pos[:m])
    flg = _np(self.parts.flags[:m])
    if name.endswith(".uni"):
        uio.write_particles_uni(name, pos, flg, self.dom.size)
    elif name.endswith(".npz"):
        np.savez_compressed(name, pos=pos, flags=flg)
    elif name.endswith(".txt"):
        with open(name, "w") as f:
            for p in pos:
                f.write(f"{p[0]} {p[1]} {p[2]}\n")
    else:
        raise ValueError(f"particle save: unknown extension for {name}")


def _parts_load(self, name: str):
    from ..core import particles as cp
    if name.endswith(".uni"):
        pos, flg, _ = uio.read_particles_uni(name)
    elif name.endswith(".npz"):
        d = np.load(name)
        pos, flg = d["pos"], d["flags"]
    else:
        raise ValueError(f"particle load: unknown extension for {name}")
    p = cp.make_particles(pos, capacity=max(self.capacity, pos.shape[0]),
                          device=self.device)
    p.flags[:flg.shape[0]] = torch.from_numpy(
        np.ascontiguousarray(flg, np.int32)).to(self.device)
    self._replace(p)


def _install_particle_io():
    from .papi import BasicParticleSystem, PdataBase
    BasicParticleSystem.save = _parts_save
    BasicParticleSystem.load = _parts_load

    def _pdata_save(self, name: str):
        arr = _np(self.data)
        if name.endswith(".uni"):
            uio.write_pdata_uni(name, arr, self.parent.dom.size)
        elif name.endswith(".npz"):
            np.savez_compressed(name, data=arr)
        else:
            raise ValueError(f"pdata save: unknown extension for {name}")

    def _pdata_load(self, name: str):
        if name.endswith(".uni"):
            want = np.float32 if self.data.is_floating_point() else np.int32
            data, _ = uio.read_pdata_uni(name, dtype=want)
        elif name.endswith(".npz"):
            data = np.load(name)["data"]
        else:
            raise ValueError(f"pdata load: unknown extension for {name}")
        n = min(data.shape[0], self.data.shape[0])
        out = self.data.clone()
        out[:n] = torch.as_tensor(np.asarray(data[:n])).to(out)
        self.data = out

    PdataBase.save = _pdata_save
    PdataBase.load = _pdata_load


_install_particle_io()


def save(name: str, objects: list):
    """Batched save (mantaio.cpp:42): one file per object, suffix _N."""
    if len(objects) == 1:
        objects[0].save(name)
        return
    stem, dot, ext = name.rpartition(".")
    for i, o in enumerate(objects):
        o.save(f"{stem}_{i}{dot}{ext}")


def load(name: str, objects: list):
    if len(objects) == 1:
        objects[0].load(name)
        return
    stem, dot, ext = name.rpartition(".")
    for i, o in enumerate(objects):
        o.load(f"{stem}_{i}{dot}{ext}")


# ---------------------------------------------------------------------------
# state checkpoints (the JAX package's pytree npz layout)

#: fields of the port's states that the JAX package's states lack
_PORT_ONLY_FIELDS = ("cg_iters",)


def _flatten(state):
    """The state's tensors in the JAX package's pytree leaf order: the
    dataclass fields in declaration order, depth first, None skipped."""
    if state is None:
        return []
    if _dc.is_dataclass(state):
        out = []
        for f in _dc.fields(state):
            if f.name not in _PORT_ONLY_FIELDS:
                out += _flatten(getattr(state, f.name))
        return out
    if isinstance(state, (tuple, list)):
        return [leaf for s in state for leaf in _flatten(s)]
    return [state]


def _unflatten(like, leaves):
    """A copy of ``like`` with its leaves taken from the iterator
    ``leaves``, each on its leaf's device and of its dtype."""
    if like is None:
        return None
    if _dc.is_dataclass(like):
        kw = {f.name: _unflatten(getattr(like, f.name), leaves)
              for f in _dc.fields(like)
              if f.name not in _PORT_ONLY_FIELDS}
        return _dc.replace(like, **kw)
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(s, leaves) for s in like)
    arr = next(leaves)
    if torch.is_tensor(like):
        return torch.from_numpy(np.array(arr)).to(device=like.device,
                                                  dtype=like.dtype)
    return type(like)(arr)


def _host(leaf):
    return _np(leaf) if torch.is_tensor(leaf) else np.asarray(leaf)


def save_checkpoint(name: str, state):
    """Save a state (e.g. models.smoke.SmokeState, models.flip.FlipState)
    to one npz, leaves in the JAX package's order."""
    leaves = _flatten(state)
    np.savez_compressed(name, __treedef__=type(state).__name__,
                        **{f"leaf_{i}": _host(leaf)
                           for i, leaf in enumerate(leaves)})


def load_checkpoint(name: str, like_state):
    """Restore a checkpoint into ``like_state``'s structure and devices."""
    d = np.load(name, allow_pickle=False)
    n = len(_flatten(like_state))
    return _unflatten(like_state, iter(d[f"leaf_{i}"] for i in range(n)))


def projectPpmFull(grid: RealGrid, name: str, shadeMode: int = 0,
                   scale: float = 1.0):
    """PPM projection of a density grid (initplugins.cpp:277 /
    util/simpleimage.cpp): mean-project along z, write binary PPM."""
    arr = _np(grid.data)
    img = arr.mean(axis=0) if arr.shape[0] > 1 else arr[0]
    img = np.clip(img * scale, 0.0, 1.0)
    img8 = (img[::-1] * 255).astype(np.uint8)  # y up
    if name.endswith(".png"):  # simpleimage.cpp also writes PNG
        from ..io.png import write_png
        write_png(name, np.repeat(img8[..., None], 3, axis=-1))
        return
    h, w = img8.shape
    with open(name, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(np.repeat(img8[..., None], 3, axis=-1).tobytes())
