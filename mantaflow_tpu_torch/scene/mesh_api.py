"""Scene-level Mesh object and mesh plugins (mesh.h:129-420,
levelset.cpp:330 createMesh, plugin/meshplugins.cpp) on the port: the
topology stays on the host as numpy arrays, as in the JAX package; node
advection and the mesh SDF run on the grids' device."""

from __future__ import annotations

import numpy as np
import torch

from ..core import mesh as cmesh
from ..io import uni as uio
from .api import FlagGrid, LevelsetGrid, MACGrid, Solver, _np


class MdataBase:
    """Per-node mesh data channel (mesh.h:310 MeshDataImpl<T>), sized to the
    parent mesh's node count and re-synced lazily after topology changes."""

    width = 1
    dtype = np.float32

    def __init__(self, parent: "Mesh"):
        self.parent = parent
        self._alloc(parent.numNodes())

    def _alloc(self, n):
        shape = (n,) if self.width == 1 else (n, self.width)
        self.data = np.zeros(shape, self.dtype)

    def _sync(self):
        if self.data.shape[0] != self.parent.numNodes():
            old = self.data
            self._alloc(self.parent.numNodes())
            n = min(old.shape[0], self.data.shape[0])
            self.data[:n] = old[:n]

    def size(self):
        self._sync()
        return self.data.shape[0]

    def setConst(self, v):
        self._sync()
        self.data[...] = v

    def copyFrom(self, other):
        self.data = np.array(other.data)

    def multConst(self, v):
        self._sync()
        self.data = self.data * v

    def add(self, other):
        self._sync()
        self.data = self.data + other.data

    def clamp(self, vmin, vmax):
        self._sync()
        self.data = np.clip(self.data, vmin, vmax)

    def getMaxAbs(self):
        self._sync()
        if self.data.ndim == 2:
            return float(np.sqrt((self.data ** 2).sum(axis=-1).max()))
        return float(np.abs(self.data).max())

    def setSource(self, grid, isMAC: bool = False):
        """MeshDataImpl::setSource (mesh.cpp:1110): grid sampled at node
        positions to initialize values for newly created nodes."""
        self._source = grid
        self._source_is_mac = isMAC

    def save(self, name: str):
        self._sync()
        uio.write_pdata_uni(name, self.data, self.parent.dom.size)

    def load(self, name: str):
        data, _ = uio.read_pdata_uni(name, dtype=self.dtype)
        self.data = np.asarray(data, self.dtype).reshape(
            -1, *self.data.shape[1:])


class MdataReal(MdataBase):
    pass


class MdataInt(MdataBase):
    dtype = np.int32


class MdataVec3(MdataBase):
    width = 3


class Mesh:
    """Triangle mesh (nodes/tris); node data channels as numpy arrays."""

    def __init__(self, solver: Solver = None, name: str = "",
                 parent: Solver = None):
        solver = solver if solver is not None else parent
        self.solver = solver
        self.name = name
        self.nodes = np.zeros((0, 3), np.float32)
        self.tris = np.zeros((0, 3), np.int32)
        self._mdata = []

    def create(self, cls, **kw):
        """Mesh.create(MdataReal/...) (mesh.cpp:78)."""
        md = cls(self)
        self._mdata.append(md)
        return md

    @property
    def dom(self):
        return self.solver.domain

    def numNodes(self):
        return self.nodes.shape[0]

    def numTris(self):
        return self.tris.shape[0]

    def clear(self):
        self.nodes = np.zeros((0, 3), np.float32)
        self.tris = np.zeros((0, 3), np.int32)

    def load(self, name: str, append: bool = False):
        if name.endswith(".obj"):
            # readObjFile keeps file coordinates raw (scenes rescale)
            nodes, tris = uio.read_mesh_obj(name)
        elif name.endswith(".bobj.gz") or name.endswith(".bobj"):
            # readBobj converts world -> grid space (iomeshes.cpp:154-156)
            nodes, tris = uio.read_mesh_bobj(name, grid_size=self.dom.size)
        else:
            raise ValueError(f"mesh load: unknown extension {name}")
        if append and self.numNodes():
            tris = tris + self.numNodes()
            self.nodes = np.concatenate([self.nodes, nodes])
            self.tris = np.concatenate([self.tris, tris])
        else:
            self.nodes, self.tris = nodes, tris

    def save(self, name: str):
        # both writers emit the reference's centered unit-cube world coords
        if name.endswith(".obj"):
            uio.write_mesh_obj(name, self.nodes, self.tris,
                               grid_size=self.dom.size)
        elif name.endswith(".bobj.gz") or name.endswith(".bobj"):
            uio.write_mesh_bobj(name, self.nodes, self.tris,
                                grid_size=self.dom.size)
        else:
            raise ValueError(f"mesh save: unknown extension {name}")

    def advectInGrid(self, flags: FlagGrid, vel: MACGrid,
                     integrationMode: int = 1):
        new = cmesh.advect_mesh_nodes(self.nodes, vel.data,
                                      self.solver.timestep, self.dom,
                                      integrationMode)
        self.nodes = _np(new)

    def computeLevelset(self, levelset: LevelsetGrid, sigma: float = 2.0,
                        cutoff: float = -1.0):
        levelset.data = cmesh.mesh_sdf(self.nodes, self.tris, levelset.dom,
                                       sigma, cutoff,
                                       parent_size=self.dom.size,
                                       device=levelset.device)

    def applyMeshToGrid(self, grid, value=1.0, cutoff: float = -1.0,
                        meshSigma: float = 2.0):
        phi = cmesh.mesh_sdf(self.nodes, self.tris, grid.dom, meshSigma,
                             cutoff, parent_size=self.dom.size,
                             device=grid.device)
        grid.data = torch.where(phi < 0.0, value, grid.data)

    def scale(self, s):
        self.nodes = self.nodes * np.asarray(s, np.float32)

    def offset(self, o):
        self.nodes = self.nodes + np.asarray(o, np.float32)

    def rotate(self, thetas):
        """Mesh::rotate (mesh.cpp:343-373): sequential planar rotations
        x, then y, then z (radians); the y rotation's (0,2) axis pair uses
        the fork's negated sine convention."""
        thetas = np.asarray(thetas, np.float32)
        pos = self.nodes.copy()
        for theta, (a, b) in zip(thetas, ((1, 2), (0, 2), (0, 1))):
            if theta == 0.0:
                continue
            sin_t = np.float32(np.sin(theta))
            cos_t = np.float32(np.cos(theta))
            if (a, b) == (0, 2):
                sin_t = -sin_t
            fa, sb = pos[:, a].copy(), pos[:, b].copy()
            pos[:, a] = fa * cos_t - sb * sin_t
            pos[:, b] = sb * cos_t + fa * sin_t
        self.nodes = pos

    def save_pos(self):
        """Mesh::save_pos (mesh.cpp:320)."""
        self._saved_pos = self.nodes.copy()

    def load_pos(self):
        """Mesh::load_pos (mesh.cpp:326)."""
        if getattr(self, "_saved_pos", None) is None or \
                len(self._saved_pos) != len(self.nodes):
            raise AssertionError("# of mesh nodes has changed")
        self.nodes = self._saved_pos.copy()

    def computeVelocity(self, oldMesh: "Mesh", vel: MACGrid):
        """Mesh::computeVelocity (mesh.cpp:375-399): per-node frame
        displacement scattered to the MAC grid (setInterpolMAC) and
        averaged by the accumulated weights (safeDivide)."""
        if oldMesh.numNodes() != self.numNodes():
            return
        from ..core.particles import make_particles
        from ..ops import flip as fo
        pos = self.nodes
        if not self.dom.is3d:
            keep = (pos[:, 2] >= -0.5) & (pos[:, 2] <= 0.5)
        else:
            keep = np.ones(len(pos), bool)
        velo = (pos - oldMesh.nodes)[keep]
        dev = vel.device
        parts = make_particles(pos[keep], capacity=max(len(velo), 1),
                               device=dev)
        # the flags are unused by the scatter
        flags = torch.zeros(self.dom.shape, dtype=torch.int32, device=dev)
        v, _ = fo.map_parts_to_mac(parts, torch.from_numpy(velo).to(dev),
                                   flags, self.dom)
        vel.data = v

    def getLevelset(self, sigma: float = 2.0, cutoff: float = -1.0):
        """Mesh::getLevelset (mesh.h:170): computeLevelset into a fresh
        grid."""
        ls = LevelsetGrid(self.solver)
        self.computeLevelset(ls, sigma, cutoff)
        return ls

    def fromShape(self, shape):
        """Build from a shape's SDF via surface extraction."""
        phi = _np(shape.shape.compute_levelset(self.dom, self.solver.device))
        self.nodes, self.tris = cmesh.marching_cubes(phi)


def _ls_create_mesh(self: LevelsetGrid, mesh: Mesh):
    """LevelsetGrid::createMesh (levelset.cpp:330): extract phi=0 surface
    with table-driven marching cubes (generated tables + exact edge-id
    vertex welding, the mcubes.h/createMesh scheme; see core/mesh.py)."""
    nodes, tris = cmesh.marching_cubes(_np(self.data))
    mesh.nodes, mesh.tris = nodes, tris


LevelsetGrid.createMesh = _ls_create_mesh


def smoothMesh(mesh: Mesh, strength: float = 1.0, steps: int = 1,
               minLength: float = 1e-5):
    mesh.nodes = cmesh.smooth_mesh(mesh.nodes, mesh.tris, strength, steps)


def subdivideMesh(mesh: Mesh, minAngle: float = 0.0, minLength: float = 0.0,
                  maxLength: float = 2.0, cutTubes: bool = False):
    """subdivideMesh (meshplugins.cpp:108): collapse short/sliver edges,
    then split edges longer than maxLength (reference sweep order)."""
    nodes, tris = cmesh.collapse_edges(mesh.nodes, mesh.tris, minLength,
                                       minAngle)
    mesh.nodes, mesh.tris = cmesh.subdivide_mesh(nodes, tris, maxLength)


def killSmallComponents(mesh: Mesh, elements: int = 10):
    mesh.nodes, mesh.tris = cmesh.kill_small_components(mesh.nodes, mesh.tris,
                                                        elements)
