"""Mantaflow-style scene API on the port.

The JAX package's ``scene/api.py`` with the same names and argument order:
reference scenes written against ``from manta import *`` run against
``from mantaflow_tpu_torch import *`` (or unedited through
``mantaflow_tpu_torch.scene.run``). Objects are thin imperative wrappers:
a grid holds one tensor on its solver's device and ops re-bind it, while
the math lives in the port's ``core`` / ``ops``.

Every grid, particle system and shape lives on the device of the
``Solver`` that made it: ``Solver(..., device=None)`` resolves through
``resolve_device`` (CUDA unless the caller, or the scene runner, names a
device).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..core import flags as fl
from ..core import mac as macops
from ..core import shapes as shp
from ..core import solver as slv
from ..core.domain import Domain
from ..ops import advection as adv
from ..ops import extforces as ext
from ..ops import initops as ini
from ..ops import pressure as prs
from ..utils.noise import WaveletNoiseField

# ---------------------------------------------------------------------------
# module constants mirroring registry.cpp:395-420 + defines.py:25-60

GUI = False

def _np(t):
    """A tensor's values as a host numpy array."""
    return t.detach().cpu().numpy()


class Gui:
    """Headless stand-in for the Qt GUI (gui/qtmain.cpp): interaction calls
    are no-ops and screenshot() renders a grid slice to PPM."""

    def __init__(self):
        self._grids = []

    def show(self, twoD: bool = False):
        mantaMsg("Gui: headless build, rendering via projectPpmFull/"
                 "screenshot(grid=...)", 2)

    def pause(self):
        pass

    def update(self):
        pass

    def setCamPos(self, x, y, z):
        pass

    def setCamRot(self, x, y, z):
        pass

    def windowSize(self, w, h):
        pass

    def nextRealGrid(self):
        pass

    def nextVec3Grid(self):
        pass

    def nextParts(self):
        pass

    def nextPdata(self):
        pass

    def nextMesh(self):
        pass

    def toggleHideGrids(self):
        pass

    def screenshot(self, filename: str, grid=None, scale: float = 1.0):
        if grid is None:
            mantaMsg("Gui.screenshot: no framebuffer in the headless build; "
                     "pass grid=<RealGrid> to render a slice", 1)
            return
        from .io_api import projectPpmFull
        projectPpmFull(grid, filename, 0, scale)


CUDA = True
TPU = False
DOUBLEPRECISION = False

FlagFluid = fl.TypeFluid
FlagObstacle = fl.TypeObstacle
FlagEmpty = fl.TypeEmpty
FlagInflow = fl.TypeInflow
FlagOutflow = fl.TypeOutflow
FlagOpen = fl.TypeOpen
FlagStick = fl.TypeStick
FlagSurface = fl.TypeSurface

PcNone = prs.PcNone
PcMIC = prs.PcMIC
PcMGDynamic = prs.PcMGDynamic
PcMGStatic = prs.PcMGStatic

IntEuler = 0
IntRK2 = 1
IntRK4 = 2


class vec3(tuple):
    """Mantaflow's Vec3 scripting type (pwrapper/pvec3.cpp behavior)."""

    def __new__(cls, x, y=None, z=None):
        if y is None:
            y = z = x
        return super().__new__(cls, (float(x), float(y), float(z)))

    @property
    def x(self):
        return self[0]

    @property
    def y(self):
        return self[1]

    @property
    def z(self):
        return self[2]

    def __mul__(self, o):
        if isinstance(o, (tuple, list)):
            return vec3(self[0] * o[0], self[1] * o[1], self[2] * o[2])
        return vec3(self[0] * o, self[1] * o, self[2] * o)

    __rmul__ = __mul__

    def __add__(self, o):
        if isinstance(o, (tuple, list)):
            return vec3(self[0] + o[0], self[1] + o[1], self[2] + o[2])
        return vec3(self[0] + o, self[1] + o, self[2] + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, (tuple, list)):
            return vec3(self[0] - o[0], self[1] - o[1], self[2] - o[2])
        return vec3(self[0] - o, self[1] - o, self[2] - o)

    def __truediv__(self, o):
        if isinstance(o, (tuple, list)):
            return vec3(self[0] / o[0], self[1] / o[1], self[2] / o[2])
        return vec3(self[0] / o, self[1] / o, self[2] / o)

    def __neg__(self):
        return vec3(-self[0], -self[1], -self[2])


Vec3 = vec3  # manta exposes both spellings


def Vec4(x, y=None, z=None, t=None):
    """4-component vector literal for the Grid4d API (vector.h Vec4)."""
    if y is None:
        y = z = t = x
    return (float(x), float(y), float(z), float(t))


vec4 = Vec4  # manta exposes both spellings


def vec3i(x, y=None, z=None):
    if y is None:
        y = z = x
    return (int(x), int(y), int(z))


def mantaMsg(msg, level: int = 1):
    if level <= _debug_level[0]:
        print(msg)


_debug_level = [1]


def setDebugLevel(level: int):
    _debug_level[0] = int(level)


# ---------------------------------------------------------------------------
# grids

def _resolve_parent(solver, parent):
    """The reference's generated constructors accept the owning solver as a
    `parent` kwarg on every PbClass (pwrapper/pclass.h:44); mirror that."""
    return solver if solver is not None else parent


def _vec_const(v, dtype, device, channels=3):
    return torch.tensor([float(c) for c in tuple(v)[:channels]], dtype=dtype,
                        device=device)


class GridBase:
    dtype = torch.float32
    channels = 0  # 0: scalar [z,y,x]; 3: (3,z,y,x)

    def __init__(self, solver: "Solver" = None, name: str = "",
                 parent: "Solver" = None):
        solver = _resolve_parent(solver, parent)
        self.solver = solver
        self.name = name
        dom = solver.domain
        shape = dom.shape if self.channels == 0 else (3,) + dom.shape
        self.data = torch.zeros(shape, dtype=self.dtype, device=solver.device)

    # -- mantaflow Grid<T> surface (grid.h:99-247) --------------------------
    @property
    def dom(self) -> Domain:
        return self.solver.domain

    @property
    def device(self) -> torch.device:
        return self.data.device

    def clear(self):
        self.data = torch.zeros_like(self.data)

    def setConst(self, value):
        if self.channels == 3:
            v = _vec_const(value, self.dtype, self.device).reshape(3, 1, 1, 1)
            self.data = v.expand(self.data.shape).contiguous()
        else:
            self.data = torch.full_like(self.data, value)

    def copyFrom(self, other):
        self.data = other.data

    def add(self, other):
        self.data = self.data + other.data

    def sub(self, other):
        self.data = self.data - other.data

    def _const(self, v):
        """Normalize scalar/vec3 constants: a Vec3 on a 3-channel grid
        broadcasts per component (Grid<Vec3> scalar-op semantics)."""
        if self.channels == 3 and hasattr(v, "__len__") and len(v) == 3:
            return _vec_const(v, self.dtype, self.device).reshape(3, 1, 1, 1)
        return v

    def addConst(self, v):
        self.data = self.data + self._const(v)

    def addScaled(self, other, factor):
        self.data = self.data + self._const(factor) * other.data

    def mult(self, other):
        self.data = self.data * other.data

    def multConst(self, v):
        self.data = self.data * self._const(v)

    def clamp(self, vmin, vmax):
        self.data = torch.clamp(self.data, vmin, vmax)

    def clamp_norm(self, max_norm: float):
        """Grid::clamp_norm (fork, grid.h:191) for Vec3/MAC grids."""
        from .ops2 import clampNorm
        clampNorm(self, max_norm)

    def _norm2(self):
        return self.data[0] ** 2 + self.data[1] ** 2 + self.data[2] ** 2

    def getMax(self):
        if self.channels == 3:
            # Grid<Vec3>::getMax = sqrt(max norm^2) (grid.cpp:361)
            return self.getMaxAbs()
        return float(torch.max(self.data))

    def getMin(self):
        if self.channels == 3:
            # Grid<Vec3>::getMin = sqrt(min norm^2) (grid.cpp:364)
            return float(torch.sqrt(torch.min(self._norm2())))
        return float(torch.min(self.data))

    def getMaxAbs(self):
        if self.channels == 3:
            return float(torch.sqrt(torch.max(self._norm2())))
        return float(torch.max(torch.abs(self.data)))

    def getL1(self, bnd: int = 0):
        return float(torch.sum(torch.abs(self._interior(bnd))))

    def getL2(self, bnd: int = 0):
        return float(torch.sqrt(torch.sum(self._interior(bnd) ** 2)))

    def _interior(self, bnd):
        if bnd <= 0:
            return self.data
        from ..core.masks import interior_mask
        m = interior_mask(self.dom, bnd, self.device)
        if self.channels == 3:
            m = m[None]
        return torch.where(m, self.data, 0.0)

    def setBoundNeumann(self, boundaryWidth: int = 0):
        """Copy the first interior layer into the boundary shells
        (Grid::setBoundNeumann, grid.cpp:667)."""
        from ..core.masks import axis_index
        from ..core.masks import shift as _shift
        out = self.data
        dom = self.dom
        w = boundaryWidth
        for ax, n in (("x", dom.shape[2]), ("y", dom.shape[1]),
                      ("z", dom.shape[0])):
            if ax == "z" and not dom.is3d:
                continue
            idx = axis_index(dom, ax, self.device)
            for layer in range(w + 1):
                lo = idx == (w - layer)
                hi = idx == (n - 1 - w + layer)
                if self.channels == 3:
                    lo, hi = lo[None], hi[None]
                out = torch.where(lo, _shift(out, 1, ax), out)
                out = torch.where(hi, _shift(out, -1, ax), out)
        self.data = out

    def setBound(self, value, boundaryWidth: int = 1):
        from ..core.masks import interior_mask
        m = interior_mask(self.dom, boundaryWidth, self.device)
        if self.channels == 3:
            m = m[None]
            if isinstance(value, (tuple, list)):
                value = _vec_const(value, torch.float32,
                                   self.device).reshape(3, 1, 1, 1)
        if not torch.is_tensor(value):
            value = torch.tensor(value, dtype=self.dtype, device=self.device)
        self.data = torch.where(m, self.data, value.to(self.dtype))

    # numpy interop (numpyconvert.cpp equivalents)
    def to_numpy(self):
        return _np(self.data)

    def from_numpy(self, arr):
        self.data = torch.tensor(np.asarray(arr)).to(
            device=self.device, dtype=self.dtype).reshape(self.data.shape)


class RealGrid(GridBase):
    dtype = torch.float32


class IntGrid(GridBase):
    dtype = torch.int32


class Vec3Grid(GridBase):
    dtype = torch.float32
    channels = 3


def _bnd_masks(dom, w, device, *, normal_only=False, mac2=False):
    """The per-component face masks of setBoundMAC / set_bound_MAC2."""
    sz, sy, sx = dom.shape
    i = torch.arange(sx, device=device).reshape(1, 1, sx)
    j = torch.arange(sy, device=device).reshape(1, sy, 1)
    k = torch.arange(sz, device=device).reshape(sz, 1, 1)
    is3d = dom.is3d
    none = torch.zeros((sz, 1, 1), dtype=torch.bool, device=device)
    if mac2:
        zb = ((k <= w) | (k >= sz - 1 - w)) if is3d else none
        mx = ((i <= w + 1) | (i >= sx - 1 - w)
              | (j <= w) | (j >= sy - 1 - w) | zb)
        my = ((i <= w) | (i >= sx - 1 - w)
              | (j <= w + 1) | (j >= sy - 1 - w) | zb)
        mz = ((i <= w) | (i >= sx - 1 - w)
              | (j <= w) | (j >= sy - 1 - w)
              | ((k <= w + 1) | (k >= sz - 1 - w))) if is3d else none
    elif normal_only:
        mx = (i <= w) | (i >= sx - w)
        my = (j <= w) | (j >= sy - w)
        mz = ((k <= w) | (k >= sz - w)) if is3d else none
    else:
        zb = ((k <= w - 1) | (k >= sz - 1 - w)) if is3d else none
        mx = ((i <= w) | (i >= sx - w)
              | (j <= w - 1) | (j >= sy - 1 - w) | zb)
        my = ((i <= w - 1) | (i >= sx - 1 - w)
              | (j <= w) | (j >= sy - w) | zb)
        mz = ((i <= w - 1) | (i >= sx - 1 - w)
              | (j <= w - 1) | (j >= sy - 1 - w)
              | ((k <= w) | (k >= sz - w))) if is3d else none
    return mx, my, mz


class MACGrid(Vec3Grid):
    def getCentered(self):
        g = Vec3Grid(self.solver)
        g.data = macops.get_centered(self.data)
        return g

    def _set_faces(self, value, masks, keep_z):
        v = _vec_const(value, torch.float32, self.device)
        d = self.data
        mx, my, mz = masks
        self.data = torch.stack([
            torch.where(mx, v[0], d[0]),
            torch.where(my, v[1], d[1]),
            d[2] if keep_z else torch.where(mz, v[2], d[2])])

    def setBoundMAC(self, value, boundaryWidth: int, normalOnly=False):
        """MACGrid::setBoundMAC (grid.h:290, knSetBoundaryMAC /
        knSetBoundaryMACNorm grid.cpp:672-686): Dirichlet on a w-cell
        boundary shell, respecting staggered face locations."""
        masks = _bnd_masks(self.dom, int(boundaryWidth), self.device,
                           normal_only=normalOnly)
        self._set_faces(value, masks,
                        keep_z=not (self.dom.is3d or not normalOnly))

    def set_bound_MAC2(self, value, boundaryWidth: int):
        """Fork MACGrid::set_bound_MAC2 (grid.h:292, kn_set_bound_MAC2
        grid.cpp:695-714): like setBoundMAC with one extra low-side layer on
        each component's own axis (zflip.py:765)."""
        masks = _bnd_masks(self.dom, int(boundaryWidth), self.device,
                           mac2=True)
        self._set_faces(value, masks, keep_z=not self.dom.is3d)


class LevelsetGrid(RealGrid):
    def __init__(self, solver=None, name: str = "", parent=None):
        solver = _resolve_parent(solver, parent)
        super().__init__(solver, name)
        self.data = torch.full(solver.domain.shape, self.invalidTimeValue(),
                               dtype=self.dtype, device=solver.device)

    def invalidTimeValue(self):
        # reference: FastMarch invalid value = 4.0 * max reinit time
        return 1e10

    def join(self, other):
        self.data = torch.minimum(self.data, other.data)

    def subtract(self, other, flags=None, subtractType=None):
        """KnSubtract (levelset.cpp:114): where other<0 overwrite with
        -other; cells outside `other` keep their value."""
        mask = other.data < 0.0
        if flags is not None and subtractType is not None:
            mask = mask & ((flags.data & subtractType) != 0)
        self.data = torch.where(mask, -other.data, self.data)

    def initFromFlags(self, flags, ignore_walls: bool = False):
        inside = fl.is_fluid(flags.data)
        if ignore_walls:
            inside = inside | fl.is_obstacle(flags.data)
        self.data = torch.where(inside, -0.5, 0.5).to(self.dtype)

    def reinitMarching(self, flags, maxTime: float = 4.0, velTransport=None,
                       ignoreWalls: bool = False,
                       correctOuterLayer: bool = True,
                       obstacleType: int = fl.TypeObstacle):
        """reinitMarching (levelset.cpp:224): the reference-exact serial
        fast march with velocity value-transport, on the host through the
        port's native library (which raises when it cannot be built)."""
        from .. import native
        new_phi, new_vel = native.reinit_march(
            _np(self.data), _np(flags.data),
            _np(velTransport.data) if velTransport is not None else None,
            maxTime, ignoreWalls, correctOuterLayer, obstacleType)
        self.data = torch.from_numpy(new_phi).to(self.device)
        if velTransport is not None and new_vel is not None:
            velTransport.data = torch.from_numpy(new_vel).to(self.device)

    def fillHoles(self, maxDepth: int = 10, boundaryWidth: int = 1):
        from ..ops import levelset as lso
        self.data = lso.fill_holes(self.data, self.dom, maxDepth)


class FlagGrid(IntGrid):
    def initDomain(self, boundaryWidth: int = 0, phiWalls=None,
                   wall: str = "xXyYzZ", open: str = "      ",
                   inflow: str = "      ", outflow: str = "      "):
        self.data = fl.init_domain(self.dom, boundaryWidth, wall, open,
                                   inflow, outflow, device=self.device)
        if phiWalls is not None:
            # obstacle SDF of the wall shells (InitMin/Max*Wall); only sides
            # that remain obstacle get a wall
            eff = "".join(c for c in wall
                          if c not in open + inflow + outflow)
            phiWalls.data = fl._wall_sdf(self.dom, boundaryWidth, eff,
                                         device=self.device)

    def fillGrid(self, type: int = fl.TypeFluid):
        self.data = fl.fill_grid(self.data, type)

    def updateFromLevelset(self, levelset):
        self.data = fl.update_from_levelset(self.data, levelset.data,
                                            levelset.invalidTimeValue())

    def countCells(self, flag: int, bnd: int = 0):
        return int(fl.count_cells(self.data, flag, bnd, self.dom))


# ---------------------------------------------------------------------------
# shapes (scene-facing wrappers around core.shapes)

class _SceneShape:
    core_cls = None

    def __init__(self, solver: "Solver" = None, **kw):
        self.solver = _resolve_parent(solver, kw.pop("parent", None))
        self.shape = self._make(**kw)

    def _make(self, **kw):
        raise NotImplementedError

    def applyToGrid(self, grid: GridBase, value=None, respectFlags=None):
        # stamped into the GRID's own index space (the shape is geometric;
        # a shape built on one solver can stamp another solver's grids)
        rf = respectFlags.data if respectFlags is not None else None
        if value is None:
            value = 1.0
        if isinstance(grid, MACGrid):
            grid.data = self.shape.apply_to_mac_grid(grid.data, value,
                                                     grid.dom, rf)
        else:
            grid.data = self.shape.apply_to_grid(grid.data, value,
                                                 grid.dom, rf)

    def applyToGridSmooth(self, grid: GridBase, sigma: float = 1.0,
                          shift: float = 0.0, value=1.0, respectFlags=None):
        rf = respectFlags.data if respectFlags is not None else None
        grid.data = self.shape.apply_to_grid_smooth(
            grid.data, value, grid.dom, sigma, shift, rf)

    def computeLevelset(self):
        g = LevelsetGrid(self.solver)
        g.data = self.shape.compute_levelset(self.solver.domain,
                                             self.solver.device)
        return g

    def collideMesh(self, mesh):
        """Shape::collideMesh (shapes.cpp:106-131): push mesh nodes out of
        this shape to a 0.2-cell margin; sets NfCollide|NfMarked (mesh.h:135)
        on moved nodes in mesh.node_flags."""
        from ..core.mesh import collide_mesh_nodes
        dom = self.solver.domain
        phi = self.shape.compute_levelset(dom, self.solver.device)
        new_nodes, hit = collide_mesh_nodes(mesh.nodes, phi, dom)
        mesh.nodes = _np(new_nodes)
        nf = getattr(mesh, "node_flags", None)
        if nf is None or len(nf) != mesh.numNodes():
            nf = np.zeros(mesh.numNodes(), np.int32)
        NfMarked, NfCollide = 2, 8
        nf = np.where(_np(hit), nf | (NfCollide | NfMarked),
                      nf & ~(NfCollide | NfMarked))
        mesh.node_flags = nf.astype(np.int32)


class Box(_SceneShape):
    def _make(self, p0=None, p1=None, center=None, size=None):
        return shp.Box(p0=p0, p1=p1, center=center, size=size,
                       dim=self.solver.domain.dim)


class Sphere(_SceneShape):
    def _make(self, center, radius, scale=vec3(1, 1, 1)):
        return shp.Sphere(center=center, radius=radius, scale=scale)


class Cylinder(_SceneShape):
    def _make(self, center, radius, z):
        return shp.Cylinder(center=center, radius=radius, z=z)


class Slope(_SceneShape):
    def _make(self, anglexy, angleyz, origin, gs):
        return shp.Slope(anglexy, angleyz, origin, gs)


class NullShape(_SceneShape):
    def _make(self):
        return shp.NullShape()


class NoiseField:
    """Scene wrapper for WaveletNoiseField with mantaflow attribute names;
    its tiles live on the solver's device."""

    _MAPPING = {
        "posScale": "pos_scale", "posOffset": "pos_offset",
        "valScale": "val_scale", "valOffset": "val_offset",
        "clamp": "clamp", "clampNeg": "clamp_neg",
        "clampPos": "clamp_pos", "timeAnim": "time_anim",
    }

    def __init__(self, solver: "Solver" = None, fixedSeed: int = -1,
                 loadFromFile: bool = False, parent: "Solver" = None):
        solver = _resolve_parent(solver, parent)
        self.solver = solver
        self._n = WaveletNoiseField(solver.domain, fixedSeed, loadFromFile,
                                    device=solver.device)

    # mantaflow-style attribute spelling
    posScale = property(lambda s: vec3(*s._n.pos_scale))
    posOffset = property(lambda s: vec3(*s._n.pos_offset))
    valScale = property(lambda s: s._n.val_scale)
    valOffset = property(lambda s: s._n.val_offset)
    clamp = property(lambda s: s._n.clamp)
    clampNeg = property(lambda s: s._n.clamp_neg)
    clampPos = property(lambda s: s._n.clamp_pos)
    timeAnim = property(lambda s: s._n.time_anim)

    def __setattr__(self, name, value):
        if name in self._MAPPING:
            if name in ("posScale", "posOffset"):
                if not isinstance(value, (tuple, list)):
                    value = (float(value),) * 3
                value = tuple(float(v) for v in value)
            setattr(self._n, self._MAPPING[name], value)
        else:
            object.__setattr__(self, name, value)


# ---------------------------------------------------------------------------
# solver

class Solver:
    """FluidSolver equivalent (scene-facing): grid-size/dt/frame state plus
    the create() factory (fluidsolver.h:26-119). ``device``: where its grids
    live, resolved by ``resolve_device``."""

    def __init__(self, name: str = "solver", gridSize=(64, 64, 64),
                 dim: int = 3, fourthDim: int = -1, device=None):
        self.fourthDim = int(fourthDim)
        gs = tuple(int(v) for v in gridSize)
        if dim == 2:
            gs = (gs[0], gs[1], 1)
        self.name = name
        self.device = resolve_device(device)
        self.domain = Domain(size=gs, dim=dim)
        self.timestep = 1.0
        self.frameLength = 1.0
        self.cfl = 3.0
        self.timestepMin = 0.0001
        self.timestepMax = 1.0
        self._time_per_frame = 0.0
        self._lock_dt = False
        self.timeTotal = 0.0
        self.frame = 0
        self._count = 0

    # manta property names
    @property
    def dt(self):
        return self.timestep

    def getGridSize(self):
        return vec3(*self.domain.size)

    def is2D(self):
        return self.domain.dim == 2

    def is3D(self):
        return self.domain.dim == 3

    def create(self, cls, **kw):
        name = kw.pop("name", "")
        kw.pop("type", None)  # manta allows create(name=..., type=Cls)
        if issubclass(cls, GridBase):
            return cls(self, name=name)
        # shapes, noise fields, particle systems, meshes: ctor(solver, **kw)
        return cls(self, **kw)

    def step(self, frame: int = -1):
        """fluidsolver.cpp:143-166."""
        self._time_per_frame += self.timestep
        self.timeTotal += self.timestep
        self._count += 1
        if self._time_per_frame + slv.VECTOR_EPSILON > self.frameLength:
            self.frame += 1
            self.timeTotal = float(self.frame) * self.frameLength
            self._time_per_frame = 0.0
            self._lock_dt = False
        if frame >= 0:
            self.frame = frame

    def adaptTimestep(self, maxVel: float):
        """fluidsolver.cpp:184-204."""
        mvt = maxVel * self.timestep
        if not self._lock_dt:
            dt = max(min(self.timestep * (self.cfl / (mvt + 1e-5)),
                         self.timestepMax), self.timestepMin)
            if (self._time_per_frame + dt * 1.05) > self.frameLength:
                dt = (self.frameLength - self._time_per_frame) + 1e-4
            elif ((self._time_per_frame + dt + self.timestepMin)
                  > self.frameLength
                  or (self._time_per_frame + dt * 1.25) > self.frameLength):
                dt = (self.frameLength - self._time_per_frame + 1e-4) * 0.5
                self._lock_dt = True
            self.timestep = dt
        assert self.timestep > self.timestepMin / 2.0, "Invalid dt encountered!"

    def printMemInfo(self):
        pass


FluidSolver = Solver


from .timing_api import Timings  # noqa: E402  (real registry)


# ---------------------------------------------------------------------------
# plugin entry points (the JAX package's jitted wrappers become plain calls)

def cgSolveDiffusion(flags: FlagGrid, grid: GridBase, alpha: float = 0.25,
                     cgMaxIterFac: float = 1.0, cgAccuracy: float = 1e-4):
    """conjugategrad.cpp:350 cgSolveDiffusion (viscosity; see
    lidDrivenCavity.py)."""
    from ..core.domain import domain_from_shape
    dom = domain_from_shape(flags.data.shape)
    grid.data = prs.cg_solve_diffusion(flags.data, grid.data, dom,
                                       float(np.float32(alpha)),
                                       float(cgMaxIterFac), float(cgAccuracy))


def advectSemiLagrange(flags: FlagGrid, vel: MACGrid, grid: GridBase,
                       order: int = 1, strength: float = 1.0,
                       orderSpace: int = 1, openBounds: bool = False,
                       boundaryWidth: int = -1, clampMode: int = 2,
                       orderTrace: int = 1):
    """plugin/advection.cpp:443 advectSemiLagrange."""
    del openBounds, boundaryWidth  # deprecated in the reference too
    dt = float(np.float32(grid.solver.timestep))
    if isinstance(grid, MACGrid):
        fn = adv.advect_mac
    elif isinstance(grid, (RealGrid, LevelsetGrid)):
        fn = adv.advect_real
    elif isinstance(grid, Vec3Grid):
        fn = adv.advect_vec3
    else:
        raise TypeError("advectSemiLagrange: unsupported grid type")
    grid.data = fn(flags.data, vel.data, grid.data, dt, order, strength,
                   orderSpace, clampMode, orderTrace)


def solvePressure(vel: MACGrid, pressure: RealGrid, flags: FlagGrid,
                  cgAccuracy: float = 1e-3, phi=None, perCellCorr=None,
                  fractions=None, obvel=None, gfClamp: float = 1e-4,
                  cgMaxIterFac: float = 1.5, precondition: bool = True,
                  preconditioner: int = PcMIC,
                  enforceCompatibility: bool = False, useL2Norm: bool = False,
                  zeroPressureFixing: bool = False, curv=None,
                  surfTens: float = 0.0, retRhs: RealGrid | None = None):
    """plugin/pressure.cpp:482 solvePressure. The iteration count and the
    residual are read from the device only when the message prints."""
    from ..core.domain import domain_from_shape
    if not precondition:
        preconditioner = PcNone
    dom = domain_from_shape(flags.data.shape)
    new_vel, p, rhs, iters, rn = prs.solve_pressure(
        vel.data, flags.data, dom, cgAccuracy,
        phi.data if phi is not None else None,
        perCellCorr.data if perCellCorr is not None else None,
        fractions.data if fractions is not None else None,
        obvel.data if obvel is not None else None,
        gfClamp, cgMaxIterFac, preconditioner, enforceCompatibility,
        useL2Norm, zeroPressureFixing,
        curv.data if curv is not None else None, surfTens)
    vel.data = new_vel
    pressure.data = p
    if retRhs is not None:
        retRhs.data = rhs
    if _debug_level[0] >= 2:
        mantaMsg(f"FluidSolver::solvePressure done. Iterations:{int(iters)}, "
                 f"residual:{float(rn):g}", 2)


def setWallBcs(flags: FlagGrid, vel: MACGrid, obvel=None, fractions=None,
               phiObs=None, boundaryWidth: int = 0):
    """setWallBcs (extforces.cpp:327-335): plain axis-aligned kernel, or the
    second-order fraction variant when both fractions and phiObs are given."""
    ob = obvel.data if obvel is not None else None
    if fractions is not None and phiObs is not None:
        vel.data = ext.set_wall_bcs_frac(flags.data, vel.data, flags.dom,
                                         phiObs.data, ob)
    else:
        vel.data = ext.set_wall_bcs(flags.data, vel.data, flags.dom, ob)


def addGravity(flags: FlagGrid, vel: MACGrid, gravity, exclude=None,
               scale: bool = True):
    vel.data = ext.add_gravity(flags.data, vel.data, tuple(gravity),
                               flags.solver.timestep, flags.dom,
                               exclude.data if exclude is not None else None,
                               scale)


def addGravityNoScale(flags: FlagGrid, vel: MACGrid, gravity, exclude=None):
    addGravity(flags, vel, gravity, exclude, scale=False)


def addBuoyancy(flags: FlagGrid, density: RealGrid, vel: MACGrid, gravity,
                coefficient: float = 1.0, scale: bool = True):
    vel.data = ext.add_buoyancy(flags.data, density.data, vel.data,
                                tuple(gravity), flags.solver.timestep,
                                flags.dom, coefficient, scale)


def setOpenBound(flags: FlagGrid, bWidth: int, openBound: str = "",
                 type: int = fl.TypeOutflow | fl.TypeEmpty):
    flags.data = fl.set_open_bound(flags.data, flags.dom, bWidth, openBound,
                                   type)


def resetOutflow(flags: FlagGrid, phi=None, parts=None, real=None, index=None,
                 indexSys=None):
    new_flags, new_phi, new_real = ext.reset_outflow_grids(
        flags.data, flags.dom,
        phi.data if phi is not None else None,
        real.data if real is not None else None)
    flags.data = new_flags
    if phi is not None:
        phi.data = new_phi
    if real is not None:
        real.data = new_real
    if parts is not None:
        parts.kill_in_outflow(flags)


def vorticityConfinement(vel: MACGrid, flags: FlagGrid, strength: float = 0.0,
                         strengthCell=None):
    sc = strengthCell.data if strengthCell is not None else None
    vel.data = ext.vorticity_confinement(vel.data, flags.data, flags.dom,
                                         strength, sc)


def addForceField(flags: FlagGrid, vel: MACGrid, force: Vec3Grid, region=None,
                  isMAC: bool = False):
    vel.data = ext.apply_force_field(
        flags.data, vel.data, force.data, flags.dom,
        region.data if region is not None else None, True, isMAC)


def setForceField(flags: FlagGrid, vel: MACGrid, force: Vec3Grid, region=None,
                  isMAC: bool = False):
    vel.data = ext.apply_force_field(
        flags.data, vel.data, force.data, flags.dom,
        region.data if region is not None else None, False, isMAC)


def setInitialVelocity(flags: FlagGrid, vel: MACGrid, invel: Vec3Grid):
    vel.data = ext.set_initial_velocity(flags.data, vel.data, invel.data,
                                        flags.dom)


def setInflowBcs(vel: MACGrid, dir: str, value):
    vel.data = ext.set_inflow_bcs(vel.data, vel.dom, dir, tuple(value))


def dissolveSmoke(flags: FlagGrid, density: RealGrid, heat=None, red=None,
                  green=None, blue=None, speed: int = 5,
                  logFalloff: bool = True):
    d, h = ext.dissolve_smoke(flags.data, density.data, flags.dom,
                              heat.data if heat is not None else None,
                              speed, logFalloff)
    density.data = d
    if heat is not None:
        heat.data = h


def densityInflow(flags: FlagGrid, density: RealGrid, noise: NoiseField,
                  shape, scale: float = 1.0, sigma: float = 0.0):
    t = flags.solver.timeTotal * flags.dom.dx
    density.data = ini.density_inflow(flags.data, density.data, noise._n,
                                      shape.shape, flags.dom, scale, sigma,
                                      time=t)


def addNoise(flags: FlagGrid, density: RealGrid, noise: NoiseField, sdf=None,
             scale: float = 1.0):
    t = flags.solver.timeTotal * flags.dom.dx
    density.data = ini.add_noise(flags.data, density.data, noise._n,
                                 flags.dom,
                                 sdf.data if sdf is not None else None,
                                 scale, time=t)


def applyEmission(flags: FlagGrid, target: RealGrid, source: RealGrid,
                  emissionTexture=None, isAbsolute: bool = True):
    target.data = ini.apply_emission(
        flags.data, target.data, source.data, flags.dom,
        emissionTexture.data if emissionTexture is not None else None,
        isAbsolute)


def blurRealGrid(source: RealGrid, target: RealGrid, sigma: float = 1.0):
    target.data = ini.blur_real_grid(source.data, source.dom, sigma)


def blurMacGrid(source: MACGrid, target: MACGrid, sigma: float = 1.0):
    target.data = ini.blur_mac_grid(source.data, source.dom, sigma)


def checkSymmetry(a: RealGrid, err=None, symmetrize: bool = False,
                  axis: int = 0, bound: int = 0):
    """checkSymmetry (initplugins.cpp:189)."""
    new_a, new_err = ini.check_symmetry(
        a.data, a.dom, err.data if err is not None else None, symmetrize,
        axis, bound)
    a.data = new_a
    if err is not None:
        err.data = new_err


def checkSymmetryVec3(a, err=None, symmetrize: bool = False, axis: int = 0,
                      bound: int = 0, disable: int = 0):
    """checkSymmetryVec3 (initplugins.cpp:205)."""
    new_a, new_err = ini.check_symmetry_vec3(
        a.data, a.dom, err.data if err is not None else None, symmetrize,
        axis, bound, disable)
    a.data = new_a
    if err is not None:
        err.data = new_err


def testInitGridWithPos(grid: RealGrid):
    """testInitGridWithPos (flip.cpp:191): grid(i,j,k) = |Vec3(i,j,k)|."""
    sz, sy, sx = grid.dom.shape
    dev = grid.device
    x = torch.arange(sx, dtype=torch.float32, device=dev).reshape(1, 1, sx)
    y = torch.arange(sy, dtype=torch.float32, device=dev).reshape(1, sy, 1)
    z = torch.arange(sz, dtype=torch.float32, device=dev).reshape(sz, 1, 1)
    grid.data = torch.sqrt(x * x + y * y + z * z)


testInitGridWithPos.__test__ = False  # keep pytest from collecting it


def getGridAvg(source: RealGrid, flags=None):
    if flags is not None:
        m = fl.is_fluid(flags.data)
        s = torch.sum(torch.where(m, source.data, 0.0))
        c = torch.clamp(torch.sum(m.to(torch.float32)), min=1.0)
        return float(s / c)
    return float(torch.mean(source.data))


def gridMaxDiff(g1: GridBase, g2: GridBase):
    """Max abs per-cell difference (grid.cpp:437), the golden-test metric."""
    return float(torch.max(torch.abs(g1.data.to(torch.float32)
                                     - g2.data.to(torch.float32))))


def gridMaxDiffInt(g1, g2):
    return gridMaxDiff(g1, g2)


def gridMaxDiffVec3(g1, g2):
    return gridMaxDiff(g1, g2)


def copyMacToVec3(source: MACGrid, target: Vec3Grid):
    target.data = source.data


def copyVec3ToReal(source: Vec3Grid, targetX: RealGrid, targetY: RealGrid,
                   targetZ: RealGrid):
    targetX.data, targetY.data, targetZ.data = (source.data[0],
                                                source.data[1],
                                                source.data[2])


def copyRealToVec3(sourceX: RealGrid, sourceY: RealGrid, sourceZ: RealGrid,
                   target: Vec3Grid):
    target.data = torch.stack([sourceX.data, sourceY.data, sourceZ.data])


def copyLevelsetToReal(source: LevelsetGrid, target: RealGrid):
    target.data = source.data


def getComponent(source: Vec3Grid, target: RealGrid, component: int):
    target.data = source.data[component]


def _set_index(data, idx, value):
    """A copy of ``data`` with ``data[idx] = value`` (the JAX ``.at[].set``)."""
    out = data.clone()
    out[idx] = value
    return out


def setComponent(source: RealGrid, target: Vec3Grid, component: int):
    target.data = _set_index(target.data, component, source.data)


class Grid4Base:
    """4D space-time grid (grid4d.h:27-93), array layout [t,z,y,x]."""
    dtype = torch.float32
    channels = 0

    def __init__(self, solver: "Solver" = None, name: str = "",
                 parent: "Solver" = None):
        from ..core import grid4d as g4
        solver = _resolve_parent(solver, parent)
        self.solver = solver
        self.name = name
        st = max(solver.fourthDim, 1)
        sx, sy, sz = solver.domain.size
        self.data = g4.zeros4d((sx, sy, sz, st), self.dtype, self.channels,
                               device=solver.device)

    @property
    def device(self):
        return self.data.device

    def _const(self, v):
        """Scalar or per-channel (vec3/vec4) constant, broadcastable."""
        if self.channels and hasattr(v, "__len__"):
            return _vec_const(v, self.dtype, self.device,
                              self.channels).reshape(self.channels, 1, 1, 1,
                                                     1)
        return torch.tensor(v, dtype=self.dtype, device=self.device)

    def setConst(self, v):
        self.data = self._const(v).expand(self.data.shape).contiguous()

    def clear(self):
        self.data = torch.zeros_like(self.data)

    def add(self, other):
        self.data = self.data + other.data

    def sub(self, other):
        self.data = self.data - other.data

    def addConst(self, v):
        self.data = self.data + self._const(v)

    def addScaled(self, other, factor):
        self.data = self.data + self._const(factor) * other.data

    def multConst(self, v):
        self.data = self.data * self._const(v)

    def copyFrom(self, other):
        self.data = other.data.to(self.dtype)

    def getMaxAbs(self):
        return float(torch.max(torch.abs(self.data)))

    def getInterpolated(self, pos4):
        from ..core import grid4d as g4
        args = tuple(torch.tensor(pos4[c], dtype=torch.float32,
                                  device=self.device) for c in range(4))
        if self.channels:
            return tuple(float(g4.interpol4d(self.data[c], *args))
                         for c in range(self.channels))
        return float(g4.interpol4d(self.data, *args))

    def to_numpy(self):
        return _np(self.data)

    def from_numpy(self, arr):
        self.data = torch.tensor(np.asarray(arr)).to(
            device=self.device, dtype=self.dtype).reshape(self.data.shape)

    def _bnd_mask(self, w: int):
        st, sz, sy, sx = self.data.shape[-4:]
        dev = self.device
        i = torch.arange(sx, device=dev).reshape(1, 1, 1, sx)
        j = torch.arange(sy, device=dev).reshape(1, 1, sy, 1)
        k = torch.arange(sz, device=dev).reshape(1, sz, 1, 1)
        t = torch.arange(st, device=dev).reshape(st, 1, 1, 1)
        return ((i <= w) | (i >= sx - 1 - w) | (j <= w) | (j >= sy - 1 - w)
                | (k <= w) | (k >= sz - 1 - w) | (t <= w) | (t >= st - 1 - w))

    def setBound(self, value, boundaryWidth: int = 0):
        """knSetBnd4d (grid4d.cpp:299): constant on the 4D boundary shell."""
        m = self._bnd_mask(boundaryWidth)
        if self.channels:
            v = _vec_const(value, self.dtype, self.device, len(tuple(value)))
            self.data = torch.where(m[None], v.reshape(-1, 1, 1, 1, 1),
                                    self.data)
        else:
            self.data = torch.where(m, torch.tensor(value, dtype=self.dtype,
                                                    device=self.device),
                                    self.data)

    def setBoundNeumann(self, boundaryWidth: int = 0):
        """knSetBnd4dNeumann (grid4d.cpp:313): copy the nearest interior
        value onto the boundary shell (per-axis clamped source index)."""
        st, sz, sy, sx = self.data.shape[-4:]
        w = boundaryWidth

        def src_idx(n):
            r = torch.arange(n, device=self.device)
            return torch.clamp(r, w + 1, n - 2 - w)

        d = torch.index_select(self.data, self.data.ndim - 1, src_idx(sx))
        d = torch.index_select(d, d.ndim - 2, src_idx(sy))
        d = torch.index_select(d, d.ndim - 3, src_idx(sz))
        d = torch.index_select(d, d.ndim - 4, src_idx(st))
        m = self._bnd_mask(w)
        if self.channels:
            m = m[None]
        self.data = torch.where(m, d, self.data)


class Grid4Real(Grid4Base):
    pass


class Grid4Int(Grid4Base):
    dtype = torch.int32


class Grid4Vec3(Grid4Base):
    channels = 3


class Grid4Vec4(Grid4Base):
    channels = 4


def getSliceFrom4d(src: Grid4Real, srct: int, dst):
    """getSliceFrom4d (grid4d.cpp): copy time slice srct into a 3D grid."""
    dst.data = src.data[srct] if src.channels == 0 else src.data[:, srct]


def setSliceTo4d(src, dst: Grid4Real, dstt: int):
    if dst.channels == 0:
        dst.data = _set_index(dst.data, dstt, src.data)
    else:
        dst.data = _set_index(dst.data, (slice(None), dstt), src.data)


def getComp4d(src: Grid4Vec4, dst: Grid4Real, c: int):
    """getComp4d (grid4d.cpp:295): extract one component of a Vec4 grid."""
    dst.data = src.data[c]


def setComp4d(src: Grid4Real, dst: Grid4Vec4, c: int):
    """setComp4d (grid4d.cpp:296)."""
    dst.data = _set_index(dst.data, c, src.data)


def grid4dMaxDiff(g1: Grid4Real, g2: Grid4Real) -> float:
    """grid4dMaxDiff (grid4d.cpp:352): max per-cell |difference|."""
    return float(torch.max(torch.abs(g1.data.to(torch.float32)
                                     - g2.data.to(torch.float32))))


def grid4dMaxDiffInt(g1: Grid4Int, g2: Grid4Int) -> float:
    return grid4dMaxDiff(g1, g2)


def grid4dMaxDiffVec3(g1: Grid4Vec3, g2: Grid4Vec3) -> float:
    """grid4dMaxDiffVec3 (grid4d.cpp:368): max over cells of the SUM of
    per-component |differences| (reference sums components per cell)."""
    d = torch.abs(g1.data.to(torch.float32) - g2.data.to(torch.float32))
    return float(torch.max(torch.sum(d, dim=0)))


def grid4dMaxDiffVec4(g1: Grid4Vec4, g2: Grid4Vec4) -> float:
    return grid4dMaxDiffVec3(g1, g2)


def _region4d_mask(shape4, start, end, device):
    st, sz, sy, sx = shape4
    i = torch.arange(sx, device=device).reshape(1, 1, 1, sx)
    j = torch.arange(sy, device=device).reshape(1, 1, sy, 1)
    k = torch.arange(sz, device=device).reshape(1, sz, 1, 1)
    t = torch.arange(st, device=device).reshape(st, 1, 1, 1)
    return ((i >= start[0]) & (i <= end[0]) & (j >= start[1])
            & (j <= end[1]) & (k >= start[2]) & (k <= end[2])
            & (t >= start[3]) & (t <= end[3]))


def setRegion4d(dst: Grid4Real, start, end, value: float):
    """setRegion4d (grid4d.cpp:402): constant fill of an ijkt box."""
    m = _region4d_mask(dst.data.shape[-4:], tuple(start), tuple(end),
                       dst.device)
    dst.data = torch.where(m, torch.tensor(value, dtype=dst.dtype,
                                           device=dst.device), dst.data)


def setRegion4dVec4(dst: Grid4Vec4, start, end, value):
    m = _region4d_mask(dst.data.shape[-4:], tuple(start), tuple(end),
                       dst.device)
    v = _vec_const(value, dst.dtype, dst.device,
                   len(tuple(value))).reshape(-1, 1, 1, 1, 1)
    dst.data = torch.where(m[None], v, dst.data)


def getSliceFrom4dVec(src: Grid4Vec4, srct: int, dst, dstt=None):
    """getSliceFrom4dVec (grid4d.cpp:420): xyz components of time slice srct
    into a Vec3 grid, optionally the t component into a Real grid."""
    dst.data = src.data[:3, srct]
    if dstt is not None:
        dstt.data = src.data[3, srct]


def interpolateGrid4d(target: Grid4Base, source: Grid4Base,
                      offset=(0, 0, 0, 0), scale=(1, 1, 1, 1),
                      size=(-1, -1, -1, -1)):
    """interpolateGrid4d(+Vec) (grid4d.cpp:455-468): resample a 4D grid;
    pos = ijkt*srcFac - offset*srcFac + srcFac/2, srcFac from the size
    ratio (overridable via `size`) divided by `scale`."""
    from ..core import grid4d as g4
    st, sz, sy, sx = target.data.shape[-4:]
    ss = source.data.shape[-4:]  # (T,Z,Y,X)
    tgt = [sx, sy, sz, st]
    eff = [size[c] if size[c] > 0 else tgt[c] for c in range(4)]
    f = [ss[3 - c] / eff[c] / scale[c] for c in range(4)]
    off2 = [-offset[c] * f[c] + f[c] * 0.5 for c in range(4)]
    dev = target.device

    def axis(n, c, shp4):
        a = torch.arange(n, dtype=torch.float32, device=dev).reshape(shp4)
        return a * f[c] + off2[c]

    shape = (st, sz, sy, sx)
    px = axis(sx, 0, (1, 1, 1, sx)).expand(shape)
    py = axis(sy, 1, (1, 1, sy, 1)).expand(shape)
    pz = axis(sz, 2, (1, sz, 1, 1)).expand(shape)
    pt = axis(st, 3, (st, 1, 1, 1)).expand(shape)
    if target.channels:
        target.data = torch.stack([
            g4.interpol4d(source.data[c], px, py, pz, pt)
            for c in range(target.channels)])
    else:
        target.data = g4.interpol4d(source.data, px, py, pz, pt)


def interpolateGrid4dVec(target: Grid4Vec4, source: Grid4Vec4,
                         offset=(0, 0, 0, 0), scale=(1, 1, 1, 1),
                         size=(-1, -1, -1, -1)):
    interpolateGrid4d(target, source, offset, scale, size)


def printBuildInfo():
    mantaMsg("mantaflow-tpu: PyTorch build, torch " + torch.__version__
             + (", CUDA " + str(torch.version.cuda)
                if torch.version.cuda else ", CPU"))


def assertNumpy():
    pass
