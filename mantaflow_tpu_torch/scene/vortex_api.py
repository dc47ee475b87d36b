"""Scene API on the port: vortex particles, vortex-sheet meshes, turbulence
particles (vortexpart.h, vortexsheet.h, turbulencepart.h,
plugin/vortexplugins.cpp). Mesh topology and the vortex particles stay on
the host as numpy arrays, as in the JAX package; the turbulence particles'
positions and texture coordinates live on the solver's device."""

from __future__ import annotations

import numpy as np
import torch

from ..ops import vortex as vx
from .api import (FlagGrid, LevelsetGrid, MACGrid, RealGrid, Solver, Vec3Grid,
                  _np)
from .mesh_api import Mesh


class VortexParticleSystem:
    """Vortex particles with Gaussian-mollified kernel induction
    (vortexpart.h:33-41)."""

    def __init__(self, solver: Solver = None, name: str = "",
                 parent: Solver = None):
        solver = solver if solver is not None else parent
        self.solver = solver
        self.pos = np.zeros((0, 3), np.float32)
        self.vorticity = np.zeros((0, 3), np.float32)
        self.sigma = np.zeros((0,), np.float32)

    def size(self):
        return self.pos.shape[0]

    pySize = size

    def add(self, pos, vorticity, sigma):
        self.pos = np.concatenate([self.pos, np.asarray([pos], np.float32)])
        self.vorticity = np.concatenate(
            [self.vorticity, np.asarray([vorticity], np.float32)])
        self.sigma = np.concatenate(
            [self.sigma, np.asarray([sigma], np.float32)])

    def _dev(self, a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            self.solver.device)

    def _vp_args(self):
        active = torch.ones(self.pos.shape[0], dtype=torch.bool,
                            device=self.solver.device)
        return (self._dev(self.pos), self._dev(self.vorticity),
                self._dev(self.sigma), active)

    def advectSelf(self, scale: float = 1.0, integrationMode: int = 2):
        new = vx.vp_advect_points(
            self._dev(self.pos), *self._vp_args(),
            scale * self.solver.timestep, integrationMode, self_adv=True)
        self.pos = _np(new)

    def applyToMesh(self, mesh: Mesh, scale: float = 1.0,
                    integrationMode: int = 2):
        new = vx.vp_advect_points(
            self._dev(mesh.nodes), *self._vp_args(),
            scale * self.solver.timestep, integrationMode)
        mesh.nodes = _np(new)


def VPseedK41(system: VortexParticleSystem, shape, strength: float = 0.0,
              sigma0: float = 0.2, sigma1: float = 1.0,
              probability: float = 1.0, N: float = 3.0):
    pos, vort, sig = vx.vp_seed_k41(shape.shape, system.solver.domain,
                                    system.solver.timestep, strength, sigma0,
                                    sigma1, probability, N)
    system.pos = np.concatenate([system.pos, pos])
    system.vorticity = np.concatenate([system.vorticity, vort])
    system.sigma = np.concatenate([system.sigma, sig])


#: process-level statics mirroring the reference's C++ function statics
#: (turbulencepart.cpp:58 `static RandomStream rand(34894231)`, :117-118
#: `static Real ctime; static Vec3 inflow`). reset_process_statics()
#: emulates a fresh process (the reference runs one scene per process).
_turb_statics = {"stream": None, "ctime": 0.0, "inflow": None}


def reset_process_statics():
    _turb_statics["stream"] = None
    _turb_statics["ctime"] = 0.0
    _turb_statics["inflow"] = None


def _hsv2rgb_scalar(h: float, s: float, v: float):
    """hsv2rgb (turbulencepart.cpp:34-54)."""
    i = int(h * 6)
    f = h * 6 - i
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    return [(v, t, p), (q, v, p), (p, v, t),
            (p, q, v), (t, p, v), (v, p, q)][i % 6]


class TurbulenceParticleSystem:
    """Synthesized-turbulence tracers (turbulencepart.h:35-42,
    turbulencepart.cpp) with the reference's exact static RNG stream and
    static synthesize-time state. ``pos``, ``tex0`` and ``tex1`` are (N, 3)
    tensors on the solver's device, ``color`` a host array."""

    def __init__(self, solver: Solver = None, noise=None,
                 name: str = "", parent: Solver = None):
        solver = solver if solver is not None else parent
        self.solver = solver
        self.noise = noise
        empty = torch.zeros((0, 3), dtype=torch.float32, device=solver.device)
        self.pos = self.tex0 = self.tex1 = empty
        self.color = np.zeros((0, 3), np.float32)

    def size(self):
        return self.pos.shape[0]

    pySize = size

    def seed(self, shape, num: int):
        """seed (turbulencepart.cpp:57-68): rejection-sample the shape's
        bounding box with the persistent RandomStream(34894231)."""
        from ..utils.mtrand import RandomStream
        if _turb_statics["stream"] is None:
            _turb_statics["stream"] = RandomStream(34894231)
        stream = _turb_statics["stream"]
        core = shape.shape
        ext = np.asarray(core.get_extent(), np.float32)
        p0 = np.asarray(core.get_center(), np.float32) - ext * 0.5
        pts = np.empty((num, 3), np.float32)
        cols = np.empty((num, 3), np.float32)
        for i in range(num):
            while True:
                p = stream.get_vec3s(1)[0] * ext + p0
                if bool(core.is_inside(float(p[0]), float(p[1]),
                                       float(p[2]))):
                    break
            pts[i] = p
            z = (p[2] - p0[2]) / ext[2] if ext[2] != 0 else 0.0
            cols[i] = _hsv2rgb_scalar(float(z), 0.75, 1.0)
        new = torch.from_numpy(pts).to(self.solver.device)
        self.pos = torch.cat([self.pos, new])
        self.tex0 = torch.cat([self.tex0, new])
        self.tex1 = torch.cat([self.tex1, new])
        self.color = np.concatenate([self.color, cols])

    def resetTexCoords(self, num: int, inflow):
        off = torch.from_numpy(np.asarray(inflow, np.float32)).to(
            self.solver.device)
        if num == 0:
            self.tex0 = self.pos - off
        else:
            self.tex1 = self.pos - off

    def synthesize(self, flags: FlagGrid, k: RealGrid, octaves: int = 2,
                   switchLength: float = 10.0, L0: float = 0.1,
                   scale: float = 1.0, inflowBias=(0.0, 0.0, 0.0)):
        """synthesize (turbulencepart.cpp:113-131): static ctime/inflow,
        tex resets at the hat-function wrap points, alpha pinned to 1.0
        (reference line `alpha = 1.0`), kmin = 1.5*0.1^2."""
        dt = self.solver.timestep
        if _turb_statics["inflow"] is None:
            _turb_statics["inflow"] = np.zeros(3, np.float32)
        _turb_statics["inflow"] = (_turb_statics["inflow"]
                                   + np.asarray(inflowBias, np.float32) * dt)
        ctime = _turb_statics["ctime"]
        old_alpha = 2.0 * ((ctime / switchLength) % 1.0)
        ctime += dt
        _turb_statics["ctime"] = ctime
        alpha = 2.0 * ((ctime / switchLength) % 1.0)
        if old_alpha < 1.0 <= alpha:
            self.resetTexCoords(0, _turb_statics["inflow"])
        if old_alpha > alpha:
            self.resetTexCoords(1, _turb_statics["inflow"])
        alpha = 1.0  # the reference pins alpha after the resets

        dom = self.solver.domain
        self.pos, self.tex0, self.tex1 = vx.synthesize_turbulence(
            self.pos, self.tex0, self.tex1, flags.data, k.data,
            self.noise._n, dom, alpha, dt, octaves, scale, 1.0 / L0,
            1.5 * 0.1 ** 2)

    # legacy spelling kept for existing tests; explicit alpha/kmin override
    def synthesizeTurbulence(self, flags: FlagGrid, k: RealGrid, octaves: int,
                             switchLength: float = 10.0, L0: float = 0.1,
                             scale: float = 1.0, inflowBias=None,
                             alpha: float | None = None,
                             kmin: float = 0.0):
        dom = self.solver.domain
        if alpha is None:
            t = self.solver.timeTotal / switchLength
            t = t - np.floor(t)
            alpha = 2.0 * t if t < 0.5 else 2.0 - 2.0 * t
        self.pos, self.tex0, self.tex1 = vx.synthesize_turbulence(
            self.pos, self.tex0, self.tex1, flags.data, k.data,
            self.noise._n, dom, alpha, self.solver.timestep, octaves, scale,
            1.0 / L0, kmin)

    def advectInGrid(self, flags: FlagGrid, vel: MACGrid,
                     integrationMode: int = 2):
        # generic ParticleSystem::advectInGrid — positions only, the
        # texcoords are moved by synthesize()'s noise step instead
        from ..core import particles as cp
        n = self.size()
        dev = self.pos.device
        parts = cp.Particles(
            pos=self.pos, flags=torch.zeros(n, dtype=torch.int32, device=dev),
            count=torch.tensor(n, dtype=torch.int32, device=dev))
        self.pos = cp.advect_in_grid(parts, flags.data, vel.data,
                                     self.solver.timestep, self.solver.domain,
                                     integrationMode,
                                     delete_in_obstacle=False).pos

    def deleteInObstacle(self, flags: FlagGrid):
        dom = self.solver.domain
        sz, sy, sx = dom.shape
        p = self.pos
        ii = torch.clamp(p[:, 0].to(torch.int64), 0, sx - 1)
        jj = torch.clamp(p[:, 1].to(torch.int64), 0, sy - 1)
        kk = torch.clamp(p[:, 2].to(torch.int64), 0, sz - 1)
        keep = (flags.data[kk, jj, ii] & 2) == 0
        self.pos = self.pos[keep]
        self.tex0 = self.tex0[keep]
        self.tex1 = self.tex1[keep]
        self.color = self.color[_np(keep)]


class VortexSheetMesh(Mesh):
    """Mesh carrying per-triangle circulation/vorticity/smoke and two node
    texcoord3 channels (vortexsheet.h:38-82)."""

    def __init__(self, solver: Solver = None, name: str = "",
                 parent: Solver = None):
        solver = solver if solver is not None else parent
        super().__init__(solver, name)
        self.tri_vorticity = np.zeros((0, 3), np.float32)
        self.tri_vorticity_smoothed = np.zeros((0, 3), np.float32)
        self.tri_circulation = np.zeros((0, 3), np.float32)
        self.tri_smoke = np.zeros((0,), np.float32)
        self.node_fixed = np.zeros((0,), bool)
        self.tex1 = np.zeros((0, 3), np.float32)
        self.tex2 = np.zeros((0, 3), np.float32)
        self.tex_offset = np.zeros(3, np.float32)

    def _sync(self):
        nt = self.numTris()
        if self.tri_vorticity.shape[0] != nt:
            self.tri_vorticity = np.zeros((nt, 3), np.float32)
            self.tri_vorticity_smoothed = np.zeros((nt, 3), np.float32)
            self.tri_circulation = np.zeros((nt, 3), np.float32)
            self.tri_smoke = np.zeros((nt,), np.float32)
        if self.node_fixed.shape[0] != self.numNodes():
            self.node_fixed = np.zeros((self.numNodes(),), bool)
            self.reinitTexCoords()

    def faceCenters(self):
        return self.nodes[self.tris].mean(axis=1)

    def faceNormalsAreas(self):
        a = self.nodes[self.tris[:, 0]]
        b = self.nodes[self.tris[:, 1]]
        c = self.nodes[self.tris[:, 2]]
        n = np.cross(b - a, c - a)
        area = 0.5 * np.linalg.norm(n, axis=1)
        n = n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)
        return n, area

    def _edges(self):
        """Per-tri edge vectors (e0,e1,e2) as (nt,3,3)."""
        p = self.nodes[self.tris]
        return np.stack([p[:, 1] - p[:, 0], p[:, 2] - p[:, 1],
                         p[:, 0] - p[:, 2]], axis=1)

    def calcVorticity(self):
        """vorticity = (c0*e0 + c1*e1 + c2*e2)/area (vortexsheet.cpp:47)."""
        self._sync()
        e = self._edges()
        _, area = self.faceNormalsAreas()
        w = np.einsum("tc,tcd->td", self.tri_circulation, e) \
            / np.maximum(area, 1e-10)[:, None]
        bad = area < 1e-10
        w[bad] = 0.0
        self.tri_vorticity = w.astype(np.float32)

    def calcCirculation(self):
        """Least-squares per-tri edge coefficients for the stored vorticity
        (vortexsheet.cpp:61). The reference's generated SolveOverconstraint34
        (util/solvana.h) solves [e1 e2 e3; 1 1 1] c = [w; 0] — the extra row
        biases toward sum(c)=0; here that is the rank-one +1 block in the
        normal equations, batched over triangles. circulation = c * area."""
        self._sync()
        e = self._edges()  # (nt, 3 coeffs, 3 dims)
        _, area = self.faceNormalsAreas()
        w = self.tri_vorticity
        # normal equations (E E^T + 1) c = E w with E rows = edge vectors;
        # Tikhonov scaled to the gram trace keeps sliver tris solvable
        g = np.einsum("tcd,tkd->tck", e, e).astype(np.float64)
        g += np.ones((3, 3))[None]  # the "1 1 1" constraint row, target 0
        tr = np.trace(g, axis1=1, axis2=2)
        g += (1e-6 * tr + 1e-12)[:, None, None] * np.eye(3)[None]
        rhs = np.einsum("tcd,td->tc", e, w).astype(np.float64)
        c = np.linalg.solve(g, rhs[:, :, None])[:, :, 0]
        c *= area[:, None]
        c[(area < 1e-10) | (np.sum(w * w, axis=1) < 1e-10)] = 0.0
        self.tri_circulation = c.astype(np.float32)

    def setReferenceTexOffset(self, o):
        self.tex_offset = np.asarray(o, np.float32)

    def resetTex1(self):
        self.tex1 = (self.nodes + self.tex_offset[None]).astype(np.float32)

    def resetTex2(self):
        self.tex2 = (self.nodes + self.tex_offset[None]).astype(np.float32)

    def reinitTexCoords(self):
        """reinitTexCoords (vortexsheet.cpp:88)."""
        self.resetTex1()
        self.resetTex2()


def _inside(shape, pts):
    """The shape's inside test at host points (M, 3), as a bool array."""
    p = torch.from_numpy(np.ascontiguousarray(pts, np.float32))
    return _np(shape.shape.is_inside(p[:, 0], p[:, 1], p[:, 2]))


def markAsFixed(mesh: VortexSheetMesh, shape):
    """markAsFixed (vortexplugins.cpp:29): pin nodes inside the shape."""
    mesh._sync()
    inside = _inside(shape, mesh.nodes)
    mesh.node_fixed = mesh.node_fixed | inside


def vorticitySource(mesh: VortexSheetMesh, gravity, vel=None, velOld=None,
                    scale: float = 0.1, maxAmount: float = 0.0,
                    mult: float = 1.0):
    """vorticitySource (vortexplugins.cpp:83): baroclinic generation
    dt * (-n x (a - g)) * scale / dx on each triangle."""
    mesh._sync()
    dt = mesh.solver.timestep
    dx = mesh.solver.domain.dx
    n, _ = mesh.faceNormalsAreas()
    g = np.asarray(gravity, np.float32)
    if vel is not None and velOld is not None:
        from ..core.interp import interpol_mac
        fc = torch.from_numpy(mesh.faceCenters()).to(vel.device)
        acc = (vel.data - velOld.data) / dt
        u, v, w = interpol_mac(acc, fc[:, 0], fc[:, 1], fc[:, 2])
        a = np.stack([_np(u), _np(v), _np(w)], axis=1)
        source = -np.cross(n, a - g) * scale
    else:
        source = -np.cross(n, -g[None, :]) * scale
    fixed_tri = mesh.node_fixed[mesh.tris].any(axis=1)
    source[fixed_tri] = 0.0
    vort = mesh.tri_vorticity * mult + dt * source / dx
    if maxAmount > 0:
        vn = np.linalg.norm(vort, axis=1)
        f = np.where(vn > maxAmount, maxAmount / np.maximum(vn, 1e-12), 1.0)
        vort *= f[:, None]
    mesh.tri_vorticity = vort.astype(np.float32)


def smoothVorticity(mesh: VortexSheetMesh, iter: int = 1, sigma: float = 0.2,
                    alpha: float = 0.8):
    """smoothVorticity (vortexplugins.cpp:122): Gaussian-weighted averaging
    over edge-adjacent triangles."""
    import scipy.sparse as sp
    mesh._sync()
    tris = mesh.tris
    nt = tris.shape[0]
    pos = mesh.faceCenters()
    # adjacency via shared edges
    edges = {}
    rows, cols, vals = [], [], []
    mult = -0.5 / (sigma * sigma)
    for t in range(nt):
        for e in range(3):
            key = tuple(sorted((tris[t, e], tris[t, (e + 1) % 3])))
            if key in edges:
                o = edges[key]
                w = float(np.exp(np.sum((pos[o] - pos[t]) ** 2) * mult))
                rows += [t, o]
                cols += [o, t]
                vals += [w, w]
            else:
                edges[key] = t
    adj = sp.coo_matrix((vals, (rows, cols)), shape=(nt, nt)).tocsr()
    v = mesh.tri_vorticity.copy()
    for _ in range(iter):
        wsum = 1.0 + np.asarray(adj.sum(axis=1)).ravel()
        v = (v + adj @ v) / wsum[:, None]
    mesh.tri_vorticity_smoothed = (v * alpha).astype(np.float32)


def VICintegration(mesh: VortexSheetMesh, sigma: float, vel: Vec3Grid,
                   flags: FlagGrid, vorticity=None, cgMaxIterFac: float = 1.5,
                   cgAccuracy: float = 1e-3, scale: float = 0.01,
                   precondition: int = 0):
    mesh._sync()
    _, areas = mesh.faceNormalsAreas()
    v, vort = vx.vic_integration(
        mesh.faceCenters(), mesh.tri_vorticity, areas, flags.data, flags.dom,
        sigma, cgMaxIterFac, cgAccuracy, scale)
    vel.data = v
    if vorticity is not None:
        vorticity.data = vort


def densityFromLevelset(phi: LevelsetGrid, density: RealGrid,
                        value: float = 1.0, sigma: float = 1.0):
    density.data = vx.density_from_levelset(phi.data, phi.dom, value, sigma)


def texcoordInflow(mesh: VortexSheetMesh, shape, vel: MACGrid):
    """texcoordInflow (vortexplugins.cpp:41): advance the reference tex
    offset against the mean inflow velocity and pin both texcoord channels
    to pos + offset inside the shape (effective inflow advection)."""
    mesh._sync()
    from ..core import mac as macops
    dom = vel.dom
    inside_g = _np(shape.shape.compute_levelset(dom, vel.device)) < 0
    cc = _np(macops.get_centered(vel.data))
    cnt = max(int(inside_g.sum()), 1)
    mean_v = np.stack([cc[c][inside_g].sum() for c in range(3)]) / cnt
    t0 = mesh.tex_offset - mesh.solver.timestep * mean_v.astype(np.float32)
    mesh.setReferenceTexOffset(t0)
    inside = _inside(shape, mesh.nodes)
    tc = mesh.nodes + t0[None]
    mesh.tex1 = np.where(inside[:, None], tc, mesh.tex1).astype(np.float32)
    mesh.tex2 = np.where(inside[:, None], tc, mesh.tex2).astype(np.float32)


def meshSmokeInflow(mesh: VortexSheetMesh, shape, amount: float = 1.0):
    """meshSmokeInflow (vortexplugins.cpp:69): set the per-triangle smoke
    amount for faces whose center lies inside the shape."""
    mesh._sync()
    fc = mesh.faceCenters()
    inside = _inside(shape, fc)
    mesh.tri_smoke = np.where(inside, np.float32(amount),
                              mesh.tri_smoke).astype(np.float32)
