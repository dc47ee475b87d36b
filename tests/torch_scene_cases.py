"""The scene API parity cases shared by tests/test_torch_scene_api.py and
tests/test_torch_scene_api_parts.py: each case is one scenario written
once against a package ``m`` (the JAX package, or the port on the CPU),
fed the same seeded numpy inputs; ``compare`` holds the two packages'
outputs to the case's tolerance (see tests/test_torch_scene_api.py)."""

import numpy as np
import torch

import mantaflow_tpu as J
import mantaflow_tpu_torch as T

F32 = np.float32


def arr(x):
    """Host numpy value of a grid, pdata, tensor, JAX array or number."""
    if hasattr(x, "data") and not isinstance(x, np.ndarray):
        x = x.data
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def solver_of(m):
    if m is T:
        return lambda **kw: T.Solver(device="cpu", **kw)
    return J.Solver


def _shape(n, dim):
    return (n, n, n) if dim == 3 else (1, n, n)


def base(m, n=16, dim=3, seed=0):
    """A solver with walls, a sphere of liquid (numpy SDF), a random MAC
    velocity, density and pressure, all from one seeded numpy stream."""
    rng = np.random.default_rng(seed)
    shape = _shape(n, dim)
    s = solver_of(m)(name="s", gridSize=m.vec3(n, n, n if dim == 3 else 1),
                     dim=dim)
    g = {"s": s, "rng": rng, "shape": shape, "n": n}
    z, y, x = np.meshgrid(*[np.arange(k, dtype=F32) + 0.5 for k in shape],
                          indexing="ij")
    cz = n * 0.5 if dim == 3 else 0.5
    phi = np.sqrt((x - n * 0.5) ** 2 + (y - n * 0.35) ** 2
                  + (z - cz) ** 2).astype(F32) - F32(n * 0.3)
    g["phi_np"] = phi
    g["flags"] = s.create(m.FlagGrid)
    g["flags"].initDomain(boundaryWidth=1)
    g["phi"] = s.create(m.LevelsetGrid)
    g["phi"].from_numpy(phi)
    g["flags"].updateFromLevelset(g["phi"])
    for k, c, sh, amp in (("vel", m.MACGrid, (3,) + shape, 0.5),
                          ("v3", m.Vec3Grid, (3,) + shape, 1.0),
                          ("dens", m.RealGrid, shape, 1.0),
                          ("real", m.RealGrid, shape, 2.0)):
        g[k] = s.create(c)
        a = rng.uniform(-amp, amp, sh).astype(F32)
        if k == "dens":
            a = np.abs(a)
        if dim == 2 and sh[0] == 3:
            a[2] = 0
        g[k].from_numpy(a)
    g["pressure"] = s.create(m.RealGrid)
    return g


def liquid(m, n=16, dim=3, seed=0, disc=2):
    """``base`` plus particles sampled in the liquid (the same positions in
    both packages: the sampler is numpy) and their velocities."""
    g = base(m, n, dim, seed)
    pp = g["s"].create(m.BasicParticleSystem)
    pv = pp.create(m.PdataVec3)
    m.sampleLevelsetWithParticles(phi=g["phi"], flags=g["flags"], parts=pp,
                                  discretization=disc, randomness=0.1)
    m.mapMACToParts(flags=g["flags"], vel=g["vel"], parts=pp, partVel=pv)
    g["pp"], g["pv"] = pp, pv
    return g


def parts_out(pp):
    n = pp.pySize()
    return {"count": n, "pos": arr(pp.parts.pos)[:n],
            "pflags": arr(pp.parts.flags)[:n]}


# ---------------------------------------------------------------------------
# cases: each returns {name: value}; CASES[name] = (fn, tolerance)

CASES = {}


def case(tol=1e-6, name=None):
    def deco(fn):
        CASES[name or fn.__name__] = (fn, tol)
        return fn
    return deco


@case(tol=2e-6)  # the sums of getL1/getL2 add in another order
def grid_arithmetic(m):
    g = base(m)
    a, b, v3 = g["real"], g["dens"], g["v3"]
    out = {}
    c = g["s"].create(m.RealGrid)
    c.copyFrom(a)
    c.add(b)
    c.sub(g["dens"])
    c.mult(b)
    c.addConst(0.25)
    c.multConst(1.5)
    c.addScaled(b, 0.5)
    out["c"] = arr(c)
    c.clamp(-0.3, 0.4)
    out["clamped"] = arr(c)
    out["stats"] = [a.getMax(), a.getMin(), a.getMaxAbs(), a.getL1(),
                    a.getL2(), a.getL1(2), a.getL2(1)]
    out["vstats"] = [v3.getMax(), v3.getMin(), v3.getMaxAbs()]
    w = g["s"].create(m.Vec3Grid)
    w.setConst(m.vec3(1, 2, 3))
    w.addConst(m.vec3(0.5, -1, 2))
    w.multConst(m.vec3(2, 3, -1))
    w.addScaled(v3, m.Vec3(0.5, 0.25, 1))
    out["w"] = arr(w)
    w.clamp_norm(1.5)
    out["w_norm"] = arr(w)
    i = g["s"].create(m.IntGrid)
    i.setConst(3)
    i.addConst(2)
    out["int"] = arr(i)
    c.setConst(7.0)
    c.setBound(-1.0, 2)
    out["bound"] = arr(c)
    d = g["s"].create(m.RealGrid)
    d.copyFrom(a)
    d.setBoundNeumann(1)
    out["neumann"] = arr(d)
    w.setBound((1.0, 2.0, 3.0), 1)
    out["vbound"] = arr(w)
    w.clear()
    out["cleared"] = arr(w)
    out["to_numpy"] = a.to_numpy()
    out["solver"] = [tuple(g["s"].getGridSize()), g["s"].is2D(),
                     g["s"].is3D(), g["s"].dt]
    return out


@case()
def mac_and_levelset(m):
    g = base(m)
    out = {}
    vel = g["vel"]
    out["centered"] = arr(vel.getCentered())
    for w in (1, 2):
        for norm in (False, True):
            v = g["s"].create(m.MACGrid)
            v.copyFrom(vel)
            v.setBoundMAC(m.vec3(0.1, 0.2, 0.3), w, normalOnly=norm)
            out[f"bmac{w}{norm}"] = arr(v)
    v = g["s"].create(m.MACGrid)
    v.copyFrom(vel)
    v.set_bound_MAC2(m.vec3(0.5, -0.5, 0.25), 1)
    out["bmac2"] = arr(v)
    phi, other = g["phi"], g["s"].create(m.LevelsetGrid)
    other.from_numpy(g["phi_np"][:, :, ::-1].copy() + 1.0)
    p = g["s"].create(m.LevelsetGrid)
    out["invalid"] = arr(p)
    p.copyFrom(phi)
    p.join(other)
    out["join"] = arr(p)
    p.copyFrom(phi)
    p.subtract(other)
    out["subtract"] = arr(p)
    p.copyFrom(phi)
    p.subtract(other, flags=g["flags"], subtractType=m.FlagFluid)
    out["subtract_flags"] = arr(p)
    p.initFromFlags(g["flags"])
    out["from_flags"] = arr(p)
    p.initFromFlags(g["flags"], ignore_walls=True)
    out["from_flags_walls"] = arr(p)
    h = np.where(g["phi_np"] < 0, -1.0, 1.0).astype(F32)
    h[8, 8, 8] = 1.0
    p.from_numpy(h)
    p.fillHoles(10)
    out["fill_holes"] = arr(p)
    p.from_numpy(np.where(g["phi_np"] < 0, -0.5, 0.5).astype(F32))
    v.copyFrom(vel)
    p.reinitMarching(flags=g["flags"], velTransport=v)
    out["reinit_phi"], out["reinit_vel"] = arr(p), arr(v)
    return out


@case()
def flag_grid(m):
    g = base(m)
    s, out = g["s"], {}
    f = s.create(m.FlagGrid)
    walls = s.create(m.LevelsetGrid)
    f.initDomain(boundaryWidth=1, phiWalls=walls, open="xX", inflow="y",
                 outflow="Y")
    out["init"], out["walls"] = arr(f), arr(walls)
    f.fillGrid()
    out["fill"] = arr(f)
    f.updateFromLevelset(g["phi"])
    out["from_ls"] = arr(f)
    out["counts"] = [f.countCells(m.FlagFluid), f.countCells(m.FlagEmpty, 2),
                     f.countCells(m.FlagObstacle)]
    m.setOpenBound(f, 1, "yY", m.FlagOutflow | m.FlagEmpty)
    out["open"] = arr(f)
    out["consts"] = [m.FlagFluid, m.FlagObstacle, m.FlagEmpty, m.FlagInflow,
                     m.FlagOutflow, m.FlagOpen, m.FlagStick, m.FlagSurface,
                     m.PcNone, m.PcMIC, m.PcMGDynamic, m.PcMGStatic,
                     m.IntEuler, m.IntRK2, m.IntRK4, m.GUI,
                     m.DOUBLEPRECISION, m.PtypeSpray, m.PtypeBubble,
                     m.PtypeFoam, m.PtypeTracer]
    return out


@case(tol=2e-6)
def shapes(m):
    g = base(m)
    s, out = g["s"], {}
    n = g["n"]
    shapes_ = {"box": m.Box(s, p0=m.vec3(3, 4, 5), p1=m.vec3(11, 9, 12)),
               "box_c": s.create(m.Box, center=m.vec3(8, 8, 8),
                                 size=m.vec3(4, 6, 2)),
               "sphere": m.Sphere(parent=s, center=m.vec3(7, 8, 9),
                                  radius=4.5, scale=m.vec3(1, 1.5, 1)),
               "cyl": m.Cylinder(s, center=m.vec3(8, 8, 8), radius=3,
                                 z=m.vec3(0, 0, 5)),
               "slope": m.Slope(s, anglexy=20.0, angleyz=10.0, origin=4.0,
                                gs=m.vec3(n, n, n)),
               "null": m.NullShape(s)}
    for k, sh in shapes_.items():
        if k != "null":
            out[f"{k}_ls"] = arr(sh.computeLevelset())
        r = s.create(m.RealGrid)
        sh.applyToGrid(grid=r, value=2.5)
        out[f"{k}_grid"] = arr(r)
        f = s.create(m.FlagGrid)
        f.copyFrom(g["flags"])
        sh.applyToGrid(grid=f, value=m.FlagObstacle,
                       respectFlags=g["flags"])
        out[f"{k}_flags"] = arr(f)
    v = s.create(m.MACGrid)
    shapes_["box"].applyToGrid(grid=v, value=m.vec3(0.1, 0.2, 0.3))
    out["box_mac"] = arr(v)
    r = s.create(m.RealGrid)
    shapes_["sphere"].applyToGridSmooth(grid=r, sigma=1.5, shift=0.5,
                                        value=2.0)
    out["sphere_smooth"] = arr(r)
    return out


@case()
def solver_stepping(m):
    s = solver_of(m)(name="s", gridSize=(8, 8, 8), dim=3)
    s.frameLength, s.cfl = 1.2, 3.0
    s.timestep, s.timestepMin, s.timestepMax = 1.1, 0.2, 2.0
    seq = []
    for v in (0.0, 0.5, 2.0, 0.1, 8.0, 0.3, 0.0, 1.5, 0.9, 0.05):
        s.adaptTimestep(v)
        seq.append((s.timestep, s.timeTotal, s.frame))
        s.step()
    s.step(frame=7)
    seq.append((s.timestep, s.timeTotal, s.frame))
    s.printMemInfo()
    s2 = solver_of(m)(name="t", gridSize=m.vec3(8, 6, 4), dim=2,
                      fourthDim=5)
    return {"seq": seq, "2d": [s2.is2D(), s2.domain.shape, s2.fourthDim]}


@case(tol=2e-4)
def pressure_solves(m):
    g = base(m)
    s, out = g["s"], {}
    # tight accuracies: both packages solve by plain CG, but their dots sum
    # in another order (XLA's reductions, the CG kernel's plain version),
    # so loose solves exit at other iterates
    for k, kw in (("plain", {"cgAccuracy": 1e-5}),
                  ("phi", {"phi": g["phi"], "cgAccuracy": 1e-5}),
                  ("pcnone", {"preconditioner": m.PcNone,
                              "cgAccuracy": 1e-5}),
                  ("noprecond", {"precondition": False,
                                 "cgAccuracy": 1e-5})):
        v = s.create(m.MACGrid)
        v.copyFrom(g["vel"])
        p = s.create(m.RealGrid)
        rhs = s.create(m.RealGrid)
        m.solvePressure(flags=g["flags"], vel=v, pressure=p, retRhs=rhs,
                        **kw)
        out[f"{k}_vel"], out[f"{k}_p"], out[f"{k}_rhs"] = (arr(v), arr(p),
                                                          arr(rhs))
    # the obstacle's fractions and the second-order wall BCs
    phi_obs = s.create(m.LevelsetGrid)
    phi_obs.from_numpy(-g["phi_np"] - 2.0)
    fr = s.create(m.MACGrid)
    f = s.create(m.FlagGrid)
    f.initDomain(boundaryWidth=1)
    f.fillGrid()
    m.updateFractions(flags=f, phiObs=phi_obs, fractions=fr,
                      boundaryWidth=1)
    m.setObstacleFlags(flags=f, phiObs=phi_obs, fractions=fr)
    out["fractions"], out["obs_flags"] = arr(fr), arr(f)
    v = s.create(m.MACGrid)
    v.copyFrom(g["vel"])
    m.setWallBcs(flags=f, vel=v, fractions=fr, phiObs=phi_obs)
    out["wallbcs_frac"] = arr(v)
    m.solvePressure(flags=f, vel=v, pressure=g["pressure"], fractions=fr,
                    cgAccuracy=1e-5)
    out["frac_vel"], out["frac_p"] = arr(v), arr(g["pressure"])
    # the split solve (zflip's Correct19 path)
    rhs, p2 = s.create(m.RealGrid), s.create(m.RealGrid)
    m.computePressureRhs(rhs=rhs, vel=g["vel"], pressure=p2,
                         flags=g["flags"])
    out["rhs"] = arr(rhs)
    m.solvePressureSystem(rhs=rhs, vel=g["vel"], pressure=p2,
                          flags=g["flags"], cgAccuracy=1e-5)
    out["p_system"] = arr(p2)
    v.copyFrom(g["vel"])
    m.correctVelocity(vel=v, pressure=p2, flags=g["flags"])
    out["corrected"] = arr(v)
    d = s.create(m.MACGrid)
    d.copyFrom(g["vel"])
    m.cgSolveDiffusion(g["flags"], d, alpha=0.3)
    out["diffusion"] = arr(d)
    return out


@case()
def forces(m):
    g = base(m)
    s, f, out = g["s"], g["flags"], {}
    s.timestep = 0.7

    def fresh():
        v = s.create(m.MACGrid)
        v.copyFrom(g["vel"])
        return v
    v = fresh()
    m.setWallBcs(flags=f, vel=v)
    out["wall"] = arr(v)
    ob = s.create(m.MACGrid)
    ob.setConst(m.vec3(0.1, 0.2, 0.3))
    v = fresh()
    m.setWallBcs(flags=f, vel=v, obvel=ob)
    out["wall_ob"] = arr(v)
    v = fresh()
    m.addGravity(flags=f, vel=v, gravity=(0, -0.01, 0))
    m.addGravityNoScale(flags=f, vel=v, gravity=m.vec3(0.01, 0, 0))
    m.addGravity(flags=f, vel=v, gravity=(0, 0, 0.02), exclude=g["phi"])
    out["gravity"] = arr(v)
    v = fresh()
    m.addBuoyancy(flags=f, density=g["dens"], vel=v,
                  gravity=m.vec3(0, -6e-4, 0), coefficient=1.3)
    out["buoyancy"] = arr(v)
    v = fresh()
    m.vorticityConfinement(vel=v, flags=f, strength=0.2)
    m.vorticityConfinement(vel=v, flags=f, strength=0.1,
                           strengthCell=g["dens"])
    out["vc"] = arr(v)
    v = fresh()
    m.addForceField(flags=f, vel=v, force=g["v3"])
    m.addForceField(flags=f, vel=v, force=g["v3"], region=g["dens"],
                    isMAC=True)
    out["add_ff"] = arr(v)
    v = fresh()
    m.setForceField(flags=f, vel=v, force=g["v3"], isMAC=True)
    out["set_ff"] = arr(v)
    v = fresh()
    m.setInitialVelocity(flags=f, vel=v, invel=g["v3"])
    out["init_vel"] = arr(v)
    v = fresh()
    m.setInflowBcs(vel=v, dir="xX", value=m.vec3(0.5, 0, 0))
    out["inflow"] = arr(v)
    fo = s.create(m.FlagGrid)
    fo.copyFrom(f)
    m.setOpenBound(fo, 1, "yY", m.FlagOutflow | m.FlagEmpty)
    d, h = s.create(m.RealGrid), s.create(m.RealGrid)
    d.copyFrom(g["dens"])
    h.copyFrom(g["real"])
    p = s.create(m.LevelsetGrid)
    p.copyFrom(g["phi"])
    m.resetOutflow(flags=fo, phi=p, real=d)
    out["reset"] = [arr(fo), arr(p), arr(d)]
    m.dissolveSmoke(flags=f, density=d, heat=h, speed=4)
    m.dissolveSmoke(flags=f, density=d, logFalloff=False)
    out["dissolve"] = [arr(d), arr(h)]
    return out


@case()
def init_plugins(m):
    g = base(m)
    s, f, out = g["s"], g["flags"], {}
    d = s.create(m.RealGrid)
    d.copyFrom(g["dens"])
    src = s.create(m.RealGrid)
    src.from_numpy(g["rng"].uniform(0, 2, g["shape"]).astype(F32))
    m.applyEmission(flags=f, target=d, source=src)
    m.applyEmission(flags=f, target=d, source=src, emissionTexture=g["dens"],
                    isAbsolute=False)
    out["emission"] = arr(d)
    b = s.create(m.RealGrid)
    m.blurRealGrid(g["real"], b, sigma=1.2)
    out["blur"] = arr(b)
    bm = s.create(m.MACGrid)
    m.blurMacGrid(g["vel"], bm, sigma=0.8)
    out["blur_mac"] = arr(bm)
    a, err = s.create(m.RealGrid), s.create(m.RealGrid)
    a.copyFrom(g["real"])
    m.checkSymmetry(a, err, symmetrize=True, axis=1, bound=1)
    out["sym"] = [arr(a), arr(err)]
    v, ev = s.create(m.Vec3Grid), s.create(m.RealGrid)
    v.copyFrom(g["v3"])
    m.checkSymmetryVec3(v, ev, symmetrize=True, axis=0)
    out["symv"] = [arr(v), arr(ev)]
    t = s.create(m.RealGrid)
    m.testInitGridWithPos(t)
    out["pos"] = arr(t)
    out["avg"] = [m.getGridAvg(g["real"]), m.getGridAvg(g["real"], f)]
    out["maxdiff"] = [m.gridMaxDiff(g["real"], g["dens"]),
                      m.gridMaxDiffInt(f, f),
                      m.gridMaxDiffVec3(g["v3"], g["vel"])]
    x, y, zz = (s.create(m.RealGrid) for _ in range(3))
    m.copyVec3ToReal(g["v3"], x, y, zz)
    w = s.create(m.Vec3Grid)
    m.copyRealToVec3(y, zz, x, w)
    out["copy3"] = arr(w)
    m.copyMacToVec3(g["vel"], w)
    m.getComponent(w, x, 1)
    m.setComponent(g["real"], w, 2)
    out["comp"] = [arr(x), arr(w)]
    ls = s.create(m.RealGrid)
    m.copyLevelsetToReal(g["phi"], ls)
    out["ls"] = arr(ls)
    noise = s.create(m.NoiseField, fixedSeed=13, loadFromFile=True)
    noise.posScale = m.vec3(20)
    noise.posOffset = 2.0
    noise.clamp, noise.clampNeg, noise.clampPos = True, 0.0, 1.0
    noise.valScale, noise.valOffset, noise.timeAnim = 1.1, 0.3, 0.2
    out["noise_attrs"] = [tuple(noise.posScale), tuple(noise.posOffset),
                          noise.valScale, noise.valOffset, noise.clamp,
                          noise.clampNeg, noise.clampPos, noise.timeAnim]
    s.timeTotal = 3.0
    box = m.Box(s, p0=m.vec3(4, 2, 4), p1=m.vec3(12, 6, 12))
    d2 = s.create(m.RealGrid)
    m.densityInflow(flags=f, density=d2, noise=noise, shape=box, scale=1.0,
                    sigma=0.5)
    out["inflow"] = arr(d2)
    m.addNoise(flags=f, density=d2, noise=noise, sdf=g["phi"], scale=0.5)
    m.addNoise(flags=f, density=d2, noise=noise)
    out["noise"] = arr(d2)
    return out


@case()
def grids_4d(m):
    s = solver_of(m)(name="s", gridSize=m.vec3(6, 5, 4), dim=3, fourthDim=3)
    rng = np.random.default_rng(4)
    out = {}
    r, r2 = s.create(m.Grid4Real), s.create(m.Grid4Real)
    r.from_numpy(rng.uniform(-1, 1, (3, 4, 5, 6)).astype(F32))
    r2.setConst(0.5)
    r2.addConst(0.25)
    r2.add(r)
    r2.multConst(2.0)
    r2.addScaled(r, 0.5)
    r2.sub(r)
    out["r2"] = arr(r2)
    out["maxabs"] = r2.getMaxAbs()
    r2.setBound(9.0, 0)
    out["bound"] = arr(r2)
    r2.copyFrom(r)
    r2.setBoundNeumann(0)
    out["neumann"] = r2.to_numpy()
    out["interp"] = r.getInterpolated(m.Vec4(2.2, 1.7, 1.4, 1.1))
    v4, v3 = s.create(m.Grid4Vec4), s.create(m.Grid4Vec3)
    v4.setConst(m.vec4(1, 2, 3, 4))
    v4.setBound((5, 6, 7, 8), 0)
    v3.from_numpy(rng.uniform(-1, 1, (3, 3, 4, 5, 6)).astype(F32))
    out["v3interp"] = v3.getInterpolated((2.5, 2.5, 1.5, 1.5))
    m.setRegion4d(r2, (1, 1, 1, 0), (3, 3, 2, 1), -2.0)
    m.setRegion4dVec4(v4, (0, 0, 0, 0), (2, 2, 2, 1), (0.1, 0.2, 0.3, 0.4))
    out["region"] = [arr(r2), arr(v4)]
    sl, sv = s.create(m.RealGrid), s.create(m.Vec3Grid)
    m.getSliceFrom4d(r, 1, sl)
    m.getSliceFrom4dVec(v4, 0, sv, sl)
    out["slice"] = [arr(sl), arr(sv)]
    m.setSliceTo4d(sl, r2, 2)
    c = s.create(m.Grid4Real)
    m.getComp4d(v4, c, 2)
    m.setComp4d(r, v4, 3)
    out["comp"] = [arr(r2), arr(c), arr(v4)]
    i4 = s.create(m.Grid4Int)
    i4.setConst(3)
    out["diffs"] = [m.grid4dMaxDiff(r, r2), m.grid4dMaxDiffInt(i4, i4),
                    m.grid4dMaxDiffVec3(v3, v3), m.grid4dMaxDiffVec4(v4, v4)]
    big = solver_of(m)(name="b", gridSize=m.vec3(8, 7, 6), dim=3,
                       fourthDim=5)
    t, tv = big.create(m.Grid4Real), big.create(m.Grid4Vec4)
    m.interpolateGrid4d(t, r)
    m.interpolateGrid4dVec(tv, v4, offset=(0.5, 0, 0, 0),
                           scale=(1, 1, 1, 1.5))
    out["interp4d"] = [arr(t), arr(tv)]
    return out


@case(tol=1e-5)  # index_add_ sums the particles in another order
def particles(m):
    g = liquid(m)
    s, f, pp, pv = g["s"], g["flags"], g["pp"], g["pv"]
    out = {"sampled": parts_out(pp), "pvel": arr(pv)[:pp.pySize()],
           "size": [pp.size(), pp.capacity]}
    # the particle levelsets on the sampled positions, equal in both
    # packages (a radius test turns an ulp of a position into a jump)
    idx = s.create(m.IntGrid)
    pis = s.create(m.ParticleIndexSystem)
    ls = s.create(m.LevelsetGrid)
    m.unionParticleLevelset(pp, pis, f, idx, ls, radiusFactor=1.2)
    out["union"] = arr(ls)
    m.averagedParticleLevelset(pp, pis, f, idx, ls, radiusFactor=1.5,
                               smoothen=2, smoothenNeg=1)
    out["averaged"] = arr(ls)
    m.resetPhiInObs(f, ls)
    out["reset_phi"] = arr(ls)
    s.timestep = 0.6
    for k, kw in (("rk4", {"integrationMode": m.IntRK4}),
                  ("euler", {"integrationMode": m.IntEuler,
                             "deleteInObstacle": False}),
                  ("rk2", {"integrationMode": m.IntRK2,
                           "stopInObstacle": False})):
        pp.advectInGrid(flags=f, vel=g["vel"], **kw)
        out[f"adv_{k}"] = parts_out(pp)
    pp.projectOutOfBnd(flags=f, bnd=2.0)
    out["oob"] = parts_out(pp)
    phi_obs = s.create(m.LevelsetGrid)
    phi_obs.from_numpy(g["phi_np"][:, ::-1, :].copy())
    m.pushOutofObs(parts=pp, flags=f, phiObs=phi_obs, shift=0.05)
    out["pushed"] = parts_out(pp)
    vel, old, w = (s.create(c) for c in (m.MACGrid, m.MACGrid, m.Vec3Grid))
    m.mapPartsToMAC(flags=f, vel=vel, velOld=old, parts=pp, partVel=pv,
                    weight=w)
    out["p2g"] = [arr(vel), arr(old), arr(w)]
    m.flipVelocityUpdate(flags=f, vel=g["vel"], velOld=old, parts=pp,
                         partVel=pv, flipRatio=0.95)
    out["flip"] = arr(pv)
    pd = pp.create(m.PdataReal)
    pd.setConst(0.5)
    pd.setConstRange(2.0, 3, 40)
    rg = s.create(m.RealGrid)
    m.mapPartsToGrid(flags=f, target=rg, parts=pp, source=pd)
    v3 = s.create(m.Vec3Grid)
    m.mapPartsToGridVec3(flags=f, target=v3, parts=pp, source=pv)
    out["p2grid"] = [arr(rg), arr(v3)]
    m.mapGridToParts(g["dens"], pp, pd)
    pv2 = pp.create(m.PdataVec3)
    m.mapGridToPartsVec3(g["v3"], pp, pv2)
    out["g2p"] = [arr(pd), arr(pv2)]
    pt = pp.create(m.PdataInt)
    fl2 = s.create(m.FlagGrid)
    fl2.copyFrom(f)
    m.markFluidCells(parts=pp, flags=fl2)
    out["marked"] = arr(fl2)
    m.markFluidCells(parts=pp, flags=fl2, phiObs=phi_obs)
    m.markIsolatedFluidCell(fl2, m.FlagEmpty)
    out["marked2"] = arr(fl2)
    m.setPartType(pp, pt, m.FlagFluid, 2, fl2, m.FlagFluid)
    out["ptype"] = arr(pt)
    cnt = s.create(m.IntGrid)
    m.gridParticleIndex(parts=pp, indexSys=pis, flags=f, index=idx,
                        counter=cnt)
    out["index"] = [arr(idx), arr(cnt), pis.size()]
    lap, curv = s.create(m.RealGrid), s.create(m.RealGrid)
    m.getLaplacian(lap, g["phi"])
    m.getCurvature(curv, g["phi"], 0.5)
    out["lap"] = [arr(lap), arr(curv)]
    m.addForcePvel(pv, (0, -0.1, 0.05), 0.5)
    xprev = pp.create(m.PdataVec3)
    pp.getPosPdata(xprev)
    m.eulerStep(pp, pv)
    m.updateVelocityFromDeltaPos(pp, pv, xprev, 0.5)
    out["euler"] = [parts_out(pp), arr(pv)]
    pp.setPosPdata(xprev)
    pp.multScalePos(1.0)
    out["setpos"] = parts_out(pp)
    return out


@case(tol=2.5e-3)
def improved_levelset(m):
    # the largest eigenvalue jumps where the cubic's discriminant changes
    # sign, so an ulp of the averaged positions moves a cell by up to a
    # radius (ROADMAP C, improved_particle_levelset on the card)
    g = liquid(m)
    pis = g["s"].create(m.ParticleIndexSystem)
    idx, ls = g["s"].create(m.IntGrid), g["s"].create(m.LevelsetGrid)
    m.improvedParticleLevelset(g["pp"], pis, g["flags"], idx, ls,
                               radiusFactor=1.5)
    return {"improved": arr(ls)}


@case()
def pdata_ops(m):
    g = liquid(m)
    pp, pv = g["pp"], g["pv"]
    a, b = pp.create(m.PdataReal), pp.create(m.PdataReal)
    n = pp.pySize()
    a.setConst(2.0)
    b.copyFrom(a)
    b.addConst(1.5)
    a.add(b)
    a.sub(b)
    a.mult(b)
    a.multConst(0.5)
    a.addScaled(b, 2.0)
    a.safeDiv(b)
    out = {"a": arr(a)[:n], "sum": a.sum(), "maxabs": a.getMaxAbs()}
    a.clamp(0.1, 1.2)
    a.clampMin(0.5)
    a.clampMax(1.0)
    out["clamped"] = arr(a)[:n]
    v = pp.create(m.PdataVec3)
    v.setConst(m.vec3(1, 2, 3))
    v.addConst(m.vec3(0.5, 0.5, 0.5))
    v.multConst(m.vec3(1, -1, 2))
    v.addScaled(pv, m.vec3(0.1, 0.2, 0.3))
    out["v"] = [arr(v)[:n], v.getMaxAbs(), v.to_numpy()[:n]]
    i = pp.create(m.PdataInt)
    i.setConst(4)
    i.setConstRange(7, 2, 9)
    i.addConst(1)
    out["i"] = arr(i)[:n]
    out["pos"] = pp.to_numpy()
    out["maxdiff"] = m.pdataMaxDiff(a, b)
    m.addTestParts(pp, 5)
    out["test_parts"] = parts_out(pp)
    arr_r = np.zeros(pp.pySize(), F32)
    m.copyPdataToArrayReal(a, arr_r)
    m.copyArrayToPdataReal(arr_r * 2, b)
    arr_v = np.zeros((pp.pySize(), 3), F32)
    m.copyPdataToArrayVec3(pv, arr_v)
    m.copyArrayToPdataVec3(arr_v + 1, v)
    arr_i = np.zeros(pp.pySize(), np.int32)
    m.copyPdataToArrayInt(i, arr_i)
    m.copyArrayToPdataInt(arr_i * 3, i)
    out["converted"] = [arr_r, arr(b), arr_v, arr(v), arr_i, arr(i)]
    pp.clear()
    pp.doCompress()
    out["cleared"] = pp.pySize()
    return out


@case()
def flip_resampling(m):
    g = liquid(m, disc=1)
    s, f, pp, pv = g["s"], g["flags"], g["pp"], g["pv"]
    pv.setSource(g["vel"], isMAC=True)
    phi_obs = s.create(m.LevelsetGrid)
    phi_obs.from_numpy(g["phi_np"][::-1].copy() + 3.0)
    m.adjustNumber(parts=pp, vel=g["vel"], flags=f, minParticles=2,
                   maxParticles=4, phi=g["phi"], narrowBand=3,
                   exclude=phi_obs)
    out = {"adjusted": parts_out(pp), "pv": arr(pv)}
    m.sampleFlagsWithParticles(flags=f, parts=pp, discretization=2,
                               randomness=0.2)
    out["flags_sampled"] = parts_out(pp)
    box = m.Box(s, p0=m.vec3(2, 10, 2), p1=m.vec3(6, 14, 6))
    m.sampleShapeWithParticles(shape=box, flags=f, parts=pp,
                               discretization=2, randomness=0.1)
    out["shape_sampled"] = parts_out(pp)
    m.sampleLevelsetWithParticles(phi=g["phi"], flags=f, parts=pp,
                                  discretization=2, randomness=0.1,
                                  reset=True, particleFlag=m.PtypeTracer)
    out["reset"] = parts_out(pp)
    fo = s.create(m.FlagGrid)
    fo.copyFrom(f)
    m.setOpenBound(fo, 1, "yY", m.FlagOutflow | m.FlagEmpty)
    m.resetOutflow(flags=fo, parts=pp)
    out["outflow_killed"] = parts_out(pp)
    v, w, cv = (s.create(c) for c in (m.MACGrid, m.Vec3Grid, m.MACGrid))
    v.copyFrom(g["vel"])
    w.from_numpy(np.abs(arr(g["v3"])))
    cv.copyFrom(g["vel"])
    cv.multConst(0.5)
    m.combineGridVel(vel=v, weight=w, combineVel=cv, phi=g["phi"],
                     narrowBand=2, thresh=0.2)
    out["combined"] = [arr(v), arr(cv)]
    return out


@case()
def extrapolation(m):
    g = base(m)
    s, f, out = g["s"], g["flags"], {}
    v = s.create(m.MACGrid)
    for k, kw in (("plain", {}), ("obs", {"intoObs": True, "distance": 3})):
        v.copyFrom(g["vel"])
        m.extrapolateMACSimple(flags=f, vel=v, **kw)
        out[f"mac_{k}"] = arr(v)
    phi_obs = s.create(m.LevelsetGrid)
    phi_obs.from_numpy(g["phi_np"][::-1].copy())
    v.copyFrom(g["vel"])
    m.extrapolateMACSimple(flags=f, vel=v, distance=2, phiObs=phi_obs)
    out["mac_phiobs"] = arr(v)
    w = s.create(m.Vec3Grid)
    w.from_numpy(np.where(np.abs(arr(g["v3"])) > 0.7, 1.0, 0.0).astype(F32))
    v.copyFrom(g["vel"])
    m.extrapolateMACFromWeight(vel=v, weight=w, distance=3)
    out["weight"] = [arr(v), arr(w)]
    p = s.create(m.LevelsetGrid)
    for k, kw in (("out", {}), ("in", {"inside": True, "distance": 5}),
                  ("walls", {"include_walls": True})):
        p.copyFrom(g["phi"])
        m.extrapolateLsSimple(phi=p, **kw)
        out[f"ls_{k}"] = arr(p)
    v3 = s.create(m.Vec3Grid)
    v3.copyFrom(g["v3"])
    m.extrapolateVec3Simple(vel=v3, phi=g["phi"], distance=3)
    out["vec3"] = arr(v3)
    return out


@case(tol=1e-5)
def whitewater(m):
    g = liquid(m)
    s, f = g["s"], g["flags"]
    ta, wc, ke, nr = (s.create(m.RealGrid) for _ in range(4))
    nrm = s.create(m.Vec3Grid)
    m.flipComputeSecondaryParticlePotentials(
        ta, wc, ke, nr, f, g["vel"], nrm, g["phi"], 2, 5, 20, 0.1, 1, 5, 40,
        1.0)
    out = {"pots": [arr(ta), arr(wc), arr(ke), arr(nr), arr(nrm)]}
    m.flipComputePotentialTrappedAir(ta, f, g["vel"], 2, 5, 20, 1.0)
    m.flipComputePotentialKineticEnergy(ke, f, g["vel"], 1, 5, 1.0)
    m.flipComputeSurfaceNormals(nrm, g["phi"])
    m.flipComputePotentialWaveCrest(wc, f, g["vel"], 2, nrm, 0.1, 1, 1.0)
    m.flipUpdateNeighborRatio(f, nr, 2)
    out["legacy"] = [arr(ta), arr(ke), arr(nrm), arr(wc), arr(nr)]
    sec = s.create(m.BasicParticleSystem)
    vs, ls, fs = (sec.create(c) for c in (m.PdataVec3, m.PdataReal,
                                          m.PdataVec3))
    s.timestep = 0.5
    m.flipSampleSecondaryParticles("single", f, g["vel"], sec, vs, ls, 1.0,
                                   2.0, ta, wc, ke, nr, 0.4, 0.6, 40, 40)
    out["sampled"] = [parts_out(sec), arr(vs)[:sec.pySize()]]
    m.flipUpdateSecondaryParticles("linear", sec, vs, ls, fs, f, g["vel"],
                                   nr, 2, (0, -0.003, 0), 0.5, 0.2, 0.4,
                                   0.6)
    out["updated"] = [parts_out(sec), arr(ls)[:sec.pySize()]]
    m.flipDeleteParticlesInObstacle(sec, f)
    out["deleted"] = parts_out(sec)
    f2 = s.create(m.FlagGrid)
    f2.copyFrom(f)
    m.setFlagsFromLevelset(f2, g["phi"])
    v = s.create(m.MACGrid)
    v.copyFrom(g["vel"])
    m.setMACFromLevelset(v, g["phi"], (0.1, 0.2, 0.3))
    m.debugGridInfo(f, g["real"], "real")
    out["misc"] = [arr(f2), arr(v)]
    return out


@case(tol=1e-5)
def surface_turbulence(m):
    g = liquid(m)
    s, f, pp = g["s"], g["flags"], g["pp"]
    prev = pp.create(m.PdataVec3)
    pp.getPosPdata(prev)
    s.timestep = 0.5
    pp.advectInGrid(flags=f, vel=g["vel"], integrationMode=m.IntRK2)
    surf, disp = (s.create(m.BasicParticleSystem) for _ in range(2))
    nrm = surf.create(m.PdataVec3)
    h, dth, src, seed, amp = (surf.create(m.PdataReal) for _ in range(5))
    m.particleSurfaceTurbulence(f, pp, prev, surf, nrm, h, dth, disp, src,
                                seed, amp, 16, surfaceDensity=8,
                                nbSurfaceMaintenanceIterations=2)
    n = surf.pySize()
    return {"surf": parts_out(surf), "disp": parts_out(disp),
            "fields": [arr(x)[:n] for x in (nrm, h, dth, src, seed, amp)],
            "prev": arr(prev)}


@case()
def apic(m):
    g = liquid(m)
    pp, pv = g["pp"], g["pv"]
    cx, cy, cz = (pp.create(m.PdataVec3) for _ in range(3))
    mass = g["s"].create(m.MACGrid)
    v = g["s"].create(m.MACGrid)
    m.apicMapMACGridToParts(pv, cx, cy, cz, pp, g["vel"], g["flags"])
    m.apicMapPartsToMAC(g["flags"], v, pp, pv, cx, cy, cz, mass=mass)
    return {"g2p": [arr(pv), arr(cx), arr(cy), arr(cz)],
            "p2g": [arr(v), arr(mass)]}


@case()
def turbulence_and_waves(m):
    g = base(m)
    s, f, out = g["s"], g["flags"], {}
    xl = solver_of(m)(name="xl", gridSize=m.vec3(24, 24, 24), dim=3)
    tr, tv, tm = (xl.create(c) for c in (m.RealGrid, m.Vec3Grid,
                                         m.MACGrid))
    m.interpolateGrid(tr, g["dens"])
    m.interpolateGridVec3(tv, g["v3"], orderSpace=2)
    m.interpolateMACGrid(tm, g["vel"])
    out["interp"] = [arr(tr), arr(tv), arr(tm)]
    noise = s.create(m.NoiseField, loadFromFile=True)
    s.timeTotal = 2.0
    v3 = s.create(m.Vec3Grid)
    v3.copyFrom(g["v3"])
    m.applySimpleNoiseVec3(f, v3, noise, scale=0.5)
    r = s.create(m.RealGrid)
    m.applySimpleNoiseReal(f, r, noise, scale=0.5, weight=g["dens"])
    uv = s.create(m.Vec3Grid)
    m.resetUvGrid(uv)
    m.applyNoiseVec3(f, v3, noise, scale=0.3, weight=g["dens"], uv=uv)
    out["noise"] = [arr(v3), arr(r)]
    e, vort, nrm, mag, cu = (s.create(c) for c in (
        m.RealGrid, m.Vec3Grid, m.RealGrid, m.RealGrid, m.RealGrid))
    m.computeEnergy(f, g["vel"], e)
    m.computeVorticity(g["vel"], vort, nrm)
    m.computeStrainRateMag(g["vel"], mag)
    m.getCurl(g["vel"], cu, 1)
    w = s.create(m.RealGrid)
    w.copyFrom(e)
    m.computeWaveletCoeffs(w)
    out["fields"] = [arr(e), arr(vort), arr(nrm), arr(mag), arr(cu), arr(w)]
    s.timestep = 0.5
    m.resetUvGrid(uv, offset=(1, 2, 3))
    m.updateUvWeight(resetTime=4.0, index=0, numUvs=2, uv=uv)
    out["uv"] = [arr(uv), m.getUvWeight(uv)]
    ex = s.create(m.RealGrid)
    ex.copyFrom(g["dens"])
    m.extrapolateSimpleFlags(f, ex, 2, m.FlagFluid, m.FlagEmpty)
    out["extrap_flags"] = arr(ex)
    # fire
    fuel, dens, react, heat, red, flame = (s.create(m.RealGrid)
                                           for _ in range(6))
    for gr, k in ((fuel, "dens"), (dens, "real"), (react, "dens"),
                  (heat, "real"), (red, "dens")):
        gr.copyFrom(g[k])
    m.processBurn(fuel, dens, react, red=red, heat=heat, burningRate=0.6)
    m.updateFlame(react, flame)
    out["fire"] = [arr(fuel), arr(dens), arr(react), arr(heat), arr(red),
                   arr(flame)]
    # k-epsilon
    k, eps, prod, nut, strain = (s.create(m.RealGrid) for _ in range(5))
    m.KEpsilonBcs(f, k, eps, 0.1, 0.1, True)
    m.KEpsilonComputeProduction(g["vel"], k, eps, prod, nut, strain,
                                pscale=2.0)
    m.KEpsilonSources(k, eps, prod)
    v = s.create(m.MACGrid)
    v.copyFrom(g["vel"])
    m.KEpsilonGradientDiffusion(k, eps, nut, sigmaU=8.0, vel=v)
    out["keps"] = [arr(k), arr(eps), arr(prod), arr(nut), arr(strain),
                   arr(v)]
    return out


@case(tol=2e-4)
def waves_2d(m):
    g = base(m, n=24, dim=2)
    s, f = g["s"], g["flags"]
    f.fillGrid()
    s.timestep = 0.5
    ut, utm1, o, c = (s.create(m.RealGrid) for _ in range(4))
    ut.copyFrom(g["dens"])
    utm1.copyFrom(g["dens"])
    utm1.multConst(0.9)
    m.calcSecDeriv2d(ut, c)
    tot = m.totalSum(ut)
    m.normalizeSumTo(ut, 10.0)
    m.cgSolveWE(f, ut, utm1, o, cSqr=0.3)
    m.cgSolveWE(f, ut, utm1, o, crankNic=True)
    return {"curv": arr(c), "sum": tot, "ut": arr(ut), "utm1": arr(utm1),
            "out": arr(o)}


@case(tol=2e-4)
def guiding_and_idp(m):
    g = base(m, n=24, dim=2)
    s, f = g["s"], g["flags"]
    f.fillGrid()
    vt, v = s.create(m.MACGrid), s.create(m.MACGrid)
    m.getSpiralVelocity(f, vt, strength=0.5)
    w = s.create(m.RealGrid)
    m.setGradientYWeight(w, 2, 20, 0.5, 2.0)
    v.copyFrom(vt)
    v.multConst(m.vec3(0.5, 0.5, 0))
    p = s.create(m.RealGrid)
    m.PD_fluid_guiding(vel=v, velT=vt, pressure=p, flags=f, weight=w,
                       blurRadius=2, maxIters=3, preconditioner=m.PcMGStatic)
    m.releaseBlurPrecomp()
    m.releaseMG(s)
    out = {"spiral": arr(vt), "weight": arr(w), "guided": [arr(v), arr(p)]}
    h = liquid(m, n=16, dim=3, disc=2)
    s3, f3, pp = h["s"], h["flags"], h["pp"]
    phi_obs = s3.create(m.LevelsetGrid)
    phi_obs.setConst(5.0)
    fl2 = s3.create(m.FlagGrid)
    dx, rho, lam = s3.create(m.MACGrid), s3.create(m.RealGrid), \
        s3.create(m.RealGrid)
    m.copyFlagsToFlags(f3, fl2)
    m.markFluidAndBoundaryCells(pp, fl2, dx, phi_obs)
    out["marked"] = [arr(fl2), arr(dx)]
    m.mapMassToGrid(fl2, rho, pp, None, dx, phi_obs, 0.5, 0.125)
    out["mass"] = [arr(fl2), arr(rho), arr(dx)]
    m.solvePressureSystem(rhs=rho, vel=h["vel"], pressure=lam, flags=fl2,
                          cgAccuracy=1e-4)
    m.computeDeltaX(dx, lam, fl2)
    m.mapMACToPartPositions(fl2, dx, pp, 0.5)
    out["idp"] = [arr(lam), arr(dx), parts_out(pp)]
    m.resampeOverfullCells(h["vel"], rho, None, None, pp, h["pv"], 0.5)
    out["resampled"] = [parts_out(pp), arr(h["pv"]), arr(rho)]
    return out


@case(tol=2e-6)
def obstacles_and_misc(m):
    g = base(m)
    s, f, out = g["s"], g["flags"], {}
    phi_obs = s.create(m.LevelsetGrid)
    phi_obs.from_numpy(g["phi_np"] + 1.0)
    v = s.create(m.MACGrid)
    m.initVortexVelocity(phi_obs, v, m.vec3(8, 6, 8), 4.0)
    out["vortex"] = arr(v)
    v.copyFrom(g["vel"])
    ob = s.create(m.MACGrid)
    ob.setConst(m.vec3(0.3, 0.2, 0.1))
    fo = s.create(m.FlagGrid)
    fo.copyFrom(f)
    Sphere = m.Sphere(s, center=m.vec3(4, 4, 4), radius=2)
    Sphere.applyToGrid(grid=fo, value=m.FlagObstacle)
    m.set_wall_bcs2(fo, v, ob)
    out["wall2"] = arr(v)
    t = s.create(m.MACGrid)
    m.copyMACData(g["vel"], t, f, m.FlagFluid, 1)
    out["copymac"] = arr(t)
    f2 = s.create(m.FlagGrid)
    f2.copyFrom(fo)
    m.markSurfaceCells(f2)
    out["surface"] = arr(f2)
    m.clearObstacle(f2)
    m.clearObstacle(fo, include_boundary=True)
    out["cleared"] = [arr(f2), arr(fo)]
    v.copyFrom(g["vel"])
    m.clampNorm(v, 0.4)
    out["clampnorm"] = arr(v)
    r3 = s.create(m.Vec3Grid)
    m.resampleMacToVec3(g["vel"], r3)
    m.resampleVec3ToMac(g["v3"], t)
    sw = s.create(m.Vec3Grid)
    sw.copyFrom(g["v3"])
    m.swapComponents(sw, 2, 0, 1)
    out["resample"] = [arr(r3), arr(t), arr(sw)]
    st, st3 = s.create(m.RealGrid), s.create(m.Vec3Grid)
    st.copyFrom(g["real"])
    m.stompGrid(st, 0.2)
    st3.copyFrom(g["v3"])
    m.stompGrid(st3, (0.1, 0.0, -0.1))
    pa = s.create(m.RealGrid)
    pa.copyFrom(g["real"])
    m.permuteAxes(pa, 2, 0, 1)
    out["stomp"] = [arr(st), arr(st3), arr(pa)]
    d, h = s.create(m.RealGrid), s.create(m.RealGrid)
    d.copyFrom(g["dens"])
    h.copyFrom(g["real"])
    v.copyFrom(g["vel"])
    m.resetInObstacle(fo, v, density=d, heat=h, resetValue=0.5)
    out["reset_obs"] = [arr(v), arr(d), arr(h)]
    out["com"] = tuple(m.calcCenterOfMass(g["dens"]))
    out["obs_ls"] = arr(m.obstacleLevelset(fo))
    out["obs_grad"] = arr(m.obstacleGradient(fo))
    a = np.zeros(g["shape"], F32)
    m.copyGridToArrayReal(g["real"], a)
    r = s.create(m.RealGrid)
    m.copyArrayToGridReal(a * 2, r)
    ai = np.zeros(g["shape"], np.int32)
    m.copyGridToArrayInt(f, ai)
    m.copyGridToArrayFlag(f, ai)
    fi = s.create(m.FlagGrid)
    m.copyArrayToGridFlag(ai, fi)
    ii = s.create(m.IntGrid)
    m.copyArrayToGridInt(ai + 1, ii)
    al = np.zeros(g["shape"], F32)
    m.copyGridToArrayLevelset(g["phi"], al)
    li = s.create(m.LevelsetGrid)
    m.copyArrayToGridLevelset(al - 1, li)
    av = np.zeros(g["shape"] + (3,), F32)
    m.copyGridToArrayVec3(g["v3"], av)
    m.copyGridToArrayMAC(g["vel"], av)
    vv, vm = s.create(m.Vec3Grid), s.create(m.MACGrid)
    m.copyArrayToGridVec3(av, vv)
    m.copyArrayToGridMAC(av * 2, vm)
    out["numpy"] = [a, arr(r), ai, arr(fi), arr(ii), al, arr(li), av,
                    arr(vv), arr(vm)]
    mo = m.MovingObstacle(s)
    mo.add(m.Box(s, p0=m.vec3(2, 2, 2), p1=m.vec3(5, 6, 5)))
    fm, vmo = s.create(m.FlagGrid), s.create(m.MACGrid)
    fm.copyFrom(f)
    s.timestep = 0.5
    mo.moveLinear(2.0, 0.0, 10.0, m.vec3(3, 3, 3), m.vec3(10, 3, 3), fm,
                  vmo)
    out["moving"] = [arr(fm), arr(vmo)]
    m.printGrid(g["real"], 3)
    m.printGrid(g["v3"])
    m.mantaMsg("scene api parity", 3)
    m.printBuildInfo()
    m.assertNumpy()
    gui = m.Gui()
    gui.show()
    for fn in ("pause", "update", "nextRealGrid", "nextVec3Grid",
               "nextParts", "nextPdata", "nextMesh", "toggleHideGrids"):
        getattr(gui, fn)()
    gui.setCamPos(0, 0, 1)
    gui.setCamRot(0, 1, 0)
    gui.windowSize(64, 64)
    gui.screenshot("unused.ppm")
    return out


@case(tol=2e-6)
def meshes(m, tmp_path):
    g = base(m)
    s, out = g["s"], {}
    mesh = s.create(m.Mesh)
    g["phi"].createMesh(mesh)
    out["mc"] = [mesh.nodes, mesh.tris, mesh.numNodes(), mesh.numTris()]
    m.smoothMesh(mesh, strength=0.5, steps=2)
    out["smooth"] = np.asarray(mesh.nodes)
    m.subdivideMesh(mesh, minLength=0.3, maxLength=1.2)
    out["subdiv"] = [np.asarray(mesh.nodes), np.asarray(mesh.tris)]
    m.killSmallComponents(mesh, 20)
    out["kill"] = mesh.numTris()
    ls = s.create(m.LevelsetGrid)
    mesh.computeLevelset(ls, sigma=2.0, cutoff=4.0)
    out["mesh_ls"] = arr(ls)
    out["getls"] = arr(mesh.getLevelset())
    r = s.create(m.RealGrid)
    mesh.applyMeshToGrid(r, value=3.0)
    out["applied"] = arr(r)
    d = s.create(m.RealGrid)
    m.densityInflowMesh(g["flags"], d, mesh, value=2.0, cutoff=5)
    noise = s.create(m.NoiseField, loadFromFile=True)
    m.densityInflowMeshNoise(g["flags"], d, noise, mesh, sigma=0.5)
    out["inflow_mesh"] = arr(d)
    old = s.create(m.Mesh)
    old.nodes, old.tris = mesh.nodes.copy(), mesh.tris.copy()
    s.timestep = 0.5
    mesh.advectInGrid(g["flags"], g["vel"], integrationMode=m.IntRK2)
    v = s.create(m.MACGrid)
    mesh.computeVelocity(old, v)
    out["advected"] = [np.asarray(mesh.nodes), arr(v)]
    mesh.scale(m.vec3(1.1, 1.0, 0.9))
    mesh.offset(m.vec3(0.5, 0.0, -0.5))
    mesh.rotate(m.vec3(0.1, 0.2, 0.3))
    mesh.save_pos()
    mesh.load_pos()
    out["moved"] = np.asarray(mesh.nodes)
    sph = m.Sphere(s, center=m.vec3(8, 8, 8), radius=3)
    sph.collideMesh(mesh)
    out["collided"] = [np.asarray(mesh.nodes), mesh.node_flags]
    fs = s.create(m.Mesh)
    fs.fromShape(sph)
    out["from_shape"] = [fs.nodes, fs.tris]
    for ext in ("obj", "bobj.gz"):
        p = str(tmp_path / f"mesh_{'jax' if m is J else 'port'}.{ext}")
        mesh.save(p)
        back = s.create(m.Mesh)
        back.load(p)
        back.load(p, append=True)
        out[f"io_{ext}"] = [back.nodes, back.tris]
    mesh.clear()
    out["cleared"] = mesh.numNodes()
    return out


@case(tol=1e-5)
def vortex_systems(m):
    g = base(m)
    s, out = g["s"], {}
    s.timestep = 0.5
    vp = s.create(m.VortexParticleSystem)
    vp.add(m.vec3(8, 8, 8), m.vec3(0, 0, 1), 2.0)
    vp.add(m.vec3(6, 9, 8), m.vec3(0.5, 0, 0), 1.5)
    box = m.Box(s, p0=m.vec3(4, 4, 4), p1=m.vec3(12, 12, 12))
    m.VPseedK41(vp, box, strength=0.3, probability=0.5)
    vp.advectSelf(scale=1.0)
    out["vp"] = [vp.pos, vp.vorticity, vp.sigma, vp.size(), vp.pySize()]
    sheet = s.create(m.VortexSheetMesh)
    g["phi"].createMesh(sheet)
    vp.applyToMesh(sheet)
    out["sheet_nodes"] = np.asarray(sheet.nodes)
    m.markAsFixed(sheet, m.Box(s, p0=m.vec3(0, 0, 0), p1=m.vec3(16, 6, 16)))
    old = s.create(m.MACGrid)
    old.copyFrom(g["vel"])
    old.multConst(0.9)
    m.vorticitySource(sheet, (0, -0.01, 0), vel=g["vel"], velOld=old,
                      maxAmount=0.5)
    m.vorticitySource(sheet, (0, -0.01, 0), scale=0.2)
    sheet.calcCirculation()
    sheet.calcVorticity()
    m.smoothVorticity(sheet, iter=2)
    m.texcoordInflow(sheet, box, g["vel"])
    m.meshSmokeInflow(sheet, box, 0.7)
    sheet.setReferenceTexOffset(m.vec3(1, 2, 3))
    sheet.reinitTexCoords()
    out["sheet"] = [sheet.tri_vorticity, sheet.tri_vorticity_smoothed,
                    sheet.tri_circulation, sheet.tri_smoke, sheet.node_fixed,
                    sheet.tex1, sheet.tex2]
    vel = s.create(m.Vec3Grid)
    vort = s.create(m.Vec3Grid)
    m.VICintegration(sheet, 1.5, vel, g["flags"], vorticity=vort)
    out["vic"] = [arr(vel), arr(vort)]
    d = s.create(m.RealGrid)
    m.densityFromLevelset(g["phi"], d, value=2.0, sigma=1.5)
    out["dens"] = arr(d)
    return out


@case(tol=1e-5)
def turbulence_particles(m):
    from importlib import import_module
    g = base(m)
    s, f = g["s"], g["flags"]
    import_module(m.__name__ + ".scene.vortex_api").reset_process_statics()
    noise = s.create(m.NoiseField)
    tp = s.create(m.TurbulenceParticleSystem, noise=noise)
    box = m.Box(s, p0=m.vec3(3, 6, 3), p1=m.vec3(6, 10, 7))
    k = s.create(m.RealGrid)
    k.copyFrom(g["dens"])
    s.timestep = 0.5
    out = {}
    for i in range(3):
        tp.seed(box, 30)
        tp.advectInGrid(f, g["vel"], integrationMode=m.IntRK4)
        tp.synthesize(f, k, octaves=1, switchLength=1.5, L0=0.05,
                      scale=0.1, inflowBias=(0.5, 0, 0))
        tp.deleteInObstacle(f)
        out[f"s{i}"] = [arr(tp.pos), arr(tp.tex0), arr(tp.tex1), tp.color,
                        tp.size(), tp.pySize()]
    tp.synthesizeTurbulence(f, k, 2, alpha=0.4, kmin=0.01)
    tp.resetTexCoords(1, (1.0, 0, 0))
    out["legacy"] = [arr(tp.pos), arr(tp.tex1)]
    return out


@case(tol=2e-4)
def zflip(m):
    g = liquid(m)
    s, f, pp, pv = g["s"], g["flags"], g["pp"], g["pv"]
    s.timestep = 0.5
    pis = s.create(m.ParticleIndexSystem)
    gpi = s.create(m.IntGrid)
    phi_obs = s.create(m.LevelsetGrid)
    phi_obs.setConst(5.0)
    c19 = m.Correct19(3, s, 2, pp)
    c19.main(s, f, pp, g["vel"], pis, gpi, phi_obs)
    out = {"c19": [parts_out(pp), arr(c19.density), arr(c19.Lambda),
                   arr(c19.deltaX)]}
    m.set_particles_pos0(pp)
    m.limit_particle_velocity(pv, 0.3)
    pp.advectInGrid(flags=f, vel=g["vel"], integrationMode=m.IntEuler)
    out["limit"] = [arr(pv), m.limit_time_step_to_one_cell_movement(pp, 0.5)]
    phi = s.create(m.LevelsetGrid)
    phi.copyFrom(g["phi"])
    res = m.fixed_volume_advection(pp, pv, f, 0.5, 3, 4, phi)
    out["fva"] = [parts_out(pp), arr(f), arr(phi), res[0], res[1], res[4],
                  res[5]]
    f2 = s.create(m.FlagGrid)
    f2.copyFrom(f)
    m.update_fluid_from_phi(f2, g["phi"])
    out["fluid_from_phi"] = arr(f2)
    m.tic()
    out["toc"] = m.toc() >= 0.0
    m.emphasize("zflip parity")
    m.warn("zflip parity")
    return out


@case()
def timings(m, tmp_path):
    from importlib import import_module
    tapi = import_module(m.__name__ + ".scene.timing_api")
    t = m.Timings()
    t.clear()
    t.add("op", 0.002)
    t.add("op", 0.004)
    t.display()
    out = {"acc": dict(tapi._ACC)}
    t.clear()
    g = base(m, n=8)
    m.enableTimings()
    try:
        avg = [m.getGridAvg(g["real"]), m.getGridAvg(g["dens"], notiming=True)]
    finally:
        tapi._ENABLED[0] = False  # the wrappers pass calls through again
    t.saveMean(str(tmp_path / f"{m.__name__}.txt"))
    out["timed"] = [avg, sorted((k, n) for k, (_, n) in tapi._ACC.items())]
    t.clear()
    return out


@case()
def base_classes(m):
    s = (m.FluidSolver if m is J else
         lambda **kw: m.FluidSolver(device="cpu", **kw))(
        name="f", gridSize=m.vec3i(6, 5, 4), dim=3, fourthDim=2)
    pp = s.create(m.BasicParticleSystem)
    return {"vec3i": [m.vec3i(3), m.vec3i(1, 2, 3)],
            "bases": [isinstance(s.create(m.RealGrid), m.GridBase),
                      isinstance(s.create(m.Grid4Real), m.Grid4Base),
                      isinstance(pp.create(m.PdataReal), m.PdataBase),
                      isinstance(s, m.Solver)]}


# ---------------------------------------------------------------------------


def compare(a, b, tol, path="out"):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            compare(a[k], b[k], tol, f"{path}.{k}")
        return
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            compare(x, y, tol, f"{path}[{i}]")
        return
    a, b = arr(a), arr(b)
    assert a.shape == b.shape, (path, a.shape, b.shape)
    if a.dtype.kind in "USO" or b.dtype.kind in "USO":
        assert a.tolist() == b.tolist(), path
        return
    if a.dtype.kind in "iub" and b.dtype.kind in "iub":
        assert np.array_equal(a, b), (path, int((a != b).sum()))
        return
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    assert np.array_equal(np.isfinite(a64), np.isfinite(b64)), path
    ok = np.isfinite(a64)
    if not ok.any():
        return
    err = float(np.abs(a64[ok] - b64[ok]).max())
    scale = max(1.0, float(np.abs(a64[ok]).max()))
    assert err <= tol * scale, (path, err, tol * scale)


