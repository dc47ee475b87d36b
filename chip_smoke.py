#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one GPU and check them.

    python3 chip_smoke.py

Phases (any failed check raises, and the script exits non-zero):
1. build the CUDA kernels from ``mantaflow_tpu_torch/csrc`` (one nvcc each,
   in parallel);
2. the main path: the bench smoke configuration at 128^3 (1 warm step, 10
   timed, 30 developing, 10 timed; CUDA events), with every kernel launch
   counted, then checks of the final state;
3. hold the window-advection kernel against its plain PyTorch version on the
   card: a 12x16x24 fixture with displacements beyond the window, and the
   eight passes of one 128^3 bench step, in all three variants;
4. hold the CG kernel against the plain CG on the card: the 128^3 smoke
   system after a few steps in full and unit mode, a 128^3 system with an
   obstacle sphere and an empty (Dirichlet) slab, the same system at 192^3
   (more cells than the kernel's blocks keep on chip); two solves of the
   smoke and the 192^3 system bitwise equal;
5. the port on the card against the port on the CPU, 3 steps at 32^3;
6. the FLIP main path: the bench's FLIP dam at 128^3 (bench.py:60-175;
   ~3.8M particles, PPC 10), 1 warm step, then through
   flip_run_bucketed_auto in chunks of 10 (an overflow escalates the PPC
   and redoes the chunk): 10 timed steps, 30 more, the bench's settle
   loop, 10 timed steps, with every kernel launch counted per step, then
   checks of the final state (no particle lost);
7. hold the four FLIP kernels (advection+blend, the fused rebin,
   p2g+levelset, extrapolation layer) and the CG on the ghost-fluid system
   against their plain versions on the card: every kernel call of one
   128^3 step, cold (PPC 10) and developed (PPC 16), a 24^3 corner dam
   over the advection's modes, blend and obstacle options (the step's
   advection on its live slots, the form that passes invalid slots
   through on every slot; the step's rebin bitwise the same with the
   advected buckets' invalid slots poisoned by NaN and +-1e30); the fused
   rebin bitwise against flip_bucket.rebin and against the three-pass
   kernel (each pass against its plain version) on each step's rebin, a
   24^3 overflow, the overflow fixture and made-up buckets of 1, 24 and 40
   slots; then each kernel's time on the developed step's inputs (the
   three-pass kernel on the step's rebin);
8. the FLIP port on the card against the port on the CPU, 3 steps at 24^3;
9. path A, the bench dam solved without ghost fluid
   (scenes/flip01_simple.py: no particle levelset) at 128^3, driven and
   checked as phase 6: the transfer kernel alone;
10. path B, the dam with a sphere obstacle (the flip06_obstacle.py
   pattern) and scenes/flip03_gen.py's particle radius (radius_factor 2.5,
   a levelset window of 3 cells) at 128^3, the same way: the advection on
   its flags-at-position probes, the transfer kernel, the levelset kernel;
   then finalize_buckets (the blend kernel, once) and the particles read
   out; no particle lost or inside an obstacle cell;
11. hold the transfer, levelset (windows of 1, 2 and 3 cells) and blend
   kernels, and the advection with the obstacle, against their plain
   versions on the card, on the inputs of one cold and one developed 128^3
   step of paths A and B and on the 24^3 corner dam (the levelset also on
   made-up buckets over 19x23x29 at 1, 24 and 40 slots); then each kernel's
   time on the developed step's inputs;
12. paths A and B on the card against the port on the CPU, 3 steps at 24^3;
13. the z-sharded path: phase 6's developed state cut into 4 z-slabs over
   every visible card (``parallel/sharding.py``; on one card all four share
   it), 10 timed steps of ``flip_step_bucketed(..., zshard=mesh)`` against
   10 one-device steps from the same state (grids, flags and buckets
   equal, no particle lost, the launches per step counted: per shard one
   advection, one whole rebin of the halo-extended slab and one transfer;
   on the lead the extrapolation layers and the CG); every z-slab kernel
   call of a step against its plain version (the advection as in phase 7,
   the sharded rebin with poisoned invalid slots), the step's rebin also
   through the three-pass kernels (the slabs' x/y passes and the z pass
   over the halo-extended slab, each call against its plain version, the
   result bitwise against the step's), both also on the
   boundary-crossing fixture at 8 shards; their times and the halo
   copies; 3 steps at 16^3 over 8 shards on the card against the CPU;
14. the flat-layout FLIP dam (bench.py:37-40: the bench dam through
   make_dam_state, particles as (N, 3) tensors, 3,830,400 of them) at
   128^3: 1 warm step, 10 timed, 20 more, 10 timed (CUDA events), the
   launches per step counted (10 extrapolation layers and 1 CG, no other
   kernel), no particle lost, every field finite, every position in
   [0, 128); the layer kernel and the CG against their plain versions on
   every call of a cold and a developed step, and timed on the developed
   step's inputs;
15. the APIC ghost-fluid dam (tests/test_flip_model.py:24) at 128^3, driven
   and checked the same way;
16. the flat FLIP dam, the APIC dam and the flat dam with a sphere
   obstacle on the card against the CPU, 3 steps at 24^3.

Prints the card, a ``{"kernels": [...]}`` line and a timing line, and as its
last line ``{"ok": true, "device": {...}}``. Needs one CUDA device. A
kernel's time is its device time from a torch.profiler trace that holds
exactly its launches, else from CUDA events around its wrapper calls; each
entry says which (``timed_by``).
"""

import contextlib
import dataclasses
import json
import re
import subprocess
import sys
import time

import numpy as np

RES = 128
CG_BIG_RES = 192  # a CG system larger than the kernel keeps on chip
K = 3  # window: the bench's CFL bound
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (data sheet)
FP32_OPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores


FLIP_RES = 128
FLIP_CHUNK = 10  # bench.py's n_steps: timed window and runner chunk
ZSHARDS = 4      # z-slabs of the sharded path


def flip_bench_params(flip):
    # bench.py:84-86
    return flip.FlipParams(gravity=(0.0, -0.003, 0.0), ghost_fluid=True,
                           cg_accuracy=1e-3, ring_only_obstacles=True)


def bench_params(smoke):
    # bench.py:193-197
    return smoke.SmokeParams(buoyancy=(0.0, -6e-4, 0.0),
                             vorticity_confinement=0.1, cg_accuracy=1e-3,
                             window=K, adaptive_dt=True,
                             cfl=3.0, dt_max=2.0)


def bench_state(smoke, Domain, Sphere, res, device):
    dom = Domain(size=(res, res, res), dim=3)
    src = Sphere(center=(res / 2.0, res * 0.1, res / 2.0), radius=res * 0.14)
    return dom, smoke.make_smoke_state(dom, bench_params(smoke),
                                       source_shape=src, device=device)


def synthetic_buckets(dom, ppc, rng, device, spread=0.5):
    """Gap-free buckets with 0..ppc particles in half the cells (the rest
    empty), at random positions up to ``spread`` from the cell centre (past
    0.5: in the neighbouring cells too, inside the domain); free slots at
    the centre."""
    import torch

    from mantaflow_tpu_torch.ops import flip_bucket as fb
    sz, sy, sx = dom.shape
    T = sx * sy * sz
    n = rng.integers(0, ppc + 1, T)
    n[rng.random(T) < 0.5] = 0
    valid = np.arange(ppc)[:, None] < n[None, :]
    flat = np.arange(T)
    centre = (flat % sx + 0.5, (flat // sx) % sy + 0.5,
              flat // (sx * sy) + 0.5)
    pos = []
    for c, n_axis in zip(centre, (sx, sy, sz)):
        p = c + rng.uniform(-spread, spread, (ppc, T))
        if spread > 0.5:
            p = np.clip(p, 0.01, n_axis - 0.01)
        pos.append(torch.tensor(np.where(valid, p, c).astype(np.float32),
                                device=device))
    zero = torch.zeros((ppc, T), dtype=torch.float32, device=device)
    return fb.Buckets(*pos, zero, zero, zero,
                      torch.tensor(valid, device=device),
                      torch.zeros((), dtype=torch.int32, device=device))


def valid_bytes_read(bk):
    """The valid bytes a function over gap-free buckets (ops/flip_bucket.py)
    must read: each cell's up to its first invalid slot, min(count + 1, P);
    the slots after it are invalid."""
    return int((bk.valid.sum(dim=0) + 1).clamp(max=bk.ppc).sum())


def require(cond, what):
    if not cond:
        raise AssertionError(what)


def cuda_ms(torch, fn, reps):
    """Mean milliseconds of fn() over reps runs, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


@contextlib.contextmanager
def recording(module, name, calls):
    """Record the arguments of every call of ``module.name`` (the calls
    still run)."""
    orig = getattr(module, name)

    def rec(*args, **kwargs):
        calls.append((args, kwargs))
        return orig(*args, **kwargs)
    rec.launches = 0
    setattr(module, name, rec)
    try:
        yield orig
    finally:
        setattr(module, name, orig)


def replay(calls, fn):
    def go():
        for args, kwargs in calls:
            fn(*args, **kwargs)
    return go


def kernel_key_matches(key, names):
    """Whether a profiler key, the demangled name of a kernel (e.g. ``void
    (anonymous namespace)::union_levelset_kernel<3>((anonymous
    namespace)::LevelsetArgs)``), is one of the instances ``names``: a
    function name whole, with its template arguments where it has them
    (``union_levelset_kernel<3>``, ``window_advect_kernel<true,false,true>``),
    so that no other kernel and no other instance of a template matches."""
    key = key.replace(", ", ",")
    return any(re.search(r"(?:^|[\s:])" + re.escape(n.replace(" ", ""))
                         + r"\(", key) for n in names)


def kernel_device_ms(torch, fn, reps, names, launches):
    """Mean device milliseconds per launch of the CUDA kernel instances
    ``names`` (kernel_key_matches), from a torch.profiler trace of reps runs
    of fn() (``launches`` of them each): the kernel's own time, without the
    host's launch gaps. A trace is accepted only when the records matched
    number reps x launches: a trace can come back without some of the
    kernel's records, or with records of launches made outside it (an
    earlier trace's, flushed late). The instances matched are printed, and
    a trace refused is taken again; after three, returns None."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    want = reps * launches
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        us, count, keys = 0.0, 0, []
        for e in events:
            if kernel_key_matches(e.key, names):
                t = getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0.0))
                us += t
                count += e.count
                keys.append(f"{e.key[:90]} x{e.count} {t / 1e3:.3f} ms")
        ok = count == want and us > 0
        print(f"profiler trace {attempt + 1} of {'/'.join(names)}: {count} "
              f"records (want {want}), {us / 1e3:.3f} ms, "
              f"{'accepted' if ok else 'refused'}; matched: {keys}",
              flush=True)
        if ok:
            return us / 1e3 / count
    return None


def timed_launches(torch, fn, reps, names, launches):
    """(ms, call_ms, timed_by) per launch of the kernel instances ``names``:
    ``ms`` the profiler's device time (kernel_device_ms), ``call_ms`` CUDA
    events around the wrapper calls (host gaps included). ``ms`` is the
    events time, ``timed_by`` says which and the line printed says so,
    where no trace was accepted, where the profiler reads more than 1.05 of
    the events time (records that are not these launches'), or where a
    kernel of more than 0.2 ms reads under 0.8 of it (host gaps cannot
    explain that much)."""
    if isinstance(names, str):
        names = (names,)
    what = "/".join(names)
    dev = kernel_device_ms(torch, fn, reps, names, launches)
    call = cuda_ms(torch, fn, reps) / launches
    if dev is None:
        print(f"{what}: no profiler trace accepted; timed with CUDA "
              f"events, {call * 1e3:.1f} us/launch", flush=True)
        return call, call, "events"
    if dev > 1.05 * call or (call > 0.2 and dev < 0.8 * call):
        print(f"{what}: the profiler reads {dev * 1e3:.1f} us/launch, "
              f"CUDA events {call * 1e3:.1f}; timed with CUDA events",
              flush=True)
        return call, call, "events"
    return dev, call, "profiler"


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")

    from mantaflow_tpu_torch.core import flags as fl
    from mantaflow_tpu_torch.core import mac as macops
    from mantaflow_tpu_torch.core.domain import Domain
    from mantaflow_tpu_torch.core.shapes import Sphere
    from mantaflow_tpu_torch.kernels import _build
    from mantaflow_tpu_torch.core import particles as cp
    from mantaflow_tpu_torch.models import flip, smoke
    from mantaflow_tpu_torch.ops import advect_bucket_kernels as fadk
    from mantaflow_tpu_torch.ops import advection_kernels as advk
    from mantaflow_tpu_torch.ops import blend_kernels as blk
    from mantaflow_tpu_torch.ops import extrapolation_kernels as xk
    from mantaflow_tpu_torch.ops import flip_bucket as fb
    from mantaflow_tpu_torch.ops import levelset_kernels as lsk
    from mantaflow_tpu_torch.ops import p2g_kernels as p2gk
    from mantaflow_tpu_torch.ops import rebin_kernels as rbk
    from mantaflow_tpu_torch.ops import extforces as ext
    from mantaflow_tpu_torch.ops import pressure as prs
    from mantaflow_tpu_torch.ops import pressure_kernels as prk
    from mantaflow_tpu_torch.ops.advection import _cell_centers
    from mantaflow_tpu_torch.ops.advection_fast import window_interp
    from mantaflow_tpu_torch.parallel import sharding as shd

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    t_start = time.perf_counter()

    # -- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build()
    build_s = time.perf_counter() - t0
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[{name}] {line.strip()}")
    print(f"build: {build_s:.1f} s for {', '.join(_build.SOURCES)}",
          flush=True)

    # -- 2. main path: the bench smoke step at 128^3 -------------------------
    # first after the build, so that no earlier phase's work on the host or
    # the card (the plain versions, the CPU run) is in its timing
    params = bench_params(smoke)
    dom, state = bench_state(smoke, Domain, Sphere, RES, dev)
    torch.cuda.synchronize()
    advk.window_pass.launches = 0
    prk.cg_solve.launches = 0

    def timed(state, n_steps):
        iters = torch.zeros((), dtype=torch.int64, device=dev)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(n_steps):
            state = smoke.smoke_step(state, dom, params)
            iters += state.cg_iters
        t1.record()
        torch.cuda.synchronize()
        return state, n_steps / (t0.elapsed_time(t1) / 1e3), \
            int(iters) / n_steps

    state = smoke.smoke_step(state, dom, params)  # warm
    state, cold_sps, cold_it = timed(state, 10)
    state = smoke.smoke_run(state, dom, params, 30)
    state, dev_sps, dev_it = timed(state, 10)
    torch.cuda.synchronize()
    launches = {"window_advect": advk.window_pass.launches,
                "cg_solve": prk.cg_solve.launches}
    steps = 51
    require(launches["window_advect"] == 8 * steps,
            f"window_advect launched {launches['window_advect']} times")
    require(launches["cg_solve"] == steps,
            f"cg_solve launched {launches['cg_solve']} times")

    for name in ("vel", "density", "pressure"):
        require(bool(torch.isfinite(getattr(state, name)).all()),
                f"{name} not finite")
    dmax = float(state.density.max())
    require(0.1 < dmax <= 1.01, f"density max {dmax}")
    require(int(state.ts.count) == steps, f"ts.count {int(state.ts.count)}")

    # -- 3. window-advection kernel vs window_interp ------------------------
    def k1_check(src, px, py, pz, dom, ok, want_minmax):
        got = advk.window_pass(src, px, py, pz, dom, K, ok_mask=ok,
                               want_minmax=want_minmax)
        ref = window_interp(src, px, py, pz, dom, K, ok_mask=ok,
                            want_minmax=want_minmax)
        if not want_minmax:
            got, ref = (got,), (ref,)
        err = 0.0
        for g, r in zip(got, ref):
            if r.dtype == torch.bool:
                require(torch.equal(g, r), "window_advect: have differs")
            else:
                err = max(err, float((g - r).abs().max()))
        require(err < 1e-6, f"window_advect: max abs err {err} >= 1e-6")
        return err, got

    rng = np.random.RandomState(0)
    Z, Y, X = 12, 16, 24
    fdom = Domain(size=(X, Y, Z), dim=3)
    fsrc = torch.tensor(rng.rand(Z, Y, X).astype(np.float32), device=dev)
    fok = torch.tensor(rng.rand(Z, Y, X) > 0.3, device=dev)
    zz, yy, xx = np.meshgrid(np.arange(Z), np.arange(Y), np.arange(X),
                             indexing="ij")
    disp = (rng.rand(3, Z, Y, X) * 2 - 1) * 3.8  # exceeds k: tests clamping
    fpos = [torch.tensor((g + 0.5 + d).astype(np.float32), device=dev)
            for g, d in ((xx, disp[0]), (yy, disp[1]), (zz, disp[2]))]
    k1_err = 0.0
    for ok, mm in ((None, False), (None, True), (fok, True)):
        k1_err = max(k1_err, k1_check(fsrc, *fpos, fdom, ok, mm)[0])
    print(f"window_advect fixture 12x16x24: max abs err {k1_err:.3g}",
          flush=True)

    # a few bench steps give the 128^3 fields the kernels see
    dom, state = bench_state(smoke, Domain, Sphere, RES, dev)
    for _ in range(5):
        state = smoke.smoke_step(state, dom, params)
    flags, vel, dt = state.flags, state.vel, state.ts.dt
    xx, yy, zz = _cell_centers(dom, dev)
    c = macops.get_centered(vel)
    ok = (flags & (fl.TypeFluid | fl.TypeEmpty)) != 0
    # the eight window passes of one step (advect_real_pl, advect_mac_pl)
    passes = [(state.density, xx - c[0] * dt, yy - c[1] * dt,
               zz - c[2] * dt, ok, True)]
    fwd = advk.window_pass(*passes[0][:4], dom, K, ok_mask=ok,
                           want_minmax=True)[0]
    passes.append((fwd, xx + c[0] * dt, yy + c[1] * dt, zz + c[2] * dt,
                   None, False))
    for comp in range(3):
        f = advk._face_positions(vel, dt, dom, comp)
        passes.append((vel[comp], *f[:3], None, True))
        passes.append((vel[comp], *f[3:], None, False))
    for p in passes:
        k1_err = max(k1_err, k1_check(p[0], p[1], p[2], p[3], dom, p[4],
                                      p[5])[0])
    print(f"window_advect 128^3 step passes: max abs err {k1_err:.3g}",
          flush=True)

    def run_passes(fn):
        def go():
            for s_, px, py, pz, o, mm in passes:
                fn(s_, px, py, pz, dom, K, ok_mask=o, want_minmax=mm)
        return go

    # the template instances the passes launch: <kMinMax, kWithOk, k3d>
    k1_names = sorted({"window_advect_kernel<%s,%s,true>" % (
        str(mm).lower(), str(mm and o is not None).lower())
        for *_, o, mm in passes})
    k1_ms, k1_call_ms, k1_timed_by = timed_launches(
        torch, run_passes(advk.window_pass), 20, k1_names, len(passes))
    k1_plain_ms = cuda_ms(torch, run_passes(window_interp), 1) / len(passes)
    n = dom.num_cells
    k1_bytes = sum(n * (16 + (1 if o is not None else 0)
                        + (4 + (9 if mm else 0))) for *_, o, mm in passes)
    k1_bytes /= len(passes)
    k1_ops = n * 60  # 3 axis setups (~8 each) + 8-corner blend (~36)
    k1_bound_bytes = k1_bytes / HBM_BYTES_PER_S * 1e3
    k1_bound_ops = k1_ops / FP32_OPS_PER_S * 1e3

    # -- 4. CG kernel vs plain CG -------------------------------------------
    def cg_check(rhs, stencil, fluid, acc, max_iter, dom_,
                 units=(False, True)):
        p_ref, it_ref, _ = prs.cg_plain(rhs, stencil, dom_, acc, max_iter,
                                        fluid)
        scale = float(p_ref.abs().max()) + 1e-30
        worst = 0.0
        for unit in units:
            p, it, rn = prk.cg_solve(rhs, stencil, dom_, acc, max_iter,
                                     fluid=fluid, unit_stencil=unit)
            it, it_ref_ = int(it), int(it_ref)
            rel = float((p - p_ref).abs().max()) / scale
            require(abs(it - it_ref_) <= 10,
                    f"cg_solve unit={unit}: {it} vs {it_ref_} iterations")
            require(rel < 5e-3, f"cg_solve unit={unit}: rel err {rel}")
            require(it == max_iter or float(rn) < acc,
                    f"cg_solve unit={unit}: exited at resnorm {float(rn)}")
            worst = max(worst, float((p - p_ref).abs().max()))
            print(f"cg_solve {dom_.shape} unit={unit}: {it} it "
                  f"(plain {it_ref_}), rel err {rel:.3g}", flush=True)
        return worst

    vel_pre = ext.add_buoyancy(flags, state.density, vel, params.buoyancy,
                               dt, dom)
    vel_pre = ext.vorticity_confinement(vel_pre, flags, dom,
                                        params.vorticity_confinement)
    rhs = prs.make_rhs(flags, vel_pre, dom)
    stencil = prs.make_laplace_stencil(flags, dom)
    fluid = fl.is_fluid(flags)
    max_iter = int(params.cg_max_iter_fac * RES)
    k2_err = cg_check(rhs, stencil, fluid, params.cg_accuracy, max_iter, dom)

    def obstacle_slab_system(n):
        """A walled n^3 system with an obstacle sphere and an empty slab."""
        dom_ = Domain(size=(n,) * 3)
        x_, y_, z_ = _cell_centers(dom_, dev)
        ob_flags = fl.fill_grid(fl.init_domain(dom_, 1, device=dev))
        sphere = ((x_ - 0.3 * n) ** 2 + (y_ - 0.2 * n) ** 2
                  + (z_ - 0.5 * n) ** 2).sqrt() < 0.12 * n
        ob_flags = torch.where(sphere, fl.TypeObstacle, ob_flags)
        slab = (y_ > 0.8 * n) & fl.is_fluid(ob_flags)
        ob_flags = torch.where(slab, fl.TypeEmpty, ob_flags)
        g = torch.Generator(device="cpu").manual_seed(7)
        ob_vel = (torch.randn((3,) + dom_.shape, generator=g) * 0.1).to(dev)
        return (prs.make_rhs(ob_flags, ob_vel, dom_),
                prs.make_laplace_stencil(ob_flags, dom_),
                fl.is_fluid(ob_flags), dom_)

    rhs_o, stencil_o, fluid_o, _ = obstacle_slab_system(RES)
    k2_err = max(k2_err, cg_check(rhs_o, stencil_o, fluid_o, 1e-4,
                                  max_iter * 12, dom))
    del rhs_o, stencil_o, fluid_o
    # more cells than the kernel keeps on chip: its blocks' further cells
    # go through the device-memory scratch (ops/pressure_kernels.cg_plan)
    big = obstacle_slab_system(CG_BIG_RES)
    big_plan = prk.cg_plan(big[3].shape, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    require(big_plan.overflow > 0,
            f"{CG_BIG_RES}^3 fits on chip: {big_plan}")
    k2_err = max(k2_err, cg_check(*big[:3], 1e-4,
                                  int(1.5 * CG_BIG_RES) * 12, big[3]))
    # a solve is deterministic: every block reduces in the same fixed order
    for sys_, acc_, mi_ in (((rhs, stencil, fluid, dom), params.cg_accuracy,
                             max_iter),
                            (big, 1e-4, int(1.5 * CG_BIG_RES) * 12)):
        for unit in (False, True):
            a_, b_ = (prk.cg_solve(sys_[0], sys_[1], sys_[3], acc_, mi_,
                                   fluid=sys_[2], unit_stencil=unit)
                      for _ in range(2))
            require(all(torch.equal(u, v) for u, v in zip(a_, b_)),
                    f"cg_solve {sys_[3].shape} unit={unit}: two solves of "
                    "the same system differ")
    print(f"cg_solve {CG_BIG_RES}^3: {big_plan.overflow} of "
          f"{big_plan.onchip + big_plan.overflow} cells per block off chip; "
          "two solves bitwise equal (128^3 smoke, "
          f"{CG_BIG_RES}^3, both modes)", flush=True)
    del big

    cg_iters = {}

    def cg_kernel_run():
        cg_iters["k"] = prk.cg_solve(rhs, stencil, dom, params.cg_accuracy,
                                     max_iter)[1]

    def cg_plain_run():
        cg_iters["p"] = prs.cg_plain(rhs, stencil, dom, params.cg_accuracy,
                                     max_iter, fluid)[1]

    k2_ms, k2_call_ms, k2_timed_by = timed_launches(
        torch, cg_kernel_run, 5, "cg_kernel<false>", 1)
    k2_plain_ms = cuda_ms(torch, cg_plain_run, 1)
    k2_it = int(cg_iters["k"])
    k2_bound_bytes = 6 * 4 * n / HBM_BYTES_PER_S * 1e3  # rhs, A0-Ak in; p out
    k2_bound_ops = k2_it * 24 * n / FP32_OPS_PER_S * 1e3  # 24 flops/cell/it
    # this design's floor per iteration: r, s and tmp stay in the blocks'
    # shared memory, p in registers; s (read by the neighbouring blocks)
    # and A0-Ak are read once and s written once, 24 bytes a cell, between
    # the SMs and the L2. They cross device memory only as far as the L2
    # (50 MB) fails to hold the 20 bytes a cell read (42 MB at 128^3): then
    # at most the 24 bytes, at the device memory's rate
    k2_iter_floor = {"l2_bytes": 24 * n, "dram_bytes_if_l2_holds": 0,
                     "dram_bytes_if_l2_misses": 24 * n,
                     "dram_ms_if_l2_misses": 24 * n / HBM_BYTES_PER_S * 1e3}

    # -- 5. port on the card vs port on the CPU ----------------------------
    sdom, s_gpu = bench_state(smoke, Domain, Sphere, 32, dev)
    _, s_cpu = bench_state(smoke, Domain, Sphere, 32, "cpu")
    for _ in range(3):
        s_gpu = smoke.smoke_step(s_gpu, sdom, params)
        s_cpu = smoke.smoke_step(s_cpu, sdom, params)
    d_err = float((s_gpu.density.cpu() - s_cpu.density).abs().max())
    v_err = float((s_gpu.vel.cpu() - s_cpu.vel).abs().max())
    require(d_err < 2e-4 and v_err < 2e-4,
            f"32^3 card vs CPU: density {d_err}, vel {v_err}")
    print(f"32^3 x3 steps, card vs CPU: density {d_err:.3g}, vel "
          f"{v_err:.3g}", flush=True)

    # -- 6. FLIP main path: the bench FLIP dam at 128^3 ---------------------
    fdom = Domain(size=(FLIP_RES,) * 3)
    # the step's advection (live slots only) and, never on a step, the
    # form that passes invalid slots through
    flip_kernels = {"advect_bucket": fadk.advect_blend_live,
                    "advect_bucket_public": fadk.advect_blend,
                    "rebin_fused": rbk.rebin_fused,
                    "rebin_fused_slab": rbk.rebin_fused_slab,
                    "rebin": rbk.rebin_pass,
                    "rebin_zshard": rbk.rebin_zpass_halo,
                    "p2g_levelset": p2gk.p2g_union,
                    "p2g_mac": p2gk.p2g_mac,
                    "union_levelset": lsk.union_levelset,
                    "flip_blend": blk.flip_update,
                    "extrap_layer": xk.extrap_layer, "cg_solve": prk.cg_solve}
    step_fn = flip.flip_step_bucketed

    def drive_flip(name, fparams, per_step, obstacle=None, finalize=False):
        """One FLIP main path at 128^3: the dam set up at PPC 10, 1 warm
        step, then through flip_run_bucketed_auto in chunks of FLIP_CHUNK:
        a timed chunk (cold), 30 more steps, the bench's settle loop (so
        that no escalation falls into the timed window), and a timed chunk
        (developed); with ``finalize`` the pending blend and the particles
        read out. Every kernel's count is set to 0 just before and read
        just after; the launches per step, the particle count and the
        fields are checked. Returns the run's numbers, its last state
        (before the finalize) and the launches."""
        t0 = time.perf_counter()
        fst = flip.make_dam_state_bucketed(fdom, fparams, ppc=10,
                                           obstacle=obstacle, device=dev)
        n_parts = int(fst.buckets.count())
        setup_s = time.perf_counter() - t0
        print(f"{name} {FLIP_RES}^3 set-up: {n_parts} particles, PPC "
              f"{fst.buckets.ppc}, {setup_s:.1f} s", flush=True)
        # every step the path runs, redone chunks included, and its CG
        # iterations (a device sum, no sync)
        run = {"n": 0, "iters": torch.zeros((), dtype=torch.int64,
                                            device=dev),
               "ppc": fst.buckets.ppc, "escalations": []}

        def counted_step(state, dom_, params_):
            if state.buckets.ppc != run["ppc"]:
                # the runner rebinned before this step: (step, new PPC)
                run["ppc"] = state.buckets.ppc
                run["escalations"].append((int(state.ts.count) + 1,
                                           state.buckets.ppc))
            state = step_fn(state, dom_, params_)
            run["n"] += 1
            run["iters"] += state.cg_iters
            return state

        def chunk(state):
            return flip.flip_run_bucketed_auto(state, fdom, fparams,
                                               FLIP_CHUNK,
                                               check_every=FLIP_CHUNK)

        def timed_chunk(state):
            """One runner chunk of FLIP_CHUNK steps: (state, steps/s, CG
            iterations per step run, redone steps included)."""
            torch.cuda.synchronize()
            mark, steps_pre = int(run["iters"]), run["n"]
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            state = chunk(state)
            t1.record()
            torch.cuda.synchronize()
            return (state, FLIP_CHUNK / (t0.elapsed_time(t1) / 1e3),
                    (int(run["iters"]) - mark) / (run["n"] - steps_pre))

        torch.cuda.synchronize()
        for fn in flip_kernels.values():
            fn.launches = 0
        flip.flip_step_bucketed = counted_step
        try:
            fst = flip.flip_step_bucketed(fst, fdom, fparams)  # warm
            require(int(fst.buckets.dropped) == 0,
                    f"{name}: {int(fst.buckets.dropped)} dropped in the "
                    "warm step")
            fst, cold_sps, cold_it = timed_chunk(fst)
            cold_ppc = fst.buckets.ppc
            for _ in range(3):
                fst = chunk(fst)
            # bench.py:147-153: a chunk that ends at an unchanged PPC shows
            # that no escalation is pending
            for _ in range(3):
                ppc_pre = fst.buckets.ppc
                fst = chunk(fst)
                if fst.buckets.ppc == ppc_pre:
                    break
            fst, dev_sps, dev_it = timed_chunk(fst)
        finally:
            flip.flip_step_bucketed = step_fn
        if finalize:
            fin = flip.finalize_buckets(fst, fdom, fparams)
            parts, pvel = fb.to_particles(fin.buckets, fdom)
            torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in flip_kernels.items()}
        n_steps = run["n"]
        for k in flip_kernels:
            want = per_step.get(k, 0) * n_steps
            if k == "flip_blend":
                want = 1 if finalize else 0
            require(launches[k] == want,
                    f"{name}: {k} launched {launches[k]} times in {n_steps} "
                    f"steps (expected {want})")
        require(int(fst.buckets.dropped) == 0,
                f"{name}: {int(fst.buckets.dropped)} particles dropped")
        require(int(fst.buckets.count()) == n_parts,
                f"{name}: {int(fst.buckets.count())} particles, had "
                f"{n_parts}")
        for field in ("vel", "phi", "pressure"):
            require(bool(torch.isfinite(getattr(fst, field)).all()),
                    f"{name}: {field} not finite")
        occupied = fst.buckets.valid.any(dim=0).reshape(fdom.shape)
        require(not bool((fl.is_obstacle(fst.flags) & occupied).any()),
                f"{name}: a valid slot lies in an obstacle cell")
        if finalize:
            require(not bool(fin.blend_pending), f"{name}: blend pending")
            require(int(parts.count) == n_parts,
                    f"{name}: to_particles read {int(parts.count)} of "
                    f"{n_parts} particles")
            require(bool(torch.isfinite(pvel).all()),
                    f"{name}: particle velocities not finite")
        print(f"{name} {FLIP_RES}^3: {n_steps} steps run "
              f"({int(fst.ts.count)} kept), PPC {cold_ppc} after the cold "
              f"window, {fst.buckets.ppc} at the end, escalations (from "
              f"step, to PPC) {run['escalations']}, {cold_sps:.2f} steps/s "
              f"cold, {dev_sps:.2f} developed, CG {cold_it:.1f} / "
              f"{dev_it:.1f} it/step, launches {launches}", flush=True)
        numbers = {"steps_per_s_cold": cold_sps,
                   "steps_per_s_developed": dev_sps, "particles": n_parts,
                   "ppc_cold": cold_ppc, "ppc_final": fst.buckets.ppc,
                   "escalations": run["escalations"], "steps_run": n_steps,
                   "steps_kept": int(fst.ts.count),
                   "cg_iters_per_step_cold": cold_it,
                   "cg_iters_per_step_developed": dev_it,
                   "launches_per_step": per_step, "setup_s": setup_s}
        return numbers, fst, launches

    fparams = flip_bench_params(flip)
    per_step = {"advect_bucket": 1, "rebin_fused": 1, "p2g_levelset": 1,
                "extrap_layer": 10, "cg_solve": 1}
    flip_numbers, fst, flip_launches = drive_flip("flip", fparams, per_step)
    zshard_start = fst  # phase 13 starts from the developed state

    # -- 7. FLIP kernels vs their plain versions on the card ----------------
    plain_of = {"advect_bucket": fadk.advect_blend_plain,
                "rebin_fused": fb.rebin,
                "p2g_levelset": p2gk.p2g_union_plain,
                "p2g_mac": fb.p2g_mac,
                "union_levelset": fb.union_levelset_bucketed,
                "flip_blend": fb.flip_update_bucketed,
                "extrap_layer": xk.extrap_layer_plain}
    sites = {"advect_bucket": (fadk, "advect_blend_live"),
             "rebin_fused": (rbk, "rebin_fused"),
             "rebin": (rbk, "rebin_pass"),
             "p2g_levelset": (p2gk, "p2g_union"),
             "p2g_mac": (p2gk, "p2g_mac"),
             "union_levelset": (lsk, "union_levelset"),
             "flip_blend": (blk, "flip_update"),
             "extrap_layer": (xk, "extrap_layer"),
             "cg_solve": (prk, "cg_solve")}

    def record_step(state, params_=fparams):
        """The arguments of every kernel call of one step from state."""
        calls = {k: [] for k in sites}
        with contextlib.ExitStack() as stack:
            for k, (mod, name) in sites.items():
                stack.enter_context(recording(mod, name, calls[k]))
            flip.flip_step_bucketed(state, fdom, params_)
        torch.cuda.synchronize()
        return calls

    fields6 = ("px", "py", "pz", "vx", "vy", "vz")

    def advect_err(got, ref, bk, public):
        """The step's advection (``got``) against the plain version
        (``ref``) on the live slots of its input ``bk``, to abs 1e-6; the
        public form (``public``, invalid slots passed through) against the
        plain version on every slot, its invalid slots equal to the input
        and its live slots to the step's form."""
        live = bk.valid
        require(torch.equal(got.valid, live)
                and int(got.dropped) == int(bk.dropped),
                "advection: valid or dropped changed")
        err = 0.0
        for f in fields6:
            g, r, p_, i_ = (getattr(o, f) for o in (got, ref, public, bk))
            require(torch.equal(g[live], p_[live]),
                    f"advection: the step's and the public form's {f} "
                    "differ on the live slots")
            require(torch.equal(p_[~live], i_[~live]),
                    f"advection: the public form changed an invalid {f}")
            err = max(err, float((g[live] - r[live]).abs().max()),
                      float((p_ - r).abs().max()))
        require(err <= 1e-6, f"advection: max abs err {err}")
        return err

    def poisoned(bk):
        """``bk`` with the invalid slots' six fields NaN, +1e30 and -1e30
        by turns: what no rebin may read."""
        bad = torch.tensor([float("nan"), 1e30, -1e30],
                           device=bk.px.device)
        idx = torch.arange(bk.px.numel(), device=bk.px.device)
        return dataclasses.replace(bk, **{
            f: torch.where(bk.valid, getattr(bk, f),
                           bad[(idx + k) % 3].view(bk.px.shape))
            for k, f in enumerate(fields6)})

    def bucket_err(got, ref, exact):
        require(torch.equal(got.valid, ref.valid), "buckets: valid differs")
        require(int(got.dropped) == int(ref.dropped),
                f"buckets: dropped {int(got.dropped)} vs {int(ref.dropped)}")
        err = 0.0
        for f in ("px", "py", "pz", "vx", "vy", "vz"):
            g, r = getattr(got, f), getattr(ref, f)
            if exact:
                require(torch.equal(g, r), f"rebin: {f} differs")
            err = max(err, float((g - r).abs().max()))
        return err

    def three_passes(bk, dom_):
        """The three-pass kernel's x, y and z passes, each against
        ``_rebin_axis`` on its own input (bitwise); returns the result and
        the passes' calls."""
        calls = []
        for axis in range(3):
            calls.append(((bk, dom_, axis), {}))
            nxt = rbk.rebin_pass(bk, dom_, axis)
            bucket_err(nxt, fb._rebin_axis(bk, dom_, axis), exact=True)
            bk = nxt
        return bk, calls

    def check_call(kind, args, kwargs):
        """Kernel vs plain on one recorded call; returns max abs error."""
        orig = getattr(*sites[kind])
        got = orig(*args, **kwargs)
        ref = plain_of[kind](*args, **kwargs)
        if kind == "rebin_fused":
            # against flip_bucket.rebin and the three-pass kernel
            bucket_err(got, three_passes(*args)[0], exact=True)
            return bucket_err(got, ref, exact=True)
        if kind == "advect_bucket":
            return advect_err(got, ref, args[0], fadk.advect_blend(
                *args, **kwargs))
        if kind == "flip_blend":
            err = bucket_err(got, ref, exact=False)
            require(err <= 1e-6, f"{kind}: max abs err {err}")
            return err
        if kind == "extrap_layer":
            for g, r in zip(got[0] + got[1], ref[0] + ref[1]):
                require(torch.equal(g, r), "extrap_layer: differs")
            return 0.0
        # the transfer's gather sums in another order than the plain rolls
        # (the Pallas kernel's tolerance, flip_bucket_pallas2.py:25-28); the
        # levelset alone is a min of the same expressions (the JAX tests'
        # tolerance, tests/test_flip_bucket.py:165-167)
        if kind == "union_levelset":
            got, ref = (got,), (ref,)
        tol = 1e-6 if kind == "union_levelset" else 1e-5
        err = 0.0
        for g, r, what in zip(got, ref, ("vel", "weight", "phi")):
            e = float((g - r).abs().max())
            require(e <= tol, f"{kind}: output {what} max abs err {e}")
            err = max(err, e)
        return err

    errs = {k: 0.0 for k in flip_kernels}
    poison_checks = []
    # the 128^3 step from the developed state (PPC escalated), from a cold
    # state a few steps in (PPC 10), and from that state rebinned at PPC 16
    dev_calls = record_step(fst)
    cold = flip.make_dam_state_bucketed(fdom, fparams, ppc=10, device=dev)
    for _ in range(3):
        cold = flip.flip_step_bucketed(cold, fdom, fparams)
    cold_calls = record_step(cold)
    cold = dataclasses.replace(
        cold, buckets=fb.rebin_to_ppc(cold.buckets, fdom, 16))
    ppc16_calls = record_step(cold)
    del cold
    for calls, what in ((dev_calls, f"PPC {fst.buckets.ppc}"),
                        (cold_calls, "PPC 10"), (ppc16_calls, "PPC 16")):
        for kind in plain_of:
            require(len(calls[kind]) == per_step.get(kind, 0),
                    f"{kind}: {len(calls[kind])} calls in one step")
            for args, kwargs in calls[kind]:
                errs[kind] = max(errs[kind], check_call(kind, args, kwargs))
        # the step's rebin reads the advected buckets' live slots alone
        (r_args, _), = calls["rebin_fused"]
        r_ref = rbk.rebin_fused(*r_args)
        r_bad = poisoned(r_args[0])
        bucket_err(rbk.rebin_fused(r_bad, r_args[1]), r_ref, exact=True)
        bucket_err(fb.rebin(r_bad, r_args[1]), r_ref, exact=True)
        poison_checks.append(f"rebin {what}")
        del r_args, r_ref, r_bad
        for args, kwargs in calls["cg_solve"]:
            rhs, stencil, dom_, acc, max_iter = args
            # the ghost-fluid diagonal needs the full-stencil mode
            errs["cg_solve"] = max(errs["cg_solve"], cg_check(
                rhs, stencil, kwargs["fluid"], acc, max_iter, dom_,
                units=(False,)))
        print(f"flip {FLIP_RES}^3 step kernels vs plain ({what}): "
              + ", ".join(f"{k} {errs[k]:.3g}" for k in per_step),
              flush=True)
    del cold_calls, ppc16_calls

    # the advection's options at 128^3 (developed inputs) and at 24^3
    (a_args, _), = dev_calls["advect_bucket"]
    bk128, flags128, vel128, vold128, dt128 = a_args[:5]
    cdom = Domain(size=(24,) * 3)
    corner = flip.make_dam_state_bucketed(cdom, fparams,
                                          dam_frac=(0.3, 0.3, 0.35), ppc=12,
                                          device=dev)
    cbk = corner.buckets
    cbk = dataclasses.replace(
        cbk, vx=torch.where(cbk.valid, cbk.px * 0.01, 0.0),
        vy=torch.where(cbk.valid, cbk.py * 0.02 - 0.05, 0.0),
        vz=torch.where(cbk.valid, cbk.pz * 0.005, 0.0))
    cvel = torch.tensor(np.random.RandomState(7).randn(3, 24, 24, 24)
                        .astype(np.float32) * 0.25, device=dev)
    c = torch.arange(24, device=dev) + 0.5
    zz, yy, xx = torch.meshgrid(c, c, c, indexing="ij")
    sphere_flags = torch.where(
        ((xx - 5.0) ** 2 + (yy - 4.0) ** 2 + (zz - 4.5) ** 2).sqrt() < 3.0,
        fl.TypeObstacle, corner.flags)
    options = []
    for mode in (0, 1, 2):
        for pending in (True, False):
            options.append((bk128, flags128, vel128, vold128, dt128,
                            pending, mode, True, fdom))
            for ring, cflags in ((True, corner.flags), (False, sphere_flags)):
                for dt in (0.5, 2.5):
                    options.append((cbk, cflags, cvel, cvel * 0.85,
                                    torch.tensor(dt, device=dev), pending,
                                    mode, ring, cdom))
    options.append((bk128, flags128, vel128, vold128, dt128, True, 2, False,
                    fdom))
    for b_, f_, v_, vo_, dt_, pend, mode, ring, d_ in options:
        errs["advect_bucket"] = max(errs["advect_bucket"], check_call(
            "advect_bucket", (b_, f_, v_, vo_, dt_,
                              torch.tensor(pend, device=dev),
                              fparams.flip_ratio, d_, mode, ring), {}))
    # the rebin on a 24^3 overflow (displacements of a cell), the overflow
    # fixture of tests/test_flip_bucket.py and made-up buckets over
    # 19x23x29 (1, 24 and 40 slots, up to 1.45 cells from the centre): the
    # fused kernel against flip_bucket.rebin and the three passes, each
    # pass against its plain version
    moved = fb.advect_bucketed(cbk, corner.flags, cvel * 6.0,
                               torch.tensor(1.0, device=dev), cdom, 0)
    opos = np.array([[3.5, 3.5, 3.5], [2.6, 3.5, 3.5], [4.4, 3.5, 3.5],
                     [3.5, 2.7, 3.5], [3.5, 3.5, 4.3]], np.float32)
    odom = Domain(size=(8, 8, 8))
    obk = fb.bin_from_particles(
        cp.make_particles(opos, capacity=8, device=dev),
        np.arange(24, dtype=np.float32).reshape(8, 3) * np.float32(0.01),
        odom, ppc=4)
    obk = dataclasses.replace(obk, **{
        f: torch.where(obk.valid, getattr(obk, f)
                       + 0.9 * (3.5 - getattr(obk, f)), getattr(obk, f))
        for f in ("px", "py", "pz")})
    sydom = Domain(size=(19, 23, 29))
    rebin_cases = [(moved, cdom), (obk, odom)] + [
        (synthetic_buckets(sydom, ppc, np.random.default_rng(ppc), dev,
                           spread=1.45), sydom) for ppc in (1, 24, 40)]
    drops = []
    for b_, d_ in rebin_cases:
        errs["rebin_fused"] = max(errs["rebin_fused"], check_call(
            "rebin_fused", (b_, d_), {}))
        drops.append(int(rbk.rebin_fused(b_, d_).dropped))
    require(drops[0] > 0 and drops[1] == 1 and all(d > 0 for d in drops[2:]),
            f"rebin overflow drops {drops}")
    del rebin_cases
    errs["p2g_levelset"] = max(errs["p2g_levelset"], check_call(
        "p2g_levelset", (cbk, cdom, 1.0), {}))
    print(f"flip kernels vs plain, 24^3 and option sweeps: "
          f"advect_bucket {errs['advect_bucket']:.3g} over {len(options)} "
          f"cases, rebin (fused and three passes) overflow drops {drops} "
          f"bitwise, p2g_levelset "
          f"{errs['p2g_levelset']:.3g}", flush=True)

    # times on the developed step's inputs
    P, T = bk128.ppc, fdom.num_cells
    live = int(bk128.valid.sum())
    fk = {}

    def time_kernel(kind, kname, calls, fn, plain, nbytes, nops, what):
        """Device ms per launch of ``fn`` over the recorded calls, the
        plain version's ms, and the bound from the bytes and operations
        the function needs for these inputs."""
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        o_ms = nops / FP32_OPS_PER_S * 1e3
        ms, call_ms, timed_by = timed_launches(torch, replay(calls, fn), 5,
                                               kname, len(calls))
        fk[kind] = {
            "ms": ms, "call_ms": call_ms, "timed_by": timed_by,
            "plain_ms": cuda_ms(torch, replay(calls, plain), 1) / len(calls),
            "bound_ms": max(b_ms, o_ms),
            "bound_by": "bytes" if b_ms >= o_ms else "operations"}
        print(f"{kind}: {fk[kind]['ms'] * 1e3:.1f} us/launch (bound "
              f"{fk[kind]['bound_ms'] * 1e3:.1f} us, "
              f"{fk[kind]['bound_by']}; {what}), "
              f"plain {fk[kind]['plain_ms']:.2f} ms", flush=True)

    # least bytes per launch, for what each function must read and write:
    # slot fields are 4 bytes, valid 1 byte, of which each function reads
    # valid_bytes_read (the buckets are gap-free; the mean over the
    # recorded calls' inputs). The step's advection reads and writes the
    # six slot fields of the live slots, and reads the vel and vel_old
    # grids (and, unless ring_only, the obstacle mask); the public form
    # passes invalid slots through, so it reads and writes the six fields
    # of every slot. The rebin and p2g read the six fields of
    # the live particles only; the rebin writes all seven output fields of
    # every slot, p2g its seven grids (vel and weight 3 each, phi).
    def mean_valid_bytes(calls):
        return sum(valid_bytes_read(a[0]) for a, _ in calls) / len(calls)

    layer_bytes = [len(a[0]) * 16 * T for a, _ in dev_calls["extrap_layer"]]
    # the three-pass kernel's x, y and z passes of the step's rebin
    rebin_calls = three_passes(*dev_calls["rebin_fused"][0][0])[1]
    def advect_bytes(calls, t_grid, ring_only, every_slot=False):
        """Least bytes per launch of the advection over the recorded
        calls: the six fields of the live slots (every slot's for the
        public form) read and written, the valid bytes read, vel and
        vel_old over ``t_grid`` cells, the obstacle mask unless
        ``ring_only``."""
        n = 0.0
        for a, _ in calls:
            slots = a[0].valid.numel() if every_slot else int(
                a[0].valid.sum())
            n += (48 * slots + valid_bytes_read(a[0]) + 24 * t_grid
                  + (0 if ring_only else t_grid))
        return n / len(calls)

    fbytes = {
        "advect_bucket": advect_bytes(dev_calls["advect_bucket"], T,
                                      fparams.ring_only_obstacles),
        "rebin": 25 * P * T + 24 * live + mean_valid_bytes(rebin_calls),
        # the whole rebin moves what one pass does
        "rebin_fused": 25 * P * T + 24 * live
        + mean_valid_bytes(dev_calls["rebin_fused"]),
        "p2g_levelset": 24 * live + 28 * T
        + mean_valid_bytes(dev_calls["p2g_levelset"]),
        "extrap_layer": sum(layer_bytes) / len(layer_bytes),
    }
    # float operations per launch, counted on the live particles: RK4 with
    # the blend ~620 per particle (4 stages x 3 components x ~36 for the
    # weights and the 8-corner blend, plus dt scaling and clamps; the
    # blend's second grid and mix ~120); a rebin pass ~10 per particle, the
    # fused rebin three passes' worth;
    # p2g+levelset ~540 per particle (3 components x 18 taps x 5, and 27
    # levelset distances x 10); a layer ~20 per cell and pair
    fops = {"advect_bucket": 620 * live, "rebin": 10 * live,
            "rebin_fused": 30 * live,
            "p2g_levelset": 540 * live,
            "extrap_layer": 20 * sum(len(a[0]) for a, _ in
                                     dev_calls["extrap_layer"]) * T
            / len(dev_calls["extrap_layer"])}
    for kind, kname in (("advect_bucket", "advect_live_kernel<false>"),
                        ("rebin_fused", "rebin_fused_kernel<false>"),
                        ("p2g_levelset", "p2g_levelset_kernel"),
                        ("extrap_layer", "extrap_layer_kernel")):
        time_kernel(kind, kname, dev_calls[kind], getattr(*sites[kind]),
                    plain_of[kind], fbytes[kind], fops[kind],
                    f"P {P}, {live} live")
    time_kernel("rebin", "rebin_pass_kernel", rebin_calls, rbk.rebin_pass,
                fb._rebin_axis, fbytes["rebin"], fops["rebin"],
                f"P {P}, {live} live, the step's rebin in three passes")
    # the public form on the same inputs: its copies of every slot and the
    # kernel, timed together by CUDA events, against the every-slot bound
    adv_calls = dev_calls["advect_bucket"]
    pub_b_ms = advect_bytes(adv_calls, T, fparams.ring_only_obstacles,
                            every_slot=True) / HBM_BYTES_PER_S * 1e3
    pub_o_ms = fops["advect_bucket"] / FP32_OPS_PER_S * 1e3
    fk["advect_bucket_public"] = {
        "ms": cuda_ms(torch, replay(adv_calls, fadk.advect_blend), 5)
        / len(adv_calls), "timed_by": "events",
        "plain_ms": fk["advect_bucket"]["plain_ms"],
        "bound_ms": max(pub_b_ms, pub_o_ms),
        "bound_by": "bytes" if pub_b_ms >= pub_o_ms else "operations"}
    print(f"advect_bucket public form: "
          f"{fk['advect_bucket_public']['ms'] * 1e3:.1f} us/launch (bound "
          f"{fk['advect_bucket_public']['bound_ms'] * 1e3:.1f} us, "
          f"{fk['advect_bucket_public']['bound_by']}; P {P}, {live} live, "
          "invalid slots copied through)", flush=True)
    # the developed bench dam's full-mode (ghost-fluid) solve: rhs and A0-Ak
    # in, p out, against its iterations x 24 flops per cell
    (cg_args, cg_kw), = dev_calls["cg_solve"]
    bench_it = int(prk.cg_solve(*cg_args, **cg_kw)[1])
    unit = str(bool(cg_kw.get("unit_stencil", False))).lower()
    time_kernel("cg_solve_bench", f"cg_kernel<{unit}>", dev_calls["cg_solve"],
                prk.cg_solve, prs.cg_plain, 6 * 4 * T, bench_it * 24 * T,
                f"bench dam developed solve, {bench_it} it")
    fk["cg_solve_bench"]["iterations"] = bench_it
    fk["cg_solve_bench"]["ms_per_iteration"] = (
        fk["cg_solve_bench"]["ms"] / max(bench_it, 1))

    # -- 8. FLIP port on the card vs the port on the CPU -------------------
    sdom = Domain(size=(24,) * 3)

    def card_vs_cpu(name, params_, obstacle=None, ppc=10):
        """3 steps at 24^3 on the card and on the CPU: flags and particle
        counts exact, grids to abs 2e-4."""
        runs = []
        for d_ in (dev, "cpu"):
            s_ = flip.make_dam_state_bucketed(sdom, params_, ppc=ppc,
                                              obstacle=obstacle, device=d_)
            for _ in range(3):
                s_ = flip.flip_step_bucketed(s_, sdom, params_)
            runs.append(s_)
        f_gpu, f_cpu = runs
        require(torch.equal(f_gpu.flags.cpu(), f_cpu.flags),
                f"24^3 {name} card vs CPU: flags differ")
        require(int(f_gpu.buckets.count()) == int(f_cpu.buckets.count()),
                f"24^3 {name} card vs CPU: particle counts differ")
        require(int(f_gpu.buckets.dropped) == 0,
                f"24^3 {name}: particles dropped")
        fv_err = float((f_gpu.vel.cpu() - f_cpu.vel).abs().max())
        fphi_err = float((f_gpu.phi.cpu() - f_cpu.phi).abs().max())
        require(fv_err < 2e-4 and fphi_err < 2e-4,
                f"24^3 {name} card vs CPU: vel {fv_err}, phi {fphi_err}")
        print(f"24^3 {name} x3 steps, card vs CPU: vel {fv_err:.3g}, phi "
              f"{fphi_err:.3g}", flush=True)

    card_vs_cpu("FLIP", fparams)
    del fst, dev_calls

    # -- 9. path A: the bench dam without ghost fluid ----------------------
    # scenes/flip01_simple.py's solve (no particle levelset): the transfer
    # kernel alone, the CG on the plain system, no levelset layers
    params_a = flip.FlipParams(gravity=(0.0, -0.003, 0.0), ghost_fluid=False,
                               cg_accuracy=1e-3, ring_only_obstacles=True)
    per_step_a = {"advect_bucket": 1, "rebin_fused": 1, "p2g_mac": 1,
                  "extrap_layer": 6, "cg_solve": 1}
    a_numbers, a_state, a_launches = drive_flip("flip01", params_a,
                                                per_step_a)
    require(a_numbers["particles"] == flip_numbers["particles"],
            "flip01: not the bench dam's particles")

    # -- 10. path B: the dam with an obstacle and a wide particle radius ---
    # the flip06_obstacle.py pattern at scenes/flip03_gen.py's radius: the
    # advection on its flags-at-position probes, the transfer kernel, the
    # levelset kernel at rw = 3, the ghost-fluid CG, then the blend kernel
    params_b = flip.FlipParams(gravity=(0.0, -0.003, 0.0), ghost_fluid=True,
                               radius_factor=2.5, cg_accuracy=1e-3)
    require(fb.levelset_radius(fdom, params_b.radius_factor)[1] == 3,
            "path B: the levelset window is not 3 cells")
    obstacle_b = Sphere(center=(FLIP_RES * 0.7, FLIP_RES * 0.28,
                                FLIP_RES * 0.5), radius=FLIP_RES * 0.15)
    per_step_b = {"advect_bucket": 1, "rebin_fused": 1, "p2g_mac": 1,
                  "union_levelset": 1, "extrap_layer": 10, "cg_solve": 1}
    b_numbers, b_state, b_launches = drive_flip(
        "obstacle", params_b, per_step_b, obstacle=obstacle_b, finalize=True)
    n_obs = int(fl.is_obstacle(b_state.flags)[1:-1, 1:-1, 1:-1].sum())
    require(n_obs > 0.01 * fdom.num_cells,
            f"obstacle: {n_obs} interior obstacle cells")

    # -- 11. the new kernels vs their plain versions on the card -----------
    new_kinds = ("p2g_mac", "union_levelset", "flip_blend")
    obstacle_err = 0.0
    path_calls = {}
    for name, params_, obstacle, developed in (
            ("flip01", params_a, None, a_state),
            ("obstacle", params_b, obstacle_b, b_state)):
        cold = flip.make_dam_state_bucketed(fdom, params_, ppc=10,
                                            obstacle=obstacle, device=dev)
        for _ in range(3):
            cold = flip.flip_step_bucketed(cold, fdom, params_)
        for st_, what in ((cold, "cold"), (developed, "developed")):
            calls = record_step(st_, params_)
            (args, _), = calls["p2g_mac"]
            bk_ = args[0]
            errs["p2g_mac"] = max(errs["p2g_mac"],
                                  check_call("p2g_mac", args, {}))
            if params_.ghost_fluid:
                require(len(calls["union_levelset"]) == 1
                        and not calls["p2g_levelset"],
                        f"{name}: levelset route")
                for rf in (1.0, 1.5, 2.5):
                    errs["union_levelset"] = max(
                        errs["union_levelset"],
                        check_call("union_levelset", (bk_, fdom, rf), {}))
            else:
                require(not calls["union_levelset"]
                        and not calls["p2g_levelset"],
                        f"{name}: a levelset kernel ran")
            errs["flip_blend"] = max(errs["flip_blend"], check_call(
                "flip_blend", (st_.buckets, st_.vel, st_.vel_old,
                               fparams.flip_ratio, fdom), {}))
            # the advection on this path's own inputs (path B: its
            # flags-at-position obstacle probes at 128^3)
            (args, kwargs), = calls["advect_bucket"]
            e = check_call("advect_bucket", args, kwargs)
            errs["advect_bucket"] = max(errs["advect_bucket"], e)
            if obstacle is not None:
                require(kwargs.get("ring_only") is False,
                        "obstacle: the advection ran on the bounds test")
                obstacle_err = max(obstacle_err, e)
            for args, kwargs in calls["cg_solve"]:
                rhs, stencil, dom_, acc, max_iter = args
                errs["cg_solve"] = max(errs["cg_solve"], cg_check(
                    rhs, stencil, kwargs["fluid"], acc, max_iter, dom_,
                    units=(False,)))
            print(f"{name} {FLIP_RES}^3 {what} step (PPC {bk_.ppc}), kernels "
                  "vs plain: " + ", ".join(
                      f"{k} {errs[k]:.3g}" for k in new_kinds
                      + ("advect_bucket", "cg_solve")), flush=True)
            path_calls[name] = (calls, st_)
        del cold
    # the 24^3 corner dam (cbk: made-up particle velocities)
    errs["p2g_mac"] = max(errs["p2g_mac"],
                          check_call("p2g_mac", (cbk, cdom), {}))
    for rf in (1.0, 1.5, 2.5):
        errs["union_levelset"] = max(
            errs["union_levelset"],
            check_call("union_levelset", (cbk, cdom, rf), {}))
    # made-up gap-free buckets over 19x23x29, which no brick of the levelset
    # kernel divides: 1 slot, 24, and 40 (five staged chunks of 8)
    odom = Domain(size=(19, 23, 29))
    for ppc in (1, 24, 40):
        obk_ = synthetic_buckets(odom, ppc, np.random.default_rng(ppc), dev)
        for rf in (1.0, 1.5, 2.5):
            errs["union_levelset"] = max(
                errs["union_levelset"],
                check_call("union_levelset", (obk_, odom, rf), {}))
    del obk_
    errs["flip_blend"] = max(errs["flip_blend"], check_call(
        "flip_blend", (cbk, cvel, cvel * 0.85, fparams.flip_ratio, cdom),
        {}))
    # finalize, then a step with nothing pending, moves the particles and
    # sets their velocities as a step with the blend pending does
    pend_step = flip.flip_step_bucketed(b_state, fdom, params_b)
    fin_step = flip.flip_step_bucketed(
        flip.finalize_buckets(b_state, fdom, params_b), fdom, params_b)
    for f in ("px", "py", "pz", "vx", "vy", "vz", "valid"):
        require(torch.equal(getattr(pend_step.buckets, f),
                            getattr(fin_step.buckets, f)),
                f"finalize then step vs pending step: {f} differs")
    del pend_step, fin_step
    print("new kernels vs plain, 128^3 steps and 24^3 corner dam: "
          + ", ".join(f"{k} {errs[k]:.3g}" for k in new_kinds)
          + f"; advect_bucket with the obstacle {obstacle_err:.3g}; "
          "finalize+step equals the pending step bitwise", flush=True)

    # times on the developed steps' inputs: the transfer on path A's, the
    # levelset (rw = 3) and the blend on path B's. Least bytes: the valid
    # bytes valid_bytes_read counts and the needed fields of the live
    # particles; the transfer writes six grids, the levelset one; the blend
    # reads every slot's velocity and writes it (invalid slots pass
    # through) and reads two MAC grids. Operations on the live particles: the transfer ~270
    # (3 components x 18 taps x 5), the levelset ~10 per source cell of the
    # (2 rw + 1)^3 window, the blend ~230 (two grids x three 8-corner
    # interpolations and the mix).
    T = fdom.num_cells
    for name, kind in (("flip01", "p2g_mac"),
                       ("obstacle", "p2g_mac_obstacle")):
        calls, st_ = path_calls[name]
        P, live = st_.buckets.ppc, int(st_.buckets.valid.sum())
        time_kernel(kind, "p2g_mac_kernel", calls["p2g_mac"], p2gk.p2g_mac,
                    fb.p2g_mac, valid_bytes_read(calls["p2g_mac"][0][0][0])
                    + 24 * live + 24 * T, 270 * live,
                    f"{name} developed, P {P}, {live} live")
    # calls, st_, P and live are the obstacle path's from here on
    what = f"obstacle developed, P {P}, {live} live"
    (ls_args, _), = calls["union_levelset"]
    for rf in (1.0, 1.5, 2.5):
        rw = fb.levelset_radius(fdom, rf)[1]
        time_kernel("union_levelset" if rw == 3 else f"union_levelset_rw{rw}",
                    f"union_levelset_kernel<{rw}>",
                    [((ls_args[0], fdom, rf), {})],
                    lsk.union_levelset, fb.union_levelset_bucketed,
                    valid_bytes_read(ls_args[0]) + 12 * live + 4 * T,
                    10 * (2 * rw + 1) ** 3 * live,
                    f"rw {rw}, {what}")
    time_kernel("flip_blend", "flip_blend_kernel",
                [((st_.buckets, st_.vel, st_.vel_old, fparams.flip_ratio,
                   fdom), {})], blk.flip_update, fb.flip_update_bucketed,
                24 * P * T + valid_bytes_read(st_.buckets) + 12 * live
                + 24 * T, 230 * live, what)
    del path_calls, a_state, b_state

    # -- 12. paths A and B on the card vs the port on the CPU ---------------
    card_vs_cpu("flip01", params_a)
    card_vs_cpu("obstacle", params_b, ppc=14, obstacle=Sphere(
        center=(24 * 0.7, 24 * 0.28, 12.0), radius=24 * 0.15))

    # -- 13. the z-sharded bench dam at 128^3 over ZSHARDS z-slabs ----------
    mesh = shd.make_zmesh(ZSHARDS, devices=[
        torch.device("cuda", i) for i in range(torch.cuda.device_count())])
    print(f"zshard mesh: {mesh.n} shards over {len(mesh.devices)} card(s): "
          + ", ".join(f"shard {i} on {mesh.device(i)}" for i in range(mesh.n)),
          flush=True)
    zstart = zshard_start
    del zshard_start

    def one_device(st):
        for _ in range(FLIP_CHUNK):
            st = flip.flip_step_bucketed(st, fdom, fparams)
        return st

    ref = one_device(zstart)
    rebinned = None
    if int(ref.buckets.dropped) != int(zstart.buckets.dropped):
        ppc = flip._next_ppc(zstart.buckets.ppc + 4,
                             fb.max_cell_occupancy(zstart.buckets, fdom))
        rebinned = ppc
        print(f"zshard: the one-device steps drop particles at PPC "
              f"{zstart.buckets.ppc}: both runs start rebinned at PPC {ppc}",
              flush=True)
        zstart = dataclasses.replace(
            zstart, buckets=fb.rebin_to_ppc(zstart.buckets, fdom, ppc))
        ref = one_device(zstart)
    require(int(ref.buckets.dropped) == int(zstart.buckets.dropped),
            "zshard: the one-device reference drops particles")
    n_parts = int(zstart.buckets.count())
    z_kernels = {**flip_kernels,
                 "advect_bucket_zshard": fadk.advect_blend_slab_live,
                 "advect_bucket_zshard_public": fadk.advect_blend_slab,
                 "p2g_levelset_zshard": p2gk.p2g_union_slab}
    z_per_step = {"advect_bucket_zshard": mesh.n, "rebin_fused_slab": mesh.n,
                  "p2g_levelset_zshard": mesh.n, "extrap_layer": 10,
                  "cg_solve": 1}
    sh0 = shd.shard_flip_bucket_state(zstart, mesh)
    flip.flip_step_bucketed(sh0, fdom, fparams, zshard=mesh)  # warm
    torch.cuda.synchronize()
    for fn in z_kernels.values():
        fn.launches = 0
    sh = sh0
    z_iters = torch.zeros((), dtype=torch.int64, device=dev)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(FLIP_CHUNK):
        sh = flip.flip_step_bucketed(sh, fdom, fparams, zshard=mesh)
        z_iters += sh.cg_iters
    t1.record()
    torch.cuda.synchronize()
    z_sps = FLIP_CHUNK / (t0.elapsed_time(t1) / 1e3)
    z_launches = {k: fn.launches for k, fn in z_kernels.items()}
    for k in z_kernels:
        want = z_per_step.get(k, 0) * FLIP_CHUNK
        require(z_launches[k] == want,
                f"zshard: {k} launched {z_launches[k]} times in "
                f"{FLIP_CHUNK} steps (expected {want})")
    require(int(sh.buckets.dropped) == 0 and int(ref.buckets.dropped) == 0,
            f"zshard: {int(sh.buckets.dropped)} particles dropped")
    require(int(sh.buckets.count()) == n_parts,
            f"zshard: {int(sh.buckets.count())} particles, had {n_parts}")
    # the same steps on one device: the same slots gathered in the same
    # order, so equal; else within the JAX sharded test's 2e-5
    whole = shd.unshard_buckets(sh.buckets)
    z_diff, z_exact = 0.0, True
    pairs = [(getattr(sh, k), getattr(ref, k), k)
             for k in ("flags", "vel", "vel_old", "pressure", "phi")]
    pairs += [(getattr(whole, f), getattr(ref.buckets, f), f)
              for f in ("px", "py", "pz", "vx", "vy", "vz", "valid")]
    for g, r, what in pairs:
        if torch.equal(g, r):
            continue
        z_exact = False
        require(g.dtype == torch.float32, f"zshard: {what} differs")
        z_diff = max(z_diff, float((g - r).abs().max()))
    require(z_diff <= 2e-5, f"zshard vs one device: max abs diff {z_diff}")
    del whole, pairs
    z_it = int(z_iters) / FLIP_CHUNK
    print(f"flip_zshard {FLIP_RES}^3 over {mesh.n} shards: {z_sps:.2f} "
          f"steps/s developed (PPC {zstart.buckets.ppc}, {n_parts} particles"
          f", CG {z_it:.1f} it/step), equal to the one-device steps: "
          f"{'exactly' if z_exact else f'max abs diff {z_diff:.3g}'}; "
          f"launches {z_launches}", flush=True)

    # every z-slab kernel call of one step against its plain version; the
    # halo copies of the step (halo_z, and the lead's scatter_z/gather_z).
    # The three-pass kernels are off the step's path: the step's rebin
    # input goes through them too (the slabs' x and y passes, K9), each
    # call recorded and held against its plain version, the result against
    # the step's rebin
    z_sites = {"advect_bucket_zshard": (fadk, "advect_blend_slab_live"),
               "rebin_fused_slab": (rbk, "rebin_fused_slab"),
               "rebin_zshard_step": (rbk, "rebin_zshard"),
               "p2g_levelset_zshard": (p2gk, "p2g_union_slab"),
               "halo_z": (shd, "halo_z"), "scatter_z": (shd, "scatter_z"),
               "gather_z": (shd, "gather_z")}
    three_sites = {"rebin": (rbk, "rebin_pass"),
                   "rebin_zshard": (rbk, "rebin_zpass_halo")}
    z_plain = {"advect_bucket_zshard": fadk.advect_blend_slab_plain,
               "rebin_fused_slab": fb.rebin_slab_plain,
               "rebin": fb._rebin_axis,
               "rebin_zshard": fb.rebin_zpass_halo_plain,
               "p2g_levelset_zshard": p2gk.p2g_union_slab_plain}
    z_wrappers = {**z_sites, **three_sites}
    zcalls = {k: [] for k in z_wrappers}
    with contextlib.ExitStack() as stack:
        for k, (mod, name) in z_sites.items():
            stack.enter_context(recording(mod, name, zcalls[k]))
        flip.flip_step_bucketed(sh, fdom, fparams, zshard=mesh)
    (z_rebin_args, _), = zcalls["rebin_zshard_step"]
    with contextlib.ExitStack() as stack:
        for k, (mod, name) in three_sites.items():
            stack.enter_context(recording(mod, name, zcalls[k]))
        z_three = rbk.rebin_zshard_three_pass(*z_rebin_args)
    bucket_err(shd.unshard_buckets(z_three),
               shd.unshard_buckets(rbk.rebin_zshard(*z_rebin_args)),
               exact=True)
    del z_three, z_rebin_args
    torch.cuda.synchronize()
    z_calls_want = {**z_per_step, "rebin": 2 * mesh.n, "rebin_zshard": mesh.n}
    for k in z_plain:
        require(len(zcalls[k]) == z_calls_want[k],
                f"zshard: {len(zcalls[k])} {k} calls in one step")
    for k, plain in z_plain.items():
        kernel = getattr(*z_wrappers[k])
        for args, kwargs in zcalls[k]:
            got, want = kernel(*args, **kwargs), plain(*args, **kwargs)
            if k == "p2g_levelset_zshard":
                for g, r, tol in zip(got, want, (1e-5, 1e-5, 1e-6)):
                    e = float((g - r).abs().max())
                    require(e <= tol, f"{k}: max abs err {e}")
                    errs[k] = max(errs.get(k, 0.0), e)
                continue
            if k == "advect_bucket_zshard":
                e = advect_err(got, want, args[0], fadk.advect_blend_slab(
                    *args, **kwargs))
            else:
                e = bucket_err(got, want, exact=True)
            errs[k] = max(errs.get(k, 0.0), e)
    # the sharded rebin reads the advected slabs' live slots alone
    (z_rebin_args, _), = zcalls["rebin_zshard_step"]
    z_sbk = z_rebin_args[0]
    bucket_err(shd.unshard_buckets(rbk.rebin_zshard(dataclasses.replace(
        z_sbk, slabs=[poisoned(b) for b in z_sbk.slabs]),
        *z_rebin_args[1:])), shd.unshard_buckets(
        rbk.rebin_zshard(*z_rebin_args)), exact=True)
    poison_checks.append(f"rebin_zshard {mesh.n} shards")
    del z_rebin_args, z_sbk
    # the boundary-crossing fixture of tests/test_flip_sharded.py:145-162
    # at 8 shards: particles displaced across the slab faces, overflow
    xdom = Domain(size=(16,) * 3)
    xbk = flip.make_dam_state_bucketed(
        xdom, flip.FlipParams(gravity=(0.0, -0.003, 0.0), ghost_fluid=True),
        ppc=12, device=dev).buckets
    xd = np.random.default_rng(7).uniform(
        -0.9, 0.9, size=(3,) + tuple(xbk.px.shape)).astype(np.float32)
    xbk = dataclasses.replace(xbk, **{
        f: torch.clamp(getattr(xbk, f) + torch.where(
            xbk.valid, torch.tensor(xd[i], device=dev), 0.0), 1.01, 14.99)
        for i, f in enumerate(("px", "py", "pz"))})
    xmesh = shd.make_zmesh(8, devices=mesh.devices)
    xlocal = Domain(size=(16, 16, 2))
    xsbk = shd.shard_buckets(xbk, xmesh)
    xslabs = []
    for i, b in enumerate(xsbk.slabs):
        for axis in (0, 1):
            b = rbk.rebin_pass(b, xlocal, axis, z_base=2 * i)
        xslabs.append(b)
    for i, e in enumerate(rbk.halo_buckets(xslabs, 1, xlocal)):
        bucket_err(rbk.rebin_zpass_halo(e, xlocal, 2 * i, 16),
                   fb.rebin_zpass_halo_plain(e, xlocal, 2 * i, 16), exact=True)
    for i, e in enumerate(rbk.halo_buckets(xsbk.slabs, 1, xlocal)):
        bucket_err(rbk.rebin_fused_slab(e, xlocal, 2 * i, 16),
                   fb.rebin_slab_plain(e, xlocal, 2 * i, 16), exact=True)
    xref = fb.rebin(xbk, xdom)
    for rebin_sharded in (rbk.rebin_zshard, rbk.rebin_zshard_three_pass):
        xgot = shd.unshard_buckets(rebin_sharded(xsbk, xdom, xmesh))
        bucket_err(xgot, xref, exact=True)
    require(int(xgot.dropped) > 0, "crossing fixture: no overflow")
    print(f"zshard kernels vs plain on the step's calls: "
          + ", ".join(f"{k} {errs[k]:.3g}" for k in z_plain)
          + f"; the slab rebin (fused and three passes) on the 8-shard "
          f"crossing fixture bitwise, {int(xgot.dropped)} dropped as "
          "fb.rebin", flush=True)
    del xbk, xsbk, xgot, xslabs, xref

    # times per launch on the step's inputs; the bounds of the slab rebin
    # and of the z pass are counted as the rebin pass's: the valid bytes
    # valid_bytes_read counts in the input (the halo planes too), the six
    # fields of the live particles, every output slot
    zk = {}
    zP = sh.buckets.ppc
    t_slab = fdom.num_cells // mesh.n
    z_live = sum(int(s.valid.sum()) for s in sh.buckets.slabs) / mesh.n
    for k, kname, nbytes, nops in (
            ("rebin_fused_slab", "rebin_fused_kernel<true>",
             mean_valid_bytes(zcalls["rebin_fused_slab"]) + 25 * zP * t_slab
             + 24 * z_live, 30 * z_live),
            ("rebin_zshard", "rebin_zshard_kernel",
             mean_valid_bytes(zcalls["rebin_zshard"]) + 25 * zP * t_slab
             + 24 * z_live, 10 * z_live),
            ("advect_bucket_zshard", "advect_live_kernel<true>",
             advect_bytes(zcalls["advect_bucket_zshard"],
                          t_slab + 4 * FLIP_RES ** 2,
                          fparams.ring_only_obstacles), 620 * z_live),
            ("p2g_levelset_zshard", "p2g_levelset_zshard_kernel",
             mean_valid_bytes(zcalls["p2g_levelset_zshard"]) + 24 * z_live
             + 28 * t_slab, 540 * z_live)):
        calls = zcalls[k]
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        o_ms = nops / FP32_OPS_PER_S * 1e3
        ms, call_ms, timed_by = timed_launches(
            torch, replay(calls, getattr(*z_wrappers[k])), 5, kname, len(calls))
        zk[k] = {"ms": ms, "call_ms": call_ms, "timed_by": timed_by,
                 "plain_ms": cuda_ms(torch, replay(calls, z_plain[k]), 1)
                 / len(calls),
                 "bound_ms": max(b_ms, o_ms),
                 "bound_by": "bytes" if b_ms >= o_ms else "operations"}
        print(f"{k}: {zk[k]['ms'] * 1e3:.1f} us/launch at {mesh.n} shards "
              f"(bound {zk[k]['bound_ms'] * 1e3:.1f} us, "
              f"{zk[k]['bound_by']}), plain {zk[k]['plain_ms']:.2f} ms",
              flush=True)
    # the public slab form (invalid slots copied through) on the same
    # inputs, CUDA events, against its every-slot bound
    z_adv = zcalls["advect_bucket_zshard"]
    zk["advect_bucket_zshard"]["public_form"] = {
        "ms": cuda_ms(torch, replay(z_adv, fadk.advect_blend_slab), 5)
        / len(z_adv), "timed_by": "events",
        "bound_ms": advect_bytes(z_adv, t_slab + 4 * FLIP_RES ** 2,
                                 fparams.ring_only_obstacles,
                                 every_slot=True) / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes"}
    print(f"advect_bucket_zshard public form: "
          f"{zk['advect_bucket_zshard']['public_form']['ms'] * 1e3:.1f} "
          f"us/launch (bound "
          f"{zk['advect_bucket_zshard']['public_form']['bound_ms'] * 1e3:.1f}"
          " us)", flush=True)
    halo_ms = {k: cuda_ms(torch, replay(zcalls[k], getattr(*z_sites[k])), 5)
               for k in ("halo_z", "scatter_z", "gather_z")}
    print("zshard copies per step (ms): " + ", ".join(
        f"{k} {v:.3f} ({len(zcalls[k])} calls)" for k, v in halo_ms.items()),
        flush=True)
    del zcalls, sh, sh0, ref, zstart

    # 3 steps at 16^3 over 8 shards on the card against the CPU
    xruns = []
    for d_ in (dev, "cpu"):
        s_ = flip.make_dam_state_bucketed(xdom, fparams, ppc=10, device=d_)
        m_ = shd.make_zmesh(8, devices=mesh.devices if d_ is dev else [d_])
        s_ = shd.shard_flip_bucket_state(s_, m_)
        for _ in range(3):
            s_ = flip.flip_step_bucketed(s_, xdom, fparams, zshard=m_)
        xruns.append(s_)
    x_gpu, x_cpu = xruns
    require(torch.equal(x_gpu.flags.cpu(), x_cpu.flags),
            "16^3 zshard card vs CPU: flags differ")
    require(int(x_gpu.buckets.count()) == int(x_cpu.buckets.count()),
            "16^3 zshard card vs CPU: particle counts differ")
    require(int(x_gpu.buckets.dropped) == 0, "16^3 zshard: particles dropped")
    xv = float((x_gpu.vel.cpu() - x_cpu.vel).abs().max())
    xp = float((x_gpu.phi.cpu() - x_cpu.phi).abs().max())
    require(xv < 2e-4 and xp < 2e-4,
            f"16^3 zshard card vs CPU: vel {xv}, phi {xp}")
    print(f"16^3 zshard x3 steps over 8 shards, card vs CPU: vel {xv:.3g}, "
          f"phi {xp:.3g}", flush=True)
    zshard_numbers = {
        "steps_per_s_developed": z_sps, "cg_iters_per_step_developed": z_it,
        "particles": n_parts, "ppc": zP, "rebinned_to_ppc": rebinned,
        "shards": mesh.n, "devices": [str(d) for d in mesh.devices],
        "equal_to_one_device": z_exact, "max_abs_diff_one_device": z_diff,
        "launches_per_step": z_per_step, "copies_ms_per_step": halo_ms,
        "card_vs_cpu_16": {"vel": xv, "phi": xp}}

    # -- 14-15. the flat-layout FLIP and APIC dams at 128^3 -----------------
    # the particles as (N, 3) tensors, their transfers PyTorch's scatters
    # and gathers; per step 10 K14 launches and 1 K2 and nothing else
    every_kernel = {**flip_kernels, "window_advect": advk.window_pass,
                    "advect_bucket_zshard": fadk.advect_blend_slab_live,
                    "advect_bucket_zshard_public": fadk.advect_blend_slab,
                    "p2g_levelset_zshard": p2gk.p2g_union_slab}
    flat_per_step = {"extrap_layer": 10, "cg_solve": 1}
    flat_sites = {k: sites[k] for k in flat_per_step}

    def flat_checks(name, st, n_parts):
        """No particle lost, every field finite, every active particle in
        [0, n) on every axis."""
        active = st.parts.active_mask()
        require(int(active.sum()) == n_parts,
                f"{name}: {int(active.sum())} active particles, had "
                f"{n_parts}")
        for field in ("vel", "vel_old", "pressure", "phi", "pvel", "cpx",
                      "cpy", "cpz"):
            require(bool(torch.isfinite(getattr(st, field)).all()),
                    f"{name}: {field} not finite")
        pos = st.parts.pos[active]
        require(bool(torch.isfinite(pos).all()) and bool((pos >= 0).all())
                and bool((pos < FLIP_RES).all()),
                f"{name}: a position outside [0, {FLIP_RES})")

    def drive_flat(name, params_, windows):
        """A flat dam at 128^3 set up by make_dam_state (bench.py:37-40), 1
        warm step, then for each (pre, n) of ``windows`` pre untimed steps
        (flip_run) and n timed ones (CUDA events). Every kernel's count is
        set to 0 just before the warm step and read after the last; the
        launches per step, the particles and the fields are checked.
        Returns the run's numbers, the state after the warm step (the cold
        inputs) and the last state, and the launches."""
        t0 = time.perf_counter()
        st = flip.make_dam_state(fdom, params_, discretization=2, device=dev)
        n_parts = int(st.parts.count)
        setup_s = time.perf_counter() - t0
        require(n_parts == flip_numbers["particles"],
                f"{name}: {n_parts} particles, the bucketed dam has "
                f"{flip_numbers['particles']}")
        require(st.parts.capacity == -(-int(n_parts * 1.02) // 1024) * 1024,
                f"{name}: capacity {st.parts.capacity}")
        torch.cuda.synchronize()
        for fn in every_kernel.values():
            fn.launches = 0
        st = flip.flip_step(st, fdom, params_)  # warm
        cold_state, n_steps, timed_ = st, 1, []
        for pre, n in windows:
            st = flip.flip_run(st, fdom, params_, pre)
            iters = torch.zeros((), dtype=torch.int64, device=dev)
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(n):
                st = flip.flip_step(st, fdom, params_)
                iters += st.cg_iters
            t1.record()
            torch.cuda.synchronize()
            timed_.append((t0.elapsed_time(t1) / n, int(iters) / n))
            n_steps += pre + n
        launches = {k: fn.launches for k, fn in every_kernel.items()}
        for k, got in launches.items():
            want = flat_per_step.get(k, 0) * n_steps
            require(got == want, f"{name}: {k} launched {got} times in "
                    f"{n_steps} steps (expected {want})")
        flat_checks(name, st, n_parts)
        require(int(st.ts.count) == n_steps, f"{name}: ts.count")
        (cold_ms, cold_it), (dev_ms, dev_it) = timed_[0], timed_[-1]
        print(f"{name} {FLIP_RES}^3: {n_steps} steps, {n_parts} particles "
              f"(capacity {st.parts.capacity}), {cold_ms:.2f} ms/step cold, "
              f"{dev_ms:.2f} developed, CG {cold_it:.1f} / {dev_it:.1f} "
              f"it/step, launches {launches}", flush=True)
        numbers = {"ms_per_step_cold": cold_ms, "ms_per_step_developed":
                   dev_ms, "steps_per_s_cold": 1e3 / cold_ms,
                   "steps_per_s_developed": 1e3 / dev_ms,
                   "cg_iters_per_step_cold": cold_it,
                   "cg_iters_per_step_developed": dev_it,
                   "particles": n_parts, "capacity": st.parts.capacity,
                   "steps_run": n_steps, "launches_per_step": flat_per_step,
                   "setup_s": setup_s}
        return numbers, cold_state, st, launches

    def cg_check_by_residual(rhs, stencil, fluid, acc, max_iter, dom_,
                             early=10):
        """K2 against cg_plain on a flat step's system. The max-norm
        residual of these solves hovers near the accuracy for tens of
        iterations before it exits, so rounding anywhere moves the exit
        iteration (the float64 CG's too) and with it the pressure, by up
        to a few per cent at equal iteration counts past ~20 (measured by
        tools/profile_cg_exit.py). So: after ``early``
        iterations with no exit the two pressures must agree to rel 1e-5
        (the arithmetic is the same); each solve must exit on its residual
        or at max_iter; and the true residual of each pressure, max|rhs -
        A p| over the fluid cells in float64, must lie below the accuracy,
        with 1 % for the drift of the updated residual from the true one.
        Returns the max abs error after ``early`` iterations."""
        st64 = tuple(a.double() for a in stencil)
        n = min(early, max_iter)
        pk, nk, _ = prk.cg_solve(rhs, stencil, dom_, 0.0, n, fluid=fluid)
        pp, np_, _ = prs.cg_plain(rhs, stencil, dom_, 0.0, n, fluid)
        require(int(nk) == int(np_) == n,
                f"cg_solve: {int(nk)} and {int(np_)} of {n} iterations")
        err = float((pk - pp).abs().max())
        rel = err / (float(pp.abs().max()) + 1e-30)
        require(rel < 1e-5, f"cg_solve at {n} iterations: rel err {rel}")
        exits = []
        for who, (p_, it, rn) in (
                ("kernel", prk.cg_solve(rhs, stencil, dom_, acc, max_iter,
                                        fluid=fluid)),
                ("plain", prs.cg_plain(rhs, stencil, dom_, acc, max_iter,
                                       fluid))):
            it = int(it)
            require(it == max_iter or float(rn) < acc,
                    f"cg_solve ({who}) exited at resnorm {float(rn)}")
            r64 = rhs.double() - prs._apply_stencil(p_.double(), st64, dom_)
            true_rn = float(torch.where(fluid, r64, 0.0).abs().max())
            require(it == max_iter or true_rn < 1.01 * acc,
                    f"cg_solve ({who}): true residual {true_rn} at exit")
            exits.append(f"{it} it, true residual {true_rn:.4g}")
        print(f"cg_solve {dom_.shape}: rel err {rel:.3g} at {n} it; kernel "
              f"exits at {exits[0]}, plain at {exits[1]}", flush=True)
        return err

    def flat_kernel_check(name, st, params_, what):
        """K14 and K2 against their plain versions on every call of one
        flat step from ``st``: the layers exact, the CG by
        cg_check_by_residual."""
        calls = {k: [] for k in flat_sites}
        with contextlib.ExitStack() as stack:
            for k, (mod, fname) in flat_sites.items():
                stack.enter_context(recording(mod, fname, calls[k]))
            flip.flip_step(st, fdom, params_)
        torch.cuda.synchronize()
        for k, n in flat_per_step.items():
            require(len(calls[k]) == n,
                    f"{name}: {len(calls[k])} {k} calls in one step")
        for args, kwargs in calls["extrap_layer"]:
            errs["extrap_layer"] = max(errs["extrap_layer"], check_call(
                "extrap_layer", args, kwargs))
        for args, kwargs in calls["cg_solve"]:
            rhs, stencil, dom_, acc, max_iter = args
            errs["cg_solve"] = max(errs["cg_solve"], cg_check_by_residual(
                rhs, stencil, kwargs["fluid"], acc, max_iter, dom_))
        print(f"{name} {FLIP_RES}^3 {what} step, kernels vs plain: "
              f"extrap_layer {errs['extrap_layer']:.3g}, cg_solve "
              f"{errs['cg_solve']:.3g}", flush=True)
        return calls

    flat_params = flip_bench_params(flip)
    apic_params = dataclasses.replace(flat_params, apic=True)
    flat_numbers, flat_cold, flat_last, flat_launches = drive_flat(
        "flat", flat_params, [(0, FLIP_CHUNK), (20, FLIP_CHUNK)])
    flat_kernel_check("flat", flat_cold, flat_params, "cold")
    flat_calls = flat_kernel_check("flat", flat_last, flat_params,
                                   "developed")
    del flat_cold, flat_last
    # K2 and K14 on the developed flat step's inputs
    (cg_args, cg_kw), = flat_calls["cg_solve"]
    flat_it = int(prk.cg_solve(*cg_args, **cg_kw)[1])
    T = fdom.num_cells
    time_kernel("cg_solve_flat", "cg_kernel<false>", flat_calls["cg_solve"],
                prk.cg_solve, prs.cg_plain, 6 * 4 * T, flat_it * 24 * T,
                f"flat dam developed solve, {flat_it} it")
    fk["cg_solve_flat"]["iterations"] = flat_it
    # the bytes and operations of phase 7's layers
    layer_calls = flat_calls["extrap_layer"]
    pairs = sum(len(a[0]) for a, _ in layer_calls) / len(layer_calls)
    time_kernel("extrap_layer_flat", "extrap_layer_kernel", layer_calls,
                xk.extrap_layer, xk.extrap_layer_plain, pairs * 16 * T,
                pairs * 20 * T, "flat dam developed step's layers")
    del flat_calls, layer_calls, cg_args, cg_kw

    apic_numbers, apic_cold, apic_last, apic_launches = drive_flat(
        "apic", apic_params, [(0, FLIP_CHUNK), (20, FLIP_CHUNK)])
    require(bool((apic_last.cpx != 0).any()), "apic: the affine rows are 0")
    flat_kernel_check("apic", apic_cold, apic_params, "cold")
    flat_kernel_check("apic", apic_last, apic_params, "developed")
    del apic_cold, apic_last

    # -- 16. the flat dams on the card vs the port on the CPU ---------------
    def flat_card_vs_cpu(name, params_, obstacle=None):
        """3 steps at 24^3 on the card and on the CPU: flags, particle
        flags and counts exact, grids to abs 2e-4, particles to 1e-4."""
        g_, c_ = (flip.flip_run(flip.make_dam_state(
            sdom, params_, obstacle=obstacle, device=d_), sdom, params_, 3)
            for d_ in (dev, "cpu"))
        for what, a_, b_ in (("flags", g_.flags, c_.flags),
                             ("particle flags", g_.parts.flags,
                              c_.parts.flags),
                             ("count", g_.parts.count, c_.parts.count),
                             ("ts.count", g_.ts.count, c_.ts.count)):
            require(torch.equal(a_.cpu(), b_),
                    f"24^3 {name} card vs CPU: {what} differ")
        gerr = max(float((getattr(g_, k).cpu() - getattr(c_, k)).abs().max())
                   for k in ("vel", "vel_old", "pressure", "phi"))
        perr = max(float((a_.cpu() - b_).abs().max()) for a_, b_ in (
            (g_.parts.pos, c_.parts.pos), (g_.pvel, c_.pvel),
            (g_.cpx, c_.cpx), (g_.cpy, c_.cpy), (g_.cpz, c_.cpz)))
        require(gerr < 2e-4 and perr < 1e-4,
                f"24^3 {name} card vs CPU: grids {gerr}, particles {perr}")
        print(f"24^3 {name} x3 steps, card vs CPU: grids {gerr:.3g}, "
              f"particles {perr:.3g}", flush=True)
        return {"grids": gerr, "particles": perr}

    flat_card_cpu = {
        "flat": flat_card_vs_cpu("flat", flat_params),
        "apic": flat_card_vs_cpu("apic", apic_params),
        "flat_obstacle": flat_card_vs_cpu("flat obstacle", params_b, Sphere(
            center=(24 * 0.7, 24 * 0.28, 12.0), radius=24 * 0.15))}
    flat_numbers["card_vs_cpu_24"] = flat_card_cpu

    flip_paths = {"flip_128": flip_launches, "flip01_128": a_launches,
                  "obstacle_128": b_launches, "flip_zshard_128": z_launches,
                  "flat_128": flat_launches, "apic_128": apic_launches}
    kernels = [
        {"name": "window_advect", "route": "cuda",
         "source": "mantaflow_tpu_torch/csrc/window_advect.cu",
         "replaces": "mantaflow_tpu/ops/advection_pallas.py:284",
         "launches": launches["window_advect"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms,
         "bound_ms": max(k1_bound_bytes, k1_bound_ops),
         "bound_by": "bytes" if k1_bound_bytes >= k1_bound_ops
         else "operations", "library_ms": None, "call_ms": k1_call_ms,
         "timed_by": k1_timed_by},
        {"name": "cg_solve", "route": "cuda",
         "source": "mantaflow_tpu_torch/csrc/cg_solve.cu",
         "replaces": "mantaflow_tpu/ops/pressure_pallas.py:88",
         "launches": launches["cg_solve"] + sum(
             v["cg_solve"] for v in flip_paths.values()),
         "max_abs_err": max(k2_err, errs["cg_solve"]),
         "ms": k2_ms, "plain_ms": k2_plain_ms,
         "bound_ms": max(k2_bound_bytes, k2_bound_ops),
         "bound_by": "bytes" if k2_bound_bytes >= k2_bound_ops
         else "operations", "library_ms": None,
         "call_ms": k2_call_ms, "timed_by": k2_timed_by, "iterations": k2_it,
         "launches_by_path": {"smoke_128": launches["cg_solve"],
                              **{k: v["cg_solve"]
                                 for k, v in flip_paths.items()}},
         "ms_per_iteration": k2_ms / max(k2_it, 1),
         "iteration_floor": k2_iter_floor,
         "bench_dam_solve": fk["cg_solve_bench"],
         "flat_dam_solve": fk["cg_solve_flat"]},
    ]
    fbp = "mantaflow_tpu/ops/flip_bucket_pallas.py"
    # the TPU kernel replaced, and (rebin) the others of the same function
    flip_replaces = {
        "advect_bucket": [f"{fbp}:80"],
        "rebin_fused": [f"{fbp}:1079"],
        "rebin": [f"{fbp}:{n}" for n in (744, 301, 433, 482)],
        "p2g_levelset": ["mantaflow_tpu/ops/flip_bucket_pallas2.py:408"],
        "extrap_layer": ["mantaflow_tpu/ops/extrapolation_pallas.py:45"]}
    fbp2 = "mantaflow_tpu/ops/flip_bucket_pallas2.py"
    flip_replaces.update({"p2g_mac": [f"{fbp2}:75"],
                          "union_levelset": [f"{fbp2}:197"],
                          "flip_blend": [f"{fbp2}:299"]})
    for kind, (repl, *also) in flip_replaces.items():
        by_path = {k: v[kind] for k, v in flip_paths.items()}
        entry = {
            "name": kind, "route": "cuda",
            "source": f"mantaflow_tpu_torch/csrc/{kind}.cu",
            "replaces": repl, "also_replaces": also,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": errs[kind], "library_ms": None, **fk[kind]}
        if kind == "p2g_mac":
            entry["obstacle_path"] = fk["p2g_mac_obstacle"]
        if kind == "union_levelset":
            entry["narrower_windows"] = {rw: fk[f"union_levelset_rw{rw}"]
                                         for rw in (1, 2)}
        if kind == "advect_bucket":
            entry["max_abs_err_with_obstacle"] = obstacle_err
            entry["public_form"] = fk["advect_bucket_public"]
            entry["poison_checks"] = poison_checks
        if kind == "extrap_layer":
            entry["flat_path"] = fk["extrap_layer_flat"]
        kernels.append(entry)
    # the z-slab kernels: the slab rebin, K9, and the z-slab forms of K3
    # and K10, each its own __global__ function or template instance (in
    # the one-domain kernel's source for the slab rebin, K3 and K10)
    z_sources = {"advect_bucket_zshard": ("advect_bucket", f"{fbp}:80"),
                 "rebin_fused_slab": ("rebin_fused", f"{fbp}:1310"),
                 "rebin_zshard": ("rebin_zshard", f"{fbp}:1310"),
                 "p2g_levelset_zshard": ("p2g_levelset", f"{fbp2}:408")}
    for name, (src, repl) in z_sources.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"mantaflow_tpu_torch/csrc/{src}.cu",
            "replaces": repl, "launches": z_launches[name],
            "launches_by_path": {k: v.get(name, 0)
                                 for k, v in flip_paths.items()},
            "max_abs_err": errs[name], "library_ms": None, **zk[name]})
    print(card)
    print(json.dumps({
        "smoke_128": {"steps_per_s_cold": cold_sps,
                      "steps_per_s_developed": dev_sps,
                      "cg_iters_per_step_cold": cold_it,
                      "cg_iters_per_step_developed": dev_it,
                      "density_max": dmax},
        "flip_128": flip_numbers, "flip01_128": a_numbers,
        "obstacle_128": b_numbers, "flip_zshard_128": zshard_numbers,
        "flat_128": flat_numbers, "apic_128": apic_numbers,
        "build_s": build_s, "total_s": time.perf_counter() - t_start}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
