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
   obstacle on the card against the CPU, 3 steps at 24^3;
17. the exact-gather smoke (the bench configuration with window 0 and
   clamp mode 2, the JAX package's default advection) at 128^3: 1 warm
   step, 10 timed, 30 more, 10 timed, no window kernel and one CG per
   step; the CG kernel against the plain CG on a developed step's system,
   as phase 4 holds it;
18. the bench smoke with PcMGStatic at 128^3 (bench.py's BENCH_SMOKE_PC=mg:
   V-cycles and a CG tail, no CG kernel, 8 window passes a step): 1 warm
   step, 10 timed, 10 more, 10 timed, with the V-cycles, CG-tail
   iterations and host reads per step; the hierarchy built once; the
   post-projection divergence under the JAX package's bound; 5 PcMGDynamic
   steps equal to 5 PcMGStatic steps bit for bit; 10 PcMIC steps (one CG
   with 12 times PcNone's budget), each equal to a PcNone step from the
   same state wherever PcNone converged inside its own budget;
19. the 2D plume (scenes/plume_2d.py: open "yY" bounds, window 3,
   MacCormack, PcNone, its Cylinder source; adaptive dt for the window's
   CFL bound) at 512^2:
   1 warm step, 10 timed, 30 more, 10 timed, 6 passes of the window
   kernel's 2D instance and one CG a step; every window pass and the CG of
   a developed step against their plain versions, and their times;
20. these configurations on the card against the CPU, 3 steps each (the
   exact gathers at 24^3 in both clamp modes, PcMGStatic and PcMIC at
   32^3, the 2D plume at 32^2), and one solve_pressure at 24^3 for each of
   the l2 exit, compatibility, fractions with an obstacle velocity and
   ghost fluid with surface tension;
21. the z-sharded bench smoke at 128^3 over 4 z-slabs of 32 planes
   (``smoke_step(..., zshard=mesh)``: every window pass one launch of the
   window kernel's z-slab instance per shard, 32 a step, no one-domain
   window launch, 1 CG): 1 warm step, 10 timed, 30 more, 10 timed, each
   timed window bit for bit the 10 one-domain steps from its first state;
   every slab launch of a cold and a developed step against its plain
   version, the slab launch's time, bound and grid_sample's time, the halo
   copies' ms a step; 3 steps at 16^3 over 4 slabs of k+1 planes on the
   card against the CPU;
22. the 2D flat FLIP dam (tests/test_torch_flat_flip.py's dam_2d,
   scenes/flip01_simple.py in 2D) at 512^2: 1 warm step, 10 timed, 20 more,
   10 timed, 6 launches of the layer kernel's 2D instance and 1 CG a step,
   no particle lost; every layer and the CG of a developed step against
   their plain versions, the layer's time; 3 steps at 64^2 on the card
   against the CPU;
23. the scene API's FLIP functions (averaged and improved particle
   levelsets, combine_grid_vel, adjust_number) and the extrapolation
   options (extrapolate_mac_simple with phi_obs and into_obs,
   extrapolate_vec3_simple, through the layer kernel) on the developed flat
   128^3 dam, timed, and at 24^3 on the card against the CPU;
24. scenes/surfaceTension.py's loop at 128^3 (a liquid box, dt 0.25): the
   parallel redistancing with velocity transport, order-1 levelset
   advection, the boundary Neumann copy, flags from the levelset, order-2
   MAC advection, wall BCs, the curvature and the ghost-fluid PcMIC solve
   with surface tension (K2, full mode), 1 warm step, 10 timed, 30 more,
   10 timed, 1 K2 and no other kernel a step, then 10 steps under the
   profiler (device busy, device launches and idle a step); on the
   developed state the native fast march (the reference's serial heap, on
   the host) against the card's transport in the band (the test's bounds
   on the test's basin and drop; on the developed liquid the card's
   transport and redistancing bit for bit the CPU's), marching cubes on
   the host (timed, every edge in two triangles), K2 against cg_plain by
   its residual and timed; 3 steps at 24^3 on the card against the CPU.
   Cut: the scene's createMesh every step (marching cubes runs once);
25. scenes/karman.py with dim = 3 at 256x128x128 (inflow x walls and the
   wall SDF, the obstacle and inflow cylinders along z, fractions,
   sec_order_bc, PcMIC at 1e-4; K2 on its spill path, more cells a block
   than it keeps on chip), driven and traced as phase 24, 7 K14 (3 pairs)
   and 1 K2 a step; K14 and K2 of a developed step against their plain
   versions and timed (K2's us an iteration); 3 steps at 32x16x16 on the
   card against the CPU. The flow starts from the scene's y-noise
   (addNoise from the file-loaded tile, setComponent);
26. scenes/fire.py at 128^3 (open yY bounds, four noise densityInflow calls
   a step, processBurn, five order-2 exact-gather advections, resetOutflow,
   fuel-weighted vorticity confinement, two buoyancies, the scene API's
   PcMIC solve, updateFlame, the scene's adaptive dt), driven and traced as
   phase 24, 1 K2 a step and no other kernel; K2 of a developed step
   against its plain version by its residual and timed; 3 steps at 24^3 on
   the card against the CPU;
27. scenes/turbulence.py at 256x128x128 (16 sphere obstacles, the
   generated noise tile, 500 turbulence particles seeded a step with the
   scene API's persistent stream, RK4 advection, synthesis and deletion in
   obstacles; the k-epsilon chain with diffusion, inflow BCs, PcMIC with
   cgMaxIterFac 0.5: K2 on its spill path), driven, traced and checked as
   phase 26; 3 steps at 32x16x16 on the card against the CPU. Cut: the
   GUI-only obstacleLevelset + createMesh;
28. the rest of the breadth ops, each on the card at a stated size (timed)
   and held against the CPU on the same inputs: the wave equation (40
   explicit-then-implicit steps at 512^2), the wavelet-turbulence up-res
   (res 256 in 2D, the xl grid 512x768; held at res 64), PD fluid guiding
   (the guiding_2d spiral at 128^2, PcMGStatic; held at 64^2), a
   Correct19 IDP step (idp_apic02_3d's box at 64^3), whitewater
   (potentials, sampling, update on phase 14's developed 128^3 dam; held
   on its 48^3 corner), surface turbulence (4 frames on a flat FLIP liquid
   at 64^3), VIC (a sphere's sheet at 64^3) and interpol4d (40^4 -> 80^4;
   held 20^4 -> 40^4).

Prints the card, a timing line and a ``{"kernels": [...]}`` line, and as its
last line ``{"ok": true, "device": {...}}``. K1's entries carry
torch.nn.functional.grid_sample's time on the same passes (``library_ms``:
the passes without the min/max, held to K1 within the window). Needs one CUDA device. A
kernel's time is its device time from a torch.profiler trace that holds
exactly its launches, else (K1, K14) from a CUDA graph replay of the same
launches or from CUDA events around its wrapper calls; each entry says
which (``timed_by``).
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
PLUME_RES = 512  # the 2D plume (scenes/plume_2d.py's 64^2 occupies no card)
FLAT2D_RES = 512  # the 2D flat dam (tests/test_torch_flat_flip.py's 40^2
                  # occupies no card)
FLIP_CHUNK = 10  # bench.py's n_steps: timed window and runner chunk
ZSHARDS = 4      # z-slabs of the sharded path
SURF_RES = 128   # scenes/surfaceTension.py (its 40^3 occupies no card)
KARMAN_RES = 128  # scenes/karman.py with dim = 3: 2 res x res x res cells
FIRE_RES = 128   # scenes/fire.py (its 52^3 occupies no card)
KEPS_RES = 256   # scenes/turbulence.py: res x res/2 x res/2 (its res 64)
WAVES_RES = 512  # tests/ref_scenes/test_1030_waveeq.py's loop (113x127)
WLT_RES = 256    # scenes/waveletTurbulence.py's res (80), 2D
GUIDE_RES = 128  # scenes/guiding_2d.py's own size
IDP_RES = 64     # scenes/idp_apic02_3d.py's box (its res 48)
ST_RES = 64      # scenes/surfaceTurbulence.py (its res 32)
VIC_RES = 64     # a sphere's vortex sheet (tests/test_vortex.py's 16^3)


def flip_bench_params(flip):
    # bench.py:84-86
    return flip.FlipParams(gravity=(0.0, -0.003, 0.0), ghost_fluid=True,
                           cg_accuracy=1e-3, ring_only_obstacles=True)


def bench_params(smoke):
    # bench.py:193-197
    return smoke.SmokeParams(buoyancy=(0.0, -6e-4, 0.0),
                             vorticity_confinement=0.1, cg_accuracy=1e-3,
                             window=K, use_pallas=True, adaptive_dt=True,
                             cfl=3.0, dt_max=2.0)


def bench_state(smoke, Domain, Sphere, res, device, params=None):
    """The bench smoke's initial state (``params``: bench_params)."""
    dom = Domain(size=(res, res, res), dim=3)
    src = Sphere(center=(res / 2.0, res * 0.1, res / 2.0), radius=res * 0.14)
    return dom, smoke.make_smoke_state(dom, params or bench_params(smoke),
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


def grid_sample_inputs(torch, src, px, py, pz, is3d, z_base=0, halo=0):
    """The input and the normalised grid of
    torch.nn.functional.grid_sample (align_corners=True, border padding)
    that sample ``src`` trilinearly (bilinearly in 2D) at the window
    kernel's positions: cell centres at +0.5. ``z_base`` and ``halo``: a
    z-slab's positions and its haloed source (the border clamp at the
    haloed ends reads the end planes' copies, which the global clamp
    reads too)."""
    def norm(p, size, off=0.0):
        return (p - (0.5 + off)) * (2.0 / (size - 1)) - 1.0
    sz, sy, sx = src.shape
    axes = [norm(px, sx), norm(py, sy)]
    if not is3d:
        return src[0][None, None], torch.stack(axes, dim=-1)[0][None]
    axes.append(norm(pz, sz, z_base - halo))
    return src[None, None], torch.stack(axes, dim=-1)[None]


def grid_sample(torch, inp, grid):
    """The one PyTorch call that computes a window pass without the
    MacCormack min/max where every displacement is within the window."""
    return torch.nn.functional.grid_sample(
        inp, grid, mode="bilinear", padding_mode="border",
        align_corners=True)


def within_window(torch, px, py, pz, k, is3d, z_base=0):
    """Cells whose displacement lies within +-k on every axis (where the
    window clamp leaves the sample as it is)."""
    lz, sy, sx = px.shape
    dev = px.device
    cx = torch.arange(sx, dtype=torch.float32, device=dev).view(1, 1, sx)
    cy = torch.arange(sy, dtype=torch.float32, device=dev).view(1, sy, 1)
    m = ((px - 0.5 - cx).abs() <= k) & ((py - 0.5 - cy).abs() <= k)
    if is3d:
        cz = (torch.arange(lz, dtype=torch.float32, device=dev)
              + z_base).view(lz, 1, 1)
        m = m & ((pz - 0.5 - cz).abs() <= k)
    return m


def library_vs_window(torch, calls, kernel, is3d, tol_scale=False,
                      slab=False):
    """grid_sample on the non-min/max window passes among ``calls``, the
    recorded arguments of ``kernel`` (the window wrapper, or with ``slab``
    the z-slab wrapper), and its ms per call (CUDA events, the float32 call
    alone). That it computes the kernel's function is checked in float64:
    its output on the cells within the window must lie within 1e-5 (times
    max(1, max|src|) with ``tol_scale``) of the kernel's. In float32 its
    normalised coordinates carry an error of about (n - 1) / 2 float32
    ulps of 1 (1.5e-5 cells at 512 cells), so that difference is only
    reported. Returns the numbers and the least share of cells within the
    window."""
    prepared, err, err32, share = [], 0.0, 0.0, []
    for a, kw in calls:
        if slab:
            src, px, py, pz, _, k, z_base, _, mm = a
            halo = k + 1
        else:
            src, px, py, pz, _, k = a[:6]
            mm, z_base, halo = kw.get("want_minmax", False), 0, 0
        if mm:
            continue
        kern = kernel(*a, **kw)
        inside = within_window(torch, px, py, pz, k, is3d, z_base)
        inp, grid = grid_sample_inputs(torch, src, px, py, pz, is3d, z_base,
                                       halo)
        lib32 = grid_sample(torch, inp, grid).reshape(px.shape)
        inp64, grid64 = grid_sample_inputs(
            torch, src.double(), px.double(), py.double(), pz.double(), is3d,
            z_base, halo)
        lib64 = grid_sample(torch, inp64, grid64).reshape(px.shape)
        e = float(torch.where(inside, (lib64 - kern.double()).abs(),
                              0.0).max())
        tol = 1e-5 * (max(1.0, float(src.abs().max())) if tol_scale else 1.0)
        require(e < tol, f"grid_sample (float64) vs the window kernel: {e} "
                f">= {tol}")
        err = max(err, e)
        err32 = max(err32, float(torch.where(inside, (lib32 - kern).abs(),
                                             0.0).max()))
        share.append(float(inside.float().mean()))
        prepared.append((inp, grid))
    require(prepared, "no window pass without the min/max to time")

    def go():
        for inp, grid in prepared:
            grid_sample(torch, inp, grid)
    ms = cuda_ms(torch, go, 5) / len(prepared)
    return {"library_ms": ms, "library_max_abs_diff_float64": err,
            "library_max_abs_diff_float32": err32,
            "library_calls": len(prepared),
            "library_cells_within_window": min(share)}


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
    (``union_levelset_kernel<3>``,
    ``window_advect_kernel<true,false,true,false>``),
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


def graph_ms(torch, fn, reps, launches):
    """Mean milliseconds per launch of the kernels of fn() captured once in
    a CUDA graph and replayed ``reps`` times between CUDA events: the
    kernels back to back with no host between them. For wrappers that do
    nothing but allocate their outputs and launch (no host read)."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps / launches


def timed_launches(torch, fn, reps, names, launches, graph=False):
    """(ms, call_ms, timed_by) per launch of the kernel instances ``names``:
    ``ms`` the profiler's device time (kernel_device_ms), ``call_ms`` CUDA
    events around the wrapper calls (host gaps included). Where no trace
    was accepted, where the profiler reads more than 1.05 of the events
    time (records that are not these launches'), or where a kernel of more
    than 0.2 ms reads under 0.8 of it (host gaps cannot explain that much),
    ``ms`` is the time of the launches replayed from a CUDA graph
    (``graph``: wrappers that only launch) or else the events time;
    ``timed_by`` says which and the line printed says so."""
    if isinstance(names, str):
        names = (names,)
    what = "/".join(names)
    dev = kernel_device_ms(torch, fn, reps, names, launches)
    call = cuda_ms(torch, fn, reps) / launches
    if dev is not None and not (dev > 1.05 * call
                                or (call > 0.2 and dev < 0.8 * call)):
        return dev, call, "profiler"
    why = ("no profiler trace accepted" if dev is None else
           f"the profiler reads {dev * 1e3:.1f} us/launch, CUDA events "
           f"{call * 1e3:.1f}")
    if graph:
        ms = graph_ms(torch, fn, reps, launches)
        print(f"{what}: {why}; timed from a CUDA graph, {ms * 1e3:.1f} "
              f"us/launch (events around the calls {call * 1e3:.1f})",
              flush=True)
        return ms, call, "graph"
    print(f"{what}: {why}; timed with CUDA events, {call * 1e3:.1f} "
          "us/launch", flush=True)
    return call, call, "events"


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")

    from mantaflow_tpu_torch.core import flags as fl
    from mantaflow_tpu_torch.core import mac as macops
    from mantaflow_tpu_torch.core.domain import Domain
    from mantaflow_tpu_torch.core.shapes import Box, Cylinder, Sphere
    from mantaflow_tpu_torch.core import mesh as trimesh
    from mantaflow_tpu_torch.core.masks import axis_index, shift
    from mantaflow_tpu_torch import native
    from mantaflow_tpu_torch.kernels import _build
    from mantaflow_tpu_torch.core import particles as cp
    from mantaflow_tpu_torch.models import flip, smoke
    from mantaflow_tpu_torch.ops import advect_bucket_kernels as fadk
    from mantaflow_tpu_torch.ops import advection_kernels as advk
    from mantaflow_tpu_torch.ops import blend_kernels as blk
    from mantaflow_tpu_torch.ops import extrapolation as xtr
    from mantaflow_tpu_torch.ops import extrapolation_kernels as xk
    from mantaflow_tpu_torch.ops import flip as fo
    from mantaflow_tpu_torch.ops import flip_bucket as fb
    from mantaflow_tpu_torch.ops import levelset as lso
    from mantaflow_tpu_torch.ops import levelset_kernels as lsk
    from mantaflow_tpu_torch.ops import obstacles as obs
    from mantaflow_tpu_torch.ops import p2g_kernels as p2gk
    from mantaflow_tpu_torch.ops import rebin_kernels as rbk
    from mantaflow_tpu_torch.ops import extforces as ext
    from mantaflow_tpu_torch.ops.flip import get_curvature
    from mantaflow_tpu_torch.ops import pressure as prs
    from mantaflow_tpu_torch.ops import pressure_kernels as prk
    from mantaflow_tpu_torch.ops import advection as sladv
    from mantaflow_tpu_torch.ops.advection import _cell_centers
    from mantaflow_tpu_torch.ops.advection_fast import window_interp
    from mantaflow_tpu_torch.parallel import sharding as shd
    from mantaflow_tpu_torch.core import grid4d as g4
    from mantaflow_tpu_torch.ops import fire
    from mantaflow_tpu_torch.ops import guiding as gd
    from mantaflow_tpu_torch.ops import idp
    from mantaflow_tpu_torch.ops import initops as ini
    from mantaflow_tpu_torch.ops import kepsilon as kep
    from mantaflow_tpu_torch.ops import surfaceturbulence as stb
    from mantaflow_tpu_torch.ops import turbulence as tur
    from mantaflow_tpu_torch.ops import vortex as vx
    from mantaflow_tpu_torch.ops import waves as wav
    from mantaflow_tpu_torch.ops import whitewater as ww
    from mantaflow_tpu_torch.utils.mtrand import RandomStream
    from mantaflow_tpu_torch.utils.noise import WaveletNoiseField

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
    advk.window_pass_slab.launches = 0
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
                "window_advect_zshard": advk.window_pass_slab.launches,
                "cg_solve": prk.cg_solve.launches}
    steps = 51
    require(launches["window_advect"] == 8 * steps,
            f"window_advect launched {launches['window_advect']} times")
    require(launches["window_advect_zshard"] == 0,
            f"window_advect_zshard launched "
            f"{launches['window_advect_zshard']} times")
    require(launches["cg_solve"] == steps,
            f"cg_solve launched {launches['cg_solve']} times")

    for name in ("vel", "density", "pressure"):
        require(bool(torch.isfinite(getattr(state, name)).all()),
                f"{name} not finite")
    dmax = float(state.density.max())
    require(0.1 < dmax <= 1.01, f"density max {dmax}")
    require(int(state.ts.count) == steps, f"ts.count {int(state.ts.count)}")

    # -- 3. window-advection kernel vs window_interp ------------------------
    def k1_check(src, px, py, pz, dom, ok, want_minmax, scaled=False):
        """K1 against window_interp: abs 1e-6; ``scaled``: 1e-6 times
        max(1, max|src|), the same few ulps for a field of any magnitude
        (the 2D plume's velocities reach tens of cells a unit time)."""
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
        tol = 1e-6 * (max(1.0, float(src.abs().max())) if scaled else 1.0)
        require(err < tol, f"window_advect: max abs err {err} >= {tol}")
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
    for comp, (fpos, bpos) in enumerate(advk._face_traces(vel, dt, dom)):
        passes.append((vel[comp], *fpos, None, True))
        passes.append((vel[comp], *bpos, None, False))
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

    # the template instances the passes launch: <kMinMax, kWithOk, k3d,
    # kSlab>
    k1_names = sorted({"window_advect_kernel<%s,%s,true,false>" % (
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
    # the library yardstick: grid_sample computes the passes without the
    # min/max wherever the displacement lies within the window
    k1_library = library_vs_window(
        torch, [((s_, px, py, pz, dom, K), {"ok_mask": o, "want_minmax": mm})
                for s_, px, py, pz, o, mm in passes], advk.window_pass, True)
    print(f"grid_sample on the 128^3 step's {k1_library['library_calls']} "
          f"passes without the min/max: {k1_library['library_ms'] * 1e3:.1f}"
          " us/call, max abs diff from K1 within the window "
          f"{k1_library['library_max_abs_diff_float64']:.3g} (float64), "
          f"{k1_library['library_max_abs_diff_float32']:.3g} (float32)",
          flush=True)

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
        ms, call_ms, timed_by = timed_launches(
            torch, replay(calls, fn), 5, kname, len(calls),
            graph=kname.startswith("extrap_layer"))
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
                        ("extrap_layer", "extrap_layer_kernel<true>")):
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
                    "window_advect_zshard": advk.window_pass_slab,
                    "advect_bucket_zshard": fadk.advect_blend_slab_live,
                    "advect_bucket_zshard_public": fadk.advect_blend_slab,
                    "p2g_levelset_zshard": p2gk.p2g_union_slab}
    flat_per_step = {"extrap_layer": 10, "cg_solve": 1}
    flat_sites = {k: sites[k] for k in flat_per_step}

    def flat_checks(name, st, n_parts, dom_=fdom):
        """No particle lost, every field finite, every active particle
        inside the domain on every axis."""
        active = st.parts.active_mask()
        require(int(active.sum()) == n_parts,
                f"{name}: {int(active.sum())} active particles, had "
                f"{n_parts}")
        for field in ("vel", "vel_old", "pressure", "phi", "pvel", "cpx",
                      "cpy", "cpz"):
            require(bool(torch.isfinite(getattr(st, field)).all()),
                    f"{name}: {field} not finite")
        pos = st.parts.pos[active]
        size = torch.tensor(dom_.size, dtype=torch.float32, device=dev)
        require(bool(torch.isfinite(pos).all()) and bool((pos >= 0).all())
                and bool((pos < size).all()),
                f"{name}: a position outside the domain {dom_.size}")

    def drive_flat(name, params_, windows, dom_=fdom, disc=2,
                   per_step=flat_per_step):
        """A flat dam (the 128^3 bench dam unless ``dom_`` says otherwise)
        set up by make_dam_state (bench.py:37-40), 1 warm step, then for
        each (pre, n) of ``windows`` pre untimed steps (flip_run) and n
        timed ones (CUDA events). Every kernel's count is set to 0 just
        before the warm step and read after the last; the launches per step
        (``per_step``, every other kernel 0), the particles and the fields
        are checked. Returns the run's numbers, the state after the warm
        step (the cold inputs) and the last state, and the launches."""
        t0 = time.perf_counter()
        st = flip.make_dam_state(dom_, params_, discretization=disc,
                                 device=dev)
        n_parts = int(st.parts.count)
        setup_s = time.perf_counter() - t0
        require(dom_ is not fdom or n_parts == flip_numbers["particles"],
                f"{name}: {n_parts} particles, the bucketed dam has "
                f"{flip_numbers['particles']}")
        require(st.parts.capacity == -(-int(n_parts * 1.02) // 1024) * 1024,
                f"{name}: capacity {st.parts.capacity}")
        torch.cuda.synchronize()
        for fn in every_kernel.values():
            fn.launches = 0
        st = flip.flip_step(st, dom_, params_)  # warm
        cold_state, n_steps, timed_ = st, 1, []
        for pre, n in windows:
            st = flip.flip_run(st, dom_, params_, pre)
            iters = torch.zeros((), dtype=torch.int64, device=dev)
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(n):
                st = flip.flip_step(st, dom_, params_)
                iters += st.cg_iters
            t1.record()
            torch.cuda.synchronize()
            timed_.append((t0.elapsed_time(t1) / n, int(iters) / n))
            n_steps += pre + n
        launches = {k: fn.launches for k, fn in every_kernel.items()}
        for k, got in launches.items():
            want = per_step.get(k, 0) * n_steps
            require(got == want, f"{name}: {k} launched {got} times in "
                    f"{n_steps} steps (expected {want})")
        flat_checks(name, st, n_parts, dom_)
        require(int(st.ts.count) == n_steps, f"{name}: ts.count")
        (cold_ms, cold_it), (dev_ms, dev_it) = timed_[0], timed_[-1]
        print(f"{name} {dom_.size}: {n_steps} steps, {n_parts} particles "
              f"(capacity {st.parts.capacity}), {cold_ms:.2f} ms/step cold, "
              f"{dev_ms:.2f} developed, CG {cold_it:.1f} / {dev_it:.1f} "
              f"it/step, launches {launches}", flush=True)
        numbers = {"ms_per_step_cold": cold_ms, "ms_per_step_developed":
                   dev_ms, "steps_per_s_cold": 1e3 / cold_ms,
                   "steps_per_s_developed": 1e3 / dev_ms,
                   "cg_iters_per_step_cold": cold_it,
                   "cg_iters_per_step_developed": dev_it,
                   "particles": n_parts, "capacity": st.parts.capacity,
                   "steps_run": n_steps, "launches_per_step": per_step,
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

    def flat_kernel_check(name, st, params_, what, dom_=fdom,
                          per_step=flat_per_step, layer_key="extrap_layer"):
        """K14 and K2 against their plain versions on every call of one
        flat step from ``st``: the layers exact (their error under
        ``layer_key``), the CG by cg_check_by_residual."""
        calls = {k: [] for k in flat_sites}
        with contextlib.ExitStack() as stack:
            for k, (mod, fname) in flat_sites.items():
                stack.enter_context(recording(mod, fname, calls[k]))
            flip.flip_step(st, dom_, params_)
        torch.cuda.synchronize()
        for k, n in per_step.items():
            require(len(calls[k]) == n,
                    f"{name}: {len(calls[k])} {k} calls in one step")
        for args, kwargs in calls["extrap_layer"]:
            errs[layer_key] = max(errs.get(layer_key, 0.0), check_call(
                "extrap_layer", args, kwargs))
        for args, kwargs in calls["cg_solve"]:
            rhs, stencil, _, acc, max_iter = args
            errs["cg_solve"] = max(errs["cg_solve"], cg_check_by_residual(
                rhs, stencil, kwargs["fluid"], acc, max_iter, dom_))
        print(f"{name} {dom_.size} {what} step, kernels vs plain: "
              f"{layer_key} {errs[layer_key]:.3g}, cg_solve "
              f"{errs['cg_solve']:.3g}", flush=True)
        return calls

    flat_params = flip_bench_params(flip)
    apic_params = dataclasses.replace(flat_params, apic=True)
    flat_numbers, flat_cold, flat_last, flat_launches = drive_flat(
        "flat", flat_params, [(0, FLIP_CHUNK), (20, FLIP_CHUNK)])
    flat_kernel_check("flat", flat_cold, flat_params, "cold")
    flat_calls = flat_kernel_check("flat", flat_last, flat_params,
                                   "developed")
    del flat_cold  # flat_last: phase 23's developed state
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
    time_kernel("extrap_layer_flat", "extrap_layer_kernel<true>", layer_calls,
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
    def flat_card_vs_cpu(name, params_, obstacle=None, dom_=sdom, disc=2):
        """3 steps (at 24^3 unless ``dom_`` says otherwise) on the card and
        on the CPU: flags, particle flags and counts exact, grids to abs
        2e-4, particles to 1e-4."""
        g_, c_ = (flip.flip_run(flip.make_dam_state(
            dom_, params_, discretization=disc, obstacle=obstacle,
            device=d_), dom_, params_, 3) for d_ in (dev, "cpu"))
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
        size = "x".join(str(n) for n in dom_.size if n > 1)
        require(gerr < 2e-4 and perr < 1e-4,
                f"{size} {name} card vs CPU: grids {gerr}, particles {perr}")
        print(f"{size} {name} x3 steps, card vs CPU: grids {gerr:.3g}, "
              f"particles {perr:.3g}", flush=True)
        return {"grids": gerr, "particles": perr}

    flat_card_cpu = {
        "flat": flat_card_vs_cpu("flat", flat_params),
        "apic": flat_card_vs_cpu("apic", apic_params),
        "flat_obstacle": flat_card_vs_cpu("flat obstacle", params_b, Sphere(
            center=(24 * 0.7, 24 * 0.28, 12.0), radius=24 * 0.15))}
    flat_numbers["card_vs_cpu_24"] = flat_card_cpu

    # -- 17-19. the smoke model's other configurations ------------------------
    smoke_paths = {}  # launches by path
    new_numbers = {}

    def drive_smoke(name, params_, dom_, state_, windows, per_step,
                    zshard=None, window_states=None):
        """Drive the smoke model from ``state_`` (``zshard``: over that
        mesh's z-slabs): 1 warm step, then per (pre, n) of ``windows``
        ``pre`` steps and ``n`` timed ones (CUDA events; the host reads of
        the multigrid solve included). The kernels' counts are set to 0
        just before the warm step and read after the last; the launches per
        step (``per_step``, every other kernel 0), finite fields and
        ts.count are checked. The CG iterations a step reports count the
        multigrid start's V-cycles too: the recorded mg_richardson cycles
        are taken out. ``window_states``: a list that takes each timed
        window's first and last state. Returns the numbers and the last
        state."""
        def run(st, n):
            if zshard is None:
                return smoke.smoke_run(st, dom_, params_, n)
            for _ in range(n):
                st = smoke.smoke_step(st, dom_, params_, zshard=zshard)
            return st

        cycles = []
        mg_rich = prs.mg_richardson

        def counted_richardson(*a, **k):
            out = mg_rich(*a, **k)
            cycles.append(out[1])
            return out
        prs.mg_richardson = counted_richardson
        try:
            torch.cuda.synchronize()
            advk.window_pass.launches = 0
            advk.window_pass_slab.launches = 0
            prk.cg_solve.launches = 0
            st = run(state_, 1)  # warm
            n_steps, timed_ = 1, []
            for pre, n in windows:
                st = run(st, pre)
                first = st
                iters = torch.zeros((), dtype=torch.int64, device=dev)
                mark = len(cycles)
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                for _ in range(n):
                    st = smoke.smoke_step(st, dom_, params_, zshard=zshard)
                    iters += st.cg_iters
                t1.record()
                torch.cuda.synchronize()
                if window_states is not None:
                    window_states.append((first, st))
                vc = sum(int(c) for c in cycles[mark:]) / n
                timed_.append((t0.elapsed_time(t1) / n, int(iters) / n - vc,
                               vc))
                n_steps += pre + n
            got = {"window_advect": advk.window_pass.launches,
                   "window_advect_zshard": advk.window_pass_slab.launches,
                   "cg_solve": prk.cg_solve.launches}
        finally:
            prs.mg_richardson = mg_rich
        for k in got:
            want = per_step.get(k, 0)
            require(got[k] == want * n_steps,
                    f"{name}: {k} launched {got[k]} times in {n_steps} steps "
                    f"(expected {want * n_steps})")
        for field in ("vel", "density", "pressure"):
            require(bool(torch.isfinite(getattr(st, field)).all()),
                    f"{name}: {field} not finite")
        require(int(st.ts.count) == int(state_.ts.count) + n_steps,
                f"{name}: ts.count {int(st.ts.count)}")
        (cold_ms, cold_it, cold_vc), (dev_ms, dev_it, dev_vc) = \
            timed_[0], timed_[-1]
        mg_path = params_.preconditioner in (prs.PcMGStatic, prs.PcMGDynamic)
        # host reads per step: one per V-cycle, and the CG tail's test
        # before its loop and one per iteration
        reads = dev_vc + dev_it + 1 if mg_path else 0
        print(f"{name}: {n_steps} steps, {cold_ms:.2f} ms/step cold, "
              f"{dev_ms:.2f} developed, CG {cold_it:.1f} / {dev_it:.1f} "
              f"it/step, V-cycles {cold_vc:.1f} / {dev_vc:.1f} per step, "
              f"host reads {reads:.1f} per developed step, launches {got}",
              flush=True)
        numbers = {"ms_per_step_cold": cold_ms, "ms_per_step_developed":
                   dev_ms, "steps_per_s_developed": 1e3 / dev_ms,
                   "cg_iters_per_step_cold": cold_it,
                   "cg_iters_per_step_developed": dev_it,
                   "vcycles_per_step_cold": cold_vc,
                   "vcycles_per_step_developed": dev_vc,
                   "host_reads_per_step_developed": reads,
                   "steps_run": n_steps, "launches_per_step": per_step}
        smoke_paths[name] = got
        new_numbers[name] = numbers
        return numbers, st

    def record_step(st, dom_, params_):
        """The window and CG kernel calls of one step from ``st``."""
        calls = {"window_advect": [], "cg_solve": []}
        with recording(advk, "window_pass", calls["window_advect"]), \
                recording(prk, "cg_solve", calls["cg_solve"]):
            smoke.smoke_step(st, dom_, params_)
        torch.cuda.synchronize()
        return calls

    # 17. the exact-gather smoke (the JAX package's default advection)
    exact_params = dataclasses.replace(params, window=0, clamp_mode=2)
    dom, state = bench_state(smoke, Domain, Sphere, RES, dev)
    _, est = drive_smoke("smoke_exact_128", exact_params, dom, state,
                         [(0, 10), (30, 10)],
                         {"window_advect": 0, "cg_solve": 1})
    (cg_args, cg_kw), = record_step(est, dom, exact_params)["cg_solve"]
    k2_err = max(k2_err, cg_check(cg_args[0], cg_args[1], cg_kw["fluid"],
                                  cg_args[3], cg_args[4], dom))
    del est, cg_args, cg_kw

    # 18. multigrid (PcMGStatic, PcMGDynamic) and PcMIC at 128^3
    builds = []
    build_mg = smoke.multigrid.build_mg_hierarchy
    smoke.multigrid.build_mg_hierarchy = \
        lambda *a, **k: (builds.append(1), build_mg(*a, **k))[1]
    try:
        mg_params = dataclasses.replace(params,
                                        preconditioner=prs.PcMGStatic)
        dom, state = bench_state(smoke, Domain, Sphere, RES, dev, mg_params)
        # five levels at 128^3 (128 -> 8)
        levels = len(smoke.multigrid._levels(dom))
        require(len(builds) == 1 and state.mg is not None
                and len(state.mg.level_flags) == levels,
                f"PcMGStatic: {len(builds)} hierarchy builds")
        mg_numbers, mst = drive_smoke(
            "smoke_mg_128", mg_params, dom, state, [(0, 10), (10, 10)],
            {"window_advect": 8, "cg_solve": 0})
        require(len(builds) == 1, f"PcMGStatic: {len(builds)} hierarchy "
                "builds in the run (one expected)")
    finally:
        smoke.multigrid.build_mg_hierarchy = build_mg
    # post-projection divergence on interior fluid: the JAX package's bound
    # at cg_accuracy 1e-3 (tests/test_pressure.py:36,49)
    mg_div = float(prs.make_rhs(mst.flags, mst.vel, dom).abs().max())
    require(mg_div < 2e-3, f"PcMGStatic: post-projection max|div| {mg_div}")
    mg_numbers["post_projection_max_div"] = mg_div
    del mst
    # PcMGDynamic through the smoke model: the same hierarchy, the same
    # steps bit for bit
    dyn = {}
    for pc in (prs.PcMGStatic, prs.PcMGDynamic):
        p_ = dataclasses.replace(params, preconditioner=pc)
        dom, st_ = bench_state(smoke, Domain, Sphere, RES, dev, p_)
        dyn[pc] = smoke.smoke_run(st_, dom, p_, 5)
    require(all(torch.equal(getattr(dyn[prs.PcMGStatic], k),
                            getattr(dyn[prs.PcMGDynamic], k))
                for k in ("vel", "density", "pressure", "cg_iters")),
            "PcMGDynamic differs from PcMGStatic")
    print("smoke 128^3: 5 PcMGDynamic steps equal 5 PcMGStatic steps bit "
          "for bit", flush=True)
    del dyn, st_
    # PcMIC: plain CG with 12 times PcNone's budget, driven as a run of its
    # own (its launches counted over that run alone); every solve of the run
    # is given the 12-fold budget
    mic_params = dataclasses.replace(params, preconditioner=prs.PcMIC)
    budget = int(params.cg_max_iter_fac * RES)
    dom, state = bench_state(smoke, Domain, Sphere, RES, dev)
    mic_budgets = []
    cg = prk.cg_solve

    def mic_counted(*a, **k):
        mic_budgets.append(a[4])
        return cg(*a, **k)
    # the wrapper counts its launches on its module's name, mic_counted here
    mic_counted.launches = 0
    prk.cg_solve = mic_counted
    try:
        mic_numbers, mst = drive_smoke(
            "smoke_mic_128", mic_params, dom, state, [(0, 10), (30, 10)],
            {"window_advect": 8, "cg_solve": 1})
    finally:
        prk.cg_solve = cg
    require(mic_budgets == [12 * budget] * mic_numbers["steps_run"],
            f"PcMIC budgets {sorted(set(mic_budgets))} (expected "
            f"{12 * budget})")

    # outside the counted run: from the cold and from the developed state,
    # PcMIC's step against PcNone's. Where PcNone converges inside its own
    # budget the two are equal bit for bit; where it runs out (developed
    # steps), PcMIC's solve runs on past the budget and K2 is held against
    # cg_plain with the 12-fold budget on that step's system, by residual as
    # the flat dams' solves are (an exit past ~20 iterations moves with
    # rounding, tools/profile_cg_exit.py)
    mic_same, mic_past, mic_solves = 0, 0, []
    for start in (state, mst):
        st_ = start
        for _ in range(2):
            none = smoke.smoke_step(st_, dom, params)
            calls = {"cg_solve": []}
            with recording(prk, "cg_solve", calls["cg_solve"]):
                mic = smoke.smoke_step(st_, dom, mic_params)
            (cg_args, cg_kw), = calls["cg_solve"]
            require(cg_args[4] == 12 * budget,
                    f"PcMIC: budget {cg_args[4]}")
            n_none, n_mic = int(none.cg_iters), int(mic.cg_iters)
            if n_none < budget:
                require(n_mic == n_none
                        and torch.equal(mic.pressure, none.pressure),
                        "PcMIC differs from PcNone inside its budget")
                mic_same += 1
            else:
                require(n_mic >= budget, f"PcMIC: {n_mic} it where PcNone "
                        f"used its budget of {budget}")
                mic_past += 1
                k2_err = max(k2_err, cg_check_by_residual(
                    cg_args[0], cg_args[1], cg_kw["fluid"], cg_args[3],
                    cg_args[4], dom))
            mic_solves.append((n_none, n_mic))
            st_ = mic
            del cg_args, cg_kw, calls, none
    require(mic_past > 0, "PcMIC: PcNone converged inside its budget on "
            "every developed step, so the 12-fold budget was not exercised")
    mic_numbers.update({
        "cg_budget": 12 * budget, "pcnone_budget": budget,
        "steps_equal_to_pcnone": mic_same,
        "steps_past_pcnone_budget": mic_past,
        "pcnone_vs_pcmic_iterations": mic_solves})
    print(f"smoke PcMIC 128^3: budget {12 * budget} ({budget} PcNone); "
          f"PcNone / PcMIC iterations from the cold and the developed state "
          f"{mic_solves}: {mic_same} steps equal to PcNone's bit for bit, "
          f"{mic_past} past PcNone's budget held against cg_plain",
          flush=True)
    del state, mst, mic, st_

    # 19. the 2D plume (scenes/plume_2d.py: open "yY" bounds, window 3,
    # MacCormack, PcNone) at PLUME_RES^2; adaptive dt keeps the window's
    # CFL bound at this resolution (the buoyancy grows with 1 / dx)
    plume_params = smoke.SmokeParams(buoyancy=(0.0, -4e-3, 0.0),
                                     open_bound="yY", window=K,
                                     adaptive_dt=True, cfl=float(K))
    pdom = Domain(size=(PLUME_RES, PLUME_RES, 1), dim=2)
    # scenes/plume_2d.py:23-24's source: a cylinder along y of half-height
    # 0.02 res, in 2D a rectangle (a disc of its radius stood in before the
    # Cylinder was ported)
    plume_src = Cylinder(center=(PLUME_RES * 0.5, PLUME_RES * 0.1, 0.5),
                         radius=PLUME_RES * 0.14,
                         z=(0.0, PLUME_RES * 0.02, 0.0))
    pst = smoke.make_smoke_state(pdom, plume_params, source_shape=plume_src,
                                 device=dev)
    disc_cells = int((Sphere(center=plume_src.center,
                             radius=plume_src.radius).compute_levelset(
                                 pdom, dev) <= 0).sum())
    new_numbers["plume_source_cells"] = {"cylinder": int(pst.source.sum()),
                                         "disc_of_its_radius": disc_cells}
    print(f"plume source: {int(pst.source.sum())} cells of the cylinder "
          f"(the disc that stood in: {disc_cells})", flush=True)
    plume_path = f"plume2d_{PLUME_RES}"
    _, pst = drive_smoke(
        plume_path, plume_params, pdom, pst, [(0, 10), (30, 10)],
        {"window_advect": 6, "cg_solve": 1})
    require(0.1 < float(pst.density.max()) <= 1.01,
            f"plume: density max {float(pst.density.max())}")
    pcalls = record_step(pst, pdom, plume_params)
    require(len(pcalls["window_advect"]) == 6
            and len(pcalls["cg_solve"]) == 1,
            f"plume: {len(pcalls['window_advect'])} window passes, "
            f"{len(pcalls['cg_solve'])} solves in a step")
    k1_2d_err = 0.0
    for a, kw in pcalls["window_advect"]:
        k1_2d_err = max(k1_2d_err, k1_check(
            a[0], a[1], a[2], a[3], pdom, kw.get("ok_mask"),
            kw.get("want_minmax", False), scaled=True)[0])
    (cg_args, cg_kw), = pcalls["cg_solve"]
    plume_err = cg_check(cg_args[0], cg_args[1], cg_kw["fluid"], cg_args[3],
                         cg_args[4], pdom, units=(False,))
    k2_err = max(k2_err, plume_err)
    # K1's 2D instances, <kMinMax, kWithOk, false>, on the step's passes
    k1_2d_names = sorted({"window_advect_kernel<%s,%s,false,false>" % (
        str(kw.get("want_minmax", False)).lower(),
        str(kw.get("ok_mask") is not None).lower())
        for _, kw in pcalls["window_advect"]})
    nw = len(pcalls["window_advect"])
    k1_2d_ms, k1_2d_call_ms, k1_2d_timed_by = timed_launches(
        torch, replay(pcalls["window_advect"], advk.window_pass), 20,
        k1_2d_names, nw, graph=True)
    k1_2d_plain_ms = cuda_ms(torch, replay(pcalls["window_advect"],
                                           window_interp), 1) / nw
    pn = pdom.num_cells
    # src, px, py read (no pz in 2D), the ok mask, the value written, and
    # with the min/max its two grids and the have mask
    k1_2d_bytes = sum(pn * (12 + (1 if kw.get("ok_mask") is not None else 0)
                            + 4 + (9 if kw.get("want_minmax") else 0))
                      for _, kw in pcalls["window_advect"]) / nw
    k1_2d_ops = pn * 34  # 2 axis setups (~8 each) + 4-corner blend (~18)
    k1_2d_bound = (k1_2d_bytes / HBM_BYTES_PER_S * 1e3,
                   k1_2d_ops / FP32_OPS_PER_S * 1e3)
    k1_2d_library = library_vs_window(torch, pcalls["window_advect"],
                                      advk.window_pass, False,
                                      tol_scale=True)
    print(f"grid_sample on the 2D plume step's "
          f"{k1_2d_library['library_calls']} passes without the min/max: "
          f"{k1_2d_library['library_ms'] * 1e3:.1f} us/call, max abs diff "
          "from K1 within the window "
          f"{k1_2d_library['library_max_abs_diff_float64']:.3g} (float64), "
          f"{k1_2d_library['library_max_abs_diff_float32']:.3g} (float32)",
          flush=True)
    plume_it = int(prk.cg_solve(*cg_args, **cg_kw)[1])
    time_kernel("cg_solve_plume", "cg_kernel<false>", pcalls["cg_solve"],
                prk.cg_solve, prs.cg_plain, 6 * 4 * pn, plume_it * 24 * pn,
                f"2D plume developed solve, {plume_it} it")
    fk["cg_solve_plume"]["iterations"] = plume_it
    print(f"window_advect 2D {PLUME_RES}^2 step passes: max abs err "
          f"{k1_2d_err:.3g}", flush=True)
    del pst, pcalls, cg_args, cg_kw

    # -- 20. the new configurations on the card vs the port on the CPU -------
    def smoke_card_vs_cpu(name, params_, size):
        """3 steps on the card and on the CPU: flags and ts.count exact,
        grids abs 2e-4."""
        dom_ = Domain(size=size, dim=3 if size[2] > 1 else 2)
        src = Sphere(center=(size[0] / 2.0, size[1] * 0.1, size[2] / 2.0),
                     radius=size[0] * 0.14)
        if not dom_.is3d:  # the 2D plume's own source, as in phase 19
            src = Cylinder(center=src.center, radius=src.radius,
                           z=(0.0, size[0] * 0.02, 0.0))
        g_, c_ = (smoke.smoke_run(smoke.make_smoke_state(
            dom_, params_, source_shape=src, device=d_), dom_, params_, 3)
            for d_ in (dev, "cpu"))
        require(torch.equal(g_.flags.cpu(), c_.flags)
                and int(g_.ts.count) == int(c_.ts.count) == 3,
                f"{name} card vs CPU: flags or ts differ")
        err = max(float((getattr(g_, k).cpu() - getattr(c_, k)).abs().max())
                  for k in ("vel", "density", "pressure"))
        require(err < 2e-4, f"{name} card vs CPU: grids {err}")
        print(f"{name} x3 steps, card vs CPU: grids {err:.3g}", flush=True)
        return err

    new_card_cpu = {
        "exact_clamp1_24": smoke_card_vs_cpu(
            "exact clamp 1 24^3", dataclasses.replace(exact_params,
                                                      clamp_mode=1),
            (24, 24, 24)),
        "exact_clamp2_24": smoke_card_vs_cpu(
            "exact clamp 2 24^3", exact_params, (24, 24, 24)),
        "mg_32": smoke_card_vs_cpu("PcMGStatic 32^3", mg_params,
                                   (32, 32, 32)),
        "mic_32": smoke_card_vs_cpu("PcMIC 32^3", mic_params, (32, 32, 32)),
        "plume_32": smoke_card_vs_cpu("2D plume 32^2", plume_params,
                                      (32, 32, 1))}

    def branch_card_vs_cpu(name, **kw):
        """One solve_pressure at 24^3 (walls, an obstacle sphere, an empty
        slab) on the card and on the CPU: iterations within +-10,
        max|dp|/max|p| < 5e-3, velocities abs 2e-4."""
        n_ = 24
        bdom = Domain(size=(n_,) * 3)
        x_, y_, z_ = _cell_centers(bdom, "cpu")
        bf = fl.fill_grid(fl.init_domain(bdom, 1, device="cpu"))
        bf = torch.where(((x_ - 0.3 * n_) ** 2 + (y_ - 0.2 * n_) ** 2
                          + (z_ - 0.5 * n_) ** 2).sqrt() < 0.12 * n_,
                         fl.TypeObstacle, bf)
        g = torch.Generator(device="cpu").manual_seed(7)
        bv = torch.randn((3,) + bdom.shape, generator=g) * 0.1
        fields = {"fractions": 0.3 + 0.7 * torch.rand(
            (3,) + bdom.shape, generator=g),
            "obvel": torch.randn((3,) + bdom.shape, generator=g) * 0.05,
            "phi": y_ - 0.7 * n_ + 1.5 * torch.sin(x_ / 3.0) + 0.3}
        if "phi" in kw:
            bf = fl.update_from_levelset(
                fl.fill_grid(fl.init_domain(bdom, 1, device="cpu"),
                             fl.TypeEmpty), fields["phi"], 1e10)
            kw["curv"] = get_curvature(fields["phi"], bdom)
        else:
            bf = torch.where((y_ > 0.8 * n_) & fl.is_fluid(bf),
                             fl.TypeEmpty, bf)
        def on(v, d_):
            v = fields[v] if isinstance(v, str) else v
            return v.to(d_) if isinstance(v, torch.Tensor) else v

        out = []
        for d_ in (dev, "cpu"):
            a_ = {k: on(v, d_) for k, v in kw.items()}
            out.append(prs.solve_pressure(bv.to(d_), bf.to(d_), bdom,
                                          max_iter=400, **a_))
        (gv, gp, _, git, _), (cv, cp, _, cit, _) = out
        rel = float((gp.cpu() - cp).abs().max()) / (float(cp.abs().max())
                                                     + 1e-30)
        verr = float((gv.cpu() - cv).abs().max())
        require(abs(int(git) - int(cit)) <= 10 and rel < 5e-3
                and verr < 2e-4, f"{name} card vs CPU: {int(git)} vs "
                f"{int(cit)} it, rel {rel}, vel {verr}")
        print(f"solve_pressure {name} 24^3 card vs CPU: {int(git)} / "
              f"{int(cit)} it, rel {rel:.3g}, vel {verr:.3g}", flush=True)
        return rel

    for name, kw in (("l2", dict(cg_accuracy=1e-6, use_l2_norm=True)),
                     ("compatibility", dict(cg_accuracy=1e-4,
                                            enforce_compatibility=True)),
                     ("fractions_obvel", dict(cg_accuracy=1e-4,
                                              fractions="fractions",
                                              obvel="obvel")),
                     ("phi_curv", dict(cg_accuracy=1e-4, phi="phi",
                                       surf_tens=0.05))):
        new_card_cpu[f"solve_{name}_24"] = branch_card_vs_cpu(name, **kw)
    new_numbers["card_vs_cpu"] = new_card_cpu

    # -- 21. the z-sharded bench smoke at 128^3 over ZSHARDS z-slabs -------
    # every window pass through window_pass_zshard: per pass one launch of
    # the window kernel's z-slab instance per shard, the rest of the step
    # whole on the lead
    smesh = shd.make_zmesh(ZSHARDS, devices=[
        torch.device("cuda", i) for i in range(torch.cuda.device_count())])
    dom, state = bench_state(smoke, Domain, Sphere, RES, dev)
    zs_windows = []
    zs_numbers, zst = drive_smoke(
        "smoke_zshard_128", params, dom, state, [(0, 10), (30, 10)],
        {"window_advect_zshard": 8 * ZSHARDS, "cg_solve": 1}, zshard=smesh,
        window_states=zs_windows)
    del state
    # each timed window against 10 one-domain steps from its first state
    for (first, last), what in zip(zs_windows, ("cold", "developed")):
        one = smoke.smoke_run(first, dom, params, 10)
        for f in ("density", "vel", "pressure", "cg_iters"):
            require(torch.equal(getattr(one, f), getattr(last, f)),
                    f"smoke zshard ({what} window): {f} differs from the "
                    "one-domain steps")
    zs_numbers["equal_to_one_domain_bitwise"] = True
    print(f"smoke zshard {RES}^3 over {smesh.n} shards: both timed windows "
          "bit for bit the one-domain steps (density, vel, pressure)",
          flush=True)
    zs_cold = zs_windows[0][0]
    del zs_windows, one, first, last

    zs_sites = {"window_advect_zshard": (advk, "window_pass_slab"),
                "halo_z": (shd, "halo_z"), "scatter_z": (shd, "scatter_z")}

    def record_zstep(st):
        calls = {k: [] for k in zs_sites}
        with contextlib.ExitStack() as stack:
            for k, (mod, name) in zs_sites.items():
                stack.enter_context(recording(mod, name, calls[k]))
            smoke.smoke_step(st, dom, params, zshard=smesh)
        torch.cuda.synchronize()
        # the slab calls without their output views (a replay writes new
        # tensors)
        calls["window_advect_zshard"] = [
            (a[:9], {}) for a, _ in calls["window_advect_zshard"]]
        return calls

    k1z_err = 0.0
    for st_, what in ((zs_cold, "cold"), (zst, "developed")):
        zc = record_zstep(st_)
        require(len(zc["window_advect_zshard"]) == 8 * smesh.n,
                f"smoke zshard: {len(zc['window_advect_zshard'])} slab "
                "calls in a step")
        for a, _ in zc["window_advect_zshard"]:
            got = advk.window_pass_slab(*a)
            ref = advk.window_slab_plain(*a)
            if not a[8]:
                got, ref = (got,), (ref,)
            for g, r in zip(got, ref):
                if r.dtype == torch.bool:
                    require(torch.equal(g, r), "window_advect_zshard: have "
                            "differs")
                else:
                    k1z_err = max(k1z_err, float((g - r).abs().max()))
        require(k1z_err <= 1e-6,
                f"window_advect_zshard: max abs err {k1z_err}")
        print(f"window_advect_zshard {what} step's {len(zc['window_advect_zshard'])}"
              f" slab launches vs plain: max abs err {k1z_err:.3g}",
              flush=True)
    del zs_cold
    # the developed step's slab launches: time, bound, library
    zslab = zc["window_advect_zshard"]
    k1z_names = sorted({"window_advect_kernel<%s,%s,true,true>" % (
        str(a[8]).lower(), str(a[8] and a[7] is not None).lower())
        for a, _ in zslab})
    k1z_ms, k1z_call_ms, k1z_timed_by = timed_launches(
        torch, replay(zslab, advk.window_pass_slab), 5, k1z_names,
        len(zslab), graph=True)
    k1z_plain_ms = cuda_ms(torch, replay(zslab, advk.window_slab_plain),
                           1) / len(zslab)
    k1z_bytes = sum(a[1].numel() * (12 + 4 + (9 if a[8] else 0))
                    + a[0].numel() * (4 + (1 if a[7] is not None else 0))
                    for a, _ in zslab) / len(zslab)
    k1z_ops = sum(a[1].numel() * 60 for a, _ in zslab) / len(zslab)
    k1z_bound = (k1z_bytes / HBM_BYTES_PER_S * 1e3,
                 k1z_ops / FP32_OPS_PER_S * 1e3)
    k1z_library = library_vs_window(torch, zslab, advk.window_pass_slab,
                                    True, slab=True)
    zs_copies = {k: cuda_ms(torch, replay(zc[k], getattr(*zs_sites[k])), 5)
                 for k in ("halo_z", "scatter_z")}
    zs_numbers["copies_ms_per_step"] = zs_copies
    print(f"window_advect_zshard: {k1z_ms * 1e3:.1f} us/launch (bound "
          f"{max(k1z_bound) * 1e3:.1f} us), plain {k1z_plain_ms:.2f} ms, "
          f"grid_sample {k1z_library['library_ms'] * 1e3:.1f} us; copies per "
          "step (ms): " + ", ".join(f"{k} {v:.3f} ({len(zc[k])} calls)"
                                    for k, v in zs_copies.items()),
          flush=True)
    del zc, zslab, zst
    # 3 steps at 16^3 over 4 slabs of k+1 planes on the card against the CPU
    xs = []
    for d_ in (dev, "cpu"):
        m_ = shd.make_zmesh(ZSHARDS, devices=smesh.devices if d_ is dev
                            else [d_])
        xdom_, s_ = bench_state(smoke, Domain, Sphere, 16, d_)
        require(xdom_.shape[0] // m_.n == K + 1, "16^3 zshard: slab planes")
        for _ in range(3):
            s_ = smoke.smoke_step(s_, xdom_, params, zshard=m_)
        xs.append(s_)
    zs16 = max(float((getattr(xs[0], f).cpu() - getattr(xs[1], f))
                     .abs().max()) for f in ("vel", "density", "pressure"))
    require(torch.equal(xs[0].flags.cpu(), xs[1].flags) and zs16 < 2e-4,
            f"16^3 smoke zshard card vs CPU: grids {zs16}")
    zs_numbers["card_vs_cpu_16"] = zs16
    print(f"16^3 smoke zshard x3 steps over {ZSHARDS} slabs of {K + 1} "
          f"planes, card vs CPU: grids {zs16:.3g}", flush=True)
    del xs

    # -- 22. the 2D flat FLIP dam at FLAT2D_RES^2 ---------------------------
    # tests/test_torch_flat_flip.py's dam_2d (scenes/flip01_simple.py in 2D:
    # no ghost fluid, discretization 3) grown to the 2D plume's size; per
    # step 6 layers of the layer kernel's 2D instance (2 pairs each) and 1 CG
    d2params = flip.FlipParams(gravity=(0.0, -0.002, 0.0))
    d2dom = Domain(size=(FLAT2D_RES, FLAT2D_RES, 1), dim=2)
    d2_per_step = {"extrap_layer": 6, "cg_solve": 1}
    d2_numbers, _, d2_last, d2_launches = drive_flat(
        "flat_2d", d2params, [(0, FLIP_CHUNK), (20, FLIP_CHUNK)],
        dom_=d2dom, disc=3, per_step=d2_per_step)
    d2_calls = flat_kernel_check("flat_2d", d2_last, d2params, "developed",
                                 dom_=d2dom, per_step=d2_per_step,
                                 layer_key="extrap_layer_2d")
    del d2_last
    d2_layers = d2_calls["extrap_layer"]
    pairs = sum(len(a[0]) for a, _ in d2_layers) / len(d2_layers)
    require(pairs == 2, f"flat_2d: {pairs} pairs a layer")
    T2 = d2dom.num_cells
    time_kernel("extrap_layer_2d", "extrap_layer_kernel<false>", d2_layers,
                xk.extrap_layer, xk.extrap_layer_plain, pairs * 16 * T2,
                pairs * 14 * T2, "2D dam developed step's layers")
    del d2_calls, d2_layers
    d2_numbers["card_vs_cpu_64"] = flat_card_vs_cpu(
        "dam 2D", d2params, dom_=Domain(size=(64, 64, 1), dim=2), disc=3)

    # -- 23. the scene API's FLIP functions and extrapolation options -------
    # on the flat 128^3 dam's developed state (phase 14), with an obstacle
    # sphere's levelset (and its cells as obstacles for into_obs); the two
    # extrapolations through the layer kernel: 4 three-pair layers, then a
    # marker-only layer and 3 three-pair ones
    def scene_functions(st, dom_, phi_obs, avg=None):
        """The functions on ``st``: the averaged levelset (or ``avg``)
        feeds combine_grid_vel, adjust_number and the Vec3 extrapolation,
        so that each is held alone."""
        flags_obs = torch.where(phi_obs < 0.0, fl.TypeObstacle, st.flags)
        weight = fo.map_parts_to_mac(st.parts, st.pvel, st.flags, dom_)[1]
        levelsets = {"averaged_particle_levelset": lambda:
                     fo.averaged_particle_levelset(st.parts, st.flags, dom_),
                     "improved_particle_levelset": lambda:
                     fo.improved_particle_levelset(st.parts, st.flags, dom_)}
        res = {k: f() for k, f in levelsets.items()}
        phi = res["averaged_particle_levelset"] if avg is None else avg
        others = {
            "combine_grid_vel": lambda: fo.combine_grid_vel(
                st.vel, weight, st.vel_old, dom_, phi=phi, narrow_band=2.0),
            "adjust_number": lambda: fo.adjust_number(
                st.parts, st.vel, st.flags, dom_, 8, 12, phi),
            "extrapolate_mac_simple_obs": lambda: xtr.extrapolate_mac_simple(
                flags_obs, st.vel, dom_, 4, phi_obs=phi_obs, into_obs=True),
            "extrapolate_vec3_simple": lambda: xtr.extrapolate_vec3_simple(
                st.vel, phi, dom_, 4)}
        res.update({k: f() for k, f in others.items()})
        return res, {**levelsets, **others}

    def obstacle_phi(dom_, d_):
        n_ = dom_.size[0]
        return Sphere(center=(n_ * 0.7, n_ * 0.3, n_ * 0.5),
                      radius=n_ * 0.12).compute_levelset(dom_, d_)

    torch.cuda.synchronize()
    xk.extrap_layer.launches = 0
    sc_res, sc_fns = scene_functions(flat_last, fdom,
                                     obstacle_phi(fdom, dev))
    torch.cuda.synchronize()
    require(xk.extrap_layer.launches == 4 + 4,
            f"scene functions: {xk.extrap_layer.launches} layer launches")
    for k in ("averaged_particle_levelset", "improved_particle_levelset"):
        phi_ = sc_res[k]
        require(bool(torch.isfinite(phi_).all()) and bool((phi_ < 0).any())
                and bool((phi_ > 0).any()), f"{k}: not a levelset")
    adj = sc_res["adjust_number"]
    adj_active = adj.active_mask()
    require(int(adj.count) == adj.capacity
            and bool(torch.isfinite(adj.pos[adj_active]).all()),
            "adjust_number: count or positions")
    for k in ("combine_grid_vel", "extrapolate_mac_simple_obs",
              "extrapolate_vec3_simple"):
        r_ = sc_res[k]
        require(all(bool(torch.isfinite(t).all())
                    for t in (r_ if isinstance(r_, tuple) else (r_,))),
                f"{k}: not finite")
    scene_ms = {k: cuda_ms(torch, f, 1) for k, f in sc_fns.items()}
    scene_fn_numbers = {"ms_at_128": scene_ms,
                     "active_after_adjust_number": int(adj_active.sum()),
                     "active_before": int(flat_last.parts.active_mask()
                                          .sum())}
    print(f"scene functions on the developed flat {FLIP_RES}^3 dam (ms): "
          + ", ".join(f"{k} {v:.2f}" for k, v in scene_ms.items())
          + f"; adjust_number: {scene_fn_numbers['active_before']} -> "
          f"{scene_fn_numbers['active_after_adjust_number']} active",
          flush=True)
    # the developed dam's grids, for phase 28's whitewater
    dam_grids = {k: getattr(flat_last, k).cpu() for k in ("flags", "vel",
                                                          "phi")}
    del sc_res, sc_fns, adj, flat_last
    # at 24^3 on the card and on the CPU, from one state (3 CPU steps) and
    # one averaged levelset (the CPU's): the averaged levelset to abs 1e-5
    # (the card's scatter-adds sum in another order), the extrapolations to
    # 1e-6, combine_grid_vel and adjust_number exact. The improved levelset
    # is held in its two stages: its sums are the averaged levelset's, and
    # its correction from the card's sums, on the card and on the CPU, to
    # 1e-5; end to end it is only reported (its eigenvalue jumps where the
    # cubic's discriminant changes sign, so sums in another order move a
    # few cells by up to a radius)
    c_st = flip.flip_run(flip.make_dam_state(sdom, flat_params,
                                             device="cpu"), sdom,
                         flat_params, 3)
    g_st = flip.flat_state_from_numpy(flip.flat_state_to_numpy(c_st),
                                      device=dev)
    c_res, _ = scene_functions(c_st, sdom, obstacle_phi(sdom, "cpu"))
    g_res, _ = scene_functions(g_st, sdom, obstacle_phi(sdom, dev),
                               avg=c_res["averaged_particle_levelset"].to(dev))
    scene_cpu = {}
    radius = 0.5 * fo._radius_factor(sdom, 1.0)
    have_g, pavg_g = fo._averaged_positions(g_st.parts, sdom, radius, None,
                                            0)
    corr_args = (sdom, radius, 1, 1, 0.4, 3.5)
    e = float((fo._corrected_levelset(have_g, pavg_g, *corr_args).cpu()
               - fo._corrected_levelset(have_g.cpu(), pavg_g.cpu(),
                                        *corr_args)).abs().max())
    require(e <= 1e-5, f"24^3 improved levelset's correction card vs CPU: "
            f"{e}")
    scene_cpu["improved_particle_levelset_correction"] = e
    scene_cpu["improved_particle_levelset_end_to_end"] = float(
        (g_res["improved_particle_levelset"].cpu()
         - c_res["improved_particle_levelset"]).abs().max())
    del have_g, pavg_g
    for k, tol in (("averaged_particle_levelset", 1e-5),
                   ("extrapolate_mac_simple_obs", 1e-6),
                   ("extrapolate_vec3_simple", 1e-6),
                   ("combine_grid_vel", 0.0)):
        g_, c_ = g_res[k], c_res[k]
        g_, c_ = (g_, c_) if isinstance(g_, tuple) else ((g_,), (c_,))
        e = max(float((a_.cpu() - b_).abs().max()) for a_, b_ in zip(g_, c_))
        require(e <= tol, f"24^3 {k} card vs CPU: {e} > {tol}")
        scene_cpu[k] = e
    ga, ca = g_res["adjust_number"], c_res["adjust_number"]
    require(torch.equal(ga.pos.cpu(), ca.pos)
            and torch.equal(ga.flags.cpu(), ca.flags)
            and int(ga.count) == int(ca.count),
            "24^3 adjust_number card vs CPU: particles differ")
    scene_cpu["adjust_number"] = 0.0
    scene_fn_numbers["card_vs_cpu_24"] = scene_cpu
    print("24^3 scene functions card vs CPU: " + ", ".join(
        f"{k} {v:.3g}" for k, v in scene_cpu.items()), flush=True)
    del c_st, g_st, c_res, g_res, ga, ca

    # -- 24-25: a levelset liquid and an obstacle flow, scene loops --------
    scene_kernels = {**flip_kernels, "window_advect": advk.window_pass,
                     "window_advect_zshard": advk.window_pass_slab}
    scene_paths = {}  # launches by path
    scene_numbers = {}

    def drive_scene(name, step, st, per_step):
        """Drive a scene loop ``step`` (a function of the state dict, whose
        "it" is the step's CG iterations) from ``st``: 1 warm step, 10
        timed, 30 more, 10 timed (CUDA events). Every kernel's count is set
        to 0 just before the warm step and read after the last; the
        launches per step (``per_step``, every other kernel 0) are checked.
        Then 10 developed steps under torch.profiler give the device busy
        ms, the device launches (kernels, copies, fills) and the traced
        wall per step. Returns the numbers and the last state."""
        torch.cuda.synchronize()
        for fn in scene_kernels.values():
            fn.launches = 0
        st = step(st)  # warm
        timed_, n_steps = [], 1
        for pre in (0, 30):
            for _ in range(pre):
                st = step(st)
            iters = torch.zeros((), dtype=torch.int64, device=dev)
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(10):
                st = step(st)
                iters += st["it"]
            t1.record()
            torch.cuda.synchronize()
            timed_.append((t0.elapsed_time(t1) / 10, int(iters) / 10))
            n_steps += pre + 10
        got = {k: getattr(fn, "launches", 0)
               for k, fn in scene_kernels.items()}
        for k, n in got.items():
            want = per_step.get(k, 0) * n_steps
            require(n == want, f"{name}: {k} launched {n} times in {n_steps} "
                    f"steps (expected {want})")
        for k, v in st.items():
            if isinstance(v, torch.Tensor) and v.is_floating_point():
                require(bool(torch.isfinite(v).all()), f"{name}: {k} not "
                        "finite")
        # the traced window: device busy, launches and idle per step
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(10):
                st = step(st)
            t1.record()
            torch.cuda.synchronize()
        traced_ms = t0.elapsed_time(t1) / 10
        busy_us, count = 0.0, 0
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            if us > 0:
                busy_us += us
                count += e.count
        busy_ms = busy_us / 1e3 / 10
        require(busy_ms > 0, f"{name}: the trace holds no device time")
        (cold_ms, cold_it), (dev_ms, dev_it) = timed_
        numbers = {"ms_per_step_cold": cold_ms, "ms_per_step_developed":
                   dev_ms, "cg_iters_per_step_cold": cold_it,
                   "cg_iters_per_step_developed": dev_it,
                   "steps_run": n_steps, "kernel_launches_per_step": per_step,
                   "traced_wall_ms_per_step": traced_ms,
                   "device_busy_ms_per_step": busy_ms,
                   "device_launches_per_step": count / 10,
                   "idle_share_traced": 1.0 - busy_ms / traced_ms}
        print(f"{name}: {n_steps} steps, {cold_ms:.2f} ms/step cold, "
              f"{dev_ms:.2f} developed, CG {cold_it:.1f} / {dev_it:.1f} "
              f"it/step; traced: {traced_ms:.2f} ms/step, device busy "
              f"{busy_ms:.2f} ms, {count / 10:.0f} device launches a step, "
              f"idle {100 * numbers['idle_share_traced']:.1f} %; kernel "
              f"launches {dict((k, v) for k, v in got.items() if v)}",
              flush=True)
        scene_paths[name] = got
        scene_numbers[name] = numbers
        return numbers, st

    def record_scene_step(step, st):
        """The K2 and K14 calls of one step from ``st``."""
        calls = {"cg_solve": [], "extrap_layer": []}
        with recording(prk, "cg_solve", calls["cg_solve"]), \
                recording(xk, "extrap_layer", calls["extrap_layer"]):
            step(st)
        torch.cuda.synchronize()
        return calls

    def tracked_iterations(rhs, stencil, fluid, dom_, most=10):
        """How many CG iterations from zero (up to ``most``) the plain
        float32 CG stays within rel 1e-6 of the float64 CG on this system,
        and their distance at the first iteration past that: beyond it the
        system amplifies float32 rounding (a ghost-fluid diagonal grows
        like 1 / the clamped fraction), so two float32 CGs that sum in
        another order part there too, and cg_check_by_residual holds K2 to
        cg_plain over these iterations only."""
        st64 = tuple(a.double() for a in stencil)
        tracked, rel = 0, 0.0
        for n in range(1, most + 1):
            p32 = prs.cg_plain(rhs, stencil, dom_, 0.0, n, fluid)[0]
            p64 = prs.cg_plain(rhs.double(), st64, dom_, 0.0, n, fluid)[0]
            rel = float((p32.double() - p64).abs().max()) / (
                float(p64.abs().max()) + 1e-300)
            if rel > 1e-6:
                break
            tracked = n
        require(tracked > 0, f"CG float32 vs float64 at 1 iteration: {rel}")
        return tracked, rel

    def scene_card_vs_cpu(name, setup, step, dom_, keys, solved=(),
                          acc=None):
        """3 steps on the card and on the CPU from the same setup: flags
        exact, the grids ``keys`` abs 2e-4. ``solved``: grids downstream
        of a pressure solve (at accuracy ``acc``) whose exit the order of
        the CG's sums moves by more than that; on the CPU alone a
        float64-accumulated dot moves the k-epsilon channel's velocity by
        7.9e-4 after 3 steps at equal iterations (its closed box has no
        Dirichlet cell). Those are held by each device's last solve,
        max|rhs - A p| over the fluid cells under the accuracy (+1 %), and
        to 2e-3 x max(1, max|CPU value|)."""
        out = []
        for d_ in (dev, "cpu"):
            st = setup(dom_, d_)
            for _ in range(3):
                st = step(st, dom_)
            out.append(st)
        g_, c_ = out
        require(torch.equal(g_["flags"].cpu(), c_["flags"]),
                f"{name} card vs CPU: flags differ")
        err = max(float((g_[k].cpu() - c_[k]).abs().max()) for k in keys)
        require(err < 2e-4, f"{name} card vs CPU: grids {err}")
        msg = ""
        for k in solved:
            scale = max(1.0, float(c_[k].abs().max()))
            e_ = float((g_[k].cpu() - c_[k]).abs().max()) / scale
            require(e_ < 2e-3, f"{name} card vs CPU: {k} {e_}")
            msg += f", {k} {e_:.3g} of its scale"
        if solved:
            for st in out:
                stencil = prs.make_laplace_stencil(st["flags"], dom_)
                r_ = torch.where(fl.is_fluid(st["flags"]), st["rhs"]
                                 - prs.apply_laplace(st["flags"],
                                                     st["pressure"],
                                                     stencil, dom_), 0.0)
                res = float(r_.abs().max())
                require(res < 1.01 * acc, f"{name}: residual {res}")
                msg += f", residual {res:.3g}"
        print(f"{name} x3 steps, card vs CPU: grids {err:.3g}{msg}, CG "
              f"{int(g_['it'])} / {int(c_['it'])} it", flush=True)
        return err

    # 24. scenes/surfaceTension.py at SURF_RES^3 (the scene's 40^3 occupies
    # no card): a liquid box (0.25-0.75) pulled round by surface tension,
    # dt 0.25; each call mirrors one line of the scene's loop. Cut: the
    # scene's createMesh every step; marching_cubes runs once, on the
    # developed state
    def surface_setup(dom_, d_):
        n_ = dom_.size[0]
        phi = Box(p0=(n_ * 0.25,) * 3, p1=(n_ * 0.75,) * 3).compute_levelset(
            dom_, d_)
        flags = fl.update_from_levelset(fl.init_domain(dom_, 1, device=d_),
                                        phi, 1e10)
        z = torch.zeros(dom_.shape, device=d_)
        return {"flags": flags, "phi": phi, "vel": torch.zeros(
            (3,) + dom_.shape, device=d_), "pressure": z,
            "it": torch.zeros((), dtype=torch.int32, device=d_)}

    def set_bound_neumann(g, dom_, w):
        """Grid.setBoundNeumann(w): the first interior layer copied into
        the boundary shells (the JAX package's scene/api.py:306-326)."""
        for ax, n_ in (("x", dom_.shape[2]), ("y", dom_.shape[1]),
                       ("z", dom_.shape[0])):
            idx = axis_index(dom_, ax, g.device)
            for layer in range(w + 1):
                g = torch.where(idx == w - layer, shift(g, 1, ax), g)
                g = torch.where(idx == n_ - 1 - w + layer, shift(g, -1, ax),
                                g)
        return g

    def surface_step(st, dom_):
        flags, phi, vel = st["flags"], st["phi"], st["vel"]
        phi, vel = lso.reinit_marching(phi, flags, dom_, vel=vel)
        phi = sladv.advect_real(flags, vel, phi, 0.25, order=1)
        phi = set_bound_neumann(phi, dom_, 1)
        flags = fl.update_from_levelset(flags, phi, 1e10)
        vel = sladv.advect_mac(flags, vel, vel, 0.25, order=2)
        vel = ext.set_wall_bcs(flags, vel, dom_)
        curv = get_curvature(phi, dom_)
        vel, p, _, it, _ = prs.solve_pressure(
            vel, flags, dom_, 5e-4, phi=phi, curv=curv, surf_tens=0.1,
            preconditioner=prs.PcMIC)
        return {"flags": flags, "phi": phi, "vel": vel, "pressure": p,
                "it": it}

    st_dom = Domain(size=(SURF_RES,) * 3)
    st0 = surface_setup(st_dom, dev)
    vol0 = int((st0["phi"] < 0).sum())
    st_numbers, st_last = drive_scene(
        f"surface_tension_{SURF_RES}", lambda s: surface_step(s, st_dom),
        st0, {"cg_solve": 1})
    del st0
    vol = int((st_last["phi"] < 0).sum())
    require(0.5 * vol0 < vol < 2.0 * vol0,
            f"surface tension: liquid cells {vol0} -> {vol}")
    require(float(st_last["vel"].abs().max()) > 1e-3,
            "surface tension: the liquid did not move")
    st_numbers["liquid_cells"] = [vol0, vol]
    # the native fast march (the reference's serial heap, on the host)
    # against the card's data-parallel transport (on the native phi), in
    # the band. On tests/test_levelset.py:132-166's fixture at SURF_RES^3
    # (the basin and drop, its sinusoidal velocity): that test's bounds. On
    # the developed liquid: the card's transport bit for bit its plain
    # version on the host; its distance from the native march is the
    # replay's own (it accepts an event whose distance ties the best so
    # far, so an ulp decides which neighbours weigh in on a curved surface)
    # and is reported
    def transport_vs_native(phi_np, flags_np, vel_np):
        t0 = time.perf_counter()
        phi_ref, vel_ref = native.reinit_march(phi_np, flags_np,
                                               vel_np.copy(), max_time=4.0)
        native_s = time.perf_counter() - t0
        args = [torch.from_numpy(a) for a in (phi_ref, flags_np, vel_np)]
        vt = lso.value_transport_mac(*(a.to(dev) for a in args),
                                     st_dom).cpu().numpy()
        band = (phi_ref > 0) & (phi_ref <= 4.0)
        band[[0, -1], :, :] = band[:, [0, -1], :] = False
        band[:, :, [0, -1]] = False
        d_ = np.abs(vt - vel_ref)[:, band]
        return vt, args, {"mean_abs": float(d_.mean()),
                          "share_over_0.05": float((d_ > 0.05).mean()),
                          "band_cells": int(band.sum()),
                          "native_march_s": native_s}

    # what that rests on: PyTorch's CUDA float32 sqrt is not correctly
    # rounded, ops/levelset.py's float64 root and tensor division are
    x_ = torch.rand(10_000_000, generator=torch.Generator().manual_seed(0))
    x_ = x_ * 10
    sqrt_off = int((torch.sqrt(x_.to(dev)).cpu() != torch.sqrt(x_)).sum())
    require(all(torch.equal(f(x_.to(dev)).cpu(), f(x_))
                for f in (lso._sqrt, lso._third)),
            "levelset's rounding helpers differ between the card and the CPU")
    st_numbers["cuda_float32_sqrt_off_of_1e7"] = sqrt_off
    print(f"rounding: PyTorch's CUDA float32 sqrt differs from the CPU's on "
          f"{sqrt_off} of 10^7 inputs; the levelset's float64 root and "
          "tensor division are equal", flush=True)
    del x_
    n_ = SURF_RES
    bphi = torch.minimum(
        Box(p0=(0.0, 0.0, 0.0), p1=(n_, n_ * 0.25, n_)).compute_levelset(
            st_dom, "cpu"),
        Sphere(center=(n_ * 0.5, n_ * 0.6, n_ * 0.5),
               radius=n_ * 0.15).compute_levelset(st_dom, "cpu"))
    bflags = fl.update_from_levelset(fl.init_domain(st_dom, 1, device="cpu"),
                                     bphi, 1e10).numpy()
    t_ = np.arange(n_, dtype=np.float32)
    zz, yy, xx = np.meshgrid(t_, t_, t_, indexing="ij")
    bvel = np.stack([np.sin(0.4 * xx) * np.cos(0.3 * yy),
                     np.cos(0.25 * zz) * np.sin(0.35 * xx),
                     np.sin(0.3 * yy) * np.cos(0.2 * zz)]).astype(np.float32)
    _, _, basin = transport_vs_native(bphi.numpy(), bflags, bvel)
    require(basin["mean_abs"] < 5e-3 and basin["share_over_0.05"] < 0.02,
            f"transport vs the native march on the basin and drop: {basin}")
    del bphi, bflags, bvel, zz, yy, xx
    phi_np = st_last["phi"].cpu().numpy()
    vt, args, developed = transport_vs_native(
        phi_np, st_last["flags"].cpu().numpy(),
        st_last["vel"].cpu().numpy())
    require(np.array_equal(vt, lso.value_transport_mac(*args,
                                                       st_dom).numpy()),
            "surface tension: the card's transport differs from the CPU's")
    # the card's parallel redistancing against its plain version and,
    # reported, against the serial march
    card_phi = lso.reinit(st_last["phi"], st_last["flags"], st_dom).cpu()
    require(torch.equal(card_phi, lso.reinit(st_last["phi"].cpu(),
                                             st_last["flags"].cpu(), st_dom)),
            "surface tension: the card's redistancing differs from the CPU's")
    near = np.abs(args[0].numpy()) <= 4.0
    phi_d = np.abs(card_phi.numpy() - args[0].numpy())[near]
    st_numbers["native_vs_card"] = {
        "basin_and_drop": basin, "developed": developed,
        "developed_card_equals_cpu": True,
        "phi_max_abs_in_band": float(phi_d.max()),
        "phi_mean_abs_in_band": float(phi_d.mean())}
    print(f"surface tension: transport on the native march's phi vs its "
          f"own, in the band: basin and drop {basin}; developed "
          f"{developed} (the card's transport and redistancing bit for bit "
          f"the CPU's); card redistancing vs native phi in |phi| <= 4: max "
          f"{float(phi_d.max()):.3g}, mean {float(phi_d.mean()):.3g}",
          flush=True)
    del vt, args, card_phi, near, phi_d
    # createMesh once: marching cubes on the host, watertight
    t0 = time.perf_counter()
    nodes, tris = trimesh.marching_cubes(phi_np)
    mc_s = time.perf_counter() - t0
    edges = np.sort(np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]],
                                    tris[:, [2, 0]]]), axis=1)
    _, per_edge = np.unique(edges, axis=0, return_counts=True)
    require(len(tris) > 1000 and (per_edge == 2).all(),
            f"surface tension mesh: {len(tris)} triangles, edges with "
            f"{sorted(set(per_edge.tolist()))} triangles")
    st_numbers["mesh"] = {"nodes": len(nodes), "triangles": len(tris),
                          "marching_cubes_s": mc_s, "watertight": True}
    print(f"surface tension mesh: {len(nodes)} nodes, {len(tris)} "
          f"triangles in {mc_s:.2f} s on the host, every edge in two",
          flush=True)
    del phi_np, nodes, tris, edges, per_edge
    # K2 of a developed step (ghost fluid with surface tension, full mode)
    # against cg_plain, by its residual: the exit is chaotic at 5e-4
    sc = record_scene_step(lambda s: surface_step(s, st_dom), st_last)
    require(len(sc["cg_solve"]) == 1 and not sc["extrap_layer"],
            "surface tension: kernel calls in a step")
    (cg_args, cg_kw), = sc["cg_solve"]
    tracked, drift = tracked_iterations(cg_args[0], cg_args[1],
                                        cg_kw["fluid"], st_dom)
    diag = float(cg_args[1][0][cg_kw["fluid"]].max())
    print(f"surface tension developed system: diagonal up to {diag:.5g}; "
          f"float32 CG within rel 1e-6 of float64 for {tracked} iterations, "
          f"{drift:.3g} after", flush=True)
    st_numbers["cg_float32_tracks_float64_iterations"] = [tracked, drift]
    st_numbers["cg_diagonal_max"] = diag
    k2_err = max(k2_err, cg_check_by_residual(
        cg_args[0], cg_args[1], cg_kw["fluid"], cg_args[3], cg_args[4],
        st_dom, early=tracked))
    st_it = int(prk.cg_solve(*cg_args, **cg_kw)[1])
    sn = st_dom.num_cells
    time_kernel("cg_solve_surface", "cg_kernel<false>", sc["cg_solve"],
                prk.cg_solve, prs.cg_plain, 6 * 4 * sn, st_it * 24 * sn,
                f"surface tension developed solve, {st_it} it")
    fk["cg_solve_surface"]["iterations"] = st_it
    fk["cg_solve_surface"]["us_per_iteration"] = (
        fk["cg_solve_surface"]["ms"] * 1e3 / max(st_it, 1))
    del sc, cg_args, cg_kw, st_last
    st_numbers["card_vs_cpu_24"] = scene_card_vs_cpu(
        "surface tension 24^3", surface_setup, surface_step,
        Domain(size=(24,) * 3), ("phi", "vel", "pressure"))

    # 25. scenes/karman.py with its switches set to dim = 3, res =
    # KARMAN_RES: 2 res x res x res cells, inflow x walls, the obstacle
    # cylinder (r = 0.2 res) and the inflow cylinder (0.21 res) along z,
    # sec_order_bc, dt 1; the initial y-noise (addNoise on the testall SDF
    # and setComponent, karman.py:40-51: posScale 75, clamp +-1, scale 0.1)
    KM_VEL = (0.9, 0.0, 0.0)

    def karman_setup(dom_, d_):
        gs = dom_.size
        res_ = gs[1]
        flags = fl.init_domain(dom_, 0, inflow="xX", device=d_)
        walls = "".join(c for c in "xXyYzZ" if c not in "xX")
        phi_walls = fl._wall_sdf(dom_, 0, walls, device=d_)
        center = (gs[0] * 0.25, gs[1] * 0.5, gs[2] * 0.5)
        axis = (0.0, 0.0, float(gs[2]))
        phi_obs = torch.minimum(Cylinder(center, res_ * 0.2, axis)
                                .compute_levelset(dom_, d_), phi_walls)
        fractions = obs.update_fractions(flags, phi_obs, dom_)
        flags = obs.set_obstacle_flags(flags, phi_obs, dom_,
                                       fractions=fractions)
        flags = fl.fill_grid(flags)
        vel = torch.zeros((3,) + dom_.shape, device=d_)
        vel[0] = KM_VEL[0]
        noise = WaveletNoiseField(dom_, -1, True, device=d_)
        noise.pos_scale = (75.0, 75.0, 75.0)
        noise.clamp, noise.clamp_neg, noise.clamp_pos = True, -1.0, 1.0
        z = torch.zeros(dom_.shape, device=d_)
        vel[1] = ini.add_noise(flags, z, noise, dom_, sdf=z - 1.0, scale=0.1,
                               time=0.0)
        return {"flags": flags, "phi_obs": phi_obs, "fractions": fractions,
                "inflow": Cylinder(center, res_ * 0.21, axis), "vel": vel,
                "density": torch.zeros(dom_.shape, device=d_),
                "pressure": torch.zeros(dom_.shape, device=d_),
                "it": torch.zeros((), dtype=torch.int32, device=d_)}

    def karman_step(st, dom_):
        flags, phi_obs, fr = st["flags"], st["phi_obs"], st["fractions"]
        density = st["inflow"].apply_to_grid(st["density"], 2.0, dom_)
        vel = st["vel"]
        density = sladv.advect_real(flags, vel, density, 1.0, order=2,
                                    order_space=1)
        vel = sladv.advect_mac(flags, vel, vel, 1.0, order=2)
        vel = xtr.extrapolate_mac_simple(flags, vel, dom_, 2, into_obs=True)
        vel = ext.set_wall_bcs_frac(flags, vel, dom_, phi_obs)
        vel = ext.set_inflow_bcs(vel, dom_, "xX", KM_VEL)
        vel, p, _, it, _ = prs.solve_pressure(
            vel, flags, dom_, 1e-4, fractions=fr, cg_max_iter_fac=5.0,
            preconditioner=prs.PcMIC)
        vel = xtr.extrapolate_mac_simple(flags, vel, dom_, 5, into_obs=True)
        vel = ext.set_wall_bcs_frac(flags, vel, dom_, phi_obs)
        vel = ext.set_inflow_bcs(vel, dom_, "xX", KM_VEL)
        return {**st, "density": density, "vel": vel, "pressure": p,
                "it": it}

    km_dom = Domain(size=(2 * KARMAN_RES, KARMAN_RES, KARMAN_RES))
    km0 = karman_setup(km_dom, dev)
    require(bool(fl.is_obstacle(km0["flags"])[1:-1, 1:-1, 1:-1].any())
            and bool(fl.is_inflow(km0["flags"]).any()),
            "karman: no obstacle or inflow cells")
    km_plan = prk.cg_plan(km_dom.shape, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    require(km_plan.overflow > 0, f"karman fits on chip: {km_plan}")
    km_numbers, km_last = drive_scene(
        f"karman_3d_{KARMAN_RES}", lambda s: karman_step(s, km_dom), km0,
        {"cg_solve": 1, "extrap_layer": 2 + 5})
    del km0
    require(float(km_last["density"].max()) > 1.0,
            "karman: no density downstream of the inflow cylinder")
    wake = km_last["vel"][0, :, KARMAN_RES // 2, KARMAN_RES:]
    km_numbers["wake_u_mean"] = float(wake.mean())
    km_numbers["cg_plan"] = dataclasses.asdict(km_plan)
    print(f"karman 3D: {km_plan.overflow} of "
          f"{km_plan.onchip + km_plan.overflow} cells per block off chip; "
          f"wake u {float(wake.mean()):.3f}", flush=True)
    del wake
    # K2 (fractions, the spill path) and K14 of a developed step against
    # their plain versions: the layers exact, K2 by its residual
    kc = record_scene_step(lambda s: karman_step(s, km_dom), km_last)
    require(len(kc["cg_solve"]) == 1 and len(kc["extrap_layer"]) == 7,
            "karman: kernel calls in a step")
    for args, kwargs in kc["extrap_layer"]:
        errs["extrap_layer"] = max(errs["extrap_layer"], check_call(
            "extrap_layer", args, kwargs))
    (cg_args, cg_kw), = kc["cg_solve"]
    tracked, drift = tracked_iterations(cg_args[0], cg_args[1],
                                        cg_kw["fluid"], km_dom)
    print(f"karman developed system: float32 CG within rel 1e-6 of float64 "
          f"for {tracked} iterations, {drift:.3g} after", flush=True)
    km_numbers["cg_float32_tracks_float64_iterations"] = [tracked, drift]
    k2_err = max(k2_err, cg_check_by_residual(
        cg_args[0], cg_args[1], cg_kw["fluid"], cg_args[3], cg_args[4],
        km_dom, early=tracked))
    km_it = int(prk.cg_solve(*cg_args, **cg_kw)[1])
    kn = km_dom.num_cells
    time_kernel("cg_solve_karman", "cg_kernel<false>", kc["cg_solve"],
                prk.cg_solve, prs.cg_plain, 6 * 4 * kn, km_it * 24 * kn,
                f"karman developed solve, {km_it} it, spill path")
    fk["cg_solve_karman"]["iterations"] = km_it
    fk["cg_solve_karman"]["us_per_iteration"] = (
        fk["cg_solve_karman"]["ms"] * 1e3 / max(km_it, 1))
    fk["cg_solve_karman"]["cells_off_chip_per_block"] = km_plan.overflow
    layer_calls = kc["extrap_layer"]
    pairs = sum(len(a[0]) for a, _ in layer_calls) / len(layer_calls)
    time_kernel("extrap_layer_karman", "extrap_layer_kernel<true>",
                layer_calls, xk.extrap_layer, xk.extrap_layer_plain,
                pairs * 16 * kn, pairs * 20 * kn,
                "karman developed step's layers")
    print(f"karman 3D developed step, kernels vs plain: extrap_layer "
          f"{errs['extrap_layer']:.3g}, cg_solve {km_it} it at "
          f"{fk['cg_solve_karman']['us_per_iteration']:.1f} us/it",
          flush=True)
    del kc, layer_calls, cg_args, cg_kw, km_last
    km_numbers["card_vs_cpu_32x16x16"] = scene_card_vs_cpu(
        "karman 3D 32x16x16", karman_setup, karman_step,
        Domain(size=(32, 16, 16)), ("vel", "density", "pressure"))

    # -- 26-28: the breadth ops (A13) -------------------------------------
    class SceneClock:
        """The scene API's Solver stepping on the host, in Python floats
        as the scenes run it (mantaflow_tpu/scene/api.py:714-741:
        FluidSolver::step and adaptTimestep, fluidsolver.cpp:143-204)."""

        def __init__(self, dt, frame_length=1.0, cfl=3.0, dt_min=1e-4,
                     dt_max=1.0):
            self.timestep, self.frame_length, self.cfl = dt, frame_length, \
                cfl
            self.dt_min, self.dt_max = dt_min, dt_max
            self.time_total, self.frame, self._tpf = 0.0, 0, 0.0
            self._lock = False

        def adapt(self, max_vel):
            if not self._lock:
                dt = max(min(self.timestep * (
                    self.cfl / (max_vel * self.timestep + 1e-5)),
                    self.dt_max), self.dt_min)
                if self._tpf + dt * 1.05 > self.frame_length:
                    dt = (self.frame_length - self._tpf) + 1e-4
                elif (self._tpf + dt + self.dt_min > self.frame_length
                      or self._tpf + dt * 1.25 > self.frame_length):
                    dt = (self.frame_length - self._tpf + 1e-4) * 0.5
                    self._lock = True
                self.timestep = dt

        def step(self):
            self._tpf += self.timestep
            self.time_total += self.timestep
            if self._tpf + 1e-6 > self.frame_length:
                self.frame += 1
                self.time_total = float(self.frame) * self.frame_length
                self._tpf = 0.0
                self._lock = False

    def k2_of_scene(name, kind, step, st, dom_):
        """K2 of one developed step from ``st`` against cg_plain by its
        residual, and its time (us an iteration), as phases 24-25."""
        calls = record_scene_step(step, st)
        require(len(calls["cg_solve"]) == 1 and not calls["extrap_layer"],
                f"{name}: kernel calls in a step")
        (cg_args, cg_kw), = calls["cg_solve"]
        tracked, drift = tracked_iterations(cg_args[0], cg_args[1],
                                            cg_kw["fluid"], dom_)
        out = {"cg_float32_tracks_float64_iterations": [tracked, drift]}
        err = cg_check_by_residual(cg_args[0], cg_args[1], cg_kw["fluid"],
                                   cg_args[3], cg_args[4], dom_,
                                   early=tracked)
        it = int(prk.cg_solve(*cg_args, **cg_kw)[1])
        n_ = dom_.num_cells
        time_kernel(kind, "cg_kernel<false>", calls["cg_solve"],
                    prk.cg_solve, prs.cg_plain, 6 * 4 * n_, it * 24 * n_,
                    f"{name} developed solve, {it} it of {cg_args[4]}")
        fk[kind]["iterations"] = it
        fk[kind]["max_iterations"] = cg_args[4]
        fk[kind]["us_per_iteration"] = fk[kind]["ms"] * 1e3 / max(it, 1)
        print(f"{name} developed system: float32 CG within rel 1e-6 of "
              f"float64 for {tracked} iterations; K2 {it} it of "
              f"{cg_args[4]} at {fk[kind]['us_per_iteration']:.1f} us/it",
              flush=True)
        return err, out

    # 26. scenes/fire.py at FIRE_RES^3 (grown from res = 52, nothing else
    # changed): open yY bounds, four densityInflow calls a step from the
    # file-loaded noise tile (posScale 45, clamp [0, 1], valOffset 0.75,
    # timeAnim 0.2), processBurn, five order-2 exact-gather advections,
    # resetOutflow, fuel-weighted vorticity confinement, two buoyancies,
    # wall BCs, the scene API's PcMIC solvePressure (K2), updateFlame;
    # the adaptive dt of frameLength 1.2, cfl 3, timestepMin/Max 0.2/2.0
    # (one host read of max|vel| a step, as the scene)
    FIRE_GRAV_D = tuple(g * -0.001 for g in (0.0, -0.0981, 0.0))
    FIRE_GRAV_H = tuple(g * 0.1 for g in (0.0, -0.0981, 0.0))

    def fire_setup(dom_, d_):
        res_ = dom_.size[0]
        flags = fl.fill_grid(fl.init_domain(dom_, 1, device=d_))
        flags = fl.set_open_bound(flags, dom_, 1, "yY",
                                  fl.TypeOutflow | fl.TypeEmpty)
        noise = WaveletNoiseField(dom_, -1, True, device=d_)
        noise.pos_scale = (45.0, 45.0, 45.0)
        noise.clamp, noise.clamp_neg, noise.clamp_pos = True, 0.0, 1.0
        noise.val_scale, noise.val_offset, noise.time_anim = 1.0, 0.75, 0.2
        st = {k: torch.zeros(dom_.shape, device=d_) for k in
              ("density", "heat", "fuel", "react", "flame", "pressure")}
        return {**st, "flags": flags,
                "vel": torch.zeros((3,) + dom_.shape, device=d_),
                "it": torch.zeros((), dtype=torch.int32, device=d_),
                "noise": noise, "clock": SceneClock(1.1, 1.2, 3.0, 0.2, 2.0),
                "box": Box(center=(res_ * 0.5, res_ * 0.15, res_ * 0.5),
                           size=(res_ / 8, 0.05 * res_, res_ / 8))}

    def fire_step(st, dom_):
        flags, vel, clock = st["flags"], st["vel"], st["clock"]
        clock.adapt(float(torch.sqrt(torch.max(vel[0] ** 2 + vel[1] ** 2
                                               + vel[2] ** 2))))
        dt = clock.timestep
        g = {k: st[k] for k in ("density", "heat", "fuel", "react")}
        if clock.time_total < 200:
            t = clock.time_total * dom_.dx
            for k in g:
                g[k] = ini.density_inflow(flags, g[k], st["noise"],
                                          st["box"], dom_, 1.0, 0.5, time=t)
        g["fuel"], g["density"], g["react"], _, _, _, g["heat"] = \
            fire.process_burn(g["fuel"], g["density"], g["react"], dt, dom_,
                              heat=g["heat"])
        for k in g:
            g[k] = sladv.advect_real(flags, vel, g[k], dt, order=2)
        vel = sladv.advect_mac(flags, vel, vel, dt, order=2)
        flags, _, g["density"] = ext.reset_outflow_grids(flags, dom_,
                                                         real=g["density"])
        flame = g["fuel"] * 0.5
        vel = ext.vorticity_confinement(vel, flags, dom_, 0.1, flame)
        vel = ext.add_buoyancy(flags, g["density"], vel, FIRE_GRAV_D, dt,
                               dom_)
        vel = ext.add_buoyancy(flags, g["heat"], vel, FIRE_GRAV_H, dt, dom_)
        vel = ext.set_wall_bcs(flags, vel, dom_)
        vel, p, _, it, _ = prs.solve_pressure(vel, flags, dom_, 1e-3,
                                              preconditioner=prs.PcMIC)
        flame = fire.update_flame(g["react"], flame, dom_)
        clock.step()
        return {**st, **g, "flags": flags, "vel": vel, "flame": flame,
                "pressure": p, "it": it}

    fire_dom = Domain(size=(FIRE_RES,) * 3)
    fire0 = fire_setup(fire_dom, dev)
    fire_numbers, fire_last = drive_scene(
        f"fire_3d_{FIRE_RES}", lambda s: fire_step(s, fire_dom), fire0,
        {"cg_solve": 1})
    del fire0
    fire_numbers["dt_last"] = fire_last["clock"].timestep
    fire_numbers["time_total"] = fire_last["clock"].time_total
    for k, lo in (("density", 1e-3), ("flame", 0.1), ("fuel", 1e-2)):
        fire_numbers[f"{k}_max"] = float(fire_last[k].max())
        require(fire_numbers[f"{k}_max"] > lo, f"fire: {k} max "
                f"{fire_numbers[f'{k}_max']}")
    rise = float(fire_last["vel"][1].max())
    require(rise > 1e-2, f"fire: the plume did not rise ({rise})")
    print(f"fire 3D: dt {fire_numbers['dt_last']:.4f}, time "
          f"{fire_numbers['time_total']:.2f}, density max "
          f"{fire_numbers['density_max']:.3f}, flame max "
          f"{fire_numbers['flame_max']:.3f}, vel y max {rise:.3f}",
          flush=True)
    e, extra = k2_of_scene("fire 3D", "cg_solve_fire",
                           lambda s: fire_step(s, fire_dom), fire_last,
                           fire_dom)
    k2_err = max(k2_err, e)
    fire_numbers.update(extra)
    del fire_last
    fire_numbers["card_vs_cpu_24"] = scene_card_vs_cpu(
        "fire 3D 24^3", fire_setup, fire_step, Domain(size=(24,) * 3),
        ("density", "heat", "fuel", "react", "flame", "vel", "pressure"))

    # 27. scenes/turbulence.py at KEPS_RES x KEPS_RES/2 x KEPS_RES/2 (grown
    # from res = 64): 16 sphere obstacles, the generated noise tile
    # (NoiseField(), timeAnim 0), 500 turbulence particles seeded a step in
    # the box with the scene API's persistent RandomStream(34894231)
    # (scene/vortex_api.py:115-140), RK4 advectInGrid, synthesize
    # (octaves 1, switchLength 5, L0 0.01, the static ctime/inflow and the
    # tex resets of vortex_api.py:146-176) and deleteInObstacle; the
    # k-epsilon chain with diffusion (sigmaU 10), inflow BCs, PcMIC with
    # cgMaxIterFac 0.5 (K2 on its spill path). Cut: the GUI-only
    # obstacleLevelset + createMesh
    KE_INFLOW = (0.52, 0.0, 0.0)

    class TurbParticles:
        """TurbulenceParticleSystem (scene/vortex_api.py:88-210) on a
        device: positions and both texture coordinate sets, the seeding
        stream and the synthesize statics of one scene run."""

        def __init__(self, noise, d_):
            self.noise, self.d = noise, d_
            self.pos = self.tex0 = self.tex1 = torch.zeros((0, 3),
                                                           device=d_)
            self.stream = RandomStream(34894231)
            self.ctime, self.inflow = 0.0, np.zeros(3, np.float32)

        def seed(self, box, num):
            """seed (turbulencepart.cpp:57-68): rejection samples of the
            box's bounding box, on the host."""
            ext_ = np.asarray(box.get_extent(), np.float32)
            p0 = np.asarray(box.get_center(), np.float32) - ext_ * 0.5
            pts = np.empty((num, 3), np.float32)
            for i in range(num):
                while True:
                    p = self.stream.get_vec3s(1)[0] * ext_ + p0
                    if bool(box.is_inside(float(p[0]), float(p[1]),
                                          float(p[2]))):
                        break
                pts[i] = p
            new = torch.from_numpy(pts).to(self.d)
            self.pos, self.tex0, self.tex1 = (torch.cat([a, new]) for a in
                                              (self.pos, self.tex0,
                                               self.tex1))

        def advect(self, flags, vel, dt, dom_):
            n_ = self.pos.shape[0]
            parts = cp.Particles(
                pos=self.pos, flags=torch.zeros(n_, dtype=torch.int32,
                                                device=self.d),
                count=torch.tensor(n_, dtype=torch.int32, device=self.d))
            self.pos = cp.advect_in_grid(parts, flags, vel, dt, dom_, 2,
                                         delete_in_obstacle=False).pos

        def synthesize(self, flags, k, dt, dom_):
            self.inflow = self.inflow + np.asarray(KE_INFLOW,
                                                   np.float32) * dt
            old_alpha = 2.0 * ((self.ctime / 5.0) % 1.0)
            self.ctime += dt
            alpha = 2.0 * ((self.ctime / 5.0) % 1.0)
            off = torch.from_numpy(self.inflow).to(self.d)
            if old_alpha < 1.0 <= alpha:
                self.tex0 = self.pos - off
            if old_alpha > alpha:
                self.tex1 = self.pos - off
            self.pos, self.tex0, self.tex1 = vx.synthesize_turbulence(
                self.pos, self.tex0, self.tex1, flags, k, self.noise, dom_,
                1.0, dt, 1, 0.1, 1.0 / 0.01, 1.5 * 0.1 ** 2)

        def delete_in_obstacle(self, flags, dom_):
            sz, sy, sx = dom_.shape
            ci = [torch.clamp(self.pos[:, a].to(torch.int64), 0, n_ - 1)
                  for a, n_ in ((2, sz), (1, sy), (0, sx))]
            keep = (flags[ci[0], ci[1], ci[2]] & fl.TypeObstacle) == 0
            self.pos, self.tex0, self.tex1 = (a[keep] for a in
                                              (self.pos, self.tex0,
                                               self.tex1))

    def keps_setup(dom_, d_):
        gs = dom_.size
        res_ = gs[0]
        flags = fl.fill_grid(fl.init_domain(dom_, device=d_))
        for i in range(4):
            for j in range(4):
                flags = Sphere(center=(res_ * 0.2, gs[1] * (i + 1) / 5.0,
                                       gs[2] * (j + 1) / 5.0),
                               radius=res_ * 0.025).apply_to_grid(
                    flags, fl.TypeObstacle, dom_)
        z = torch.zeros(dom_.shape, device=d_)
        k, eps = kep.bcs(flags, z, z, 0.1, 0.1, True)
        noise = WaveletNoiseField(dom_, device=d_)
        return {"flags": flags, "vel": torch.zeros((3,) + dom_.shape,
                                                   device=d_),
                "k": k, "eps": eps, "pressure": z,
                "it": torch.zeros((), dtype=torch.int32, device=d_),
                "tp": TurbParticles(noise, d_),
                "box": Box(center=(res_ * 0.05, gs[1] * 0.43, gs[2] * 0.6),
                           size=(res_ * 0.02, gs[1] * 0.005, gs[2] * 0.07))}

    def keps_step(st, dom_):
        flags, vel, k, eps, tp = (st[n_] for n_ in ("flags", "vel", "k",
                                                    "eps", "tp"))
        dt = 0.5
        tp.seed(st["box"], 500)
        tp.advect(flags, vel, dt, dom_)
        tp.synthesize(flags, k, dt, dom_)
        tp.delete_in_obstacle(flags, dom_)
        k, eps = kep.bcs(flags, k, eps, 0.1, 0.1, False)
        k = sladv.advect_real(flags, vel, k, dt, order=1)
        eps = sladv.advect_real(flags, vel, eps, dt, order=1)
        k, eps = kep.bcs(flags, k, eps, 0.1, 0.1, False)
        k, eps, prod, nu_t, _ = kep.compute_production(vel, k, eps, dom_,
                                                       2.5)
        k, eps = kep.sources(k, eps, prod, dt)
        k, eps, vel = kep.gradient_diffusion(k, eps, nu_t, dt, dom_, 10.0,
                                             vel)
        vel = sladv.advect_mac(flags, vel, vel, dt, order=2)
        vel = ext.set_wall_bcs(flags, vel, dom_)
        vel = ext.set_inflow_bcs(vel, dom_, "xXyYzZ", KE_INFLOW)
        vel, p, rhs, it, _ = prs.solve_pressure(
            vel, flags, dom_, 1e-3, cg_max_iter_fac=0.5,
            preconditioner=prs.PcMIC)
        vel = ext.set_wall_bcs(flags, vel, dom_)
        vel = ext.set_inflow_bcs(vel, dom_, "xXyYzZ", KE_INFLOW)
        return {**st, "vel": vel, "k": k, "eps": eps, "pressure": p,
                "rhs": rhs, "it": it, "tp_pos": tp.pos}

    keps_dom = Domain(size=(KEPS_RES, KEPS_RES // 2, KEPS_RES // 2))
    t0 = time.perf_counter()
    keps0 = keps_setup(keps_dom, dev)
    keps_setup_s = time.perf_counter() - t0
    require(bool(fl.is_obstacle(keps0["flags"])[1:-1, 1:-1, 1:-1].any()),
            "k-epsilon: no sphere obstacle cells")
    keps_plan = prk.cg_plan(keps_dom.shape, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    keps_numbers, keps_last = drive_scene(
        f"kepsilon_channel_{KEPS_RES}", lambda s: keps_step(s, keps_dom),
        keps0, {"cg_solve": 1})
    del keps0
    keps_numbers["setup_s_with_the_generated_tile"] = keps_setup_s
    keps_numbers["cg_plan"] = dataclasses.asdict(keps_plan)
    keps_numbers["turbulence_particles"] = int(keps_last["tp"].pos.shape[0])
    keps_numbers["k_max"] = float(keps_last["k"].max())
    keps_numbers["eps_min"] = float(keps_last["eps"].min())
    require(keps_numbers["turbulence_particles"] > 5000,
            f"k-epsilon: {keps_numbers['turbulence_particles']} particles")
    require(float(keps_last["vel"][0].abs().max()) > 0.3,
            "k-epsilon: no inflow velocity")
    print(f"k-epsilon channel: {keps_numbers['turbulence_particles']} "
          f"turbulence particles, k max {keps_numbers['k_max']:.4f}, "
          f"{keps_plan.overflow} of {keps_plan.onchip + keps_plan.overflow} "
          f"cells per block off chip; set-up {keps_setup_s:.1f} s (the "
          "generated noise tile)", flush=True)
    e, extra = k2_of_scene("k-epsilon channel", "cg_solve_kepsilon",
                           lambda s: keps_step(s, keps_dom), keps_last,
                           keps_dom)
    k2_err = max(k2_err, e)
    keps_numbers.update(extra)
    fk["cg_solve_kepsilon"]["cells_off_chip_per_block"] = keps_plan.overflow
    del keps_last
    keps_numbers["card_vs_cpu_32x16x16"] = scene_card_vs_cpu(
        "k-epsilon channel 32x16x16", keps_setup, keps_step,
        Domain(size=(32, 16, 16)), ("k", "eps", "tp_pos"),
        solved=("vel", "pressure"), acc=1e-3)

    # 28. the rest of A13: each module on the card at a stated size
    # (timed), and held against the CPU on the same inputs (the card's
    # copied to the CPU): integer and bool outputs exact, floats within
    # ``tol`` x max(1, max|CPU value|): 1e-6 for elementwise and gather
    # work, 1e-5 where index_add_'s order differs, 1e-4 for the outputs of
    # a CG or multigrid solve (the solves' own iteration counts within 2)
    a13 = {}

    def move(x, d_):
        if isinstance(x, torch.Tensor):
            return x.to(d_)
        if isinstance(x, cp.Particles):
            return cp.Particles(pos=x.pos.to(d_), flags=x.flags.to(d_),
                                count=x.count.to(d_))
        if isinstance(x, (tuple, list)):
            return type(x)(move(v, d_) for v in x)
        if isinstance(x, dict):
            return {k: move(v, d_) for k, v in x.items()}
        return x

    def leaves(x, name):
        if isinstance(x, torch.Tensor):
            yield name, x
        elif isinstance(x, cp.Particles):
            for k in ("pos", "flags", "count"):
                yield f"{name}.{k}", getattr(x, k)
        elif isinstance(x, (tuple, list)):
            for i, v in enumerate(x):
                yield from leaves(v, f"{name}[{i}]")
        elif isinstance(x, dict):
            for k, v in x.items():
                yield from leaves(v, f"{name}.{k}")

    def on_card(fn, args):
        """fn(dev, *args) on the card and its milliseconds (host clock,
        synchronized; the caching allocator is warm from the phases
        before)."""
        args_g = move(args, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_g = fn(dev, *args_g)
        torch.cuda.synchronize()
        return out_g, (time.perf_counter() - t0) * 1e3

    def hold(name, fn, args, tol, solves=(), loose=()):
        """``fn(device, *args)`` on the card (timed) and on the CPU.
        ``solves``: leaves that count solver iterations (within 2);
        ``loose``: float leaves out of a CG or multigrid solve (1e-4).
        Returns the card's outputs."""
        out_g, ms = on_card(fn, args)
        out_c = fn("cpu", *move(args, "cpu"))
        worst = 0.0
        for (k, g_), (_, c_) in zip(leaves(out_g, name), leaves(out_c,
                                                                name)):
            g_ = g_.cpu()
            require(g_.shape == c_.shape, f"{k}: shapes {tuple(g_.shape)}"
                    f" and {tuple(c_.shape)}")
            if any(k.endswith(s) for s in solves):
                require(bool((g_ - c_).abs().max() <= 2) if c_.numel()
                        else True, f"{k}: iterations {g_} and {c_}")
            elif not c_.is_floating_point():
                require(torch.equal(g_, c_), f"{k}: card and CPU differ")
            elif c_.numel():
                t_ = 1e-4 if any(k.endswith(s) for s in loose) else tol
                scale = max(1.0, float(c_.abs().max()))
                e_ = float((g_.double() - c_.double()).abs().max()) / scale
                require(e_ <= t_, f"{k}: card vs CPU {e_} > {t_} (x max(1,"
                        f" max|value|) = {scale:.4g})")
                worst = max(worst, e_)
        a13[name] = {"card_ms": ms, "max_err_over_scale": worst,
                     "tol": tol}
        print(f"{name}: card {ms:.2f} ms; card vs CPU {worst:.3g} x "
              f"max(1, max|value|) (tol {tol:g})", flush=True)
        return out_g

    # waves: tests/ref_scenes/test_1030_waveeq.py's loop at WAVES_RES^2
    # (grown from 113x127): 20 explicit steps, then 20 implicit (the
    # (I + sL) CG with its l2 exit, a host read an iteration)
    def waves_run(d_, n_res):
        wdom = Domain(size=(n_res, n_res, 1), dim=2)
        flags = fl.fill_grid(fl.init_domain(wdom, device=d_))
        h = Box(p0=(n_res * 0.3, n_res * 0.3, 0.3),
                p1=(n_res * 0.5, n_res * 0.5, 0.5)).apply_to_grid(
            torch.zeros(wdom.shape, device=d_), 1.0, wdom)
        hprev, vel, its = h.clone(), torch.zeros(wdom.shape, device=d_), []
        mass0 = float(wav.total_sum(h, wdom))
        implicit = False
        for t in range(40):
            mass = float(wav.total_sum(h, wdom))
            if implicit:
                h, hprev, it, _ = wav.cg_solve_wave_eq(flags, h, hprev, 0.9,
                                                       wdom, False, 0.12)
                its.append(it)
            else:
                vel = vel + (0.12 * 0.9) * wav.calc_sec_deriv_2d(h, wdom)
                h = h + 0.9 * vel
                implicit = t >= 20
            h = wav.normalize_sum_to(h, wdom, mass)
        return {"height": h, "vel": vel, "cg_iterations": torch.stack(its),
                "mass": torch.stack([wav.total_sum(h, wdom),
                                     torch.tensor(mass0, device=d_)])}

    w_out = hold(f"waves_{WAVES_RES}", lambda d_: waves_run(d_, WAVES_RES),
                 (), 1e-4, solves=("cg_iterations",))
    a13[f"waves_{WAVES_RES}"]["cg_iterations_per_implicit_step"] = [
        int(i) for i in w_out["cg_iterations"]]
    m_end, m0 = (float(m) for m in w_out["mass"])
    require(bool(torch.isfinite(w_out["height"]).all())
            and abs(m_end - m0) <= 1e-4 * m0,
            f"waves: the mass went from {m0} to {m_end}")

    # wavelet turbulence: scenes/waveletTurbulence.py's up-res pass at
    # res = WLT_RES on the card (2D, the xl grid 2 x (WLT_RES x 1.5
    # WLT_RES)), held against the CPU at res 64, on a seeded low-res
    # state: computeEnergy, computeWaveletCoeffs, interpolateGrid,
    # interpolateMACGrid, three applyNoiseVec3 octaves (then, from the
    # CPU's xl velocity) two order-2 substep advections and the xl
    # densityInflow
    def wlt_doms(res_):
        return (Domain(size=(res_, int(1.5 * res_), 1), dim=2),
                Domain(size=(2 * res_, 2 * int(1.5 * res_), 1), dim=2))

    def wlt_noises(d_, xl_dom, res_):
        out = []
        for ps, sc in ((0.5 * res_, 0.4), (1.0 * res_, 0.4 * 0.6),
                       (2.0 * res_, 0.4 * 0.36)):
            nz = WaveletNoiseField(xl_dom, -1, True, device=d_)
            nz.pos_scale, nz.time_anim = (ps,) * 3, 0.1
            out.append((nz, sc))
        return out

    def wlt_upres(d_, vel):
        res_ = vel.shape[-1]
        lo_dom, xl_dom = wlt_doms(res_)
        lo_flags = fl.set_open_bound(fl.fill_grid(fl.init_domain(
            lo_dom, 0, device=d_)), lo_dom, 0, "Y",
            fl.TypeOutflow | fl.TypeEmpty)
        xl_flags = fl.fill_grid(fl.init_domain(xl_dom, device=d_))
        energy = tur.compute_wavelet_coeffs(
            tur.compute_energy(lo_flags, vel, lo_dom), lo_dom)
        weight = tur.interpolate_grid(xl_dom, energy, lo_dom)
        xl_vel = tur.interpolate_mac_grid(xl_dom, vel, lo_dom)
        for nz, sc in wlt_noises(d_, xl_dom, res_):
            xl_vel = tur.apply_noise_vec3(xl_flags, xl_vel, nz, xl_dom, sc,
                                          weight=weight, time=7.5 * xl_dom.dx)
        return {"energy": energy, "weight": weight, "xl_vel": xl_vel}

    def wlt_advect(d_, xl_vel, dens):
        xl_dom = Domain(size=(dens.shape[-1], dens.shape[-2], 1), dim=2)
        xl_flags = fl.fill_grid(fl.init_domain(xl_dom, device=d_))
        for _ in range(2):
            dens = sladv.advect_real(xl_flags, xl_vel, dens, 1.5, order=2)
        nz = WaveletNoiseField(xl_dom, 265, True, device=d_)
        nz.pos_scale, nz.clamp, nz.clamp_neg, nz.clamp_pos = \
            (20.0,) * 3, True, 0.0, 2.0
        nz.val_scale, nz.val_offset, nz.time_anim = 1.0, 0.075, 0.6
        src = Cylinder(center=(xl_dom.size[0] * 0.3, xl_dom.size[1] * 0.2,
                               0.5), radius=xl_dom.size[0] * 0.081,
                       z=(xl_dom.size[0] * 0.081, 0.0, 0.0))
        return ini.density_inflow(xl_flags, dens, nz, src, xl_dom, 1.0, 0.5,
                                  time=7.5 * xl_dom.dx)

    def wlt_inputs(res_):
        lo_dom, xl_dom = wlt_doms(res_)
        rng = np.random.RandomState(28)
        vel = (rng.standard_normal((3,) + lo_dom.shape) * 0.3).astype(
            np.float32)
        vel[2] = 0.0
        return (torch.from_numpy(vel),
                torch.from_numpy(rng.rand(*xl_dom.shape).astype(np.float32)))

    lo_vel, xl_dens = wlt_inputs(WLT_RES)
    up, up_ms = on_card(wlt_upres, (lo_vel,))
    _, adv_ms = on_card(wlt_advect, (up["xl_vel"], xl_dens))
    require(float((up["xl_vel"] - tur.interpolate_mac_grid(
        wlt_doms(WLT_RES)[1], lo_vel.to(dev), wlt_doms(WLT_RES)[0]))
        .abs().max()) > 1e-4,
        "wavelet turbulence: the noise octaves added nothing")
    del up, lo_vel, xl_dens
    lo_vel, xl_dens = wlt_inputs(64)
    xl_vel = hold("wavelet_upres_64", wlt_upres, (lo_vel,), 1e-6)[
        "xl_vel"].cpu()
    hold("wavelet_xl_advect_64", wlt_advect, (xl_vel, xl_dens), 1e-6)
    a13["wavelet_upres_64"][f"card_ms_at_{WLT_RES}"] = up_ms
    a13["wavelet_xl_advect_64"][f"card_ms_at_{WLT_RES}"] = adv_ms
    print(f"wavelet turbulence at res {WLT_RES}: up-res {up_ms:.1f} ms, "
          f"xl advection and inflow {adv_ms:.1f} ms on the card",
          flush=True)
    del xl_vel, lo_vel, xl_dens

    # guiding: PD_fluid_guiding on scenes/guiding_2d.py's spiral at its
    # GUIDE_RES^2 on the card (strength 1, weights 1 below and 5 above
    # mid-height, blur radius 2, tau 1, sigma 0.99, PcMGStatic), from the
    # buoyancy of its source; one host read a PD iteration besides the
    # nested solves'; held against the CPU at 64^2
    def guide_run(d_, res_):
        gdom = Domain(size=(res_, res_, 1), dim=2)
        flags = fl.fill_grid(fl.init_domain(gdom, 1, device=d_))
        src = Cylinder(center=(res_ * 0.5, res_ * 0.2, 0.5),
                       radius=res_ * 0.14, z=(0.0, res_ * 0.02 * 1.5, 0.0))
        dens = src.apply_to_grid(torch.zeros(gdom.shape, device=d_), 1.0,
                                 gdom)
        vel = ext.add_buoyancy(flags, dens, torch.zeros(
            (3,) + gdom.shape, device=d_), (0.0, 0.25 * 2 * -4e-3, 0.0),
            1.0, gdom)
        vel_t = gd.get_spiral_velocity(gdom, res_ / 128, device=d_)
        w = gd.set_gradient_y_weight(torch.zeros(gdom.shape, device=d_),
                                     gdom, 0, res_ // 2, 1, 1)
        w = gd.set_gradient_y_weight(w, gdom, res_ // 2, res_, 5, 5)
        v, p, it = gd.pd_fluid_guiding(
            vel, vel_t, flags, w, gdom, 2, 1.0, 1.0, 0.99,
            preconditioner=prs.PcMGStatic, zero_pressure_fixing=True)
        return {"vel": v, "pressure": p, "pd_iterations": it}

    g_out, g_ms = on_card(lambda d_: guide_run(d_, GUIDE_RES), ())
    g_it = int(g_out["pd_iterations"])
    require(1 < g_it < 200 and bool(torch.isfinite(g_out["vel"]).all()),
            f"guiding: {g_it} PD iterations")
    print(f"guiding at {GUIDE_RES}^2: {g_ms:.1f} ms on the card, {g_it} PD "
          "iterations", flush=True)
    hold("guiding_64", lambda d_: guide_run(d_, 64), (), 1e-4,
         solves=("pd_iterations",))
    a13["guiding_64"].update({f"card_ms_at_{GUIDE_RES}": g_ms,
                              f"pd_iterations_at_{GUIDE_RES}": g_it})
    del g_out

    # IDP: a Correct19 step (scenes/idp_apic02_3d.py:73-84) on its box at
    # IDP_RES^3 (8 particles a cell, randomness 0.5; the wall SDF as
    # phiObs), stage by stage: mapMassToGrid, the lambda solve (the scene
    # API's PcMIC over cg_loop), computeDeltaX, mapMACToPartPositions;
    # then resampeOverfullCells on the unclamped density
    idom = Domain(size=(IDP_RES,) * 3)
    box_phi = Box(p0=(0.0, 0.0, IDP_RES * 0.25),
                  p1=(IDP_RES * 0.5, IDP_RES * 0.35, IDP_RES * 0.75)
                  ).compute_levelset(idom, "cpu")
    iflags0 = fl.update_from_levelset(fl.init_domain(idom, 1, device="cpu"),
                                      box_phi, 1e10)
    iparts = cp.sample_flags_with_particles(iflags0.numpy(), idom, 2, 0.5,
                                            device="cpu")
    iflags = fl.init_domain(idom, 1, device="cpu")
    iphi = fl._wall_sdf(idom, 1, "xXyYzZ", device="cpu")
    mass_ = 1.0 / 8

    def idp_mass(d_, parts, flags, phi_obs, clamp):
        f2, rho, dx = idp.map_mass_to_grid(parts, flags, phi_obs, idom, 1.0,
                                           mass_, not clamp)
        return {"flags": f2, "rho": rho, "delta": dx}

    m_out = hold(f"idp_map_mass_{IDP_RES}",
                 lambda d_, *a: idp_mass(d_, *a, True),
                 (iparts, iflags, iphi), 1e-5)
    m_cpu = move(m_out, "cpu")

    def idp_solve(d_, rho, flags):
        stencil = prs.make_laplace_stencil(flags, idom)
        lam, it, _ = prs.solve_pressure_system(rho, flags, idom, stencil,
                                               1e-3,
                                               preconditioner=prs.PcMIC)
        return {"lambda": lam, "cg_iterations": it}

    l_out = hold(f"idp_lambda_solve_{IDP_RES}", idp_solve,
                 (m_cpu["rho"], m_cpu["flags"]), 1e-6, solves=(
                     "cg_iterations",), loose=("lambda",))
    lam = l_out["lambda"].cpu()
    dx_out = hold(f"idp_delta_x_{IDP_RES}",
                  lambda d_, lam_, f_: idp.compute_delta_x(lam_, f_, idom),
                  (lam, m_cpu["flags"]), 1e-6)
    hold(f"idp_map_mac_to_positions_{IDP_RES}",
         lambda d_, p_, dx_, f_: idp.map_mac_to_part_positions(
             p_, dx_, f_, idom, 1.0), (iparts, dx_out.cpu(), m_cpu["flags"]),
         1e-6)
    u_out = move(hold(f"idp_map_mass_unclamped_{IDP_RES}",
                      lambda d_, *a: idp_mass(d_, *a, False),
                      (iparts, iflags, iphi), 1e-5), "cpu")
    # the density error scaled so that its most overfull cells fall below
    # -1 (the box's sampling leaves none that full)
    over = u_out["rho"] * (1.5 / max(-float(u_out["rho"].min()), 1e-3))
    require(bool((over < -1.0).any()), "IDP: no overfull cell")
    hold(f"idp_resample_overfull_{IDP_RES}",
         lambda d_, p_, v_, rho_: idp.resample_overfull_cells(
             p_, torch.zeros_like(p_.pos), v_, rho_, idom, 1.0),
         (iparts, torch.zeros((3,) + idom.shape), over), 1e-6)
    a13[f"idp_map_mass_{IDP_RES}"]["particles"] = int(iparts.count)
    del iparts, iflags, iphi, m_out, m_cpu, l_out, lam, dx_out, u_out, over

    # whitewater: potentials (radius 2), 'single' sampling (rates k_ta = k_wc
    # = 5000: the dam's slow flow emits little) into 2^20 slots
    # and the 'linear' update with anti-tunneling on phase 14's developed
    # flat FLIP_RES^3 dam, on the card (timed); held against the CPU on
    # the dam's 48^3 corner stage by stage (each stage from the CPU's
    # outputs, so that the emission counts, integer work, meet equal
    # inputs)
    WW_POT = dict(radius=2, tau_min_ta=0.1, tau_max_ta=5.0, tau_min_wc=0.1,
                  tau_max_wc=5.0, tau_min_ke=0.01, tau_max_ke=5.0,
                  scale_from_manta=1.0)

    def ww_dom(flags):
        return Domain(size=tuple(reversed(flags.shape)))

    def ww_sample(d_, flags, vel, pots, cap):
        parts = cp.Particles(
            pos=torch.zeros((cap, 3), device=d_),
            flags=torch.full((cap,), cp.PDELETE, dtype=torch.int32,
                             device=d_),
            count=torch.tensor(0, dtype=torch.int32, device=d_))
        z3, z1 = torch.zeros((cap, 3), device=d_), torch.zeros(cap,
                                                               device=d_)
        return ww.sample_secondary_particles(
            parts, z3, z1, flags, vel, *pots[:4], ww_dom(flags), 2.0, 5.0,
            0.3, 0.8, 5000.0, 5000.0, 1.0)

    def ww_update(d_, flags, vel, nr, parts, v_sec, l_sec):
        return ww.update_secondary_particles(
            parts, v_sec, l_sec, torch.zeros_like(v_sec), flags, vel, nr,
            ww_dom(flags), (0.0, -0.003, 0.0), 0.5, 0.6, 0.3, 0.8, 1.0,
            antitunneling=2)

    dam = {k: v.to(dev) for k, v in dam_grids.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pots = ww.compute_secondary_particle_potentials(
        dam["flags"], dam["vel"], dam["phi"], ww_dom(dam["flags"]), **WW_POT)
    sampled = ww_sample(dev, dam["flags"], dam["vel"], pots, 1 << 20)
    updated = ww_update(dev, dam["flags"], dam["vel"], pots[3], *sampled)
    torch.cuda.synchronize()
    ww_ms = (time.perf_counter() - t0) * 1e3
    emitted = int((sampled[0].flags & cp.PDELETE == 0).sum())
    require(emitted > 0 and bool(torch.isfinite(updated[0].pos).all())
            and bool(torch.isfinite(updated[1]).all()),
            f"whitewater: {emitted} emitted or not finite")
    print(f"whitewater on the developed {FLIP_RES}^3 dam: {ww_ms:.1f} ms "
          f"(potentials, sampling, update), {emitted} particles emitted",
          flush=True)
    del dam, pots, sampled, updated
    crop = tuple(slice(0, 48) for _ in range(3))
    wf = dam_grids["flags"][crop].contiguous()
    wv = dam_grids["vel"][(slice(None),) + crop].contiguous()
    wp = dam_grids["phi"][crop].contiguous()
    pots = move(hold("whitewater_potentials_48",
                     lambda d_, f_, v_, p_:
                     ww.compute_secondary_particle_potentials(
                         f_, v_, p_, ww_dom(f_), **WW_POT),
                     (wf, wv, wp), 1e-6), "cpu")
    sampled = move(hold("whitewater_sampling_48",
                        lambda d_, f_, v_, p_: ww_sample(d_, f_, v_, p_,
                                                         1 << 16),
                        (wf, wv, pots), 1e-6), "cpu")
    hold("whitewater_update_48", ww_update, (wf, wv, pots[3]) + sampled,
         1e-6)
    a13["whitewater_potentials_48"][f"card_ms_all_stages_at_{FLIP_RES}"] = \
        ww_ms
    a13["whitewater_sampling_48"][f"emitted_at_{FLIP_RES}"] = emitted
    a13["whitewater_sampling_48"]["emitted_at_48"] = int(
        (sampled[0].flags & cp.PDELETE == 0).sum())
    del dam_grids, pots, sampled, wf, wv, wp

    # surface turbulence: scenes/surfaceTurbulence.py's call (its
    # parameters: 6 maintenance iterations, surface density 12, dt 0.005,
    # wave speed 32, damping 0.05, max amplitude 0.5, max frequency 128)
    # on a coarse FLIP liquid at ST_RES^3 (the port's flat dam step, the
    # scene's 0.4 x 0.4 x 1 box), 4 steps on the card (timed); the last
    # call held against the CPU
    sdom_ = Domain(size=(ST_RES,) * 3)
    st_params = dataclasses.replace(flat_params, gravity=(0.0, -0.001, 0.0))
    coarse = flip.make_dam_state(sdom_, st_params, dam_frac=(0.4, 0.4, 1.0),
                                 randomness=0.35, device=dev)
    sp = stb.SurfTurbParams(maintenance_iters=6, surface_density=12,
                            dt=0.005, wave_speed=32.0, wave_damping=0.05,
                            wave_max_amplitude=0.5,
                            wave_max_frequency=128.0)
    cap = 1 << 18
    surf = cp.Particles(pos=torch.zeros((cap, 3), device=dev),
                        flags=torch.full((cap,), cp.PDELETE,
                                         dtype=torch.int32, device=dev),
                        count=torch.tensor(0, dtype=torch.int32, device=dev))
    waves_ = tuple(torch.zeros(cap, device=dev) for _ in range(5))
    st_ms = []
    for frame in range(4):
        prev = coarse.parts.pos
        coarse = flip.flip_step(coarse, sdom_, st_params)
        args_ = (coarse.flags, coarse.parts, prev, surf) + waves_
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = stb.particle_surface_turbulence(
            coarse.flags, coarse.parts, prev, surf, None, *waves_, sdom_,
            sp, frame)
        torch.cuda.synchronize()
        st_ms.append((time.perf_counter() - t0) * 1e3)
        surf = out[0]
        waves_ = (out[3], out[4], out[5], out[6], out[7])
    require(int(surf.active_mask().sum()) > 1000,
            "surface turbulence: the band was not populated")
    hold(f"surface_turbulence_{ST_RES}",
         lambda d_, f_, c_, pv_, s_, *w_: stb.particle_surface_turbulence(
             f_, c_, pv_, s_, None, *w_, sdom_, sp, 4), args_, 1e-5)
    a13[f"surface_turbulence_{ST_RES}"]["card_ms_per_frame"] = st_ms
    a13[f"surface_turbulence_{ST_RES}"]["surface_points"] = int(
        surf.active_mask().sum())
    del coarse, surf, waves_, out, args_

    # VIC: VICintegration (sigma 1.5, scale 0.1) of a sphere's marching-
    # cubes mesh at VIC_RES^3 with seeded per-triangle vorticity: the
    # Peskin splat and the three l2-exit Poisson solves (cg_loop)
    vdom = Domain(size=(VIC_RES,) * 3)
    sph = Sphere(center=(VIC_RES / 2,) * 3, radius=VIC_RES / 4)
    nodes, tris = trimesh.marching_cubes(
        sph.compute_levelset(vdom, "cpu").numpy())
    tri_p = nodes[tris]
    centers = tri_p.mean(axis=1).astype(np.float32)
    areas = (0.5 * np.linalg.norm(np.cross(tri_p[:, 1] - tri_p[:, 0],
                                           tri_p[:, 2] - tri_p[:, 0]),
                                  axis=1)).astype(np.float32)
    tv_ = np.random.RandomState(29).standard_normal(
        (len(tris), 3)).astype(np.float32)

    def vic_run(d_, c_, v_, a_):
        flags = fl.fill_grid(fl.init_domain(vdom, device=d_))
        vel, vort = vx.vic_integration(c_, v_, a_, flags, vdom, 1.5,
                                       scale=0.1)
        return {"vorticity": vort, "vel": vel}

    v_out = hold(f"vic_{VIC_RES}", vic_run,
                 (torch.from_numpy(centers), torch.from_numpy(tv_),
                  torch.from_numpy(areas)), 1e-5, loose=("vel",))
    a13[f"vic_{VIC_RES}"]["triangles"] = len(tris)
    require(float(v_out["vel"].abs().max()) > 1e-6,
            "VIC: the sheet induced no velocity")
    del v_out, nodes, tris, tri_p

    # interpol4d: a region-stamped 4D grid (tests/ref_scenes/
    # test_0042_interpol4d.py) resampled 40^4 -> 80^4 on the card (timed),
    # 20^4 -> 40^4 held against the CPU
    def interp4d(d_, src, n_to):
        st_, sz, sy, sx = (n_to,) * 4
        f = src.shape[-1] / n_to
        a = torch.arange(n_to, dtype=torch.float32, device=d_) * f + f * 0.5
        return g4.interpol4d(src, a.reshape(1, 1, 1, sx),
                             a.reshape(1, 1, sy, 1), a.reshape(1, sz, 1, 1),
                             a.reshape(st_, 1, 1, 1))

    reg = torch.zeros((20,) * 4)
    reg[6:15, 6:15, 6:15, 6:15] = 1.0
    d40 = hold("interpol4d_20_to_40", lambda d_, s_: interp4d(d_, s_, 40),
               (reg,), 1e-6)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d80 = interp4d(dev, d40, 80)
    torch.cuda.synchronize()
    a13["interpol4d_20_to_40"]["card_ms_40_to_80"] = (
        time.perf_counter() - t0) * 1e3
    require(abs(float(d80.sum()) / 16 - float(d40.sum())) < 1e-2 * float(
        d40.sum()), "interpol4d: the 80^4 grid lost mass")
    print(f"interpol4d 40^4 -> 80^4 on the card: "
          f"{a13['interpol4d_20_to_40']['card_ms_40_to_80']:.2f} ms",
          flush=True)
    del d40, d80

    flip_paths = {"flip_128": flip_launches, "flip01_128": a_launches,
                  "obstacle_128": b_launches, "flip_zshard_128": z_launches,
                  "flat_128": flat_launches, "apic_128": apic_launches}
    # the smoke paths: the bench path (phase 2) and phases 17-19's
    smoke_paths = {"smoke_128": launches, **smoke_paths}
    k1_3d_by_path = {k: v["window_advect"] for k, v in smoke_paths.items()
                     if k != plume_path}
    kernels = [
        {"name": "window_advect", "route": "cuda",
         "source": "mantaflow_tpu_torch/csrc/window_advect.cu",
         "replaces": "mantaflow_tpu/ops/advection_pallas.py:284",
         "launches": sum(k1_3d_by_path.values()),
         "launches_by_path": k1_3d_by_path, "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms,
         "bound_ms": max(k1_bound_bytes, k1_bound_ops),
         "bound_by": "bytes" if k1_bound_bytes >= k1_bound_ops
         else "operations", **k1_library, "call_ms": k1_call_ms,
         "timed_by": k1_timed_by},
        # K1's 2D instances (k3d = false), on the 2D plume's passes
        {"name": "window_advect_2d", "route": "cuda",
         "source": "mantaflow_tpu_torch/csrc/window_advect.cu",
         "replaces": "mantaflow_tpu/ops/advection_pallas.py:284",
         "launches": smoke_paths[plume_path]["window_advect"],
         "launches_by_path": {plume_path:
                              smoke_paths[plume_path]["window_advect"]},
         "max_abs_err": k1_2d_err, "ms": k1_2d_ms,
         "plain_ms": k1_2d_plain_ms, "bound_ms": max(k1_2d_bound),
         "bound_by": "bytes" if k1_2d_bound[0] >= k1_2d_bound[1]
         else "operations", **k1_2d_library, "call_ms": k1_2d_call_ms,
         "timed_by": k1_2d_timed_by, "instances": k1_2d_names},
        # K1's z-slab instances (kSlab = true), on the z-sharded smoke's
        # passes: one launch per shard and pass
        {"name": "window_advect_zshard", "route": "cuda",
         "source": "mantaflow_tpu_torch/csrc/window_advect.cu",
         "replaces": "mantaflow_tpu/ops/advection_pallas.py:284",
         "replaces_call": "mantaflow_tpu/ops/advection_pallas.py:530",
         "launches": smoke_paths["smoke_zshard_128"]["window_advect_zshard"],
         "launches_by_path": {k: v["window_advect_zshard"]
                              for k, v in smoke_paths.items()},
         "max_abs_err": k1z_err, "ms": k1z_ms, "plain_ms": k1z_plain_ms,
         "bound_ms": max(k1z_bound),
         "bound_by": "bytes" if k1z_bound[0] >= k1z_bound[1]
         else "operations", **k1z_library, "call_ms": k1z_call_ms,
         "timed_by": k1z_timed_by, "instances": k1z_names},
        {"name": "cg_solve", "route": "cuda",
         "source": "mantaflow_tpu_torch/csrc/cg_solve.cu",
         "replaces": "mantaflow_tpu/ops/pressure_pallas.py:88",
         "launches": sum(v["cg_solve"] for v in smoke_paths.values())
         + sum(v["cg_solve"] for v in flip_paths.values())
         + d2_launches["cg_solve"]
         + sum(v["cg_solve"] for v in scene_paths.values()),
         "max_abs_err": max(k2_err, errs["cg_solve"]),
         "ms": k2_ms, "plain_ms": k2_plain_ms,
         "bound_ms": max(k2_bound_bytes, k2_bound_ops),
         "bound_by": "bytes" if k2_bound_bytes >= k2_bound_ops
         else "operations", "library_ms": None,
         "call_ms": k2_call_ms, "timed_by": k2_timed_by, "iterations": k2_it,
         "launches_by_path": {**{k: v["cg_solve"]
                                 for k, v in smoke_paths.items()},
                              **{k: v["cg_solve"]
                                 for k, v in flip_paths.items()},
                              "flat_2d": d2_launches["cg_solve"],
                              **{k: v["cg_solve"]
                                 for k, v in scene_paths.items()}},
         "ms_per_iteration": k2_ms / max(k2_it, 1),
         "iteration_floor": k2_iter_floor,
         "bench_dam_solve": fk["cg_solve_bench"],
         "flat_dam_solve": fk["cg_solve_flat"],
         "plume_2d_solve": fk["cg_solve_plume"],
         "surface_tension_solve": fk["cg_solve_surface"],
         "karman_3d_solve": fk["cg_solve_karman"],
         "fire_3d_solve": fk["cg_solve_fire"],
         "kepsilon_channel_solve": fk["cg_solve_kepsilon"]},
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
        if kind == "extrap_layer":
            by_path.update({k: v[kind] for k, v in scene_paths.items()})
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
            entry["karman_3d_path"] = fk["extrap_layer_karman"]
        kernels.append(entry)
    # the layer kernel's 2D instance, on the 2D flat dam's layers
    kernels.append({
        "name": "extrap_layer_2d", "route": "cuda",
        "source": "mantaflow_tpu_torch/csrc/extrap_layer.cu",
        "replaces": "mantaflow_tpu/ops/extrapolation_pallas.py:45",
        "launches": d2_launches["extrap_layer"],
        "launches_by_path": {"flat_2d": d2_launches["extrap_layer"]},
        "max_abs_err": errs["extrap_layer_2d"], "library_ms": None,
        **fk["extrap_layer_2d"]})
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
        **new_numbers, "flat_2d": d2_numbers,
        "scene_functions": scene_fn_numbers, **scene_numbers,
        "breadth_ops": a13,
        "build_s": build_s,
        "total_s": time.perf_counter() - t_start}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
