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
   through on every slot, the form without the blend and the forms that
   do not stop in obstacles, each of those two also timed on the
   developed step's inputs; the step's rebin bitwise the same with the
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
   PcMIC solve, updateFlame, the scene's adaptive dt through the scene
   API's Solver), driven and traced as
   phase 24, 1 K2 a step and no other kernel; K2 of a developed step
   against its plain version by its residual and timed; 3 steps at 24^3 on
   the card against the CPU;
27. scenes/turbulence.py at 256x128x128 (16 sphere obstacles, the
   generated noise tile, 500 turbulence particles seeded a step by the
   scene API's TurbulenceParticleSystem (its persistent stream, RK4
   advection, synthesis and deletion in obstacles); the k-epsilon chain with diffusion, inflow BCs, PcMIC with
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
   held 20^4 -> 40^4);
29. scenes/flip06_obstacle.py 20 128, unedited, through the scene runner
   (``mantaflow_tpu_torch.scene.run``) on the card: narrow-band FLIP with
   a sphere obstacle, fractions, adaptive dt and a mesh every step; the
   scene step's CUDA-event span (median of the last 10), createMesh's
   host seconds, 1 K2 and 16 K14 a step, the last two frames traced; the
   scene's last line, finite fields, the particles' depth in the obstacle
   after each pushOutofObs and the mesh's manifold checked; K2 (by its
   residual) and K14 of the last step against their plain versions and
   timed; the same scene at 2 frames on 24^3 on the card against the CPU;
30. the reference-binary goldens on the card: every
   tests/ref_scenes/test_*.py the port passes there (refgolden.LEFT_OUT
   and LEFT_OUT_ON_CARD name the four it does not, and why) through the
   runner's alias, each within its own thresholds, timed; the sloshing
   liquid test_1090_waveBench run twice, its grids equal bit for bit;
31. the ML toolbox (``mantaflow_tpu_torch/ml``): scenes/mlflip.py's three
   stages at the scene's own settings through the API (gen-data 25 frames
   at 32^3 with drop_speed 4, 120 training steps at batch 128, 10 steps
   with the net; the scene file itself runs in phase 32); ML-FLIP at
   128^3 (the basin and drop, ~2.4M particles) with that net in the
   loop: 1 warm step, 20 with
   CUDA events, every kernel's launches counted (1 K2 and 6 K14 a step,
   nothing else), the ML block's ms, 5 steps traced (device busy, idle),
   no particle lost, finite fields, ptype in {0, fluid, empty}, K2 (by
   its residual) and K14 of a developed step against their plain
   versions and timed; the other pipelines timed (create_dataset smoke
   and flip at 64, 2 sims x 3 frames; the SR pairs at 64, 50 training
   steps and apply_sr on a frame; the pressure resnet trained at 24^3 and
   its NN-projected loop at 128^3, the NN projection's ms beside the K2
   solve's on the same step; the 2D autoencoder at 64^2; 20 GAN step
   pairs); the card against the CPU: 3 ML-FLIP steps at 20^3 with the
   net, the ML block on equal inputs (decisions equal wherever the
   detector's probability is more than 1e-5 from the threshold), 5 Adam
   steps of each network from equal weights, one dataset frame of each
   generator at 16^3;
32. the multi-device module (``parallel/``): the bench smoke and the flat
   FLIP dam at 128^3 (3,830,400 particles) over 4 shards on one card
   (``make_mesh``, ``shard_smoke_state`` / ``shard_flip_state``: grids as
   z-slabs, particles in chunks), each 3 steps against the one-device run
   from the same start (the smoke within 1e-5 with CG iterations within
   2; the flat dam, whose ghost-fluid solves exit at another iterate under
   any other order of sums, with equal flags, systems equal to 2e-5,
   10 iterations of the slab CG against K2 to rel 1e-5 and every solve
   below its accuracy by its true residual), then 1 warm step and 10
   timed (CUDA events), the launches counted (the smoke: 8 slab launches of the window kernel per shard a step, no
   one-domain window launch and no CG kernel: the slab CG; the flat dam:
   10 layers of the layer kernel per shard a step), the smoke held by its
   residual after 11 steps, 3 steps traced, the halo copies' ms and the
   slab CG's us an iteration; the dry run (``parallel/dryrun.py``) at 4
   shards; the APIC dam at 128^3, an IDP step and a VIC integration run 5
   times each, 1 distinct result each (``tools/scatter_order.py
   --witness``); scenes/smoke_fused_128.py (its 128^3, 10 frames of 10
   steps), bit for bit ``smoke_run`` through the API from the same start,
   and scenes/mlflip.py 1, both unedited through the scene runner; then
   what a sharded state once could not run, each held against one device
   from the same start: the bench smoke at 128^3 with PcMGStatic over 4
   slabs (the V-cycles' finest four levels on the slabs), in its closed
   box with zero-pressure fixing over 4, and over 3 shards (43, 43, 42
   planes), each to 1e-5; the 2D plume at 512^2 over 4 (one plane, on
   shard 0) and the flat dam at 128^3 over 3 shards by each solve's true
   residual, flags equal (the plume's systems equal on the first step,
   its fields within the accuracy of their scale); each timed, its
   launches counted.

33. every scene of scenes/ the port runs (SCENE_GROUPS: 31 files, the two
   chains flip02_surface.py -> flip03_gen.py and guiding_3d01_low.py ->
   guiding_3d02_high.py each in one MANTA_OUT), unedited, through the
   scene runner on the card at the files' own grid sizes, frame counts
   cut: every Solver.step timed by CUDA events, K2 and K14 launches and
   K2 iterations counted, every float field finite, the last line's
   counts against the state; each held against a CPU twin of the same
   file and argv (worker processes of this script,
   ``--scene-twin``, run alongside) by ``scene/snapshot.py``'s rules
   (flags and counts exact, a levelset within 2e-4 of its scale, the
   rest within 1e-2 of max(1, scale), each device's last solve under its
   accuracy by its true residual; SCENE_KNOWN's fields, ROADMAP C, by that
   residual alone), flip03_levelset.py over its first 6 steps of 120;
   the last K2 solve of fire.py, flip05_nbflip.py and plume_2d.py and the
   last step's K14 layers of flip05_nbflip.py and freesurface.py against
   their plain versions, timed; then idp_apic02_3d.py (IDP
   volume-preserving APIC) at 128^3, 150 steps, the median of the last
   10, 3 steps traced (device busy, launches, idle).
34. the fork's own experiment, unedited through the scene runner:
   scenes/run.py at its defaults (20 frames at 32^3, the moving obstacle,
   a 64^3 mesh every frame; each of FLIP, FIXED_VOL and CORRECT19 a child
   process on the card, run as the runner's launcher runs it, through
   ``--zflip-child``), then scenes/zflip.py with the static obstacle for
   each method in this process, each held against a CPU twin of the same
   argv (``--zflip-twin``) on ``run_zflip``'s locals and meshes, with the
   fields that part through the CG's exit iterate bounded per
   configuration by the sensitivity tool's numbers (ZFLIP_KNOWN); FLIP and
   CORRECT19 at 128^3 (~4.0 M particles): the scene step, K2 and K14 a
   step, the scene's host reads, 3 steps traced, no particle lost;
   FIXED_VOL's host redistribution at 64^3, timed.
35. the exact-gather advection's passes (``csrc/advect_exact.cu``) on the
   benchmark's plume at 112x168x112 (walls, the cylinder source, MacCormack
   at CFL 3): 1 warm step and 40 timed, 5 launches a step and every driver
   call on the kernels; one developed step's advect_real and advect_mac
   against their plain versions bit for bit, with the walls and with open
   "yY" bounds; each kernel's us a launch against its own least bytes
   (EXACT_BYTES_PER_CELL), the step's against the advection's (36 bytes a
   cell), the plain versions' ms; the exact smoke at 32^3 over 4 z-slabs
   against one device, every shard's calls on the kernels.

``python3 chip_smoke.py --only-multi`` builds the kernels and runs phase 32
alone, ``--only-scenes`` phase 33 alone, ``--only-zflip`` phase 34 alone,
``--only-exact`` phase 35 alone (no kernels line, no ok line).

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
import hashlib
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
FLIP06_RES = 128  # scenes/flip06_obstacle.py's res argument (its 48)
FLIP06_FRAMES = 20
ML_RES = 128        # ML-FLIP with the net in the loop (the scene's 32)
ML_SCENE_RES = 32   # scenes/mlflip.py's own stages: res, gen-data frames
ML_GEN_FRAMES = 25  # and training steps
ML_TRAIN_STEPS = 120
ML_DATASET_RES = 64  # create_dataset smoke (64x96x64) and flip
ML_SR_RES = 64      # the SR example's high-res plume
ML_DEMO_RES = 128   # the resnet's NN-projected loop
ML_AE_RES = 64      # the 2D autoencoder's frames
ML_CMP_RES = 20     # ML-FLIP card vs CPU
ML_PER_STEP = {"cg_solve": 1, "extrap_layer": 6}  # an ML-FLIP step's kernels


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


def moved(obj, device):
    """A copy of a state dataclass (nested dataclasses of tensors) on
    ``device``."""
    import torch
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: moved(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj)
            if getattr(obj, f.name) is not None})
    return obj


def ml_toolbox_phase(torch, dev, h):
    """Phase 31: the ML toolbox on the card. ``h`` carries main()'s
    helpers and records (check_call, cg_check_by_residual,
    tracked_iterations, time_kernel, errs, fk, scene_kernels, scene_paths,
    smoke_paths) and the card's nvidia-smi line (card). Returns (numbers,
    K2's max abs error)."""
    import io
    import os
    import shutil
    import tempfile
    from statistics import median

    from torch.profiler import ProfilerActivity, profile

    from mantaflow_tpu_torch.core import flags as fl
    from mantaflow_tpu_torch.core.domain import Domain
    from mantaflow_tpu_torch.ml import create_dataset as mlcli
    from mantaflow_tpu_torch.ml import datagen as mldg
    from mantaflow_tpu_torch.ml import gan as mlgan
    from mantaflow_tpu_torch.ml import mlflip as mlf
    from mantaflow_tpu_torch.ml import models as mlm
    from mantaflow_tpu_torch.ml import resnet_example as mlres
    from mantaflow_tpu_torch.ml import simple_example as mlse
    from mantaflow_tpu_torch.ml import sr_example as mlsr
    from mantaflow_tpu_torch.models import flip
    from mantaflow_tpu_torch.ops import extrapolation_kernels as xk
    from mantaflow_tpu_torch.ops import pressure as prs
    from mantaflow_tpu_torch.ops import pressure_kernels as prk

    numbers = {}
    k2_err = 0.0

    def sync_s(t0):
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def counted(fn):
        """fn() with every kernel's count set to 0 just before and read
        just after: (fn's result, the launches)."""
        torch.cuda.synchronize()
        for k_ in h.scene_kernels.values():
            k_.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {k_: getattr(f_, "launches", 0)
                     for k_, f_ in h.scene_kernels.items()}

    # scenes/mlflip.py's settings
    params = flip.FlipParams(gravity=(0.0, -0.03, 0.0), cg_accuracy=1e-3,
                             flip_ratio=0.97)

    # 1. the scene's three stages at its own settings, through the API
    sdom = Domain(size=(ML_SCENE_RES,) * 3)
    t0 = time.perf_counter()
    feats, labels, modvels, _ = mlf.generate_training_data(
        sdom, params, n_frames=ML_GEN_FRAMES, window=1, drop_speed=4.0,
        device=dev)
    gen_s = sync_s(t0)
    n_splash = int((labels > 0.5).sum())
    require(feats.shape[1] == 108 and feats.shape[0] == len(labels)
            and bool(np.isfinite(feats).all())
            and bool(np.isfinite(modvels).all()),
            f"mlflip gen-data: features {feats.shape}")
    require(n_splash > 0, "mlflip gen-data: no splash label")
    t0 = time.perf_counter()
    net, net_params, scale, losses = mlf.train(
        feats, labels, modvels, hidden=32, n_steps=ML_TRAIN_STEPS,
        batch=128, device=dev)
    train_s = sync_s(t0)
    loss_first, loss_last = (float(np.mean(losses[:10])),
                             float(np.mean(losses[-10:])))
    require(bool(np.isfinite(losses).all()) and loss_last < loss_first,
            f"mlflip train: loss {loss_first} -> {loss_last}")
    st = mlf.make_mlflip_state(sdom, params, drop_speed=4.0, device=dev)
    t0 = time.perf_counter()
    st = mlf.run_with_net(st, sdom, params, net, net_params, scale,
                          n_steps=10)
    run_s = sync_s(t0)
    n_ball = int(((st.ptype == fl.TypeEmpty) & st.parts.active_mask()).sum())
    require(bool(torch.isfinite(st.vel).all()) and int(st.ts.count) == 10,
            "mlflip 32^3 with the net: state")
    numbers["scene_stages_32"] = {
        "gen_frames": ML_GEN_FRAMES, "gen_s": gen_s,
        "candidates": int(feats.shape[0]), "splash_labels": n_splash,
        "train_steps": ML_TRAIN_STEPS, "train_s": train_s,
        "loss_first10": loss_first, "loss_last10": loss_last,
        "net_steps": 10, "net_steps_s": run_s, "ballistic": n_ball,
        "particles": int(st.parts.count)}
    print(f"mlflip scene stages at {ML_SCENE_RES}^3 on the card: gen-data "
          f"{ML_GEN_FRAMES} frames {gen_s:.2f} s, {feats.shape[0]} "
          f"candidates, {n_splash} splash labels; train {ML_TRAIN_STEPS} "
          f"steps {train_s:.2f} s, loss {loss_first:.4f} -> "
          f"{loss_last:.4f}; 10 steps with the net {run_s:.2f} s, "
          f"{n_ball} ballistic of {int(st.parts.count)} particles",
          flush=True)

    # 2. ML-FLIP at ML_RES^3 with the trained net in the loop
    mdom = Domain(size=(ML_RES,) * 3)
    T = mdom.num_cells
    st = mlf.make_mlflip_state(mdom, params, drop_speed=4.0, device=dev)
    n_parts = int(st.parts.count)
    n_act = int(st.parts.active_mask().sum())
    scaled = mlf.ScaledNet(net, torch.as_tensor(scale, device=dev))

    def step(s):
        return mlf.mlflip_step(s, mdom, params, net=scaled,
                               net_params=net_params)

    block_ev = []
    orig_block = mlf.ml_block

    def timed_block(*a, **kw):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = orig_block(*a, **kw)
        e1.record()
        block_ev.append((e0, e1))
        return out

    def drive(s):
        s = step(s)  # warm
        evs, its = [], []
        for _ in range(20):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            s = step(s)
            e1.record()
            evs.append((e0, e1))
            its.append(s.cg_iters)
        return s, evs, its

    mlf.ml_block = timed_block
    try:
        (st, evs, its), got = counted(lambda: drive(st))
    finally:
        mlf.ml_block = orig_block
    n_steps = 21
    for k_, n_ in got.items():
        want = ML_PER_STEP.get(k_, 0) * n_steps
        require(n_ == want, f"mlflip {ML_RES}^3: {k_} launched {n_} times "
                f"in {n_steps} steps (expected {want})")
    step_ms = [a.elapsed_time(b) for a, b in evs]
    block_ms = [a.elapsed_time(b) for a, b in block_ev[1:]]
    its = [int(i) for i in its]
    act = st.parts.active_mask()
    require(int(st.parts.count) == n_parts and int(act.sum()) == n_act,
            f"mlflip {ML_RES}^3: particles {int(act.sum())} of {n_act}")
    for k_ in ("vel", "vel_old", "pressure", "phi"):
        require(bool(torch.isfinite(getattr(st, k_)).all()),
                f"mlflip {ML_RES}^3: {k_} not finite")
    require(bool(torch.isfinite(st.parts.pos[act]).all())
            and bool(torch.isfinite(st.pvel[act]).all()),
            f"mlflip {ML_RES}^3: particles not finite")
    require(bool(torch.isin(st.ptype[act], torch.tensor(
        [fl.TypeFluid, fl.TypeEmpty], device=dev)).all())
        and not bool(st.ptype[~act].any()),
        f"mlflip {ML_RES}^3: ptype outside {{0, fluid, empty}}")
    n_ball = int(((st.ptype == fl.TypeEmpty) & act).sum())
    # a profiler window of 5 developed steps: device busy and idle
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(5):
            st = step(st)
        t1.record()
        torch.cuda.synchronize()
    traced_ms = t0.elapsed_time(t1) / 5
    busy_us, dev_count = 0.0, 0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us > 0:
            busy_us += us
            dev_count += e.count
    busy_ms = busy_us / 1e3 / 5
    require(busy_ms > 0, f"mlflip {ML_RES}^3: the trace holds no device time")
    h.scene_paths[f"mlflip_{ML_RES}"] = got
    mnum = {
        "particles": n_parts, "steps_run": n_steps + 5,
        "ms_per_step_cold_median": median(step_ms[:10]),
        "ms_per_step_developed_median": median(step_ms[10:]),
        "ms_per_step": step_ms, "cg_iters_per_step": its,
        "ml_block_ms_median": median(block_ms[-10:]),
        "ml_block_ms": block_ms,
        "kernel_launches_per_step": {k_: v / n_steps for k_, v in got.items()
                                     if v},
        "traced_wall_ms_per_step": traced_ms,
        "device_busy_ms_per_step": busy_ms,
        "device_launches_per_step": dev_count / 5,
        "idle_share_traced": 1.0 - busy_ms / traced_ms,
        "ballistic_after_21": n_ball}
    print(f"mlflip {ML_RES}^3 with the net ({n_parts} particles; "
          f"{h.card}): "
          f"{mnum['ms_per_step_cold_median']:.1f} ms/step cold, "
          f"{mnum['ms_per_step_developed_median']:.1f} developed (medians "
          f"of 10, CUDA events), CG it/step {its}, ML block "
          f"{mnum['ml_block_ms_median']:.1f} ms; traced {traced_ms:.1f} "
          f"ms/step, device busy {busy_ms:.1f} ms, {dev_count / 5:.0f} "
          f"device launches a step, idle "
          f"{100 * mnum['idle_share_traced']:.1f} %; kernel launches a "
          f"step {mnum['kernel_launches_per_step']}; {n_ball} ballistic",
          flush=True)
    # K2 (by its residual) and K14 of a developed step against their plain
    # versions, and timed on its inputs
    calls = {"cg_solve": [], "extrap_layer": []}
    with recording(prk, "cg_solve", calls["cg_solve"]), \
            recording(xk, "extrap_layer", calls["extrap_layer"]):
        st = step(st)
    torch.cuda.synchronize()
    require(len(calls["cg_solve"]) == 1 and len(calls["extrap_layer"])
            == ML_PER_STEP["extrap_layer"], "mlflip: kernel calls in a step")
    for args, kwargs in calls["extrap_layer"]:
        h.errs["extrap_layer"] = max(h.errs["extrap_layer"], h.check_call(
            "extrap_layer", args, kwargs))
    (cg_args, cg_kw), = calls["cg_solve"]
    tracked, drift = h.tracked_iterations(cg_args[0], cg_args[1],
                                          cg_kw["fluid"], mdom)
    k2_err = max(k2_err, h.cg_check_by_residual(
        cg_args[0], cg_args[1], cg_kw["fluid"], cg_args[3], cg_args[4],
        mdom, early=tracked))
    m_it = int(prk.cg_solve(*cg_args, **cg_kw)[1])
    h.time_kernel("cg_solve_mlflip", "cg_kernel<false>", calls["cg_solve"],
                  prk.cg_solve, prs.cg_plain, 6 * 4 * T, m_it * 24 * T,
                  f"mlflip {ML_RES}^3 developed solve, {m_it} it")
    h.fk["cg_solve_mlflip"].update(
        iterations=m_it, us_per_iteration=h.fk["cg_solve_mlflip"]["ms"]
        * 1e3 / max(m_it, 1), launches_per_step=1,
        cg_float32_tracks_float64_iterations=[tracked, drift])
    layers = calls["extrap_layer"]
    pairs = sum(len(a[0]) for a, _ in layers) / len(layers)
    h.time_kernel("extrap_layer_mlflip", "extrap_layer_kernel<true>", layers,
                  xk.extrap_layer, xk.extrap_layer_plain, pairs * 16 * T,
                  pairs * 20 * T, f"mlflip {ML_RES}^3 developed step's layers")
    h.fk["extrap_layer_mlflip"]["launches_per_step"] = len(layers)
    numbers[f"mlflip_{ML_RES}"] = mnum
    print(f"mlflip {ML_RES}^3 developed step, kernels vs plain: extrap_layer "
          f"{h.errs['extrap_layer']:.3g}; cg_solve {m_it} it at "
          f"{h.fk['cg_solve_mlflip']['us_per_iteration']:.1f} us/it",
          flush=True)
    del st, calls, layers, cg_args, cg_kw, evs, block_ev
    torch.cuda.empty_cache()

    # 3. the other pipelines at stated sizes, timed
    tmp = tempfile.mkdtemp()
    try:
        pipes = {}

        pipe_launches = dict.fromkeys(h.scene_kernels, 0)

        def timed(name, fn):
            t0_ = time.perf_counter()
            out_, got_ = counted(fn)
            pipes[name] = {"s": time.perf_counter() - t0_,
                           "kernel_launches": {k_: v for k_, v in
                                               got_.items() if v}}
            for k_, v in got_.items():
                pipe_launches[k_] += v
            return out_, got_

        ds_args = ["-n", "2", "-s", "3", "--resolution", str(ML_DATASET_RES),
                   "--datasets_path", tmp, "--device", str(dev)]
        with contextlib.redirect_stdout(io.StringIO()):
            _, got = timed("create_dataset_smoke", lambda: mlcli.main(
                ["--name", "smoke", "-t", "smoke"] + ds_args))
        require(got["window_advect"] == 8 * 6 and got["cg_solve"] == 6,
                f"create_dataset smoke: launches {got}")
        # K1's launches by path (its K2 launches are in the pipelines')
        h.smoke_paths[f"ml_smoke_dataset_{ML_DATASET_RES}"] = {
            "window_advect": got["window_advect"], "window_advect_zshard": 0,
            "cg_solve": 0}
        with contextlib.redirect_stdout(io.StringIO()):
            _, got = timed("create_dataset_flip", lambda: mlcli.main(
                ["--name", "flip", "-t", "flip"] + ds_args))
        require(got["cg_solve"] == 6 and got["extrap_layer"] == 60,
                f"create_dataset flip: launches {got}")
        for name in ("smoke", "flip"):
            path = os.path.join(tmp, name)
            n_files = sum(len(fs) for _, _, fs in os.walk(path))
            desc = json.load(open(os.path.join(path, "description.json")))
            require(n_files == 2 * 3 * len(desc["fields"]) + 1,
                    f"create_dataset {name}: {n_files} files")
            for f_ in desc["fields"]:
                a_ = mldg.load_dataset(path, f_)
                require(len(a_) == 2 and all(np.isfinite(x).all()
                                             for x in a_[0] + a_[1]),
                        f"create_dataset {name}: {f_}")
        (xs, ys), _ = timed("sr_generate_pairs", lambda: mlsr.generate_pairs(
            res=ML_SR_RES, device=dev))
        (sr_net, sr_params, sr_losses), _ = timed(
            "sr_train_50", lambda: mlsr.train_sr(xs, ys, n_steps=50,
                                                 device=dev))
        c_ = ML_SR_RES // 2
        nt_ = c_ // 8
        coarse = xs[:nt_ ** 3, ..., 0].reshape(nt_, nt_, nt_, 8, 8, 8) \
            .transpose(0, 3, 1, 4, 2, 5).reshape(c_, c_, c_)
        fine, _ = timed("sr_apply_frame", lambda: mlsr.apply_sr(
            sr_net, sr_params, coarse))
        require(fine.shape == (ML_SR_RES,) * 3 and np.isfinite(fine).all()
                and np.isfinite(sr_losses).all(), "sr: output")

        (pxs, pys), got = timed("resnet_pairs_24",
                                lambda: mlres.generate_pressure_pairs(
                                    res=24, device=dev))
        require(got["cg_solve"] == 24, f"resnet pairs: launches {got}")
        (r_net, r_params, r_losses, r_sc), _ = timed(
            "resnet_train_300", lambda: mlres.train_pressure_net(
                pxs, pys, device=dev))
        quality = mlres.evaluate_projection(r_net, r_params, r_sc,
                                            pxs[-4:], pys[-4:])
        ddom, dparams, dst = mlres.demo_state(ML_DEMO_RES, 3, dev)
        pairs_ = []

        def demo():
            s_ = dst
            for _ in range(5):
                s_, b_, a_ = mlres.nn_projection_step(
                    s_, ddom, dparams, r_net, r_params, r_sc)
                pairs_.append((float(b_), float(a_)))
            return s_
        dst, got = timed(f"resnet_demo_{ML_DEMO_RES}_5_steps", demo)
        require(got["cg_solve"] == 0 and all(np.isfinite(pairs_).ravel()),
                f"resnet demo: {got}, {pairs_}")
        # the projection alone on the same step: the net's inference and
        # the CG solve (K2) of the same system
        rhs = prs.make_rhs(dst.flags, dst.vel, ddom)
        inp = torch.stack([rhs / r_sc[0], fl.is_fluid(dst.flags).to(
            torch.float32)], dim=-1)[None]

        def nn_proj():
            with torch.inference_mode():
                return r_net.apply(r_params, inp)
        nn_ms = cuda_ms(torch, nn_proj, 5)
        cg_ms = cuda_ms(torch, lambda: prs.solve_pressure(
            dst.vel, dst.flags, ddom, cg_accuracy=dparams.cg_accuracy), 3)
        cg_it = int(prs.solve_pressure(dst.vel, dst.flags, ddom,
                                       cg_accuracy=dparams.cg_accuracy)[3])
        numbers["resnet_demo"] = {
            "res": ML_DEMO_RES, "div_before_after": pairs_,
            "heldout_quality": quality, "nn_projection_ms": nn_ms,
            "cg_solve_ms": cg_ms, "cg_iterations": cg_it,
            "train_loss_first10": float(np.mean(r_losses[:10])),
            "train_loss_last10": float(np.mean(r_losses[-10:]))}

        (frames), got = timed("ae_frames_64_2d",
                              lambda: mlse.generate_densities(
                                  res=ML_AE_RES, device=dev))
        require(got["cg_solve"] == 80, f"ae frames: launches {got}")
        (_, _, ae_losses, ae_cost), _ = timed(
            "ae_train_200", lambda: mlse.train_autoencoder(frames,
                                                           device=dev))
        require(np.isfinite(ae_losses).all() and np.isfinite(ae_cost),
                "ae: losses")

        def gan_pairs():
            g_ = mlgan.make_gan_states(
                torch.from_numpy(xs[:8]).to(dev),
                torch.from_numpy(ys[:8]).to(dev))
            out_ = []
            for i in range(20):
                sl = slice(8 * i % (len(xs) - 8), 8 * i % (len(xs) - 8) + 8)
                c_t = torch.from_numpy(xs[sl]).to(dev)
                f_t = torch.from_numpy(ys[sl]).to(dev)
                _, _, dl = g_["disc_step"](g_["gen_params"],
                                           g_["disc_params"], None, c_t, f_t)
                _, _, gl = g_["gen_step"](g_["gen_params"],
                                          g_["disc_params"], None, c_t, f_t)
                out_.append((float(dl), float(gl)))
            return out_
        gan_l, _ = timed("gan_20_step_pairs", gan_pairs)
        require(np.isfinite(gan_l).all(), "gan: losses")
        # K2's and K14's launches by path (K1's: the smoke dataset's above)
        h.scene_paths["ml_pipelines"] = pipe_launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    numbers["pipelines"] = pipes
    print("ML pipelines on the card (s): " + ", ".join(
        f"{k_} {v['s']:.2f}" for k_, v in pipes.items())
        + f"; resnet demo {ML_DEMO_RES}^3: NN projection {nn_ms:.2f} ms vs "
        f"the K2 solve {cg_ms:.2f} ms ({cg_it} it) on the same step, "
        f"divergence before/after {pairs_[-1]}", flush=True)

    # 4. card against CPU on the same carried weights and batches
    cmp = {}
    cdom = Domain(size=(ML_CMP_RES,) * 3)
    cpu_params = {k_: v.cpu() for k_, v in net_params.items()}
    cpu_net = mlm.load_params(mlm.MLFlipNet(hidden=32), cpu_params)
    nets = {str(dev): mlf.ScaledNet(net, torch.as_tensor(scale, device=dev)),
            "cpu": mlf.ScaledNet(cpu_net, torch.as_tensor(scale))}
    nparams = {str(dev): net_params, "cpu": cpu_params}
    seen = []

    def capture(*a, **kw):
        seen.append(a[0])
        return orig_block(*a, **kw)
    runs = {}
    for d_ in (dev, "cpu"):
        s_ = mlf.make_mlflip_state(cdom, params, drop_speed=4.0, device=d_)
        if d_ == dev:
            mlf.ml_block = capture
        try:
            for _ in range(3):
                s_ = mlf.mlflip_step(s_, cdom, params, net=nets[str(d_)],
                                     net_params=nparams[str(d_)])
        finally:
            mlf.ml_block = orig_block
        runs[str(d_)] = s_
    g_, c_ = runs[str(dev)], runs["cpu"]
    for what, a_, b_ in (("flags", g_.flags, c_.flags),
                         ("ptype", g_.ptype, c_.ptype),
                         ("particle flags", g_.parts.flags, c_.parts.flags),
                         ("count", g_.parts.count, c_.parts.count)):
        require(torch.equal(a_.cpu(), b_),
                f"mlflip {ML_CMP_RES}^3 card vs CPU: {what} differ")
    gerr = max(float((getattr(g_, k_).cpu() - getattr(c_, k_)).abs().max())
               for k_ in ("vel", "phi"))
    perr = max(float((a_.cpu() - b_).abs().max()) for a_, b_ in (
        (g_.parts.pos, c_.parts.pos), (g_.pvel, c_.pvel)))
    require(gerr < 2e-4 and perr < 1e-4,
            f"mlflip {ML_CMP_RES}^3 card vs CPU: grids {gerr}, particles "
            f"{perr}")
    # the ML block on equal inputs (each card step's post-projection state
    # and its copy on the CPU): the splash decisions equal wherever the
    # detector's probability is more than 1e-5 from the threshold, the
    # velocity modifications to 1e-5 of their scale
    undecided, dv_err, splashers = 0, 0.0, 0
    for s_g in seen:
        s_c = moved(s_g, "cpu")
        pt_g, dv_g = orig_block(s_g, cdom, params, nets[str(dev)], net_params)
        pt_c, dv_c = orig_block(s_c, cdom, params, nets["cpu"], cpu_params)
        cand, ptmp = mlf.surface_candidates(s_c, cdom)
        with torch.inference_mode():
            logit = nets["cpu"].apply(cpu_params, mlf.extract_features(
                s_c, ptmp, cdom))[0]
        close = cand & ((torch.sigmoid(logit) - 0.5).abs() <= 1e-5)
        diff = pt_g.cpu() != pt_c
        require(not bool((diff & ~close).any()),
                "mlflip card vs CPU: a splash decision differs")
        undecided += int(close.sum())
        both = ~diff
        dv_err = max(dv_err, float((dv_g.cpu() - dv_c)[both].abs().max())
                     / max(float(dv_c.abs().max()), 1.0))
        splashers += int((pt_c == fl.TypeEmpty).sum())
    require(dv_err < 1e-5, f"mlflip card vs CPU: velocity modification "
            f"{dv_err}")
    cmp[f"mlflip_{ML_CMP_RES}_3_steps"] = {
        "grids": gerr, "particles": perr, "ml_blocks": len(seen),
        "splashers": splashers, "undecided_within_1e-5": undecided,
        "dv_rel_err": dv_err}

    # 5 Adam steps of each model from the same initial weights, on the same
    # batches: the losses to 1e-5 relative, the parameters to 1e-5 relative
    # plus a tenth of the learning rate. Adam's first steps move an entry
    # by about lr whatever its gradient's size, so an entry whose gradient
    # is near zero moves by a share of lr that the gradient's rounding
    # decides: cuBLAS sums the autoencoder's 4096-wide layers in another
    # order than the CPU, and such entries part by up to 5.1e-5 at lr 1e-3
    # (NVIDIA H100 80GB HBM3, 700 W)
    rs = np.random.RandomState(31)

    def params_err(sg, sc, lr):
        """How far the card's parameters lie beyond 1e-5 of the CPU's
        plus lr / 10 (negative: inside)."""
        return max(float(((sg[k_].cpu() - sc[k_]).abs()
                          - 1e-5 * sc[k_].abs()).max()) for k_ in sc) \
            - 0.1 * lr

    def adam_pair(name, make, sample, batches, loss):
        nc = make()
        mlm.init_params(nc, 0, *[torch.from_numpy(x) for x in sample])
        ng = mlm.load_params(make(), nc.state_dict(), device=dev)
        out = {}
        for d_, n_ in ((dev, ng), ("cpu", nc)):
            opt = mlm.adam(n_, 1e-3)
            ls = []
            for b in batches:
                bt = [torch.from_numpy(x).to(d_) for x in b]
                ls.append(float(mlm.train_step(n_, opt,
                                               lambda: loss(n_, *bt))))
            out[str(d_)] = (ls, n_.state_dict())
        (lg, sg), (lc, sc) = out[str(dev)], out["cpu"]
        lerr = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(lg, lc))
        perr_ = params_err(sg, sc, 1e-3)
        require(lerr < 1e-5 and perr_ < 0,
                f"{name} card vs CPU after 5 Adam steps: loss {lerr}, "
                f"params {perr_} beyond the bound")
        return {"loss_rel_err": lerr, "params_beyond_bound": perr_,
                "param_max_abs_err": max(float((sg[k_].cpu() - sc[k_])
                                               .abs().max()) for k_ in sc)}

    def mse(n_, x, y):
        return torch.mean((n_(x) - y) ** 2)

    def rnd(*shape):
        return rs.randn(*shape).astype(np.float32)
    adam = {
        "MLFlipNet": adam_pair(
            "MLFlipNet", lambda: mlm.MLFlipNet(hidden=32), [rnd(1, 108)],
            [(rnd(128, 108), (rs.rand(128) < 0.5).astype(np.float32),
              rnd(128, 3)) for _ in range(5)], mlf.mlflip_loss),
        "TiledSRNet": adam_pair(
            "TiledSRNet", lambda: mlm.TiledSRNet(upres=2),
            [rnd(1, 8, 8, 8, 1)],
            [(rnd(8, 8, 8, 8, 1), rnd(8, 16, 16, 16, 1)) for _ in range(5)],
            mse),
        "PressureResNet": adam_pair(
            "PressureResNet", lambda: mlm.PressureResNet(features=8,
                                                         blocks=2),
            [rnd(1, 24, 24, 24, 2)],
            [(rnd(4, 24, 24, 24, 2), rnd(4, 24, 24, 24)) for _ in range(5)],
            mlres.resnet_loss),
        "DenseAutoencoder": adam_pair(
            "DenseAutoencoder", lambda: mlse.DenseAutoencoder(),
            [rnd(1, 64, 64, 1)],
            [(x, x) for x in (rnd(10, 64, 64, 1) for _ in range(5))], mse)}
    # the GAN's alternating steps from the same weights
    gan_out = {}
    cs, fs = rnd(4, 8, 8, 8, 1), rnd(4, 16, 16, 16, 1)
    g0 = mlgan.make_gan_states(torch.from_numpy(cs), torch.from_numpy(fs))
    for d_ in (dev, "cpu"):
        gen = mlm.load_params(mlgan.ResUpresGenerator(upres=2),
                              g0["gen"].state_dict(), device=d_)
        disc = mlm.load_params(mlgan.PatchDiscriminator(),
                               g0["disc"].state_dict(), device=d_)
        gs, ds = mlgan.gan_train_steps(gen, disc, mlm.adam(gen, 1e-4),
                                       mlm.adam(disc, 1e-4))
        ls = []
        for i in range(5):
            c_t = torch.from_numpy(cs + 0.1 * i).to(d_)
            f_t = torch.from_numpy(fs - 0.1 * i).to(d_)
            ls.append(float(ds(None, None, None, c_t, f_t)[2]))
            ls.append(float(gs(None, None, None, c_t, f_t)[2]))
        gan_out[str(d_)] = (ls, {**gen.state_dict(), **{
            "disc." + k_: v for k_, v in disc.state_dict().items()}})
    (lg, sg), (lc, sc) = gan_out[str(dev)], gan_out["cpu"]
    lerr = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(lg, lc))
    perr_ = params_err(sg, sc, 1e-4)
    require(lerr < 1e-5 and perr_ < 0,
            f"GAN card vs CPU after 5 step pairs: loss {lerr}, params "
            f"{perr_} beyond the bound")
    adam["GAN"] = {"loss_rel_err": lerr, "params_beyond_bound": perr_,
                   "param_max_abs_err": max(float((sg[k_].cpu() - sc[k_])
                                                  .abs().max()) for k_ in sc)}
    cmp["adam_5_steps"] = adam

    # one dataset frame of each generator at 16^3
    tmp = tempfile.mkdtemp()
    try:
        ds_err = {}
        for kind, fn in (("smoke", mldg.generate_smoke_dataset),
                         ("flip", mldg.generate_flip_dataset)):
            for d_ in (dev, "cpu"):
                fn(os.path.join(tmp, kind, str(d_)), num_sims=1,
                   num_frames=1, res=16, device=d_)
            base = os.path.join(tmp, kind, "cpu", "sim_000000")
            for f_ in sorted(os.listdir(base)):
                a_ = np.load(os.path.join(base, f_))["data"]
                b_ = np.load(os.path.join(tmp, kind, str(dev), "sim_000000",
                                          f_))["data"]
                require(a_.shape == b_.shape and a_.dtype == b_.dtype,
                        f"dataset {kind} {f_}: shapes")
                ds_err[f"{kind}/{f_}"] = float(np.abs(a_ - b_).max())
        tol = {"parts": 1e-4, "pvel": 1e-4}
        for k_, e in ds_err.items():
            require(e < tol.get(k_.split("/")[1].split("_")[0], 2e-4),
                    f"dataset card vs CPU: {k_} {e}")
        cmp["dataset_frame_16"] = ds_err
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    numbers["card_vs_cpu"] = cmp
    print(f"ML card vs CPU: {json.dumps(cmp)}", flush=True)
    return numbers, k2_err


class _Helpers:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def _every_kernel(advk, fadk, rbk, p2gk, lsk, blk, xk, prk):
    """Every kernel wrapper by name, each with its ``launches`` count."""
    from mantaflow_tpu_torch.ops import advection_exact_kernels as advx
    return {"advect_bucket": fadk.advect_blend_live,
            "advect_bucket_public": fadk.advect_blend,
            "advect_bucket_no_blend": fadk.advect,
            "rebin_fused": rbk.rebin_fused,
            "rebin_fused_slab": rbk.rebin_fused_slab,
            "rebin": rbk.rebin_pass, "rebin_zshard": rbk.rebin_zpass_halo,
            "p2g_levelset": p2gk.p2g_union, "p2g_mac": p2gk.p2g_mac,
            "union_levelset": lsk.union_levelset,
            "flip_blend": blk.flip_update, "extrap_layer": xk.extrap_layer,
            "cg_solve": prk.cg_solve, "window_advect": advk.window_pass,
            "window_advect_zshard": advk.window_pass_slab,
            "advect_bucket_zshard": fadk.advect_blend_slab_live,
            "advect_bucket_zshard_public": fadk.advect_blend_slab,
            "p2g_levelset_zshard": p2gk.p2g_union_slab,
            "advect_exact_fwd": advx.forward,
            "advect_exact_bwd": advx.backward,
            "advect_exact_outflow": advx.outflow}


def traced_busy(torch, step, st, n):
    """n steps of ``step`` under torch.profiler: (traced wall ms, device
    busy ms, device launches) a step, and the last state."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(n):
            st = step(st)
        t1.record()
        torch.cuda.synchronize()
    busy_us, count = 0.0, 0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us > 0:
            busy_us += us
            count += e.count
    return t0.elapsed_time(t1) / n, busy_us / 1e3 / n, count / n, st


def multi_device_rest(torch, dev, h):
    """Phase 32's cases of what a sharded state once could not run, each
    held against the same state on one device from the same start: the
    bench smoke at RES^3 with PcMGStatic over ZSHARDS slabs (the V-cycles'
    levels on the slabs), in its closed box with zero-pressure fixing
    (``cg_accuracy`` < 1e-7) over ZSHARDS, and over 3 shards (43, 43 and
    42 planes at 128^3), each to 1e-5 with CG iterations within 2; the
    flat dam at FLIP_RES^3 over 3 shards by each solve's true residual
    (its ghost-fluid solves exit at another iterate under any other order
    of sums) with equal flags; the 2D plume at PLUME_RES^2 over ZSHARDS
    (one plane: shard 0 holds it, the other slabs are empty) the same way,
    its ~850-iteration solves parting by ~1e-4 in vel (the CPU's plain CG
    against the slab CG parts as far), with equal systems on the first
    step and its fields within the accuracy x max(1, scale). Each
    then timed (CUDA events) with its launches counted. ``h``:
    ``every_kernel``. Returns (numbers, launches by smoke path, launches
    by FLIP path, failures)."""
    import dataclasses as dc
    from mantaflow_tpu_torch.core import flags as fl_
    from mantaflow_tpu_torch.core.domain import Domain
    from mantaflow_tpu_torch.core.shapes import Cylinder, Sphere
    from mantaflow_tpu_torch.models import flip, smoke
    from mantaflow_tpu_torch.ops import pressure as prs
    from mantaflow_tpu_torch.parallel import sharding as shd

    kernels = h.every_kernel
    numbers, smoke_p, flip_p, failures = {}, {}, {}, []

    def reset():
        torch.cuda.synchronize()
        for fn in kernels.values():
            fn.launches = 0

    def counts():
        torch.cuda.synchronize()
        return {k: fn.launches for k, fn in kernels.items()}

    def timed(step, st, n):
        iters = torch.zeros((), dtype=torch.int64, device=dev)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(n):
            st = step(st)
            iters += st.cg_iters
        t1.record()
        torch.cuda.synchronize()
        return st, t0.elapsed_time(t1) / n, int(iters) / n

    def true_res(rhs, sten, fluid, p, dom):
        r = rhs.double() - prs._apply_stencil(
            p.double(), tuple(a.double() for a in sten), dom, fluid)
        return float(r.abs()[fluid].max())

    def kept(mod, name, got_):
        """``mod.name`` wrapped to keep its calls' arguments; returns the
        original."""
        fn = getattr(mod, name)

        def wrap(*a, **kw):
            got_.append(a)
            return fn(*a, **kw)
        setattr(mod, name, wrap)
        return fn

    def smoke_case(name, params, dom, st0, mesh, held_steps, timed_steps,
                   want, by_residual=False):
        """``held_steps`` against one device, then ``timed_steps`` timed;
        ``want``: each kernel's launches a step. Held to 1e-5, or
        ``by_residual`` (solves of hundreds of iterations, which exit at
        another iterate under another order of sums): equal systems on
        the first step, each solve under its accuracy by its true
        residual, the fields within the accuracy x max(1, scale)."""
        one, sh = st0, shd.shard_smoke_state(st0, mesh)
        held, acc = [], params.cg_accuracy
        for k in range(held_steps):
            calls1, calls2 = [], []
            orig = kept(prs, "solve_pressure_system", calls1)
            try:
                one = smoke.smoke_step(one, dom, params)
            finally:
                prs.solve_pressure_system = orig
            orig = kept(prs, "cg_slabs", calls2)
            try:
                sh = smoke.smoke_step(sh, dom, params)
            finally:
                prs.cg_slabs = orig
            w = shd.unshard_smoke_state(sh)
            errs_ = {f: float((getattr(w, f) - getattr(one, f)).abs().max())
                     for f in ("vel", "density", "pressure")}
            rec = {"max_abs_err": max(errs_.values()),
                   "cg_iters_one": int(one.cg_iters),
                   "cg_iters_slabs": int(sh.cg_iters)}
            ok = (torch.equal(w.flags, one.flags)
                  and abs(int(sh.cg_iters) - int(one.cg_iters)) <= 2)
            if by_residual:
                (a1,), (a2,) = calls1, calls2
                fluid = fl_.is_fluid(a1[1])
                rhs2 = a2[0].whole()
                sten2 = tuple(x.whole() for x in a2[2])
                rec["true_residual_one"] = true_res(a1[0], a1[3], fluid,
                                                    one.pressure, dom)
                rec["true_residual_slabs"] = true_res(rhs2, sten2, fluid,
                                                      w.pressure, dom)
                rec["limit"] = {f: acc * max(1.0, float(
                    getattr(one, f).abs().max())) for f in errs_}
                ok = (ok and rec["true_residual_one"] < acc * 1.01
                      and rec["true_residual_slabs"] < acc * 1.01
                      and all(errs_[f] <= rec["limit"][f] for f in errs_))
                if k == 0:
                    rec["system_max_abs_diff"] = max(
                        float((rhs2 - a1[0]).abs().max()),
                        *(float((x - y).abs().max())
                          for x, y in zip(sten2, a1[3])))
                    ok = ok and rec["system_max_abs_diff"] == 0.0
                del a1, a2, rhs2, sten2
            else:
                ok = ok and rec["max_abs_err"] <= 1e-5
            del calls1, calls2
            held.append(rec)
            if not ok:
                failures.append(f"{name} step {k + 1}: {held[-1]}")
        del one, w
        reset()
        sh, ms, it = timed(lambda s: smoke.smoke_step(s, dom, params), sh,
                           timed_steps)
        got = counts()
        smoke_p[name] = got
        for k_, n_ in got.items():
            require(n_ == want.get(k_, 0) * timed_steps,
                    f"{name}: {k_} launched {n_} times in {timed_steps} "
                    f"steps (expected {want.get(k_, 0)} a step)")
        numbers[name] = {
            "shards": mesh.n, "planes": [p.shape[0] for p in
                                         sh.density.parts],
            "first_steps_vs_one_device": held, "ms_per_step": ms,
            "cg_iters_per_step": it,
            "launches_per_step": {k_: n_ / timed_steps
                                  for k_, n_ in got.items() if n_}}
        print(f"{name}: {ms:.2f} ms/step over {mesh.n} shards "
              f"{numbers[name]['planes']}, CG {it:.1f} it/step; first "
              f"steps {held}", flush=True)
        return sh

    mesh, mesh3 = shd.make_mesh(ZSHARDS), shd.make_mesh(3)
    zslab = {"window_advect_zshard": 8 * ZSHARDS}

    # the bench smoke with PcMGStatic: its hierarchy cut level by level
    mg = dc.replace(bench_params(smoke), preconditioner=prs.PcMGStatic)
    dom, st0 = bench_state(smoke, Domain, Sphere, RES, dev, mg)
    smoke_case(f"smoke_mg_slabs_{RES}", mg, dom, st0, mesh, 2, 3, zslab)

    # the closed box: no empty or outflow cell, so the solve pins a cell
    fix = dc.replace(bench_params(smoke), cg_accuracy=1e-8)
    dom, st0 = bench_state(smoke, Domain, Sphere, RES, dev, fix)
    require(int((fl_.is_empty(st0.flags) | fl_.is_outflow(st0.flags)).sum())
            == 0, "the bench smoke's box is not closed")
    smoke_case(f"smoke_fix_slabs_{RES}", fix, dom, st0, mesh, 2, 2, zslab)

    # 3 shards: RES planes in GSPMD's padded layout
    params = bench_params(smoke)
    dom, st0 = bench_state(smoke, Domain, Sphere, RES, dev)
    smoke_case(f"smoke_slabs3_{RES}", params, dom, st0, mesh3, 2, 3,
               {"window_advect_zshard": 8 * 3})
    del st0

    # the 2D plume (phase 19's) on the mesh: one plane, on shard 0
    pp = smoke.SmokeParams(buoyancy=(0.0, -4e-3, 0.0), open_bound="yY",
                           window=K, adaptive_dt=True, cfl=float(K))
    pdom = Domain(size=(PLUME_RES, PLUME_RES, 1), dim=2)
    pst = smoke.make_smoke_state(pdom, pp, source_shape=Cylinder(
        center=(PLUME_RES * 0.5, PLUME_RES * 0.1, 0.5),
        radius=PLUME_RES * 0.14, z=(0.0, PLUME_RES * 0.02, 0.0)),
        device=dev)
    smoke_case(f"plume2d_slabs_{PLUME_RES}", pp, pdom, pst, mesh, 2, 2,
               {"window_advect": 6}, by_residual=True)
    del pst

    # the flat dam over 3 shards, held by residual
    fparams = flip_bench_params(flip)
    fdom = Domain(size=(FLIP_RES,) * 3, dim=3)
    f0 = flip.make_dam_state(fdom, fparams, discretization=2, device=dev)
    n_parts = int(f0.parts.count)
    one, sh = f0, shd.shard_flip_state(f0, mesh3)
    held, acc = [], fparams.cg_accuracy
    for k in range(2):
        calls1, calls2 = [], []
        orig = kept(prs, "solve_pressure_system", calls1)
        try:
            one = flip.flip_step(one, fdom, fparams)
        finally:
            prs.solve_pressure_system = orig
        orig = kept(prs, "cg_slabs", calls2)
        try:
            sh = flip.flip_step(sh, fdom, fparams)
        finally:
            prs.cg_slabs = orig
        (a1,), (a2,) = calls1, calls2
        fluid = fl_.is_fluid(a1[1])
        w = shd.unshard_flip_state(sh)
        rec = {"flags_equal": bool(torch.equal(w.flags, one.flags)),
               "cg_iters_one": int(one.cg_iters),
               "cg_iters_slabs": int(sh.cg_iters),
               "max_abs_diff": max(
                   float((getattr(w, f) - getattr(one, f)).abs().max())
                   for f in ("vel", "phi", "pressure", "pvel")),
               "true_residual_one": true_res(a1[0], a1[3], fluid,
                                             one.pressure, fdom),
               "true_residual_slabs": true_res(
                   a2[0].whole(), tuple(x.whole() for x in a2[2]), fluid,
                   w.pressure, fdom)}
        held.append(rec)
        if not (rec["flags_equal"] and int(w.parts.count) == n_parts
                and rec["true_residual_one"] < acc * 1.01
                and rec["true_residual_slabs"] < acc * 1.01):
            failures.append(f"flat slabs3 step {k + 1}: {rec}")
        del a1, a2, calls1, calls2
    del one, w
    reset()
    sh, fms, fit = timed(lambda s: flip.flip_step(s, fdom, fparams), sh, 3)
    got = counts()
    flip_p[f"flat_slabs3_{FLIP_RES}"] = got
    for k_, n_ in got.items():
        want = 10 * 3 * 3 if k_ == "extrap_layer" else 0
        require(n_ == want, f"flat slabs3: {k_} launched {n_} times in 3 "
                f"steps (expected {want})")
    w = shd.unshard_flip_state(sh)
    require(int(w.parts.count) == n_parts
            and bool(torch.isfinite(w.vel).all()),
            "flat slabs3: particles lost or not finite")
    numbers[f"flat_slabs3_{FLIP_RES}"] = {
        "shards": 3, "planes": [p.shape[1] for p in sh.vel.parts],
        "particles": n_parts, "first_steps_vs_one_device": held,
        "ms_per_step": fms, "cg_iters_per_step": fit,
        "launches_per_step": {k_: n_ / 3 for k_, n_ in got.items() if n_}}
    print(f"flat slabs3 {FLIP_RES}^3: {fms:.2f} ms/step, CG {fit:.1f} "
          f"it/step; first steps {held}", flush=True)
    del sh, w, f0
    torch.cuda.empty_cache()
    return numbers, smoke_p, flip_p, failures


def multi_device_phase(torch, dev, h):
    """32. The multi-device module (A.3) and the repairs C.1-C.2 on the
    card: the sharded bench smoke and the sharded flat FLIP dam at 128^3
    over ZSHARDS shards on one card, each held against the one-device run
    from the same start, timed and traced, with the slab CG's iterations
    and the halo copies; the dry run at ZSHARDS shards; the float scatters'
    repeat (tools/scatter_order.py --witness); scenes/smoke_fused_128.py
    and scenes/mlflip.py 1, unedited, through the scene runner; and
    ``multi_device_rest``'s cases (multigrid, zero-pressure fixing, 3
    shards, the 2D plume on the mesh, the flat dam over 3 shards). Returns
    (numbers, launches by path: smoke paths, flip paths, scene paths)."""
    import contextlib
    import io
    import os
    from mantaflow_tpu_torch.core.domain import Domain
    from mantaflow_tpu_torch.core.shapes import Sphere
    from mantaflow_tpu_torch.models import flip, smoke
    from mantaflow_tpu_torch.ops import pressure as prs
    from mantaflow_tpu_torch.parallel import dryrun
    from mantaflow_tpu_torch.parallel import sharding as shd
    from mantaflow_tpu_torch.scene import run as srun

    here = os.path.dirname(os.path.abspath(__file__))
    kernels = h.every_kernel
    mesh = shd.make_mesh(ZSHARDS)
    numbers, smoke_p, flip_p, scene_p = {}, {}, {}, {}
    failures = []

    def reset():
        torch.cuda.synchronize()
        for fn in kernels.values():
            fn.launches = 0

    def counts():
        torch.cuda.synchronize()
        return {k: fn.launches for k, fn in kernels.items()}

    def rhs_max(flags, vel, dom_, phi=None):
        """max |negative divergence| over the interior fluid cells after a
        projection: the solve's true residual."""
        return float(prs.make_rhs(flags, vel, dom_, phi=phi).abs().max())

    def timed(step, st, n):
        iters = torch.zeros((), dtype=torch.int64, device=dev)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(n):
            st = step(st)
            iters += st.cg_iters
        t1.record()
        torch.cuda.synchronize()
        return st, t0.elapsed_time(t1) / n, int(iters) / n

    def slab_costs(step, st):
        """One step more with every halo_z call timed by CUDA events and
        the slab CG's system kept; then that system solved 3 times, timed.
        Returns (halo ms a step, halo calls, slab CG ms, its iterations)."""
        spans, systems = [], []
        halo, cg = shd.halo_z, prs.cg_slabs

        def timed_halo(*a, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = halo(*a, **kw)
            e1.record()
            spans.append((e0, e1))
            return out

        def kept_cg(*a):
            systems.append(a)
            return cg(*a)
        shd.halo_z, prs.cg_slabs = timed_halo, kept_cg
        try:
            step(st)
            torch.cuda.synchronize()
        finally:
            shd.halo_z, prs.cg_slabs = halo, cg
        halo_ms = sum(a.elapsed_time(b) for a, b in spans)
        n_halo = len(spans)
        del spans
        args = systems[-1]
        _, it, _ = cg(*args)
        ms = cuda_ms(torch, lambda: cg(*args), 3)
        return halo_ms, n_halo, ms, int(it)

    # -- the sharded bench smoke at 128^3 ----------------------------------
    params = bench_params(smoke)
    dom, st0 = bench_state(smoke, Domain, Sphere, RES, dev)
    one, sh = st0, shd.shard_smoke_state(st0, mesh)
    held = []
    for k in range(3):
        one = smoke.smoke_step(one, dom, params)
        sh = smoke.smoke_step(sh, dom, params)
        w = shd.unshard_smoke_state(sh)
        err = max(float((getattr(w, f) - getattr(one, f)).abs().max())
                  for f in ("vel", "density", "pressure"))
        di = int(sh.cg_iters) - int(one.cg_iters)
        held.append({"max_abs_err": err, "cg_iters_one": int(one.cg_iters),
                     "cg_iters_slabs": int(sh.cg_iters)})
        if not (err <= 1e-5 and torch.equal(w.flags, one.flags)
                and abs(di) <= 2):
            failures.append(f"smoke slabs step {k + 1}: {held[-1]}")
    reset()
    step_s = (lambda s: smoke.smoke_step(s, dom, params))
    s = step_s(shd.shard_smoke_state(st0, mesh))  # warm
    s, ms, it = timed(step_s, s, 10)
    got = counts()
    smoke_p["smoke_slabs_128"] = got
    want = {"window_advect_zshard": 8 * ZSHARDS * 11}
    for k_, n_ in got.items():
        require(n_ == want.get(k_, 0), f"smoke slabs: {k_} launched {n_} "
                f"times in 11 steps (expected {want.get(k_, 0)})")
    for _ in range(8):
        one = smoke.smoke_step(one, dom, params)
    w = shd.unshard_smoke_state(s)
    res_one, res_sh = (rhs_max(x.flags, x.vel, dom) for x in (one, w))
    for who, r in (("one device", res_one), ("slabs", res_sh)):
        if not r < params.cg_accuracy * 1.01:
            failures.append(f"smoke after 11 steps, {who}: residual {r}")
    traced_ms, busy_ms, n_dev, s = traced_busy(torch, step_s, s, 3)
    halo_ms, n_halo, cg_ms, cg_it = slab_costs(step_s, s)
    numbers["smoke_slabs_128"] = {
        "shards": ZSHARDS, "mesh": mesh.shape, "ms_per_step": ms,
        "cg_iters_per_step": it, "first_steps_vs_one_device": held,
        "residual_after_11_steps": {"one_device": res_one, "slabs": res_sh},
        "traced_wall_ms_per_step": traced_ms,
        "device_busy_ms_per_step": busy_ms,
        "device_launches_per_step": n_dev,
        "idle_share_traced": 1.0 - busy_ms / traced_ms,
        "halo_ms_per_step": halo_ms, "halo_calls_per_step": n_halo,
        "slab_cg_ms": cg_ms, "slab_cg_iterations": cg_it,
        "slab_cg_us_per_iteration": 1e3 * cg_ms / max(cg_it, 1),
        "launches_per_step": {k_: n_ / 11 for k_, n_ in got.items() if n_}}
    print(f"smoke slabs 128^3 x{ZSHARDS}: {ms:.2f} ms/step, CG {it:.1f} "
          f"it/step, busy {busy_ms:.2f} of {traced_ms:.2f} ms traced, halo "
          f"{halo_ms:.2f} ms/step ({n_halo} calls), slab CG "
          f"{1e3 * cg_ms / max(cg_it, 1):.1f} us/it; first steps {held}",
          flush=True)
    del one, sh, s, w, st0

    # -- the sharded flat FLIP dam at 128^3 --------------------------------
    # held by residual from the first step: its ghost-fluid solves to 1e-3
    # hover near the accuracy for tens of iterations, so any other order of
    # sums moves the exit iterate (phase 14 holds K2 against cg_plain the
    # same way). Per step: flags equal, each solve's true residual below
    # the accuracy; on the first the systems equal to 2e-5 (the p2g's
    # partial sums add in shard order) and the first 10 iterations of the
    # slab CG and K2 on the one system to rel 1e-5
    from mantaflow_tpu_torch.core import flags as fl_
    from mantaflow_tpu_torch.ops import pressure_kernels as prk_
    fparams = flip_bench_params(flip)
    fdom = Domain(size=(FLIP_RES,) * 3, dim=3)
    f0 = flip.make_dam_state(fdom, fparams, discretization=2, device=dev)
    n_parts = int(f0.parts.count)
    one, sh = f0, shd.shard_flip_state(f0, mesh)

    def true_res(rhs, sten, fluid, p):
        r = rhs.double() - prs._apply_stencil(
            p.double(), tuple(a.double() for a in sten), fdom, fluid)
        return float(r.abs()[fluid].max())

    def kept(mod, name):
        fn, got_ = getattr(mod, name), []

        def wrap(*a, **kw):
            got_.append((a, kw))
            return fn(*a, **kw)
        setattr(mod, name, wrap)
        return fn, got_
    held = []
    acc = fparams.cg_accuracy
    for k in range(3):
        k2, k2_calls = kept(prs, "solve_pressure_system")
        try:
            one = flip.flip_step(one, fdom, fparams)
        finally:
            prs.solve_pressure_system = k2
        sc, sc_calls = kept(prs, "cg_slabs")
        try:
            sh = flip.flip_step(sh, fdom, fparams)
        finally:
            prs.cg_slabs = sc
        (a1, kw1), = k2_calls
        (a2, _), = sc_calls
        rhs1, sten1, fluid1 = a1[0], a1[3], fl_.is_fluid(a1[1])
        rhs2 = a2[0].whole()
        sten2 = tuple(x.whole() for x in a2[2])
        w = shd.unshard_flip_state(sh)
        rec = {"flags_equal": bool(torch.equal(w.flags, one.flags)),
               "cg_iters_one": int(one.cg_iters),
               "cg_iters_slabs": int(sh.cg_iters),
               "max_abs_diff": max(
                   float((getattr(w, f) - getattr(one, f)).abs().max())
                   for f in ("vel", "phi", "pressure", "pvel")),
               "true_residual_one": true_res(rhs1, sten1, fluid1,
                                             one.pressure),
               "true_residual_slabs": true_res(rhs2, sten2, fluid1,
                                               w.pressure)}
        ok = (rec["flags_equal"] and rec["true_residual_one"] < acc * 1.01
              and rec["true_residual_slabs"] < acc * 1.01)
        if k == 0:
            rec["system_max_abs_diff"] = max(
                float((rhs2 - rhs1).abs().max()),
                *(float((x - y).abs().max()) for x, y in zip(sten2, sten1)))
            p10, _, _ = prk_.cg_solve(rhs1, sten1, fdom, 0.0, 10,
                                      fluid=fluid1)
            q10, _, _ = prs.cg_slabs(*a2[:4], 0.0, 10)
            rec["rel_err_at_10_iterations"] = float(
                (q10.whole() - p10).abs().max()) / float(p10.abs().max())
            ok = (ok and rec["system_max_abs_diff"] <= 2e-5
                  and rec["rel_err_at_10_iterations"] < 1e-5)
        held.append(rec)
        if not ok:
            failures.append(f"flat slabs step {k + 1}: {rec}")
        del a1, a2, kw1, k2_calls, sc_calls, rhs1, rhs2, sten1, sten2
    del one, sh, w
    reset()
    step_f = (lambda s: flip.flip_step(s, fdom, fparams))
    s = step_f(shd.shard_flip_state(f0, mesh))  # warm
    s, fms, fit = timed(step_f, s, 10)
    got = counts()
    flip_p["flat_slabs_128"] = got
    # per shard and step: 2 layers a component from the weights (6), 4 a
    # component after the solve (12, extrapolate_mac_simple) and the
    # levelset's 3 (extrapolate_ls_simple)
    per_step = {"extrap_layer": got["extrap_layer"] / 11}
    want = {"extrap_layer": 10 * ZSHARDS * 11}
    for k_, n_ in got.items():
        require(n_ == want.get(k_, 0), f"flat slabs: {k_} launched {n_} "
                f"times in 11 steps (expected {want.get(k_, 0)})")
    w = shd.unshard_flip_state(s)
    act = w.parts.active_mask()
    require(int(w.parts.count) == n_parts, "flat slabs: particles lost")
    require(bool(torch.isfinite(w.vel).all())
            and bool(torch.isfinite(w.parts.pos[act]).all()),
            "flat slabs: not finite")
    res_sh = rhs_max(w.flags, w.vel, fdom, w.phi)
    traced_f, busy_f, ndev_f, s = traced_busy(torch, step_f, s, 3)
    fhalo_ms, fn_halo, fcg_ms, fcg_it = slab_costs(step_f, s)
    numbers["flat_slabs_128"] = {
        "shards": ZSHARDS, "particles": n_parts, "ms_per_step": fms,
        "cg_iters_per_step": fit, "first_steps_vs_one_device": held,
        "traced_wall_ms_per_step": traced_f,
        "device_busy_ms_per_step": busy_f,
        "device_launches_per_step": ndev_f,
        "idle_share_traced": 1.0 - busy_f / traced_f,
        "halo_ms_per_step": fhalo_ms, "halo_calls_per_step": fn_halo,
        "slab_cg_ms": fcg_ms, "slab_cg_iterations": fcg_it,
        "slab_cg_us_per_iteration": 1e3 * fcg_ms / max(fcg_it, 1),
        "divergence_after_11_steps": res_sh,
        "launches_per_step": per_step}
    print(f"flat slabs 128^3 x{ZSHARDS}: {n_parts} particles, {fms:.2f} "
          f"ms/step, CG {fit:.1f} it/step, busy {busy_f:.2f} of "
          f"{traced_f:.2f} ms traced, halo {fhalo_ms:.2f} ms/step, slab CG "
          f"{1e3 * fcg_ms / max(fcg_it, 1):.1f} us/it, K14 "
          f"{per_step['extrap_layer']:.0f} a step; first steps {held}",
          flush=True)
    del s, w, f0

    # -- multigrid, fixing, 3 shards and 2D on the mesh ---------------------
    rest, rest_smoke, rest_flip, rest_failures = multi_device_rest(
        torch, dev, h)
    numbers["rest"] = rest
    smoke_p.update(rest_smoke)
    flip_p.update(rest_flip)
    failures += rest_failures

    # -- the dry run at ZSHARDS shards on the card -------------------------
    reset()
    t0 = time.perf_counter()
    lines = dryrun.dryrun(ZSHARDS)
    numbers["dryrun"] = {"shards": ZSHARDS, "lines": lines,
                         "s": time.perf_counter() - t0}
    require(len(lines) == 5, f"dry run: {lines}")
    got = counts()
    smoke_p["dryrun"] = {k_: got[k_] for k_ in
                         ("window_advect", "window_advect_zshard",
                          "cg_solve")}
    flip_p["dryrun"] = {k_: (0 if k_ in smoke_p["dryrun"] else n_)
                        for k_, n_ in got.items()}

    # -- C.2: the float scatters repeat bit for bit ------------------------
    sys.path.insert(0, os.path.join(here, "tools"))
    import scatter_order
    with contextlib.redirect_stdout(io.StringIO()):
        wit = scatter_order.witness(dev, res=FLIP_RES, runs=5)
    numbers["scatter_repeat"] = wit
    for k_, v in wit.items():
        require(v["distinct_results"] == 1, f"{k_}: {v['distinct_results']}"
                " distinct results over 5 runs")
    print("scatter repeat: " + ", ".join(
        f"{k_} {v['distinct_results']} distinct over 5 runs" for k_, v in
        wit.items()), flush=True)

    # -- C.1: the two scenes that read np.asarray of card tensors ---------
    out_dir = os.path.join(here, "build", "scene_out")
    os.makedirs(out_dir, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(out_dir)
    try:
        reset()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            g = srun.run_scene(os.path.join(here, "scenes",
                                            "smoke_fused_128.py"), [], dev)
        torch.cuda.synchronize()
        sf_s = time.perf_counter() - t0
        smoke_p["smoke_fused_128_scene"] = counts()
        sf_lines = out.getvalue().splitlines()
        require(len(sf_lines) == 10 and os.path.exists(
            "smoke128_final.npz"), f"smoke_fused_128: {sf_lines[-2:]}")
        # the same run through the port's API, from the same start
        sdom = Domain(size=(128, 128, 128), dim=3)
        sp = smoke.SmokeParams(buoyancy=(0.0, -6e-4, 0.0),
                               vorticity_confinement=0.1, window=3,
                               adaptive_dt=True, cfl=3.0, dt_max=2.0)
        ref = smoke.make_smoke_state(sdom, sp, source_shape=Sphere(
            center=(64.0, 12.8, 64.0), radius=128 * 0.14), device=dev)
        for _ in range(10):
            ref = smoke.smoke_run(ref, sdom, sp, 10)
        for f in ("flags", "vel", "density", "pressure"):
            require(torch.equal(getattr(g["state"], f), getattr(ref, f)),
                    f"smoke_fused_128: {f} differs from smoke_run")
        del g, ref
        reset()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            g = srun.run_scene(os.path.join(here, "scenes", "mlflip.py"),
                               ["1"], dev)
        torch.cuda.synchronize()
        ml_s = time.perf_counter() - t0
        scene_p["mlflip_scene_1"] = counts()
        ml_last = out.getvalue().strip().splitlines()[-1]
        require(ml_last.startswith("done:") and g["state"].vel.is_cuda,
                f"mlflip.py 1: {ml_last}")
        del g
    finally:
        os.chdir(cwd)
    numbers["scenes_on_card"] = {
        "smoke_fused_128": {"s": sf_s, "last_line": sf_lines[-1],
                            "bitwise_vs_smoke_run": True},
        "mlflip_1": {"s": ml_s, "last_line": ml_last}}
    print(f"scenes on the card: smoke_fused_128.py {sf_s:.1f} s "
          f"({sf_lines[-1]}), bit for bit smoke_run; mlflip.py 1 "
          f"{ml_s:.1f} s ({ml_last})", flush=True)
    torch.cuda.empty_cache()
    require(not failures, "; ".join(failures))
    return numbers, smoke_p, flip_p, scene_p


#: phase 33: the scenes of scenes/ on the card, unedited, through the
#: runner. Groups share one directory (MANTA_OUT, the cwd); a run is (file,
#: argv, env). Every file keeps its own grid size; only frame counts are
#: cut. flip06_obstacle.py, smoke_fused_128.py and mlflip.py run in phases
#: 29 and 32, zflip.py and run.py (which drives it) in phase 34
SCENE_GROUPS = (
    ("simpleplume", (("simpleplume.py", ("4",), {}),)),
    ("plume_adaptDt", (("plume_adaptDt.py", ("3",), {}),)),
    ("plume_2d", (("plume_2d.py", (), {}),)),
    ("karman", (("karman.py", (), {"FRAMES": "2"}),)),
    ("lidDrivenCavity", (("lidDrivenCavity.py", ("6",), {}),)),
    ("fire", (("fire.py", ("4",), {}),)),
    ("turbulence", (("turbulence.py", ("3",), {}),)),
    ("waveletTurbulence", (("waveletTurbulence.py", (), {"FRAMES": "2"}),)),
    ("waveletTurbulenceObs", (("waveletTurbulenceObs.py", ("2",), {}),)),
    ("waveEquation", (("waveEquation.py", ("8",), {}),)),
    ("benchmark_wave", (("benchmark_wave.py", ("0.1",), {}),)),
    ("movingObstacle", (("movingObstacle.py", ("6",), {}),)),
    ("meshload", (("meshload.py", ("3",), {}),)),
    ("guiding_2d", (("guiding_2d.py", ("3",), {}),)),
    ("guiding_3d", (("guiding_3d01_low.py", ("2",), {}),
                    ("guiding_3d02_high.py", ("1",), {}))),
    ("numpy_array_simple", (("numpy_array_simple.py", ("4",), {}),)),
    ("numpy_write_read", (("numpy_write_read.py", ("2",), {}),)),
    ("flip01_simple", (("flip01_simple.py", (), {"FRAMES": "2"}),)),
    ("flip02_chain", (("flip02_surface.py", ("4",),
                       {"MANTA_SAVE_PARTS": "1"}),
                      ("flip03_gen.py", ("2",), {}))),
    ("flip03_levelset", (("flip03_levelset.py", (), {}),)),
    ("flip04_adaptDt", (("flip04_adaptDt.py", ("2",), {}),)),
    ("flip05_nbflip", (("flip05_nbflip.py", ("2",), {}),)),
    ("freesurface", (("freesurface.py", (), {"FRAMES": "2"}),)),
    ("surfaceTension", (("surfaceTension.py", ("3",), {}),)),
    ("apic01_simple", (("apic01_simple.py", ("6",), {}),)),
    ("idp_apic01_simple", (("idp_apic01_simple.py", ("5",), {}),)),
    ("idp_apic02_3d", (("idp_apic02_3d.py", ("2",), {}),)),
    ("surfaceTurbulence", (("surfaceTurbulence.py", ("2",), {}),)),
    ("benchmark_dam", (("benchmark_dam.py", ("10", "0.1"), {}),)),
)
#: scenes the card runs whole but holds against the CPU over their first
#: Solver.step calls only (the CPU twin of 120 frames at 48^3 takes minutes)
SCENE_CUT = {"flip03_levelset.py": 6}
#: the last K2 solve of these scenes, and the last step's K14 layers of
#: those, against their plain versions
SCENE_K2_CHECK = ("fire.py", "flip05_nbflip.py", "plume_2d.py")
SCENE_K14_CHECK = ("flip05_nbflip.py", "freesurface.py")
#: the headline: IDP volume-preserving APIC at 128^3, timed and traced
IDP_HEAD_RES = 128
IDP_HEAD_FRAMES = 150
SCENE_TWIN_WORKERS = 6  # CPU twins at a time, one torch thread each
#: card-vs-CPU differences kept in ROADMAP C, each measured (NVIDIA H100
#: 80GB HBM3, 700 W). None: the field is held by each device's residual of
#: its last solve alone. K2 sums in another order than the plain CG, so a
#: solve exits at another iterate within its accuracy; these fields grow
#: that apart: the 2D plume's 400 steps (vel 0.56), particles resting on a
#: cell face (benchmark_wave's grid index), a near-zero phi that flips
#: sign and moves the inside extrapolation's layers (flip04's phi 0.88) and
#: adjustNumber's reseeding (flip03_levelset's particles). The port
#: against itself with every solve's accuracy x 0.7 parts the same fields
#: by as much (tools/scene_cg_sensitivity.py). A number: the field's own
#: limit; flip03_gen's improved particle levelset, whose largest
#: eigenvalue jumps where the card's sums move a cell's average (phi
#: 2.97e-3)
SCENE_KNOWN = {
    "plume_2d.py": dict.fromkeys(("density", "pressure", "vel")),
    "benchmark_wave.py": {"gIdx": None},
    "flip04_adaptDt.py": {"phi": None},
    "flip03_levelset.py": dict.fromkeys((
        "gpi", "pVel", "phi", "phiParts", "pp.flags", "pp.pos", "pressure",
        "tmpVec3", "vel", "velOld")),
    "flip03_gen.py": {"phi": 1e-2},
}
#: the last printed line's counts and the globals they count
SCENE_COUNTS = (
    (r"(\d+) particles", ("pp",)),
    (r"(\d+) mesh tris", ("mesh",)),
    (r"(\d+) coarse, (\d+) surface, (\d+) displaced",
     ("pp", "surfacePoints", "surfacePointsDisplaced")),
)


class _SceneCut(Exception):
    """Raised by the cut wrapper of Solver.step; carries the scene's
    globals."""

    def __init__(self, scene_globals):
        super().__init__("cut")
        self.scene_globals = scene_globals


class SolveWatch:
    """Keeps the last linear solve of a scene run: every
    ``pressure.solve_pressure_system`` (solvePressure, solvePressureSystem,
    cgSolveDiffusion, the PD guiding's and the VIC's projections, K2's
    route included) and every ``waves.cg_solve_wave_eq`` (cgSolveWE).
    ``residual()`` gives the last solve's accuracy, whether it exited on its
    own residual, its true residual in float64 over the fluid cells, max
    |rhs - A p| (a sum of squares for the l2 exits), and the limit that
    residual is held to: the accuracy with 1 % for the updated residual's
    drift, plus the residual that rounding p to float32 alone leaves,
    float32's epsilon x the largest row sum of |A| x max |p| (it matters
    where p is large: benchmark_wave.py's pressure reaches 841, and a
    float64 CG on its system exits at the same iteration)."""

    def __init__(self):
        import inspect
        from mantaflow_tpu_torch.ops import pressure as prs
        from mantaflow_tpu_torch.ops import waves as wav
        self.prs, self.wav, self.last = prs, wav, None
        self.orig = (prs.solve_pressure_system, wav.cg_solve_wave_eq)
        self.sig = [inspect.signature(f) for f in self.orig]

    def __enter__(self):
        sps, we = self.orig

        def solve(*a, **kw):
            out = sps(*a, **kw)
            b = self.sig[0].bind(*a, **kw)
            b.apply_defaults()
            self.last = ("pressure", b.arguments, out)
            return out

        def wave(*a, **kw):
            out = we(*a, **kw)
            b = self.sig[1].bind(*a, **kw)
            b.apply_defaults()
            self.last = ("wave", b.arguments, out)
            return out
        self.prs.solve_pressure_system, self.wav.cg_solve_wave_eq = solve, wave
        return self

    def __exit__(self, *exc):
        self.prs.solve_pressure_system, self.wav.cg_solve_wave_eq = self.orig

    def residual(self):
        import torch
        from mantaflow_tpu_torch.core import flags as fl
        if self.last is None:
            return None
        kind, a, out = self.last
        prs = self.prs
        if kind == "pressure":
            p, it, rn = out
            acc, l2 = float(a["cg_accuracy"]), bool(a["use_l2_norm"])
            fluid = fl.is_fluid(a["flags"])
            st64 = tuple(s.double() for s in a["stencil"])
            r = a["rhs"].double() - prs._apply_stencil(p.double(), st64,
                                                       a["dom"], fluid)
            r = torch.where(fluid, r, 0.0)
        else:
            # the wave CG's system, as cg_solve_wave_eq builds it
            from mantaflow_tpu_torch.core.masks import interior_mask
            p, _, it, rn = out
            acc, l2, dom = float(a["cg_accuracy"]), True, a["dom"]
            s = a["dt"] * a["dt"] * a["c_sqr"] * 0.5
            a0, ai, aj, ak = prs.make_laplace_stencil(a["flags"], dom)
            st64 = tuple(x.double() for x in (a0 * s + 1.0, ai * s, aj * s,
                                              ak * s))
            rhs = 2.0 * a["ut"] - a["utm1"]
            if a["crank_nic"]:
                rhs = rhs + s * self.wav.calc_sec_deriv_2d(a["ut"], dom)
            rhs = torch.where(interior_mask(dom, 1, rhs.device), rhs, 0.0)
            r = rhs.double() - prs.apply_laplace(a["flags"], p.double(), st64,
                                                 dom)
        true = float((r * r).sum()) if l2 else float(r.abs().max())
        a0, ai, aj, ak = (s.abs() for s in st64)
        rows = (a0 + ai + aj + ak + prs.shift(ai, -1, "x")
                + prs.shift(aj, -1, "y") + prs.shift(ak, -1, "z"))
        floor = (float(torch.finfo(torch.float32).eps) * float(rows.max())
                 * float(p.abs().max()))
        limit = (1.01 * acc + floor * floor * r.numel()) if l2 else (
            1.01 * acc + floor)
        return {"solve": kind, "accuracy": acc, "l2": l2,
                "iterations": int(it), "exited_on_residual": float(rn) < acc,
                "true_residual": true, "float32_floor": floor,
                "limit": limit}


def scene_counts_check(scene, last, snap):
    """The counts the scene's last printed line reports, against its
    state (the snapshot's ``name.count``)."""
    import re as re_
    for pat, names in SCENE_COUNTS:
        m_ = re_.search(pat, last)
        if m_ is None:
            continue
        for k, name in enumerate(names):
            got = int(snap[f"{name}.count"][1])
            require(got == int(m_[k + 1]), f"{scene}: {name} holds {got}, "
                    f"the last line says {last!r}")


def run_scene_recorded(torch, path, argv, env, device, cut=None,
                       trace_from=None, step_hook=None, on_card=False,
                       watch=None):
    """Run one scene file through the runner on ``device`` in the current
    directory, with ``env`` set and the process statics reset first.
    Solver.step is wrapped: ``on_card``, a CUDA event after each step, and
    from step ``trace_from`` on a torch.profiler trace; at step ``cut`` the
    state's snapshot and the last solve's residual are taken (the run
    stops there unless ``on_card``, where it runs on). ``step_hook(n)``
    runs after step n; ``watch``, a ``SolveWatch`` of the caller's, keeps
    the solves. Returns (globals, record)."""
    import io
    import os
    from mantaflow_tpu_torch.ops import obstacles as obs_
    from mantaflow_tpu_torch.scene import api as sapi
    from mantaflow_tpu_torch.scene import run as srun
    from mantaflow_tpu_torch.scene import snapshot as snp
    from mantaflow_tpu_torch.scene.vortex_api import reset_process_statics

    rec = {"events": [], "steps": 0, "traced_steps": 0}
    orig_step = sapi.Solver.step
    watch = watch or SolveWatch()

    def step(self, frame=-1):
        orig_step(self, frame)
        rec["steps"] += 1
        n = rec["steps"]
        if on_card:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            rec["events"].append(ev)
            if "prof" in rec:
                rec["traced_steps"] += 1
            elif trace_from is not None and n >= trace_from:
                from torch.profiler import ProfilerActivity, profile
                rec["prof"] = profile(activities=[ProfilerActivity.CUDA])
                rec["prof"].__enter__()
                # after the profiler's start, which the first trace of a
                # process pays seconds for
                rec["trace_t0"] = torch.cuda.Event(enable_timing=True)
                rec["trace_t0"].record()
        if step_hook is not None:
            step_hook(n)
        if cut is not None and n == cut:
            g_ = sys._getframe(1).f_globals
            rec["cut_snapshot"] = snp.snapshot(g_)
            rec["cut_residual"] = watch.residual()
            if not on_card:
                raise _SceneCut(g_)

    old_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    reset_process_statics()
    obs_.MovingObstacleState._next_id_bit = 10
    sapi._debug_level[0] = 1
    out = io.StringIO()
    sapi.Solver.step = step
    t0 = time.perf_counter()
    if on_card:
        e0 = torch.cuda.Event(enable_timing=True)
        e0.record()
        rec["events"].append(e0)
    try:
        with watch, contextlib.redirect_stdout(out):
            try:
                g_ = srun.run_scene(path, list(argv), device)
            except _SceneCut as c:
                g_ = c.scene_globals
        if on_card:
            t1 = torch.cuda.Event(enable_timing=True)
            t1.record()
            torch.cuda.synchronize()
            if "prof" in rec:
                rec["prof"].__exit__(None, None, None)
                rec["traced_ms"] = rec["trace_t0"].elapsed_time(t1)
    finally:
        sapi.Solver.step = orig_step
        for k, v in old_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    rec["wall_s"] = time.perf_counter() - t0
    rec["stdout"] = out.getvalue()
    rec["residual"] = watch.residual()
    return g_, rec


def scene_twin_main(args):
    """``python3 chip_smoke.py --scene-twin DIR GROUP``: phase 33's CPU
    twin of one scene group, run in DIR (one torch thread); writes each
    run's snapshot (``snapshot.save``) and a JSON record (residuals, wall
    seconds, last line) there."""
    import os
    import torch
    from mantaflow_tpu_torch.scene import snapshot as snp
    torch.set_num_threads(1)
    out_dir, group = args
    here = os.path.dirname(os.path.abspath(__file__))
    os.chdir(out_dir)
    recs = []
    for i, (scene, argv, env) in enumerate(dict(SCENE_GROUPS)[group]):
        env = {**env, "MANTA_OUT": out_dir}
        g_, r_ = run_scene_recorded(torch, os.path.join(here, "scenes",
                                                        scene),
                                    argv, env, "cpu",
                                    cut=SCENE_CUT.get(scene))
        snap = r_.get("cut_snapshot") or snp.snapshot(g_)
        snp.save(os.path.join(out_dir, f"cpu_{i}.npz"), snap)
        recs.append({"scene": scene, "wall_s": r_["wall_s"],
                     "steps": r_["steps"],
                     "residual": r_.get("cut_residual") or r_["residual"],
                     "last_line": (r_["stdout"].strip().splitlines()
                                   or [""])[-1]})
        del g_
    with open(os.path.join(out_dir, "cpu.json"), "w") as f:
        json.dump(recs, f)


def scenes_phase(torch, dev, h):
    """33. Every scene of SCENE_GROUPS, unedited, through the runner on the
    card: each group in its own directory (MANTA_OUT), the process statics
    reset before each run; every Solver.step timed by CUDA events; K2 and
    K14 launches and K2 iterations counted; every float field finite; the
    last line's counts against the state; each run held against its CPU
    twin (worker processes of this script, run alongside) by the rules of
    ``scene/snapshot.py``: flags, counts and particle flags exact, a
    levelset within 2e-4 of its scale, every other field within 1e-2 of
    max(1, scale) with each device's last solve under its accuracy by its
    true residual (SCENE_KNOWN: fields held by that residual alone); the
    last K2 solves and K14 layers of SCENE_K2_CHECK / SCENE_K14_CHECK
    against their plain versions, timed; then idp_apic02_3d.py at
    IDP_HEAD_RES^3, timed and traced. ``h``: ``every_kernel`` (the kernel
    wrappers by name). Returns (numbers, launches by path, kernel records
    for the kernels line, K2's max abs error)."""
    import concurrent.futures
    import os
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="scenes_")
    t_phase = time.perf_counter()

    # the CPU twins, SCENE_TWIN_WORKERS at a time, beside the card runs
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    dirs = {}
    for group, _ in SCENE_GROUPS:
        dirs[group] = os.path.join(root, group)
        os.makedirs(os.path.join(dirs[group], "cpu"))
        os.makedirs(os.path.join(dirs[group], "card"))

    procs = []

    def twin(group):
        p_ = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--scene-twin",
             os.path.join(dirs[group], "cpu"), group], env=env,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        procs.append(p_)
        _, err_ = p_.communicate(timeout=900)
        return p_.returncode, err_[-3000:]
    pool = concurrent.futures.ThreadPoolExecutor(SCENE_TWIN_WORKERS)
    # the longest twins (their CPU seconds on the H100 machine) first
    order = sorted((g for g, _ in SCENE_GROUPS), key=lambda g: g not in (
        "guiding_3d", "flip03_levelset", "plume_2d", "guiding_2d",
        "plume_adaptDt", "flip02_chain", "simpleplume", "fire"))
    twins = {g: pool.submit(twin, g) for g in order}
    try:
        return _scene_groups(torch, dev, h, twins, dirs, root, t_phase)
    finally:
        # a failed phase leaves no twin running
        pool.shutdown(wait=False, cancel_futures=True)
        for p_ in procs:
            if p_.poll() is None:
                p_.kill()
                p_.wait()
        shutil.rmtree(root, ignore_errors=True)


def _scene_groups(torch, dev, h, twins, dirs, root, t_phase):
    """scenes_phase's card runs, each group held against its twin (the
    future ``twins[group]``), then the headline."""
    import os
    from statistics import median
    from mantaflow_tpu_torch.ops import extrapolation_kernels as xk
    from mantaflow_tpu_torch.ops import pressure as prs
    from mantaflow_tpu_torch.ops import pressure_kernels as prk
    from mantaflow_tpu_torch.scene import snapshot as snp

    here = os.path.dirname(os.path.abspath(__file__))
    numbers, paths, fk, failures = {}, {}, {}, []
    k2_err = 0.0

    kernels = h.every_kernel

    def time_k(kind, kname, calls, fn, plain, nbytes, nops):
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
        print(f"{kind}: {ms * 1e3:.1f} us/launch (bound "
              f"{fk[kind]['bound_ms'] * 1e3:.1f} us, {fk[kind]['bound_by']})"
              f", plain {fk[kind]['plain_ms']:.2f} ms", flush=True)

    def card_run(scene, argv, env_, trace_from=None, keep=False):
        """The card run of one scene with K2's and K14's calls counted (and,
        ``keep``, those of the last step kept)."""
        calls = {"cg_solve": [], "extrap_layer": []}
        last = {}
        iters = torch.zeros((), dtype=torch.int64, device=dev)
        origs = {"cg_solve": (prk, prk.cg_solve),
                 "extrap_layer": (xk, xk.extrap_layer)}
        wrapped = {}
        for name, (mod, orig) in origs.items():
            def fn(*a, _orig=orig, _name=name, **kw):
                if keep:
                    calls[_name].append((a, kw))
                out = _orig(*a, **kw)
                if _name == "cg_solve":
                    iters.add_(out[1])
                return out
            fn.launches = 0
            wrapped[name] = fn
            setattr(mod, name, fn)

        def hook(n):
            if keep:
                last.update({k: list(v) for k, v in calls.items()})
                for v in calls.values():
                    v.clear()
        torch.cuda.synchronize()
        for fn_ in kernels.values():
            fn_.launches = 0
        try:
            g_, r_ = run_scene_recorded(
                torch, os.path.join(here, "scenes", scene), argv, env_, dev,
                cut=SCENE_CUT.get(scene), trace_from=trace_from,
                step_hook=hook, on_card=True)
        finally:
            for name, (mod, orig) in origs.items():
                setattr(mod, name, orig)
        got = {k: getattr(fn_, "launches", 0) for k, fn_ in kernels.items()}
        got.update({k: fn_.launches for k, fn_ in wrapped.items()})
        r_["launches"] = got
        r_["k2_iterations"] = int(iters)
        r_["last_calls"] = last
        ev = r_["events"]
        r_["spans"] = [ev[i - 1].elapsed_time(ev[i])
                       for i in range(1, len(ev))]
        return g_, r_

    def held(scene, card_snap, cpu_snap, card_res, cpu_res):
        """Card against CPU by the phase's rules; returns the record."""
        known = SCENE_KNOWN.get(scene, {})
        cmp_ = snp.compare(card_snap, cpu_snap, 1e-2, limits={
            k: float("inf") if v is None else v for k, v in known.items()})
        bad = snp.failures(cmp_)
        for who, r_ in (("card", card_res), ("cpu", cpu_res)):
            if r_ is not None and r_["exited_on_residual"] and not (
                    r_["true_residual"] < r_["limit"]):
                bad[f"residual_{who}"] = (r_["true_residual"], r_["limit"])
        if bad:
            failures.append(f"{scene} card vs CPU: {bad}")
        # a field held by residual alone has no limit (null)
        return {"max_abs_diff": {k: v[0] for k, v in cmp_.items()},
                "limit": {k: None if v[1] == float("inf") else v[1]
                          for k, v in cmp_.items()},
                "held_by_residual": sorted(k for k, v in known.items()
                                           if v is None),
                "residual_card": card_res, "residual_cpu": cpu_res,
                "beyond": sorted(bad)}

    for group, runs in SCENE_GROUPS:
        gdir = os.path.join(dirs[group], "card")
        cwd = os.getcwd()
        os.chdir(gdir)
        recs = []
        try:
            for scene, argv, env_ in runs:
                keep = scene in SCENE_K2_CHECK or scene in SCENE_K14_CHECK
                g_, r_ = card_run(scene, argv, {**env_, "MANTA_OUT": gdir},
                                  keep=keep)
                snap = snp.snapshot(g_)
                for k, (kind, a) in snap.items():
                    if kind != "exact":
                        require(bool(np.isfinite(a).all()),
                                f"{scene}: {k} not finite")
                last = (r_["stdout"].strip().splitlines() or [""])[-1]
                scene_counts_check(scene, last, snap)
                steps = max(r_["steps"], 1)
                # the first span holds the scene's set-up too
                spans = r_["spans"][1:] or r_["spans"]
                rec = {"scene": scene, "argv": list(argv), "env": env_,
                       "steps": r_["steps"], "frames": {
                           k[:-6]: int(v[1]) for k, v in snap.items()
                           if k.endswith(".frame")},
                       "wall_s": r_["wall_s"],
                       "ms_per_step_median": median(spans) if spans
                       else None,
                       "k2_iterations_per_step": r_["k2_iterations"] / steps,
                       "k2_launches_per_step":
                           r_["launches"]["cg_solve"] / steps,
                       "k14_launches_per_step":
                           r_["launches"]["extrap_layer"] / steps,
                       "last_line": last}
                paths[f"scene_{scene[:-3]}"] = r_["launches"]
                recs.append((rec, r_.get("cut_snapshot") or snap,
                             r_.get("cut_residual") or r_["residual"],
                             r_["last_calls"]))
                del g_, snap
        finally:
            os.chdir(cwd)
        # the kernels against their plain versions on the last calls
        for rec, _, _, last_calls in recs:
            scene = rec["scene"]
            if scene in SCENE_K2_CHECK:
                (args, kw), = last_calls["cg_solve"][-1:]
                dom_ = args[2]
                tracked, _ = tracked_iterations(args[0], args[1], kw["fluid"],
                                                dom_)
                k2_err = max(k2_err, cg_check_by_residual(
                    args[0], args[1], kw["fluid"], args[3], args[4], dom_,
                    early=tracked))
                it = int(prk.cg_solve(*args, **kw)[1])
                n_ = dom_.num_cells
                kind = f"cg_solve_scene_{scene[:-3]}"
                time_k(kind, "cg_kernel<false>", last_calls["cg_solve"][-1:],
                       prk.cg_solve, prs.cg_plain, 6 * 4 * n_,
                       it * 24 * n_)
                fk[kind].update(iterations=it, max_iterations=args[4],
                                us_per_iteration=fk[kind]["ms"] * 1e3
                                / max(it, 1), tracked_iterations=tracked)
                rec["k2_vs_plain"] = fk[kind]
            if scene in SCENE_K14_CHECK:
                layers = last_calls["extrap_layer"]
                require(layers, f"{scene}: no K14 layer in the last step")
                for args, kw in layers:
                    a_ = xk.extrap_layer(*args, **kw)
                    b_ = xk.extrap_layer_plain(*args, **kw)
                    for x_, y_ in zip(a_[0] + a_[1], b_[0] + b_[1]):
                        require(torch.equal(x_, y_),
                                f"{scene}: extrap_layer differs from plain")
                n_ = args[2].num_cells
                pairs = sum(len(a[0]) for a, _ in layers) / len(layers)
                kind = f"extrap_layer_scene_{scene[:-3]}"
                time_k(kind, "extrap_layer_kernel<true>", layers,
                       xk.extrap_layer, xk.extrap_layer_plain,
                       pairs * 16 * n_, pairs * 20 * n_)
                fk[kind]["layers_last_step"] = len(layers)
                rec["k14_vs_plain"] = fk[kind]
        # the CPU twin, then card against CPU
        rc, err = twins[group].result()
        require(rc == 0, f"{group}: the CPU twin failed: {err}")
        with open(os.path.join(dirs[group], "cpu", "cpu.json")) as f:
            cpu_recs = json.load(f)
        out = []
        for i, ((rec, card_snap, card_res, _), crec) in enumerate(
                zip(recs, cpu_recs)):
            cpu_snap = snp.load(os.path.join(dirs[group], "cpu",
                                             f"cpu_{i}.npz"))
            rec["cpu_wall_s"] = crec["wall_s"]
            rec["card_vs_cpu"] = held(rec["scene"], card_snap, cpu_snap,
                                      card_res, crec["residual"])
            if rec["scene"] in SCENE_CUT:
                rec["card_vs_cpu"]["steps_compared"] = SCENE_CUT[rec["scene"]]
            out.append(rec)
        numbers[group] = out
        print(json.dumps({"scene_group": group, "runs": out}), flush=True)
        del recs

    # the headline: idp_apic02_3d.py at IDP_HEAD_RES^3, the last 3 steps
    # traced
    gdir = os.path.join(root, "idp_head")
    os.makedirs(gdir)
    cwd = os.getcwd()
    os.chdir(gdir)
    try:
        g_, r_ = card_run("idp_apic02_3d.py",
                          (str(IDP_HEAD_FRAMES), str(IDP_HEAD_RES)),
                          {"MANTA_OUT": gdir},
                          trace_from=IDP_HEAD_FRAMES - 3)
        snap = snp.snapshot(g_)
    finally:
        os.chdir(cwd)
    for k, (kind, a) in snap.items():
        if kind != "exact":
            require(bool(np.isfinite(a).all()), f"IDP head: {k} not finite")
    last = r_["stdout"].strip().splitlines()[-1]
    scene_counts_check("idp_apic02_3d.py", last, snap)
    busy_us, dev_count = 0.0, 0
    for e in r_["prof"].key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us > 0:
            busy_us += us
            dev_count += e.count
    nt = max(r_["traced_steps"], 1)
    busy = busy_us / 1e3 / nt
    require(busy > 0, "IDP head: the trace holds no device time")
    traced = r_["traced_ms"] / nt
    steps = r_["steps"]
    # a step: the pressure solve through K2 (the IDP density solve runs
    # cg_loop), extrapolateMACFromWeight's 2 layers and
    # extrapolateMACSimple's 5
    require(r_["launches"]["cg_solve"] == steps
            and r_["launches"]["extrap_layer"] == 7 * steps,
            f"IDP head: {r_['launches']} launches in {steps} steps")
    head = {"res": IDP_HEAD_RES, "frames": IDP_HEAD_FRAMES, "steps": steps,
            "wall_s": r_["wall_s"],
            "ms_per_step_median_last10": median(r_["spans"][-10:]),
            "ms_per_step_all": r_["spans"],
            "k2_iterations_per_step": r_["k2_iterations"] / steps,
            "k2_launches_per_step": r_["launches"]["cg_solve"] / steps,
            "k14_launches_per_step": r_["launches"]["extrap_layer"] / steps,
            "traced_steps": r_["traced_steps"],
            "traced_wall_ms_per_step": traced,
            "device_busy_ms_per_step": busy,
            "device_launches_per_step": dev_count / nt,
            "idle_share_traced": 1.0 - busy / traced,
            "particles": int(snap["pp.count"][1]), "last_line": last,
            "residual": r_["residual"]}
    paths[f"scene_idp_apic02_3d_{IDP_HEAD_RES}"] = r_["launches"]
    numbers[f"idp_apic02_3d_{IDP_HEAD_RES}"] = head
    print(f"idp_apic02_3d {IDP_HEAD_RES}^3 x {IDP_HEAD_FRAMES}: {steps} "
          f"steps in {r_['wall_s']:.1f} s, "
          f"{head['ms_per_step_median_last10']:.1f} ms/step (median of the "
          f"last 10), K2 {head['k2_iterations_per_step']:.0f} it/step; "
          f"traced {traced:.1f} ms/step, busy {busy:.1f}, "
          f"{dev_count / nt:.0f} launches a step, idle "
          f"{100 * head['idle_share_traced']:.1f} %", flush=True)
    del g_, snap, r_
    torch.cuda.empty_cache()
    numbers["phase_s"] = time.perf_counter() - t_phase
    require(not failures, "; ".join(failures))
    return numbers, paths, fk, k2_err


#: phase 34: the fork's own experiment, scenes/zflip.py (FLIP, FIXED_VOL,
#: CORRECT19) driven by scenes/run.py, unedited, on the card
ZFLIP_METHODS = {0: "flip", 1: "fixed_vol", 2: "correct19"}
ZFLIP_RUN_ARGV = ("20", "32", "1", "1")  # run.py's own defaults
ZFLIP_STATIC_ARGV = ("20", "32", "2", "0")
ZFLIP_HEAD_RES = 128  # the dam at 8 particles a cell: ~4.0 M particles
ZFLIP_HEAD_FRAMES = 20
ZFLIP_HEAD_METHODS = (0, 2)
ZFLIP_FIXED_RES = 64  # FIXED_VOL's host redistribution, timed
ZFLIP_FIXED_FRAMES = 10
ZFLIP_ACC = 1e-3  # the accuracy of every solve of zflip.py
ZFLIP_TWIN_WORKERS = 6
ZFLIP_EARLY = 4  # the in-process runs are also held after this many steps
ZFLIP_MARGIN = 1.5
#: Per configuration of the phase (``run_M``: run.py's child of method M,
#: ``static_M``: zflip.py M 20 32 2 0), the fields of run_zflip's locals
#: and the meshes (``surface_*``: any frame's) in which the card's run
#: parts from its CPU twin beyond snapshot.compare's rules, each with the
#: largest difference that tools/scene_cg_sensitivity.py --locals run_zflip
#: measured between the port and itself on the CPU, the same argv, with
#: every solve's accuracy x 0.5, 0.7 and 0.85 (ROADMAP C). Each must still
#: part, by no more than ZFLIP_MARGIN x its number; a ``nodes`` entry of
#: None parts only where the mesh's triangle count does (the nodes are then
#: unmatched). ``occ`` is the last frame's ``volumes`` entry and is held at
#: the list's number. Any other field is held by the rules.
ZFLIP_KNOWN = {
    "run_0": {"flags": 3, "gpi": 2, "ii": 1, "jj": 1, "mgen.gpi": 3,
              "mgen.mesh.nodes": 18, "mgen.phi": 0.2425,
              "mgen.phiParts": 0.2425, "occ": 3, "phi": 0.2092,
              "phiParts": 0.2092, "surface_*.count": 12,
              "surface_*.nodes": 0.5781, "volumes": 3},
    "run_1": {"flags": 3, "gpi": 9, "ii": 10, "jj": 6, "kk": 6,
              "mapWeights": 3, "mgen.gpi": 15, "mgen.mesh.count": 72,
              "mgen.mesh.nodes": None, "mgen.phi": 1.792,
              "mgen.phiParts": 1.792, "obs.flags": 3, "pVel": 0.1327,
              "phi": 1, "phiParts": 1.149, "pos": 10.43, "pp.pos": 10.43,
              "pressure": 0.01031, "surface_*.count": 120,
              "surface_*.nodes": 0.9688, "vel": 0.3651, "velOld": 0.227,
              "volumes": 9},
    "run_2": {"flags": 3, "gpi": 3, "ii": 1, "jj": 1, "mapWeights": 3,
              "mgen.gpi": 2, "mgen.mesh.nodes": 18, "mgen.phi": 0.3919,
              "mgen.phiParts": 0.3919, "obs.flags": 3, "occ": 19,
              "pVel": 0.01617, "phi": 0.2306, "phiParts": 0.2306,
              "pos": 0.03391, "pp.pos": 0.03391, "pressure": 0.01482,
              "surface_*.count": 8, "surface_*.nodes": 0.9688,
              "vel": 0.2777, "velOld": 0.1729, "volumes": 19},
    "static_0": {"flags": 3, "gpi": 3, "ii": 1, "jj": 1, "mapWeights": 3,
                 "occ": 4, "phi": 0.2056, "phiParts": 0.2056,
                 "velOld": 0.04836, "volumes": 4},
    "static_1": {"gpi": 10, "ii": 10, "jj": 6, "kk": 4, "mapWeights": 3,
                 "obs.flags": 3, "pVel": 0.1324, "phiParts": 0.8674,
                 "pos": 10.43, "pp.pos": 10.43, "pressure": 0.01022,
                 "vel": 0.3646, "velOld": 0.2267, "volumes": 5},
    "static_2": {"flags": 3, "gpi": 5, "ii": 1, "jj": 1, "mapWeights": 3,
                 "obs.flags": 3, "occ": 19, "pVel": 0.002036,
                 "phi": 0.2328, "phiParts": 0.2328, "pos": 0.04006,
                 "pp.pos": 0.04006, "pressure": 0.001319, "vel": 0.1904,
                 "velOld": 0.1773, "volumes": 19},
}
#: the same after ZFLIP_EARLY steps of the in-process runs (the tool's
#: ``--steps 4``): in CORRECT19 a near-zero phi flips sign within the
#: first steps, and FLIP's particle levelset moves by a few 1e-4
ZFLIP_KNOWN_EARLY = {
    "static_0": {"phiParts": 3.935e-4},
    "static_1": {},
    "static_2": {"flags": 3, "gpi": 1, "phi": 0.2129, "phiParts": 0.2129},
}


def _zflip_group(key):
    """A snapshot key's entry in ZFLIP_KNOWN (a mesh file's under
    ``surface_*``)."""
    m = re.match(r"surface_\d+\.bobj\.gz\.(count|nodes)$", key)
    return f"surface_*.{m.group(1)}" if m else key


def _zflip_run_frame():
    """The frame of the running scenes/zflip.py's ``run_zflip``."""
    f = sys._getframe(1)
    while f is not None and f.f_code.co_name != "run_zflip":
        f = f.f_back
    return f


def zflip_twin_main(args):
    """``python3 chip_smoke.py --zflip-twin DIR M FRAMES RES OBS MESH``:
    phase 34's CPU twin of one zflip.py run in DIR (one torch thread):
    writes the snapshot of ``run_zflip``'s locals and the meshes at the end
    (``cpu.npz``) and after ZFLIP_EARLY steps (``cpu_early.npz``), and a
    JSON record (the last solve's residual, the printed lines, seconds)."""
    import os
    import torch
    from mantaflow_tpu_torch.scene import snapshot as snp
    torch.set_num_threads(1)
    out_dir, argv = args[0], args[1:]
    here = os.path.dirname(os.path.abspath(__file__))
    os.chdir(out_dir)
    path = os.path.join(here, "scenes", "zflip.py")
    early, watch = {}, SolveWatch()

    def hook(n):
        if n == ZFLIP_EARLY:
            early.update(snp.snapshot(dict(_zflip_run_frame().f_locals),
                                      members=True))
            early_res.append(watch.residual())
    early_res = []
    with snp.returned_locals("run_zflip", path) as loc:
        _, r_ = run_scene_recorded(torch, path, argv, {}, "cpu",
                                   step_hook=hook, watch=watch)
    snap = {**snp.snapshot(loc, members=True), **snp.meshes(out_dir)}
    snp.save(os.path.join(out_dir, "cpu.npz"), snap)
    snp.save(os.path.join(out_dir, "cpu_early.npz"), early)
    with open(os.path.join(out_dir, "cpu.json"), "w") as f:
        json.dump({"argv": argv, "wall_s": r_["wall_s"],
                   "residual": r_["residual"],
                   "residual_early": (early_res or [None])[0],
                   "lines": _zflip_lines(r_["stdout"])}, f)


def zflip_child_main(args):
    """``python3 chip_smoke.py --zflip-child [--device cpu] SCENE ARGS``:
    one child of scenes/run.py in phase 34, which hands run.py this in
    place of the runner's launcher. The scene runs as the launcher runs it
    (``scene.run.main``: on the card unless ``--device cpu``, raising
    without a GPU, and with no JAX loaded); the locals of ``run_zflip`` as
    it returns go to ``locals_run_zflip.npz`` and the last solve's residual
    (``SolveWatch``) to ``child.json`` in the working directory."""
    import os
    from mantaflow_tpu_torch.scene import run as srun
    from mantaflow_tpu_torch.scene import snapshot as snp
    path = args[2] if args[:1] == ["--device"] else args[0]
    watch = SolveWatch()
    with watch, snp.returned_locals("run_zflip", path) as loc:
        srun.main(args)
    snp.save("locals_run_zflip.npz", snp.snapshot(loc, members=True))
    with open("child.json", "w") as f:
        json.dump({"residual": watch.residual()}, f)


def zflip_child_launcher(dev, out_dir):
    """An executable in ``out_dir`` that runs its arguments as
    ``zflip_child_main`` on ``dev``, with the repo on PYTHONPATH."""
    import os
    import shlex
    here = os.path.dirname(os.path.abspath(__file__))
    flag = " --device cpu" if dev.type == "cpu" else ""
    path = os.path.join(out_dir, "python-zflip-child")
    with open(path, "w") as f:
        f.write("#!/bin/sh\n"
                f"PYTHONPATH={shlex.quote(here)}${{PYTHONPATH:+:$PYTHONPATH}}"
                "\nexport PYTHONPATH\n"
                f"exec {shlex.quote(sys.executable)} "
                f"{shlex.quote(os.path.abspath(__file__))} --zflip-child"
                f"{flag} \"$@\"\n")
    os.chmod(path, 0o755)
    return path


def _zflip_lines(text):
    return [ln for ln in text.splitlines()
            if re.match(r"^(it \d+:|zflip method=)", ln)]


def zflip_phase(torch, dev, h):
    """34. scenes/zflip.py, the fork's volume-preserving FLIP experiment,
    unedited on the card through the runner: scenes/run.py <tmp> 20 32 1 1
    (its own defaults: the three methods as children, started through
    ``zflip_child_launcher``, which runs them as the runner's launcher
    does and keeps their locals and last residual, each with the moving
    obstacle and the 64^3 mesh every frame); zflip.py M 20 32 2 0 (the
    static obstacle) for each method in this process, also held after
    ZFLIP_EARLY steps; each run held against a CPU twin of the same file
    and argv (``--zflip-twin`` worker processes, run alongside) by
    ``scene/snapshot.py``'s rules on ``run_zflip``'s locals and the meshes
    (flags, particle flags, counts and volumes exact, a levelset within
    2e-4 of its scale, fields within ZFLIP_ACC x max(1, scale)), but for
    ZFLIP_KNOWN's (ZFLIP_KNOWN_EARLY's) fields of that configuration, which
    must part within their bounds, each device's last solve then meeting
    its accuracy by its true residual; then
    FLIP and CORRECT19 at ZFLIP_HEAD_RES^3 (moving obstacle, no mesh): the
    scene step by CUDA events, K2 and K14 launches and K2 iterations a
    step, the scene's host reads, 3 steps traced, a constant particle
    count; and FIXED_VOL at ZFLIP_FIXED_RES^3, its host redistribution
    timed a frame. Returns (numbers, launches by path)."""
    import concurrent.futures
    import io
    import os
    import shutil
    import tempfile
    from statistics import median
    import mantaflow_tpu_torch as port
    from mantaflow_tpu_torch.ops import pressure_kernels as prk
    from mantaflow_tpu_torch.scene import run as srun
    from mantaflow_tpu_torch.scene import snapshot as snp

    here = os.path.dirname(os.path.abspath(__file__))
    zflip = os.path.join(here, "scenes", "zflip.py")
    kernels = h.every_kernel
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="zflip_")
    numbers, paths, failures = {}, {}, []

    # the CPU twins, beside the card runs
    twin_argv = {**{f"run_{m}": (str(m),) + ZFLIP_RUN_ARGV
                    for m in ZFLIP_METHODS},
                 **{f"static_{m}": (str(m),) + ZFLIP_STATIC_ARGV
                    for m in ZFLIP_METHODS}}
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    procs = []

    def twin(name):
        d = os.path.join(root, "cpu", name)
        os.makedirs(d)
        p_ = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--zflip-twin", d,
             *twin_argv[name]], env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True)
        procs.append(p_)
        _, err_ = p_.communicate(timeout=900)
        return p_.returncode, err_[-3000:], d
    pool = concurrent.futures.ThreadPoolExecutor(ZFLIP_TWIN_WORKERS)
    twins = {name: pool.submit(twin, name) for name in twin_argv}

    def held(name, card, cpu, known, card_res, cpu_res):
        """The card's snapshot against the twin's: the record. Beyond the
        rules only ``known``'s fields may part, each by no more than
        ZFLIP_MARGIN x its number, and each must still part; where any
        parts, each device's last solve must meet its accuracy by its true
        residual."""
        cmp_ = snp.compare(card, cpu, ZFLIP_ACC)
        bad = snp.failures(cmp_)
        parted, beyond = {}, []
        for k, (d, _) in bad.items():
            g = _zflip_group(k)
            if g not in known:
                beyond.append(k)
            elif d == float("inf"):
                # a mesh's nodes, unmatched where its triangle count parts
                if not (k.endswith(".nodes")
                        and f"{k[:-len('nodes')]}count" in bad):
                    beyond.append(k)
                parted.setdefault(g, None)
            elif known[g] is None or d > ZFLIP_MARGIN * known[g]:
                beyond.append(k)
            else:
                parted[g] = max(parted.get(g) or 0.0, d)
        still = sorted(set(known) - set(parted))
        for who, r_ in (("card", card_res), ("cpu", cpu_res)):
            if parted and not (r_ is not None
                               and r_["true_residual"] < r_["limit"]):
                beyond.append(f"residual_{who}")
        if beyond or still:
            failures.append(
                f"{name}: {sorted(beyond)} beyond the rules and the known "
                f"bounds ({ {k: bad[k] for k in bad if k in beyond} }); "
                f"known but no longer parting: {still}")
        worst = max((k for k in cmp_ if k not in bad),
                    key=lambda k: cmp_[k][0] / max(cmp_[k][1], 1e-30),
                    default=None)
        return {"largest_within_rule": None if worst is None else
                [worst, *cmp_[worst]],
                "known_parted": parted, "beyond": beyond,
                "known_not_parting": still, "residual_card": card_res,
                "residual_cpu": cpu_res}

    def twin_result(name):
        rc, err_, d = twins[name].result()
        require(rc == 0, f"zflip twin {name} failed: {err_}")
        with open(os.path.join(d, "cpu.json")) as f:
            rec = json.load(f)
        return (snp.load(os.path.join(d, "cpu.npz")),
                snp.load(os.path.join(d, "cpu_early.npz")), rec)

    def reset():
        torch.cuda.synchronize()
        for fn in kernels.values():
            fn.launches = 0

    def counts():
        torch.cuda.synchronize()
        return {k: fn.launches for k, fn in kernels.items()}

    cwd = os.getcwd()
    try:
        # -- scenes/run.py at its own defaults ------------------------------
        out_root = os.path.join(root, "card", "run_py")
        os.makedirs(out_root)
        os.chdir(root)
        # run.py's sys.executable: the runner's launcher's run, which also
        # writes each child's locals and last residual
        launcher = zflip_child_launcher(dev, root)
        orig_launcher = srun.launcher
        srun.launcher = lambda device: launcher
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(io.StringIO()) as out:
                srun.run_scene(os.path.join(here, "scenes", "run.py"),
                               [out_root, *ZFLIP_RUN_ARGV], dev)
        finally:
            srun.launcher = orig_launcher
        run_s = time.perf_counter() - t0
        text = out.getvalue()
        require("run.py is done" in text, f"run.py: {text[-2000:]}")
        starts = [ln for ln in text.splitlines() if ln.startswith(launcher)]
        require(len(starts) == 3, f"run.py started {starts}")
        frames = int(ZFLIP_RUN_ARGV[0])
        runs = {}
        for m, name in ZFLIP_METHODS.items():
            d = os.path.join(out_root, f"{m}_{name}")
            with open(os.path.join(d, "_log.txt")) as f:
                log = f.read()
            lines = _zflip_lines(log)
            require(lines and lines[-1].startswith(f"zflip method={m} "),
                    f"run.py child {m}: log ends {log[-300:]!r}")
            meshes = snp.meshes(d)
            require(len(meshes) == 2 * frames,
                    f"run.py child {m}: {len(meshes) // 2} meshes")
            card = {**snp.load(os.path.join(d, "locals_run_zflip.npz")),
                    **meshes}
            require(len(card["volumes"][1]) == frames
                    and int(card["pp.count"][1]) == int(card["n0"][1]),
                    f"run.py child {m}: particles or volumes")
            with open(os.path.join(d, "child.json")) as f:
                card_res = json.load(f)["residual"]
            cpu, _, crec = twin_result(f"run_{m}")
            rec = {"argv": [str(m), *ZFLIP_RUN_ARGV], "lines": lines,
                   "cpu_lines": crec["lines"],
                   "particles": int(card["pp.count"][1]),
                   "volumes": [int(v) for v in card["volumes"][1]],
                   "cpu_volumes": [int(v) for v in cpu["volumes"][1]],
                   "mesh_tris_last": int(card[
                       f"surface_{frames - 1:04d}.bobj.gz.count"][1]),
                   "cpu_wall_s": crec["wall_s"],
                   "card_vs_cpu": held(f"run.py child {m}", card, cpu,
                                       ZFLIP_KNOWN[f"run_{m}"], card_res,
                                       crec["residual"])}
            runs[name] = rec
        numbers["run_py"] = {"argv": list(ZFLIP_RUN_ARGV), "wall_s": run_s,
                             "children": runs}
        print(json.dumps({"zflip_run_py": numbers["run_py"]}), flush=True)

        # -- zflip.py with the static obstacle, in this process ------------
        static = {}
        for m, name in ZFLIP_METHODS.items():
            d = os.path.join(root, "card", f"static_{m}")
            os.makedirs(d)
            os.chdir(d)
            early, early_res, watch = {}, [], SolveWatch()

            def hook(n):
                if n == ZFLIP_EARLY:
                    early.update(snp.snapshot(
                        dict(_zflip_run_frame().f_locals), members=True))
                    early_res.append(watch.residual())
            reset()
            with snp.returned_locals("run_zflip", zflip) as loc:
                _, r_ = run_scene_recorded(
                    torch, zflip, (str(m),) + ZFLIP_STATIC_ARGV, {}, dev,
                    step_hook=hook, on_card=True, watch=watch)
            got = counts()
            paths[f"zflip_static_{name}"] = got
            card = snp.snapshot(loc, members=True)
            for k, (kind, a) in card.items():
                if kind != "exact":
                    require(bool(np.isfinite(a).all()),
                            f"zflip static {m}: {k} not finite")
            cpu, cpu_early, crec = twin_result(f"static_{m}")
            ev = r_["events"]
            spans = [ev[i - 1].elapsed_time(ev[i]) for i in range(2, len(ev))]
            static[name] = {
                "argv": [str(m), *ZFLIP_STATIC_ARGV],
                "lines": _zflip_lines(r_["stdout"]),
                "cpu_lines": crec["lines"],
                "wall_s": r_["wall_s"], "cpu_wall_s": crec["wall_s"],
                "ms_per_step_median": median(spans),
                "k2_launches_per_step": got["cg_solve"] / r_["steps"],
                "k14_launches_per_step": got["extrap_layer"] / r_["steps"],
                "card_vs_cpu_early": held(
                    f"static {m} after {ZFLIP_EARLY} steps", early,
                    cpu_early, ZFLIP_KNOWN_EARLY[f"static_{m}"],
                    early_res[0], crec["residual_early"]),
                "card_vs_cpu": held(f"static {m}", card, cpu,
                                    ZFLIP_KNOWN[f"static_{m}"],
                                    r_["residual"], crec["residual"])}
            require(int(card["pp.count"][1]) == int(card["n0"][1]),
                    f"zflip static {m}: particles lost")
            del loc, card
        numbers["static"] = static
        print(json.dumps({"zflip_static": static}), flush=True)

        # -- FLIP and CORRECT19 at ZFLIP_HEAD_RES^3 -------------------------
        host = {"asarray": 0.0, "unique": 0.0, "pos0": 0.0, "dt_limit": 0.0}

        def timed_host(key, fn):
            def run(*a, **kw):
                torch.cuda.synchronize()
                t0_ = time.perf_counter()
                out_ = fn(*a, **kw)
                host[key] += time.perf_counter() - t0_
                return out_
            return staticmethod(run) if key in ("asarray", "unique") \
                else run
        scene_np = srun._SceneNumpy
        orig_asarray = scene_np.__dict__["asarray"]
        orig_pos0 = port.set_particles_pos0
        orig_dt = port.limit_time_step_to_one_cell_movement
        head = {}
        for m in ZFLIP_HEAD_METHODS:
            name = ZFLIP_METHODS[m]
            d = os.path.join(root, "card", f"head_{m}")
            os.makedirs(d)
            os.chdir(d)
            for k in host:
                host[k] = 0.0
            iters = torch.zeros((), dtype=torch.int64, device=dev)
            cg = prk.cg_solve

            def cg_counted(*a, **kw):
                out_ = cg(*a, **kw)
                iters.add_(out_[1])
                return out_
            cg_counted.launches = 0
            scene_np.asarray = timed_host("asarray", orig_asarray.__func__)
            scene_np.unique = timed_host("unique", np.unique)
            port.set_particles_pos0 = timed_host("pos0", orig_pos0)
            port.limit_time_step_to_one_cell_movement = timed_host(
                "dt_limit", orig_dt)
            prk.cg_solve = cg_counted
            reset()
            try:
                with snp.returned_locals("run_zflip", zflip) as loc:
                    _, r_ = run_scene_recorded(
                        torch, zflip,
                        (str(m), str(ZFLIP_HEAD_FRAMES), str(ZFLIP_HEAD_RES),
                         "1", "0"), {}, dev,
                        trace_from=ZFLIP_HEAD_FRAMES - 3, on_card=True)
            finally:
                scene_np.asarray = orig_asarray
                del scene_np.unique
                port.set_particles_pos0 = orig_pos0
                port.limit_time_step_to_one_cell_movement = orig_dt
                prk.cg_solve = cg
            got = counts()
            got["cg_solve"] = cg_counted.launches
            paths[f"zflip_{name}_{ZFLIP_HEAD_RES}"] = got
            steps = r_["steps"]
            snap = snp.snapshot(loc, members=True)
            for k, (kind, a) in snap.items():
                if kind != "exact":
                    require(bool(np.isfinite(a).all()),
                            f"zflip {name} {ZFLIP_HEAD_RES}: {k} not finite")
            n0, n = int(snap["n0"][1]), int(snap["pp.count"][1])
            lines = _zflip_lines(r_["stdout"])
            parts_printed = [int(x) for ln in lines
                             for x in re.findall(r"parts=(\d+)", ln)]
            require(n == n0 and all(p == n0 for p in parts_printed)
                    and len(parts_printed) == ZFLIP_HEAD_FRAMES // 10,
                    f"zflip {name} {ZFLIP_HEAD_RES}: {n0} particles, "
                    f"{n} at the end, printed {parts_printed}")
            require(got["cg_solve"] == steps and got["extrap_layer"] > 0,
                    f"zflip {name} {ZFLIP_HEAD_RES}: {got} in {steps} steps")
            busy_us, dev_count = 0.0, 0
            for e in r_["prof"].key_averages():
                us = getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0))
                if us > 0:
                    busy_us += us
                    dev_count += e.count
            nt = max(r_["traced_steps"], 1)
            busy = busy_us / 1e3 / nt
            require(busy > 0, f"zflip {name}: the trace holds no device time")
            traced = r_["traced_ms"] / nt
            ev = r_["events"]
            spans = [ev[i - 1].elapsed_time(ev[i]) for i in range(1, len(ev))]
            med = median(spans[-10:])
            host_ms = {k: 1e3 * v / steps for k, v in host.items()}
            head[name] = {
                "argv": [str(m), str(ZFLIP_HEAD_FRAMES), str(ZFLIP_HEAD_RES),
                         "1", "0"],
                "particles": n0, "steps": steps, "wall_s": r_["wall_s"],
                "ms_per_step_median_last10": med, "ms_per_step_all": spans,
                "k2_launches_per_step": got["cg_solve"] / steps,
                "k2_iterations_per_step": int(iters) / steps,
                "k14_launches_per_step": got["extrap_layer"] / steps,
                "host_ms_per_step": host_ms,
                "occupancy_read_share": (host_ms["asarray"]
                                         + host_ms["unique"]) / med,
                "traced_steps": r_["traced_steps"],
                "traced_wall_ms_per_step": traced,
                "device_busy_ms_per_step": busy,
                "device_launches_per_step": dev_count / nt,
                "idle_share_traced": 1.0 - busy / traced,
                "lines": lines, "residual": r_["residual"]}
            print(f"zflip {name} {ZFLIP_HEAD_RES}^3: {n0} particles, "
                  f"{med:.1f} ms/step (median of the last 10), K2 "
                  f"{head[name]['k2_iterations_per_step']:.0f} it/step, K14 "
                  f"{head[name]['k14_launches_per_step']:.1f} a step; host "
                  f"reads {host_ms}; traced {traced:.1f} ms/step, busy "
                  f"{busy:.1f}, idle {100 * (1 - busy / traced):.1f} %",
                  flush=True)
            del loc, snap, r_
            torch.cuda.empty_cache()
        numbers[f"head_{ZFLIP_HEAD_RES}"] = head

        # -- FIXED_VOL at ZFLIP_FIXED_RES^3: its host redistribution -------
        d = os.path.join(root, "card", "fixed_vol")
        os.makedirs(d)
        os.chdir(d)
        fv_s = []
        orig_fv = port.fixed_volume_advection

        def fv_timed(*a, **kw):
            torch.cuda.synchronize()
            t0_ = time.perf_counter()
            out_ = orig_fv(*a, **kw)
            torch.cuda.synchronize()
            fv_s.append(time.perf_counter() - t0_)
            return out_
        port.fixed_volume_advection = fv_timed
        reset()
        try:
            _, r_ = run_scene_recorded(
                torch, zflip, ("1", str(ZFLIP_FIXED_FRAMES),
                               str(ZFLIP_FIXED_RES), "1", "0"), {}, dev,
                on_card=True)
        finally:
            port.fixed_volume_advection = orig_fv
        paths[f"zflip_fixed_vol_{ZFLIP_FIXED_RES}"] = counts()
        ev = r_["events"]
        spans = [ev[i - 1].elapsed_time(ev[i]) for i in range(1, len(ev))]
        require(len(fv_s) == ZFLIP_FIXED_FRAMES, f"FIXED_VOL ran {fv_s}")
        numbers[f"fixed_vol_{ZFLIP_FIXED_RES}"] = {
            "argv": ["1", str(ZFLIP_FIXED_FRAMES), str(ZFLIP_FIXED_RES), "1",
                     "0"],
            "redistribution_host_s_per_frame": fv_s,
            "ms_per_step": spans, "lines": _zflip_lines(r_["stdout"])}
        print(f"FIXED_VOL {ZFLIP_FIXED_RES}^3: the redistribution "
              f"{fv_s} s a frame, scene steps {spans} ms", flush=True)
    finally:
        os.chdir(cwd)
        pool.shutdown(wait=False, cancel_futures=True)
        for p_ in procs:
            if p_.poll() is None:
                p_.kill()
                p_.wait()
        shutil.rmtree(root, ignore_errors=True)
    numbers["phase_s"] = time.perf_counter() - t_phase
    require(not failures, "; ".join(failures))
    return numbers, paths


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
    import torch
    from mantaflow_tpu_torch.ops import pressure as prs
    from mantaflow_tpu_torch.ops import pressure_kernels as prk
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


def tracked_iterations(rhs, stencil, fluid, dom_, most=10):
    """How many CG iterations from zero (up to ``most``) the plain
    float32 CG stays within rel 1e-6 of the float64 CG on this system,
    and their distance at the first iteration past that: beyond it the
    system amplifies float32 rounding (a ghost-fluid diagonal grows
    like 1 / the clamped fraction), so two float32 CGs that sum in
    another order part there too, and cg_check_by_residual holds K2 to
    cg_plain over these iterations only."""
    import torch
    from mantaflow_tpu_torch.ops import pressure as prs
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


#: phase 35: the exact-gather plume at the benchmark cell's grid
#: (benchmark/configs/plume112.json: the scene's values, walls on every
#: side, the cylinder source without the noise), EXACT_STEPS steps to
#: develop it
EXACT_RES = (112, 168, 112)
EXACT_STEPS = 40
EXACT_CELLS = EXACT_RES[0] * EXACT_RES[1] * EXACT_RES[2]
#: the least time of one plume step's advection at EXACT_RES: 36 bytes a
#: cell (benchmark/roofline/advection.py) at HBM_BYTES_PER_S
EXACT_BOUND_US = 36 * EXACT_CELLS / HBM_BYTES_PER_S * 1e6
#: the exact kernels' launches in a smoke step of order 2 (a scalar grid:
#: forward and backward; the MAC grid: both and the outflow pass)
EXACT_PER_STEP = {"advect_exact_fwd": 2, "advect_exact_bwd": 2,
                  "advect_exact_outflow": 1}
#: each launch's least bytes a cell on the plume step's inputs: every grid
#: it reads once (flags 4, a scalar 4, a MAC or velocity grid 12; the MAC
#: grid advected is the velocity itself, read once) and its output written
#: once; the outflow pass reads the grid before the advection only at
#: outflow cells, none with the walls
EXACT_BYTES_PER_CELL = {
    "advect_exact_fwd<false>": 12 + 4 + 4,
    "advect_exact_fwd<true>": 12 + 12,
    "advect_exact_bwd<false>": 4 + 12 + 4 + 4 + 4,
    "advect_exact_bwd<true>": 4 + 12 + 12 + 12,
    "advect_exact_outflow": 4 + 12 + 12}


def exact_advect_phase(torch, dev, h):
    """Phase 35: the exact-gather advection's passes (csrc/advect_exact.cu)
    on a developed plume at EXACT_RES. 1 warm step, EXACT_STEPS timed
    (CUDA events): 2 forward, 2 backward and 1 outflow launch a step, every
    driver call counted ``advection.exact_kernel``; one developed step's
    two driver calls against their plain versions (advect_real_plain,
    advect_mac_plain) bit for bit, every cell, with the cell's walls and
    with open "yY" bounds (outflow cells); each kernel's time on those
    inputs against its own least bytes (EXACT_BYTES_PER_CELL), with the
    largest error of the driver calls that launch it; the five launches'
    against the advection's (EXACT_BOUND_US) and the plain versions' ms;
    the exact smoke at 32^3 over 4 z-slabs against one device (1e-5, CG
    iterations within 2), every shard's two calls a step on the kernels
    (the slabs are views) with their launches. ``h``: ``every_kernel``.
    Returns (numbers, the kernels' timings by name)."""
    import dataclasses as dc
    from mantaflow_tpu_torch.core import flags as fl_
    from mantaflow_tpu_torch.core.domain import Domain
    from mantaflow_tpu_torch.core.shapes import Cylinder
    from mantaflow_tpu_torch.models import smoke
    from mantaflow_tpu_torch.ops import advection as adv
    from mantaflow_tpu_torch.ops import advection_exact_kernels as advx
    from mantaflow_tpu_torch.parallel import sharding as shd
    from mantaflow_tpu_torch.utils import trace

    kernels = {k: h.every_kernel[k] for k in EXACT_PER_STEP}
    numbers = {}

    def counted():
        torch.cuda.synchronize()
        c = trace.counters()
        return ({k: fn.launches for k, fn in kernels.items()},
                c.get("advection.exact_kernel", 0),
                c.get("advection.exact_plain", 0))

    def since(before):
        after = counted()
        return ({k: after[0][k] - before[0][k] for k in kernels},
                after[1] - before[1], after[2] - before[2])

    def plume(res, params_):
        sx, sy, sz = res
        dom_ = Domain(size=res, dim=3)
        return dom_, smoke.make_smoke_state(dom_, params_, source_shape=Cylinder(
            center=(0.5 * sx, 0.1 * sy, 0.5 * sz), radius=0.14 * sx,
            z=(0.0, 0.02 * sy, 0.0)), boundary_width=0, dt=1.1, device=dev)

    params = smoke.SmokeParams(
        buoyancy=(0.0, -6e-3, 0.0), cg_accuracy=1e-3, cg_max_iter_fac=1.5,
        adaptive_dt=True, cfl=3.0, dt_min=0.2, dt_max=2.0,
        frame_length=1.2, window=0, clamp_mode=2)
    dom, st = plume(EXACT_RES, params)
    st = smoke.smoke_step(st, dom, params)  # warm: builds the kernels
    before = counted()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    st = smoke.smoke_run(st, dom, params, EXACT_STEPS)
    t1.record()
    got, n_kernel, n_plain = since(before)
    per_step = EXACT_PER_STEP
    for k, n in got.items():
        require(n == per_step[k] * EXACT_STEPS,
                f"exact plume: {k} launched {n} times in {EXACT_STEPS} "
                f"steps (expected {per_step[k]} a step)")
    require(n_kernel == 2 * EXACT_STEPS and n_plain == 0,
            f"exact plume: {n_kernel} driver calls on the kernels, "
            f"{n_plain} plain, in {EXACT_STEPS} steps")
    for f in ("vel", "density", "pressure"):
        require(bool(torch.isfinite(getattr(st, f)).all()),
                f"exact plume: {f} not finite")
    numbers["plume"] = {
        "res": list(EXACT_RES), "steps": EXACT_STEPS,
        "ms_per_step_developed": t0.elapsed_time(t1) / EXACT_STEPS,
        "launches_per_step": per_step, "density_max": float(st.density.max()),
        "dt": float(st.ts.dt)}

    # one developed step's two driver calls
    real_calls, mac_calls = [], []
    with recording(adv, "advect_real", real_calls) as drv_real, \
            recording(adv, "advect_mac", mac_calls) as drv_mac:
        smoke.smoke_step(st, dom, params)
    torch.cuda.synchronize()
    require(len(real_calls) == 1 and len(mac_calls) == 1,
            f"exact plume: {len(real_calls)} advect_real and "
            f"{len(mac_calls)} advect_mac calls in a step")
    (r_args, r_kw), = real_calls
    (m_args, m_kw), = mac_calls
    flags = r_args[0]
    open_flags = fl_.set_open_bound(flags, dom, 0, "yY")
    n_out = int(fl_.is_outflow(open_flags).sum())
    require(n_out > 0 and int(fl_.is_outflow(flags).sum()) == 0,
            f"exact plume: {n_out} outflow cells with open bounds")
    held = {}
    for variant, fl_v in (("walls", flags), ("open_yY", open_flags)):
        for name, drv, plain, (args, kw) in (
                ("advect_real", drv_real, adv.advect_real_plain,
                 (r_args, r_kw)),
                ("advect_mac", drv_mac, adv.advect_mac_plain,
                 (m_args, m_kw))):
            args = (fl_v,) + tuple(args[1:])
            before = counted()
            out = drv(*args, **kw)
            require(since(before)[1] == 1, f"exact plume {variant}: "
                    f"{name} did not take the kernels")
            ref = plain(*args, **kw)
            torch.cuda.synchronize()
            diff = out != ref
            n_diff = int(diff.sum())
            err = float((out - ref).abs().max())
            require(n_diff == 0, f"exact plume {variant}: {name} differs "
                    f"from its plain version in {n_diff} cells (max {err})")
            held[f"{name}_{variant}"] = {"cells_differing": n_diff,
                                          "max_abs_err": err}
    numbers["held_bit_for_bit"] = held
    print(f"exact advection kernels vs plain on the developed "
          f"{EXACT_RES} plume: {held}", flush=True)

    # each kernel's time on the step's inputs, the five launches' and the
    # plain versions'
    vel, density, dt = r_args[1], r_args[2], r_args[3]
    strength = m_kw.get("strength", 1.0)
    fwd_d = advx.forward(vel, density, dt)
    fwd_v = advx.forward(vel, vel, dt)
    new_v = advx.backward(flags, vel, vel, fwd_v, dt, strength)
    launches = {
        "advect_exact_fwd<false>": lambda: advx.forward(vel, density, dt),
        "advect_exact_bwd<false>": lambda: advx.backward(
            flags, vel, density, fwd_d, dt, 1.0),
        "advect_exact_fwd<true>": lambda: advx.forward(vel, vel, dt),
        "advect_exact_bwd<true>": lambda: advx.backward(
            flags, vel, vel, fwd_v, dt, strength),
        "advect_exact_outflow": lambda: advx.outflow(flags, new_v, vel, dt)}
    timings = {}
    for name, fn in launches.items():
        ms, call_ms, timed_by = timed_launches(torch, fn, 20, name, 1,
                                               graph=True)
        bound_ms = (EXACT_BYTES_PER_CELL[name] * EXACT_CELLS
                    / HBM_BYTES_PER_S * 1e3)
        # the scalar instances run in advect_real, the rest in advect_mac
        driver = "advect_real" if name.endswith("<false>") else "advect_mac"
        timings[name] = {
            "ms": ms, "call_ms": call_ms, "timed_by": timed_by,
            "bound_ms": bound_ms, "bound_by": "bytes",
            "roofline_pct": 100.0 * bound_ms / ms,
            "max_abs_err": max(v["max_abs_err"] for k, v in held.items()
                               if k.startswith(driver))}
        print(f"{name}: {ms * 1e3:.2f} us/launch (bound "
              f"{bound_ms * 1e3:.2f} us, {EXACT_BYTES_PER_CELL[name]} B a "
              f"cell: {timings[name]['roofline_pct']:.1f} %), {timed_by}",
              flush=True)
    both = (lambda: (drv_real(*r_args, **r_kw), drv_mac(*m_args, **m_kw)))
    plain = (lambda: (adv.advect_real_plain(*r_args, **r_kw),
                      adv.advect_mac_plain(*m_args, **m_kw)))
    kern_ms = sum(t["ms"] for t in timings.values())
    numbers["advection"] = {
        "kernels_ms": kern_ms, "drivers_ms": cuda_ms(torch, both, 20),
        "plain_ms": cuda_ms(torch, plain, 3), "bound_us": EXACT_BOUND_US,
        "roofline_pct": 100.0 * EXACT_BOUND_US / (kern_ms * 1e3),
        "us_per_launch": {k: t["ms"] * 1e3 for k, t in timings.items()}}
    print(f"exact advection a step: kernels {kern_ms:.4f} ms, drivers "
          f"{numbers['advection']['drivers_ms']:.4f} ms (events), plain "
          f"{numbers['advection']['plain_ms']:.3f} ms; "
          f"{numbers['advection']['roofline_pct']:.2f} % of the bound",
          flush=True)
    del st, real_calls, mac_calls, fwd_d, fwd_v, new_v

    # the exact smoke on a sharded state's slabs against one device
    sp = dc.replace(params, adaptive_dt=False)
    sdom, s0 = plume((32, 32, 32), sp)
    one, sh = s0, shd.shard_smoke_state(s0, shd.make_mesh(ZSHARDS))
    got = dict.fromkeys(kernels, 0)
    n_kernel = n_plain = 0
    steps = []
    for k in range(3):
        one = smoke.smoke_step(one, sdom, sp)
        before = counted()
        sh = smoke.smoke_step(sh, sdom, sp)
        got_k, n_k, n_p = since(before)
        got = {k_: got[k_] + n for k_, n in got_k.items()}
        n_kernel, n_plain = n_kernel + n_k, n_plain + n_p
        w = shd.unshard_smoke_state(sh)
        err = max(float((getattr(w, f) - getattr(one, f)).abs().max())
                  for f in ("vel", "density", "pressure"))
        di = int(sh.cg_iters) - int(one.cg_iters)
        steps.append({"max_abs_err": err, "cg_iters_diff": di})
        require(err <= 1e-5 and torch.equal(w.flags, one.flags)
                and abs(di) <= 2,
                f"exact smoke slabs step {k + 1}: {steps[-1]}")
    # every shard holds planes: its two driver calls a step, each on the
    # kernels
    shards = sum(p.shape[0] > 0 for p in sh.density.parts)
    require(shards == ZSHARDS and n_kernel == 2 * 3 * ZSHARDS
            and n_plain == 0,
            f"exact smoke slabs: {n_kernel} driver calls on the kernels, "
            f"{n_plain} plain, in 3 steps over {shards} shards")
    for k, n in got.items():
        require(n == EXACT_PER_STEP[k] * 3 * ZSHARDS,
                f"exact smoke slabs: {k} launched {n} times in 3 steps over "
                f"{ZSHARDS} shards (expected {EXACT_PER_STEP[k]} a shard "
                f"and step)")
    numbers["slabs_32"] = {"shards": ZSHARDS, "steps": steps,
                           "driver_calls_kernel": n_kernel,
                           "driver_calls_plain": n_plain,
                           "launches": got}
    print(f"exact smoke 32^3 over {ZSHARDS} slabs vs one device: {steps}; "
          f"driver calls {n_kernel} on the kernels, {n_plain} plain",
          flush=True)
    return numbers, timings


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
    from mantaflow_tpu_torch.scene import api as sapi
    from mantaflow_tpu_torch.scene import vortex_api as vapi
    from mantaflow_tpu_torch.ops import waves as wav
    from mantaflow_tpu_torch.ops import whitewater as ww
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
    if "--only-multi" in sys.argv[1:]:
        # phase 32 alone, for a quick call: no kernels line, no ok line
        md = multi_device_phase(torch, dev, _Helpers(every_kernel=_every_kernel(
            advk, fadk, rbk, p2gk, lsk, blk, xk, prk)))[0]
        print(card)
        print(json.dumps({"multi_device": md}))
        return
    if "--only-zflip" in sys.argv[1:]:
        # phase 34 alone, for a quick call: no kernels line, no ok line
        zf = zflip_phase(torch, dev, _Helpers(every_kernel=_every_kernel(
            advk, fadk, rbk, p2gk, lsk, blk, xk, prk)))
        print(card)
        print(json.dumps({"zflip": zf[0], "launches_by_path": zf[1]}))
        return
    if "--only-exact" in sys.argv[1:]:
        # phase 35 alone, for a quick call: no kernels line, no ok line
        ex = exact_advect_phase(torch, dev, _Helpers(
            every_kernel=_every_kernel(advk, fadk, rbk, p2gk, lsk, blk, xk,
                                       prk)))
        print(card)
        print(json.dumps({"exact_advect": ex[0], "kernels": ex[1]}))
        return
    if "--only-scenes" in sys.argv[1:]:
        # phase 33 alone, for a quick call: no kernels line, no ok line
        sc = scenes_phase(torch, dev, _Helpers(every_kernel=_every_kernel(
            advk, fadk, rbk, p2gk, lsk, blk, xk, prk)))
        print(card)
        print(json.dumps({"scenes": sc[0], "launches_by_path": sc[1],
                          "kernels_vs_plain": sc[2]}))
        return

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
                    "advect_bucket_no_blend": fadk.advect,
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
                              fparams.flip_ratio, d_, mode),
            {"ring_only": ring}))
    # K3's form without the blend (advect: the kernel's kBlend = false
    # instances, advect_pallas) with and without stopping, and the blend
    # form without stopping (kStop = false), on the same sweep (the 24^3
    # corner dam and the developed 128^3 inputs) against their plain
    # versions, held as the step's form is (abs 1e-6); the form without the
    # blend passes the velocities through untouched
    forms_err = {"no_blend": 0.0, "no_stop": 0.0}
    forms_bitwise = {"no_blend": True, "no_stop": True}
    for b_, f_, v_, vo_, dt_, pend, mode, ring, d_ in options:
        if pend:
            for stop in (True, False):
                got = fadk.advect(b_, f_, v_, dt_, d_, mode, ring_only=ring,
                                  stop_in_obstacle=stop)
                ref = fb.advect_bucketed(b_, f_, v_, dt_, d_, mode, stop,
                                         ring)
                for f in fields6:
                    same = torch.equal(getattr(got, f), getattr(ref, f))
                    if f in ("vx", "vy", "vz"):
                        require(same, f"advect (no blend): {f} changed")
                    forms_bitwise["no_blend"] &= same
                    forms_err["no_blend"] = max(forms_err["no_blend"], float(
                        (getattr(got, f) - getattr(ref, f)).abs().max()))
        args = (b_, f_, v_, vo_, dt_, torch.tensor(pend, device=dev),
                fparams.flip_ratio, d_, mode)
        got = fadk.advect_blend(*args, ring_only=ring, stop_in_obstacle=False)
        ref = fadk.advect_blend_plain(*args, ring_only=ring,
                                      stop_in_obstacle=False)
        for f in fields6:
            forms_bitwise["no_stop"] &= torch.equal(getattr(got, f),
                                                    getattr(ref, f))
            forms_err["no_stop"] = max(forms_err["no_stop"], float(
                (getattr(got, f) - getattr(ref, f)).abs().max()))
    require(max(forms_err.values()) <= 1e-6,
            f"advect forms without blend / stop: max abs err {forms_err}")
    print(f"advect_bucket's forms without the blend and without stopping vs "
          f"plain over {len(options)} cases: {forms_err}, bit for bit "
          f"{forms_bitwise}", flush=True)
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

    def time_kernel(kind, kname, calls, fn, plain, nbytes, nops, what,
                    graph=False):
        """Device ms per launch of ``fn`` over the recorded calls, the
        plain version's ms, and the bound from the bytes and operations
        the function needs for these inputs (``graph``: ``fn`` only
        allocates and launches, timed_launches' graph fallback)."""
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        o_ms = nops / FP32_OPS_PER_S * 1e3
        ms, call_ms, timed_by = timed_launches(
            torch, replay(calls, fn), 5, kname, len(calls),
            graph=graph or kname.startswith("extrap_layer"))
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
    for kind, kname in (("advect_bucket",
                         "advect_live_kernel<false,true,true>"),
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
    # K3's two other instances on the same inputs (RK4): without the blend,
    # the live slots' positions read and written, vel alone staged (~500
    # operations a particle: the RK4 less the blend's ~120); the blend form
    # without stopping, the step form's bytes less the obstacle mask
    ring128 = fparams.ring_only_obstacles
    vb = sum(valid_bytes_read(a[0]) for a, _ in adv_calls) / len(adv_calls)
    # each timed through its live form (outputs uninitialised, the kernel
    # writes the live slots; the public wrappers first copy every slot's
    # fields, 0.4-0.8 ms here), so that the profiler, CUDA events and a
    # graph replay all read the kernel; the public wrappers' events time
    # with their copies beside it
    no_blend_calls = [((bk128, flags128, vel128, None, dt128, None, 0.0, fdom,
                        2, ring128, True, False, "advect"), {})]

    def no_blend_plain(b_, f_, v_, _vo, dt_, _p, _fr, d_, mode, ring, stop,
                       _through, _who):
        return fb.advect_bucketed(b_, f_, v_, dt_, d_, mode, stop, ring)
    time_kernel("advect_bucket_no_blend",
                "advect_live_kernel<false,false,true>", no_blend_calls,
                fadk._advect_cuda, no_blend_plain,
                24 * live + vb + 12 * T + (0 if ring128 else T), 500 * live,
                f"P {P}, {live} live, without the blend", graph=True)
    no_stop_calls = [((bk128, flags128, vel128, vold128, dt128,
                       torch.tensor(True, device=dev), fparams.flip_ratio,
                       fdom, 2), {"ring_only": ring128,
                                  "stop_in_obstacle": False})]
    time_kernel("advect_bucket_no_stop",
                "advect_live_kernel<false,true,false>", no_stop_calls,
                fadk.advect_blend_live, fadk.advect_blend_plain,
                48 * live + vb + 24 * T, 600 * live,
                f"P {P}, {live} live, without stopping", graph=True)
    for kind, pub_calls, pub in (
            ("advect_bucket_no_blend",
             [((bk128, flags128, vel128, dt128, fdom, 2),
               {"ring_only": ring128})], fadk.advect),
            ("advect_bucket_no_stop", no_stop_calls, fadk.advect_blend)):
        fk[kind]["public_call_ms"] = cuda_ms(torch, replay(pub_calls, pub),
                                             5)
        print(f"{kind}: the kernel {fk[kind]['ms'] * 1e3:.1f} us "
              f"({fk[kind]['timed_by']}), the public wrapper with its "
              f"copies {fk[kind]['public_call_ms'] * 1e3:.1f} us",
              flush=True)
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
            ("advect_bucket_zshard", "advect_live_kernel<true,true,true>",
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
    every_kernel = _every_kernel(advk, fadk, rbk, p2gk, lsk, blk, xk, prk)
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

    exact_kernels = {k: every_kernel[k] for k in EXACT_PER_STEP}

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
            for fn in exact_kernels.values():
                fn.launches = 0
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
                   "cg_solve": prk.cg_solve.launches,
                   **{k: fn.launches for k, fn in exact_kernels.items()}}
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
                         {"window_advect": 0, "cg_solve": 1,
                          **EXACT_PER_STEP})
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
    def scene_solver(dom_, d_, dt, frame_length=1.0, cfl=3.0, dt_min=1e-4,
                     dt_max=1.0):
        """The scene API's Solver (FluidSolver::step and adaptTimestep,
        fluidsolver.cpp:143-204) with a scene's time settings."""
        sol = sapi.Solver(name="scene", gridSize=dom_.size, dim=dom_.dim,
                          device=d_)
        sol.timestep, sol.frameLength, sol.cfl = dt, frame_length, cfl
        sol.timestepMin, sol.timestepMax = dt_min, dt_max
        return sol

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
                "noise": noise, "clock": scene_solver(dom_, d_, 1.1, 1.2, 3.0,
                                                      0.2, 2.0),
                "box": Box(center=(res_ * 0.5, res_ * 0.15, res_ * 0.5),
                           size=(res_ / 8, 0.05 * res_, res_ / 8))}

    def fire_step(st, dom_):
        flags, vel, clock = st["flags"], st["vel"], st["clock"]
        clock.adaptTimestep(float(torch.sqrt(torch.max(
            vel[0] ** 2 + vel[1] ** 2 + vel[2] ** 2))))
        dt = clock.timestep
        g = {k: st[k] for k in ("density", "heat", "fuel", "react")}
        if clock.timeTotal < 200:
            t = clock.timeTotal * dom_.dx
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
    fire_numbers["time_total"] = fire_last["clock"].timeTotal
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
    # the box by the port's scene API TurbulenceParticleSystem (its
    # persistent RandomStream(34894231)), RK4 advectInGrid, synthesize
    # (octaves 1, switchLength 5, L0 0.01, the static ctime/inflow and the
    # tex resets) and deleteInObstacle; the
    # k-epsilon chain with diffusion (sigmaU 10), inflow BCs, PcMIC with
    # cgMaxIterFac 0.5 (K2 on its spill path). Cut: the GUI-only
    # obstacleLevelset + createMesh
    KE_INFLOW = (0.52, 0.0, 0.0)

    def scene_grid(solver, cls, data):
        """A scene API grid of ``solver`` holding ``data``."""
        g_ = solver.create(cls)
        g_.data = data
        return g_

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
        # the scene API's turbulence particles: one scene run's persistent
        # seeding stream and synthesize statics, reset per run
        vapi.reset_process_statics()
        sol = scene_solver(dom_, d_, 0.5)
        noise = sapi.NoiseField(sol)
        return {"flags": flags, "vel": torch.zeros((3,) + dom_.shape,
                                                   device=d_),
                "k": k, "eps": eps, "pressure": z,
                "it": torch.zeros((), dtype=torch.int32, device=d_),
                "solver": sol,
                "tp": vapi.TurbulenceParticleSystem(sol, noise=noise),
                "box": sapi.Box(sol, center=(res_ * 0.05, gs[1] * 0.43,
                                             gs[2] * 0.6),
                                size=(res_ * 0.02, gs[1] * 0.005,
                                      gs[2] * 0.07))}

    def keps_step(st, dom_):
        flags, vel, k, eps, tp = (st[n_] for n_ in ("flags", "vel", "k",
                                                    "eps", "tp"))
        dt = 0.5
        sol = st["solver"]
        fg = scene_grid(sol, sapi.FlagGrid, flags)
        tp.seed(st["box"], 500)
        tp.advectInGrid(fg, scene_grid(sol, sapi.MACGrid, vel),
                        integrationMode=sapi.IntRK4)
        tp.synthesize(fg, scene_grid(sol, sapi.RealGrid, k), octaves=1,
                      switchLength=5.0, L0=0.01, scale=0.1,
                      inflowBias=KE_INFLOW)
        tp.deleteInObstacle(fg)
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
    # -- 29-30: the scene API (A14): unedited scenes through the runner ----
    # 29. scenes/flip06_obstacle.py FLIP06_FRAMES FLIP06_RES, unedited,
    # through the scene runner on the card: narrow-band FLIP with a sphere
    # obstacle, fractions, adaptive dt and a mesh every step (marching cubes
    # on the host). Solver.step is wrapped: a CUDA event after each step
    # (the median of the last 10 steps' spans), the K2/K14 calls of the
    # step kept for the kernel checks, and from frame FLIP06_FRAMES - 2 on
    # a torch.profiler trace; createMesh is timed on the host
    import io
    import os
    from statistics import median
    import mantaflow_tpu_torch as mtt
    from mantaflow_tpu_torch.core.interp import interpol
    from mantaflow_tpu_torch.scene import papi as spapi
    from mantaflow_tpu_torch.scene import run as srun
    from mantaflow_tpu_torch.scene import refgolden
    here = os.path.dirname(os.path.abspath(__file__))
    flip06_file = os.path.join(here, "scenes", "flip06_obstacle.py")

    def flip06_run(frames, res, d_, trace_from=None):
        """Run the scene; returns its globals and the run's record."""
        rec = {"events": [], "mesh_s": [], "steps": 0, "cur": {}, "last": {},
               "traced_steps": 0}
        on_card = torch.device(d_).type == "cuda"
        orig_step = sapi.Solver.step
        orig_mesh = sapi.LevelsetGrid.createMesh
        counted = {}

        def counting(module, name):
            orig = getattr(module, name)

            def fn(*args, **kwargs):
                rec["cur"].setdefault(name, []).append((args, kwargs))
                return orig(*args, **kwargs)
            fn.launches = 0
            counted[name] = (module, orig, fn)
            setattr(module, name, fn)

        def step(self, frame=-1):
            orig_step(self, frame)
            rec["steps"] += 1
            rec["last"], rec["cur"] = rec["cur"], {}
            if on_card:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                rec["events"].append(ev)
                if "prof" in rec:
                    rec["traced_steps"] += 1
                elif trace_from is not None and self.frame >= trace_from:
                    from torch.profiler import ProfilerActivity, profile
                    rec["prof"] = profile(activities=[ProfilerActivity.CUDA])
                    rec["prof"].__enter__()
                    rec["trace_t0"] = ev

        def push_out(parts, flags, phiObs, **kw):
            # the particles' depth in the obstacle right after the push:
            # interpolated phiObs (min) and the count in obstacle cells
            orig_push(parts, flags, phiObs, **kw)
            act = parts.parts.active_mask()
            pos = parts.parts.pos[act]
            v = interpol(phiObs.data, pos[:, 0], pos[:, 1], pos[:, 2])
            sz, sy, sx = flags.data.shape
            c = flags.data[torch.clamp(pos[:, 2].to(torch.int64), 0, sz - 1),
                           torch.clamp(pos[:, 1].to(torch.int64), 0, sy - 1),
                           torch.clamp(pos[:, 0].to(torch.int64), 0, sx - 1)]
            rec["push"].append((v.min(), ((c & fl.TypeObstacle) != 0).sum()))

        def create_mesh(self, mesh):
            if on_card:
                torch.cuda.synchronize()
            t0_ = time.perf_counter()
            orig_mesh(self, mesh)
            rec["mesh_s"].append(time.perf_counter() - t0_)

        out = io.StringIO()
        orig_push = spapi.pushOutofObs
        rec["push"] = []
        # the scene's star import reads the package's attribute
        spapi.pushOutofObs = mtt.pushOutofObs = push_out
        sapi.Solver.step, sapi.LevelsetGrid.createMesh = step, create_mesh
        counting(prk, "cg_solve")
        counting(xk, "extrap_layer")
        try:
            t0_ = time.perf_counter()
            with contextlib.redirect_stdout(out):
                g_ = srun.run_scene(flip06_file, [frames, res], d_)
            if on_card:
                t1_ = torch.cuda.Event(enable_timing=True)
                t1_.record()
                torch.cuda.synchronize()
            rec["wall_s"] = time.perf_counter() - t0_
            if "prof" in rec:
                rec["prof"].__exit__(None, None, None)
                rec["traced_ms"] = rec["trace_t0"].elapsed_time(t1_)
        finally:
            sapi.Solver.step, sapi.LevelsetGrid.createMesh = (orig_step,
                                                              orig_mesh)
            spapi.pushOutofObs = mtt.pushOutofObs = orig_push
            for name_, (module, orig, _) in counted.items():
                setattr(module, name_, orig)
        rec["launches"] = {n: v[2].launches for n, v in counted.items()}
        rec["stdout"] = out.getvalue()
        return g_, rec

    def flip06_checks(g_, rec, name):
        """The scene's last line against its state; every field finite;
        after every pushOutofObs no active particle more than half a cell
        inside the obstacle (the push moves a particle along the
        cell-centred gradient of phiObs by its interpolated depth, so the
        reference leaves some on the surface, in obstacle cells, and some
        a fraction of a cell inside: reported); the mesh a consistently
        oriented 2-manifold: no edge in more than two triangles, no
        directed edge twice, no degenerate triangle (the table-driven
        marching cubes leaves cracks at ambiguous faces, so some edges
        bound one triangle: counted). Returns the particle and triangle
        counts, the deepest particle and most in obstacle cells after a
        push, and the edges in one triangle."""
        last = rec["stdout"].strip().splitlines()[-1]
        m_ = re.match(r"flip06 done: (\d+) particles, (\d+) mesh tris", last)
        require(m_ is not None, f"{name}: last line {last!r}")
        pp_, mesh_ = g_["pp"], g_["mesh"]
        n_parts, n_tris = pp_.pySize(), mesh_.numTris()
        require((n_parts, n_tris) == (int(m_[1]), int(m_[2])),
                f"{name}: {n_parts} particles, {n_tris} triangles vs {last}")
        require(n_parts > 0 and n_tris > 0, f"{name}: empty")
        for k in ("phi", "vel", "velOld", "velParts", "pressure", "phiParts",
                  "fractions", "phiObs"):
            require(bool(torch.isfinite(g_[k].data).all()),
                    f"{name}: {k} not finite")
        act = pp_.parts.active_mask()
        require(bool(torch.isfinite(g_["pVel"].data[act]).all()),
                f"{name}: particle velocities not finite")
        deepest = min(float(v) for v, _ in rec["push"])
        in_obs = max(int(c) for _, c in rec["push"])
        require(len(rec["push"]) == rec["steps"] and deepest > -0.5,
                f"{name}: a particle {-deepest} cells inside the obstacle "
                "after pushOutofObs")
        t_ = mesh_.tris
        d_ = np.concatenate([t_[:, [0, 1]], t_[:, [1, 2]], t_[:, [2, 0]]])
        _, uses = np.unique(np.sort(d_, axis=1), axis=0, return_counts=True)
        _, d_uses = np.unique(d_, axis=0, return_counts=True)
        require(bool((uses <= 2).all()) and bool((d_uses == 1).all())
                and not bool(((t_[:, 0] == t_[:, 1]) | (t_[:, 1] == t_[:, 2])
                              | (t_[:, 0] == t_[:, 2])).any()),
                f"{name}: mesh not a consistently oriented 2-manifold")
        return n_parts, n_tris, deepest, in_obs, int((uses == 1).sum())

    FLIP06_K14 = 5 + 3 + 2 + 2 + 4  # the five extrapolations' layers a step
    f06_g, f06 = flip06_run(FLIP06_FRAMES, FLIP06_RES, dev,
                            trace_from=FLIP06_FRAMES - 2)
    n_steps06 = f06["steps"]
    spans = [f06["events"][i - 1].elapsed_time(f06["events"][i])
             for i in range(1, len(f06["events"]))]
    f06_parts, f06_tris, f06_deep, f06_in_obs, f06_open = flip06_checks(
        f06_g, f06, f"flip06 {FLIP06_RES}^3")
    got06 = f06["launches"]
    require(got06["cg_solve"] == n_steps06,
            f"flip06: {got06['cg_solve']} K2 launches in {n_steps06} steps")
    require(got06["extrap_layer"] == FLIP06_K14 * n_steps06,
            f"flip06: {got06['extrap_layer']} K14 launches in {n_steps06} "
            f"steps (expected {FLIP06_K14} a step)")
    busy_us, dev_count = 0.0, 0
    for e in f06["prof"].key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us > 0:
            busy_us += us
            dev_count += e.count
    nt = max(f06["traced_steps"], 1)
    f06_busy = busy_us / 1e3 / nt
    require(f06_busy > 0, "flip06: the trace holds no device time")
    f06_traced = f06["traced_ms"] / nt
    mesh_s = f06["mesh_s"]
    f06_numbers = {
        "frames": FLIP06_FRAMES, "res": FLIP06_RES, "steps": n_steps06,
        "wall_s": f06["wall_s"],
        "step_ms_median_last10": median(spans[-10:]),
        "step_ms_all": spans,
        "create_mesh_host_s_median": median(mesh_s),
        "create_mesh_host_s_max": max(mesh_s),
        "create_mesh_share_of_step": median(mesh_s) * 1e3
        / median(spans[-10:]),
        "kernel_launches_per_step": {k: v / n_steps06
                                     for k, v in got06.items()},
        "traced_steps": f06["traced_steps"],
        "traced_wall_ms_per_step": f06_traced,
        "device_busy_ms_per_step": f06_busy,
        "device_launches_per_step": dev_count / nt,
        "idle_share_traced": 1.0 - f06_busy / f06_traced,
        "particles": f06_parts, "mesh_triangles": f06_tris,
        "after_push_deepest_phi_obs": f06_deep,
        "after_push_most_in_obstacle_cells": f06_in_obs,
        "mesh_edges_in_one_triangle": f06_open,
        "dt_last": f06_g["s"].timestep}
    scene_paths[f"flip06_{FLIP06_RES}"] = got06
    scene_numbers[f"flip06_{FLIP06_RES}"] = f06_numbers
    print(f"flip06 {FLIP06_RES}^3 x {FLIP06_FRAMES} frames: {n_steps06} "
          f"steps in {f06['wall_s']:.1f} s, {f06_numbers['step_ms_median_last10']:.1f} "
          f"ms/step (median of the last 10), createMesh "
          f"{f06_numbers['create_mesh_host_s_median']:.3f} s on the host "
          f"(median), {f06_parts} particles, {f06_tris} triangles; traced "
          f"{f06_traced:.1f} ms/step, device busy {f06_busy:.1f} ms, "
          f"{dev_count / nt:.0f} device launches a step, idle "
          f"{100 * f06_numbers['idle_share_traced']:.1f} %; K2 "
          f"{got06['cg_solve'] / n_steps06:.0f}, K14 "
          f"{got06['extrap_layer'] / n_steps06:.0f} a step", flush=True)
    # K14 and K2 of the last (developed) step against their plain versions:
    # the layers exact, K2 by its residual on the fractions-plus-ghost-fluid
    # system
    last06 = f06["last"]
    require(len(last06.get("cg_solve", ())) == 1
            and len(last06.get("extrap_layer", ())) == FLIP06_K14,
            "flip06: kernel calls in the last step")
    f06_dom = Domain(size=(FLIP06_RES,) * 3)
    for args, kwargs in last06["extrap_layer"]:
        errs["extrap_layer"] = max(errs["extrap_layer"], check_call(
            "extrap_layer", args, kwargs))
    (cg_args, cg_kw), = last06["cg_solve"]
    tracked, drift = tracked_iterations(cg_args[0], cg_args[1],
                                        cg_kw["fluid"], f06_dom)
    f06_numbers["cg_float32_tracks_float64_iterations"] = [tracked, drift]
    k2_err = max(k2_err, cg_check_by_residual(
        cg_args[0], cg_args[1], cg_kw["fluid"], cg_args[3], cg_args[4],
        f06_dom, early=tracked))
    f06_it = int(prk.cg_solve(*cg_args, **cg_kw)[1])
    n06 = f06_dom.num_cells
    time_kernel("cg_solve_flip06", "cg_kernel<false>", last06["cg_solve"],
                prk.cg_solve, prs.cg_plain, 6 * 4 * n06, f06_it * 24 * n06,
                f"flip06 last step's solve, {f06_it} it")
    fk["cg_solve_flip06"]["iterations"] = f06_it
    fk["cg_solve_flip06"]["max_iterations"] = cg_args[4]
    fk["cg_solve_flip06"]["us_per_iteration"] = (
        fk["cg_solve_flip06"]["ms"] * 1e3 / max(f06_it, 1))
    fk["cg_solve_flip06"]["launches_per_step"] = 1
    layer06 = last06["extrap_layer"]
    pairs06 = sum(len(a[0]) for a, _ in layer06) / len(layer06)
    time_kernel("extrap_layer_flip06", "extrap_layer_kernel<true>", layer06,
                xk.extrap_layer, xk.extrap_layer_plain, pairs06 * 16 * n06,
                pairs06 * 20 * n06, "flip06 last step's layers")
    fk["extrap_layer_flip06"]["launches_per_step"] = FLIP06_K14
    fk["extrap_layer_flip06"]["us_per_layer"] = (
        fk["extrap_layer_flip06"]["ms"] * 1e3)
    print(f"flip06 last step, kernels vs plain: extrap_layer "
          f"{errs['extrap_layer']:.3g}; cg_solve {f06_it} it at "
          f"{fk['cg_solve_flip06']['us_per_iteration']:.1f} us/it, "
          f"float32 within rel 1e-6 of float64 for {tracked} it", flush=True)
    del f06_g, f06, last06, layer06, cg_args, cg_kw
    torch.cuda.empty_cache()

    # the same scene at 2 frames on 24^3, the card against the port on the
    # CPU: flags, particle count and triangle count exact; phi within 2e-4
    # of its scale. The CG's exit moves with rounding on this ghost-fluid
    # system with fractions (K2 and its plain version track float64 for
    # ~8-10 iterations), so, as phase 27, the grids downstream of the solve
    # (vel, pressure, the particles' velocities and the positions they
    # advect) are held by each device's residual of its last solve, and
    # to 1e-2 x max(1, max|CPU value|): the two solves to 1e-3 part by
    # 2.7e-3 in vel (NVIDIA H100, 700 W), within the ill-conditioned
    # system's bound of its residuals, where a broken path parts by O(1)
    cmp06 = {}
    for d_ in (dev, "cpu"):
        g_, r_ = flip06_run(2, 24, d_)
        flip06_checks(g_, r_, f"flip06 24^3 on {d_}")
        cmp06[str(d_)] = (g_, r_["last"]["cg_solve"][0])
    (g_, g_cg), (c_, c_cg) = cmp06[str(dev)], cmp06["cpu"]
    require(torch.equal(g_["flags"].data.cpu(), c_["flags"].data),
            "flip06 card vs CPU: flags differ")
    require(g_["pp"].pySize() == c_["pp"].pySize()
            and g_["mesh"].numTris() == c_["mesh"].numTris(),
            "flip06 card vs CPU: particle or triangle counts differ")

    def rel_err(a, b, floor=1e-30):
        a, b = a.cpu().double(), b.cpu().double()
        return float((a - b).abs().max()) / max(float(b.abs().max()), floor)
    n_ = c_["pp"].pySize()
    f06_cmp = {"phi": rel_err(g_["phi"].data, c_["phi"].data)}
    require(f06_cmp["phi"] < 2e-4,
            f"flip06 card vs CPU: phi {f06_cmp['phi']} of its scale")
    for k, a, b in (
            ("vel", g_["vel"].data, c_["vel"].data),
            ("pressure", g_["pressure"].data, c_["pressure"].data),
            ("particle_vel", g_["pVel"].data[:n_], c_["pVel"].data[:n_]),
            ("particle_pos", g_["pp"].parts.pos[:n_],
             c_["pp"].parts.pos[:n_])):
        f06_cmp[k] = rel_err(a, b, floor=1.0)
        require(f06_cmp[k] < 1e-2,
                f"flip06 card vs CPU: {k} {f06_cmp[k]} of max(1, scale)")
    dom24 = Domain(size=(24,) * 3)
    for who, st, (args, kwargs) in (("card", g_, g_cg), ("cpu", c_, c_cg)):
        # max-norm over the fluid cells, in float64, under the accuracy
        # with 1 % for the updated residual's drift
        st64 = tuple(a.double() for a in args[1])
        r64 = args[0].double() - prs._apply_stencil(
            st["pressure"].data.double(), st64, dom24)
        res = float(torch.where(kwargs["fluid"], r64, 0.0).abs().max())
        require(res < 1.01 * args[3],
                f"flip06 card vs CPU: {who} residual {res}")
        f06_cmp[f"pressure_residual_{who}"] = res
    f06_numbers["card_vs_cpu_24"] = f06_cmp
    print(f"flip06 24^3 x 2 frames, card vs CPU: {f06_cmp}", flush=True)
    del cmp06, g_, c_

    # 30. the reference-binary goldens on the card: every
    # tests/ref_scenes/test_*.py through the runner's alias, each with its
    # own thresholds, the process statics reset before each
    gold = {}
    t_gold = time.perf_counter()
    for name in refgolden.scene_names(on_card=True):
        t0_ = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            rec_ = refgolden.run_ref_scene(name, dev)
        torch.cuda.synchronize()
        gold[name] = {"s": time.perf_counter() - t0_,
                      "grids": len(rec_.results),
                      "diffs": {n_: d for n_, d, _, _ in rec_.results},
                      "sha256": hashlib.sha256("".join(
                          rec_.digests).encode()).hexdigest()[:12],
                      "worst_share_of_threshold": max(
                          (d / t if t > 0 else 0.0)
                          for _, d, t, _ in rec_.results)}
        del out
    gold_s = time.perf_counter() - t_gold
    # the flat layout sums its scatters in one order (core/interp.py:
    # add_at): the sloshing liquid, which parted whole particles from run
    # to run under atomics, run again gives the same grids bit for bit
    with contextlib.redirect_stdout(io.StringIO()):
        again = refgolden.run_ref_scene("test_1090_waveBench", dev)
    again = hashlib.sha256("".join(again.digests).encode()).hexdigest()[:12]
    require(again == gold["test_1090_waveBench"]["sha256"],
            f"test_1090_waveBench run again: grids {again}, first run "
            f"{gold['test_1090_waveBench']['sha256']}")
    scene_numbers["ref_goldens"] = {
        "scenes": gold, "total_s": gold_s, "repeat_sha256": again,
        "left_out": {**refgolden.LEFT_OUT, **refgolden.LEFT_OUT_ON_CARD}}
    print(f"reference goldens on the card: {len(gold)} scenes, "
          f"{sum(v['grids'] for v in gold.values())} grids, all within "
          f"their thresholds, {gold_s:.1f} s; slowest "
          f"{max(gold, key=lambda k: gold[k]['s'])} "
          f"{max(v['s'] for v in gold.values()):.1f} s", flush=True)

    # 31. the ML toolbox: scenes/mlflip.py's stages, ML-FLIP at ML_RES^3
    # with the net in the loop, the other pipelines, card against CPU
    import types
    ml_numbers, ml_k2_err = ml_toolbox_phase(torch, dev, types.SimpleNamespace(
        check_call=check_call, cg_check_by_residual=cg_check_by_residual,
        tracked_iterations=tracked_iterations, time_kernel=time_kernel,
        errs=errs, fk=fk, scene_kernels=scene_kernels,
        scene_paths=scene_paths, smoke_paths=smoke_paths, card=card))
    k2_err = max(k2_err, ml_k2_err)
    torch.cuda.empty_cache()

    # 32. the multi-device module and the repairs C.1-C.2
    md_numbers, md_smoke, md_flip, md_scene = multi_device_phase(
        torch, dev, _Helpers(every_kernel=every_kernel))
    smoke_paths.update(md_smoke)
    flip_paths.update(md_flip)
    scene_paths.update(md_scene)

    # 33. every scene of scenes/ the port runs, unedited, on the card
    sc_numbers, sc_paths, sc_fk, sc_k2_err = scenes_phase(
        torch, dev, _Helpers(every_kernel=every_kernel))
    scene_paths.update(sc_paths)
    k2_err = max(k2_err, sc_k2_err)

    # 34. the fork's experiment: scenes/run.py and scenes/zflip.py
    zf_numbers, zf_paths = zflip_phase(
        torch, dev, _Helpers(every_kernel=every_kernel))
    scene_paths.update(zf_paths)

    # 35. the exact-gather advection's passes on the developed plume
    ex_numbers, ex_timings = exact_advect_phase(
        torch, dev, _Helpers(every_kernel=every_kernel))

    # the smoke paths: the bench path (phase 2) and phases 17-19's
    smoke_paths = {"smoke_128": launches, **smoke_paths}
    # the 2D plume's passes, on one device and on the mesh, are K1's 2D
    # instance
    k1_2d_by_path = {k: v["window_advect"] for k, v in smoke_paths.items()
                     if k.startswith("plume2d")}
    k1_3d_by_path = {k: v["window_advect"] for k, v in smoke_paths.items()
                     if k not in k1_2d_by_path}
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
         "launches": sum(k1_2d_by_path.values()),
         "launches_by_path": k1_2d_by_path,
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
         "launches": sum(v["window_advect_zshard"]
                         for v in smoke_paths.values()),
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
         "kepsilon_channel_solve": fk["cg_solve_kepsilon"],
         "flip06_128_solve": fk["cg_solve_flip06"],
         "mlflip_128_solve": fk["cg_solve_mlflip"],
         "scene_solves": {k: v for k, v in sc_fk.items()
                          if k.startswith("cg_solve")}},
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
            # the kernel's other instances: held and timed in phase 7, on
            # no main path (the port's FLIP steps blend and stop)
            # (advect_pallas, and the kernel's stop_in_obstacle=False)
            for form, inst, line in (
                    ("no_blend", "<false,false,true>", 990),
                    ("no_stop", "<false,true,false>", 80)):
                entry[f"{form}_form"] = {
                    "name": f"advect_bucket_{form}", "route": "cuda",
                    "source": entry["source"], "replaces": f"{fbp}:{line}",
                    "instance": "advect_live_kernel" + inst, "launches": 0,
                    "max_abs_err": forms_err[form],
                    "bitwise": forms_bitwise[form], "library_ms": None,
                    **fk[f"advect_bucket_{form}"]}
        if kind == "extrap_layer":
            entry["flat_path"] = fk["extrap_layer_flat"]
            entry["karman_3d_path"] = fk["extrap_layer_karman"]
            entry["flip06_128_path"] = fk["extrap_layer_flip06"]
            entry["mlflip_128_path"] = fk["extrap_layer_mlflip"]
            entry["scene_paths"] = {k: v for k, v in sc_fk.items()
                                    if k.startswith("extrap_layer")}
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
            "replaces": repl,
            "launches": sum(v.get(name, 0) for v in flip_paths.values()),
            "launches_by_path": {k: v.get(name, 0)
                                 for k, v in flip_paths.items()},
            "max_abs_err": errs[name], "library_ms": None, **zk[name]})
    # the exact-gather advection's passes: replace no TPU kernel (the JAX
    # package runs its exact gathers in XLA)
    ex_paths = {**smoke_paths, **scene_paths}
    for name in EXACT_PER_STEP:
        # each instance's time, own bound and error; the entry's ms and
        # bound over one launch of each
        inst = {k: v for k, v in ex_timings.items() if k.startswith(name)}
        kernels.append({
            "name": name, "route": "cuda",
            "source": "mantaflow_tpu_torch/csrc/advect_exact.cu",
            "replaces": None,
            "launches": sum(v.get(name, 0) for v in ex_paths.values()),
            "launches_by_path": {k: v.get(name, 0)
                                 for k, v in ex_paths.items()
                                 if v.get(name, 0)},
            "max_abs_err": max(v["max_abs_err"] for v in inst.values()),
            "library_ms": None,
            "ms": sum(v["ms"] for v in inst.values()),
            "bound_ms": sum(v["bound_ms"] for v in inst.values()),
            "bound_by": "bytes", "step_bound_ms": EXACT_BOUND_US / 1e3,
            "instances": inst})
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
        "breadth_ops": a13, "ml_toolbox": ml_numbers,
        "multi_device": md_numbers, "scenes": sc_numbers,
        "zflip": zf_numbers, "exact_advect": ex_numbers,
        "build_s": build_s,
        "total_s": time.perf_counter() - t_start}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--scene-twin"]:
        scene_twin_main(sys.argv[2:])
    elif sys.argv[1:2] == ["--zflip-twin"]:
        zflip_twin_main(sys.argv[2:])
    elif sys.argv[1:2] == ["--zflip-child"]:
        zflip_child_main(sys.argv[2:])
    else:
        main()
