#!/usr/bin/env python3
"""Where the time of the port's 128^3 FLIP dam steps goes, on one GPU.

    python3 tools/profile_torch_flip.py [--path bench|flip01|obstacle|zshard
                                                |flat|apic]
                                        [--shards 4] [--res 128]
                                        [--develop 40] [--steps 10]
                                        [--chunks 3]

Builds one of chip_smoke.py's FLIP dams. On the bucketed layout, at PPC
10: ``bench`` (bench.py:84-86, ghost fluid, the fused transfer and
levelset), ``flip01`` (the same dam without ghost fluid,
scenes/flip01_simple.py: the transfer alone) or ``obstacle`` (a sphere
obstacle and radius_factor 2.5, a levelset window of 3 cells: the
transfer, then the levelset kernel); ``zshard`` is the bench dam developed
on one device, then cut into ``--shards`` z-slabs over every visible card
(``parallel/sharding.py``) and stepped with ``flip_step_bucketed(...,
zshard=mesh)``, its halo copies (``halo_z``, ``scatter_z``, ``gather_z``)
of one step recorded and timed on their own (CUDA events over 10
replays). On the flat layout (``make_dam_state``, ``flip_step``: particles
as (N, 3) tensors, bench.py:37-40): ``flat``, the bench dam, and ``apic``,
the same dam with APIC transfers (tests/test_flip_model.py:24); each
stage of their step is also read from the step's own spans over
``--steps`` more steps (``utils/trace.py``: CUDA events at the stages'
boundaries, nothing synchronised; the host's launch gaps inside a stage
are in its time).

It runs 1 warm step and ``--develop`` more through the dam's runner in
chunks of ``--steps`` (``flip_run_bucketed_auto``, where the PPC escalates,
then the bench's settle loop, bench.py:147-153: chunks until one ends at
an unchanged PPC; ``flip_run`` on the flat layout). It times ``--steps``
steps with CUDA events, then traces ``--steps`` more with torch.profiler
(device activity only, which keeps the tracer's host cost small), and
fails if a particle was lost in those windows. Last it times ``--chunks``
runner chunks of ``--steps`` steps each, as a user of the runner sees them
(CUDA events around the call; the bucketed runner ends in its host read
of ``dropped``; zshard has none, the runner takes no mesh). Prints one
JSON line: the untraced and traced wall ms per step, the runner chunks'
ms per step, the caching allocator's cudaMalloc/cudaFree calls (and
retries) in those windows, the device-busy ms per step (sum of kernel
times), the idle share of the traced window, and device ms per step of
each hand-written kernel and of everything else (PyTorch's own
elementwise, roll and reduction kernels: the glue), with the top kernels
by name.
"""

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

# kernel name in the trace -> group
GROUPS = {"advect_live_kernel<false,true,true>": "advect_bucket",
          "advect_live_kernel<true,true,true>": "advect_bucket_zshard",
          "rebin_fused_kernel<false>": "rebin_fused",
          "rebin_fused_kernel<true>": "rebin_fused_slab",
          "rebin_pass_kernel": "rebin",
          "rebin_zshard_kernel": "rebin_zshard",
          "p2g_levelset_kernel": "p2g_levelset",
          "p2g_levelset_zshard_kernel": "p2g_levelset_zshard",
          "p2g_mac_kernel": "p2g_mac",
          "union_levelset_kernel": "union_levelset",
          "extrap_layer_kernel": "extrap_layer",
          "cg_kernel": "cg_solve"}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--path", choices=("bench", "flip01", "obstacle",
                                       "zshard", "flat", "apic"),
                    default="bench")
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--develop", type=int, default=40)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--chunks", type=int, default=3)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_torch_flip: no CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from mantaflow_tpu_torch.core.domain import Domain
    from mantaflow_tpu_torch.core.shapes import Sphere
    from mantaflow_tpu_torch.models import flip
    from mantaflow_tpu_torch.parallel import sharding as shd

    res = args.res
    dom = Domain(size=(res, res, res), dim=3)
    flat = args.path in ("flat", "apic")
    mesh, copies, extra = None, {}, {}
    if flat:
        params = flip.FlipParams(gravity=(0.0, -0.003, 0.0),
                                 ghost_fluid=True, cg_accuracy=1e-3,
                                 ring_only_obstacles=True,
                                 apic=args.path == "apic")
        state = flip.make_dam_state(dom, params, discretization=2)
        particles = int(state.parts.count)

        def chunk(state):
            return flip.flip_run(state, dom, params, args.steps)

        def lost(state):
            return particles - int(state.parts.active_mask().sum())
        state = flip.flip_step(state, dom, params)
        state = flip.flip_run(state, dom, params, args.develop)
    else:
        obstacle = None
        if args.path == "obstacle":
            params = flip.FlipParams(gravity=(0.0, -0.003, 0.0),
                                     ghost_fluid=True, radius_factor=2.5,
                                     cg_accuracy=1e-3)
            obstacle = Sphere(center=(res * 0.7, res * 0.28, res * 0.5),
                              radius=res * 0.15)
        else:
            params = flip.FlipParams(gravity=(0.0, -0.003, 0.0),
                                     ghost_fluid=args.path != "flip01",
                                     cg_accuracy=1e-3,
                                     ring_only_obstacles=True)
        state = flip.make_dam_state_bucketed(dom, params, ppc=10,
                                             obstacle=obstacle)

        def chunk(state):
            return flip.flip_run_bucketed_auto(state, dom, params,
                                               args.steps,
                                               check_every=args.steps)
        state = flip.flip_step_bucketed(state, dom, params)
        if args.develop:
            state = flip.flip_run_bucketed_auto(state, dom, params,
                                                args.develop,
                                                check_every=args.steps)
            for _ in range(3):
                ppc_pre = state.buckets.ppc
                state = chunk(state)
                if state.buckets.ppc == ppc_pre:
                    break
        if args.path == "zshard":
            mesh = shd.make_zmesh(args.shards)
            state = shd.shard_flip_bucket_state(state, mesh)
            state = flip.flip_step_bucketed(state, dom, params, zshard=mesh)
            # the halo copies of one step, recorded, then replayed alone
            for name in ("halo_z", "scatter_z", "gather_z"):
                orig = getattr(shd, name)
                copies[name] = (orig, [])
                setattr(shd, name, lambda *a, _o=orig, _c=copies[name][1]:
                        (_c.append(a), _o(*a))[1])
            try:
                flip.flip_step_bucketed(state, dom, params, zshard=mesh)
            finally:
                for name, (orig, _) in copies.items():
                    setattr(shd, name, orig)
        dropped_before = int(state.buckets.dropped)

        def lost(state):
            return int(state.buckets.dropped) - dropped_before

    def step(state):
        if flat:
            return flip.flip_step(state, dom, params)
        return flip.flip_step_bucketed(state, dom, params, zshard=mesh)

    def run(state):
        iters = torch.zeros((), dtype=torch.int64, device="cuda")
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(args.steps):
            state = step(state)
            iters += state.cg_iters
        t1.record()
        torch.cuda.synchronize()
        return state, t0.elapsed_time(t1) / args.steps, \
            int(iters) / args.steps

    def allocator_calls():
        """cudaMalloc and cudaFree calls of PyTorch's caching allocator so
        far (each can wait for the card), and its retries after a failed
        allocation."""
        st = torch.cuda.memory_stats()
        return [st.get(k, 0) for k in ("num_device_alloc", "num_device_free",
                                       "num_alloc_retries")]

    steps_before = int(state.ts.count)
    alloc0 = allocator_calls()
    state, wall_ms, iters = run(state)
    alloc_timed = [b - a for a, b in zip(alloc0, allocator_calls())]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state, traced_wall_ms, traced_iters = run(state)
    if lost(state):
        sys.exit(f"profile_torch_flip: {lost(state)} particles lost in the "
                 "timed windows")
    if not flat:
        extra["ppc"] = state.buckets.ppc
    copies_ms = {}
    for name, (fn, calls) in copies.items():
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0.record()
        for _ in range(10):
            for a in calls:
                fn(*a)
        t1.record()
        torch.cuda.synchronize()
        copies_ms[name] = {"calls_per_step": len(calls),
                           "ms_per_step": t0.elapsed_time(t1) / 10}
    chunk_ms, alloc_chunks = [], []
    for _ in range(args.chunks if mesh is None else 0):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        alloc0 = allocator_calls()
        t0.record()
        state = chunk(state)
        t1.record()
        torch.cuda.synchronize()
        chunk_ms.append(t0.elapsed_time(t1) / args.steps)
        alloc_chunks.append([b - a for a, b in zip(alloc0,
                                                   allocator_calls())])
    if flat:
        state, extra["stage_ms_per_step"] = stage_times(step, state,
                                                        args.steps)
        extra["capacity"] = state.parts.capacity
    else:
        particles = int(state.buckets.count())
        extra.update(ppc_after_chunks=state.buckets.ppc, copies=copies_ms,
                     shards=mesh.n if mesh else None,
                     devices=[str(d) for d in mesh.devices] if mesh
                     else None)

    groups, kernels = trace_groups(prof, args.steps)
    busy_ms = sum(groups.values())
    if busy_ms <= 0:
        sys.exit("profile_torch_flip: the trace holds no device time")
    top = sorted(kernels, key=lambda k: -k[1])[:14]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(json.dumps({
        "card": card, "path": args.path, "res": res, "particles": particles,
        "steps_before": steps_before, "steps": args.steps, **extra,
        "wall_ms_per_step": wall_ms,
        "cg_iters_per_step": iters,
        "traced_wall_ms_per_step": traced_wall_ms,
        "traced_cg_iters_per_step": traced_iters,
        "runner_chunk_ms_per_step": chunk_ms,
        "allocator_calls_timed": alloc_timed,
        "allocator_calls_per_chunk": alloc_chunks,
        "allocator_conf": os.environ.get("PYTORCH_CUDA_ALLOC_CONF"),
        "device_busy_ms_per_step": busy_ms,
        "idle_share": 1.0 - busy_ms / traced_wall_ms,
        "device_ms_per_step": groups,
        "device_kernels_per_step": sum(c for _, _, c in kernels) / args.steps,
        "top_kernels": [{"name": k[:90], "ms_per_step": us / 1e3 / args.steps,
                         "calls_per_step": c / args.steps}
                        for k, us, c in top],
    }))


def trace_groups(prof, steps):
    """(groups, kernels): device ms per step of each hand-written kernel
    and of the rest, from a profiler trace of ``steps`` steps."""
    def dev_us(evt):
        return getattr(evt, "self_device_time_total",
                       getattr(evt, "self_cuda_time_total", 0.0))
    kernels = [(e.key, dev_us(e), e.count) for e in prof.key_averages()
               if dev_us(e) > 0]
    groups = dict.fromkeys(list(GROUPS.values()) + ["other"], 0.0)
    for key, us, _ in kernels:
        g = next((v for k, v in GROUPS.items()
                  if k in key.replace(", ", ",")), "other")
        groups[g] += us
    return {g: us / 1e3 / steps for g, us in groups.items()}, kernels


def stage_times(step, state, steps):
    """The step's stages over ``steps`` steps, from its own spans. Returns
    (state, device ms per step of each stage)."""
    from mantaflow_tpu_torch.utils import trace
    trace.reset()
    trace.enable()
    for _ in range(steps):
        state = step(state)
    trace.disable()
    stage_ms = {name: s["calls"] * s["device_ms"] / steps
                for name, s in trace.summary().items()
                if name != "flip.step"}
    trace.reset()
    return state, stage_ms


if __name__ == "__main__":
    main()
