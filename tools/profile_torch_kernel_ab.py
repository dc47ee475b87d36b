#!/usr/bin/env python3
"""Time the CG (K2), union-levelset (K12), particle-to-grid (K10, its
z-slab form, K11) kernels, the rebin (one device and z-sharded) and the
bucket advection (K3, its z-slab form) of this checkout against another
checkout's, on the same inputs, on one GPU.

    git archive <commit> | tar -x -C build/ab_other
    python3 tools/profile_torch_kernel_ab.py --other build/ab_other \
        [--order other,this,this,other] [--reps 5] [--only k3] \
        [--extra NAME=PATH ...]

The inputs come from this checkout, on the card: the 128^3 bench smoke
system after 5 steps (chip_smoke.py phase 4: full-stencil mode, accuracy
1e-3, 192 iterations at most); three 128^3 dams developed through
flip_run_bucketed_auto for 70 steps (PPC escalated): the bench's
ghost-fluid dam (chip_smoke.py phase 6), the same dam without ghost fluid
(phase 9, flip01) and the obstacle dam (phase 10: radius_factor 2.5, the
sphere obstacle); the bench dam's buckets cut into 4 z-slabs, each
extended by one plane of each neighbour (phase 13); and the input of the
developed bench dam's rebin, its buckets after one more advection. Each
checkout times its wrappers with CUDA events over ``--reps`` calls, after
one warm call (the transfer and the rebin first, in three rounds over
their inputs in turn, whose median it keeps; a process's first round
reads up to 3x slow):
``cg_solve`` on the smoke system and the obstacle step's ghost-fluid
system, and on an 8^3 system run for 2000 iterations (accuracy 0), which
is its grid barriers and reductions with next to no cells;
``union_levelset`` on the obstacle dam at radius_factor 1.0, 1.5 and 2.5
(windows of 1, 2 and 3 cells); ``p2g_union`` (K10) on the bench dam,
``p2g_union_slab`` on the four slabs (per launch), ``p2g_mac`` (K11) on
the flip01 and the obstacle dams; ``rebin_kernels.rebin`` (the step's
rebin, whatever kernels the checkout runs it through) on the advected
bench dam, and ``rebin_kernels.rebin_zshard`` on its 4 z-slabs (per step:
the halo copies and every launch); the step's advection (each
checkout's step form: ``advect_blend_live`` where it has one, else
``advect_blend``) on the developed bench dam, the obstacle dam (its
flags-at-position probes), the cold dam at PPC 10 (three steps in) and,
per launch, the bench dam's 4 z-slabs (``advect_blend_slab_live``, else
``advect_blend_slab``), and the form that passes invalid slots through
(``advect_blend``) on the bench dam. Untimed, K10 and K11 also run on the
made-up buckets of the ``gpu`` case ``test_p2g_kernels_synthetic_buckets``
(tests/test_torch_flip_kernels.py: 19x23x29, 1 to 40 slots, random, empty
and full fills, made-up velocities; its generator is imported, so the
inputs are the test's). The inputs are saved to a file; then each checkout
of ``--order`` runs in a process of its own, which imports that checkout's
``mantaflow_tpu_torch`` and builds its kernels. Prints one JSON line per
run, the max |difference| of the transfer's and the rebin's outputs
between the two checkouts (a change in the order of the transfer's sums
shows as a number; the rebin's are 0 where it is bitwise equal,
``dropped`` included; the advection's over the live slots, 0 where it
is bitwise equal) and between two runs of one checkout, each
checkout's max |error| against the plain version on the made-up buckets
(vel, weight, phi, and the weight's error over 1e-6 of itself), and a
summary line: per checkout, the mean over its runs of each time.
``--extra NAME=PATH`` adds a checkout under that name for ``--order``
(a design variant, tools/make_advect_variant.py); ``--only k3`` times the
advection alone.

``--only k2`` times the CG kernel alone, on the benchmark's systems
(``benchmark/``: its cells run from ``--seed`` through one episode, the
episode's last solve kept): the developed plume112 solve
(``plume112.exact``), the flat and the bucketed dams' (``flip01_128.flat``,
``flip01_128.bucketed24``), and the plume's system again with one wall
link stored as -0.0 (the same system, which a kernel that packs its
stencil must read as floats); each checkout also solves the plume's system
in unit mode, and Laplace systems at 8^3, 64^2 and 48^3 (and 48^3 with
one diagonal no packed stencil holds) for 2000 iterations each. Each
solve's result carries the wall clock it ended at, to set beside a log of
the card's clocks. The pairs print the max |difference| of p, the
iterations and the residual norm (0 where they are equal), and each
checkout's run its kernel's tally where it has one.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUCKET_FIELDS = ("px", "py", "pz", "vx", "vy", "vz", "valid", "dropped")
ZSHARDS = 4
# the (ppc, fill) cases of test_p2g_kernels_synthetic_buckets
SYNTHETIC = ((1, "random"), (24, "random"), (40, "random"), (24, "empty"),
             (40, "full"))
SYNTHETIC_SIZE = (19, 23, 29)
FIELDS6 = BUCKET_FIELDS[:6]


def k3_call(args, kwargs, slab):
    """An advection call's arguments as tensors and numbers: one domain,
    (bk, flags, vel, vel_old, dt, pending, flip_ratio, dom) with the mode
    and ring_only as keywords (models/flip.py); a slab, (bk, obs, vel,
    vel_old, dt, pending, flip_ratio, dom, z_base, mode) with ring_only
    after them or as a keyword."""
    import torch
    if slab:
        bk, obs, vel, vold, dt, pend, fr, _, z_base, mode, *ring = args
        ring = ring[0] if ring else kwargs["ring_only"]
        grid = {"obs": obs, "z_base": z_base}
    else:
        bk, flags, vel, vold, dt, pend, fr, _ = args
        mode, ring = kwargs["integration_mode"], kwargs["ring_only"]
        grid = {"flags": flags}
    return {"buckets": {f: getattr(bk, f) for f in BUCKET_FIELDS},
            "vel": vel, "vel_old": vold, "dt": torch.as_tensor(dt),
            "pending": torch.as_tensor(pend), "flip_ratio": float(fr),
            "mode": int(mode), "ring_only": bool(ring), **grid}


def cuda_ms(torch, fn, reps):
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


def make_inputs(path, only):
    sys.path.insert(0, HERE)
    import torch
    from mantaflow_tpu_torch.core import flags as fl
    from mantaflow_tpu_torch.core.domain import Domain
    from mantaflow_tpu_torch.core.shapes import Sphere
    from mantaflow_tpu_torch.models import flip, smoke
    from mantaflow_tpu_torch.ops import advect_bucket_kernels as advk
    from mantaflow_tpu_torch.ops import extforces as ext
    from mantaflow_tpu_torch.ops import flip_bucket as fb
    from mantaflow_tpu_torch.ops import pressure as prs
    from mantaflow_tpu_torch.ops import pressure_kernels as prk
    from mantaflow_tpu_torch.ops import rebin_kernels as rbk
    from mantaflow_tpu_torch.parallel import sharding as shd

    dev = torch.device("cuda")
    res = 128
    params = smoke.SmokeParams(buoyancy=(0.0, -6e-4, 0.0),
                               vorticity_confinement=0.1, cg_accuracy=1e-3,
                               window=3, use_pallas=True, adaptive_dt=True,
                               cfl=3.0, dt_max=2.0)
    dom = Domain(size=(res,) * 3, dim=3)
    st = smoke.make_smoke_state(
        dom, params, source_shape=Sphere(center=(res / 2.0, res * 0.1,
                                                 res / 2.0),
                                         radius=res * 0.14), device=dev)
    for _ in range(5):
        st = smoke.smoke_step(st, dom, params)
    vel = ext.add_buoyancy(st.flags, st.density, st.vel, params.buoyancy,
                           st.ts.dt, dom)
    vel = ext.vorticity_confinement(vel, st.flags, dom,
                                    params.vorticity_confinement)
    out = {"smoke": {"rhs": prs.make_rhs(st.flags, vel, dom),
                     "stencil": prs.make_laplace_stencil(st.flags, dom),
                     "acc": params.cg_accuracy,
                     "max_iter": int(params.cg_max_iter_fac * res)}}

    def developed(fparams, obstacle=None):
        fst = flip.make_dam_state_bucketed(dom, fparams, ppc=10,
                                           obstacle=obstacle, device=dev)
        for _ in range(7):
            fst = flip.flip_run_bucketed_auto(fst, dom, fparams, 10,
                                              check_every=10)
        return fst

    info = {}
    bench = dict(gravity=(0.0, -0.003, 0.0), cg_accuracy=1e-3)
    for name, kw in (("bench", dict(ghost_fluid=True,
                                    ring_only_obstacles=True)),
                     ("flip01", dict(ghost_fluid=False,
                                     ring_only_obstacles=True))):
        fparams_ = flip.FlipParams(**bench, **kw)
        fst_ = developed(fparams_)
        if name == "bench":
            bench_state, bench_params = fst_, fparams_
        bk = fst_.buckets
        out[name] = {f: getattr(bk, f) for f in BUCKET_FIELDS}
        info[name] = {"ppc": bk.ppc, "live": int(bk.valid.sum()),
                      "dropped": int(bk.dropped)}
    mesh = shd.make_zmesh(ZSHARDS, devices=[dev])
    ext = rbk.halo_buckets(
        shd.shard_buckets(fb.Buckets(**out["bench"]), mesh).slabs, 1,
        Domain(size=(res, res, res // ZSHARDS)))
    out["slabs"] = [{f: getattr(e, f) for f in BUCKET_FIELDS} for e in ext]
    # the rebin's input in one more step of the developed bench dam
    rebin_in, rebin = [], rbk.rebin

    def rec_rebin(bk_, dom_):
        rebin_in.append(bk_)
        return rebin(bk_, dom_)
    rbk.rebin = rec_rebin
    try:
        flip.flip_step_bucketed(bench_state, dom, bench_params)
    finally:
        rbk.rebin = rebin
    (adv,) = rebin_in
    out["rebin"] = {f: getattr(adv, f) for f in BUCKET_FIELDS}
    info["rebin"] = {"ppc": adv.ppc, "live": int(adv.valid.sum())}
    # the advection's inputs: one step of each dam, its call recorded
    k3 = out["k3"] = {}

    def record_advection(st, fparams_, zshard=None):
        name = "advect_blend_slab_live" if zshard else "advect_blend_live"
        calls, orig = [], getattr(advk, name)

        def rec(*args, **kwargs):
            calls.append((args, kwargs))
            return orig(*args, **kwargs)
        rec.launches = 0  # the wrapper counts on the module's name
        setattr(advk, name, rec)
        try:
            flip.flip_step_bucketed(st, dom, fparams_, zshard=zshard)
        finally:
            setattr(advk, name, orig)
        return [k3_call(args, kwargs, zshard is not None)
                for args, kwargs in calls]
    k3["bench"], = record_advection(bench_state, bench_params)
    mesh4 = shd.make_zmesh(ZSHARDS, devices=[dev])
    k3["slabs"] = record_advection(
        shd.shard_flip_bucket_state(bench_state, mesh4), bench_params, mesh4)
    cold = flip.make_dam_state_bucketed(dom, bench_params, ppc=10,
                                        device=dev)
    for _ in range(3):
        cold = flip.flip_step_bucketed(cold, dom, bench_params)
    k3["cold"], = record_advection(cold, bench_params)
    del cold
    for name in ("bench", "cold"):
        info[f"k3_{name}"] = {"ppc": k3[name]["buckets"]["valid"].shape[0],
                              "live": int(k3[name]["buckets"]["valid"].sum())}
    fparams = flip.FlipParams(gravity=(0.0, -0.003, 0.0), ghost_fluid=True,
                              radius_factor=2.5, cg_accuracy=1e-3)
    obstacle = Sphere(center=(res * 0.7, res * 0.28, res * 0.5),
                      radius=res * 0.15)
    fst = developed(fparams, obstacle)
    k3["obstacle"], = record_advection(fst, fparams)
    calls = []
    orig = prk.cg_solve

    def rec(*args, **kwargs):
        calls.append((args, kwargs))
        return orig(*args, **kwargs)
    rec.launches = 0  # the wrapper counts its launches on the module's name
    prk.cg_solve = rec
    try:
        flip.flip_step_bucketed(fst, dom, fparams)
    finally:
        prk.cg_solve = orig
    (args, _), = calls
    bk = fst.buckets
    out["obstacle"] = {
        "rhs": args[0], "stencil": args[1], "acc": args[3],
        "max_iter": args[4], "ppc": bk.ppc, "live": int(bk.valid.sum()),
        "buckets": {f: getattr(bk, f) for f in BUCKET_FIELDS}}
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from test_torch_flip_kernels import _synthetic_moving
    out["synthetic"] = {
        f"{ppc}_{fill}": {f: getattr(b_, f) for f in BUCKET_FIELDS}
        for ppc, fill in SYNTHETIC
        for b_ in [_synthetic_moving(SYNTHETIC_SIZE, ppc, fill, dev)[1]]}
    info["obstacle"] = {"ppc": bk.ppc, "live": out["obstacle"]["live"]}
    # --only k3: the advection's inputs alone go to the timing processes
    torch.save({"k3": out["k3"]} if only == "k3" else out, path)
    return {"ppc": bk.ppc, "live": info["obstacle"]["live"],
            "particles_kept": int(bk.count()), "dropped": int(bk.dropped),
            "fluid_cells_smoke": int(fl.is_fluid(st.flags).sum()), **info}


K2_CELLS = (("plume", "plume112.exact"), ("flat", "flip01_128.flat"),
            ("bucketed", "flip01_128.bucketed24"))
CG_FIELDS = ("p", "iterations", "resnorm")


def make_k2_inputs(path, seed):
    """The last pressure solve of one episode of each of K2_CELLS, as
    cg_solve was called, and the plume's with a -0.0 wall link."""
    sys.path[:0] = [os.path.join(HERE, "benchmark"), HERE]
    import torch
    from harness import spec
    from mantaflow_tpu_torch.ops import pressure_kernels as prk

    dev = torch.device("cuda")
    out, info = {}, {}
    orig = prk.cg_solve
    for name, cell_name in K2_CELLS:
        cell = spec.load_cell(cell_name)
        fam = spec.family(cell.config["family"]).Family(
            cell.config, cell.traffic, seed, dev)
        fam.setup()
        last = {}

        def rec(rhs, stencil, dom, acc, max_iter, fluid=None, **kw):
            with torch.inference_mode(False):
                last.update(rhs=rhs.clone(),
                            stencil=[a.clone() for a in stencil],
                            fluid=fluid.clone(), size=tuple(dom.size),
                            acc=float(acc), max_iter=int(max_iter))
            return orig(rhs, stencil, dom, acc, max_iter, fluid=fluid, **kw)
        rec.launches = 0  # the wrapper counts its launches on the module's name
        prk.cg_solve = rec
        try:
            state = fam.initial()
            for n in fam.calls():
                state = fam.call(state, n)
            torch.cuda.synchronize()
        finally:
            prk.cg_solve = orig
        del state, fam
        out[name] = last
        info[name] = {"size": last["size"], "max_iter": last["max_iter"],
                      "fluid": int(last["fluid"].sum())}
    neg = dict(out["plume"])
    ai = neg["stencil"][1].clone()
    if float(ai[0, 0, 0]) != 0.0:
        raise RuntimeError("the plume's corner link is not zero")
    ai[0, 0, 0] = -0.0
    neg["stencil"] = [neg["stencil"][0], ai] + neg["stencil"][2:]
    out["plume_negzero"] = neg
    torch.save({"k2": out}, path)
    return info


def time_k2(inp, reps, res, outs):
    """Each system's solve, timed; p, the iterations and the residual norm
    into outs."""
    import torch
    from mantaflow_tpu_torch.core.domain import Domain
    from mantaflow_tpu_torch.ops import pressure_kernels as prk

    def timed(name, c, **kw):
        dom_ = Domain(size=c["size"])
        got = {}

        def solve():
            got["out"] = prk.cg_solve(c["rhs"], tuple(c["stencil"]), dom_,
                                      c["acc"], c["max_iter"],
                                      fluid=c["fluid"], **kw)
        ms = cuda_ms(torch, solve, reps)
        it = int(got["out"][1])
        res[f"cg_{name}"] = {"ms": ms, "iterations": it,
                             "us_per_iteration": ms * 1e3 / max(it, 1),
                             "resnorm": float(got["out"][2]),
                             "at": time.time()}
        outs[f"cg_{name}"] = list(got["out"])
    for name, c in inp["k2"].items():
        timed(name, c)
    timed("plume_unit", inp["k2"]["plume"], unit_stencil=True)
    tally = getattr(prk, "cg_tally", None)
    res["cg_tally"] = list(tally()) if tally else None


def time_checkout(repo, path, reps, out_path, only):
    sys.path.insert(0, os.path.abspath(repo))
    import torch
    import mantaflow_tpu_torch
    from mantaflow_tpu_torch.core.domain import Domain
    from mantaflow_tpu_torch.kernels import _build
    from mantaflow_tpu_torch.ops import pressure_kernels as prk

    where = os.path.dirname(os.path.abspath(mantaflow_tpu_torch.__file__))
    assert where == os.path.join(os.path.abspath(repo), "mantaflow_tpu_torch")
    _build.build()
    inp = torch.load(path)
    dom = Domain(size=(128,) * 3)
    res = {"repo": repo}
    timed, outs = {}, {}
    if only == "k2":
        time_k2(inp, reps, res, outs)
    if only != "k2":
        time_non_k2(inp, reps, res, outs, timed, dom, only)
    if only != "k3":
        # Laplace systems that never converge, 2000 iterations: at 8^3 what
        # the grid barriers and reductions cost per iteration with next to
        # no cells; 64^2 (2D) and 48^3 the sizes of the scenes' small
        # solves; 48^3 again with one diagonal of 6.5, which no packed
        # stencil holds
        for name, size, dim in (("8cubed", (8, 8, 8), 3),
                                ("64x64", (64, 64, 1), 2),
                                ("48cubed", (48, 48, 48), 3),
                                ("48cubed_float", (48, 48, 48), 3)):
            tiny = Domain(size=size, dim=dim)
            trhs = torch.ones(tiny.shape, device="cuda")
            tst = (torch.full(tiny.shape, 2.0 * dim, device="cuda"),) + tuple(
                torch.full(tiny.shape, -1.0 if ax < dim else 0.0,
                           device="cuda") for ax in range(3))
            if name.endswith("_float"):
                tst[0][0, 0, 0] = 6.5
            tiny_ms = cuda_ms(
                torch, lambda: prk.cg_solve(trhs, tst, tiny, 0.0, 2000), 3)
            res[f"cg_{name}_us_per_iteration"] = tiny_ms * 1e3 / 2000
    torch.save({k: [t.cpu() for t in v] for k, v in outs.items()}, out_path)
    print(json.dumps(res), flush=True)


def time_non_k2(inp, reps, res, outs, timed, dom, only):
    """The transfer's, the rebin's, the advection's, the levelset's and
    the CG's timings of --only all and k3."""
    import torch
    from mantaflow_tpu_torch.core.domain import Domain
    from mantaflow_tpu_torch.ops import advect_bucket_kernels as advk
    from mantaflow_tpu_torch.ops import flip_bucket as fb
    from mantaflow_tpu_torch.ops import levelset_kernels as lsk
    from mantaflow_tpu_torch.ops import p2g_kernels as p2gk
    from mantaflow_tpu_torch.ops import pressure_kernels as prk
    from mantaflow_tpu_torch.ops import rebin_kernels as rbk
    from mantaflow_tpu_torch.parallel import sharding as shd
    if only != "k3":
        bk = fb.Buckets(**inp["obstacle"]["buckets"])
        # the transfer: K10 on the bench dam, its z-slab form on the bench
        # dam's four slabs, K11 on the flip01 and obstacle dams
        bench = fb.Buckets(**inp["bench"])
        slabs = [fb.Buckets(**e) for e in inp["slabs"]]
        lz = 128 // len(slabs)

        def k10():
            outs["k10"] = p2gk.p2g_union(bench, dom, 1.0)

        def k10_zshard():
            outs["k10_zshard"] = [p2gk.p2g_union_slab(e, dom, i * lz, 1.0)
                                  for i, e in enumerate(slabs)]
        adv = fb.Buckets(**inp["rebin"])
        mesh = shd.make_zmesh(len(slabs), devices=[adv.px.device])
        adv_sharded = shd.shard_buckets(adv, mesh)

        def rebin():
            outs["rebin"] = rbk.rebin(adv, dom)

        def rebin_zshard():
            outs["rebin_zshard"] = shd.unshard_buckets(
                rbk.rebin_zshard(adv_sharded, dom, mesh))
        timed.update({"p2g_levelset": (k10, 1),
                      "p2g_levelset_zshard": (k10_zshard, len(slabs)),
                      "rebin": (rebin, 1),
                      "rebin_zshard_step": (rebin_zshard, 1)})
        for name, b_ in (("flip01", fb.Buckets(**inp["flip01"])),
                         ("obstacle", bk)):
            def k11(b_=b_, name=name):
                outs[f"k11_{name}"] = p2gk.p2g_mac(b_, dom)
            timed[f"p2g_mac_{name}"] = (k11, 1)
    # the advection: each checkout's step form, and the public form
    step_form = getattr(advk, "advect_blend_live", advk.advect_blend)
    slab_form = getattr(advk, "advect_blend_slab_live",
                        advk.advect_blend_slab)

    def k3_args(c):
        """(positional arguments, keywords) of one recorded call."""
        slab = "z_base" in c
        return ((fb.Buckets(**c["buckets"]),
                 c["obs"] if slab else c["flags"], c["vel"], c["vel_old"],
                 c["dt"], c["pending"], c["flip_ratio"], dom)
                + ((c["z_base"],) if slab else ()) + (c["mode"],),
                {"ring_only": c["ring_only"]})

    def live_fields(outs_, args_):
        """The six fields of the live slots, concatenated over the calls."""
        return [torch.cat([getattr(o, f)[a[0][0].valid]
                           for o, a in zip(outs_, args_)]) for f in FIELDS6]
    k3 = {name: k3_args(inp["k3"][name])
          for name in ("bench", "obstacle", "cold")}
    k3_slabs = [k3_args(c) for c in inp["k3"]["slabs"]]
    k3_outs = {}
    for name, a_ in k3.items():
        def k3_step(a_=a_, name=name):
            k3_outs[name] = [step_form(*a_[0], **a_[1])]
        timed[f"advect_{name}"] = (k3_step, 1)

    def k3_zshard():
        k3_outs["zshard"] = [slab_form(*a_[0], **a_[1]) for a_ in k3_slabs]
    timed["advect_zshard"] = (k3_zshard, len(k3_slabs))

    def k3_public():
        k3_outs["public"] = [advk.advect_blend(*k3["bench"][0],
                                               **k3["bench"][1])]
    timed["advect_public_bench"] = (k3_public, 1)
    # three rounds of reps calls each, in turn; the median per launch
    rounds = {k: [] for k in timed}
    for _ in range(3):
        for k, (fn, n) in timed.items():
            rounds[k].append(cuda_ms(torch, fn, reps) / n)
    for k, ms in rounds.items():
        res[f"{k}_ms"] = sorted(ms)[1]
        res[f"{k}_rounds_ms"] = ms
    torch.cuda.synchronize()
    for name, o in k3_outs.items():
        a_ = (k3_slabs if name == "zshard" else
              [k3["bench" if name == "public" else name]])
        outs[f"k3_{name}"] = live_fields(o, a_)
    # the public form passes the invalid slots through
    pub, (b_, *_) = k3_outs["public"][0], k3["bench"][0]
    res["advect_public_invalid_unchanged"] = all(
        torch.equal(getattr(pub, f)[~b_.valid], getattr(b_, f)[~b_.valid])
        for f in FIELDS6)
    if only == "k3":
        return
    for name in ("smoke", "obstacle"):
        c = inp[name]
        got = {}

        def solve():
            got["it"] = prk.cg_solve(c["rhs"], c["stencil"], dom, c["acc"],
                                     c["max_iter"])[1]
        ms = cuda_ms(torch, solve, reps)
        it = int(got["it"])
        res[f"cg_{name}"] = {"ms": ms, "iterations": it,
                             "us_per_iteration": ms * 1e3 / max(it, 1)}
    for rf in (1.0, 1.5, 2.5):
        rw = fb.levelset_radius(dom, rf)[1]
        res[f"levelset_rw{rw}_ms"] = cuda_ms(
            torch, lambda: lsk.union_levelset(bk, dom, rf), reps)
    sdom = Domain(size=SYNTHETIC_SIZE)
    for case, fields in inp["synthetic"].items():
        b_ = fb.Buckets(**fields)
        outs[f"syn{case}_k10"] = p2gk.p2g_union(b_, sdom, 1.0)
        outs[f"syn{case}_k11"] = p2gk.p2g_mac(b_, sdom)
    torch.cuda.synchronize()
    outs["k10_zshard"] = [torch.cat(o, dim=-3) for o in
                          zip(*outs["k10_zshard"])]
    for k in ("rebin", "rebin_zshard"):
        outs[k] = [getattr(outs[k], f) for f in BUCKET_FIELDS]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True)
    ap.add_argument("--order", default="other,this,this,other")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--only", choices=("all", "k3", "k2"), default="all")
    ap.add_argument("--seed", type=int, default=4240000001,
                    help="--only k2: the benchmark cells' seed")
    ap.add_argument("--extra", action="append", default=[],
                    help="NAME=PATH: another checkout for --order")
    ap.add_argument("--time", help=argparse.SUPPRESS)
    ap.add_argument("--inputs", help=argparse.SUPPRESS)
    ap.add_argument("--outputs", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.time:
        time_checkout(args.time, args.inputs, args.reps, args.outputs,
                      args.only)
        return
    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_torch_kernel_ab: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    repos = {"this": HERE, "other": args.other,
             **dict(e.split("=", 1) for e in args.extra)}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "inputs.pt")
        info = (make_k2_inputs(path, args.seed) if args.only == "k2"
                else make_inputs(path, args.only))
        print(json.dumps({"inputs": info}), flush=True)
        runs, saved = [], {}
        for i, which in enumerate(args.order.split(",")):
            out_path = os.path.join(tmp, f"outputs{i}.pt")
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--other",
                 args.other, "--time", repos[which], "--inputs", path,
                 "--outputs", out_path, "--reps", str(args.reps),
                 "--only", args.only],
                capture_output=True, text=True, check=True).stdout
            run = json.loads(out.strip().splitlines()[-1])
            run["which"] = which
            runs.append(run)
            saved.setdefault(which, []).append(out_path)
            print(json.dumps(run), flush=True)
        # the transfer's outputs: this checkout against the other, and two
        # runs of one checkout against each other
        pairs = {}
        for which in saved:
            if which != "this" and "this" in saved:
                pairs[f"this_vs_{which}"] = (saved["this"][0],
                                             saved[which][0])
        for which, paths in saved.items():
            if len(paths) > 1:
                pairs[f"{which}_vs_{which}"] = paths[:2]
        for pair, (pa, pb) in pairs.items():
            a, b = torch.load(pa), torch.load(pb)
            print(json.dumps({"max_abs_diff": pair, **{
                f"{k}_{n}": float((x.double() - y.double()).abs().max())
                for k in a if k in b for n, x, y in zip(
                    BUCKET_FIELDS if k.startswith("rebin")
                    else FIELDS6 if k.startswith("k3")
                    else CG_FIELDS if k.startswith("cg_")
                    else ("vel", "weight", "phi"), a[k], b[k])}}),
                flush=True)
        # the made-up buckets: each checkout against the plain version
        if args.only == "all":
            sys.path.insert(0, HERE)
            from mantaflow_tpu_torch.core.domain import Domain
            from mantaflow_tpu_torch.ops import flip_bucket as fb
            from mantaflow_tpu_torch.ops import p2g_kernels as p2gk
            sdom = Domain(size=SYNTHETIC_SIZE)
            inp = torch.load(path)
            plain = {}
            for case, fields in inp["synthetic"].items():
                b_ = fb.Buckets(**fields)
                plain[f"syn{case}_k10"] = [
                    t.cpu() for t in p2gk.p2g_union_plain(b_, sdom, 1.0)]
                plain[f"syn{case}_k11"] = [t.cpu()
                                           for t in fb.p2g_mac(b_, sdom)]
            for which, paths in saved.items():
                got = torch.load(paths[0])
                errs = {}
                for k, ref in plain.items():
                    for n, x, y in zip(("vel", "weight", "phi"), got[k], ref):
                        errs[f"{k}_{n}"] = float((x - y).abs().max())
                    w, rw = got[k][1], ref[1]
                    errs[f"{k}_weight_over_1e-6_rel"] = float(
                        ((w - rw).abs() - 1e-6 * rw.abs()).max())
                print(json.dumps({"vs_plain": which, **errs}), flush=True)
    summary = {}
    for which in repos:
        mine = [r for r in runs if r["which"] == which]
        if not mine:
            continue
        summary[which] = {k: (sum(r[k] for r in mine) / len(mine)
                              if not isinstance(mine[0][k], dict) else
                              {kk: sum(r[k][kk] for r in mine) / len(mine)
                               for kk in mine[0][k]})
                          for k in mine[0] if k not in ("repo", "which")
                          and not isinstance(mine[0][k], list)}
    print(card)
    print(json.dumps({"summary": summary, "card": card}))


if __name__ == "__main__":
    main()
