#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's smoke step on one GPU and check it.

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
   system after a few steps in full and unit mode, and a 128^3 system with
   an obstacle sphere and an empty (Dirichlet) slab;
5. the port on the card against the port on the CPU, 3 steps at 32^3.

Prints the card, a ``{"kernels": [...]}`` line and a timing line, and as its
last line ``{"ok": true, "device": {...}}``. Needs one CUDA device.
"""

import json
import subprocess
import sys
import time

RES = 128
K = 3  # window: the bench's CFL bound
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (data sheet)
FP32_OPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores


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


def kernel_device_ms(torch, fn, reps, kernel):
    """Mean device milliseconds per launch of the CUDA kernel whose name
    contains ``kernel``, from a torch.profiler trace of reps runs of fn():
    the kernel's own time, without the host's launch gaps."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us, count = 0.0, 0
    for e in prof.key_averages():
        if kernel in e.key:
            us += getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0.0))
            count += e.count
    require(count > 0 and us > 0, f"profiler saw no device time of {kernel}")
    return us / 1e3 / count


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    import numpy as np

    from mantaflow_tpu_torch.core import flags as fl
    from mantaflow_tpu_torch.core import mac as macops
    from mantaflow_tpu_torch.core.domain import Domain
    from mantaflow_tpu_torch.core.shapes import Sphere
    from mantaflow_tpu_torch.kernels import _build
    from mantaflow_tpu_torch.models import smoke
    from mantaflow_tpu_torch.ops import advection_kernels as advk
    from mantaflow_tpu_torch.ops import extforces as ext
    from mantaflow_tpu_torch.ops import pressure as prs
    from mantaflow_tpu_torch.ops import pressure_kernels as prk
    from mantaflow_tpu_torch.ops.advection import _cell_centers
    from mantaflow_tpu_torch.ops.advection_fast import window_interp

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

    k1_ms = kernel_device_ms(torch, run_passes(advk.window_pass), 20,
                             "window_advect_kernel")
    k1_call_ms = cuda_ms(torch, run_passes(advk.window_pass), 20) / len(passes)
    k1_plain_ms = cuda_ms(torch, run_passes(window_interp), 1) / len(passes)
    n = dom.num_cells
    k1_bytes = sum(n * (16 + (1 if o is not None else 0)
                        + (4 + (9 if mm else 0))) for *_, o, mm in passes)
    k1_bytes /= len(passes)
    k1_ops = n * 60  # 3 axis setups (~8 each) + 8-corner blend (~36)
    k1_bound_bytes = k1_bytes / HBM_BYTES_PER_S * 1e3
    k1_bound_ops = k1_ops / FP32_OPS_PER_S * 1e3

    # -- 4. CG kernel vs plain CG -------------------------------------------
    def cg_check(rhs, stencil, fluid, acc, max_iter, dom_):
        p_ref, it_ref, _ = prs.cg_plain(rhs, stencil, dom_, acc, max_iter,
                                        fluid)
        scale = float(p_ref.abs().max()) + 1e-30
        worst = 0.0
        for unit in (False, True):
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

    ob_flags = fl.fill_grid(fl.init_domain(dom, 1, device=dev))
    sphere = ((xx - 0.3 * RES) ** 2 + (yy - 0.2 * RES) ** 2
              + (zz - 0.5 * RES) ** 2).sqrt() < 0.12 * RES
    ob_flags = torch.where(sphere, fl.TypeObstacle, ob_flags)
    slab = (yy > 0.8 * RES) & fl.is_fluid(ob_flags)
    ob_flags = torch.where(slab, fl.TypeEmpty, ob_flags)
    g = torch.Generator(device="cpu").manual_seed(7)
    ob_vel = (torch.randn((3,) + dom.shape, generator=g) * 0.1).to(dev)
    k2_err = max(k2_err, cg_check(
        prs.make_rhs(ob_flags, ob_vel, dom),
        prs.make_laplace_stencil(ob_flags, dom), fl.is_fluid(ob_flags),
        1e-4, max_iter * 12, dom))

    cg_iters = {}

    def cg_kernel_run():
        cg_iters["k"] = prk.cg_solve(rhs, stencil, dom, params.cg_accuracy,
                                     max_iter)[1]

    def cg_plain_run():
        cg_iters["p"] = prs.cg_plain(rhs, stencil, dom, params.cg_accuracy,
                                     max_iter, fluid)[1]

    k2_ms = kernel_device_ms(torch, cg_kernel_run, 5, "cg_kernel")
    k2_call_ms = cuda_ms(torch, cg_kernel_run, 5)
    k2_plain_ms = cuda_ms(torch, cg_plain_run, 1)
    k2_it = int(cg_iters["k"])
    k2_bound_bytes = 6 * 4 * n / HBM_BYTES_PER_S * 1e3  # rhs, A0-Ak in; p out
    k2_bound_ops = k2_it * 24 * n / FP32_OPS_PER_S * 1e3  # 24 flops/cell/it
    # what one iteration of this three-phase design streams when no field
    # stays in L2: stencil (s, A0-Ak in, tmp out), update (p, s, r, tmp in;
    # p, r out), direction (r, s in; s out): 15 fields
    k2_iter_stream_ms = 15 * 4 * n / HBM_BYTES_PER_S * 1e3

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

    kernels = [
        {"name": "window_advect", "route": "cuda",
         "source": "mantaflow_tpu_torch/csrc/window_advect.cu",
         "replaces": "mantaflow_tpu/ops/advection_pallas.py:284",
         "launches": launches["window_advect"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms,
         "bound_ms": max(k1_bound_bytes, k1_bound_ops),
         "bound_by": "bytes" if k1_bound_bytes >= k1_bound_ops
         else "operations", "library_ms": None, "call_ms": k1_call_ms},
        {"name": "cg_solve", "route": "cuda",
         "source": "mantaflow_tpu_torch/csrc/cg_solve.cu",
         "replaces": "mantaflow_tpu/ops/pressure_pallas.py:88",
         "launches": launches["cg_solve"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms,
         "bound_ms": max(k2_bound_bytes, k2_bound_ops),
         "bound_by": "bytes" if k2_bound_bytes >= k2_bound_ops
         else "operations", "library_ms": None,
         "call_ms": k2_call_ms, "iterations": k2_it,
         "ms_per_iteration": k2_ms / max(k2_it, 1),
         "iteration_stream_bound_ms": k2_iter_stream_ms},
    ]
    print(card)
    print(json.dumps({
        "smoke_128": {"steps_per_s_cold": cold_sps,
                      "steps_per_s_developed": dev_sps,
                      "cg_iters_per_step_cold": cold_it,
                      "cg_iters_per_step_developed": dev_it,
                      "density_max": dmax},
        "build_s": build_s, "total_s": time.perf_counter() - t_start}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
