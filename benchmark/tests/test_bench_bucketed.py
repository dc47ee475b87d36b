"""The bucketed dam's cell (``flip01_128.bucketed24``) on the CPU at a test's
size: a whole run reads correct; the plain reference's reading of a bucketed
state (``plainref/buckets.py``) followed by its flat FLIP step equals the
port's plain bucketed step, from a state with the blend pending and without;
a broken step and the control (the reference in bfloat16) read not correct;
``roofline/buckets.py`` counts a hand-built store's bytes."""

import dataclasses

import pytest
import torch

import bench_paths  # noqa: F401  (the import path)
import control
from harness import main as hm
from harness import spec
from roofline import buckets as rb

CELL = "flip01_128.bucketed24"
RES, STEPS = 16, 18


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def small_cell(res: int = RES, steps: int = STEPS):
    """The cell with its grid scaled to ``res`` cells in x (the other sides
    in proportion) and ``steps`` steps an episode."""
    cell = spec.load_cell(CELL)
    sx = cell.config["res"][0]
    cfg = dict(cell.config, res=[round(n * res / sx)
                                 for n in cell.config["res"]],
               episode_steps=steps)
    return dataclasses.replace(cell, config=cfg)


def family(seed: int = 11):
    cell = small_cell()
    fam = spec.family(cell.config["family"]).Family(
        cell.config, cell.traffic, seed, "cpu")
    fam.setup()
    return fam


def test_cell_run_is_correct_on_the_cpu():
    cell = small_cell()
    res = hm.run_cell(cell, 2 ** 31 + 12345, 0.0, False, device="cpu")
    checks = {k: c["value"] for k, c in res["checks"].items()}
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] == STEPS
    assert checks["start_off"] == checks["lost"] == checks["dropped"] == 0
    assert checks["vel_gap"] < 0.1 and checks["pos_gap"] < 1e-4


def test_traced_run_reads_the_new_metrics():
    res = hm.run_cell(small_cell(steps=9), 5, 0.0, True, device="cpu")
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert res["correct"], res["checks"]
    assert m["runner.escalations.bucketed"] == 0.0
    assert m["host.step_ms.particle"] > 0      # the program's step spans
    for name in ("stage.rebin_ms_per_step.bucketed",
                 "stage.advect_ms_per_step.particle",
                 "stage.g2p_ms_per_step.particle"):
        assert name not in m    # no device events on the CPU


@pytest.mark.parametrize("pending", (False, True))
def test_reference_follows_the_ports_plain_bucketed_step(pending):
    """One plain step of the port (the kernel wrappers' CPU versions) from
    the initial state, or from the state one step on (its blend pending),
    against the reference's flat step from the same state read by
    ``plainref/buckets.py``: what rounding leaves, nothing dropped."""
    fam = family()
    step = fam._flip.flip_step_bucketed
    pre = fam.initial()
    if pending:
        pre = step(pre, fam.dom, fam.p)
    assert bool(pre.blend_pending) is pending
    post = step(fam.snapshot(pre), fam.dom, fam.p)
    ref = fam.reference_run(fam.reference_state(pre), 1)
    got = fam.compare(ref, fam.reference_state(post))
    assert got["lost"] == got["dropped"] == got["clock_off"] == 0, got
    assert got["vel_gap"] < 0.01 and got["pvel_gap"] < 0.01, got
    assert got["pos_gap"] < 1e-5, got
    assert torch.equal(ref["flags"], post.flags)


def test_reading_a_store_applies_the_pending_blend_only():
    fam = family()
    st = fam._flip.flip_step_bucketed(fam.initial(), fam.dom, fam.p)
    done = fam._flip.finalize_buckets(st, fam.dom, fam.p)
    a, b = fam.reference_state(st), fam.reference_state(done)
    assert torch.equal(a["pos"], b["pos"])
    assert float((a["pvel"] - b["pvel"]).abs().max()) < 1e-6
    assert not torch.equal(st.buckets.vx, done.buckets.vx)


def slots_cleared(step):
    """The last live slot of every cell that holds more than one particle
    cleared, as a store that lost them."""
    def broken(state, *a, **kw):
        new = step(state, *a, **kw)
        bk = new.buckets
        n = bk.cell_counts()[None]
        last = torch.arange(bk.ppc)[:, None] == n - 1
        return dataclasses.replace(new, buckets=dataclasses.replace(
            bk, valid=bk.valid & ~(last & (n > 1))))
    return broken


def counted_dropped(step):
    """A step that reports a particle lost to overflow and keeps it."""
    def broken(state, *a, **kw):
        new = step(state, *a, **kw)
        return dataclasses.replace(new, buckets=dataclasses.replace(
            new.buckets, dropped=new.buckets.dropped * 0 + 1))
    return broken


def unchanged(step):
    return lambda state, *a, **kw: state


def answer_altered(step):
    """The velocity of one interior face moved by a cell a step."""
    def broken(state, *a, **kw):
        new = step(state, *a, **kw)
        vel = new.vel.clone()
        c = vel.shape[-1] // 2
        vel[1, c, c, c] += 1.0
        return dataclasses.replace(new, vel=vel)
    return broken


def blend_skipped(step):
    """The pending blend left out of the advection."""
    def broken(state, *a, **kw):
        return step(dataclasses.replace(
            state, blend_pending=torch.zeros_like(state.blend_pending)),
            *a, **kw)
    return broken


@pytest.mark.parametrize("fault", (unchanged, slots_cleared, counted_dropped,
                                   answer_altered, blend_skipped))
def test_broken_timed_path_is_not_correct(fault):
    res = hm.run_cell(small_cell(), 99, 0.0, False, device="cpu",
                      fault=fault)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("seed", (1, 2 ** 31 + 3))
def test_control_fails_a_limit(seed):
    cell = small_cell()
    prog, ctl = control.readings(cell, seed, True, device="cpu")
    limits = cell.limits
    assert all(v <= limits[k] for k, v in prog["numbers"].items()), prog
    assert any(v > limits[k] for k, v in ctl["numbers"].items()), ctl


def test_roofline_counts_a_hand_built_store():
    """Four cells of a 3-slot store holding 0, 1, 3 and 2 particles: each
    function reads min(count + 1, 3) valid bytes a cell, 1 + 2 + 3 + 3 = 9.
    The count from the size alone, 6 + 4 - 6 / 3 = 8, is the least that any
    spread of the 6 particles over the 4 cells reads."""
    counts = torch.tensor([0, 1, 3, 2])
    P, T, N = 3, 4, int(counts.sum())
    valid = torch.arange(P)[:, None] < counts[None]
    exact = int((valid.sum(0) + 1).clamp(max=P).sum())
    assert exact == 9 and rb.valid_bytes(N, T, P) == 8.0
    # every spread of 6 particles over 4 cells of 3 slots reads at least 8
    assert min(int((torch.tensor(c) + 1).clamp(max=P).sum())
               for c in ((3, 3, 0, 0), (3, 2, 1, 0), (2, 2, 1, 1))) == 8
    v = rb.valid_bytes(N, T, P)
    assert rb.advect_work(N, T, P) == (48 * N + v + 24 * T, 620 * N)
    assert rb.rebin_work(N, T, P) == (24 * N + v + 25 * P * T, 30 * N)
    assert rb.p2g_work(N, T, P) == (24 * N + v + 24 * T, 270 * N)
    n, cells = 3_830_400, 128 ** 3
    for work, us in ((rb.advect_work, 71.63), (rb.rebin_work, 404.77),
                     (rb.p2g_work, 44.19)):
        least, by = rb.least(work(n, cells, 24))
        assert by == "bytes" and least * 1e6 == pytest.approx(us, abs=0.01)
