"""``BENCHMARK.json`` keeps the benchmark's contract, every file it names
is there, and the harness finds a new configuration, cell or per-layer
metric by its name alone."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

import bench_paths
from harness import main as hm
from harness import spec

BENCH = bench_paths.BENCH
ROOT = bench_paths.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(bench["command"]) <= 32
    assert all(_line(w) for w in bench["command"])
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    for p in bench["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
    assert (ROOT / bench["command"][1]).is_file()
    assert len(json.dumps(bench)) < 64 * 1024


def test_names_and_units(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["why"])
        assert _line(c["source"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k])
        assert w["chips"] in (1, 4) and _line(w["why"])
        names.append(w["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        names.append(m["name"])
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert _line(m["layer"])
    assert len(names) == len(set(names))


def test_every_cell_reports_what_it_must(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    cells = [w["name"] for w in bench["workloads"]]
    assert cells == list(bench_paths.CELLS)

    def reports(m, cell):
        return "workloads" not in m or cell in m["workloads"]
    for cell in cells:
        mine = [n for n, m in e2e.items() if reports(m, cell)]
        assert "setup_s" in mine and len(mine) >= 2
        assert any(reports(m, cell) for m in bench["per_layer"])
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert reports(e2e[m["moves"]], cell), (m["name"], cell)


def test_every_named_file_is_there(bench):
    files = set()
    for c in bench["configs"]:
        path = ROOT / c["file"]
        assert path.is_file() and c["file"].startswith("benchmark/")
        cfg = json.loads(path.read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert all(k in cfg for k in c["reduced"])
        files.add(c["file"])
    assert len(files) == len(bench["configs"])
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.limits, w["name"]
        assert (BENCH / "families" / f"{cell.config['family']}.py").is_file()
    for m in bench["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))


def test_new_files_are_found_by_name(tmp_path, bench):
    """A configuration, a traffic mix, a cell and a per-layer metric added
    as files (and entries) to a copy, with no file of the copy edited."""
    copy = tmp_path / "benchmark"
    shutil.copytree(BENCH, copy, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    cfg = json.loads((copy / "configs" / "plume112.json").read_text())
    cfg.update(name="plume12", res=[12, 18, 12], episode_steps=2)
    (copy / "configs" / "plume12.json").write_text(json.dumps(cfg))
    (copy / "traffic" / "window1.json").write_text(json.dumps(
        {"family": "smoke", "entry": "smoke_step", "steps_per_call": 1,
         "params": {"window": 1}}))
    (copy / "limits" / "plume12.window1.json").write_text(
        (copy / "limits" / "plume112.window.json").read_text())
    (copy / "metrics" / "extra.steps_traced.py").write_text(
        "def read(record):\n    return float(record.steps)\n")
    bench = dict(bench)
    bench["configs"] = bench["configs"] + [dict(
        bench["configs"][0], name="plume12", file="benchmark/configs/"
        "plume12.json")]
    bench["workloads"] = bench["workloads"] + [{
        "name": "plume12.window1", "config": "plume12",
        "traffic": "window1", "chips": 1, "why": "a test's cell"}]
    bench["per_layer"] = bench["per_layer"] + [{
        "name": "extra.steps_traced", "unit": "steps", "better": "higher",
        "source": "program_counter", "layer": "entry",
        "moves": "grid_step_ms", "workloads": ["plume12.window1"]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("plume12.window1", bench_dir=copy)
    assert cell.config["res"] == [12, 18, 12]
    assert cell.traffic["params"] == {"window": 1}
    torch.set_num_threads(2)
    res = hm.run_cell(cell, 5, 0.0, True, device="cpu", bench_dir=copy)
    assert res["metrics"]["extra.steps_traced"]["value"] == 2.0
    assert res["correct"], res["checks"]


def test_a_run_loads_no_jax():
    """No module that a run loads has the top-level name ``jax``,
    ``jaxlib``, ``flax`` or ``mantaflow_tpu`` (compared whole: the port's
    own name begins with the last)."""
    code = (
        "import bench_paths, torch\n"
        "torch.set_num_threads(2)\n"
        "from harness import main as hm\n"
        "for n in bench_paths.CELLS:\n"
        "    hm.run_cell(bench_paths.small_cell(n, 12), 3, 0.0, n.endswith"
        "('exact'), device='cpu')\n"
        "import control, sys\n"
        "print('FOUND', hm.forbidden_modules())\n"
        "print('PORT', 'mantaflow_tpu_torch' in sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=str(BENCH / "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FOUND []" in out.stdout and "PORT True" in out.stdout


def test_without_a_card_the_run_refuses():
    """No CUDA device: exit code 2 and no result on standard output."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "plume112.window",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 2 and out.stdout == ""


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxtyping_like_name", sys)
    monkeypatch.setitem(sys.modules, "mantaflow_tpu_torchx", sys)
    assert hm.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "mantaflow_tpu.core", sys)
    assert hm.forbidden_modules() == ["mantaflow_tpu.core"]
