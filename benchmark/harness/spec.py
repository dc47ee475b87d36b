"""A cell of ``BENCHMARK.json`` and the data files it names.

The cell's configuration is ``configs/<config>.json``, its traffic
``traffic/<traffic>.json``, its limits ``limits/<cell>.json``; each metric
it reports is an entry of ``BENCHMARK.json`` whose ``workloads`` list the
cell (or that has no such list), a per-layer metric read by
``metrics/<name>.py``. Adding a configuration, a traffic mix, a cell or a
per-layer metric adds files and entries; nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list   # BENCHMARK.json entries this cell reports
    per_layer: list


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(name: str, bench_dir: Path = BENCH_DIR,
              root: Path | None = None) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` (root: the directory
    that holds ``bench_dir``)."""
    root = bench_dir.parent if root is None else root
    bench = _load(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(has {sorted(cells)})")
    w = cells[name]
    config = _load(bench_dir / "configs" / f"{w['config']}.json")
    traffic = _load(bench_dir / "traffic" / f"{w['traffic']}.json")
    if config["family"] != traffic["family"]:
        raise ValueError(f"{name}: configuration {w['config']} is of family "
                         f"{config['family']}, traffic {w['traffic']} of "
                         f"{traffic['family']}")
    limits_path = bench_dir / "limits" / f"{name}.json"
    limits = _load(limits_path) if limits_path.exists() else {}
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, limits=limits,
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, name)])


def load_module(path: Path, name: str):
    """The module in the file ``path``, loaded under ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(metric: str, bench_dir: Path = BENCH_DIR):
    """``metrics/<metric>.py``'s ``read``: takes the traced run's record
    and returns the metric's value, or None where it finds nothing."""
    path = bench_dir / "metrics" / f"{metric}.py"
    return load_module(path, "bench_metric_" + metric.replace(".", "_")).read


def family(name: str, bench_dir: Path = BENCH_DIR):
    """``families/<name>.py``: drives the program for a configuration of
    this family and holds its comparison with the plain reference."""
    return load_module(bench_dir / "families" / f"{name}.py",
                       "bench_family_" + name)
