"""Puts the benchmark's directory and the repository's root on the import
path of the benchmark's tests, and gives them the cells at a test's size.

Run the tests from the repository's root:
``python -m pytest -p no:cacheprovider benchmark/tests`` (the card's cases:
add ``-m gpu`` on a machine with a CUDA device).
"""

import dataclasses
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import spec  # noqa: E402

#: the cells of BENCHMARK.json
CELLS = ("plume112.window", "plume112.exact", "flip01_128.flat")
#: a test's size: the grid's cells in x and the steps of an episode
SMALL = {"smoke": (16, 4), "flip": (16, 18)}


def small_cell(name: str, res: int | None = None, steps: int | None = None):
    """The cell ``name`` with its configuration cut to a test's size: the
    grid scaled to ``res`` cells in x, its other sides in proportion."""
    cell = spec.load_cell(name)
    r, s = SMALL[cell.config["family"]]
    r = res or r
    sx = cell.config["res"][0]
    cfg = dict(cell.config, res=[round(n * r / sx) for n in
                                 cell.config["res"]],
               episode_steps=steps or s)
    return dataclasses.replace(cell, config=cfg)
