"""The port's scene API against the JAX package's, the particle and
breadth-plugin half of the cases (tests/torch_scene_cases.py; the other
half and the tolerances: tests/test_torch_scene_api.py)."""

import inspect
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import mantaflow_tpu as J  # noqa: E402
import mantaflow_tpu_torch as T  # noqa: E402
from test_torch_scene_api import PARTS  # noqa: E402
from torch_scene_cases import CASES, compare  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



@pytest.mark.parametrize("name", sorted(PARTS))
def test_scene_api_matches_reference(name, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    fn, tol = CASES[name]
    kw = {"tmp_path": tmp_path} if "tmp_path" in \
        inspect.signature(fn).parameters else {}
    J.setDebugLevel(1)
    T.setDebugLevel(1)
    compare(fn(J, **kw), fn(T, **kw), tol, name)
