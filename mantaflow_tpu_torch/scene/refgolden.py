"""The reference-binary golden scenes, run on the port.

``tests/ref_scenes/test_*.py`` replay the reference's own test scripts
(``from mantaflow_tpu import *``) and compare grids with ``.uni`` goldens
that the reference C++ binary wrote (``tests/testdata_ref/``), each against
its scene's own threshold (the reference's doTestGrid contract,
``tests/refgolden.py``). ``run_ref_scene`` runs one of them unedited
through the scene runner's alias, on any device: the goldens are read with
the port's ``io/uni.py`` and the grids are copied to the host with
``.cpu()``.

    python -m mantaflow_tpu_torch.scene.refgolden [--device cpu] [NAME ...]
"""

from __future__ import annotations

import hashlib
import os
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
SCENES_DIR = REPO / "tests" / "ref_scenes"
TESTDATA_REF = REPO / "tests" / "testdata_ref"


#: scenes the port does not pass within their thresholds, and why (each
#: held by a test in tests/test_torch_scene_api.py)
LEFT_OUT = {
    "test_2045_fallingDrop":
        "phi 0.061 against 0.03 (vel passes; the JAX package reaches "
        "0.0089): reinitMarching at the narrow band's edge parts by "
        "0.1-0.34 on inputs a few ulp apart, in the JAX package's reinit "
        "as in the port's, and the order-2 advection's rounding differs "
        "from XLA's by that much; each frame restarted from the JAX "
        "package's state agrees to 1e-5 "
        "(tests/test_torch_falling_drop.py)",
    "test_9070_fliptight":
        "dens 0.5 against 1e-4 after 60 frames of the 64^2 FLIP dam: both "
        "packages solve by plain CG, but their dots sum in another order "
        "(XLA's reductions, the CG kernel's plain version), so the solves "
        "to 1e-9 exit at other iterates (102 and 90 in the first frame); "
        "they agree to 8e-7 a frame, but a particle ends in another cell",
}


#: scenes the port passes on the CPU but not on the card, and why
#: (NVIDIA H100 80GB HBM3, 700 W; the CPU's margins in brackets)
LEFT_OUT_ON_CARD = {
    "test_0100_psolve":
        "vel 1.068e-4 against 1e-4 (CPU 7.2e-5): the CG kernel sums in "
        "another order than the plain CG, so the 52^3 solve to 1e-4 stops "
        "at another iterate",
    "test_1010_plume2d":
        "dens 5.14e-4 against 5e-4 (CPU 3.8e-4): 30 frames through the "
        "CG kernel's solves to 1e-5, each stopping at another iterate "
        "than the plain CG's",
}


def scene_names(port_only=True, on_card=False):
    """The golden scenes, without those in LEFT_OUT (and, ``on_card``,
    LEFT_OUT_ON_CARD) unless asked."""
    out = sorted(f[:-3] for f in os.listdir(SCENES_DIR)
                 if f.startswith("test_") and f.endswith(".py"))
    if port_only:
        out = [n for n in out if n not in LEFT_OUT]
    if on_card:
        out = [n for n in out if n not in LEFT_OUT_ON_CARD]
    return out


class RefGoldenRecorder:
    """Collects doTestGrid comparisons for one scene (as the JAX package's
    ``tests/refgolden.py`` does), reading device data through the host."""

    def __init__(self, test_name: str):
        self.test_name = test_name
        self.results: list[tuple[str, float, float, bool]] = []
        #: sha256 of each compared grid's bytes, in the order of results
        self.digests: list[str] = []

    def do_test_grid(self, name: str, grid, threshold: float,
                     threshold_strict: float = 0.0,
                     invert_result: bool = False,
                     frac_above: float | None = None) -> bool:
        from ..io import uni as uio

        path = TESTDATA_REF / f"{self.test_name}_{name}.uni"
        if not path.exists():
            raise FileNotFoundError(f"reference golden missing: {path}")
        if hasattr(grid, "parent"):  # PdataBase
            arr = grid.data.cpu().numpy()
            dt = np.int32 if arr.dtype.kind == "i" else None
            golden = uio.read_pdata_uni(str(path), dtype=dt)[0]
            n = int(grid.parent.parts.count)
            arr = arr[:n]
            golden = np.asarray(golden)[:len(arr)] if len(golden) >= n \
                else golden
        else:
            golden, _ = uio.read_grid_uni(str(path))
            data = grid.data if hasattr(grid, "data") else grid
            arr = data.cpu().numpy() if hasattr(data, "cpu") \
                else np.asarray(data)
        if arr.shape != np.asarray(golden).shape:
            raise AssertionError(
                f"{self.test_name}/{name}: shape {arr.shape} vs golden "
                f"{np.asarray(golden).shape}")
        self.digests.append(hashlib.sha256(
            np.ascontiguousarray(arr).tobytes()).hexdigest())
        ad = np.abs(arr.astype(np.float64) - np.asarray(golden, np.float64))
        if frac_above is not None:
            diff = float((ad > frac_above).mean())
            label = f"frac(|diff|>{frac_above:g})"
        else:
            diff = float(ad.max())
            label = "maxDiff"
        ok = diff <= threshold
        if invert_result:
            ok = not ok
        self.results.append((name, diff, threshold, ok))
        print(f"refgolden[{self.test_name}/{name}]: {label}={diff:.3e} "
              f"loose<={threshold:g} -> {'OK' if ok else 'FAIL'}")
        return ok

    def assert_all(self):
        bad = [(n, d, t) for (n, d, t, ok) in self.results if not ok]
        assert self.results, f"{self.test_name}: no comparisons ran"
        assert not bad, f"{self.test_name} golden mismatches: " + ", ".join(
            f"{n} diff={d:.3e} (loose {t:g})" for n, d, t in bad)


def run_ref_scene(name: str, device=None) -> RefGoldenRecorder:
    """Run ``tests/ref_scenes/<name>.py`` on the port on ``device`` (None:
    CUDA) as one reference process would (the process statics reset
    first); raises on any golden mismatch."""
    import runpy

    from .run import _aliased, _check_port_only
    from .vortex_api import reset_process_statics
    from .. import resolve_device
    device = resolve_device(device)
    reset_process_statics()
    rec = RefGoldenRecorder(name)
    added = str(SCENES_DIR.parent) not in sys.path
    if added:
        sys.path.insert(0, str(SCENES_DIR.parent))
    try:
        with _aliased(device, isolate=("ref_scenes",)):
            g = runpy.run_path(str(SCENES_DIR / f"{name}.py"),
                               run_name=f"ref_scenes.{name}")
            _check_port_only(g)
            g["scene"](rec.do_test_grid)
    finally:
        if added:
            sys.path.remove(str(SCENES_DIR.parent))
    rec.assert_all()
    return rec


def main(args=None):
    args = list(sys.argv[1:] if args is None else args)
    device = None
    if args and args[0] == "--device":
        device = args[1]
        args = args[2:]
    failed = []
    on_card = device is None or str(device).startswith("cuda")
    for name in args or scene_names(on_card=on_card):
        t0 = time.perf_counter()
        try:
            run_ref_scene(name, device)
        except Exception as e:  # report every scene, then fail
            failed.append(name)
            print(f"{name}: FAILED {type(e).__name__}: {e}")
        print(f"{name}: {time.perf_counter() - t0:.2f} s", flush=True)
    if failed:
        raise SystemExit(f"failed: {failed}")


if __name__ == "__main__":
    main()
