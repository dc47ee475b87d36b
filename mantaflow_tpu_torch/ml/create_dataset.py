"""Dataset-generation CLI (mantaGen create_dataset.py equivalent).

Port of ``mantaflow_tpu/ml/create_dataset.py``: drives the datagen
generators from the command line with the mantaGen argument surface
(name/type/num-sims/steps/resolution/seed) and the same on-disk layout
(<datasets_path>/<name>/sim_XXXXXX/<field>_YYYYYY.npz plus the same
description.json). Reference: tensorflow/mantaGen/create_dataset.py:1-120.
The generators run on CUDA unless ``--device`` names another device.

    python -m mantaflow_tpu_torch.ml.create_dataset --name DAM -t flip \\
        -n 2 -s 10 --resolution 32 --datasets_path ./datasets [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None):
    p = argparse.ArgumentParser(description="Generate simulation datasets")
    p.add_argument("--name", default="dataset", help="dataset name")
    p.add_argument("-t", "--type", default="smoke",
                   choices=["smoke", "smoke_buoyant", "flip", "liquid"],
                   help="scene type")
    p.add_argument("-n", "--num_scenes", type=int, default=1,
                   help="number of simulations")
    p.add_argument("-s", "--simulation_steps", type=int, default=10,
                   help="frames saved per simulation")
    p.add_argument("--steps_per_frame", type=int, default=1)
    p.add_argument("--resolution", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--datasets_path", default="./datasets")
    p.add_argument("--obstacles", action="store_true",
                   help="stamp a random interior obstacle per sim "
                        "(mantaGen randomized-scene parity)")
    p.add_argument("--noise_inflow", action="store_true",
                   help="smoke: wavelet-noise-modulated source emission")
    p.add_argument("--device", default=None,
                   help="torch device (default: CUDA; 'cpu' runs the plain "
                        "PyTorch versions)")
    args = p.parse_args(argv)

    from . import datagen

    out = os.path.join(args.datasets_path, args.name)
    os.makedirs(out, exist_ok=True)
    if args.type in ("smoke", "smoke_buoyant"):
        datagen.generate_smoke_dataset(
            out, num_sims=args.num_scenes, num_frames=args.simulation_steps,
            res=args.resolution, steps_per_frame=args.steps_per_frame,
            seed=args.seed, obstacles=args.obstacles,
            noise_inflow=args.noise_inflow or args.type == "smoke_buoyant",
            device=args.device)
        fields = ["density", "vel", "pressure"]
    else:
        datagen.generate_flip_dataset(
            out, num_sims=args.num_scenes, num_frames=args.simulation_steps,
            res=args.resolution, steps_per_frame=args.steps_per_frame,
            seed=args.seed, obstacles=args.obstacles, device=args.device)
        fields = ["phi", "vel", "pressure", "parts", "pvel"]

    with open(os.path.join(out, "description.json"), "w") as f:
        json.dump({"name": args.name, "type": args.type,
                   "num_scenes": args.num_scenes,
                   "simulation_steps": args.simulation_steps,
                   "resolution": args.resolution, "seed": args.seed,
                   "fields": fields}, f, indent=2)
    print(f"dataset written to {out}")
    return out


if __name__ == "__main__":
    main()
