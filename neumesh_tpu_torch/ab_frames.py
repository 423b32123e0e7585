"""Time the frames of chip_smoke.py's eight structures for several checkouts
of the port on one card, in turns (A B B A ...).

    python3 neumesh_tpu_torch/ab_frames.py ROOT_A ROOT_B [--rounds 1]

Each ROOT is the root of a checkout holding neumesh_tpu_torch/ and
chip_smoke.py. Every measurement runs in a process of its own that imports
that root's package and chip_smoke.py, builds its kernels and its scene
(chip_smoke.build_scene: the 163,842-vertex icosphere at the flagship
widths, parameters from numpy seed 0, its own candidate-grid build) and
renders each structure of its STRUCTURES: a warm-up frame, three windows
of chip_smoke.cuda_ms (CUDA events; the mean of a window of the
structure's reps), and one frame traced by chip_smoke.profile_frame.
Prints one JSON line per measurement: the root, the card (name and power
limit), the scene's build seconds and, per structure, the three window
means, the device busy ms, the traced wall ms and the device ms by kernel
(as that root's chip_smoke.profile_frame attributes it).

A measurement script, not part of the package: no module of the port
imports it. It sits in the port's tree so that the same-card A/B numbers
of PERF.md come from a committed script.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time


def measure(root: str) -> dict:
    sys.path.insert(0, root)
    import chip_smoke as cs
    import neumesh_tpu_torch
    if not neumesh_tpu_torch.__file__.startswith(root):
        raise RuntimeError(f"imported {neumesh_tpu_torch.__file__}, not the "
                           f"package under {root}")
    neumesh_tpu_torch.set_fp32_precision()
    cs.build_kernels()
    out = {"root": root, "card": cs.card_line()}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        models = cs.build_scene(tmp, "cuda")
        out["scene_s"] = time.perf_counter() - t0
        for st, (mkey, kind, H, kw, _, reps) in cs.STRUCTURES.items():
            m = models[mkey]
            cs.render(m, kind, H, **kw)

            def frame():
                return cs.render(m, kind, H, **kw)
            ms = [cs.cuda_ms(frame, reps=reps) for _ in range(3)]
            prof = cs.profile_frame(frame)
            out[st] = {"ms": ms, "busy_ms": prof["device_busy_ms"],
                       "wall_ms": prof["traced_wall_ms"],
                       "device_ms_by_kernel": prof["device_ms_by_kernel"]}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--one", action="store_true",
                    help="measure the single root in this process")
    args = ap.parse_args()
    roots = [os.path.abspath(r) for r in args.roots]
    if args.one:
        print(json.dumps(measure(roots[0])), flush=True)
        return 0
    order = []
    for _ in range(args.rounds):
        order += roots + roots[::-1]
    for root in order:
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             root, "--one"]).returncode
        if rc != 0:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
