#!/usr/bin/env python3
"""The readings that a cell's check limits are set from, in one process:
for each seed, the program's numbers after a short window at the cell's
own sizes, and the numbers of the reference put in the program's place at
each lower precision (the controls), of the program with each of its own
lower-precision paths switched on (check["program_controls"]: traffic
model knobs by name) and with each planted fault.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        --iters 3 [--controls tf32,bf16] [--program-controls all_bf16] \
        [--faults half_batch,altered]

Prints one JSON line a seed. Not run by the benchmark's own runs.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--controls", default="")
    p.add_argument("--program-controls", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--against", default="",
                   help="reference modes to read the program and its own "
                        "controls against besides f32")
    a = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    os.environ["NEUMESH_TORCH_GRID_CACHE"] = os.path.join(
        ROOT, "build", "benchmark", "grid_cache")
    import torch
    from benchmark import harness

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    bench = harness.spec()
    w, cfg, traffic, check = harness.cell(bench, a.workload)
    dev = torch.device("cuda")
    Drv = harness.driver(traffic["kind"])
    for seed in [int(s) for s in a.seeds.split(",")]:
        t0 = time.perf_counter()
        d = Drv(cfg, traffic, seed, dev, check=check)
        d.window(0.0, limit=a.iters)
        d.release()
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        row = {"seed": seed, "program": d.check(check)}
        against = {m: d.reference(check, m)
                   for m in filter(None, a.against.split(","))}
        for m, ref in against.items():
            row[f"program@{m}"] = d.numbers(d.program(), check, ref=ref)
        for name in filter(None, a.program_controls.split(",")):
            t = dict(traffic, model=dict(traffic.get("model", {}),
                                         **check["program_controls"][name]))
            v = Drv(cfg, t, seed, dev, check=check)
            v.window(0.0, limit=a.iters)
            v.release()
            v.sample = v._sample(check)
            row["program_" + name] = d.numbers(v.program(), check)
            for m, ref in against.items():
                row[f"program_{name}@{m}"] = d.numbers(v.program(), check,
                                                       ref=ref)
            del v
            torch.cuda.empty_cache()
        for mode in filter(None, a.controls.split(",")):
            row["control_" + mode] = d.control(check, mode)
        for fault in filter(None, a.faults.split(",")):
            row["fault_" + fault] = d.control(check, "f32", fault)
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        del d
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
