#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json on the cards of this machine.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints the result as the last line of standard output (one JSON object)
and each compared number beside its limit as the last lines of standard
error. Exits non-zero without a result when CUDA is missing or the machine
has fewer cards than the cell asks for.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def process_age() -> float:
    """Seconds since this process started, at T0."""
    try:
        with open("/proc/self/stat") as f:
            start = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK")
                   - (time.perf_counter() - T0))
    except (OSError, ValueError, IndexError):
        return 0.0


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    t_start = T0 - process_age()
    sys.path.insert(0, ROOT)
    # the program's caches at fixed paths inside the checkout
    os.environ["NEUMESH_TORCH_GRID_CACHE"] = os.path.join(
        ROOT, "build", "benchmark", "grid_cache")
    import torch
    from benchmark import harness

    bench = harness.spec()
    w = next((w for w in bench["workloads"] if w["name"] == a.workload),
             None)
    if w is None:
        print(f"unknown workload {a.workload!r}", file=sys.stderr)
        return 2
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < w["chips"]:
        print(f"needs {w['chips']} CUDA device(s); found {cards}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    out, numbers = harness.run(a.workload, a.seed, a.seconds, bool(a.trace),
                               t_start, device="cuda", bench=bench)
    print("numbers: " + json.dumps(numbers), file=sys.stderr)
    for n, c in out["checked"].items():
        print(f"{n} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
