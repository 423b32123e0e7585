#!/usr/bin/env python3
"""The program's own spans and counters in a traced window.

The port names the stages of a frame or a training step with spans
("nm." + name, neumesh_tpu_torch/utils/trace.py), user_annotation events
of the profiler's trace on the thread that runs the window, and counts
host reads, secant rays and launches in one registry. reduce() takes the
window's Chrome events and gives each span name its calls, host time,
device time and device-idle time; metrics() reads the per-layer numbers
of a record that holds those spans and the registry's change over the
window. A program without the spans or counters gives no number.

    python3 benchmark/spans.py --workload <cell> --seed <n> [--out FILE]

runs the cell's set-up and one traced window as `run.py --trace 1` does
(the same entry-point wrappers and profiler window) and prints one JSON
object: the window, the spans, the counters, the numbers of metrics(),
the longest idle gaps and the synchronising runtime calls inside frames
and steps by the innermost span that made them.
"""
from __future__ import annotations

import bisect
import os
import sys

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from benchmark.trace import DEVICE_CATS, LAUNCH_CATS, _merge  # noqa: E402

PREFIX = "nm."
WINDOW = "nmb.window"
# the outermost span of a frame and of a training step
ITERS = ("nm.render.frame", "nm.train.step")
# runtime calls after which the host has waited for the device
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy")


def _window(xs):
    return next(e for e in xs if e.get("name") == WINDOW
                and e.get("cat") == "user_annotation")


def _spans(xs, win):
    """The window thread's nm.* spans [(start, end, name, parent index)],
    ordered by start, outer before inner."""
    w0, w1 = win["ts"], win["ts"] + win["dur"]
    raw = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in xs
                  if e.get("cat") == "user_annotation"
                  and e.get("tid") == win.get("tid")
                  and e.get("pid") == win.get("pid")
                  and e["name"].startswith(PREFIX) and w0 <= e["ts"] <= w1),
                 key=lambda s: (s[0], -s[1]))
    out, stack = [], []
    for a, b, name in raw:
        while stack and out[stack[-1]][1] < b:
            stack.pop()
        out.append((a, b, name, stack[-1] if stack else None))
        stack.append(len(out) - 1)
    return out


def _launch_times(xs, dev):
    """Launch time of each device operation: its runtime call's, matched
    by correlation, else (no launch record) the host operation's that
    carries its external id."""
    launch = {}
    for e in xs:
        if e.get("cat") in LAUNCH_CATS:
            c = (e.get("args") or {}).get("correlation")
            if c is not None:
                launch[c] = e["ts"]
    by_ext = {(e.get("args") or {}).get("External id"): e["ts"] for e in xs
              if e.get("cat") == "cpu_op"}
    out = []
    for e in dev:
        args = e.get("args") or {}
        t = launch.get(args.get("correlation"),
                       by_ext.get(args.get("External id")))
        if t is not None:
            out.append((t, e["dur"]))
    return sorted(out)


class _Covered:
    """Length of [a, b] that sorted disjoint intervals cover."""

    def __init__(self, iv):
        self.starts = [a for a, _ in iv]
        self.ends = [b for _, b in iv]
        self.cum = [0.0]
        for a, b in iv:
            self.cum.append(self.cum[-1] + b - a)

    def _upto(self, x):
        i = bisect.bisect_right(self.starts, x)
        total = self.cum[i]
        if i and self.ends[i - 1] > x:
            total -= self.ends[i - 1] - x
        return total

    def __call__(self, a, b):
        return self._upto(b) - self._upto(a)


def reduce(events) -> dict:
    """{span name: {calls, host_s, self_host_s, device_s, idle_s,
    self_idle_s}} over the traced window (seconds). device_s: every device
    operation launched inside the span, from any thread (the autograd
    engine's backward launches fall inside nm.train.backward); idle_s:
    time inside the span when the device ran nothing; self_*: what no
    child span covers."""
    xs = [e for e in events if e.get("ph") == "X"]
    win = _window(xs)
    w0, w1 = win["ts"], win["ts"] + win["dur"]
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS
           and w0 <= e["ts"] <= w1]
    busy = _Covered(_merge([(max(e["ts"], w0), min(e["ts"] + e["dur"], w1))
                            for e in dev]))
    lt = _launch_times(xs, dev)
    lts = [t for t, _ in lt]
    cum = [0.0]
    for _, d in lt:
        cum.append(cum[-1] + d)
    spans = _spans(xs, win)
    own = [[b - a, (b - a) - busy(a, b)] for a, b, _, _ in spans]
    for i, (a, b, _, parent) in enumerate(spans):
        if parent is not None:
            own[parent][0] -= b - a
            own[parent][1] -= (b - a) - busy(a, b)
    out = {}
    for (a, b, name, _), (self_host, self_idle) in zip(spans, own):
        r = out.setdefault(name, dict(calls=0, host_s=0.0, self_host_s=0.0,
                                      device_s=0.0, idle_s=0.0,
                                      self_idle_s=0.0))
        dev_us = (cum[bisect.bisect_right(lts, b)]
                  - cum[bisect.bisect_left(lts, a)])
        r["calls"] += 1
        r["host_s"] += (b - a) * 1e-6
        r["self_host_s"] += self_host * 1e-6
        r["device_s"] += dev_us * 1e-6
        r["idle_s"] += ((b - a) - busy(a, b)) * 1e-6
        r["self_idle_s"] += self_idle * 1e-6
    return out


def syncs(events) -> dict:
    """Runtime calls after which the host has waited for the device
    (SYNCS) made inside a frame or a step, by the innermost nm.* span
    around each: {span name: count}. An item read or a copy from pageable
    memory is a copy and its stream synchronise: one call counted."""
    xs = [e for e in events if e.get("ph") == "X"]
    win = _window(xs)
    spans = _spans(xs, win)
    starts = [s[0] for s in spans]
    out = {}
    for e in xs:
        if e.get("cat") not in LAUNCH_CATS or e.get("name") not in SYNCS:
            continue
        i = bisect.bisect_right(starts, e["ts"]) - 1
        # the innermost span that holds the call, up the parent chain
        while i is not None and i >= 0 and not (
                spans[i][0] <= e["ts"] <= spans[i][1]):
            i = spans[i][3]
        if i is None or i < 0:
            continue
        inner, j = spans[i][2], i
        while spans[j][3] is not None:
            j = spans[j][3]
        if spans[j][2] in ITERS:
            out[inner] = out.get(inner, 0) + 1
    return out


def _per_iter(rec, names, key, scale=1e3):
    sp = rec.get("spans") or {}
    if rec.get("iters", 0) <= 0 or not any(n in sp for n in names):
        return None
    return scale * sum(sp[n][key] for n in names if n in sp) / rec["iters"]


def _host_reads(rec):
    c = rec.get("counters") or {}
    if rec.get("iters", 0) <= 0 or "host_read" not in c:
        return None
    return c["host_read"] / rec["iters"]


def _bracket_share(rec):
    c = rec.get("counters") or {}
    if not c.get("secant.rays_refined") or "secant.rays_bracketed" not in c:
        return None
    return 100.0 * c["secant.rays_bracketed"] / c["secant.rays_refined"]


# per-layer numbers of a record {"iters", "spans", "counters"}
METRICS = {
    # device idle inside frames, a frame (ms)
    "frame_idle_ms.render": lambda r: _per_iter(r, ["nm.render.frame"],
                                                "idle_s"),
    # device time a frame of the context build and bounds (ms)
    "ctx_build_ms.render": lambda r: _per_iter(
        r, ["nm.ctx.build", "nm.ctx.bounds"], "device_s"),
    # device time a frame of the weights' fold and pack (ms)
    "weight_prep_ms.render": lambda r: _per_iter(
        r, ["nm.weights.fold", "nm.weights.pack"], "device_s"),
    "host_reads_per_frame": _host_reads,
    # the secant's bracketed rays over the rays it refined (%)
    "secant_bracket_share.render": _bracket_share,
    # device time a step of the Adam update (ms)
    "adam_ms": lambda r: _per_iter(r, ["nm.train.adam"], "device_s"),
}


def metrics(rec) -> dict:
    return {name: fn(rec) for name, fn in METRICS.items()}


def main(argv=None) -> int:
    import argparse
    import json
    import time

    t0 = time.perf_counter()
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # the program's caches at run.py's paths inside the checkout
    os.environ["NEUMESH_TORCH_GRID_CACHE"] = os.path.join(
        root, "build", "benchmark", "grid_cache")
    import torch

    from benchmark import harness
    from benchmark import trace as tr
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    from neumesh_tpu_torch.utils import trace as prog

    w, cfg, traffic, check = harness.cell(harness.spec(), a.workload)
    dev = torch.device("cuda")
    d = harness.driver(traffic["kind"])(cfg, traffic, a.seed, dev,
                                        check=check)
    setup_s = time.perf_counter() - t0
    recorder = tr.Recorder()
    recorder.install(d)
    try:
        before = prog.counters()
        with tr.profiled() as prof:
            times = d.window(0.0, limit=traffic["trace_iters"])
        after = prog.counters()
    finally:
        recorder.uninstall()
    events = prof["events"]
    rec = tr.reduce(events, recorder.calls)
    rec["iters"] = len(times)
    rec["spans"] = reduce(events)
    rec["counters"] = {k: v - before.get(k, 0) for k, v in after.items()}
    out = {"workload": a.workload, "seed": a.seed,
           "device": torch.cuda.get_device_name(dev), "setup_s": setup_s,
           "iters": rec["iters"], "window_s": rec["window_s"],
           "busy_s": rec["busy_s"], "metrics": metrics(rec),
           "counters": rec["counters"], "spans": rec["spans"],
           "syncs": syncs(events),
           "idle_gaps": rec["breakdown"]["idle_gaps"]}
    d.release()
    line = json.dumps(out)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "a") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
