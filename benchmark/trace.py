"""The traced run: the program's kernel entry points wrapped from the
benchmark's side, a torch.profiler window, and the record that the
per-layer metrics read.

Device time is attributed to a kernel entry point by launch correlation:
every device operation whose launch (a CUDA runtime or driver call) lies
inside one call of the wrapper belongs to that call, whatever its symbol
is named.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile

import torch

from . import work

# the program's kernel entry points, reached as attributes of ops.kernels
ENTRIES = ("field_fused", "secant_refine", "surface_locate",
           "candidate_field_v3", "candidate_field")
PREFIX = "nmb."


class Recorder:
    """Wraps the entry points (module attributes, as the program's routes
    reach them) and, for a training step, the trainer's render_and_loss
    and the optimizer's step, recording CUDA events around them."""

    def __init__(self):
        self.calls = []           # (entry, bound_s or None)
        self.fwd = []             # (start, end) events of render_and_loss
        self.bwd = []             # (end of render_and_loss, step entry)
        self._undo = []

    def _wrap_entry(self, name, fn):
        def wrapped(*args, **kw):
            i = len(self.calls)
            bound = (work.bound_s(name, args, kw) if name in work.WORK
                     else None)
            self.calls.append((name, bound))
            with torch.profiler.record_function(f"{PREFIX}{name}.{i}"):
                return fn(*args, **kw)
        return wrapped

    def install(self, driver):
        from neumesh_tpu_torch.ops import kernels
        for name in ENTRIES:
            orig = getattr(kernels, name)
            setattr(kernels, name, self._wrap_entry(name, orig))
            self._undo.append((kernels, name, orig))
        trainer = getattr(driver, "trainer", None)
        if trainer is not None:
            self._wrap_step(trainer, driver.opt)

    def _wrap_step(self, trainer, opt):
        rl, step = trainer.render_and_loss, opt.step

        def event():
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e

        def render_and_loss(*a, **kw):
            e0 = event()
            out = rl(*a, **kw)
            e1 = event()
            self.fwd.append((e0, e1))
            return out

        def opt_step(*a, **kw):
            self.bwd.append((self.fwd[-1][1], event()))
            return step(*a, **kw)
        trainer.render_and_loss = render_and_loss
        opt.step = opt_step
        self._undo += [(trainer, "render_and_loss", None),
                       (opt, "step", None)]

    def uninstall(self):
        for obj, name, orig in reversed(self._undo):
            if orig is None:
                delattr(obj, name)
            else:
                setattr(obj, name, orig)
        self._undo.clear()

    def step_ms(self):
        torch.cuda.synchronize()
        return ([a.elapsed_time(b) for a, b in self.fwd],
                [a.elapsed_time(b) for a, b in self.bwd])


@contextlib.contextmanager
def profiled():
    """A torch.profiler session over the block; yields a dict that holds
    the Chrome trace's events once the block has closed."""
    from torch.profiler import ProfilerActivity, profile
    out = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(PREFIX + "window"):
            yield out
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            out["events"] = json.load(f)["traceEvents"]
    finally:
        os.remove(path)


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _merge(iv):
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce(events, calls) -> dict:
    """The record of one traced window (seconds): window_s, busy_s, the
    device time and bound of each entry point, device time outside them,
    launches, and the breakdown."""
    xs = [e for e in events if e.get("ph") == "X"]
    win = next(e for e in xs if e.get("name") == PREFIX + "window"
               and e.get("cat") == "user_annotation")
    w0, w1 = win["ts"], win["ts"] + win["dur"]
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS
           and w0 <= e["ts"] <= w1]
    launches = {}
    for e in xs:
        if e.get("cat") in LAUNCH_CATS:
            c = (e.get("args") or {}).get("correlation")
            if c is not None:
                launches[c] = e
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"])
                   for e in xs if e.get("cat") == "user_annotation"
                   and e["name"].startswith(PREFIX)
                   and e["name"] != PREFIX + "window")
    starts = [s[0] for s in spans]
    by_ext = {(e.get("args") or {}).get("External id"): e["name"]
              for e in xs if e.get("cat") == "user_annotation"
              and e["name"].startswith(PREFIX)}
    per_entry = {}
    inside = 0.0
    for e in dev:
        c = (e.get("args") or {}).get("correlation")
        lt = launches[c]["ts"] if c in launches else None
        owner = None
        if lt is not None:
            i = bisect.bisect_right(starts, lt) - 1
            # annotations of the entry points do not nest: the latest
            # one starting before the launch either holds it or none does
            if i >= 0 and spans[i][0] <= lt <= spans[i][1]:
                owner = spans[i][2]
        elif c not in launches:
            # no launch record (a statically linked runtime): the
            # innermost host operation at launch, which the device
            # operation carries as its external id
            owner = by_ext.get((e.get("args") or {}).get("External id"))
            if owner == PREFIX + "window":
                owner = None
        if owner is not None:
            entry = owner[len(PREFIX):].rsplit(".", 1)[0]
            per_entry[entry] = per_entry.get(entry, 0.0) + e["dur"] * 1e-6
            inside += e["dur"] * 1e-6
    bounds = {}
    for name, b in calls:
        if b is not None:
            bounds[name] = bounds.get(name, 0.0) + b
    busy = _merge([(max(e["ts"], w0), min(e["ts"] + e["dur"], w1))
                   for e in dev])
    busy_s = sum(b - a for a, b in busy) * 1e-6
    total = sum(e["dur"] for e in dev) * 1e-6
    return {"window_s": win["dur"] * 1e-6, "busy_s": busy_s,
            "device_s": total, "outside_s": total - inside,
            "entry_device_s": per_entry, "entry_bound_s": bounds,
            "launches": sum(1 for e in dev if e.get("cat") == "kernel"),
            "breakdown": breakdown(xs, dev, busy, win)}


def breakdown(xs, dev, busy, win, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps inside the window, each named by the innermost host operation
    running at the gap's middle on the window's thread."""
    by = {}
    for e in dev:
        name = e["name"][:100]
        by[name] = by.get(name, 0.0) + e["dur"] * 1e-6
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    w0, w1 = win["ts"], win["ts"] + win["dur"]
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    host = [e for e in xs if e.get("tid") == win.get("tid")
            and e.get("cat") in ("cpu_op", "user_annotation")
            and e is not win]
    host.sort(key=lambda e: e["ts"])
    hs = [e["ts"] for e in host]
    named = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(hs, mid)
        inner = None
        for e in host[max(0, i - 400):i]:
            if e["ts"] <= mid <= e["ts"] + e["dur"] and (
                    inner is None or e["dur"] < inner["dur"]):
                inner = e
        named.append([inner["name"][:100] if inner else "python (no op)",
                      (b - a) * 1e-6])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}
