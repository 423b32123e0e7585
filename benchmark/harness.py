"""The harness: finds a cell's configuration, traffic mix, check limits and
metric readers by the names in BENCHMARK.json, runs one set-up, one window
and the check, and builds the result line.

    benchmark/configs/<config>.json     one configuration
    benchmark/traffic/<traffic>.json    one traffic mix; its "kind" names
                                        the driver benchmark/kinds/<kind>.py
    benchmark/checks/<workload>.json    the check's sample and its limits
    benchmark/metrics/<metric>.py       one per-layer metric: read(record)
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level modules a run must not hold: JAX and the JAX package (the port,
# neumesh_tpu_torch, is told apart by its whole top-level name)
BANNED = ("jax", "jaxlib", "flax", "neumesh_tpu")


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def spec() -> dict:
    return load_json(ROOT, "BENCHMARK.json")


def cell(bench: dict, workload: str):
    w = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if w is None:
        raise SystemExit(f"unknown workload {workload!r}")
    c = next(c for c in bench["configs"] if c["name"] == w["config"])
    return w, load_json(ROOT, c["file"]), load_json(
        HERE, "traffic", w["traffic"] + ".json"), load_json(
        HERE, "checks", workload + ".json")


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def metric_reader(name: str):
    path = os.path.join(HERE, "metrics", name + ".py")
    sp = importlib.util.spec_from_file_location(f"nmb_metric_{name}", path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod.read


def driver(kind: str):
    mod = importlib.import_module(f"benchmark.kinds.{kind}")
    return getattr(mod, kind.capitalize())


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def judge(numbers: dict, limits: dict):
    """(correct, [(name, value, limit)]): every limited number at or under
    its limit and finite."""
    rows = [(n, numbers[n], lim) for n, lim in limits.items()]
    ok = all(v == v and v <= lim for _, v, lim in rows)
    return ok, rows


def run(workload: str, seed: int, seconds: float, trace: bool,
        t_start: float, device="cuda", bench=None, parts=None):
    """One run of a cell -> (the result line's object, every number the
    check read). Faults of the program surface as correct=False or as
    exceptions. parts: the cell's (workload entry, config, traffic, check)
    in place of the files."""
    bench = bench or spec()
    w, cfg, traffic, check = parts or cell(bench, workload)
    dev = torch.device(device)
    Drv = driver(traffic["kind"])
    d = Drv(cfg, traffic, seed, dev, check=check)
    setup_s = time.perf_counter() - t_start
    rec = None
    if trace:
        from . import trace as tr
        recorder = tr.Recorder()
        recorder.install(d)
        try:
            with tr.profiled() as prof:
                times = d.window(seconds, limit=traffic["trace_iters"])
            rec = tr.reduce(prof["events"], recorder.calls)
            rec["iters"] = len(times)
            rec["rays_per_iter"] = d.rays_per_frame()
            from . import work
            rec["model_flops"] = d.model_flops(work)
            rec["peak_flops"] = work.PEAK_DENSE_FLOPS
            if recorder.fwd:
                rec["forward_ms"], rec["backward_ms"] = recorder.step_ms()
        finally:
            recorder.uninstall()
    else:
        times = d.window(seconds)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    found = banned_modules()
    if found:
        raise RuntimeError(f"modules loaded that a run may not hold: "
                           f"{found}")
    d.release()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    numbers = d.check(check)
    correct, rows = judge(numbers, check["limits"])
    metrics = {}
    if trace:
        for m in bench["per_layer"]:
            if applies(m, workload):
                v = metric_reader(m["name"])(rec)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = d.end_to_end(times)
        e2e["setup_s"] = setup_s
        for m in bench["end_to_end"]:
            if applies(m, workload):
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    out = {"correct": bool(correct), "attempted": len(times), "failed": 0,
           "metrics": metrics,
           "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                      "kind": (torch.cuda.get_device_name(dev)
                               if dev.type == "cuda" else "cpu"),
                      "count": w["chips"], "memory_peak_bytes": int(peak)}}
    if trace:
        out["device"]["busy_s"] = rec["busy_s"]
        out["device"]["window_s"] = rec["window_s"]
        out["breakdown"] = rec["breakdown"]
    # the numbers compared, each beside its limit, come last
    out["checked"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    return out, numbers
