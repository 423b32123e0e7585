"""Shared pieces of the benchmark's tests: the checkout on sys.path, the
program's grid cache in a temporary directory, and each cell cut to a size
a CPU test run can hold (widths cut too: these are tests of the harness,
the reference and the checks, not of the cells' sizes)."""
import copy
import os
import sys

import pytest
import torch

# the tests run in several worker processes; each keeps to a few threads
torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture(autouse=True)
def _grid_cache(tmp_path_factory, monkeypatch):
    monkeypatch.setenv("NEUMESH_TORCH_GRID_CACHE",
                       str(tmp_path_factory.getbasetemp() / "grid_cache"))


@pytest.fixture(autouse=True)
def _tiny_teacher(monkeypatch):
    """A student's teacher, loaded by name inside the driver, at width 64."""
    from benchmark.kinds import train
    load = train.load_json

    def tiny(*parts):
        cfg = load(*parts)
        for net in ("surface", "radiance"):
            cfg["program"]["model"][net]["W"] = 64
        return cfg
    monkeypatch.setattr(train, "load_json", tiny)


# cells whose program path the harness drives but BENCHMARK.json leaves
# out (PERF.md, Open questions): (configuration, traffic mix)
LEFT_OUT = {"neumesh-distill-train": ("neumesh_dtu_scan63", "train-512")}


def tiny_parts(workload: str):
    """(workload entry, config, traffic, check) of a cell at a CPU test's
    size: a 642-vertex icosphere, width 32 or 64, 32 x 32 frames, 64 rays a
    step."""
    from benchmark import harness
    if workload in LEFT_OUT:
        config, traffic_name = LEFT_OUT[workload]
        w = {"name": workload, "chips": 1}
        cfg = harness.load_json(harness.HERE, "configs", config + ".json")
        traffic = harness.load_json(harness.HERE, "traffic",
                                    traffic_name + ".json")
        check = {"limits": {}}
    else:
        w, cfg, traffic, check = harness.cell(harness.spec(), workload)
    cfg, traffic, check = (copy.deepcopy(x) for x in (cfg, traffic, check))
    cam = traffic["cameras"]
    if "mesh" in cfg:
        cfg["mesh"]["subdivisions"] = 3
        cfg["model"]["W"] = 32
    if traffic["kind"] == "render":
        side = 32 * traffic["downscale"]
        cam.update(H=side, W=side, focal=2892.0 * side / 1600,
                   cx=side / 2, cy=side / 2)
        traffic["render"]["rayschunk"] = 512
        # tiles of 32 rays cover about as much of the 642-vertex mesh as
        # the cells' 128-ray tiles cover of theirs
        traffic["render"]["ray_tile"] = 32
        traffic["block"] = [4, 8]
        traffic["path_views"] = 5
        traffic["warmup_frames"] = 1
        check.update(rays=256, block_rays=128, every=1, per_frame=256,
                     knn_band=0.1)
    else:
        if "program" in cfg:
            prog = cfg["program"]
            prog["model"]["surface"]["W"] = 64
            prog["model"]["radiance"]["W"] = 64
            prog["data"]["N_rays"] = 64
        traffic["N_rays"] = 64
        traffic["warmup_steps"] = 1
        cam.update(H=48, W=64, focal=2892.0 / 25, cx=32.0, cy=24.0)
    return w, cfg, traffic, check


def tiny_run(workload: str, seed: int = 123456789012, **kw):
    """One harness run of the cut cell on the CPU, two iterations."""
    import time

    from benchmark import harness
    parts = tiny_parts(workload)
    parts[2]["trace_iters"] = 2
    return harness.run(workload, seed, 0.0, False, time.perf_counter(),
                       device="cpu", parts=parts, **kw)[0]
