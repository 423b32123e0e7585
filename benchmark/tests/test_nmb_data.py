"""The harness is driven by data: a new per-layer metric, traffic mix,
configuration or cell is a new file plus new entries in BENCHMARK.json,
with no edit to a file that is there."""
import json
import os
import shutil

from conftest import ROOT


def _copy(tmp_path):
    """A checkout-like copy: BENCHMARK.json and benchmark/."""
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    return json.loads((tmp_path / "BENCHMARK.json").read_text())


def test_a_scratch_metric_from_a_new_file(tmp_path, monkeypatch):
    from benchmark import harness
    bench = _copy(tmp_path)
    (tmp_path / "benchmark" / "metrics" / "scratch_busy_ms.render.py") \
        .write_text("def read(rec):\n"
                    "    return 1e3 * rec['busy_s'] / rec['iters']\n")
    bench["per_layer"].append(
        {"name": "scratch_busy_ms.render", "unit": "ms", "better": "lower",
         "source": "device_trace", "layer": "device",
         "moves": "render_mrays", "workloads": ["neumesh-volume-f32"]})
    monkeypatch.setattr(harness, "HERE", str(tmp_path / "benchmark"))
    m = bench["per_layer"][-1]
    assert harness.applies(m, "neumesh-volume-f32")
    assert not harness.applies(m, "neus-train")
    assert harness.metric_reader(m["name"])(
        {"busy_s": 0.5, "iters": 4}) == 125.0


def test_a_new_cell_from_new_files(tmp_path, monkeypatch):
    from benchmark import harness
    bench = _copy(tmp_path)
    b = tmp_path / "benchmark"
    traffic = json.loads((b / "traffic" / "render-quality-f32.json")
                         .read_text())
    traffic["downscale"] = 8
    (b / "traffic" / "render-quality-f32-small.json").write_text(
        json.dumps(traffic))
    (b / "checks" / "neumesh-volume-f32-small.json").write_text(
        (b / "checks" / "neumesh-volume-f32.json").read_text())
    bench["workloads"].append(
        {"name": "neumesh-volume-f32-small", "config": "neumesh_dtu_scan63",
         "traffic": "render-quality-f32-small", "chips": 1, "why": "x"})
    monkeypatch.setattr(harness, "HERE", str(b))
    monkeypatch.setattr(harness, "ROOT", str(tmp_path))
    w, cfg, t, check = harness.cell(bench, "neumesh-volume-f32-small")
    assert t["downscale"] == 8 and cfg["model"]["W"] == 256
    assert harness.driver(t["kind"]).__name__ == "Render"
