"""The texture-swapping cell at a CPU test's size: the program agrees with
reference/swap.py and the run is correct; each fault planted in the
program (the rotation left out, the main codes in place of the
transferred ones, one tile in ten lost) and each fault or lower precision
of the reference put in the program's place fails a limit; the cell's
FLOPs equal FlopCounterMode over the reference; its configuration holds
the student block of neumesh_dtu_scan63 unchanged."""
import json
import os
import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import harness, work
from benchmark.kinds import swap as kind
from benchmark.reference import swap as ref_swap
from benchmark.reference import volume as rv
from benchmark.reference.neumesh import NeuMeshField
from conftest import ROOT, tiny_parts
from test_nmb_work import R_KW, _codes, _rays, _sphere_points, \
    _student_tail, _wn_params

CELL = "neumesh-swap-volume-f32"


def swap_parts():
    """The swap cell cut as tiny_parts cuts the quality cell, whose
    traffic and check it shares but for the kind and the limits."""
    w, cfg, traffic, check = tiny_parts("neumesh-volume-f32")
    _, scfg, straffic, scheck = harness.cell(harness.spec(), CELL)
    cfg["edit"] = scfg["edit"]
    traffic["kind"] = straffic["kind"]
    check.update(limits=scheck["limits"], hit_opacity=scheck["hit_opacity"])
    return dict(w, name=CELL), cfg, traffic, check


def run(seed=123456789012):
    parts = swap_parts()
    parts[2]["trace_iters"] = 2
    return harness.run(CELL, seed, 0.0, False, time.perf_counter(),
                       device="cpu", parts=parts)[0]


def swap_cell(seed=5):
    w, cfg, traffic, check = swap_parts()
    d = kind.Swap(cfg, traffic, seed, torch.device("cpu"), check=check)
    d.window(0.0, limit=2)
    d.release()
    return d, check


def test_configuration_is_the_student_at_its_widths():
    def load(name):
        with open(os.path.join(ROOT, "benchmark", "configs", name)) as f:
            return json.load(f)
    swap, base = (load("neumesh_swap_dtu_scan63.json"),
                  load("neumesh_dtu_scan63.json"))
    for key in ("mesh", "speed_factor", "ln_s", "model"):
        assert swap[key] == base[key], key
    assert swap["reduced"] == [] and swap["edit"]["Kc"] == 4


@pytest.mark.parametrize("seed", [7, 2 ** 33 + 5])
def test_program_agrees_with_the_reference(seed):
    d, check = swap_cell(seed)
    n = d.check(check)
    # exact f32 on both sides
    assert n["rgb_p50"] < 1e-6 and n["depth_p50"] < 1e-5, n
    assert n["rgb_p50_painted"] < 1e-6 and n["rgb_over_0.05"] < 0.02, n
    assert n["painted_share"] > 0.3, n


def test_run_is_correct_unbroken():
    out = run()
    assert out["correct"], out["checked"]


def _no_rotation(monkeypatch):
    from neumesh_tpu_torch.editing.texture_model import \
        TextureEditableNeuMesh
    monkeypatch.setattr(TextureEditableNeuMesh, "_ref_frame",
                        lambda self, i, view, nabla: (view, nabla))


def _no_edit(monkeypatch):
    from neumesh_tpu_torch.editing import swap

    def own_codes(main, ref, weights, ref_ids, main_ids):
        ids = torch.as_tensor(main_ids)
        main.edit_color_features[ids] = main.model.color_features[ids]
    monkeypatch.setattr(swap, "write_transfer", own_codes)


def _tile_lost(monkeypatch):
    from neumesh_tpu_torch.editing.texture_model import \
        RayBoundTextureEditable
    orig = RayBoundTextureEditable.forward

    def lost(self, xyz, view_dirs):
        sdf, rgb = orig(self, xyz, view_dirs)
        flat = self.bound._flat(rgb)
        keep = (torch.arange(flat.shape[0]) % 10 != 0)[:, None, None]
        return sdf, self.bound._unflat(flat * keep)
    monkeypatch.setattr(RayBoundTextureEditable, "forward", lost)


@pytest.mark.parametrize("plant", [_no_rotation, _no_edit, _tile_lost])
def test_program_faults_are_not_correct(monkeypatch, plant):
    plant(monkeypatch)
    assert not run()["correct"]


@pytest.mark.parametrize("mode,fault", [("tf32", None),
                                        ("f32", "no_rotation"),
                                        ("f32", "no_edit"),
                                        ("f32", "tile_lost")])
def test_controls_fail_a_limit(mode, fault):
    d, check = swap_cell()
    ok, _ = harness.judge(d.check(check), check["limits"])
    assert ok
    ok, rows = harness.judge(d.control(check, mode, fault), check["limits"])
    assert not ok, rows


def test_swap_ray_flops_equal_the_flop_counter_over_the_reference():
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "neumesh_swap_dtu_scan63.json")) as f:
        m = json.load(f)["model"]
    gen = torch.Generator().manual_seed(3)
    n_v = 40
    p = _wn_params("pts_linears", [(177, 256), (256, 256), (256, 256)],
                   gen)
    p.update(_student_tail(gen))
    v = _sphere_points(n_v, gen)
    p.update(_codes(v, gen), vertices=v)
    main = NeuMeshField(p, dict(m, speed_factor=10.0))
    mask = v[:, 2] < 0
    codes = ref_swap.transfer(v, mask, v, ~mask, p["color_features"],
                              ref_swap.rotation([1.0, 0.0, 0.0], 180.0))
    field = ref_swap.SwapField(main, main, mask, codes,
                               ref_swap.rotation([1.0, 0.0, 0.0], 180.0))
    R = 2
    o, d = _rays(R, gen)
    with FlopCounterMode(display=False) as fc:
        rv.render_rays(field, o, d, torch.arange(n_v).repeat(R, 1), R_KW)
    assert fc.get_total_flops() == pytest.approx(
        R * kind.swap_ray_flops(work, m, R_KW), rel=1e-12)
