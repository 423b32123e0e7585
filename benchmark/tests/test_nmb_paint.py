"""The texture-painting cell at a CPU test's size: the program agrees with
reference/paint.py and the run is correct; each fault planted in the
program (every row of color_features trained, the geometry codes
trained, the paint rays shaded along their own direction) fails, and so
does each fault or lower precision of the reference put in the program's
place; the cell's FLOPs equal FlopCounterMode over the reference; its
configuration holds the student block of neumesh_dtu_scan63 unchanged."""
import json
import os
import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import harness, work
from benchmark.kinds import paint as kind
from benchmark.reference import neus as rn
from benchmark.reference import paint as rp
from benchmark.reference import volume as rv
from conftest import ROOT, tiny_parts
from test_nmb_work import R_KW, _codes, _neus_params, _rays, \
    _sphere_points, _student_tail, _wn_params

CELL = "neumesh-paint-train"


def _cfg(name):
    with open(os.path.join(ROOT, "benchmark", "configs", name)) as f:
        return json.load(f)


def run(seed=123456789012):
    parts = tiny_parts(CELL)
    parts[2]["trace_iters"] = 2
    return harness.run(CELL, seed, 0.0, False, time.perf_counter(),
                       device="cpu", parts=parts)[0]


def paint_cell(seed=5):
    w, cfg, traffic, check = tiny_parts(CELL)
    d = kind.Paint(cfg, traffic, seed, torch.device("cpu"), check=check)
    d.window(0.0, limit=2)
    d.release()
    return d, check


def test_configuration_is_the_student_at_its_widths():
    paint, base = (_cfg("neumesh_paint_dtu_scan105.json"),
                   _cfg("neumesh_dtu_scan63.json"))
    for key in ("mesh", "speed_factor", "ln_s", "model", "teacher",
                "render_train"):
        assert paint[key] == base[key], key
    assert paint["reduced"] == []
    tr = paint["training"]
    assert tr["lr"] == 0.01 and tr["matmul_precision"] == "highest"
    assert tr["loss_weights"] == dict(img=1.0, mask=0.0, eikonal=0.1,
                                      distill_density=1.0, distill_color=1.0,
                                      indicator_reg=1.0)


@pytest.mark.parametrize("seed", [7, 2 ** 33 + 5])
def test_program_agrees_with_the_reference(seed):
    d, check = paint_cell(seed)
    n = d.check(check)
    # exact f32 on both sides
    assert n["loss_rel"] < 2e-6 and n["grad_rel"] < 2e-6, n
    assert n["step_rel"] < 1e-4, n
    assert n["unpainted_rows_moved"] == 0 and n["frozen_moved"] == 0, n
    assert 0 < int(d.rows.sum()) < d.rows.numel() // 4


def test_run_is_correct_unbroken():
    out = run()
    assert out["correct"], out["checked"]
    assert set(out["checked"]) == {"loss_rel", "grad_rel", "step_rel",
                                   "unpainted_rows_moved", "frozen_moved"}


def _all_rows(monkeypatch):
    from neumesh_tpu_torch.editing import paint_train
    mask = paint_train.make_grad_mask

    def every_row(model, idx):
        out = mask(model, idx)
        out["color_features"] = torch.ones_like(out["color_features"])
        return out
    monkeypatch.setattr(paint_train, "make_grad_mask", every_row)


def _geometry(monkeypatch):
    from neumesh_tpu_torch.editing import paint_train
    get = paint_train.get_optimizer

    def with_geometry(args, model, names=None):
        return get(args, model,
                   names=("color_features", "geometry_features"))
    monkeypatch.setattr(paint_train, "get_optimizer", with_geometry)


def _true_view(monkeypatch):
    from neumesh_tpu_torch.train import trainer
    render = trainer.volume_render_rays

    def along_the_ray(*a, **kw):
        kw["random_color_direction"] = False
        return render(*a, **kw)
    monkeypatch.setattr(trainer, "volume_render_rays", along_the_ray)


@pytest.mark.parametrize("plant", [_all_rows, _geometry, _true_view])
def test_program_faults_are_not_correct(monkeypatch, plant):
    plant(monkeypatch)
    assert not run()["correct"]


@pytest.mark.parametrize("mode,fault", [("tf32", None),
                                        ("f32", "true_view"),
                                        ("f32", "all_rows"),
                                        ("f32", "geometry")])
def test_controls_fail_a_limit(mode, fault):
    d, check = paint_cell()
    ok, _ = harness.judge(d.check(check), check["limits"])
    assert ok
    ok, rows = harness.judge(d.control(check, mode, fault), check["limits"])
    assert not ok, rows


def test_paint_step_flops_equal_the_flop_counter_over_the_reference():
    m = _cfg("neumesh_paint_dtu_scan105.json")
    a = _cfg("neus_dtu_scan63.json")["program"]
    gen = torch.Generator().manual_seed(2)
    n_v = 40
    p = _wn_params("pts_linears", [(177, 256), (256, 256), (256, 256)],
                   gen)
    p.update(_student_tail(gen))
    v = _sphere_points(n_v, gen)
    p.update(_codes(v, gen), vertices=v)
    trained = {"color_features": p["color_features"].requires_grad_(True)}
    sf = {"speed_factor": 10.0}
    student = rp.PaintField(p, m["model"] | sf)
    teacher = rn.NeuSField(_neus_params(a, gen), a["model"] | sf)
    R = 2
    ids = torch.arange(n_v).repeat(R, 1)
    near = torch.full((R, 1), 2.4)
    groups = []
    with FlopCounterMode(display=False) as fc:
        for _ in range(2):
            o, d = _rays(R, gen)
            # the program's up-sampling, which the reference step takes as
            # given
            with torch.no_grad():
                z, _ = rv.upsample(lambda x: student.density(x, ids), o, d,
                                   near, near + 1.2, 64, 64, 4, uniforms=[
                                       torch.rand(R, 16, generator=gen)
                                       for _ in range(4)])
            groups.append({"o": o, "d": d, "z": z, "ids": ids,
                           "rgb": torch.rand(R, 3, generator=gen)})
        groups[0]["dirs"] = rp.unit(torch.rand(R, 127, 3, generator=gen))
        L = rp.render_and_loss(student, teacher, groups[0], groups[1],
                               m["training"]["loss_weights"])
        rp.masked_grads(L["total"], trained, v[:, 2] > 0)
    assert fc.get_total_flops() == pytest.approx(
        kind.paint_step_flops(m["model"], a, R_KW, R, R, work), rel=1e-12)
