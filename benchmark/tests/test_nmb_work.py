"""The frozen yardstick: model FLOPs against FlopCounterMode over the
plain reference, and kernel bounds against hand-worked numbers."""
import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import work
from benchmark.reference import distill as rd
from benchmark.reference import neus as rn
from benchmark.reference import volume as rv
from benchmark.reference.neumesh import NeuMeshField
from conftest import ROOT


def _cfg(name):
    with open(os.path.join(ROOT, "benchmark", "configs", name)) as f:
        return json.load(f)


def _wn_params(prefix, dims, gen):
    p = {}
    for l, (i, o) in enumerate(dims):
        p[f"{prefix}.{l}.v"] = torch.randn(i, o, generator=gen) * 0.05
        p[f"{prefix}.{l}.g"] = torch.ones(o)
        p[f"{prefix}.{l}.b"] = torch.zeros(o)
    return p


def _neus_params(a, gen):
    s = a["model"]["surface"]
    e = 3 * (1 + 2 * s["embed_multires"])
    dims = [(e if l == 0 else s["W"],
             257 if l == s["D"] else (s["W"] - e if (l + 1) in s["skips"]
                                      else s["W"]))
            for l in range(s["D"] + 1)]
    p = _wn_params("implicit_surface.layers", dims, gen)
    p.update(_wn_params("radiance_net.layers",
                        [(289, 256), (256, 256), (256, 256), (256, 256),
                         (256, 3)], gen))
    p["ln_s"] = torch.tensor([0.3])
    return p


def _student_tail(gen):
    """The density head and the colour MLP of the NeuMesh student."""
    p = {"density_linear." + k.rsplit(".", 1)[1]: v for k, v in
         _wn_params("head", [(256, 1)], gen).items()}
    for l, (i, o) in enumerate([(207, 256), (256, 256), (256, 256),
                                (256, 256)]):
        p[f"views_linears.{l}.w"] = torch.randn(i, o, generator=gen) * 0.05
        p[f"views_linears.{l}.b"] = torch.zeros(o)
    p["color_linear.w"] = torch.randn(256, 3, generator=gen) * 0.05
    p["color_linear.b"] = torch.zeros(3)
    return p


def _sphere_points(n, gen):
    v = torch.randn(n, 3, generator=gen)
    return 0.5 * v / v.norm(dim=-1, keepdim=True)


def _codes(v, gen):
    n = v.shape[0]
    return dict(indicator_vector=v / 0.5,
                geometry_features=torch.randn(n, 32, generator=gen),
                color_features=torch.randn(n, 32, generator=gen),
                ln_s=torch.tensor([0.3]),
                indicator_weight_raw=torch.tensor([-2.0]))


def _rays(R, gen):
    o = torch.tensor([[0.0, 0.0, -3.0]]).repeat(R, 1)
    d = torch.randn(R, 3, generator=gen) * 0.05 + torch.tensor([0, 0, 1.0])
    return o, d


R_KW = dict(N_samples=64, N_importance=64, N_upsample_iters=4,
            obj_bounding_radius=1.0)


def test_neus_step_flops_equal_the_flop_counter_over_the_reference():
    a = _cfg("neus_dtu_scan63.json")["program"]
    gen = torch.Generator().manual_seed(0)
    p = {k: v.requires_grad_(True) for k, v in _neus_params(a, gen).items()}
    field = rn.NeuSField(p, a["model"] | {"speed_factor": 10.0})
    R = 3
    o, d = _rays(R, gen)
    r = R_KW
    uni = [torch.rand(R, 16, generator=gen) for _ in range(4)]
    with FlopCounterMode(display=False) as fc:
        L = rn.render_and_loss(field, o, d, torch.rand(R, 3, generator=gen),
                               torch.ones(R, dtype=torch.bool), uni, r,
                               a["training"]["loss_weights"])
        torch.autograd.grad(L["total"], list(p.values()), allow_unused=True)
    assert fc.get_total_flops() == pytest.approx(
        work.neus_step_flops(a, r, R), rel=1e-12)


def test_volume_ray_flops_equal_the_flop_counter_over_the_reference():
    m = _cfg("neumesh_dtu_scan63.json")["model"]
    gen = torch.Generator().manual_seed(1)
    n_v = 40
    p = _wn_params("pts_linears", [(177, 256), (256, 256), (256, 256)],
                   gen)
    p.update(_student_tail(gen))
    v = _sphere_points(n_v, gen)
    p.update(_codes(v, gen), vertices=v)
    field = NeuMeshField(p, dict(m, speed_factor=10.0))
    R = 2
    o, d = _rays(R, gen)
    with FlopCounterMode(display=False) as fc:
        rv.render_rays(field, o, d, torch.arange(n_v).repeat(R, 1), R_KW)
    assert fc.get_total_flops() == pytest.approx(
        R * work.volume_ray_flops(m, R_KW), rel=1e-12)


def test_distill_step_flops_equal_the_flop_counter_over_the_reference():
    m = _cfg("neumesh_dtu_scan63.json")
    a = _cfg("neus_dtu_scan63.json")["program"]
    gen = torch.Generator().manual_seed(2)
    n_v = 40
    p = _wn_params("pts_linears", [(177, 256), (256, 256), (256, 256)],
                   gen)
    p.update(_student_tail(gen))
    v = _sphere_points(n_v, gen)
    p.update(_codes(v, gen))
    p = {k: t.requires_grad_(True) for k, t in p.items()}
    trained = list(p.values())
    p["vertices"] = v
    R = 2
    o, d = _rays(R, gen)
    sf = {"speed_factor": 10.0}
    ids = torch.arange(n_v).repeat(R, 1)
    student = NeuMeshField(p, m["model"] | sf)
    near = torch.full((R, 1), 2.4)
    with FlopCounterMode(display=False) as fc:
        # the program's up-sampling, which the reference step takes as given
        with torch.no_grad():
            z, _ = rv.upsample(lambda x: student.density(x, ids), o, d, near,
                               near + 1.2, 64, 64, 4, uniforms=[
                                   torch.rand(R, 16, generator=gen)
                                   for _ in range(4)])
        L = rd.render_and_loss(
            student, rn.NeuSField(_neus_params(a, gen), a["model"] | sf), o,
            d, torch.rand(R, 3, generator=gen),
            torch.ones(R, dtype=torch.bool), z, ids, v / 0.5,
            m["training"]["loss_weights"])
        torch.autograd.grad(L["total"], trained, allow_unused=True)
    assert fc.get_total_flops() == pytest.approx(
        work.distill_step_flops(m["model"], a, R_KW, R), rel=1e-12)
