"""Texture painting in the port: the frozen step that build_paint_step
sets up (only color_features trains, Adam over it alone) equals the
masked step over every parameter that it replaced, bit for bit, over
three steps; the painting step of the benchmark's driver (the same
build_paint_step) against the plain reference of the benchmark
(benchmark/reference/paint.py) on seeded random weights at a small size;
the paint rays' cast in one call against the cast in batches."""
import copy

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.kinds import paint as paint_kind
from benchmark.kinds import train as train_kind
from neumesh_tpu_torch.config import ConfigDict
from neumesh_tpu_torch.dataio.synthetic import icosphere_mesh
from neumesh_tpu_torch.editing.paint_train import (build_paint_step,
                                                   get_optimized_features,
                                                   make_grad_mask)
from neumesh_tpu_torch.mesh.grid import MeshGrid
from neumesh_tpu_torch.models.neumesh.model import NeuMesh
from neumesh_tpu_torch.models.neus.model import NeuS
from neumesh_tpu_torch.train.loop import build_train_step
from neumesh_tpu_torch.train.optimizers import get_optimizer
from neumesh_tpu_torch.train.trainer import Trainer
from test_torch_basics import SMALL, block_rays

# the loss weights update_paint_config sets
LOSS_W = dict(img=1.0, mask=0.0, eikonal=0.1, distill_density=1.0,
              distill_color=1.0, indicator_reg=1.0)
RENDER = dict(N_samples=16, N_importance=16, N_upsample_iters=2,
              obj_bounding_radius=1.0, perturb=True, white_bkgd=False,
              bounded_near_far=True)
NEUS = dict(variance_init=0.05, speed_factor=10.0, W_geo_feat=16,
            obj_bounding_radius=1.0,
            surface_cfg=dict(D=3, W=32, skips=(2,), embed_multires=2,
                             radius_init=0.5),
            radiance_cfg=dict(D=2, W=32, embed_multires=-1,
                              embed_multires_view=2))
# no warm-up: the three steps move the codes by ~lr each
ARGS = ConfigDict({"training": {
    "lr": 1e-2, "num_iters": 10, "matmul_precision": "highest",
    "scheduler": {"type": "warmupcosine", "warmup_steps": 0}}})
B = 24
CELL = "neumesh-paint-train"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batches(steps=3):
    """Per step B paint rays (the frame's centre, white) and B background
    rays with random targets, all on the sphere's side of the camera."""
    o, d = block_rays(16, 16, half_fov=0.25)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    rng = np.random.default_rng(7)
    paint_pool = np.arange(80, 176)
    rest = np.setdiff1d(np.arange(256), paint_pool)
    out = []
    for _ in range(steps):
        p = rng.choice(paint_pool, B, replace=False)
        b = rng.choice(rest, B, replace=False)
        mi = {"rays_o_paint": o[p], "rays_d_paint": d[p],
              "mask_paint": np.ones(B, bool), "rays_o_bg": o[b],
              "rays_d_bg": d[b], "mask_bg": np.ones(B, bool)}
        gt = {"rgb_paint": np.ones((B, 3), np.float32),
              "rgb_bg": rng.random((B, 3)).astype(np.float32)}
        out.append(({k: torch.from_numpy(np.ascontiguousarray(v))
                     for k, v in mi.items()},
                    {k: torch.from_numpy(v) for k, v in gt.items()}))
    return out, o[paint_pool], d[paint_pool]


def _student():
    grid = MeshGrid(icosphere_mesh(0.5, 3), device="cpu")
    return NeuMesh(grid, device="cpu", use_pallas=False, **SMALL).init(3)


def test_frozen_step_equals_the_masked_step():
    """build_paint_step's step (color_features alone requires a gradient
    and is in Adam) against the step it replaced (every parameter trained,
    every gradient but the painted rows multiplied by zero): the same
    losses, the same color_features gradient and, after three steps, the
    same parameters, bit for bit; the frozen step leaves the other
    parameters without a gradient."""
    batches, o_paint, d_paint = _batches()
    teacher = NeuS(device="cpu", **NEUS).init(1)
    teacher.requires_grad_(False)
    masked_model, frozen_model = _student(), _student()
    idx = get_optimized_features(masked_model.mesh_grid, o_paint, d_paint)
    masked = build_train_step(
        Trainer(masked_model, dict(LOSS_W), teacher_model=teacher),
        get_optimizer(ARGS, masked_model), dict(RENDER), 0, 0, 0,
        matmul_precision="highest", painting=True,
        grad_mask=make_grad_mask(masked_model, idx))
    frozen, opt, idx_frozen = build_paint_step(
        ARGS, Trainer(frozen_model, dict(LOSS_W), teacher_model=teacher),
        dict(RENDER), o_paint, d_paint)
    np.testing.assert_array_equal(idx_frozen, idx)
    assert [n for n, _ in opt.params] == ["color_features"]
    gens = [torch.Generator().manual_seed(5) for _ in range(2)]
    for mi, gt in batches:
        _, s_masked = masked(mi, gt, gens[0])
        _, s_frozen = frozen(mi, gt, gens[1])
        assert set(s_masked) == set(s_frozen)
        for k in s_masked:
            assert torch.equal(s_masked[k], s_frozen[k]), k
        assert torch.equal(masked_model.color_features.grad,
                           frozen_model.color_features.grad)
        for name, p in frozen_model.named_parameters():
            assert p.requires_grad == (name == "color_features"), name
            if name != "color_features":
                assert p.grad is None, name
    after = dict(frozen_model.named_parameters())
    for name, p in masked_model.named_parameters():
        assert torch.equal(p, after[name]), name


def test_one_cast_equals_the_cast_in_batches():
    mesh_grid = MeshGrid(icosphere_mesh(0.5, 3), device="cpu")
    rng = np.random.default_rng(2)
    o = np.tile([[0.0, 0.0, -2.5]], (300, 1)) + rng.normal(size=(300, 3)) \
        * 0.01
    d = np.tile([[0.0, 0.0, 1.0]], (300, 1)) + rng.normal(size=(300, 3)) \
        * 0.15
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    one = get_optimized_features(mesh_grid, o, d)
    assert 10 < len(one) < mesh_grid.get_number_of_vertices() // 2
    np.testing.assert_array_equal(
        one, get_optimized_features(mesh_grid, o, d, batch_size=7))


def _tiny_paint(monkeypatch, seed):
    """The painting cell's driver at a CPU test's size: a 642-vertex
    icosphere, student width 32, teacher width 64, 48 x 64 views, 32 +
    32 rays a step; no warm-up in the schedule."""
    _, cfg, traffic, check = harness.cell(harness.spec(), CELL)
    cfg, traffic = copy.deepcopy(cfg), copy.deepcopy(traffic)
    cfg["mesh"]["subdivisions"] = 3
    cfg["model"]["W"] = 32
    cfg["training"]["scheduler"]["warmup_steps"] = 0
    traffic.update(N_rays=32, warmup_steps=0)
    traffic["cameras"].update(H=48, W=64, focal=2892.0 / 25, cx=32.0,
                              cy=24.0)
    load = train_kind.load_json

    def tiny_teacher(*parts):
        out = load(*parts)
        for net in ("surface", "radiance"):
            out["program"]["model"][net]["W"] = 64
        return out
    monkeypatch.setattr(train_kind, "load_json", tiny_teacher)
    return paint_kind.Paint(cfg, traffic, seed, torch.device("cpu"),
                            check=check)


@pytest.mark.parametrize("seed", [11, 2 ** 33 + 3])
def test_painting_step_matches_the_reference(monkeypatch, seed):
    """Exact f32 on both sides: each step's loss within 2e-6 relative, the
    first gradient of color_features within 1e-4 of its largest entry,
    each code's change over the three steps within 1e-3 of the largest
    change, and no change off the painted rows on either side."""
    d = _tiny_paint(monkeypatch, seed)
    ref = d.reference()
    got = d.prog
    for g, r in zip(got["loss"], ref["loss"]):
        assert abs(g - r) <= 2e-6 * abs(r), (g, r)
    g, r = got["grad"]["color_features"], ref["grad"]["color_features"]
    assert float(r.abs().max()) > 0
    assert float((g - r).abs().max()) <= 1e-4 * float(r.abs().max())
    start = d.ref_weights["color_features"]
    dg = got["params"]["color_features"] - start
    dr = ref["params"]["color_features"] - start
    assert float(dr.abs().max()) > 1e-3
    assert float((dg - dr).abs().max()) <= 1e-3 * float(dr.abs().max())
    for delta in (dg, dr):
        assert float(delta[~d.rows].abs().max()) == 0.0
        assert bool((delta[d.rows] != 0).any())
