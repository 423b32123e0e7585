"""The port's tracing facility (utils/trace.py): spans cost nothing and
count_device launches nothing without a profiler; under one, a surface
frame, a volume frame of two chunks and a NeuS train step emit their
documented spans, nested as the layers are, and so do the paint CLI's
set-up and step (with its counters); the host-read and secant
counters; kernels.LAUNCHES as a view of the one counter registry."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from neumesh_tpu_torch.dataio.synthetic import icosphere_mesh
from neumesh_tpu_torch.mesh.grid import MeshGrid
from neumesh_tpu_torch.models.neumesh.model import NeuMesh
from neumesh_tpu_torch.models.neus.model import NeuS
from neumesh_tpu_torch.ops import kernels
from neumesh_tpu_torch.render.ray_casting import (render_surface_image,
                                                  surface_render)
from neumesh_tpu_torch.render.volume import render_image
from neumesh_tpu_torch.utils import trace
from test_torch_basics import SMALL, camera

H = W = 16
TILE = 16
SURF_MODEL = dict(tile_kp_per_probe=8, scan_knn_k=1, tile_cell_budget=64)
SURF = dict(ray_tile=TILE, scan_mode="distance", tile_max_candidates=64,
            N_steps=16, N_secant_steps=3)
# the reference volume structure, two chunks of 128 rays
VOL = dict(ray_tile=TILE, tile_max_candidates=128, N_samples=16,
           N_importance=16, N_upsample_iters=2, reuse_upsample_sdf=True,
           detailed_output=False, rayschunk=128)
NEUS = dict(variance_init=0.05, speed_factor=10.0, W_geo_feat=16,
            obj_bounding_radius=1.0,
            surface_cfg=dict(D=3, W=32, skips=(2,), embed_multires=2,
                             radius_init=0.5),
            radiance_cfg=dict(D=2, W=32, embed_multires=-1,
                              embed_multires_view=2))
NEUS_RENDER = dict(N_samples=16, N_importance=8, N_upsample_iters=2,
                   obj_bounding_radius=1.0, perturb=False,
                   bounded_near_far=True, calc_normal=True)


@pytest.fixture(scope="module")
def mesh_model():
    torch.manual_seed(0)
    grid = MeshGrid(icosphere_mesh(0.5, 3), device="cpu")
    return NeuMesh(grid, device="cpu", use_pallas=True,
                   **{**SMALL, **SURF_MODEL}).init(0)


def surface_frame(model, chunk=0):
    c2w, K = camera(H, W)
    return render_surface_image(model, c2w, K, H, W, device="cpu",
                                rayschunk=chunk, **SURF)


def volume_frame(model):
    c2w, K = camera(H, W)
    return render_image(model, c2w, K, H, W, block=(4, 16), device="cpu",
                        **VOL)


def edited(model):
    """The model with the cap facing the camera (vertices within 60
    degrees of -z) swapped from its antipode, turned 180 degrees about x:
    the texture-swapping editable, its codes moved by the swap's
    transfer."""
    from neumesh_tpu_torch.editing.editable import (EditablePrimitive,
                                                    EditingParams)
    from neumesh_tpu_torch.editing.swap import TextureSwappingRender
    from neumesh_tpu_torch.editing.texture_model import \
        TextureEditableNeuMesh

    v = np.asarray(model.mesh_grid.mesh.vertices)
    cos_z = v[:, 2] / np.linalg.norm(v, axis=-1)
    T = np.diag([1.0, -1.0, -1.0, 1.0])
    main = EditablePrimitive(model, [EditingParams(cos_z <= -0.5)])
    ref = EditablePrimitive(model, [EditingParams(cos_z >= 0.5)])
    TextureSwappingRender().transfer(main, main.get_editing_params(0), ref,
                                     ref.get_editing_params(0), T, Kc=4)
    return TextureEditableNeuMesh(model, [model], main.get_editing_masks(),
                                  [T], [main.edit_color_features])


def neus_step():
    from neumesh_tpu_torch.config import ConfigDict
    from neumesh_tpu_torch.train.loop import build_train_step
    from neumesh_tpu_torch.train.optimizers import get_optimizer
    from neumesh_tpu_torch.train.trainer import Trainer

    model = NeuS(device="cpu", **NEUS).init(1)
    trainer = Trainer(model, dict(img=1.0, mask=0.1, eikonal=0.1,
                                  distill_density=0.0, distill_color=0.0,
                                  indicator_reg=0.0))
    opt = get_optimizer(ConfigDict({"training": {
        "lr": 5e-4, "num_iters": 10,
        "scheduler": {"type": "warmupcosine", "warmup_steps": 2}}}), model)
    step = build_train_step(trainer, opt, NEUS_RENDER, 32, H, W)
    c2w, K = camera(H, W)
    K4 = np.eye(4, dtype=np.float32)
    K4[:3, :3] = K
    rng = np.random.default_rng(0)
    mi = {"c2w": torch.from_numpy(c2w[None]),
          "intrinsics": torch.from_numpy(K4[None]),
          "object_mask": torch.from_numpy(rng.random((1, H * W)) > 0.4)}
    gt = {"rgb": torch.from_numpy(
        rng.random((1, H * W, 3)).astype(np.float32))}
    step(mi, gt, torch.Generator().manual_seed(0))


PAINT_RENDER = dict(N_samples=16, N_importance=8, N_upsample_iters=2,
                    obj_bounding_radius=1.0, perturb=True,
                    bounded_near_far=True)


def paint_step():
    """build_paint_step (the paint rays' cast, Adam over color_features)
    and one painting step of 16 paint and 16 background rays on a fresh
    student (the fixture's model stays untrained) -> the painted vertex
    ids."""
    from neumesh_tpu_torch.config import ConfigDict
    from neumesh_tpu_torch.editing.paint_train import build_paint_step
    from neumesh_tpu_torch.train.trainer import Trainer
    from test_torch_basics import block_rays

    model = NeuMesh(MeshGrid(icosphere_mesh(0.5, 3), device="cpu"),
                    device="cpu", **SMALL).init(0)
    trainer = Trainer(model, dict(img=1.0, mask=0.0, eikonal=0.1,
                                  distill_density=1.0, distill_color=1.0,
                                  indicator_reg=1.0),
                      teacher_model=NeuS(device="cpu", **NEUS).init(2))
    o, d = block_rays(H, W)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    args = ConfigDict({"training": {
        "lr": 1e-2, "num_iters": 10,
        "scheduler": {"type": "warmupcosine", "warmup_steps": 0}}})
    step, _, idx = build_paint_step(args, trainer, PAINT_RENDER, o[96:128],
                                    d[96:128])
    paint, bg = slice(104, 120), slice(0, 16)
    ones = torch.ones(16, dtype=torch.bool)
    mi = {"rays_o_paint": torch.from_numpy(o[paint]),
          "rays_d_paint": torch.from_numpy(d[paint]), "mask_paint": ones,
          "rays_o_bg": torch.from_numpy(o[bg]),
          "rays_d_bg": torch.from_numpy(d[bg]), "mask_bg": ones}
    gt = {"rgb_paint": torch.ones(16, 3),
          "rgb_bg": torch.rand(16, 3, generator=torch.Generator()
                               .manual_seed(1))}
    step(mi, gt, torch.Generator().manual_seed(0))
    return idx


def without_pallas(model, fn):
    """fn() with the model's use_pallas off."""
    model.use_pallas = False
    try:
        return fn()
    finally:
        model.use_pallas = True


def traced(fn):
    """The nm.* spans that fn() emits under a CPU profiler: [(name,
    [names of its enclosing nm.* spans])]."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    out = []
    for e in prof.events():
        if not e.name.startswith(trace.PREFIX):
            continue
        up, p = [], e.cpu_parent
        while p is not None:
            if p.name.startswith(trace.PREFIX):
                up.append(p.name[len(trace.PREFIX):])
            p = p.cpu_parent
        out.append((e.name[len(trace.PREFIX):], up))
    return out


def test_no_profiler_no_record_function_no_device_count(monkeypatch,
                                                        mesh_model):
    def boom(*a, **kw):
        raise AssertionError("record_function opened without a profiler")

    class NoSum:
        def sum(self, *a, **kw):
            raise AssertionError("count_device summed without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    trace.reset()
    assert not trace.enabled()
    with trace.span("x"):
        pass
    trace.count_device("secant.rays_bracketed", NoSum())
    surface_frame(mesh_model)
    assert "secant.rays_bracketed" not in trace.counters()
    assert trace.counters()["secant.rays_refined"] == H * W


FRAME = {"render.frame", "render.rays", "render.assemble", "ctx.build",
         "ctx.bounds", "weights.fold", "sync.indicator_weight"}
CASES = {
    "surface": (lambda m: surface_frame(m),
                FRAME | {"surface.scan", "surface.secant", "surface.shade"},
                {"ctx.build": "render.frame",
                 "sync.indicator_weight": "render.rays",
                 "surface.secant": "render.frame",
                 "surface.shade": "render.frame"},
                {"render.frame": 1, "ctx.build": 1}),
    "volume_two_chunks": (
        lambda m: volume_frame(m),
        FRAME | {"volume.coarse", "volume.upsample", "volume.shade"},
        {"ctx.build": "render.frame", "ctx.bounds": "render.frame",
         "sync.indicator_weight": "render.rays",
         "volume.upsample": "render.frame", "volume.shade": "render.frame"},
        {"render.frame": 1, "ctx.build": 2, "sync.indicator_weight": 1,
         "render.assemble": 2}),
    # the fused route: one field_fused_edit call a chunk, the reference's
    # colour weights folded beside the main model's
    "volume_texture_swapped": (
        lambda m: volume_frame(edited(m)),
        FRAME | {"volume.coarse", "volume.upsample", "volume.shade",
                 "edit.transfer", "edit.shade"},
        {"ctx.build": "render.frame", "sync.indicator_weight": "render.rays",
         "edit.shade": "volume.shade"},
        {"render.frame": 1, "ctx.build": 2, "sync.indicator_weight": 1,
         "edit.transfer": 1, "edit.shade": 2, "weights.fold": 4}),
    "volume_texture_swapped_context_math": (
        lambda m: without_pallas(m, lambda: volume_frame(edited(m))),
        {"render.frame", "render.rays", "render.assemble", "ctx.build",
         "ctx.bounds", "volume.coarse", "volume.upsample", "volume.shade",
         "edit.transfer", "edit.shade", "edit.ref_color"},
        {"edit.shade": "volume.shade", "edit.ref_color": "edit.shade"},
        {"render.frame": 1, "edit.shade": 2, "edit.ref_color": 2}),
    "neus_train_step": (
        lambda m: neus_step(),
        {"train.step", "train.forward", "train.render", "train.loss",
         "train.backward", "train.grad_norm", "train.adam", "field.nablas",
         "volume.coarse", "volume.upsample", "volume.shade"},
        {"train.adam": "train.step", "train.render": "train.forward",
         "field.nablas": "train.render", "train.loss": "train.forward",
         "train.backward": "train.step"},
        {"train.step": 1, "train.adam": 1}),
    # the paint CLI's set-up and step: each ray group renders in its own
    # span and builds two contexts (the bounds' raw lists, then the
    # binding's); the cast runs at set-up, outside the step
    "paint_train_step": (
        lambda m: paint_step(),
        {"paint.cast", "train.step", "train.forward", "train.paint_rays",
         "train.background_rays", "train.loss", "train.teacher",
         "train.backward", "train.grad_norm", "train.adam", "field.nablas",
         "ctx.build", "ctx.bounds", "volume.coarse", "volume.upsample",
         "volume.shade"},
        {"train.paint_rays": "train.forward",
         "train.background_rays": "train.forward",
         "ctx.build": "train.forward", "train.teacher": "train.loss",
         "train.adam": "train.step"},
        {"paint.cast": 1, "train.step": 1, "train.paint_rays": 1,
         "train.background_rays": 1, "ctx.build": 4, "train.adam": 1}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_spans_and_their_nesting(case, mesh_model):
    fn, names, inside, calls = CASES[case]
    spans = traced(lambda: fn(mesh_model))
    assert {n for n, _ in spans} == names
    for child, parent in inside.items():
        assert all(parent in up for n, up in spans if n == child), (
            child, parent)
    for n, k in calls.items():
        assert sum(1 for s, _ in spans if s == n) == k, n


def test_paint_counters():
    """paint.rays counts both groups' rays on the host, always;
    paint.rows_trained the rows of color_features with a gradient after
    the mask, a device sum only under a profiler: some of the painted
    rows."""
    trace.reset("paint.")
    paint_step()
    got = trace.counters()
    assert got["paint.rays"] == 32 and "paint.rows_trained" not in got
    trace.reset("paint.")
    with profile(activities=[ProfilerActivity.CPU]):
        idx = paint_step()
    got = trace.counters()
    assert got["paint.rays"] == 32
    assert 0 < got["paint.rows_trained"] <= len(idx)


def test_pack_and_teacher_spans():
    from neumesh_tpu_torch.train.trainer import Trainer

    teacher = NeuS(device="cpu", **NEUS).init(2)
    tr = Trainer(teacher, {}, teacher_model=teacher)
    x = torch.rand(4, 3) - 0.5
    spans = traced(lambda: (kernels.pack_layer(torch.rand(40, 32), 0),
                            tr._teacher(x, x)))
    assert [n for n, _ in spans if n != "field.nablas"] == [
        "weights.pack", "train.teacher"]
    assert ("field.nablas", ["train.teacher"]) in spans


@pytest.mark.parametrize("chunks", [1, 2])
def test_host_read_one_per_binding(chunks, mesh_model):
    """Per frame: the copies of c2w and K and the indicator weight read
    back once for every binding; per binding (chunk): the candidate grid's
    dims copied to the device."""
    trace.reset()
    spans = traced(lambda: surface_frame(mesh_model, H * W // chunks))
    assert sum(n == "sync.indicator_weight" for n, _ in spans) == 1
    assert trace.counters()["host_read"] == 3 + chunks


@pytest.mark.parametrize("kind", ["surface", "volume"])
def test_host_reads_fall_before_the_frames_launches(kind, monkeypatch,
                                                    mesh_model):
    """Each span's host_read increments: render.rays holds the frame's
    three (c2w, K, w1), before any stage launches; ctx.build one per
    binding (the grid's dims); no scan, secant, sampling or shading span
    holds one. A surface frame reads 4 times, a volume frame of two chunks
    5."""
    real = torch.profiler.record_function
    seen = []

    class Watched:
        def __init__(self, name):
            self.name, self.inner = name[len(trace.PREFIX):], real(name)

        def __enter__(self):
            self.before = trace.COUNTS.get("host_read", 0)
            return self.inner.__enter__()

        def __exit__(self, *exc):
            out = self.inner.__exit__(*exc)
            seen.append((self.name,
                         trace.COUNTS.get("host_read", 0) - self.before))
            return out

    monkeypatch.setattr(torch.profiler, "record_function", Watched)
    frame = surface_frame if kind == "surface" else volume_frame
    with profile(activities=[ProfilerActivity.CPU]):
        frame(mesh_model)
    reads = {}
    for name, n in seen:
        reads.setdefault(name, []).append(n)
    assert reads["render.rays"] == [3]
    assert reads["ctx.build"] == [1] * (1 if kind == "surface" else 2)
    assert reads["render.frame"] == [4 if kind == "surface" else 5]
    stages = [n for n in reads if n.startswith(("surface.", "volume."))]
    assert stages and all(set(reads[n]) == {0} for n in stages), reads


def test_edited_frame_reads_the_host_as_the_unedited_frame(mesh_model):
    """The editable hands the frame's w1 read to the main model, so an
    edited volume frame reads the host as often as the unedited one; its
    shade counts every sample it answers and, under a profiler, the
    painted ones."""
    editable = edited(mesh_model)
    reads = []
    for model in (mesh_model, editable):
        trace.reset()
        with profile(activities=[ProfilerActivity.CPU]):
            volume_frame(model)
        reads.append(trace.counters()["host_read"])
    got = trace.counters()
    assert reads == [5, 5]
    # two chunks of 128 rays, 31 midpoints a ray
    assert got["edit.samples_shaded"] == H * W * 31
    assert 0 < got["edit.samples_painted"] < got["edit.samples_shaded"]


def test_secant_counts_the_chunks_rays(mesh_model):
    from neumesh_tpu_torch.ops.rays import block_order_indices, get_rays

    c2w, K = camera(H, W)
    o, d = get_rays(torch.from_numpy(c2w), torch.from_numpy(K), H, W)
    perm, _ = block_order_indices(H, W, 8, 16)
    R = 128
    o, d = o[perm][:R], d[perm][:R]
    trace.reset()
    kw = {k: v for k, v in SURF.items() if not k.startswith("N_")}
    cfgs = {"N_steps": 16, "N_secant_steps": 3, "fill_inf": False}
    with profile(activities=[ProfilerActivity.CPU]):
        _, _, extras = surface_render(mesh_model, o, d, device="cpu",
                                      ray_casting_cfgs=cfgs, **kw)
    got = trace.counters()
    assert got["secant.rays_refined"] == R
    hits = int(extras["mask_surface"].sum())
    assert got["secant.rays_bracketed"] == hits and 0 < hits < R


def test_launches_are_a_view_of_the_registry():
    modes = {k: set(v) for k, v in kernels.LAUNCHES.items()}
    assert modes == {
        "field_fused": {"distance", "density", "density_nabla", "full"},
        "field_fused_edit": {"full"},
        "secant_refine": {"plain", "rebracket", "frozen",
                          "frozen_rebracket"},
        "surface_locate": {"bf16", "f32"},
        "candidate_field_v3": {"ds_feat", "ds_nofeat", "ds_dh_feat",
                               "ds_dh_nofeat"},
        "candidate_field": {"ds_feat", "ds_nofeat", "ds_dh_feat",
                            "ds_dh_nofeat"},
        "candidate_bounds": {"tiled"}}
    kernels.reset_launch_counts()
    trace.count("host_read")
    trace.count("launch.secant_refine.frozen", 2)
    trace.count("launch.field_fused.full")
    got = {k: dict(v) for k, v in kernels.LAUNCHES.items()}
    assert got["secant_refine"] == {"plain": 0, "rebracket": 0, "frozen": 2,
                                    "frozen_rebracket": 0}
    assert got["field_fused"]["full"] == 1
    assert sum(sum(v.values()) for v in got.values()) == 3
    before = trace.counters()["host_read"]
    kernels.reset_launch_counts()
    assert all(v == 0 for m in kernels.LAUNCHES.values()
               for v in m.values())
    assert trace.counters()["host_read"] == before
    with pytest.raises(KeyError):
        kernels.LAUNCHES["field_fused"]["nope"]
