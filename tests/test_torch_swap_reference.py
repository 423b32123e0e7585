"""Texture swapping in the port against the plain reference of the
benchmark (benchmark/reference/swap.py) on seeded random weights at a
small size: the 642-vertex icosphere, 32-ray tiles, a 60-degree cap
facing the camera swapped from its antipode by a 180-degree turn about
x. The per-sample and the tile-bound shade of TextureEditableNeuMesh
(the fused route, field_fused_edit's plain version here, and the context
math), and a whole small volume frame through render_image, one
field_fused_edit call a chunk; the context math over slices of tiles
bit-equal to one pass; the painted samples counted alike on both routes;
tiles with no edited vertex among their candidates shaded as by the main
model alone."""
import math

import numpy as np
import pytest
import torch

from benchmark import weights
from benchmark.reference import swap as ref_swap
from benchmark.reference import volume as ref_volume
from benchmark.reference.neumesh import NeuMeshField
from neumesh_tpu_torch.dataio.synthetic import icosphere_mesh
from neumesh_tpu_torch.editing import texture_model
from neumesh_tpu_torch.editing.editable import EditablePrimitive, EditingParams
from neumesh_tpu_torch.editing.swap import TextureSwappingRender
from neumesh_tpu_torch.editing.texture_model import TextureEditableNeuMesh
from neumesh_tpu_torch.mesh.grid import MeshGrid
from neumesh_tpu_torch.models.neumesh.model import NeuMesh
from neumesh_tpu_torch.ops import kernels
from neumesh_tpu_torch.ops.rays import (block_order_indices, get_rays,
                                        near_far_from_sphere)
from neumesh_tpu_torch.render.volume import render_image
from neumesh_tpu_torch.utils import trace
from test_torch_basics import SMALL, camera

H = W = 16
BLOCK = (4, 8)
TILE = 32
S = 16
KC = 4
VOL = dict(ray_tile=TILE, tile_max_candidates=128, N_samples=16,
           N_importance=16, N_upsample_iters=2, reuse_upsample_sdf=True,
           detailed_output=False, rayschunk=128, obj_bounding_radius=1.0)


def caps(verts, u, deg=60.0):
    cos_v = verts @ u / np.linalg.norm(verts, axis=-1)
    c = math.cos(math.radians(deg))
    return cos_v >= c, -cos_v >= c


class Scene:
    """The port's editable and the reference's field on one set of
    weights. mask: the main edit region (V,) bool, else the cap facing
    the camera."""

    def __init__(self, mask=None, seed=3):
        torch.manual_seed(0)
        grid = MeshGrid(icosphere_mesh(0.5, 3), device="cpu")
        self.model = NeuMesh(grid, device="cpu", use_pallas=True, **SMALL)
        verts = np.asarray(grid.mesh.vertices, np.float64)
        self.p = weights.neumesh(self.model, torch.as_tensor(
            verts, dtype=torch.float32), seed, 0.2996)
        # the camera looks down +z: the cap facing it is about -z
        main_mask, ref_mask = caps(verts, np.array([0.0, 0.0, -1.0]))
        if mask is not None:
            main_mask = mask(verts)
        T = ref_swap.rotation([1.0, 0.0, 0.0], 180.0)
        prim = EditablePrimitive(self.model, [EditingParams(main_mask)])
        ref = EditablePrimitive(self.model, [EditingParams(ref_mask)])
        TextureSwappingRender().transfer(
            prim, prim.get_editing_params(0), ref, ref.get_editing_params(0),
            T.numpy(), Kc=KC)
        self.editable = TextureEditableNeuMesh(
            self.model, [self.model], prim.get_editing_masks(), [T.numpy()],
            [prim.edit_color_features])
        self.mask = torch.as_tensor(main_mask)
        main = NeuMeshField(self.p, SMALL)
        v = self.p["vertices"]
        codes = ref_swap.transfer(v, self.mask, v, torch.as_tensor(ref_mask),
                                  self.p["color_features"], T, KC)
        self.field = ref_swap.SwapField(main, main, self.mask, codes, T)

    def rays(self):
        """The frame's rays in block order, (R, 3) each."""
        c2w, K = camera(H, W)
        o, d = get_rays(torch.from_numpy(c2w), torch.from_numpy(K), H, W)
        perm, _ = block_order_indices(H, W, *BLOCK)
        return o[perm], d[perm]

    def bound(self):
        """(rays_o, rays_d, the tile-bound editable, its ids per ray)."""
        o, d = self.rays()
        near, far = near_far_from_sphere(o, d, 1.0)
        bound, _, _ = self.editable.bind_rays_tiled(o, d, near, far,
                                                    tile=TILE)
        ids = bound.bound.ctx["ids"]
        return o, d, bound, ids.repeat_interleave(TILE, 0)


def samples(o, d):
    """S depths a ray across the sphere: points (R, S, 3), dirs (R, S, 3)."""
    t = torch.linspace(1.9, 3.1, S)
    x = o[:, None, :] + t[None, :, None] * d[:, None, :]
    return x, d[:, None, :].expand_as(x)


@pytest.fixture(scope="module")
def scene():
    return Scene()


@pytest.mark.parametrize("form", ["per_sample", "tile_bound",
                                  "tile_bound_context_math"])
def test_shade_matches_the_reference(form, scene, monkeypatch):
    """tile_bound: the fused route (use_pallas); tile_bound_context_math:
    the sliced context math (use_pallas off)."""
    o, d, bound, ids = scene.bound()
    x, v = samples(o, d)
    if form == "tile_bound_context_math":
        monkeypatch.setattr(scene.model, "use_pallas", False)
    with torch.no_grad():
        if form == "per_sample":
            sdf, rgb = scene.editable.forward(x, v)
            # the reference over every vertex; the grid's kNN is held to it
            # where both find the same K vertices (the grid keeps a
            # bounded list of candidates a cell, which samples far from
            # the mesh outrun)
            ids = torch.arange(scene.p["vertices"].shape[0]).repeat(
                len(o), 1)
            grid_vid = scene.model.compute_distance(x)[1]
            vid, _ = scene.field.main.neighbours(x, ids)
            keep = (torch.sort(grid_vid, -1).values
                    == torch.sort(vid, -1).values).all(-1)
            assert float(keep.float().mean()) > 0.9
        else:
            sdf, rgb = bound.forward(x, v)
            keep = torch.ones(x.shape[:2], dtype=torch.bool)
    ref_sdf, _, ref_rgb = scene.field.full(x, ids, v)
    painted = scene.field.paint(x, ids) > 0
    assert 0.1 < float(painted.float().mean()) < 0.9
    # exact float32 on both sides
    e_rgb = torch.amax(torch.abs(rgb - ref_rgb), -1)
    e_sdf = torch.abs(sdf - ref_sdf)
    for e in (e_rgb[keep], e_sdf[keep], e_rgb[keep & painted]):
        assert float(torch.quantile(e, 0.5)) < 1e-6
        assert float(e.max()) < 1e-4


def test_edited_volume_frame_matches_the_reference(monkeypatch, scene):
    """render_image on the editable against the reference's volume
    structure, each ray bound to its tile's candidate ids; the shade one
    field_fused_edit call a chunk, the context math never."""
    bound, calls = [], []
    make = NeuMesh.make_tile_context
    edit = kernels.field_fused_edit

    def recorded(model, *a, **kw):
        ctx = make(model, *a, **kw)
        bound.append(ctx["ids"])
        return ctx

    def counted(*a, **kw):
        calls.append(a[0].shape[0])
        return edit(*a, **kw)

    def no_shade(*a, **kw):
        raise AssertionError("the context math shaded on the fused route")
    monkeypatch.setattr(NeuMesh, "make_tile_context", recorded)
    monkeypatch.setattr(kernels, "field_fused_edit", counted)
    monkeypatch.setattr(texture_model.RayBoundTextureEditable, "_shade",
                        no_shade)
    c2w, K = camera(H, W)
    rgb, depth, _ = render_image(scene.editable, c2w, K, H, W, block=BLOCK,
                                 device="cpu", **VOL)
    # two chunks of 128 rays, 4 tiles each
    assert calls == [VOL["rayschunk"] // TILE] * (H * W // VOL["rayschunk"])
    C = max(t.shape[1] for t in bound)
    n = scene.p["vertices"].shape[0]
    ids = torch.cat([torch.nn.functional.pad(t, (0, C - t.shape[1]),
                                             value=n) for t in bound])
    _, inv = block_order_indices(H, W, *BLOCK)
    o, d = get_rays(torch.from_numpy(c2w), torch.from_numpy(K), H, W)
    ref = ref_volume.render_rays(scene.field, o, d,
                                 ids[torch.as_tensor(inv) // TILE], VOL)
    e_rgb = torch.amax(torch.abs(rgb.reshape(-1, 3) - ref[0]), -1)
    e_depth = torch.abs(depth.reshape(-1) - ref[1])
    assert float(torch.median(e_rgb)) < 1e-5
    assert float(torch.median(e_depth)) < 1e-5
    assert float((e_rgb > 0.05).float().mean()) < 0.02


def test_sliced_shade_is_bit_equal(monkeypatch, scene):
    o, d, bound, _ = scene.bound()
    x, v = samples(o, d)
    # the context math: the fused route runs one pass whatever SLICE_ELEMS
    monkeypatch.setattr(scene.model, "use_pallas", False)
    n_tiles = len(o) // TILE
    C = bound.bound.ctx["ids"].shape[1]
    whole = bound.forward(x, v)
    # three tiles a slice: slices of 3, 3 and 2 of the 8 tiles
    monkeypatch.setattr(texture_model, "SLICE_ELEMS", 3 * TILE * S * C)
    sliced = bound.forward(x, v)
    assert n_tiles == 8
    assert torch.equal(whole[0], sliced[0])
    assert torch.equal(whole[1], sliced[1])


def test_tiles_without_edited_vertices_shade_as_the_main_model(
        monkeypatch):
    # a cap beside the sphere's silhouette: some tiles' candidates hold
    # none of its vertices, others some
    sc = Scene(mask=lambda v: v[:, 0] > 0.35)
    o, d, bound, _ = sc.bound()
    x, v = samples(o, d)
    monkeypatch.setattr(sc.model, "use_pallas", False)
    sdf, rgb = bound.forward(x, v)
    main_sdf, main_rgb = bound.bound.forward(x, v)
    clean = ~sc.mask[bound.bound.ctx["ids"].clamp(max=len(sc.mask) - 1)]
    clean = (clean | (bound.bound.ctx["ids"] == len(sc.mask))).all(-1)
    assert 0 < int(clean.sum()) < len(clean)
    rays = clean.repeat_interleave(TILE)
    assert torch.equal(sdf[rays], main_sdf[rays])
    assert torch.equal(rgb[rays], main_rgb[rays])
    assert not torch.equal(rgb[~rays], main_rgb[~rays])


def test_painted_samples_counted_alike_on_both_routes(monkeypatch, scene):
    """edit.samples_painted under a profiler: the fused route's count (the
    kernel's, the plain version's here) equals the context math's on the
    same samples."""
    from torch.profiler import ProfilerActivity, profile
    o, d, bound, _ = scene.bound()
    x, v = samples(o, d)
    got = {}
    for route in ("fused", "context_math"):
        monkeypatch.setattr(scene.model, "use_pallas", route == "fused")
        trace.reset("edit.")
        with profile(activities=[ProfilerActivity.CPU]), torch.no_grad():
            bound.forward(x, v)
        got[route] = trace.counters()["edit.samples_painted"]
    assert 0 < got["fused"] == got["context_math"] < x.shape[0] * x.shape[1]
