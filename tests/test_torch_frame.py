"""The frame entries' ray order: rays built at block-ordered pixels on the
device (ops/rays.py::block_order) and rows put back in raster order by a
view (raster_order), against block_order_indices' numpy tables; the pixel
block search (pixel_block); the frames of render_surface_image and
render_image bit-equal to the assembly by those tables
(test_torch_cuda.numpy_assembled_frame); the surface entry in raster
order, at an explicit block and refusing a tile no block fits; the
volume entry's chunks rounded up to whole tiles; both entries over two
CPU replicas against one device."""
import math

import numpy as np
import pytest
import torch

from neumesh_tpu_torch.dataio.synthetic import icosphere_mesh
from neumesh_tpu_torch.mesh.grid import MeshGrid
from neumesh_tpu_torch.models.neumesh.model import NeuMesh
from neumesh_tpu_torch.ops.rays import (block_order, block_order_indices,
                                        get_rays, pixel_block, raster_order)
from test_torch_basics import SMALL, camera
from test_torch_cuda import (assert_frames_equal, entry_frame,
                             numpy_assembled_frame)

# (H, W, block_h, block_w): the trace tests' frame, the surface cell's
# 800 x 600, the volume cell's 400 x 300, blocks wider than tall
SHAPES = [(16, 16, 2, 8), (600, 800, 8, 16), (300, 400, 4, 16),
          (48, 64, 4, 32)]


@pytest.mark.parametrize("H,W,bh,bw", SHAPES)
def test_block_order_and_its_inverse_match_the_numpy_tables(H, W, bh, bw):
    perm, inv = block_order_indices(H, W, bh, bw)
    idx = block_order(H, W, bh, bw)
    assert idx.dtype == torch.int64
    assert torch.equal(idx, torch.from_numpy(perm))
    x = torch.randn(H * W, 3, generator=torch.Generator().manual_seed(H))
    assert torch.equal(raster_order(x, H, W, bh, bw),
                       x[torch.from_numpy(inv)].reshape(H, W, 3))
    flat = torch.arange(H * W)
    assert torch.equal(raster_order(flat[idx], H, W, bh, bw),
                       flat.reshape(H, W))


@pytest.mark.parametrize("H,W,bh,bw", SHAPES)
def test_rays_at_block_ordered_pixels_equal_the_gathered_rays(H, W, bh, bw):
    c2w, K = camera(H, W)
    c2w, K = torch.from_numpy(c2w), torch.from_numpy(K)
    o, d = get_rays(c2w, K, H, W)
    perm, _ = block_order_indices(H, W, bh, bw)
    ob, db, _ = get_rays(c2w, K, H, W,
                         select_inds=block_order(H, W, bh, bw))
    assert torch.equal(ob, o[perm]) and torch.equal(db, d[perm])


def old_block_search(H, W, tile):
    """The search the render CLI and the surface entry each held."""
    bh = max(1, int(np.sqrt(tile // 2)))
    bw = tile // bh
    while bh > 1 and (H % bh or W % bw):
        bh //= 2
        bw = tile // bh
    return (bh, bw) if H % bh == 0 and W % bw == 0 else None


# (H, W, tile, block): the first block divides; halved once or twice; no
# block divides (the volume cell's 400 x 300 at 128 rays, a 24 x 24 frame)
PIXEL_BLOCKS = [(600, 800, 128, (8, 16)), (32, 32, 128, (8, 16)),
                (16, 16, 16, (2, 8)), (12, 64, 128, (4, 32)),
                (6, 256, 128, (2, 64)), (300, 400, 128, None),
                (24, 24, 128, None)]


@pytest.mark.parametrize("H,W,tile,block", PIXEL_BLOCKS)
def test_pixel_block_matches_the_old_search(H, W, tile, block):
    assert pixel_block(H, W, tile) == old_block_search(H, W, tile) == block
    if block is not None:
        assert block[0] * block[1] == tile
        assert block[0] <= max(1, math.isqrt(tile // 2))


def test_block_order_rejects_a_block_that_does_not_divide_the_frame():
    with pytest.raises(ValueError, match="do not tile 12x16"):
        block_order(12, 16, 8, 16)


H = W = 16
SURF = dict(ray_tile=16, scan_mode="distance", tile_max_candidates=64,
            N_steps=16, N_secant_steps=3)
VOL = dict(ray_tile=16, tile_max_candidates=128, N_samples=16,
           N_importance=16, N_upsample_iters=2, reuse_upsample_sdf=True,
           detailed_output=False)
# (kind, pixel block, knobs): one chunk; tile-aligned chunks; a last chunk
# padded to the chunk (tile contexts: rayschunk 100 rounds up to 112-ray
# chunks of 7 tiles, 80 rays of pad; per-ray contexts: 100-ray chunks, 44
# rays of pad)
FRAMES = {
    "surface_one_chunk": ("surface", (2, 8), dict(SURF, rayschunk=0)),
    "surface_padded": ("surface", (2, 8), dict(SURF, rayschunk=100)),
    "volume_two_chunks": ("volume", (2, 8), dict(VOL, rayschunk=128)),
    "volume_padded": ("volume", (2, 8), dict(VOL, rayschunk=100)),
    "volume_per_ray_padded": ("volume", (2, 8),
                              dict(VOL, ray_tile=0, rayschunk=100)),
}


@pytest.fixture(scope="module")
def mesh_model():
    torch.manual_seed(0)
    grid = MeshGrid(icosphere_mesh(0.5, 3), device="cpu")
    return NeuMesh(grid, device="cpu", use_pallas=True, tile_kp_per_probe=8,
                   scan_knn_k=1, tile_cell_budget=64, **SMALL).init(0)


@pytest.mark.parametrize("frame", list(FRAMES))
def test_frame_entry_matches_the_numpy_assembly(frame, mesh_model):
    kind, block, kw = FRAMES[frame]
    c2w, K = camera(H, W)
    want = numpy_assembled_frame(mesh_model, kind, c2w, K, H, W, block,
                                 device="cpu", **kw)
    got = entry_frame(mesh_model, kind, c2w, K, H, W, block, device="cpu",
                      **kw)
    assert_frames_equal(got, want)
    if kind == "surface":
        share = float(got["mask_surface"].float().mean())
        assert 0.1 < share < 0.9, share


def test_volume_entry_rounds_a_chunk_no_tile_divides(mesh_model,
                                                     monkeypatch):
    """rayschunk 100 at ray_tile 16: the entry renders 112-ray chunks, each
    on tile contexts (volume_render, which takes the chunk as given, binds
    per-ray contexts where no tile divides it); the frame equal to
    volume_render's at rayschunk 112 on the block-ordered rays."""
    from neumesh_tpu_torch.render.volume import render_image, volume_render
    calls = {"tiled": [], "per_ray": 0}
    tiled, per_ray = NeuMesh.bind_rays_tiled, NeuMesh.bind_rays

    def count_tiled(self, rays_o, *a, **k):
        calls["tiled"].append(rays_o.shape[0])
        return tiled(self, rays_o, *a, **k)

    def count_per_ray(self, *a, **k):
        calls["per_ray"] += 1
        return per_ray(self, *a, **k)

    monkeypatch.setattr(NeuMesh, "bind_rays_tiled", count_tiled)
    monkeypatch.setattr(NeuMesh, "bind_rays", count_per_ray)
    c2w, K = camera(H, W)
    _, _, got = render_image(mesh_model, c2w, K, H, W, block=(2, 8),
                             device="cpu", **dict(VOL, rayschunk=100))
    assert calls == {"tiled": [112, 112, 112], "per_ray": 0}
    ro, rd, _ = get_rays(torch.from_numpy(c2w), torch.from_numpy(K), H, W,
                         select_inds=block_order(H, W, 2, 8))
    _, _, want = volume_render(mesh_model, ro, rd, device="cpu",
                               **dict(VOL, rayschunk=112))
    assert_frames_equal(got, {k: raster_order(v, H, W, 2, 8)
                              for k, v in want.items()})
    calls.update(tiled=[], per_ray=0)
    volume_render(mesh_model, ro, rd, device="cpu", **dict(VOL, rayschunk=100))
    assert calls == {"tiled": [100, 100, 100], "per_ray": 3}


def surface_frame(model, **kw):
    from neumesh_tpu_torch.render.ray_casting import render_surface_image
    c2w, K = camera(H, W)
    rgb, depth, extras = render_surface_image(model, c2w, K, H, W,
                                              device="cpu", **kw)
    return {"rgb": rgb, "depth": depth, **extras}


def test_surface_entry_renders_raster_order_at_ray_tile_0(mesh_model):
    """ray_tile 0: raster order, per-ray contexts, the frame equal to
    surface_render on the raster rays."""
    from neumesh_tpu_torch.render.ray_casting import surface_render
    knobs = dict(SURF, ray_tile=0)
    got = surface_frame(mesh_model, **knobs)
    c2w, K = camera(H, W)
    o, d = get_rays(torch.from_numpy(c2w), torch.from_numpy(K), H, W)
    rgb, depth, extras = surface_render(
        mesh_model, o, d, calc_normal=True, ray_tile=0,
        scan_mode="distance", tile_max_candidates=64,
        ray_casting_cfgs={"N_steps": 16, "N_secant_steps": 3,
                          "fill_inf": False}, device="cpu")
    want = {"rgb": rgb, "depth": depth,
            "normals_surface": extras["normals_surface"],
            "mask_surface": extras["mask_surface"]}
    assert_frames_equal(got, {k: v.reshape(H, W, *v.shape[1:])
                              for k, v in want.items()})
    assert 0.1 < float(got["mask_surface"].float().mean()) < 0.9


@pytest.mark.parametrize("block", [(4, 4), (1, 16)])
def test_surface_entry_renders_an_explicit_block(block, mesh_model):
    """block= overrides the pixel_block default: the frame equal to the
    numpy-table assembly at that block."""
    want = numpy_assembled_frame(mesh_model, "surface", *camera(H, W), H, W,
                                 block, device="cpu", **SURF)
    assert_frames_equal(surface_frame(mesh_model, block=block, **SURF), want)


@pytest.mark.parametrize("hw,tile", [((24, 24), 128), ((6, 10), 16)])
def test_surface_entry_refuses_a_tile_no_block_fits(hw, tile, mesh_model):
    from neumesh_tpu_torch.render.ray_casting import render_surface_image
    h, w = hw
    c2w, K = camera(h, w)
    with pytest.raises(ValueError, match="no pixel block"):
        render_surface_image(mesh_model, c2w, K, h, w, ray_tile=tile,
                             device="cpu")


@pytest.mark.parametrize("kind", ["volume", "surface"])
def test_entries_over_two_cpu_replicas_match_one_device(kind, mesh_model):
    """Each chunk split over two replicas: the frame of one device (the
    plain versions' matmuls see other row counts, so f32 rounding as
    test_torch_multidevice.py allows; hit masks equal)."""
    from neumesh_tpu_torch.parallel import replicate
    knobs = dict(VOL if kind == "volume" else SURF, rayschunk=100)
    c2w, K = camera(H, W)
    one = entry_frame(mesh_model, kind, c2w, K, H, W, (2, 8), device="cpu",
                      **knobs)
    two = entry_frame(mesh_model, kind, c2w, K, H, W, (2, 8), device="cpu",
                      replicas=[mesh_model, replicate(mesh_model, "cpu")],
                      **knobs)
    assert set(one) == set(two)
    for k in one:
        if one[k].dtype == torch.bool:
            assert torch.equal(one[k], two[k]), k
        else:
            torch.testing.assert_close(two[k], one[k], rtol=1e-4, atol=1e-5)
