"""The frame entries' ray order: rays built at block-ordered pixels on the
device (ops/rays.py::block_order) and rows put back in raster order by a
view (raster_order), against block_order_indices' numpy tables, and the
frames of render_surface_image and render_image bit-equal to the assembly
by those tables (test_torch_cuda.numpy_assembled_frame)."""
import numpy as np
import pytest
import torch

from neumesh_tpu_torch.dataio.synthetic import icosphere_mesh
from neumesh_tpu_torch.mesh.grid import MeshGrid
from neumesh_tpu_torch.models.neumesh.model import NeuMesh
from neumesh_tpu_torch.ops.rays import (block_order, block_order_indices,
                                        get_rays, raster_order)
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
# padded to the chunk (surface: 112-ray chunks of 7 tiles, 80 rays of pad;
# volume: 100-ray chunks, 44 rays of pad, on per-ray contexts)
FRAMES = {
    "surface_one_chunk": ("surface", (2, 8), dict(SURF, rayschunk=0)),
    "surface_padded": ("surface", (2, 8), dict(SURF, rayschunk=100)),
    "volume_two_chunks": ("volume", (2, 8), dict(VOL, rayschunk=128)),
    "volume_padded": ("volume", (2, 8), dict(VOL, rayschunk=100)),
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
