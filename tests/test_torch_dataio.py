"""The port's host-side inputs of the render CLI against the JAX package
and the libraries it uses: the PNG codec against imageio, the resizes
against OpenCV, the DTU SceneDataset, the cameras and the spiral path,
the synthetic DTU-format scene writer, and the checkpoint reader."""
import os

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
import torch

from neumesh_tpu.dataio.dtu import SceneDataset as JScene
from neumesh_tpu.dataio.synthetic import generate_sphere_scene as jax_scene
from neumesh_tpu.ops import cameras as jcam
from neumesh_tpu_torch.dataio.dtu import SceneDataset
from neumesh_tpu_torch.dataio.synthetic import generate_sphere_scene
from neumesh_tpu_torch.ops import cameras as tcam
from neumesh_tpu_torch.utils import image_io

# (shape, dtype) imageio writes and reads as they are
PNG_KINDS = [((24, 31), np.uint8), ((24, 31, 3), np.uint8),
             ((24, 31, 4), np.uint8), ((5, 6, 2), np.uint8),
             ((17, 9), np.uint16)]


def _image(shape, dtype, seed, smooth):
    """Noise, or a smooth ramp with noise (PNG encoders pick the Sub / Up /
    Average / Paeth filters on such rows)."""
    rng = np.random.default_rng(seed)
    top = np.iinfo(dtype).max + 1
    img = rng.integers(0, top, size=shape)
    if smooth:
        ramp = np.add.outer(np.arange(shape[0]), 3 * np.arange(shape[1]))
        ramp = ramp.reshape(shape[:2] + (1,) * (len(shape) - 2))
        img = (ramp * (top // 64) + img % 3) % top
    return img.astype(dtype)


@pytest.mark.parametrize("shape,dtype", PNG_KINDS)
@pytest.mark.parametrize("smooth", [False, True])
def test_png_codec_round_trips_and_agrees_with_imageio(tmp_path, shape, dtype,
                                                       smooth):
    img = _image(shape, dtype, 0, smooth)
    mine, theirs = str(tmp_path / "mine.png"), str(tmp_path / "theirs.png")
    image_io.write_png(mine, img)
    np.testing.assert_array_equal(image_io.read_png(mine), img)
    got = imageio.imread(mine)
    assert got.dtype == img.dtype
    np.testing.assert_array_equal(got, img)
    imageio.imwrite(theirs, img)
    np.testing.assert_array_equal(image_io.read_png(theirs),
                                  imageio.imread(theirs))


def test_png_decoder_undoes_every_filter_type():
    """Rows written with each of the five filters by hand."""
    import struct
    import zlib
    rng = np.random.default_rng(1)
    H, W, bpp = 10, 7, 3
    img = rng.integers(0, 256, size=(H, W * bpp)).astype(np.int64)
    raw = b""
    for r in range(H):
        f = r % 5
        out = []
        for x in range(W * bpp):
            a = img[r, x - bpp] if x >= bpp else 0
            b = img[r - 1, x] if r else 0
            c = img[r - 1, x - bpp] if r and x >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            paeth = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            pred = [0, a, b, (a + b) // 2, paeth][f]
            out.append((img[r, x] - pred) % 256)
        raw += bytes([f]) + bytes(out)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
    np.testing.assert_array_equal(image_io.decode_png(png),
                                  img.reshape(H, W, 3))
    with pytest.raises(ValueError, match="CRC"):
        image_io.decode_png(png[:-5] + b"\x00" + png[-4:])


@pytest.mark.parametrize("factor", [2, 1.5, 2.5, 3, 4])
@pytest.mark.parametrize("shape", [(24, 24), (25, 37)])
def test_resizes_match_opencv(factor, shape):
    rng = np.random.default_rng(2)
    x = rng.random(shape + (3,)).astype(np.float32)
    m = (rng.random(shape) * 255).astype(np.float32)
    w, h = int(shape[1] / factor), int(shape[0] / factor)
    np.testing.assert_allclose(
        image_io.resize_area(x, w, h),
        cv2.resize(x, (w, h), interpolation=cv2.INTER_AREA), atol=1e-6)
    np.testing.assert_array_equal(
        image_io.resize_nearest(m, w, h),
        cv2.resize(m, (w, h), interpolation=cv2.INTER_NEAREST))


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A DTU-format scene written by the JAX package (imageio PNGs), with
    a scale_mat and a skewed camera so the decomposition has work."""
    d = str(tmp_path_factory.mktemp("scene"))
    jax_scene(d, n_views=3, H=24, W=30, focal=30.0)
    cams = dict(np.load(os.path.join(d, "cameras.npz")))
    cams["scale_mat_1"] = np.diag([1.2, 1.2, 1.2, 1.0]).astype(np.float32)
    cams["scale_mat_1"][:3, 3] = (0.1, -0.05, 0.02)
    cams["world_mat_2"][0, 1] += 2.0
    np.savez(os.path.join(d, "cameras.npz"), **cams)
    return d


@pytest.mark.parametrize("downscale,scale_radius,cammat",
                         [(1, -1, False), (2, -1, False), (1.5, 3.0, True)])
def test_scene_dataset_matches_jax(scene, downscale, scale_radius, cammat):
    kw = dict(train_cameras=False, data_dir=scene, downscale=downscale,
              scale_radius=scale_radius, intrinsic_from_cammat=cammat)
    want, got = JScene(**kw), SceneDataset(**kw)
    assert (got.H, got.W) == (want.H, want.W) and len(got) == len(want)
    for a, b in zip(got.intrinsics_all, want.intrinsics_all):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got.c2w_all, want.c2w_all):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got.object_masks, want.object_masks):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got.rgb_images, want.rgb_images):
        np.testing.assert_allclose(a, b, atol=1e-6)
    _, sample, gt = got[1]
    assert sample["c2w"] is got.c2w_all[1] and gt["rgb"].shape == (
        got.H * got.W, 3)


def test_cameras_and_spiral_match_jax():
    rng = np.random.default_rng(3)
    for _ in range(5):
        P = rng.normal(size=(3, 4))
        P[:, :3] += np.diag([300.0, 280.0, 1.0])
        for a, b in zip(tcam.load_K_Rt_from_P(P), jcam.load_K_Rt_from_P(P)):
            np.testing.assert_allclose(a, b, atol=1e-6)
        M = rng.normal(size=(3, 3))
        for a, b in zip(tcam.rq_decompose(M), jcam.rq_decompose(M)):
            np.testing.assert_allclose(a, b, atol=1e-6)
    poses = np.stack([jcam.look_at(rng.normal(size=3) * 2.5, np.zeros(3))
                      for _ in range(6)])
    np.testing.assert_allclose(tcam.poses_avg(poses), jcam.poses_avg(poses),
                               atol=1e-6)
    up = tcam.normalize(poses[:, :3, 1].sum(0))
    np.testing.assert_allclose(up, jcam.normalize(poses[:, :3, 1].sum(0)))
    rads = np.array([0.3, 0.2, 0.1])
    got = tcam.c2w_track_spiral(tcam.poses_avg(poses), up, rads, 2.0,
                                zrate=0.5, rots=2, N=7)
    want = jcam.c2w_track_spiral(jcam.poses_avg(poses), up, rads, 2.0,
                                 zrate=0.5, rots=2, N=7)
    np.testing.assert_allclose(np.stack(got), np.stack(want), atol=1e-6)


def test_scene_writer_matches_jax(tmp_path):
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    generate_sphere_scene(a, n_views=3, H=20, W=16, focal=25.0)
    jax_scene(b, n_views=3, H=20, W=16, focal=25.0)
    for sub in ("image", "mask"):
        names = sorted(os.listdir(os.path.join(b, sub)))
        assert sorted(os.listdir(os.path.join(a, sub))) == names
        for n in names:
            np.testing.assert_array_equal(
                imageio.imread(os.path.join(a, sub, n)),
                imageio.imread(os.path.join(b, sub, n)))
    ca, cb = np.load(os.path.join(a, "cameras.npz")), \
        np.load(os.path.join(b, "cameras.npz"))
    assert sorted(ca.files) == sorted(cb.files)
    for k in ca.files:
        np.testing.assert_array_equal(ca[k], cb[k])


def test_checkpoint_reader(tmp_path):
    """sorted_ckpts' order; a reference .pt fills a model; a file that is
    neither a torch zip nor a msgpack tree raises (native .ckpt files are
    read: tests/test_torch_checkpoints.py)."""
    from neumesh_tpu_torch.dataio.synthetic import icosphere_mesh
    from neumesh_tpu_torch.mesh.grid import MeshGrid
    from neumesh_tpu_torch.models.neumesh.model import NeuMesh
    from neumesh_tpu_torch.utils.checkpoints import CheckpointIO, sorted_ckpts
    from neumesh_tpu_torch.utils.state import save_reference_pt
    from neumesh_tpu.utils.checkpoints import sorted_ckpts as jax_sorted
    for n in ("final_00000300.ckpt", "latest.ckpt", "00000200.pt",
              "00000100.ckpt", "notes.txt"):
        (tmp_path / n).write_bytes(b"x")
    assert sorted_ckpts(str(tmp_path)) == jax_sorted(str(tmp_path))
    cfg = dict(D_density=2, D_color=2, W=16, geometry_dim=4, color_dim=4,
               multires_d=2, multires_fg=1, multires_ft=1, multires_view=1)
    mg = MeshGrid(icosphere_mesh(0.5, 1), device="cpu")
    src = NeuMesh(mg, device="cpu", **cfg).init(1)
    path = save_reference_pt(str(tmp_path / "m.pt"), src, global_step=7)
    dst = NeuMesh(mg, device="cpu", **cfg).init(2)
    ckpt = CheckpointIO(str(tmp_path)).load_file("m.pt", dst)
    assert ckpt["global_step"] == 7
    assert all(torch.equal(a, b) for a, b in zip(src.parameters(),
                                                 dst.parameters()))
    with pytest.raises(ValueError, match="not a checkpoint"):
        CheckpointIO(str(tmp_path)).load_file(str(tmp_path / "latest.ckpt"),
                                              dst)
    assert path.endswith("m.pt")
