"""The rest of the JAX package's public helpers in the port, each against
its JAX counterpart on the same numpy inputs: SceneDataset's accessors and
selected-view export (dataio/dtu.py), pixel_to_rays /
get_sphere_intersection / sample_cdf / lin2img (ops/rays.py), rot_to_quat
/ quat_to_rot (ops/cameras.py) and sdf_to_w (ops/alpha.py)."""
import os

import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neumesh_tpu.dataio.dtu import SceneDataset as JScene
from neumesh_tpu.dataio.synthetic import generate_sphere_scene as jax_scene
from neumesh_tpu.ops import alpha as jalpha
from neumesh_tpu.ops import cameras as jcam
from neumesh_tpu.ops import rays as jrays
from neumesh_tpu_torch.dataio.dtu import SceneDataset
from neumesh_tpu_torch.ops import alpha, cameras, rays
from neumesh_tpu_torch.utils.image_io import read_png


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("scene"))
    jax_scene(d, n_views=4, H=12, W=16, focal=16.0)
    cams = dict(np.load(os.path.join(d, "cameras.npz")))
    cams["scale_mat_2"] = np.diag([1.3, 1.3, 1.3, 1.0]).astype(np.float32)
    cams["scale_mat_2"][:3, 3] = (0.05, -0.1, 0.2)
    np.savez(os.path.join(d, "cameras.npz"), **cams)
    return d


def test_scene_accessors_and_export_match_jax(scene, tmp_path):
    kw = dict(train_cameras=False, data_dir=scene, scale_radius=3.0)
    want, got = JScene(**kw), SceneDataset(**kw)
    assert got.get_image_size() == want.get_image_size() == (12, 16)
    for name in ("get_images", "get_masks", "get_intrinsics", "get_c2ws"):
        a, b = getattr(got, name)(), getattr(want, name)()
        assert len(a) == len(b) == 4
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, atol=1e-6)
    np.testing.assert_array_equal(got.get_scale_mat(), want.get_scale_mat())
    for scaled in (True, False):
        np.testing.assert_array_equal(got.get_gt_pose(scaled),
                                      want.get_gt_pose(scaled))
    for ids in (None, [2, 0]):
        a, b = got.get_selected_pose_data(ids), want.get_selected_pose_data(
            ids)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    got.save_selected_data([3, 1], str(tmp_path / "t"))
    want.save_selected_data([3, 1], str(tmp_path / "j"))
    for sub in ("image", "mask"):
        names = sorted(os.listdir(tmp_path / "j" / sub))
        assert names == sorted(os.listdir(tmp_path / "t" / sub)) == [
            "0000.png", "0001.png"]
        for n in names:
            np.testing.assert_array_equal(
                read_png(str(tmp_path / "t" / sub / n)),
                imageio.imread(tmp_path / "j" / sub / n))
    a = np.load(tmp_path / "t" / "cameras_sphere.npz")
    b = np.load(tmp_path / "j" / "cameras_sphere.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])
    # the export loads back as a dataset of its own
    sub = SceneDataset(False, str(tmp_path / "t"),
                       cam_file="cameras_sphere.npz")
    assert len(sub) == 2
    np.testing.assert_allclose(sub.c2w_all[1], SceneDataset(
        False, scene).c2w_all[1], atol=1e-4)


def test_pixel_rays_and_sphere_intersection_match_jax():
    rng = np.random.default_rng(0)
    c2w = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    c2w[:, :3, :3] = np.linalg.qr(rng.normal(size=(2, 3, 3)))[0]
    c2w[:, :3, 3] = rng.normal(size=(2, 3)) * 2
    K = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    K[:, 0, 0], K[:, 1, 1], K[:, 0, 2], K[:, 1, 2] = 20, 22, 8, 6
    K[1, 0, 1] = 0.7
    i = rng.uniform(0, 16, (2, 50)).astype(np.float32)
    j = rng.uniform(0, 12, (2, 50)).astype(np.float32)
    want = jrays.pixel_to_rays(*(jnp.asarray(x) for x in (i, j, c2w, K)))
    got = rays.pixel_to_rays(*(torch.from_numpy(x) for x in (i, j, c2w, K)))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape == (2, 50, 3)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    # get_rays goes through pixel_to_rays: all pixels of both cameras
    o, d = rays.get_rays(torch.from_numpy(c2w), torch.from_numpy(K), 12, 16)
    jo, jd, _ = jrays.get_rays(jnp.asarray(c2w), jnp.asarray(K), 12, 16)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-6)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo))
    ro, rd = got[0].reshape(-1, 3), got[1].reshape(-1, 3)
    ro = ro * 0.4
    want = jrays.get_sphere_intersection(jnp.asarray(ro.numpy()),
                                         jnp.asarray(rd.numpy()), r=1.2)
    out = rays.get_sphere_intersection(ro, rd, r=1.2)
    assert 0.1 < float(out[2].float().mean()) < 1.0
    for g, w in zip(out, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


@pytest.mark.parametrize("det", [True, False])
def test_sample_cdf_matches_jax(det):
    rng = np.random.default_rng(1)
    bins = np.sort(rng.uniform(0, 4, (6, 33)), -1).astype(np.float32)
    w = rng.uniform(0.1, 1.0, (6, 32)).astype(np.float32)
    cdf = np.cumsum(w / w.sum(-1, keepdims=True), -1).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = jrays.sample_cdf(jnp.asarray(bins), jnp.asarray(cdf), 16,
                            det=det, key=key)
    u = None if det else torch.from_numpy(np.array(
        jax.random.uniform(key, (6, 16))))
    got = rays.sample_cdf(torch.from_numpy(bins), torch.from_numpy(cdf), 16,
                          det=det, u=u)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # and agrees with sample_pdf on the same weights
    pdf = rays.sample_pdf(torch.from_numpy(bins), torch.from_numpy(w), 16,
                          det=True)
    cdf_p = torch.cumsum((torch.from_numpy(w) + 1e-5)
                         / torch.sum(torch.from_numpy(w) + 1e-5, -1,
                                     keepdim=True), -1)
    np.testing.assert_allclose(
        rays.sample_cdf(torch.from_numpy(bins), cdf_p, 16, det=True).numpy(),
        pdf.numpy(), atol=1e-5)


def test_lin2img_matches_jax():
    x = np.arange(2 * 12 * 3, dtype=np.float32).reshape(2, 12, 3)
    for args, kw in (((x[0], 3, 4), {}), ((x, 3, 4), {"batched": True}),
                     ((x.reshape(24, 3), 3, 4), {"batched": True, "B": 2})):
        want = jrays.lin2img(jnp.asarray(args[0]), *args[1:], **kw)
        got = rays.lin2img(torch.from_numpy(args[0]), *args[1:], **kw)
        assert tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        rays.lin2img(torch.from_numpy(x[0]), 5, 4)


def test_quaternions_and_sdf_to_w_match_jax():
    rng = np.random.default_rng(2)
    Rs = np.linalg.qr(rng.normal(size=(7, 3, 3)))[0]
    Rs[np.linalg.det(Rs) < 0, :, 0] *= -1
    q = cameras.rot_to_quat(Rs)
    np.testing.assert_array_equal(q, jcam.rot_to_quat(Rs))
    np.testing.assert_array_equal(cameras.quat_to_rot(q),
                                  jcam.quat_to_rot(q))
    np.testing.assert_allclose(cameras.quat_to_rot(q), Rs, atol=1e-9)
    sdf = rng.normal(size=(4, 9)).astype(np.float32)
    want = jalpha.sdf_to_w(jnp.asarray(sdf), 64.0)
    got = alpha.sdf_to_w(torch.from_numpy(sdf), 64.0)
    assert len(got) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
