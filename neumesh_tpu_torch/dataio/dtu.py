"""DTU/IDR scene dataset on the host in numpy (counterpart of
neumesh_tpu/dataio/dtu.py): image/ and mask/ directories and
cameras.npz (world_mat_i / scale_mat_i -> K, c2w; the optional
camera_mat_i intrinsics), downscaled images and intrinsics, camera
distance normalisation (scale_radius). PNGs are read and resized by the
port's own codec and resizes (utils/image_io.py)."""
from __future__ import annotations

import glob
import os
from typing import Optional

import numpy as np

from ..ops.cameras import load_K_Rt_from_P
from ..utils.image_io import read_png, resize_area, resize_nearest, write_png


def glob_imgs(d: str):
    """PNG files of a directory, sorted (the only format the port reads;
    other image files raise rather than drop out of the view order)."""
    paths = sorted(p for p in glob.glob(os.path.join(d, "*"))
                   if os.path.isfile(p))
    others = [p for p in paths if not p.lower().endswith(".png")]
    if others:
        raise ValueError(f"{d}: only PNG images are supported, found "
                         f"{os.path.basename(others[0])}")
    return paths


def _as_float(img: np.ndarray) -> np.ndarray:
    if img.dtype == np.uint8:
        return img.astype(np.float32) / 255.0
    if img.dtype == np.uint16:
        return img.astype(np.float32) / 65535.0
    return img.astype(np.float32)


def load_rgb(path: str, downscale: float = 1.0) -> np.ndarray:
    """(H, W, 3) float32 in [0, 1]; INTER_AREA downscale to
    int(w / downscale) x int(h / downscale)."""
    img = _as_float(read_png(path))
    if img.ndim == 2:
        img = np.stack([img] * 3, -1)
    img = img[..., :3]
    if downscale != 1:
        h, w = img.shape[:2]
        img = resize_area(img, int(w / downscale), int(h / downscale))
    return img


def load_mask(path: str, downscale: float = 1.0) -> np.ndarray:
    """(H, W) bool, thresholded at 127.5 of 255; INTER_NEAREST downscale."""
    alpha = read_png(path)
    if alpha.ndim == 3:
        alpha = alpha[..., :3].mean(-1)
    alpha = alpha.astype(np.float32)
    if alpha.max() <= 1.0 + 1e-6:
        alpha = alpha * 255.0
    if downscale != 1:
        h, w = alpha.shape[:2]
        alpha = resize_nearest(alpha, int(w / downscale), int(h / downscale))
    return alpha > 127.5


class SceneDataset:
    def __init__(self, train_cameras: bool, data_dir: str,
                 downscale: float = 1.0, cam_file: Optional[str] = None,
                 scale_radius: float = -1, split: str = "entire",
                 intrinsic_from_cammat: bool = False):
        if not os.path.exists(data_dir):
            raise FileNotFoundError(f"Data directory is empty: {data_dir}")
        self.instance_dir = data_dir
        self.train_cameras = train_cameras
        self.downscale = downscale

        image_paths = glob_imgs(os.path.join(data_dir, "image"))
        mask_paths = glob_imgs(os.path.join(data_dir, "mask"))
        n_images = len(image_paths)
        if not n_images:
            raise FileNotFoundError(f"no images under {data_dir}/image")

        self.cam_file = os.path.join(data_dir, cam_file or "cameras.npz")
        camera_dict = np.load(self.cam_file)
        scale_mats = [camera_dict[f"scale_mat_{i}"].astype(np.float32)
                      for i in range(n_images)]
        world_mats = [camera_dict[f"world_mat_{i}"].astype(np.float32)
                      for i in range(n_images)]
        intrinsic_mats = None
        if "camera_mat_0" in camera_dict and intrinsic_from_cammat:
            intrinsic_mats = [camera_dict[f"camera_mat_{i}"]
                              .astype(np.float32) for i in range(n_images)]

        self.intrinsics_all, self.c2w_all = [], []
        cam_center_norms = []
        for i, (scale_mat, world_mat) in enumerate(zip(scale_mats,
                                                       world_mats)):
            P = (world_mat @ scale_mat)[:3, :4]
            if intrinsic_mats is None:
                intrinsics, pose = load_K_Rt_from_P(P)
            else:
                _, pose = load_K_Rt_from_P(P)
                intrinsics = np.eye(4)
                intrinsics[:3, :3] = intrinsic_mats[i][:3, :3]
            cam_center_norms.append(np.linalg.norm(pose[:3, 3]))
            # the skew is a ratio and is not scaled
            intrinsics = intrinsics.copy()
            intrinsics[0, 2] /= downscale
            intrinsics[1, 2] /= downscale
            intrinsics[0, 0] /= downscale
            intrinsics[1, 1] /= downscale
            self.intrinsics_all.append(intrinsics.astype(np.float32))
            self.c2w_all.append(pose.astype(np.float32))

        max_cam_norm = max(cam_center_norms)
        if scale_radius > 0:
            for c2w in self.c2w_all:
                c2w[:3, 3] *= scale_radius / max_cam_norm / 1.1

        rgbs = [load_rgb(p, downscale) for p in image_paths]
        self.H, self.W = rgbs[0].shape[:2]
        self.rgb_images = [r.reshape(-1, 3) for r in rgbs]
        self.object_masks = [load_mask(p, downscale).reshape(-1)
                             for p in mask_paths]

    def __len__(self):
        return len(self.rgb_images)

    def __getitem__(self, idx: int):
        sample = {"object_mask": self.object_masks[idx],
                  "intrinsics": self.intrinsics_all[idx]}
        if not self.train_cameras:
            sample["c2w"] = self.c2w_all[idx]
        return idx, sample, {"rgb": self.rgb_images[idx]}

    def batch(self, indices):
        """Items stacked into batched numpy dicts (the collate step):
        (indices, model_input, ground_truth)."""
        items = [self[i] for i in indices]
        idxs = np.asarray([it[0] for it in items])
        model_input = {k: np.stack([it[1][k] for it in items])
                       for k in items[0][1]}
        ground_truth = {k: np.stack([it[2][k] for it in items])
                        for k in items[0][2]}
        return idxs, model_input, ground_truth

    def epoch_batches(self, batch_size: int, rng: np.random.Generator,
                      shuffle: bool = True):
        """One epoch of full batches in an order drawn from `rng`."""
        order = np.arange(len(self))
        if shuffle:
            rng.shuffle(order)
        for i in range(0, len(order) - batch_size + 1, batch_size):
            yield self.batch(order[i:i + batch_size])

    # accessors
    def get_images(self):
        return self.rgb_images

    def get_masks(self):
        return self.object_masks

    def get_intrinsics(self):
        return self.intrinsics_all

    def get_c2ws(self):
        return self.c2w_all

    def get_image_size(self):
        return self.H, self.W

    def get_scale_mat(self):
        return np.load(self.cam_file)["scale_mat_0"]

    # selected-view export
    def get_gt_pose(self, scaled: bool = True):
        """(n, 4, 4) c2w poses from the camera file, through scale_mat_i
        unless scaled=False; without the scale_radius normalisation."""
        camera_dict = np.load(self.cam_file)
        poses = []
        for i in range(len(self)):
            P = camera_dict[f"world_mat_{i}"].astype(np.float32)
            if scaled:
                P = P @ camera_dict[f"scale_mat_{i}"].astype(np.float32)
            _, pose = load_K_Rt_from_P(P[:3, :4])
            poses.append(pose)
        return np.stack(poses)

    def get_selected_pose_data(self, select_ids=None):
        """The camera dict of a subset of views, renumbered from 0, with
        the inverses of the scale and world matrices."""
        camera_dict = np.load(self.cam_file)
        if select_ids is None:
            select_ids = range(len(self))
        out = {}
        for i, vid in enumerate(select_ids):
            sm = camera_dict[f"scale_mat_{vid}"].astype(np.float32)
            wm = camera_dict[f"world_mat_{vid}"].astype(np.float32)
            out[f"scale_mat_{i}"] = sm
            out[f"scale_mat_inv_{i}"] = np.linalg.inv(sm)
            out[f"world_mat_{i}"] = wm
            out[f"world_mat_inv_{i}"] = np.linalg.inv(wm)
        return out

    def save_selected_data(self, selected_ids, out_dir: str):
        """Write a subset of views as a DTU-format dataset of its own:
        image/ and mask/ PNGs (8-bit) and cameras_sphere.npz."""
        os.makedirs(os.path.join(out_dir, "image"), exist_ok=True)
        os.makedirs(os.path.join(out_dir, "mask"), exist_ok=True)
        for i, vid in enumerate(selected_ids):
            img = (np.clip(self.rgb_images[vid], 0, 1)
                   .reshape(self.H, self.W, 3) * 255).astype(np.uint8)
            msk = (self.object_masks[vid].reshape(self.H, self.W)
                   * 255).astype(np.uint8)
            write_png(os.path.join(out_dir, "image", f"{i:04d}.png"), img)
            write_png(os.path.join(out_dir, "mask", f"{i:04d}.png"), msk)
        np.savez(os.path.join(out_dir, "cameras_sphere.npz"),
                 **self.get_selected_pose_data(selected_ids))
