"""Paint dataset (counterpart of neumesh_tpu/dataio/paint.py): every ray of
every view, split into paint rays (the pixels of paint_mask/) and
background rays (the object mask minus the paint mask); items are
per-ray, a batch pairs paint and background rays by index."""
from __future__ import annotations

import os

import numpy as np

from .dtu import SceneDataset, glob_imgs, load_mask


def _rays_full_image(c2w: np.ndarray, K: np.ndarray, H: int, W: int):
    """Unit-direction camera rays of every pixel in raster order, float32
    (rays_o (H*W, 3), rays_d (H*W, 3)); the skew term included."""
    i, j = np.meshgrid(np.arange(W, dtype=np.float64),
                       np.arange(H, dtype=np.float64))
    i = i.reshape(-1)
    j = j.reshape(-1)
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    sk = K[0, 1]
    x = (i - cx + cy * sk / fy - sk * j / fy) / fx
    y = (j - cy) / fy
    dirs = np.stack([x, y, np.ones_like(x)], -1)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    rays_d = dirs @ c2w[:3, :3].T
    rays_o = np.broadcast_to(c2w[:3, 3], rays_d.shape)
    return rays_o.astype(np.float32), rays_d.astype(np.float32)


class PaintDataset:
    def __init__(self, img_dataset: SceneDataset):
        self.img_dataset = img_dataset
        images = img_dataset.rgb_images
        masks = img_dataset.object_masks
        self.H, self.W = img_dataset.H, img_dataset.W

        paint_mask_dir = os.path.join(img_dataset.instance_dir, "paint_mask")
        paint_mask_paths = glob_imgs(paint_mask_dir)
        assert len(paint_mask_paths) == len(images), (
            f"paint_mask/ must contain one mask per view "
            f"({len(paint_mask_paths)} vs {len(images)})")
        self.paint_masks = [
            load_mask(p, img_dataset.downscale).reshape(-1)
            for p in paint_mask_paths]

        ro_p, rd_p, rgb_p = [], [], []
        ro_b, rd_b, rgb_b = [], [], []
        for i in range(len(images)):
            paint_mask = self.paint_masks[i]
            img_mask = masks[i].copy()
            img_mask[paint_mask] = False   # background leaves painted pixels
            rays_o, rays_d = _rays_full_image(
                img_dataset.c2w_all[i], img_dataset.intrinsics_all[i],
                self.H, self.W)
            ro_p.append(rays_o[paint_mask])
            rd_p.append(rays_d[paint_mask])
            rgb_p.append(images[i][paint_mask])
            ro_b.append(rays_o[img_mask])
            rd_b.append(rays_d[img_mask])
            rgb_b.append(images[i][img_mask])

        self.rays_o_paint = np.concatenate(ro_p)
        self.rays_d_paint = np.concatenate(rd_p)
        self.rgb_paint = np.concatenate(rgb_p)
        self.num_paint = len(self.rgb_paint)
        self.rays_o_bg = np.concatenate(ro_b)
        self.rays_d_bg = np.concatenate(rd_b)
        self.rgb_bg = np.concatenate(rgb_b)
        self.num_bg = len(self.rgb_bg)
        assert self.num_paint > 0, "no painted pixels found in paint_mask/"

    def __len__(self):
        return max(self.num_paint, self.num_bg)

    def __getitem__(self, idx: int):
        ip = idx % self.num_paint
        ib = idx % self.num_bg
        sample = {
            "rays_o_paint": self.rays_o_paint[ip],
            "rays_d_paint": self.rays_d_paint[ip],
            "mask_paint": True,
            "rays_o_bg": self.rays_o_bg[ib],
            "rays_d_bg": self.rays_d_bg[ib],
            "mask_bg": True,
        }
        ground_truth = {"rgb_paint": self.rgb_paint[ip],
                        "rgb_bg": self.rgb_bg[ib]}
        return idx, sample, ground_truth

    def batch(self, indices):
        """(indices, model_input, ground_truth) of numpy arrays."""
        ip = np.asarray(indices) % self.num_paint
        ib = np.asarray(indices) % self.num_bg
        model_input = {
            "rays_o_paint": self.rays_o_paint[ip],
            "rays_d_paint": self.rays_d_paint[ip],
            "mask_paint": np.ones(len(ip), bool),
            "rays_o_bg": self.rays_o_bg[ib],
            "rays_d_bg": self.rays_d_bg[ib],
            "mask_bg": np.ones(len(ib), bool),
        }
        ground_truth = {"rgb_paint": self.rgb_paint[ip],
                        "rgb_bg": self.rgb_bg[ib]}
        return np.asarray(indices), model_input, ground_truth

    def epoch_batches(self, batch_size: int, rng: np.random.Generator,
                      shuffle: bool = True):
        """One epoch of full batches in an order drawn from `rng`."""
        order = np.arange(len(self))
        if shuffle:
            rng.shuffle(order)
        for i in range(0, len(order) - batch_size + 1, batch_size):
            yield self.batch(order[i:i + batch_size])
