"""Training logger (counterpart of neumesh_tpu/utils/logger.py): a stats
dict {category: {key: [(it, value), ...]}} pickled per process as
stats.p_<rank>, image dumps as PNGs, and TensorBoard scalars and images
when torch.utils.tensorboard can be imported (monitoring "tensorboard");
otherwise the monitoring is "none" and a warning is logged."""
from __future__ import annotations

import os
import pickle
from collections import defaultdict

import numpy as np

from .image_io import write_png
from .print_fn import log, process_index


class Logger:
    def __init__(self, log_dir: str, img_dir: str = None,
                 monitoring: str = "none", monitoring_dir: str = None,
                 rank: int = None, is_master: bool = None):
        self.rank = process_index() if rank is None else rank
        self.is_master = (self.rank == 0) if is_master is None else is_master
        self.log_dir = log_dir
        self.img_dir = img_dir or os.path.join(log_dir, "imgs")
        self.stats = defaultdict(lambda: defaultdict(list))
        os.makedirs(self.log_dir, exist_ok=True)
        os.makedirs(self.img_dir, exist_ok=True)
        self.monitoring = "none"
        self.tb = None
        if monitoring == "tensorboard" and self.is_master:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self.tb = SummaryWriter(
                    monitoring_dir or os.path.join(log_dir, "events"))
                self.monitoring = "tensorboard"
            except Exception as e:      # no tensorboard package
                log.warning(f"tensorboard unavailable ({e}); monitoring: "
                            "none")

    def add(self, category: str, k: str, v, it: int):
        v = float(np.asarray(v))
        self.stats[category][k].append((it, v))
        if self.tb is not None:
            self.tb.add_scalar(f"{category}/{k}", v, it)

    def add_vector(self, category: str, k: str, vec, it: int):
        vec = np.asarray(vec)
        self.add(category, f"{k}_mean", vec.mean(), it)
        self.add(category, f"{k}_min", vec.min(), it)
        self.add(category, f"{k}_max", vec.max(), it)
        self.add(category, f"{k}_norm", np.linalg.norm(vec), it)

    def add_imgs(self, imgs, class_name: str, it: int):
        """imgs: (H, W, 3) float in [0, 1] or uint8."""
        outdir = os.path.join(self.img_dir, class_name)
        os.makedirs(outdir, exist_ok=True)
        arr = np.asarray(imgs)
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
        write_png(os.path.join(outdir, f"{it:08d}_{self.rank}.png"), arr)
        if self.tb is not None:
            self.tb.add_image(class_name, arr, it, dataformats="HWC")

    def save_stats(self, filename: str = None):
        filename = filename or f"stats.p_{self.rank}"
        with open(os.path.join(self.log_dir, filename), "wb") as f:
            pickle.dump({k: dict(v) for k, v in self.stats.items()}, f)

    def load_stats(self, path: str) -> bool:
        if not os.path.exists(path):
            return False
        with open(path, "rb") as f:
            loaded = pickle.load(f)
        for cat, kv in loaded.items():
            for k, v in kv.items():
                self.stats[cat][k] = list(v)
        return True

    def flush(self):
        if self.tb is not None:
            self.tb.flush()
        self.save_stats()
