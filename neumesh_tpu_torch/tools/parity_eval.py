"""Reference-checkpoint parity table (counterpart of the repository's
tools/parity_eval.py), over the port's eval CLI.

    python -m neumesh_tpu_torch.tools.parity_eval --config <config.yaml> \\
        --load_pt <released latest.pt> --val_names <scene>/val_names.txt \\
        [--ref_renders <dir of reference-rendered val views>] \\
        [--out_json parity_scan63.json] [--device cpu]

- Renders every val view from the checkpoint and scores PSNR / SSIM
  against the dataset's ground truth (cli/eval.py).
- With --ref_renders holding the reference implementation's renders of
  the same views (PNGs named as the dataset images), also scores the
  reference against ground truth and prints the per-view deltas the
  +-0.1 dB parity gate is judged on.

Runs on the card unless --device cpu is given.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..cli import eval as eval_cli
from ..config import create_args_parser, load_config
from ..dataio import get_data
from ..dataio.dtu import glob_imgs
from ..ops.metrics import psnr as psnr_fn
from ..utils.image_io import read_png


def load_image(path, H, W):
    img = np.asarray(read_png(path), np.float64)
    if img.shape[0] != H or img.shape[1] != W:
        raise ValueError(
            f"{path}: reference render is {img.shape[:2]}, dataset views "
            f"are {(H, W)}: render the reference at the same scale")
    return (img[..., :3] / 255.0).astype(np.float32)


def parity_rows(config, summary, ref_dir):
    """One row a view with a reference render: the reference's PSNR
    against ground truth and ours minus it."""
    dataset = get_data(config, downscale=config.downscale)
    H, W = dataset.H, dataset.W
    paths = glob_imgs(os.path.join(config.data.data_dir, "image"))
    name_of = {i: os.path.splitext(os.path.basename(p))[0]
               for i, p in enumerate(paths)}
    ref_files = {os.path.splitext(f)[0]: os.path.join(ref_dir, f)
                 for f in os.listdir(ref_dir)}
    rows = []
    for row in summary["views"]:
        vi = row["view"]
        name = name_of.get(vi)
        if name not in ref_files:
            print(f"[parity] no reference render for view {vi} ({name}); "
                  "skipping")
            continue
        _, _, gt = dataset[vi]
        ref_img = load_image(ref_files[name], H, W)
        gt_img = np.asarray(gt["rgb"]).reshape(H, W, 3)
        ref_psnr = float(psnr_fn(torch.from_numpy(ref_img),
                                 torch.from_numpy(gt_img)))
        rows.append({"view": vi, "name": name, "psnr_ours": row["psnr"],
                     "psnr_ref": round(ref_psnr, 3),
                     "delta_db": round(row["psnr"] - ref_psnr, 3)})
    return rows


def main(argv=None):
    parser = eval_cli.create_eval_args(create_args_parser())
    parser.add_argument("--ref_renders", type=str, default=None)
    args, unknown = parser.parse_known_args(argv)
    config = load_config(args, unknown)

    out_json = config.pop("out_json", None)
    ref_dir = config.pop("ref_renders", None)
    summary = eval_cli.main_function(config)

    table = {"ours_vs_gt": summary}
    if ref_dir:
        rows = parity_rows(config, summary, ref_dir)
        deltas = [r["delta_db"] for r in rows]
        table["parity"] = {
            "views": rows,
            "mean_delta_db": (round(float(np.mean(deltas)), 3) if rows
                              else None),
            "within_0p1_db": bool(rows and abs(np.mean(deltas)) <= 0.1),
        }
        print("view  name            ours    ref     delta")
        for r in rows:
            print(f"{r['view']:<5} {r['name']:<15} {r['psnr_ours']:<7} "
                  f"{r['psnr_ref']:<7} {r['delta_db']:+.3f}")
        if rows:
            print(f"mean delta: {table['parity']['mean_delta_db']:+.3f} dB "
                  "(gate: +-0.1 dB)")

    if out_json:
        with open(out_json, "w") as f:
            json.dump(table, f, indent=2)
    return table


if __name__ == "__main__":
    main()
