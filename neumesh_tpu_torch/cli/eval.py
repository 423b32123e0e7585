"""Quality evaluation CLI (counterpart of the repository's eval.py): render
dataset views from a checkpoint and report PSNR / SSIM (and LPIPS where
its weight files are given) per view.

    python -m neumesh_tpu_torch.cli.eval --config <config.yaml> \\
        [--load_pt <.ckpt|.pt>] [--views 0,5,10] [--downscale 2] \\
        [--val_names val_names.txt] [--out_json out.json] \\
        [--save_renders <dir>] [--device cpu]

Renders with the config's test render kwargs, perturb off and the
up-sampling loop's SDF values reused. Prints one JSON line (mean PSNR,
mean SSIM, view count). Runs on the card unless --device cpu is given;
without a card and without that flag it raises.
"""
from __future__ import annotations

import json
import logging
import os
import sys

import numpy as np
import torch

from .. import resolve_device, set_fp32_precision
from ..config import create_args_parser, load_config
from ..dataio import get_data
from ..dataio.dtu import glob_imgs
from ..models import build_framework
from ..ops.lpips import load_lpips_weights, lpips as lpips_fn
from ..ops.metrics import psnr as psnr_fn, ssim as ssim_fn
from ..render.volume import render_image
from ..utils.checkpoints import CheckpointIO, sorted_ckpts
from ..utils.image_io import write_png

log = logging.getLogger("neumesh_tpu_torch")


def _image_names(args) -> dict:
    """{dataset view index: image basename without extension}."""
    paths = glob_imgs(os.path.join(args.data.data_dir, "image"))
    return {i: os.path.splitext(os.path.basename(p))[0]
            for i, p in enumerate(paths)}


def _views(args, n_views: int) -> list:
    if args.get("views", None):
        return [int(x) for x in str(args.views).split(",") if x != ""]
    if args.get("val_names", None):
        # reference-style val split: a file of image basenames
        with open(args.val_names) as f:
            names = {os.path.splitext(line.strip())[0]
                     for line in f if line.strip()}
        views = [i for i, n in _image_names(args).items() if n in names]
        if not views:
            raise ValueError("no dataset views matched val_names")
        return views
    return list(range(n_views))


@torch.no_grad()
def main_function(args, renders=None):
    """Evaluate args.model.framework on args.device (default the card).
    Returns the summary {"views": [{"view", "psnr", "ssim"[, "lpips"]}],
    "mean_psnr", "mean_ssim"[, "mean_lpips"]}; `renders`, a dict, receives
    {view index: predicted (H, W, 3) f32 numpy image}."""
    device = resolve_device(args.get("device", None) or "cuda")
    model, _, _, render_kwargs_test, _ = build_framework(
        args, args.model.framework, device=device)

    ckpt_file = args.get("load_pt", None)
    if ckpt_file is None:
        ckpts = sorted_ckpts(os.path.join(args.training.exp_dir, "ckpts"))
        if not ckpts:
            raise FileNotFoundError("no checkpoint found; pass --load_pt")
        ckpt_file = ckpts[-1]
    log.info(f"=> Use ckpt: {ckpt_file}")
    CheckpointIO(os.path.dirname(str(ckpt_file)) or ".").load_file(
        str(ckpt_file), model)
    if device.type == "cuda":
        set_fp32_precision()        # true-f32 metrics (training sets TF32)

    dataset = get_data(args, downscale=args.downscale)
    H, W = dataset.H, dataset.W
    views = _views(args, len(dataset))

    kwargs = {k: v for k, v in render_kwargs_test.items() if k != "batched"}
    kwargs["rayschunk"] = args.rayschunk
    kwargs["detailed_output"] = False
    kwargs["perturb"] = False
    # inference: reuse the up-sampling loop's SDF evaluations (identical
    # values, one fewer density pass)
    kwargs["reuse_upsample_sdf"] = True

    # LPIPS when the standard weight files are given (ops/lpips.py)
    lpips_w = load_lpips_weights()
    if lpips_w is None:
        log.info("LPIPS weights not found "
                 "(set NEUMESH_LPIPS_VGG/NEUMESH_LPIPS_LIN); skipping")

    # --save_renders <dir>: each predicted view as <basename>.png, a
    # render directory that tools/parity_eval.py --ref_renders reads
    save_dir = args.get("save_renders", None)
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        name_of = _image_names(args)

    rows = []
    for vi in views:
        _, sample, gt = dataset[vi]
        rgb, _, _ = render_image(model, sample["c2w"], sample["intrinsics"],
                                 H, W, block=(1, W), device=device, **kwargs)
        pred = rgb.to(torch.float32)
        if renders is not None:
            renders[vi] = pred.cpu().numpy()
        if save_dir:
            write_png(os.path.join(save_dir, f"{name_of.get(vi, vi)}.png"),
                      (np.clip(pred.cpu().numpy(), 0, 1) * 255.0)
                      .astype(np.uint8))
        ref = torch.as_tensor(np.asarray(gt["rgb"]).reshape(H, W, 3),
                              device=device)
        p = float(psnr_fn(pred, ref))
        s = float(ssim_fn(pred.permute(2, 0, 1), ref.permute(2, 0, 1)))
        row = {"view": int(vi), "psnr": round(p, 3), "ssim": round(s, 4)}
        if lpips_w is not None:
            row["lpips"] = round(float(lpips_fn(lpips_w, pred, ref)[0]), 4)
        rows.append(row)
        log.info(f"view {vi}: psnr {p:.2f} ssim {s:.4f}"
                 + (f" lpips {row['lpips']:.4f}" if lpips_w is not None
                    else ""))

    summary = {
        "views": rows,
        "mean_psnr": round(float(np.mean([r["psnr"] for r in rows])), 3),
        "mean_ssim": round(float(np.mean([r["ssim"] for r in rows])), 4),
    }
    if rows and "lpips" in rows[0]:
        summary["mean_lpips"] = round(
            float(np.mean([r["lpips"] for r in rows])), 4)
    out = args.get("out_json", None)
    if out:
        with open(out, "w") as f:
            json.dump(summary, f, indent=2)
    print(json.dumps({"mean_psnr": summary["mean_psnr"],
                      "mean_ssim": summary["mean_ssim"],
                      "n_views": len(rows)}))
    return summary


def create_eval_args(parser):
    parser.add_argument("--load_pt", type=str, default=None)
    parser.add_argument("--downscale", type=float, default=1)
    parser.add_argument("--rayschunk", type=int, default=4096)
    parser.add_argument("--views", type=str, default=None)
    parser.add_argument("--val_names", type=str, default=None)
    parser.add_argument("--out_json", type=str, default=None)
    parser.add_argument(
        "--save_renders", type=str, default=None,
        help="directory to dump predicted views as <basename>.png "
             "(consumable by tools/parity_eval.py --ref_renders)")
    parser.add_argument(
        "--device", type=str, default="cuda",
        help="torch device to render on; 'cpu' runs the kernels' plain "
             "versions (tests)")
    return parser


def main(argv=None, renders=None):
    parser = create_eval_args(create_args_parser())
    args, unknown = parser.parse_known_args(argv)
    return main_function(load_config(args, unknown), renders=renders)


if __name__ == "__main__":
    logging.basicConfig(stream=sys.stdout, level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s",
                        datefmt="%H:%M:%S")
    main()
