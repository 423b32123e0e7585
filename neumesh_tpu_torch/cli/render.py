"""Novel-view synthesis CLI (counterpart of the repository's render.py).

Renders a camera path (a spiral around the dataset's cameras, or dataset
views) from a reference-format `.pt` checkpoint and writes per-view rgb
and normal PNGs, and rgb/depth videos where imageio can be imported.
Prints the throughput in Mrays/s.

    python -m neumesh_tpu_torch.cli.render --config <yaml> --load_pt <.pt> \\
        [render.py's flags] [--section:key value ...] [--device cpu]

Runs on the card unless --device cpu is given; without a card and without
that flag it raises. Each view is one call of the frame entry of its mode
(render/volume.py::render_image in raster order, or
render/ray_casting.py::render_surface_image in pixel blocks of
--surface_ray_tile rays). --volume_devices / --surface_devices shard each
chunk's rays over local cards (0, the default: all of them; 1: the
single-device path), a replica of the model on each. Output goes to
out/<outbase or expname>/ under the working directory, as render.py
writes it.
"""
from __future__ import annotations

import logging
import os
import sys
import time

import numpy as np
import torch

from .. import resolve_device
from ..config import create_args_parser, load_config
from ..dataio import get_data
from ..models import build_framework
from ..ops.cameras import c2w_track_spiral, normalize, poses_avg
from ..ops.rays import pixel_block
from ..parallel import get_device_mesh, replicate
from ..render.ray_casting import render_surface_image
from ..render.volume import render_image
from ..utils.checkpoints import CheckpointIO, sorted_ckpts
from ..utils.image_io import write_png

log = logging.getLogger("neumesh_tpu_torch")


def _integerify(img):
    return (np.clip(img, 0, 1) * 255.0).astype(np.uint8)


def _render_devices(args, key: str, model) -> list:
    """The devices of --volume_devices / --surface_devices: 0 means every
    local card (the CPU counts as one device), 1 the model's device alone;
    n > 1 the first n cards, or n CPU replicas with --device cpu."""
    n = args.get(key, 0) or 0
    dev = model.device
    if dev.type != "cuda":
        return [dev] * max(n, 1)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    cards = get_device_mesh()
    if n > len(cards):
        raise ValueError(f"--{key} {n}: {len(cards)} CUDA devices visible")
    # the model's own card first
    return ([dev] + [d for d in cards if d != dev])[:n or len(cards)]


def _replicas(model, devices) -> list:
    """The model on devices[0] (model itself there) and a copy of it on
    each further device."""
    return [model] + [replicate(model, d) for d in devices[1:]]


def render_function(args, model, render_kwargs_test):
    """Render the camera path in args.render_mode through its frame entry,
    write the PNGs and videos. Returns a dict: mrays_s (steady state when
    there are two views or more), view_s (host seconds per view, rays
    built to a device synchronize), H, W, output_dir, files (the PNGs
    written), rgb / normals / depth (the frames as numpy arrays)."""
    if args.get("dataset_split", None) is not None:
        args.data.split = args.dataset_split
    if args.get("background", None) is not None:
        render_kwargs_test["white_bkgd"] = args.background == 1
    dataset = get_data(args, downscale=args.downscale)

    _, model_input, _ = dataset[0]
    intrinsics = np.array(model_input["intrinsics"])
    H, W = dataset.H, dataset.W
    # resolution overrides rescale the principal point consistently
    if args.get("H", None) is not None:
        intrinsics[1, 2] *= args.H / dataset.H
        H = args.H
    if args.get("H_scale", None) is not None:
        H = int(dataset.H * args.H_scale)
        intrinsics[1, 2] *= H / dataset.H
    if args.get("W", None) is not None:
        intrinsics[0, 2] *= args.W / dataset.W
        W = args.W
    if args.get("W_scale", None) is not None:
        W = int(dataset.W * args.W_scale)
        intrinsics[0, 2] *= W / dataset.W
    log.info(f"=> Rendering resolution @ [{H} x {W}]")

    c2ws = np.stack(dataset.c2w_all, 0)
    if args.get("camera_inds", None):
        # --camera_inds replaces the camera path
        inds = [int(x) for x in str(args.camera_inds)
                .replace("~", ",").split(",") if x != ""]
        render_c2ws = [c2ws[i] for i in inds]
    elif args.camera_path == "spiral":
        if args.get("test_frame", None) is not None:
            test_pose = c2ws[args.test_frame]
            up = test_pose[:3, 1]
            focus_distance = np.linalg.norm(test_pose[:3, 3], axis=-1)
        else:
            test_pose = poses_avg(c2ws)
            focus_distance = np.mean(np.linalg.norm(c2ws[:, :3, 3], axis=-1))
            up = c2ws[:, :3, 1].sum(0)
        rads = np.array([
            np.percentile(np.abs(c2ws[:, 0, 3]), 10, 0),
            np.percentile(np.abs(c2ws[:, 1, 3]), 15, 0),
            np.percentile(np.abs(c2ws[:, 2, 3]), 30, 0),
        ]).reshape(-1)
        for i, r in enumerate((args.get("spiral_rad", []) or [])[:3]):
            if r >= 0:
                rads[i] = r
        render_c2ws = c2w_track_spiral(
            test_pose, normalize(up), rads, focus_distance * 0.8,
            zrate=0.0, rots=1, N=args.num_views)
    elif args.camera_path == "dataset":
        inds = [int(x) for x in str(args.camera_inds or "0")
                .replace("~", ",").split(",") if x != ""]
        render_c2ws = [c2ws[i] for i in inds]
    else:
        raise RuntimeError(
            "Please choose render type between [spiral, dataset]")

    outbase = args.get("outbase", None) or args.expname
    output_dir = os.path.join("out", outbase)
    if args.get("outdirectory", None) is not None:
        output_dir = os.path.join(output_dir, args.outdirectory)
    normal_dir = os.path.join(output_dir, "normal")
    os.makedirs(normal_dir, exist_ok=True)

    out = {"mrays_s": 0.0, "view_s": [], "H": H, "W": W,
           "output_dir": output_dir, "files": [], "rgb": [], "normals": [],
           "depth": []}
    # --disable_rgb skips the render and every write; the camera path and
    # the output directories above are still made
    if args.get("disable_rgb", False):
        log.info("=> --disable_rgb: skipping render + image/video writes")
        return out
    surface = args.get("render_mode", "volume") == "surface"
    if surface:
        entry, kwargs = render_surface_image, surface_kwargs(args, H, W)
        normals_key = "normals_surface"
    else:
        entry, normals_key = render_image, "normals_volume"
        kwargs = {k: v for k, v in render_kwargs_test.items()
                  if k not in ("batched", "rayschunk")}
        if args.get("ray_tile", None):
            kwargs["ray_tile"] = args.ray_tile
        # raster order: --ray_tile shares a context over scanline tiles
        kwargs.update(block=(1, W), calc_normal=True,
                      reuse_upsample_sdf=True, detailed_output=False)
    devices = _render_devices(
        args, "surface_devices" if surface else "volume_devices", model)
    if len(devices) > 1:
        log.info(f"=> {'Surface' if surface else 'Volume'} mode on "
                 f"{len(devices)} devices: " + ", ".join(map(str, devices)))
    replicas = _replicas(model, devices)
    dev = model.device
    total_rays, t_render = 0, 0.0
    for idx, c2w in enumerate(render_c2ws):
        t0 = time.perf_counter()
        rgb, depth, extras = entry(model, c2w, intrinsics, H, W,
                                   rayschunk=args.rayschunk,
                                   replicas=replicas, device=dev, **kwargs)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out["view_s"].append(time.perf_counter() - t0)
        t_render += out["view_s"][-1]
        total_rays += H * W
        rgb = rgb.reshape(H, W, 3).cpu().numpy()
        depth = depth.reshape(H, W, 1).cpu().numpy()
        out["rgb"].append(rgb)
        out["depth"].append(depth / max(float(depth.max()), 1e-9))
        path = os.path.join(output_dir, f"{outbase}_rgb_{idx:03d}.png")
        write_png(path, _integerify(rgb))
        out["files"].append(path)
        if normals_key in extras:
            normals = extras[normals_key].reshape(H, W, 3).cpu().numpy()
            out["normals"].append(normals)
            path = os.path.join(normal_dir, f"{outbase}_normal_{idx:03d}.png")
            write_png(path, _integerify(normals / 2.0 + 0.5))
            out["files"].append(path)
        if idx % 10 == 0:
            log.info(f"view {idx + 1}/{len(render_c2ws)}")

    mrays_s = total_rays / max(t_render, 1e-9) / 1e6
    log.info(f"=> Rendered {total_rays} rays in {t_render:.2f}s: "
             f"{mrays_s:.3f} Mrays/s (incl. compile)")
    if len(out["view_s"]) > 1:
        # the first view carries the kernel build; report steady state too
        mrays_s = ((total_rays - H * W) / max(sum(out["view_s"][1:]), 1e-9)
                   / 1e6)
        log.info(f"=> Steady state (excl. first view): {mrays_s:.3f} Mrays/s")
    out["mrays_s"] = mrays_s

    post_fix = f"{H}x{W}_{args.num_views}_{args.camera_path}"
    _write_videos(output_dir, outbase, post_fix, args.fps,
                  [_integerify(i) for i in out["rgb"]],
                  [_integerify(np.repeat(i, 3, axis=-1))
                   for i in out["depth"]])
    return out


def _write_videos(output_dir, outbase, post_fix, fps, rgb, depth):
    """rgb and depth videos through imageio (mp4, else GIF), or a logged
    skip where imageio cannot be imported."""
    try:
        import imageio.v2 as imageio
    except ImportError:
        log.warning("imageio is not installed: skipping the rgb/depth "
                    "videos (the PNGs are written)")
        return
    for kind, frames in (("rgb", rgb), ("depth", depth)):
        path = os.path.join(output_dir, f"{outbase}_{kind}_{post_fix}.mp4")
        try:
            imageio.mimwrite(path, frames, fps=fps, quality=10)
        except Exception:
            # no ffmpeg backend: fall back to GIF
            gif = os.path.splitext(path)[0] + ".gif"
            imageio.mimwrite(gif, frames, duration=1000.0 / max(fps, 1))
            log.warning(f"mp4 backend unavailable; wrote {gif}")


def main_function(args):
    """Build the model on args.device (default the card), load the
    checkpoint, render. Returns render_function's dict."""
    device = resolve_device(args.get("device", None) or "cuda")
    model, _, _, render_kwargs_test, _ = build_framework(
        args, args.model.framework, device=device)

    if args.get("load_pt", None) is None:
        ckpts = sorted_ckpts(os.path.join(args.training.exp_dir, "ckpts"))
        if not ckpts:
            raise FileNotFoundError(
                f"no checkpoints under {args.training.exp_dir}/ckpts")
        ckpt_file = ckpts[-1]
    else:
        ckpt_file = args.load_pt
    log.info("=> Use ckpt: " + str(ckpt_file))
    CheckpointIO(os.path.dirname(str(ckpt_file)) or ".").load_file(
        str(ckpt_file), model)

    return render_function(args, model, render_kwargs_test)


def surface_kwargs(args, H: int, W: int) -> dict:
    """render_surface_image's keywords from the CLI's surface flags:
    --surface_ray_tile > 1 shares a context over a pixel block of that
    many rays (ops.rays.pixel_block); where none divides the H x W frame,
    tiling is disabled with a warning."""
    tile = args.get("surface_ray_tile", 0) or 0
    if tile > 1 and pixel_block(H, W, tile) is None:
        log.warning(f"surface_ray_tile={tile}: no pixel block divides "
                    f"{H}x{W}; disabling ray tiling for this render "
                    "(scanline tiles degrade tile-shared caches)")
        tile = 0
    return dict(
        ray_tile=tile,
        N_steps=args.get("surface_steps", 128) or 128,
        N_secant_steps=args.get("surface_secant_steps", 8) or 8,
        scan_mode=args.get("surface_scan", "density") or "density",
        tile_max_candidates=args.get("surface_max_candidates", 0) or None,
        shade_composite=args.get("surface_shade_composite", 0) or 0,
        shade_topk=args.get("surface_shade_topk", 0) or 0,
        shade_win_frac=args.get("surface_shade_win_frac", 0.5) or 0.5)


def create_render_args(parser):
    parser.add_argument("--num_views", type=int, default=90)
    parser.add_argument("--downscale", type=float, default=1)
    parser.add_argument("--rayschunk", type=int, default=4096)
    parser.add_argument(
        "--ray_tile", type=int, default=0,
        help="volume mode: share one candidate cache across this many "
             "consecutive rays (raster order: scanline tiles)")
    parser.add_argument("--camera_path", type=str, default="spiral")
    parser.add_argument("--load_pt", type=str, default=None)
    parser.add_argument("--H", type=int, default=None)
    parser.add_argument("--H_scale", type=float, default=None)
    parser.add_argument("--W", type=int, default=None)
    parser.add_argument("--W_scale", type=float, default=None)
    parser.add_argument("--fps", type=int, default=30)
    parser.add_argument("--outbase", type=str, default=None)
    parser.add_argument("--outdirectory", type=str, default=None)
    parser.add_argument("--background", type=int, default=None)
    parser.add_argument("--test_frame", type=int, default=None)
    parser.add_argument("--spiral_rad", type=float, nargs="+", default=[])
    parser.add_argument("--dataset_split", default="entire", type=str)
    parser.add_argument("--disable_rgb", action="store_true")
    parser.add_argument(
        "--render_mode", type=str, default="volume",
        choices=["volume", "surface"],
        help="volume: full NeuS volume rendering (quality); surface: "
             "root-finding surface hit + one color query per ray (fast)")
    parser.add_argument(
        "--surface_steps", type=int, default=128,
        help="surface mode: sign-change scan steps over the mesh-bounded "
             "interval")
    parser.add_argument(
        "--surface_secant_steps", type=int, default=8,
        help="surface mode: secant refinement iterations")
    parser.add_argument(
        "--surface_ray_tile", type=int, default=0,
        help="surface mode: share one candidate cache across this many "
             "rays of a pixel block")
    parser.add_argument(
        "--surface_devices", type=int, default=0,
        help="surface mode: shard each chunk's rays over this many local "
             "devices (0 = all, 1 = the single-device path)")
    parser.add_argument(
        "--volume_devices", type=int, default=0,
        help="volume mode: shard each chunk's rays over this many local "
             "devices (0 = all, 1 = the single-device path)")
    parser.add_argument(
        "--surface_scan", type=str, default="density",
        choices=["density", "distance"],
        help="surface mode: field for the sign-change scan; 'distance' "
             "scans the interpolated mesh distance and refines on the "
             "density")
    parser.add_argument(
        "--surface_max_candidates", type=int, default=0,
        help="surface mode: ranked tile-context candidate cap "
             "(0 = uncapped)")
    parser.add_argument(
        "--surface_shade_composite", type=int, default=0,
        help="surface mode: alpha-composite this many root-anchored "
             "sample depths instead of one color query at the root "
             "(0 = point shade)")
    parser.add_argument(
        "--surface_shade_topk", type=int, default=0,
        help="surface mode: color_topk of the micro-composite "
             "(0 = color at every midpoint)")
    parser.add_argument(
        "--surface_shade_win_frac", type=float, default=0.5,
        help="surface mode: win_frac of the micro-composite depths")
    parser.add_argument(
        "--camera_inds", type=str, default=None,
        help="comma-separated dataset view indices to render instead of the "
             "spiral path (e.g. '0,5,10')")
    parser.add_argument(
        "--device", type=str, default="cuda",
        help="torch device to render on; 'cpu' runs the kernels' plain "
             "versions (tests)")
    return parser


def main(argv=None):
    parser = create_render_args(create_args_parser())
    args, unknown = parser.parse_known_args(argv)
    return main_function(load_config(args, unknown))


if __name__ == "__main__":
    logging.basicConfig(stream=sys.stdout, level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s",
                        datefmt="%H:%M:%S")
    main()
