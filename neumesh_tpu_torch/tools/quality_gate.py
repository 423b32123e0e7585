"""End-to-end quality gate on a synthetic scene (counterpart of the
repository's tools/quality_gate.py), run by the port.

Trains the product pipeline: NeuS teacher -> extracted mesh -> NeuMesh
distillation, through the port's train loop, then scores held-out views
four ways:

  volume_f32     volume render, the f32 context math over 16-ray scanline
                 contexts, up-sampling density on the f32 field_fused
                 (the parity mode)
  volume_bf16    the root-anchored bf16 serving structure on the kernels
  surface_f32    surface mode in f32 at the SAME structural config as
                 serving (steps/secant/kp): the precision parity anchor
  surface_fast   surface mode at the serving configuration (bf16 with the
                 selective-f32 layers, distance-proxy scan, tile 128)

and prints one JSON line with the PSNRs and the gated deltas:
gate_bf16 (surface_fast within 0.1 dB of surface_f32), gate_surface
(surface_fast within 1 dB below volume_bf16 on ground truth) and
gate_volume (volume_bf16 at most 0.1 dB below volume_f32).

    python -m neumesh_tpu_torch.tools.quality_gate [--iters 3000] \\
        [--scene sphere|torus] [--workdir DIR] [--device cpu]

Flags as the JAX gate's, except --secant-tiles-per-program and the TPU
sample block, which exist only for the TPU's program blocking and have no
counterpart here. --log-every sets the train loop's log interval. Runs on
the card unless --device cpu is given; without a card and without that
flag it raises.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from .. import resolve_device, set_fp32_precision
from ..config import ConfigDict

# the gate scene (20 views, 128x128, focal 160), its scored views, and the
# prior mesh's extraction box
SCENE = dict(n_views=20, H=128, W=128, focal=160.0)
EVAL_VIEWS = (1, 6, 11, 16)
EXTRACT_RANGE = (-0.75, 0.75)
MODES = ("volume_f32", "volume_bf16", "surface_f32", "surface_fast")


def neus_config(workdir, iters, log_every=500):
    return ConfigDict({
        "expname": "qgate_neus",
        "device_ids": [0],
        "data": {
            "type": "DTU", "data_dir": os.path.join(workdir, "scene"),
            "downscale": 1, "N_rays": 512, "batch_size": 1,
            "val_downscale": 4.0, "val_rayschunk": 1024,
            "obj_bounding_radius": 1.0,
        },
        "model": {
            "framework": "NeuS", "obj_bounding_radius": 1.0,
            "W_geometry_feature": 256,
            "variance_init": 0.05,
            "surface": {"D": 4, "W": 128, "skips": [], "embed_multires": 6,
                        "radius_init": 0.6},
            "radiance": {"D": 2, "W": 128, "embed_multires": -1,
                         "embed_multires_view": 4},
            "N_upsample_iters": 4, "N_samples": 64, "N_importance": 64,
        },
        "training": {
            "speed_factor": 10.0, "lr": 5e-4, "num_iters": iters,
            "scheduler": {"type": "warmupcosine", "warmup_steps": 200},
            "loss_weights": {"img": 1.0, "mask": 0.5, "eikonal": 0.1},
            "log_root_dir": os.path.join(workdir, "logs"),
            "i_val": -1, "i_backup": -1, "i_save": 10000,
            "i_log": log_every, "monitoring": "none",
        },
    })


def neumesh_config(workdir, iters, mesh_path, neus_dir, log_every=500):
    return ConfigDict({
        "expname": "qgate_neumesh",
        "device_ids": [0],
        "data": {
            "type": "DTU", "data_dir": os.path.join(workdir, "scene"),
            "downscale": 1, "N_rays": 512, "batch_size": 1,
            "val_downscale": 4.0, "val_rayschunk": 1024,
            "obj_bounding_radius": 1.0,
        },
        "model": {
            "framework": "NeuMesh", "prior_mesh": mesh_path,
            "distance_method": "grid",
            "D_density": 3, "D_color": 4, "W": 256,
            "geometry_dim": 32, "color_dim": 32,
            "multires_d": 8, "multires_fg": 2, "multires_ft": 2,
            "multires_view": 4,
            "bounded_near_far": True, "enable_nablas_input": True,
            "learn_indicator_weight": True,
            "N_upsample_iters": 4, "N_samples": 64, "N_importance": 64,
        },
        "training": {
            "speed_factor": 10.0, "lr": 5e-4, "num_iters": iters,
            "scheduler": {"type": "warmupcosine", "warmup_steps": 200},
            "loss_weights": {"img": 1.0, "mask": 0.1, "eikonal": 0.1,
                             "distill_density": 1.0, "distill_color": 1.0,
                             "indicator_reg": 0.001},
            "teacher_config": os.path.join(neus_dir, "config.yaml"),
            "teacher_ckpt": os.path.join(neus_dir, "ckpts", "latest.ckpt"),
            "log_root_dir": os.path.join(workdir, "logs"),
            "i_val": -1, "i_backup": -1, "i_save": 10000,
            "i_log": log_every, "monitoring": "none",
        },
    })


def create_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=3000)
    ap.add_argument("--workdir", default=None,
                    help="default <tmp>/qgate_torch (sphere) / "
                         "<tmp>/qgate_torch_<scene> otherwise")
    ap.add_argument("--scene", default="sphere", choices=["sphere", "torus"],
                    help="gate scene: 'sphere' (convex, single-crossing) "
                         "or 'torus' (torus + offset sphere: "
                         "multi-crossing, self-occluding); every serving "
                         "gate must pass on both")
    ap.add_argument("--skip-train", action="store_true",
                    help="reuse checkpoints already in workdir")
    ap.add_argument("--modes", default=",".join(MODES),
                    help="which configurations to (re-)render; omitted "
                         "ones carry their scores forward from the "
                         "workdir's existing quality_gate.json")
    ap.add_argument("--secant-full-precision", action="store_true",
                    help="keep the f32_layers overrides inside the secant "
                         "refinement (serving default drops them)")
    ap.add_argument("--f32-layers", default="d0,dh,c0,ch",
                    help="comma-separated selective-f32 layer tags of the "
                         "serving config (empty = plain bf16)")
    ap.add_argument("--surface-steps", type=int, default=16,
                    help="N_steps of the distance-proxy scan in the "
                         "surface configs (serving and its f32 anchor)")
    ap.add_argument("--surface-secant", type=int, default=3,
                    help="N_secant_steps of the surface configs")
    ap.add_argument("--serving-kp", type=int, default=8,
                    help="tile_kp_per_probe of the surface models")
    ap.add_argument("--scan-knn-k", type=int, default=1,
                    help="reduced-k kNN for the scan distance proxy "
                         "(0 = full k=8); serving and the f32 anchor")
    ap.add_argument("--secant-frozen-knn", action="store_true",
                    help="freeze the secant's per-ray top-k selection at "
                         "the bracket midpoint (serving config only)")
    ap.add_argument("--no-secant-rebracket", action="store_true",
                    help="skip the density re-bracket of the proxy scan")
    ap.add_argument("--surface-shade-composite", type=int, default=0,
                    help="micro-composite shading of the surface configs: "
                         "N root-anchored sample depths (0 = point shade)")
    ap.add_argument("--surface-shade-topk", type=int, default=0,
                    help="color_topk of the surface micro-composite")
    ap.add_argument("--surface-shade-win-frac", type=float, default=0.5,
                    help="win_frac of the surface micro-composite depths")
    ap.add_argument("--surface-tile", type=int, default=128,
                    help="rays per shared tile context of the surface "
                         "configs")
    ap.add_argument("--surface-blocks", type=int, nargs=2, default=(8, 16),
                    help="pixel-block shape feeding the tiles")
    ap.add_argument("--tile-cell-budget", type=int, default=64,
                    help="cell-level pre-rank budget of the tile context "
                         "build (0 = off); serving and the f32 anchor")
    ap.add_argument("--scan-candidates", type=int, default=0,
                    help="nearest-prefix candidate budget for scan + "
                         "secant (0 = full)")
    ap.add_argument("--volume-root-anchored", type=int, default=1,
                    help="root-anchored volume serving (1 = on; 0 = "
                         "hierarchical), volume_bf16 only")
    ap.add_argument("--volume-n-fine", type=int, default=8,
                    help="samples per ray of the root-anchored path")
    ap.add_argument("--volume-root-steps", type=int, default=16,
                    help="proxy-scan steps of the root-anchored path")
    ap.add_argument("--volume-root-secant", type=int, default=3,
                    help="secant iterations of the root-anchored path")
    ap.add_argument("--volume-win-frac", type=float, default=0.25,
                    help="fraction of root-anchored samples in the dense "
                         "window around the root")
    ap.add_argument("--volume-topk", type=int, default=4,
                    help="color_topk of the volume serving config")
    ap.add_argument("--volume-tile", type=int, default=128,
                    help="rays per shared tile context of the volume "
                         "serving config")
    ap.add_argument("--volume-max-candidates", type=int, default=128,
                    help="ranked tile-context candidate cap of the volume "
                         "serving config (0 = uncapped)")
    ap.add_argument("--eval-candidates", type=int, default=0,
                    help="nearest-prefix candidate budget of the fused "
                         "density/color sample evals (0 = full set); "
                         "volume serving config only")
    ap.add_argument("--train-matmul-precision", default=None,
                    help="override training.matmul_precision of the gate "
                         "trainings")
    ap.add_argument("--train-student-dtype", default=None,
                    help="train the NeuMesh distillation with this student "
                         "compute dtype (selective-f32 first/head layers)")
    ap.add_argument("--train-teacher-dtype", default=None,
                    help="run the no-grad distillation teacher at this "
                         "compute dtype (training.teacher_dtype)")
    ap.add_argument("--n-grid", type=int, default=96,
                    help="marching-tetrahedra grid for the prior mesh")
    ap.add_argument("--log-every", type=int, default=500,
                    help="training.i_log of the gate trainings")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain "
                         "versions (tests)")
    return ap


def paths_of(args) -> dict:
    workdir = args.workdir or os.path.join(
        tempfile.gettempdir(),
        "qgate_torch" if args.scene == "sphere"
        else f"qgate_torch_{args.scene}")
    logs = os.path.join(workdir, "logs")
    return {"workdir": workdir, "scene": os.path.join(workdir, "scene"),
            "neus_dir": os.path.join(logs, "qgate_neus"),
            "mesh_dir": os.path.join(workdir, "mesh"),
            "mesh_path": os.path.join(workdir, "mesh", "extracted_0.ply"),
            "nm_dir": os.path.join(logs, "qgate_neumesh"),
            "json": os.path.join(workdir, "quality_gate.json")}


def make_scene(args, p) -> None:
    from ..dataio.synthetic import generate_sphere_scene, generate_torus_scene
    if os.path.exists(os.path.join(p["scene"], "cameras.npz")):
        return
    print(f"=> generating {args.scene} scene ({SCENE['n_views']} views, "
          f"{SCENE['H']}x{SCENE['W']})")
    gen = (generate_sphere_scene if args.scene == "sphere"
           else generate_torus_scene)
    gen(p["scene"], **SCENE)


def _latest(d):
    return os.path.join(d, "ckpts", "latest.ckpt")


def _train_configs(args, p):
    ncfg = neus_config(p["workdir"], args.iters, args.log_every)
    mcfg = neumesh_config(p["workdir"], args.iters, p["mesh_path"],
                          p["neus_dir"], args.log_every)
    for cfg in (ncfg, mcfg):
        cfg["device"] = args.device
        if args.train_matmul_precision:
            cfg.training["matmul_precision"] = args.train_matmul_precision
    if args.train_student_dtype:
        mcfg.model["compute_dtype"] = args.train_student_dtype
        mcfg.model["f32_layers"] = ("d0", "dh", "c0", "ch")
    if args.train_teacher_dtype:
        mcfg.training["teacher_dtype"] = args.train_teacher_dtype
    return ncfg, mcfg


def train(args, p) -> dict:
    """Teacher, prior mesh, student (each skipped where its files exist
    and --skip-train asks for reuse). Ends with true-f32 matmuls restored
    (the train loop turns TF32 on for the card, process-wide). Returns
    {"neus_s", "neumesh_s" (wall seconds of each training run),
    "extract" (extract_mesh's stats, n_vertices, n_triangles)}."""
    from ..cli.extract_mesh import extract_mesh
    from ..models import build_framework
    from ..train.loop import main_function
    from ..utils.checkpoints import CheckpointIO
    out = {}
    ncfg, mcfg = _train_configs(args, p)
    if not (args.skip_train and os.path.exists(_latest(p["nm_dir"]))):
        if os.path.exists(_latest(p["neus_dir"])):
            print("=> NeuS teacher checkpoint exists; skipping")
        else:
            print(f"=> training NeuS teacher ({args.iters} iters)")
            t0 = time.perf_counter()
            main_function(ncfg)
            out["neus_s"] = time.perf_counter() - t0

        print("=> extracting prior mesh")
        ncfg, _ = _train_configs(args, p)
        model_t, *_ = build_framework(ncfg, "NeuS",
                                      device=resolve_device(args.device))
        CheckpointIO().load_file(_latest(p["neus_dir"]), model_t)
        stats = {}
        mesh = extract_mesh(model_t, N_grid=args.n_grid,
                            x_range=EXTRACT_RANGE, y_range=EXTRACT_RANGE,
                            z_range=EXTRACT_RANGE, sdf_th=0.0, chunk=65536,
                            scale_factor=1.0, output_dir=p["mesh_dir"],
                            obj_id="0", stats=stats)
        out["extract"] = dict(stats, n_vertices=mesh.n_vertices,
                              n_triangles=mesh.n_triangles)
        del model_t

        print(f"=> distilling NeuMesh ({args.iters} iters)")
        t0 = time.perf_counter()
        main_function(mcfg)
        out["neumesh_s"] = time.perf_counter() - t0
    set_fp32_precision()
    return out


def make_model(args, p, tag):
    """The NeuMesh of one gate mode, every knob through its config (as
    the JAX gate builds it), with the distilled checkpoint loaded."""
    from ..models import build_framework
    from ..utils.checkpoints import CheckpointIO
    use_pallas = tag != "volume_f32"
    bf16 = tag in ("volume_bf16", "surface_fast")
    cfg = neumesh_config(p["workdir"], args.iters, p["mesh_path"],
                         p["neus_dir"])
    m = cfg.model
    m["use_pallas"] = use_pallas
    if use_pallas:
        m["tile_kp_per_probe"] = 12 if tag == "volume_bf16" \
            else args.serving_kp
        if args.scan_knn_k:
            m["scan_knn_k"] = args.scan_knn_k
        if args.scan_candidates:
            m["scan_candidates"] = args.scan_candidates
        if args.tile_cell_budget:
            m["tile_cell_budget"] = args.tile_cell_budget
        if args.no_secant_rebracket:
            m["secant_rebracket"] = False
        if tag == "volume_bf16" and args.eval_candidates:
            m["eval_candidates"] = args.eval_candidates
    if tag == "surface_fast":
        m["secant_full_precision"] = bool(args.secant_full_precision)
        m["secant_frozen_knn"] = bool(args.secant_frozen_knn)
        m["f32_layers"] = serving_f32_layers(args)
    if bf16:
        m["compute_dtype"] = "bfloat16"
    # the scoring builds no teacher: only the student's files are read
    cfg.training.pop("teacher_config")
    cfg.training.pop("teacher_ckpt")
    model, *_ = build_framework(cfg, "NeuMesh",
                                device=resolve_device(args.device))
    CheckpointIO().load_file(_latest(p["nm_dir"]), model)
    model.requires_grad_(False)
    return model


def serving_f32_layers(args) -> tuple:
    return tuple(t for t in (args.f32_layers or "").split(",") if t)


def render_fn(args, model, tag, H, W):
    """(c2w, K) -> the H x W view's rgb (H*W, 3) in raster order, through
    the frame entry of the mode."""
    from ..render.ray_casting import render_surface_image
    from ..render.volume import render_image
    dev = model.device
    if tag.startswith("volume"):
        serving = tag == "volume_bf16"
        kw = dict(detailed_output=False, perturb=False,
                  bounded_near_far=True, N_samples=64, N_importance=64,
                  N_upsample_iters=4, reuse_upsample_sdf=True,
                  root_steps=args.volume_root_steps,
                  root_secant=args.volume_root_secant,
                  root_n_fine=args.volume_n_fine,
                  root_win_frac=args.volume_win_frac)
        if serving:
            kw.update(ray_tile=args.volume_tile,
                      tile_max_candidates=args.volume_max_candidates or None,
                      color_topk=args.volume_topk,
                      root_anchored=bool(args.volume_root_anchored),
                      block=(8, 16) if args.volume_tile >= 128 else (8, 8))
        else:
            kw.update(ray_tile=16, block=(1, W))

        def r(c2w, K):
            return render_image(model, c2w, K, H, W, device=dev,
                                **kw)[0].reshape(H * W, 3)
        return r

    def s(c2w, K):
        # pixel-block tiling: compact ray bundles a shared context
        return render_surface_image(
            model, c2w, K, H, W, ray_tile=args.surface_tile,
            block=tuple(args.surface_blocks), scan_mode="distance",
            tile_max_candidates=128,
            shade_composite=args.surface_shade_composite,
            shade_topk=args.surface_shade_topk,
            shade_win_frac=args.surface_shade_win_frac,
            N_steps=args.surface_steps, N_secant_steps=args.surface_secant,
            device=dev)[0].reshape(H * W, 3)
    return s


@torch.no_grad()
def score_mode(args, p, tag, lpips_w=None):
    """Render EVAL_VIEWS in one mode: {"psnr", "ssim"[, "lpips"]} lists a
    view, "renders" (each (H*W, 3) f32 numpy), "view_s" (host
    seconds a view, each ending in a device synchronize)."""
    from ..dataio import get_data
    from ..ops.lpips import lpips as lpips_fn
    from ..ops.metrics import psnr as psnr_fn, ssim as ssim_fn
    dev = resolve_device(args.device)
    model = make_model(args, p, tag)
    ds = get_data(neumesh_config(p["workdir"], args.iters, p["mesh_path"],
                                 p["neus_dir"]), downscale=1)
    fn = render_fn(args, model, tag, ds.H, ds.W)
    out = {"psnr": [], "ssim": [], "renders": [], "view_s": []}
    for vi in EVAL_VIEWS:
        _, sample, gt = ds[vi]
        t0 = time.perf_counter()
        rgb = fn(sample["c2w"], sample["intrinsics"]).to(torch.float32)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out["view_s"].append(time.perf_counter() - t0)
        gt_rgb = torch.as_tensor(np.asarray(gt["rgb"]), device=dev)
        out["renders"].append(rgb.cpu().numpy())
        out["psnr"].append(float(psnr_fn(rgb, gt_rgb)))
        pred_hw = rgb.reshape(ds.H, ds.W, 3)
        gt_hw = gt_rgb.reshape(ds.H, ds.W, 3)
        out["ssim"].append(float(ssim_fn(pred_hw.permute(2, 0, 1),
                                         gt_hw.permute(2, 0, 1))))
        if lpips_w is not None:
            out.setdefault("lpips", []).append(
                float(lpips_fn(lpips_w, pred_hw, gt_hw)[0]))
    print(f"{tag}: mean PSNR {np.mean(out['psnr']):.2f} dB "
          f"SSIM {np.mean(out['ssim']):.4f} "
          f"({[round(x, 2) for x in out['psnr']]}); ms a view "
          f"{[round(1e3 * x, 1) for x in out['view_s']]}")
    return out


def _image_psnr(renders_a, renders_b) -> float:
    from ..ops.metrics import psnr as psnr_fn
    return round(float(np.mean([
        float(psnr_fn(torch.from_numpy(a), torch.from_numpy(b)))
        for a, b in zip(renders_a, renders_b)])), 3)


def gate_results(scores, args, prev=None) -> dict:
    """The gate JSON from each mode's scores ({tag: score_mode's dict});
    a mode missing from scores carries its numbers from `prev`, the
    workdir's previous JSON (--modes)."""
    prev = prev or {}
    results = {}
    for tag in MODES:
        if tag in scores:
            s = scores[tag]
            results[tag] = round(float(np.mean(s["psnr"])), 3)
            results[tag + "_ssim"] = round(float(np.mean(s["ssim"])), 4)
            if s.get("lpips"):
                results[tag + "_lpips"] = round(float(np.mean(s["lpips"])),
                                                4)
        else:
            if tag not in prev:
                raise ValueError(f"--modes skipped {tag} but the previous "
                                 "gate JSON has no score for it")
            for k in (tag, tag + "_ssim", tag + "_lpips"):
                if k in prev:
                    results[k] = prev[k]
            print(f"{tag}: carried {results[tag]:.2f} dB")
    results["surface_steps"] = args.surface_steps
    results["surface_secant"] = args.surface_secant
    results["surface_shade_composite"] = args.surface_shade_composite
    if args.surface_shade_composite:
        results["surface_shade_topk"] = args.surface_shade_topk
        results["surface_shade_win_frac"] = args.surface_shade_win_frac
    results["serving_kp"] = args.serving_kp
    if args.scan_knn_k:
        results["scan_knn_k"] = args.scan_knn_k
    if args.scan_candidates:
        results["scan_candidates"] = args.scan_candidates
    if args.tile_cell_budget:
        results["tile_cell_budget"] = args.tile_cell_budget
    if args.surface_tile != 128:
        results["surface_tile"] = args.surface_tile
    if args.no_secant_rebracket:
        results["secant_rebracket"] = False
    if args.secant_frozen_knn:
        results["secant_frozen_knn"] = True
    results["scene"] = args.scene
    if args.volume_root_anchored:
        results["volume_root_anchored"] = True
        results["volume_n_fine"] = args.volume_n_fine
        results["volume_root_steps"] = args.volume_root_steps
        results["volume_root_secant"] = args.volume_root_secant
        results["volume_win_frac"] = args.volume_win_frac
    results["volume_topk"] = args.volume_topk
    results["volume_tile"] = args.volume_tile
    results["volume_max_candidates"] = args.volume_max_candidates
    if args.eval_candidates:
        results["eval_candidates"] = args.eval_candidates
    results["serving_f32_layers"] = list(serving_f32_layers(args))

    def image_vs_image(tag_a, tag_b, key):
        """Mean PSNR of tag_a's renders against tag_b's (not against
        ground truth); carried from prev when either was not rendered."""
        if tag_a not in scores or tag_b not in scores:
            return prev.get(key)
        return _image_psnr(scores[tag_a]["renders"],
                           scores[tag_b]["renders"])

    # how far each serving mode's IMAGE is from the f32 reference render
    results["volume_serving_vs_f32_img"] = image_vs_image(
        "volume_bf16", "volume_f32", "volume_serving_vs_f32_img")
    results["surface_vs_volume_img"] = image_vs_image(
        "surface_fast", "volume_f32", "surface_vs_volume_img")
    results["bf16_delta_db"] = round(
        results["volume_bf16"] - results["volume_f32"], 3)
    results["surface_serving_delta_db"] = round(
        results["surface_fast"] - results["surface_f32"], 3)
    results["surface_delta_db"] = round(
        results["surface_fast"] - results["volume_bf16"], 3)
    # gate_bf16: the serving config within 0.1 dB of its f32 anchor;
    # gate_surface: surface mode loses at most 1 dB against the volume
    # serving path on ground truth; gate_volume: the volume serving config
    # at most 0.1 dB below the reference-structure f32 render
    results["gate_bf16"] = bool(
        abs(results["surface_serving_delta_db"]) <= 0.1)
    results["gate_surface"] = bool(results["surface_delta_db"] >= -1.0)
    results["gate_volume"] = bool(
        results["volume_bf16"] - results["volume_f32"] >= -0.1)
    return results


def run(args, mode_context=None) -> dict:
    """The whole gate: scene, training (unless reused), the modes of
    --modes, the gate JSON (written to the workdir and returned, with
    "train" and "view_s" beside it in the returned dict only).
    mode_context(tag), when given, is a context manager entered around
    each mode's scoring."""
    from ..ops.lpips import load_lpips_weights
    resolve_device(args.device)
    p = paths_of(args)
    make_scene(args, p)
    trained = train(args, p)
    prev = {}
    if os.path.exists(p["json"]):
        with open(p["json"]) as f:
            prev = json.load(f)
    lpips_w = load_lpips_weights()
    scores = {}
    for tag in MODES:
        if tag not in args.modes.split(","):
            continue
        with (mode_context(tag) if mode_context
              else contextlib.nullcontext()):
            scores[tag] = score_mode(args, p, tag, lpips_w)
    results = gate_results(scores, args, prev)
    print(json.dumps(results))
    with open(p["json"], "w") as f:
        json.dump(results, f, indent=2)
    return dict(results, train=trained, scores=scores, paths=p)


def main(argv=None):
    return run(create_parser().parse_args(argv))


if __name__ == "__main__":
    import logging
    logging.basicConfig(stream=sys.stdout, level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s",
                        datefmt="%H:%M:%S")
    main()
