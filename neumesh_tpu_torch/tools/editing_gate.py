"""Editing gate: texture swapping scored on a trained scene (counterpart
of tools/editing_gate.py, with its gates, defaults and JSON keys).

Runs the swap flow of the editing CLI (mask-mesh read, T_r_m and corr,
kNN colour-code transfer, TextureEditableNeuMesh blend) on a trained
NeuMesh, renders edited and original full images of held-out views, and
gates region by region in image space:

  gate_edit_untouched  the untouched region's PSNR against the ground
                       truth stays within 0.1 dB of the unedited render's
  gate_edit_swapped    the swapped region changes (mean |edit - orig|
                       above 0.01) and stays finite

Main mask = the +x cap of the scaffold, reference mask = the -x cap of
the same model, T_r_m = the exact 180-degree rotation about y (a symmetry
of the gate scenes, whose albedo is not symmetric).

    python -m neumesh_tpu_torch.tools.editing_gate --config <trained \\
        config.yaml> [--ckpt .../latest.ckpt] [--out editing_gate.json] \\
        [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from .. import resolve_device


def masked_psnr(a: np.ndarray, b: np.ndarray, mask: np.ndarray) -> float:
    """PSNR over the masked pixels only."""
    d = (a[mask] - b[mask]) ** 2
    mse = float(np.mean(d))
    return float(10.0 * np.log10(1.0 / max(mse, 1e-12)))


def create_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True,
                    help="trained NeuMesh config.yaml (the quality gate's "
                         "logs/qgate_neumesh/config.yaml)")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint (default: ckpts/latest.ckpt beside "
                         "the config)")
    ap.add_argument("--out", default=None,
                    help="output JSON (default: editing_gate.json beside "
                         "the config)")
    ap.add_argument("--views", type=int, nargs="+", default=[1, 11])
    ap.add_argument("--x-frac", type=float, default=0.5,
                    help="mask caps: main = x > frac*xmax, ref = "
                         "x < frac*xmin")
    ap.add_argument("--rayschunk", type=int, default=16384)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain "
                         "versions (tests)")
    return ap


def main(argv=None, renders=None):
    """The gate's results dict (also written to --out). `renders`, when a
    dict, receives {view: (orig rgb, edited rgb)} as numpy arrays."""
    from ..config import ConfigDict
    from ..dataio import get_data
    from ..editing.renderer_base import load_neumesh_from_config
    from ..editing.swap import TextureSwappingRender
    from ..editing.texture_model import TextureEditableNeuMesh
    from ..mesh.triangle_mesh import save_ply
    from ..render.volume import render_image

    args = create_parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg_dir = os.path.dirname(os.path.abspath(args.config))
    ckpt = args.ckpt or os.path.join(cfg_dir, "ckpts", "latest.ckpt")
    out_path = args.out or os.path.join(cfg_dir, "editing_gate.json")

    # the trained model, as the main and the reference (same scene)
    model, mcfg, _ = load_neumesh_from_config(args.config, ckpt, dev)
    mesh = model.mesh_grid.mesh
    verts = np.asarray(mesh.vertices)
    xmax, xmin = float(verts[:, 0].max()), float(verts[:, 0].min())
    main_mask = verts[:, 0] > args.x_frac * xmax
    ref_mask = verts[:, 0] < args.x_frac * xmin
    assert main_mask.sum() > 8 and ref_mask.sum() > 8, (
        f"degenerate edit caps: {main_mask.sum()} / {ref_mask.sum()} verts")

    # mask meshes on disk (the CLI convention: vertex colour != 0 => mask)
    edit_dir = os.path.join(cfg_dir, "editing_gate")
    os.makedirs(edit_dir, exist_ok=True)
    for name, m in (("mask_main", main_mask), ("mask_ref", ref_mask)):
        mm = type(mesh)(
            vertices=verts.copy(), triangles=np.asarray(mesh.triangles),
            vertex_colors=np.where(m[:, None], [1.0, 0.0, 0.0],
                                   [0.0, 0.0, 0.0]).astype(np.float32))
        save_ply(mm, os.path.join(edit_dir, name + ".ply"))

    # 180-degree rotation about y: an exact symmetry of both gate scenes
    T_r_m = np.eye(4)
    T_r_m[0, 0] = T_r_m[2, 2] = -1.0
    # correspondence pairs (main id, nearest reference-mask vertex to R v)
    main_ids = np.where(main_mask)[0][:16]
    ref_ids = np.where(ref_mask)[0]
    tgt = verts[main_ids] @ T_r_m[:3, :3].T + T_r_m[:3, 3]
    d2 = ((tgt[:, None] - verts[ref_ids][None]) ** 2).sum(-1)
    corr = np.stack([main_ids, ref_ids[np.argmin(d2, 1)]], 1)

    swapper = TextureSwappingRender()
    main_prim, _, _ = swapper.read_data(
        args.config, [os.path.join(edit_dir, "mask_main.ply")], ckpt, dev)
    ref_prim, _, _ = swapper.read_data(
        args.config, [os.path.join(edit_dir, "mask_ref.ply")], ckpt, dev)
    swap_args = ConfigDict({"T_r_m": [T_r_m.tolist()],
                            "corr": [corr.tolist()],
                            "use_arap": False, "Kc": 4})
    T_list = swapper.transfer_texture_features(swap_args, main_prim,
                                               [ref_prim])
    edited = TextureEditableNeuMesh(
        main_prim.model, [ref_prim.model], main_prim.get_editing_masks(),
        T_list, [main_prim.edit_color_features])

    # original vs edited: the f32 volume parity configuration
    kw = dict(detailed_output=False, perturb=False, bounded_near_far=True,
              N_samples=64, N_importance=64, N_upsample_iters=4,
              reuse_upsample_sdf=True)

    def render_full(mdl, c2w, K, H, W, **more):
        _, _, ret = render_image(mdl, c2w, K, H, W, block=(1, W),
                                 rayschunk=args.rayschunk, device=dev,
                                 **kw, **more)
        return {k: v.reshape(H * W, *v.shape[2:]).cpu().numpy()
                for k, v in ret.items()}

    ds = get_data(mcfg, downscale=1)
    views = sorted({v % len(ds) for v in args.views})
    results = {"scene": str(mcfg.data.data_dir),
               "n_main_mask": int(main_mask.sum()),
               "n_ref_mask": int(ref_mask.sum())}
    deltas, diffs, psnr_sw = [], [], []
    for vi in views:
        _, sample, gt = ds[vi]
        cam = (sample["c2w"], sample["intrinsics"], ds.H, ds.W)
        orig = render_full(model, *cam, rays_output=True)
        edit = render_full(edited, *cam)
        if renders is not None:
            renders[vi] = (orig["rgb"], edit["rgb"])
        gt_rgb = np.asarray(gt["rgb"])

        # image-space regions from the ORIGINAL render's geometry, on the
        # camera rays it cast
        pts = orig["rays_o"] + orig["depth_volume"][:, None] * orig["rays_d"]
        hit = orig["mask_volume"] > 0.5
        swapped = hit & (pts[:, 0] > (args.x_frac + 0.1) * xmax)
        untouched = hit & (pts[:, 0] < (args.x_frac - 0.1) * xmax)
        if untouched.sum() < 50 or swapped.sum() < 50:
            print(f"view {vi}: skipping (regions too small: "
                  f"{int(swapped.sum())} swapped / "
                  f"{int(untouched.sum())} untouched px)")
            continue

        p_orig = masked_psnr(orig["rgb"], gt_rgb, untouched)
        p_edit = masked_psnr(edit["rgb"], gt_rgb, untouched)
        deltas.append(abs(p_orig - p_edit))
        diffs.append(float(np.mean(np.abs(
            edit["rgb"][swapped] - orig["rgb"][swapped]))))
        psnr_sw.append(masked_psnr(edit["rgb"], orig["rgb"], swapped))
        assert np.isfinite(edit["rgb"]).all(), "non-finite edited render"
        print(f"view {vi}: untouched PSNR-vs-GT orig {p_orig:.2f} / "
              f"edit {p_edit:.2f} (delta {deltas[-1]:.4f} dB); swapped "
              f"mean|diff| {diffs[-1]:.4f}, edit-vs-orig {psnr_sw[-1]:.2f} dB")

    assert deltas, "no view had usable swapped/untouched regions"
    results["untouched_delta_db"] = round(float(np.max(deltas)), 4)
    results["swapped_mean_abs_diff"] = round(float(np.min(diffs)), 4)
    results["swapped_edit_vs_orig_db"] = round(float(np.mean(psnr_sw)), 3)
    results["gate_edit_untouched"] = bool(results["untouched_delta_db"]
                                          < 0.1)
    results["gate_edit_swapped"] = bool(results["swapped_mean_abs_diff"]
                                        > 0.01)
    print(json.dumps(results))
    with open(out_path, "w") as f:
        json.dump(results, f, indent=2)
    print(f"wrote {out_path}")
    return results


if __name__ == "__main__":
    main()
