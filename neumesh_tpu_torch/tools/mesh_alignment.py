"""Mesh alignment tool (counterpart of tools/mesh_alignment.py): from a
correspondence file (JSON list of [main_vertex_id, ref_vertex_id], at
least 3 pairs), estimate T_r_m (Umeyama with scaling, refined by
point-to-point ICP) and write T_r_m and corr into an editing config.

    python -m neumesh_tpu_torch.tools.mesh_alignment --main_mesh a.ply \\
        --ref_mesh b.ply --corr corr.json [--out_config edit.json]
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from ..editing.align import estimate_transform_from_corr
from ..mesh.triangle_mesh import load_mesh


def create_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--main_mesh", type=str, required=True)
    parser.add_argument("--ref_mesh", type=str, required=True)
    parser.add_argument("--corr", type=str, required=True,
                        help="JSON file: [[main_id, ref_id], ...]")
    parser.add_argument("--out_config", type=str, default=None,
                        help="editing config JSON to update in place")
    parser.add_argument("--pair_index", type=int, default=0,
                        help="which editing pair in the config to set")
    parser.add_argument("--icp_threshold", type=float, default=0.03)
    parser.add_argument("--no_refine", action="store_true")
    return parser


def main(argv=None) -> np.ndarray:
    """The estimated 4x4 T_r_m (also written into --out_config)."""
    args = create_parser().parse_args(argv)
    main_mesh = load_mesh(args.main_mesh)
    ref_mesh = load_mesh(args.ref_mesh)
    with open(args.corr) as f:
        corr = np.asarray(json.load(f), np.int64)
    assert len(corr) >= 3, "need at least 3 correspondences"
    T = estimate_transform_from_corr(
        np.asarray(main_mesh.vertices), np.asarray(ref_mesh.vertices), corr,
        threshold=args.icp_threshold, refine=not args.no_refine)
    print("T_r_m =")
    print(np.array2string(T, precision=6))
    if args.out_config:
        with open(args.out_config) as f:
            data = json.load(f)
        data.setdefault("T_r_m", [])
        data.setdefault("corr", [])
        while len(data["T_r_m"]) <= args.pair_index:
            data["T_r_m"].append(None)
            data["corr"].append(None)
        data["T_r_m"][args.pair_index] = T.tolist()
        data["corr"][args.pair_index] = corr.tolist()
        with open(args.out_config, "w") as f:
            json.dump(data, f, indent=2)
        print(f"updated {args.out_config}")
    return T


if __name__ == "__main__":
    main()
