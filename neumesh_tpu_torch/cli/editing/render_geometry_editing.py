"""Geometry editing CLI (counterpart of editing/render_geometry_editing.py):
render a NeuMesh checkpoint on a deformed mesh scaffold, its indicator
vectors rotated by the old -> new normal rotation.

    python -m neumesh_tpu_torch.cli.editing.render_geometry_editing \\
        --config configs/editing/geometry_editing_sphere.json \\
        [the render CLI's flags] [--fix_indicator] [--device cpu]

Runs on the card unless --device cpu is given.
"""
from __future__ import annotations

import argparse
import logging
import os
import sys
import time

from ...config import load_yaml
from ...editing.geometry import deform_model
from ...editing.renderer_base import load_neumesh_from_config
from ...mesh.triangle_mesh import load_mesh
from ...utils.checkpoints import sorted_ckpts
from ...utils.print_fn import log
from .. import render as render_cli
from ..render import create_render_args
from . import config_from_argv


def main_function(args):
    """{"model", "render" (render_function's dict), "stats" (host seconds
    of the checkpoint load and the MeshGrid rebuild)}."""
    ckpt_file = args.get("load_pt", None)
    if ckpt_file is None:
        main_args = load_yaml(args.main_config)
        ckpt_file = sorted_ckpts(os.path.join(
            main_args.training.log_root_dir, main_args.expname, "ckpts"))[-1]
    log.info("=> Use ckpt: " + str(ckpt_file))
    t0 = time.perf_counter()
    model, main_args, render_kwargs_test = load_neumesh_from_config(
        args.main_config, str(ckpt_file), args.get("device", None) or "cuda")
    stats = {"load_s": time.perf_counter() - t0}
    deformed_mesh = load_mesh(args.deformed_mesh)
    t0 = time.perf_counter()
    deform_model(deformed_mesh, model,
                 fix_indicator=args.get("fix_indicator", False))
    stats["meshgrid_s"] = time.perf_counter() - t0
    for k, v in dict(main_args).items():
        if k not in args:
            args[k] = v
    out = render_cli.render_function(args, model, render_kwargs_test)
    return {"model": model, "render": out, "stats": stats}


def create_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--fix_indicator", action="store_true", default=False)
    return create_render_args(parser)


def main(argv=None):
    return main_function(config_from_argv(create_parser(), argv))


if __name__ == "__main__":
    logging.basicConfig(stream=sys.stdout, level=logging.INFO)
    main()
