"""Texture swapping CLI (counterpart of editing/render_texture_swapping.py).

    python -m neumesh_tpu_torch.cli.editing.render_texture_swapping \\
        --config configs/editing/texture_swapping_sphere.json \\
        [the render CLI's flags] [--use_arap] [--Kc 4] [--device cpu]

The JSON names main_config / main_ckpt / main_mask_mesh, the lists
ref_config / ref_ckpt / ref_mask_mesh, and `corr` (and optionally
`T_r_m`) per reference (tools/mesh_alignment.py writes them). Runs on the
card unless --device cpu is given.
"""
from __future__ import annotations

import argparse
import logging
import sys

from ...editing.swap import TextureSwappingRender
from ..render import create_render_args
from . import config_from_argv


def create_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--use_arap", action="store_true", default=False)
    parser.add_argument("--Kc", default=4, type=int)
    parser.add_argument("--fix_indicator", action="store_true", default=False)
    return create_render_args(parser)


def main(argv=None):
    """{"model" (the editable), "render" (render_function's dict),
    "stats" (host seconds of the edit's steps), "T_r_m" (R, 4, 4)}."""
    renderer = TextureSwappingRender()
    model, out = renderer.forward(config_from_argv(create_parser(), argv))
    return {"model": model, "render": out, "stats": renderer.stats,
            "T_r_m": renderer.T_r_m}


if __name__ == "__main__":
    logging.basicConfig(stream=sys.stdout, level=logging.INFO)
    main()
