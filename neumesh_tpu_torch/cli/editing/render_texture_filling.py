"""Texture filling CLI (counterpart of editing/render_texture_filling.py).

    python -m neumesh_tpu_torch.cli.editing.render_texture_filling \\
        --config configs/editing/texture_filling_sphere.json \\
        [the render CLI's flags] [--Kc 4] [--device cpu]

The mask meshes carry uv charts as per-vertex s/t; `step` tiles each
reference pattern that many times. Runs on the card unless --device cpu
is given.
"""
from __future__ import annotations

import argparse
import logging
import sys

from ...editing.fill import TextureFillingRender
from ..render import create_render_args
from . import config_from_argv


def create_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--Kc", default=4, type=int)
    return create_render_args(parser)


def main(argv=None):
    """{"model", "render", "stats", "T_r_m" (None)} as the swapping CLI
    returns them."""
    renderer = TextureFillingRender()
    model, out = renderer.forward(config_from_argv(create_parser(), argv))
    return {"model": model, "render": out, "stats": renderer.stats,
            "T_r_m": renderer.T_r_m}


if __name__ == "__main__":
    logging.basicConfig(stream=sys.stdout, level=logging.INFO)
    main()
