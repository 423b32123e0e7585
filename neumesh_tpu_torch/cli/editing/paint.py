"""Texture painting CLI (counterpart of editing/paint.py): fine-tune the
colour codes of the vertices the paint rays touch, with view-independent
paint supervision and background distillation.

    python -m neumesh_tpu_torch.cli.editing.paint \\
        --config configs/editing/paint_sphere.json [--device cpu]

Runs on the card unless --device cpu is given.
"""
from __future__ import annotations

import argparse
import json
import logging
import sys

from ...editing.paint_train import main_function, update_paint_config


def main(argv=None):
    """paint_train.main_function's dict."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, default=None, required=True)
    parser.add_argument(
        "--device", type=str, default="cuda",
        help="torch device to train on; 'cpu' runs the kernels' plain "
             "versions (tests)")
    args, _ = parser.parse_known_args(argv)
    with open(args.config) as f:
        paint_config = json.load(f)
    return main_function(update_paint_config(paint_config, args))


if __name__ == "__main__":
    logging.basicConfig(stream=sys.stdout, level=logging.INFO)
    main()
