"""Checkpoint files (counterpart of neumesh_tpu/utils/checkpoints.py, the
reading side the render entry needs).

File naming and order as the JAX package keeps them: numbered backups
first, then latest, then final_*. The port reads reference-format `.pt`
files ({"model": state_dict, "global_step", "epoch_idx"}; zip containers
of torch.save). The JAX package's native `.ckpt` (flax msgpack) is not
read yet: the training slice writes the port's own checkpoints; until
then convert with neumesh_tpu/utils/torch_ckpt.py::save_torch_checkpoint.
"""
from __future__ import annotations

import os

import torch

from .state import load_reference_state


def sorted_ckpts(ckpt_dir: str) -> list:
    """Order: numbered backups ascending, then latest, then final_*."""
    if not os.path.isdir(ckpt_dir):
        return []
    names = [n for n in os.listdir(ckpt_dir)
             if n.endswith((".ckpt", ".pt"))]
    numbered, latest, final = [], [], []
    for n in names:
        stem = os.path.splitext(n)[0]
        if stem.startswith("final_"):
            final.append(n)
        elif stem == "latest":
            latest.append(n)
        else:
            numbered.append(n)
    numbered.sort()
    final.sort()
    return [os.path.join(ckpt_dir, n) for n in numbered + latest + final]


def load_checkpoint(path: str) -> dict:
    """A reference-format `.pt` as a dict of CPU tensors and numbers; a
    native msgpack `.ckpt` raises."""
    with open(path, "rb") as f:
        head = f.read(4)
    if head[:2] != b"PK":
        raise ValueError(
            f"{path}: not a reference-format .pt checkpoint (a native "
            "msgpack .ckpt of the JAX package?). The port reads .pt files "
            "only; write one with neumesh_tpu/utils/torch_ckpt.py::"
            "save_torch_checkpoint(path, params, model)")
    return torch.load(path, map_location="cpu", weights_only=True)


class CheckpointIO:
    """Checkpoint directory reader."""

    def __init__(self, checkpoint_dir: str = "./chkpts"):
        self.checkpoint_dir = checkpoint_dir

    def load_file(self, filepath: str, model=None) -> dict:
        """Load a checkpoint (a relative path missing from the working
        directory is looked up in checkpoint_dir); with `model`, its
        state dict is copied into the model's parameters. Returns the
        checkpoint dict."""
        if not os.path.isabs(filepath) and not os.path.exists(filepath):
            cand = os.path.join(self.checkpoint_dir, filepath)
            if os.path.exists(cand):
                filepath = cand
        ckpt = load_checkpoint(filepath)
        if model is not None:
            load_reference_state(ckpt.get("model", ckpt), model)
        return ckpt
