"""Framework registry (counterpart of neumesh_tpu/models/__init__.py).

build_framework(args, name, device) -> (model, trainer, render_kwargs_train,
render_kwargs_test, render_fn). The port holds parameters in the model
(no separate params tree); the NeuMesh trainer carries its frozen teacher.
"""
from __future__ import annotations


def build_framework(args, name: str, device="cuda", seed: int = 42):
    if name.lower() == "neus":
        from .neus import get_model
    elif name.lower() == "neumesh":
        from .neumesh import get_model
    else:
        raise RuntimeError(f"Please specify a valid framework name: {name}")
    return get_model(args, device=device, seed=seed)
