"""Framework registry (counterpart of neumesh_tpu/models/__init__.py).

build_framework(args, name, device) -> (model, trainer, render_kwargs_train,
render_kwargs_test, render_fn). The port holds parameters in the model
(no separate params tree) and has no trainer before the training slice:
`trainer` is None.
"""
from __future__ import annotations


def build_framework(args, name: str, device="cuda", seed: int = 42):
    if name.lower() == "neus":
        raise NotImplementedError(
            "framework NeuS waits for the training slice of the port")
    if name.lower() != "neumesh":
        raise RuntimeError(f"Please specify a valid framework name: {name}")
    from .neumesh import get_model
    return get_model(args, device=device, seed=seed)
