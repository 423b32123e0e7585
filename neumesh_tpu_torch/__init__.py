"""neumesh_tpu_torch: the PyTorch/CUDA port of neumesh_tpu.

The JAX package `neumesh_tpu` stays the reference; this package imports
nothing from it (and never imports jax). Plain tensor code is PyTorch;
every TPU kernel on the ported path is a hand-written CUDA C++ kernel
for Hopper (`csrc/`, built with nvcc at first use, bound with ctypes).

Device rule: every entry point takes `device=` (the render CLI
`--device`), default "cuda" (under a process group, each rank's
cuda:LOCAL_RANK). Without a card the default raises; only an explicit
`device="cpu"` runs on the CPU, where each kernel wrapper uses its plain
PyTorch version.
"""
from __future__ import annotations

import torch

__all__ = ["require_cuda", "resolve_device", "set_fp32_precision"]


def require_cuda() -> None:
    """Raise unless a CUDA device is visible."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "neumesh_tpu_torch: no CUDA device is available; pass "
            "device='cpu' explicitly to run the plain PyTorch versions")


def resolve_device(device="cuda") -> torch.device:
    """torch.device for an entry point's `device=` argument. A CUDA device
    requires a card; nothing falls back to the CPU. An index-less "cuda"
    is parallel.dist.default_device(): this rank's cuda:LOCAL_RANK under a
    process group, the current device without one."""
    dev = torch.device(device)
    if dev.type == "cuda":
        require_cuda()
        if dev.index is None:
            from .parallel.dist import default_device
            dev = default_device()
    return dev


def set_fp32_precision() -> None:
    """True-fp32 matmuls and convolutions on the render path (PyTorch
    defaults cuDNN to TF32; the f32 mode is the parity mode)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
