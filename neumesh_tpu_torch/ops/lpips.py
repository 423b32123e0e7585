"""LPIPS with a VGG16 backbone (counterpart of neumesh_tpu/ops/lpips.py):
the perceptual distance of the PSNR/SSIM/LPIPS metric set, in f32 through
torch's own convolution and pooling (a metric, not a ported kernel).

No weights ship with this repository. `load_lpips_weights` reads the
standard files when the user provides them (paths as arguments, or the
NEUMESH_LPIPS_VGG / NEUMESH_LPIPS_LIN environment variables):

- torchvision's vgg16 state dict (`vgg16-397923af.pth`, keys
  features.{i}.weight/bias), and
- the lpips package's linear heads (`vgg.pth`, keys lin{k}.model.1.weight).

Both are read with `torch.load(weights_only=True)`. Without a lin file the
heads are uniform (a valid perceptual distance, not the calibrated metric:
the weights' "calibrated" flag says which). `lpips_available()` lets
callers skip the metric offline.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device

# VGG16 conv plan: (out_channels, torchvision features.{index}) per conv
# layer, and the ReLU taps LPIPS uses (relu1_2, relu2_2, relu3_3, relu4_3,
# relu5_3)
_VGG_CONVS = [
    (64, 0), (64, 2), (128, 5), (128, 7), (256, 10), (256, 12), (256, 14),
    (512, 17), (512, 19), (512, 21), (512, 24), (512, 26), (512, 28),
]
_POOL_BEFORE = {2, 4, 7, 10}           # conv list indices preceded by pool
_TAPS = (1, 3, 6, 9, 12)               # conv list indices of the taps
_CHANNELS = (64, 128, 256, 512, 512)

_SHIFT = np.asarray([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.asarray([0.458, 0.448, 0.450], np.float32)

_ENV_VGG = "NEUMESH_LPIPS_VGG"         # path to vgg16-*.pth
_ENV_LIN = "NEUMESH_LPIPS_LIN"         # path to lpips vgg.pth (lin heads)


def _state_dict(path: str) -> dict:
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return sd.get("model", sd)


def load_lpips_weights(vgg_path: Optional[str] = None,
                       lin_path: Optional[str] = None):
    """{"convs": [{"w", "b"}], "lins": [(C,)], "calibrated"} as numpy f32
    from the standard .pth files, or None when the VGG file is not
    available (offline)."""
    vgg_path = vgg_path or os.environ.get(_ENV_VGG)
    lin_path = lin_path or os.environ.get(_ENV_LIN)
    if not vgg_path or not os.path.exists(vgg_path):
        return None
    sd = _state_dict(vgg_path)
    convs = [{"w": sd[f"features.{idx}.weight"].float().numpy(),
              "b": sd[f"features.{idx}.bias"].float().numpy()}
             for _, idx in _VGG_CONVS]
    lins = None
    if lin_path and os.path.exists(lin_path):
        lsd = _state_dict(lin_path)
        lins = [lsd[f"lin{k}.model.1.weight"].float().numpy().reshape(-1)
                for k in range(5)]
    if lins is None:
        # uniform heads: not the calibrated metric (see the flag)
        lins = [np.full(c, 1.0 / c, np.float32) for c in _CHANNELS]
    return {"convs": convs, "lins": lins, "calibrated": lin_path is not None}


def lpips_available(weights=None) -> bool:
    return (weights or load_lpips_weights()) is not None


def _t(a, dev):
    return torch.as_tensor(a, dtype=torch.float32, device=dev)


def _vgg_features(weights, img):
    """img: (N, 3, H, W) in [0, 1] -> list of tap activations."""
    dev = img.device
    x = (img * 2.0 - 1.0 - _t(_SHIFT, dev)[None, :, None, None]) \
        / _t(_SCALE, dev)[None, :, None, None]
    taps = []
    for i, conv in enumerate(weights["convs"]):
        if i in _POOL_BEFORE:
            x = F.max_pool2d(x, 2, 2)
        x = F.conv2d(x, _t(conv["w"], dev), _t(conv["b"], dev), padding=1)
        x = torch.clamp_min(x, 0.0)
        if i in _TAPS:
            taps.append(x)
    return taps


@torch.no_grad()
def lpips(weights, img0, img1, device=None):
    """LPIPS distance between (..., H, W, 3) images in [0, 1] (lower is
    more similar): each tap unit-normalised across channels, squared
    difference, per-channel linear head, spatial mean, sum over layers.
    Returns (N,) f32 on the images' device: that of img0 when it is a
    tensor, else `device` (default the card)."""
    dev = (img0.device if isinstance(img0, torch.Tensor)
           else resolve_device(device or "cuda"))

    def nchw(a):
        a = _t(a, dev)
        if a.dim() == 3:
            a = a[None]
        return a.permute(0, 3, 1, 2)

    t0 = _vgg_features(weights, nchw(img0))
    t1 = _vgg_features(weights, nchw(img1))
    total = 0.0
    for a, b, lin in zip(t0, t1, weights["lins"]):
        a = a / (torch.linalg.vector_norm(a, dim=1, keepdim=True) + 1e-10)
        b = b / (torch.linalg.vector_norm(b, dim=1, keepdim=True) + 1e-10)
        d = (a - b) ** 2                                  # (N, C, H, W)
        w = _t(lin, dev)[None, :, None, None]
        total = total + torch.mean(torch.sum(d * w, dim=1), dim=(-1, -2))
    return total
