"""NeuS (counterpart of neumesh_tpu/models/neus/model.py): the SDF MLP
(ImplicitSurface), the radiance MLP (RadianceNet), an optional NeRF++
background net, and the learnable CDF sharpness ln_s.

Model protocol (shared with NeuMesh):
  forward(x, view_dirs)      -> (sdf, rgb)
  forward_density_only(x)    -> sdf
  forward_with_nablas(x)     -> (sdf, nablas)
  forward_s()                -> scalar s
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ... import resolve_device
from ..base import NeRF, ImplicitSurface, RadianceNet


class NeuS(nn.Module):
    def __init__(self, variance_init: float = 0.05, speed_factor: float = 1.0,
                 input_ch: int = 3, W_geo_feat: int = -1,
                 use_outside_nerf: bool = False,
                 obj_bounding_radius: float = 1.0, surface_cfg: dict = None,
                 radiance_cfg: dict = None, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.device = dev
        self.speed_factor = speed_factor
        self.ln_s_init = -math.log(variance_init) / speed_factor
        self.ln_s = nn.Parameter(torch.full((1,), self.ln_s_init,
                                            device=dev), requires_grad=False)
        self.implicit_surface = ImplicitSurface(
            W_geo_feat=W_geo_feat, input_ch=input_ch,
            obj_bounding_size=obj_bounding_radius, device=dev,
            **(surface_cfg or {}))
        if W_geo_feat < 0:
            W_geo_feat = self.implicit_surface.W
        self.radiance_net = RadianceNet(W_geo_feat=W_geo_feat, device=dev,
                                        **(radiance_cfg or {}))
        self.use_outside_nerf = use_outside_nerf
        if use_outside_nerf:
            self.nerf_outside = NeRF(input_ch=4, multires=10,
                                     multires_view=4, use_view_dirs=True,
                                     device=dev)

    @torch.no_grad()
    def init(self, seed: int = 0) -> "NeuS":
        """Parameters from a numpy seed: ln_s at its init, the geometric
        init of the SDF net, torch-default uniform radiance layers."""
        rng = np.random.default_rng(seed)
        self.ln_s.fill_(self.ln_s_init)
        self.implicit_surface.init(rng)
        self.radiance_net.init(rng)
        if self.use_outside_nerf:
            self.nerf_outside.init(rng)
        return self

    def forward_s(self):
        return torch.exp(self.ln_s[0] * self.speed_factor)

    def forward(self, x, view_dirs):
        sdf, nablas, geometry_feature = \
            self.implicit_surface.forward_with_nablas(x)
        radiances = self.radiance_net.forward(x, view_dirs, nablas,
                                              geometry_feature)
        return sdf, radiances

    def forward_radiance(self, x, view_dirs):
        return self.forward(x, view_dirs)[1]

    def forward_density_only(self, x):
        return self.implicit_surface.forward(x)

    def forward_with_nablas(self, x):
        sdf, nablas, _ = self.implicit_surface.forward_with_nablas(x)
        return sdf, nablas
