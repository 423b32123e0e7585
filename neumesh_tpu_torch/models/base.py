"""Field MLPs: ImplicitSurface, RadianceNet, NeRF, ScalarField
(counterpart of neumesh_tpu/models/base.py).

Parameters live in the modules, in the JAX layout (linear weights (in,
out); weight norm as g (out,), v (in, out)), so a JAX parameter tree
crosses one to one (utils/state.py). Initialisation draws from a numpy
generator:
  - the geometric sphere init of the SDF net, with the sqrt(2) scalings
    and the skip layer's zeroed octave rows;
  - weight norm with g = ||v||_col at init;
  - Softplus(beta=100) activations in the SDF net;
  - the skip concat divided by sqrt(2).
Gradients with respect to the query point (nablas, differentiable again
for the eikonal loss) come from autograd.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..nn import (Linear, get_embedder, maybe_wnorm_apply,
                  maybe_wnorm_linear, softplus100, torch_default_init)
from ..utils.trace import spanned


def _rng(seed_or_rng):
    if isinstance(seed_or_rng, np.random.Generator):
        return seed_or_rng
    return np.random.default_rng(seed_or_rng)


class ImplicitSurface(nn.Module):
    """SDF MLP with geometric sphere init. D + 1 linear layers; layers 0..D-1
    use Softplus(beta=100) (or sin(30 x) with use_siren), the last is
    linear. With W_geo_feat > 0 the last layer outputs 1 + W_geo_feat: the
    sdf and a geometry feature."""

    def __init__(self, W: int = 256, D: int = 8, skips: Sequence[int] = (4,),
                 W_geo_feat: int = 256, input_ch: int = 3,
                 radius_init: float = 1.0, obj_bounding_size: float = 2.0,
                 geometric_init: bool = True, embed_multires: int = 6,
                 weight_norm: bool = True, use_siren: bool = False,
                 device="cuda"):
        super().__init__()
        self.radius_init = radius_init
        self.obj_bounding_size = obj_bounding_size
        self.geometric_init = geometric_init
        self.D, self.W, self.W_geo_feat = D, W, W_geo_feat
        self.skips = tuple(skips)
        self.use_siren = use_siren
        self.weight_norm = weight_norm
        if use_siren and self.skips:
            raise ValueError("do not use skips for siren")
        self.embed_fn, self.input_ch = get_embedder(embed_multires, input_ch)
        self.embed_multires = embed_multires
        dims = []
        for l in range(D + 1):
            if l == D:
                out_dim = 1 + W_geo_feat if W_geo_feat > 0 else 1
            elif (l + 1) in self.skips:
                out_dim = W - self.input_ch     # reduced before the concat
            else:
                out_dim = W
            dims.append((self.input_ch if l == 0 else W, out_dim))
        self.layer_dims = tuple(dims)
        self.layers = nn.ModuleList(
            [maybe_wnorm_linear(i, o, weight_norm, device) for i, o in dims])

    @torch.no_grad()
    def init(self, seed=0) -> "ImplicitSurface":
        rng = _rng(seed)
        for l, ((in_dim, out_dim), lin) in enumerate(zip(self.layer_dims,
                                                         self.layers)):
            if self.use_siren:
                w_std = (1.0 / in_dim) if l == 0 else (
                    math.sqrt(6.0 / in_dim) / 30.0)
                w = rng.uniform(-w_std, w_std, (in_dim, out_dim))
                bb = 1.0 / math.sqrt(in_dim)
                b = rng.uniform(-bb, bb, (out_dim,))
            elif self.geometric_init:
                std = math.sqrt(2) / math.sqrt(out_dim)
                b = np.zeros(out_dim)
                if l == self.D:
                    w = (rng.standard_normal((in_dim, out_dim)) * 1e-4
                         + math.sqrt(math.pi) / math.sqrt(in_dim))
                    b = np.full(out_dim, -self.radius_init)
                elif self.embed_multires > 0 and l == 0:
                    w = np.zeros((in_dim, out_dim))
                    w[:3] = rng.standard_normal((3, out_dim)) * std
                elif self.embed_multires > 0 and l in self.skips:
                    w = rng.standard_normal((in_dim, out_dim)) * std
                    # the skip input is [h, x, octaves]: zero the octaves
                    w[-(self.input_ch - 3):] = 0.0
                else:
                    w = rng.standard_normal((in_dim, out_dim)) * std
            else:
                w, b = torch_default_init(rng, in_dim, out_dim)
            lin.set_weight(w, b)
        return self

    def forward(self, x, return_h: bool = False):
        """x (..., 3) -> sdf (...,) [, geometry feature (..., F)]."""
        x = self.embed_fn(x)
        h = x
        for i in range(self.D):
            if i in self.skips:
                h = torch.cat([h, x], dim=-1) / math.sqrt(2)
            h = maybe_wnorm_apply(self.layers[i], h)
            h = torch.sin(30.0 * h) if self.use_siren else softplus100(h)
        out = maybe_wnorm_apply(self.layers[self.D], h)
        sdf = out[..., 0]
        feat = out[..., 1:] if self.W_geo_feat > 0 else h
        return (sdf, feat) if return_h else sdf

    @spanned("field.nablas")
    def forward_with_nablas(self, x):
        """(sdf (...,), nablas (..., 3), geometry feature (..., F)); the
        nablas are d sdf / d x by autograd, differentiable again when grad
        mode is on (the eikonal loss), detached otherwise."""
        grad_mode = torch.is_grad_enabled()
        with torch.enable_grad():
            xg = x if x.requires_grad else x.detach().requires_grad_(True)
            sdf, feat = self.forward(xg, return_h=True)
            nablas, = torch.autograd.grad(sdf, xg, torch.ones_like(sdf),
                                          create_graph=grad_mode)
        if not grad_mode:
            sdf, feat = sdf.detach(), feat.detach()
        return sdf, nablas, feat


class RadianceNet(nn.Module):
    """Colour MLP on [x, view dirs, normals, geometry feature]: D + 1 layers,
    ReLU, final sigmoid."""

    def __init__(self, D: int = 4, W: int = 256, skips: Sequence[int] = (),
                 W_geo_feat: int = 256, embed_multires: int = 6,
                 embed_multires_view: int = 4, use_view_dirs: bool = True,
                 weight_norm: bool = True, use_siren: bool = False,
                 device="cuda"):
        super().__init__()
        self.D, self.W = D, W
        self.skips = tuple(skips)
        self.use_view_dirs = use_view_dirs
        self.weight_norm = weight_norm
        self.use_siren = use_siren
        self.embed_fn, input_ch_pts = get_embedder(embed_multires)
        if use_view_dirs:
            self.embed_fn_view, input_ch_views = get_embedder(
                embed_multires_view)
            self.in_dim_0 = input_ch_pts + input_ch_views + 3 + W_geo_feat
        else:
            self.embed_fn_view = None
            self.in_dim_0 = input_ch_pts + W_geo_feat
        dims = []
        for l in range(D + 1):
            if l == 0:
                in_dim = self.in_dim_0
            elif l in self.skips:
                in_dim = self.in_dim_0 + W
            else:
                in_dim = W
            dims.append((in_dim, 3 if l == D else W))
        self.layer_dims = tuple(dims)
        self.layers = nn.ModuleList(
            [maybe_wnorm_linear(i, o, weight_norm, device) for i, o in dims])

    @torch.no_grad()
    def init(self, seed=0) -> "RadianceNet":
        rng = _rng(seed)
        for (in_dim, out_dim), lin in zip(self.layer_dims, self.layers):
            lin.set_weight(*torch_default_init(rng, in_dim, out_dim))
        return self

    def forward(self, x, view_dirs, normals, geometry_feature,
                return_feature: bool = False):
        x = self.embed_fn(x)
        if self.use_view_dirs:
            inp = torch.cat([x, self.embed_fn_view(view_dirs), normals,
                             geometry_feature], dim=-1)
        else:
            inp = torch.cat([x, geometry_feature], dim=-1)
        h = inp
        color_feature = None
        for i in range(self.D + 1):
            if i in self.skips:
                h = torch.cat([h, inp], dim=-1)
            h = maybe_wnorm_apply(self.layers[i], h)
            h = torch.relu(h) if i != self.D else torch.sigmoid(h)
            if i == self.D - 1:
                color_feature = h
        return (h, color_feature) if return_feature else h


class NeRF(nn.Module):
    """Vanilla NeRF MLP (the optional NeRF++ background model)."""

    def __init__(self, D: int = 8, W: int = 256, input_ch: int = 3,
                 input_ch_view: int = 3, multires: int = -1,
                 multires_view: int = -1, output_ch: int = 4,
                 skips: Sequence[int] = (4,), use_view_dirs: bool = False,
                 device="cuda"):
        super().__init__()
        self.D, self.W = D, W
        self.skips = tuple(skips)
        self.use_view_dirs = use_view_dirs
        self.output_ch = output_ch
        self.embed_fn, self.input_ch = get_embedder(multires, input_ch)
        self.embed_fn_view, self.input_ch_view = get_embedder(
            multires_view, input_ch_view)
        dims = [(self.input_ch, W)] + [
            (W + self.input_ch if i in self.skips else W, W)
            for i in range(D - 1)]
        self.pts_linears = nn.ModuleList(
            [Linear(i, o, device) for i, o in dims])
        self.views_linears = nn.ModuleList(
            [Linear(self.input_ch_view + W, W // 2, device)])
        if use_view_dirs:
            self.feature_linear = Linear(W, W, device)
            self.alpha_linear = Linear(W, 1, device)
            self.rgb_linear = Linear(W // 2, 3, device)
        else:
            self.output_linear = Linear(W, output_ch, device)

    def linears(self):
        out = [*self.pts_linears, *self.views_linears]
        if self.use_view_dirs:
            return out + [self.feature_linear, self.alpha_linear,
                          self.rgb_linear]
        return out + [self.output_linear]

    @torch.no_grad()
    def init(self, seed=0) -> "NeRF":
        rng = _rng(seed)
        for lin in self.linears():
            lin.set_weight(*torch_default_init(rng, *lin.w.shape))
        return self

    def forward(self, input_pts, input_views):
        input_pts = self.embed_fn(input_pts)
        input_views = self.embed_fn_view(input_views)
        h = input_pts
        for i, p in enumerate(self.pts_linears):
            h = torch.relu(maybe_wnorm_apply(p, h))
            if i in self.skips:
                h = torch.cat([input_pts, h], dim=-1)
        if self.use_view_dirs:
            sigma = maybe_wnorm_apply(self.alpha_linear, h)
            feature = maybe_wnorm_apply(self.feature_linear, h)
            h = torch.cat([feature, input_views], dim=-1)
            for p in self.views_linears:
                h = torch.relu(maybe_wnorm_apply(p, h))
            rgb = maybe_wnorm_apply(self.rgb_linear, h)
        else:
            outputs = maybe_wnorm_apply(self.output_linear, h)
            rgb, sigma = outputs[..., :3], outputs[..., 3:]
        return sigma[..., 0], torch.sigmoid(rgb)


class ScalarField(nn.Module):
    """Small scalar MLP: Kaiming-uniform hidden layers, a zero output layer
    with bias init_val."""

    def __init__(self, input_ch: int = 3, W: int = 128, D: int = 4,
                 skips: Sequence[int] = (), init_val: float = -2.0,
                 device="cuda"):
        super().__init__()
        self.input_ch, self.W, self.D = input_ch, W, D
        self.skips = tuple(skips)
        self.init_val = init_val
        dims = [(input_ch, W)] + [
            (W + input_ch if i in self.skips else W, W) for i in range(D - 1)]
        self.pts_linears = nn.ModuleList([Linear(i, o, device)
                                          for i, o in dims])
        self.output_linear = Linear(W, 1, device)

    @torch.no_grad()
    def init(self, seed=0) -> "ScalarField":
        rng = _rng(seed)
        for lin in self.pts_linears:
            in_dim, out_dim = lin.w.shape
            bound = math.sqrt(6.0 / in_dim)
            lin.set_weight(rng.uniform(-bound, bound, (in_dim, out_dim)),
                           np.zeros(out_dim))
        self.output_linear.set_weight(np.zeros((self.W, 1)),
                                      [self.init_val])
        return self

    def forward(self, x):
        h = x
        for i, p in enumerate(self.pts_linears):
            h = torch.relu(maybe_wnorm_apply(p, h))
            if i in self.skips:
                h = torch.cat([x, h], dim=-1)
        return maybe_wnorm_apply(self.output_linear, h)[..., 0]


def pretrain_siren_sdf_loss(surface: ImplicitSurface, pts):
    """L1 sphere-fit loss of SIREN pretraining."""
    sdf_gt = torch.linalg.vector_norm(pts, dim=-1) - surface.radius_init
    return torch.mean(torch.abs(surface.forward(pts) - sdf_gt))
