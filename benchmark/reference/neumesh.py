"""Plain NeuMesh field (NeuMesh, ECCV 2022, sec. 3): per-vertex geometry
and colour codes and learnable indicator vectors on a fixed mesh; a query
point takes its K = 8 nearest vertices, weights them by inverse distance,
interpolates the codes and the signed distance

    h(x) = sum_k w_k (w1 <x - v_k, n_k> + |x - v_k|^3) / (w1 + |x - v_k|),

and decodes a density from [gamma_8(h), gamma_2(f_geo)] and a colour from
[grad_x density, gamma_8(h), gamma_4(view), gamma_2(f_col)].

The nearest vertices are found by brute force among the candidate vertex
ids given for each ray (all vertices when the ids list them all); the
selection and its weights carry no gradient. Imports nothing of the
program.
"""
from __future__ import annotations

import torch

from .precision import linear


def embed(x: torch.Tensor, multires: int) -> torch.Tensor:
    """[x, sin(2^0 x), cos(2^0 x), ..., sin(2^(n-1) x), cos(2^(n-1) x)]."""
    parts = [x]
    for i in range(multires):
        f = float(2.0 ** i)
        parts += [torch.sin(x * f), torch.cos(x * f)]
    return torch.cat(parts, dim=-1)


def softplus100(x: torch.Tensor) -> torch.Tensor:
    """Softplus with beta 100 and threshold 20, as torch.nn.Softplus."""
    return torch.where(100.0 * x > 20.0, x,
                       torch.nn.functional.softplus(100.0 * x) / 100.0)


def wn_weight(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Weight norm over each output column of v (in, out)."""
    return v * (g / torch.clamp(torch.linalg.vector_norm(v, dim=0),
                                min=1e-12))


class NeuMeshField:
    """The field from a parameter dict named as the program's parameters
    (`geometry_features`, `pts_linears.0.g`, ...) plus `vertices`."""

    K = 8

    def __init__(self, p: dict, cfg: dict, mode: str = "f32",
                 f32_layers=()):
        self.p = p
        self.cfg = cfg
        self.mode = mode
        # layers kept in float32 whatever `mode`: d0..dn and dh (density),
        # c0..cn and ch (colour), as the program's f32_layers name them
        self.f32_layers = tuple(f32_layers)
        dev = p["vertices"].device
        pad = torch.zeros((1, 3), device=dev)
        self.verts = torch.cat([p["vertices"], pad + 1e9], 0)
        self.ind = torch.cat([p["indicator_vector"], pad], 0)
        feat = torch.cat([p["geometry_features"], p["color_features"]], -1)
        self.feat = torch.cat([feat, feat.new_zeros((1, feat.shape[1]))], 0)
        self.gd = cfg["geometry_dim"]
        self.dens = [(wn_weight(p[f"pts_linears.{i}.g"],
                                p[f"pts_linears.{i}.v"]),
                      p[f"pts_linears.{i}.b"])
                     for i in range(cfg["D_density"])]
        self.dens.append((wn_weight(p["density_linear.g"],
                                    p["density_linear.v"]),
                          p["density_linear.b"]))
        self.col = [(p[f"views_linears.{i}.w"], p[f"views_linears.{i}.b"])
                    for i in range(cfg["D_color"])]
        self.col.append((p["color_linear.w"], p["color_linear.b"]))

    def s(self) -> torch.Tensor:
        return torch.exp(self.p["ln_s"][0] * self.cfg["speed_factor"])

    def w1(self) -> torch.Tensor:
        if self.cfg["learn_indicator_weight"]:
            return torch.sigmoid(self.p["indicator_weight_raw"][0])
        return torch.tensor(0.1, device=self.verts.device)

    def neighbours(self, x: torch.Tensor, ids: torch.Tensor, k: int = 0):
        """x (R, S, 3), candidate ids (R, C) -> vertex ids (R, S, k) and
        normalised inverse-distance weights (R, S, K), both constant.

        The selection follows the rule the program states for its kNN:
        squared distances as |x|^2 + |v|^2 - 2 <x, v> in float32, ties
        (and near-ties within 2e-7 relative) to the lower candidate
        index. Exact distances would choose other neighbours wherever
        float32 rounding reorders two of them, at a few samples in a
        thousand near a dense mesh."""
        x = x.detach()
        p = self.verts[ids]                                    # (R, C, 3)
        x0, x1, x2 = (x[..., i:i + 1] for i in range(3))
        p0, p1, p2 = (p[:, None, :, i] for i in range(3))
        xv = x0 * p0 + x1 * p1 + x2 * p2
        xx = torch.sum(x * x, -1, keepdim=True)
        pp = torch.sum(p * p, -1)[:, None, :]
        d2 = torch.clamp(xx + pp - 2.0 * xv, min=0.0)
        rank = d2 * (1.0 + torch.arange(ids.shape[1], device=x.device,
                                        dtype=x.dtype) * 2e-7)
        sel = torch.topk(rank, k or self.K, dim=-1, largest=False).indices
        w = 1.0 / (torch.sqrt(torch.gather(d2, -1, sel)) + 1e-7)
        w = w / torch.sum(w, -1, keepdim=True)
        vid = torch.gather(ids[:, None, :].expand(-1, x.shape[1], -1), -1,
                           sel)
        return vid, w

    def distance(self, x, vid, w):
        v, n = self.verts[vid], self.ind[vid]                  # (R, S, K, 3)
        diff = x[:, :, None, :] - v
        d = torch.sqrt(torch.clamp(torch.sum(diff * diff, -1), min=1e-20))
        w1 = self.w1()
        term = w1 * torch.sum(diff * n, -1) + d ** 3
        return torch.sum(w * term / (w1 + d), -1, keepdim=True)

    def nearest_distance(self, x, ids):
        """The interpolated distance at x (R, S, 3) from its nearest
        candidate alone (R, S): the surface scan's proxy."""
        vid, w = self.neighbours(x, ids, 1)
        return self.distance(x, vid, w)[..., 0]

    def density_mlp(self, h, fg):
        c = self.cfg
        y = torch.cat([embed(h, c["multires_d"]),
                       embed(fg, c["multires_fg"])], -1)
        for i, (wt, b) in enumerate(self.dens[:-1]):
            y = softplus100(linear(y, wt, b, self._mode(f"d{i}")))
        wt, b = self.dens[-1]
        return linear(y, wt, b, self._mode("dh"))

    def _mode(self, layer: str) -> str:
        return "f32" if layer in self.f32_layers else self.mode

    def color_mlp(self, nabla, h, view, ft):
        c = self.cfg
        parts = [nabla] if c["enable_nablas_input"] else []
        y = torch.cat(parts + [embed(h, c["multires_d"]),
                               embed(view, c["multires_view"]),
                               embed(ft, c["multires_ft"])], -1)
        for i, (wt, b) in enumerate(self.col[:-1]):
            y = torch.relu(linear(y, wt, b, self._mode(f"c{i}")))
        wt, b = self.col[-1]
        return torch.sigmoid(linear(y, wt, b, self._mode("ch")))

    def density(self, x, ids):
        """sdf (R, S) at x (R, S, 3)."""
        vid, w = self.neighbours(x, ids)
        h = self.distance(x, vid, w)
        fg = torch.sum(w[..., None] * self.feat[vid][..., :self.gd], -2)
        return self.density_mlp(h, fg)[..., 0]

    def _field(self, x, ids, create_graph):
        vid, w = self.neighbours(x, ids)
        feats = torch.sum(w[..., None] * self.feat[vid], -2)
        with torch.enable_grad():
            xg = x if x.requires_grad else x.detach().requires_grad_(True)
            h = self.distance(xg, vid, w)
            sdf = self.density_mlp(h, feats[..., :self.gd])
            nabla, = torch.autograd.grad(sdf, xg, torch.ones_like(sdf),
                                         create_graph=create_graph)
        if not create_graph:
            sdf, h, nabla = sdf.detach(), h.detach(), nabla.detach()
        return sdf[..., 0], nabla, h, feats

    def density_nabla(self, x, ids, create_graph: bool = False):
        """(sdf (R, S), nablas (R, S, 3)); differentiable again when
        create_graph."""
        return self._field(x, ids, create_graph)[:2]

    def full(self, x, ids, view, create_graph: bool = False):
        """(sdf (R, S), nablas (R, S, 3), rgb (R, S, 3)); view (R, S, 3)."""
        sdf, nabla, h, feats = self._field(x, ids, create_graph)
        return sdf, nabla, self.color_mlp(nabla, h, view,
                                          feats[..., self.gd:])
