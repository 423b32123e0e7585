"""Plain NeuS (NeuS, NeurIPS 2021) and its training step.

The SDF MLP: positional encoding of x, 8 softplus(beta=100) layers of
width 256 with the encoded input concatenated (over sqrt 2) before layer 4,
a head giving the sdf and a 256-wide geometry feature. The radiance MLP:
[x, encoded view direction, normal = grad sdf, feature] through 4 ReLU
layers to a sigmoid colour. Weight norm on every layer.

A step renders N rays with the NeuS volume structure (uniform samples,
perturbed hierarchical up-sampling without gradient, sdf and normals at
the sorted depths, colour at the midpoints), takes the L1 colour loss over
the mask, the mask's binary cross-entropy and the eikonal loss, and steps
Adam with the warm-up cosine schedule. Imports nothing of the program.
"""
from __future__ import annotations

import math

import torch

from .neumesh import embed, softplus100, wn_weight
from .precision import linear
from .volume import alpha_from_sdf, composite, sphere_near_far, upsample, \
    visibility


class NeuSField:
    def __init__(self, p: dict, cfg: dict, mode: str = "f32"):
        self.p, self.cfg, self.mode = p, cfg, mode
        self.surf = cfg["surface"]
        self.rad = cfg["radiance"]

    def _layer(self, prefix, l):
        p = self.p
        return (wn_weight(p[f"{prefix}.{l}.g"], p[f"{prefix}.{l}.v"]),
                p[f"{prefix}.{l}.b"])

    def s(self):
        return torch.exp(self.p["ln_s"][0] * self.cfg["speed_factor"])

    def sdf_and_feature(self, x):
        e = embed(x, self.surf["embed_multires"])
        h = e
        D = self.surf["D"]
        for l in range(D):
            if l in self.surf["skips"]:
                h = torch.cat([h, e], -1) / math.sqrt(2.0)
            h = softplus100(linear(h, *self._layer(
                "implicit_surface.layers", l), self.mode))
        out = linear(h, *self._layer("implicit_surface.layers", D),
                     self.mode)
        return out[..., 0], out[..., 1:]

    def sdf(self, x):
        return self.sdf_and_feature(x)[0]

    def with_normals(self, x, create_graph: bool):
        """(sdf, grad_x sdf, feature); differentiable again when
        create_graph."""
        with torch.enable_grad():
            xg = x if x.requires_grad else x.detach().requires_grad_(True)
            sdf, feat = self.sdf_and_feature(xg)
            n, = torch.autograd.grad(sdf, xg, torch.ones_like(sdf),
                                     create_graph=create_graph)
        return sdf, n, feat

    def radiance(self, x, view, normal, feat):
        m = self.rad["embed_multires"]
        h = torch.cat([x if m < 0 else embed(x, m),
                       embed(view, self.rad["embed_multires_view"]), normal,
                       feat], -1)
        D = self.rad["D"]
        for l in range(D):
            h = torch.relu(linear(h, *self._layer("radiance_net.layers", l),
                                  self.mode))
        return torch.sigmoid(linear(h, *self._layer("radiance_net.layers",
                                                    D), self.mode))


def render_and_loss(field: NeuSField, o, d, target_rgb, target_mask,
                    uniforms, r: dict, w: dict, rgb_scale: float = 1.0):
    """Losses of one training step on rays (R, 3) -> {name: scalar}.
    rgb_scale alters the rendered colour (a planted fault)."""
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    near, far = sphere_near_far(o, d, r["obj_bounding_radius"])
    with torch.no_grad():
        z, _ = upsample(field.sdf, o, d, near, far, r["N_samples"],
                        r["N_importance"], r["N_upsample_iters"],
                        uniforms=uniforms)

    def at(t):
        return o[:, None, :] + t[..., None] * d[:, None, :]

    sdf, nablas, _ = field.with_normals(at(z), create_graph=True)
    z_mid = 0.5 * (z[..., 1:] + z[..., :-1])
    x_mid = at(z_mid)
    _, n_mid, feat = field.with_normals(x_mid, create_graph=True)
    rad = field.radiance(x_mid, d[:, None, :].expand_as(x_mid), n_mid, feat)
    vis = visibility(alpha_from_sdf(sdf, field.s()))
    rgb, _, acc = composite(vis, rad, z_mid)
    rgb = rgb * rgb_scale
    m = target_mask.to(torch.float32)
    acc = torch.clamp(acc, 1e-3, 1.0 - 1e-3)
    losses = {}
    if w["eikonal"] > 0:
        norm = torch.sqrt(torch.sum(nablas * nablas, -1) + 1e-12)
        losses["loss_eikonal"] = w["eikonal"] * torch.mean((norm - 1.0) ** 2)
    losses["loss_mask"] = w["mask"] * torch.mean(
        -(m * torch.log(acc) + (1.0 - m) * torch.log(1.0 - acc)))
    losses["loss_img"] = torch.sum(w["img"] * torch.abs(rgb - target_rgb)
                                   * m[:, None]) / (torch.sum(m) + 1e-10)
    losses["total"] = sum(losses.values())
    return losses


def warmup_cosine(step: int, total: int, warmup: int,
                  min_factor: float = 0.1) -> float:
    if step < warmup:
        return step / max(warmup, 1)
    cos = math.cos(math.pi * (step - warmup) / (total - warmup))
    return (cos + 1.0) * 0.5 * (1 - min_factor) + min_factor


class Adam:
    """Adam (Kingma and Ba) with bias correction, betas (0.9, 0.999), eps
    1e-8, lr times the schedule's factor at the step's count."""

    def __init__(self, params: dict, lr: float, factor, b1=0.9, b2=0.999,
                 eps=1e-8):
        self.params, self.lr, self.factor = params, lr, factor
        self.b1, self.b2, self.eps = b1, b2, eps
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, grads: dict):
        f = self.factor(self.count)
        t = self.count + 1
        for n, p in self.params.items():
            g = grads[n]
            self.m[n].mul_(self.b1).add_((1 - self.b1) * g)
            self.v[n].mul_(self.b2).add_((1 - self.b2) * g * g)
            mh = self.m[n] / (1 - self.b1 ** t)
            vh = self.v[n] / (1 - self.b2 ** t)
            p.sub_(self.lr * f * mh / (torch.sqrt(vh) + self.eps))
        self.count = t
