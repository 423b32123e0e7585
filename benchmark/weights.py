"""Weights made on the device from the seed, in a few large calls, and
written into the program's parameters. The same tensors (cloned) go to the
plain reference, so that both sides start from one set of weights.
"""
from __future__ import annotations

import math

import torch


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)


def _fill(params: dict, values: dict) -> dict:
    with torch.no_grad():
        for name, t in values.items():
            params[name].copy_(t)
    return {n: p.detach().clone() for n, p in params.items()}


def _uniform_layers(layers, gen, device):
    """{name: U(-1/sqrt(in), 1/sqrt(in))} for (prefix, in, out, weight
    key) layers from one draw; a weight-normalised layer gets g = ||v||."""
    sizes = [i * o + o for _, i, o, _ in layers]
    flat = torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0
    out, at = {}, 0
    for (prefix, i, o, key), n in zip(layers, sizes):
        bound = 1.0 / math.sqrt(i)
        w = flat[at:at + i * o].reshape(i, o) * bound
        out[f"{prefix}.{key}"] = w
        out[f"{prefix}.b"] = flat[at + i * o:at + n] * bound
        if key == "v":
            out[f"{prefix}.g"] = torch.linalg.vector_norm(w, dim=0)
        at += n
    return out


def neumesh(model, vertices: torch.Tensor, seed: int, ln_s: float) -> dict:
    """N(0, 1) codes, sphere normals as indicator vectors, the indicator
    weight at sigmoid(-2), uniform MLP layers. Returns the reference's
    copy, with `vertices`."""
    dev = vertices.device
    gen = generator(seed, dev)
    params = dict(model.named_parameters())
    n, gd = model.geometry_features.shape
    codes = torch.randn((n, gd + model.color_features.shape[1]),
                        generator=gen, device=dev)
    layers = [(f"pts_linears.{i}", lin.v.shape[0], lin.v.shape[1], "v")
              for i, lin in enumerate(model.pts_linears)]
    layers.append(("density_linear", model.W, 1, "v"))
    layers += [(f"views_linears.{i}", lin.w.shape[0], lin.w.shape[1], "w")
               for i, lin in enumerate(model.views_linears)]
    layers.append(("color_linear", model.W, 3, "w"))
    values = _uniform_layers(layers, gen, dev)
    values.update(
        geometry_features=codes[:, :gd], color_features=codes[:, gd:],
        indicator_vector=vertices / torch.linalg.vector_norm(
            vertices, dim=-1, keepdim=True),
        ln_s=torch.full((1,), ln_s, device=dev))
    if "indicator_weight_raw" in params:
        values["indicator_weight_raw"] = torch.full((1,), -2.0, device=dev)
    ref = _fill(params, values)
    ref["vertices"] = vertices.clone()
    return ref


def neus(model, seed: int, device) -> dict:
    """NeuS's geometric initialisation of the SDF net (a sphere of the
    configured radius_init) and uniform radiance layers, from the seed."""
    gen = generator(seed, device)
    surf = model.implicit_surface
    params = dict(model.named_parameters())
    dims = surf.layer_dims
    normals = torch.randn(sum(i * o for i, o in dims), generator=gen,
                          device=device)
    values, at = {}, 0
    n_emb = surf.embed_fn.out_dim
    for l, (i, o) in enumerate(dims):
        z = normals[at:at + i * o].reshape(i, o)
        at += i * o
        b = torch.zeros(o, device=device)
        std = math.sqrt(2.0) / math.sqrt(o)
        if l == surf.D:
            w = z * 1e-4 + math.sqrt(math.pi) / math.sqrt(i)
            b = torch.full((o,), -surf.radius_init, device=device)
        elif l == 0:
            w = torch.zeros_like(z)
            w[:3] = z[:3] * std
        else:
            w = z * std
            if l in surf.skips:
                w[i - (n_emb - 3):] = 0.0
        values[f"implicit_surface.layers.{l}.v"] = w
        values[f"implicit_surface.layers.{l}.g"] = torch.linalg.vector_norm(
            w, dim=0)
        values[f"implicit_surface.layers.{l}.b"] = b
    values.update(_uniform_layers(
        [(f"radiance_net.layers.{l}", i, o, "v")
         for l, (i, o) in enumerate(model.radiance_net.layer_dims)],
        gen, device))
    return _fill(params, values)
