"""Carrying NeuMesh weights and state across: the JAX parameter tree, and
the reference-format `.pt` checkpoint ({"model": state_dict,
"global_step", "epoch_idx"}, reference key layout incl. the nn.Sequential
nesting pts_linears.{i>=2}.0.*).

Every tensor is COPIED into the model's own parameters: nothing shares
storage with the caller's arrays (two models holding one aliased ln_s is
how a train step with donated buffers breaks).
"""
from __future__ import annotations

import numpy as np
import torch


def _put(p: torch.Tensor, a) -> None:
    src = torch.as_tensor(np.array(a, dtype=np.float32, copy=True))
    if tuple(src.shape) != tuple(p.shape):
        src = src.reshape(p.shape)
    with torch.no_grad():
        p.copy_(src)


def _lin_from_tree(lin, p: dict) -> None:
    if "g" in p:
        _put(lin.g, p["g"])
        _put(lin.v, p["v"])
    else:
        _put(lin.w, p["w"])
    _put(lin.b, p["b"])


def params_from_jax(params_np: dict, model) -> None:
    """Fill `model` from the JAX NeuMesh param tree given as numpy arrays:
    ln_s, geometry_features, color_features, indicator_vector,
    indicator_weight_raw, pts_linears[i] = {g (out,), v (in, out), b},
    density_linear, views_linears[i] = {w (in, out), b}, color_linear."""
    for name in ("ln_s", "geometry_features", "color_features",
                 "indicator_vector"):
        _put(getattr(model, name), params_np[name])
    if model.indicator_weight_raw is not None:
        _put(model.indicator_weight_raw, params_np["indicator_weight_raw"])
    for lin, p in zip(model.pts_linears, params_np["pts_linears"]):
        _lin_from_tree(lin, p)
    _lin_from_tree(model.density_linear, params_np["density_linear"])
    for lin, p in zip(model.views_linears, params_np["views_linears"]):
        _lin_from_tree(lin, p)
    _lin_from_tree(model.color_linear, params_np["color_linear"])


def _ref_layer_names(model):
    """(module, reference key prefix) for every linear layer."""
    names = [(model.pts_linears[0], "pts_linears.0")]
    names += [(model.pts_linears[i], f"pts_linears.{i + 1}.0")
              for i in range(1, model.D_density)]
    names.append((model.density_linear, "density_linear"))
    names.append((model.views_linears[0], "views_linears.0"))
    names += [(model.views_linears[i], f"views_linears.{i + 1}.0")
              for i in range(1, model.D_color)]
    names.append((model.color_linear, "color_linear.0"))
    return names


def load_reference_pt(path: str, model) -> None:
    """Fill `model` from a reference-format `.pt` (weight_g (out, 1),
    weight_v (out, in), weight (out, in), bias)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt["model"] if "model" in ckpt else ckpt
    for name in ("ln_s", "geometry_features", "color_features",
                 "indicator_vector"):
        _put(getattr(model, name), sd[name].numpy())
    if model.indicator_weight_raw is not None:
        _put(model.indicator_weight_raw, sd["indicator_weight_raw"].numpy())
    for lin, pre in _ref_layer_names(model):
        if hasattr(lin, "g"):
            _put(lin.g, sd[pre + ".weight_g"].numpy()[:, 0])
            _put(lin.v, sd[pre + ".weight_v"].numpy().T)
        else:
            _put(lin.w, sd[pre + ".weight"].numpy().T)
        _put(lin.b, sd[pre + ".bias"].numpy())


def save_reference_pt(path: str, model, global_step: int = 0,
                      epoch_idx: int = 0) -> str:
    """Write `model` as a reference-format `.pt` (inverse of
    load_reference_pt)."""
    def t(x):
        return x.detach().to("cpu", torch.float32).clone().contiguous()

    sd = {name: t(getattr(model, name))
          for name in ("ln_s", "geometry_features", "color_features",
                       "indicator_vector")}
    if model.indicator_weight_raw is not None:
        sd["indicator_weight_raw"] = t(model.indicator_weight_raw)
    for lin, pre in _ref_layer_names(model):
        if hasattr(lin, "g"):
            sd[pre + ".weight_g"] = t(lin.g)[:, None]
            sd[pre + ".weight_v"] = t(lin.v).T.contiguous()
        else:
            sd[pre + ".weight"] = t(lin.w).T.contiguous()
        sd[pre + ".bias"] = t(lin.b)
    torch.save({"model": sd, "global_step": int(global_step),
                "epoch_idx": int(epoch_idx)}, path)
    return path
