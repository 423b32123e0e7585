"""Carrying NeuMesh and NeuS weights and state across: the JAX parameter
tree, and the reference-format `.pt` checkpoint ({"model": state_dict,
"global_step", "epoch_idx"}; reference key layout: weight_g (out, 1) /
weight_v (out, in) / weight (out, in) / bias, the nn.Sequential nesting
pts_linears.{i>=2}.0.* of NeuMesh, implicit_surface.surface_fc_layers.{l}
and radiance_net.layers.{l} of NeuS).

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


def _is_neus(model) -> bool:
    return hasattr(model, "implicit_surface")


def params_from_jax(params_np: dict, model) -> None:
    """Fill `model` from its JAX param tree given as numpy arrays. NeuMesh:
    ln_s, geometry_features, color_features, indicator_vector,
    indicator_weight_raw, pts_linears[i] = {g (out,), v (in, out), b},
    density_linear, views_linears[i] = {w (in, out), b}, color_linear.
    NeuS: ln_s, implicit_surface[l], radiance_net[l] (nerf_outside, when
    the model has one: pts_linears, views_linears and its heads)."""
    if _is_neus(model):
        _put(model.ln_s, params_np["ln_s"])
        for part in ("implicit_surface", "radiance_net"):
            for lin, p in zip(getattr(model, part).layers, params_np[part]):
                _lin_from_tree(lin, p)
        if getattr(model, "use_outside_nerf", False):
            no, tree = model.nerf_outside, params_np["nerf_outside"]
            for name in ("pts_linears", "views_linears"):
                for lin, p in zip(getattr(no, name), tree[name]):
                    _lin_from_tree(lin, p)
            for name in ("feature_linear", "alpha_linear", "rgb_linear",
                         "output_linear"):
                if hasattr(no, name):
                    _lin_from_tree(getattr(no, name), tree[name])
        return
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
    if _is_neus(model):
        names = [(lin, f"implicit_surface.surface_fc_layers.{l}")
                 for l, lin in enumerate(model.implicit_surface.layers)]
        names += [(lin, f"radiance_net.layers.{l}")
                  for l, lin in enumerate(model.radiance_net.layers)]
        if getattr(model, "use_outside_nerf", False):
            no = model.nerf_outside
            names += [(lin, f"nerf_outside.pts_linears.{i}")
                      for i, lin in enumerate(no.pts_linears)]
            names.append((no.views_linears[0], "nerf_outside.views_linears.0"))
            names += [(getattr(no, n), f"nerf_outside.{n}")
                      for n in ("feature_linear", "alpha_linear",
                                "rgb_linear", "output_linear")
                      if hasattr(no, n)]
        return names
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
    load_reference_state(ckpt["model"] if "model" in ckpt else ckpt, model)


def _tables(model):
    """Names of the non-linear parameter tables of the reference layout."""
    if _is_neus(model):
        return ("ln_s",)
    names = ("ln_s", "geometry_features", "color_features",
             "indicator_vector")
    if model.indicator_weight_raw is not None:
        names += ("indicator_weight_raw",)
    return names


def _np(x):
    return x.numpy() if hasattr(x, "numpy") else np.asarray(x)


def load_reference_state(sd: dict, model) -> None:
    """Fill `model` (NeuMesh or NeuS) from a reference-layout state dict
    of CPU tensors or numpy arrays."""
    for name in _tables(model):
        _put(getattr(model, name), _np(sd[name]))
    for lin, pre in _ref_layer_names(model):
        if hasattr(lin, "g"):
            _put(lin.g, _np(sd[pre + ".weight_g"])[:, 0])
            _put(lin.v, _np(sd[pre + ".weight_v"]).T)
        else:
            _put(lin.w, _np(sd[pre + ".weight"]).T)
        _put(lin.b, _np(sd[pre + ".bias"]))


def reference_state_dict(model) -> dict:
    """The model's parameters as a reference-layout state dict of CPU
    tensors (inverse of load_reference_state; copies)."""
    def t(x):
        return x.detach().to("cpu", torch.float32).clone().contiguous()

    sd = {name: t(getattr(model, name)) for name in _tables(model)}
    for lin, pre in _ref_layer_names(model):
        if hasattr(lin, "g"):
            sd[pre + ".weight_g"] = t(lin.g)[:, None]
            sd[pre + ".weight_v"] = t(lin.v).T.contiguous()
        else:
            sd[pre + ".weight"] = t(lin.w).T.contiguous()
        sd[pre + ".bias"] = t(lin.b)
    return sd


def save_reference_pt(path: str, model, global_step: int = 0,
                      epoch_idx: int = 0) -> str:
    """Write `model` as a reference-format `.pt` (inverse of
    load_reference_pt)."""
    torch.save({"model": reference_state_dict(model),
                "global_step": int(global_step),
                "epoch_idx": int(epoch_idx)}, path)
    return path


def params_tree(model) -> dict:
    """The model's parameters as its JAX param tree of numpy arrays (the
    inverse of params_from_jax; copies)."""
    def a(t):
        return t.detach().to("cpu", torch.float32).numpy().copy()

    def lin(m):
        if hasattr(m, "g"):
            return {"g": a(m.g), "v": a(m.v), "b": a(m.b)}
        return {"w": a(m.w), "b": a(m.b)}

    if _is_neus(model):
        tree = {"ln_s": a(model.ln_s),
                "implicit_surface": [lin(m) for m in
                                     model.implicit_surface.layers],
                "radiance_net": [lin(m) for m in model.radiance_net.layers]}
        if getattr(model, "use_outside_nerf", False):
            no = model.nerf_outside
            tree["nerf_outside"] = {
                "pts_linears": [lin(m) for m in no.pts_linears],
                "views_linears": [lin(m) for m in no.views_linears],
                **{n: lin(getattr(no, n))
                   for n in ("feature_linear", "alpha_linear", "rgb_linear",
                             "output_linear") if hasattr(no, n)}}
        return tree
    tree = {name: a(getattr(model, name)) for name in _tables(model)}
    tree.update(pts_linears=[lin(m) for m in model.pts_linears],
                density_linear=lin(model.density_linear),
                views_linears=[lin(m) for m in model.views_linears],
                color_linear=lin(model.color_linear))
    return tree


def editable_from_jax(params_np: dict, editable) -> None:
    """Fill a TextureEditableNeuMesh from the JAX package's editable params
    ({"main", "refs", "edit_color_features"}, make_editable_params's
    layout) given as numpy arrays: the main and reference models through
    params_from_jax, one edit_color_features buffer per reference."""
    params_from_jax(params_np["main"], editable.main_model)
    for ref, p in zip(editable.ref_models, params_np["refs"]):
        params_from_jax(p, ref)
    for i, f in enumerate(params_np["edit_color_features"]):
        _put(editable.edit_features(i), f)
