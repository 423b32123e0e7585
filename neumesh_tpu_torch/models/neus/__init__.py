"""NeuS teacher framework builder (counterpart of
neumesh_tpu/models/neus/__init__.py): every config key the JAX builder
reads, with its default written back into the config."""
from __future__ import annotations

import copy

from .model import NeuS


def loss_weights_of(args, indicator_reg: float = 0.0) -> dict:
    """The six loss weights, defaults written back into the config."""
    lw = args.training.setdefault("loss_weights", {})
    return {k: lw.setdefault(k, indicator_reg if k == "indicator_reg"
                             else 0.0)
            for k in ("img", "mask", "eikonal", "distill_density",
                      "distill_color", "indicator_reg")}


def get_model(args, device="cuda", seed: int = 42):
    from ...render.volume import SingleRenderer
    from ...train.trainer import Trainer

    loss_weights = loss_weights_of(args)
    if loss_weights["mask"] == 0 and not args.model.get("N_outside", 0) > 0:
        # without a mask loss the model carries a NeRF++ background net
        # (nerf_outside, filled by params_from_jax); the renderer composes
        # no outside model, as the JAX package's does not
        raise ValueError("Please specify a positive model:N_outside for "
                         "neus with nerf++")

    model_config = {
        "obj_bounding_radius": args.model.obj_bounding_radius,
        "W_geo_feat": args.model.setdefault("W_geometry_feature", 256),
        "use_outside_nerf": loss_weights["mask"] == 0,
        "speed_factor": args.training.setdefault("speed_factor", 1.0),
        "variance_init": args.model.setdefault("variance_init", 0.05),
    }
    use_siren = args.model.setdefault("use_siren", False)
    surface_cfg = {
        "use_siren": args.model.surface.setdefault("use_siren", use_siren),
        "embed_multires": args.model.surface.setdefault("embed_multires", 6),
        "radius_init": args.model.surface.setdefault("radius_init", 1.0),
        "geometric_init": args.model.surface.setdefault("geometric_init",
                                                        True),
        "D": args.model.surface.setdefault("D", 8),
        "W": args.model.surface.setdefault("W", 256),
        "skips": tuple(args.model.surface.setdefault("skips", [4])),
    }
    radiance_cfg = {
        "use_siren": args.model.radiance.setdefault("use_siren", use_siren),
        "embed_multires": args.model.radiance.setdefault("embed_multires",
                                                         -1),
        "embed_multires_view": args.model.radiance.setdefault(
            "embed_multires_view", -1),
        "use_view_dirs": args.model.radiance.setdefault("use_view_dirs",
                                                        True),
        "D": args.model.radiance.setdefault("D", 4),
        "W": args.model.radiance.setdefault("W", 256),
        "skips": tuple(args.model.radiance.setdefault("skips", [])),
    }
    model = NeuS(surface_cfg=surface_cfg, radiance_cfg=radiance_cfg,
                 device=device, **model_config).init(seed)

    render_kwargs_train = {
        "N_nograd_samples": args.model.setdefault("N_nograd_samples", 2048),
        "N_samples": args.model.setdefault("N_samples", 64),
        "N_importance": args.model.setdefault("N_importance", 64),
        "N_upsample_iters": args.model.setdefault("N_upsample_iters", 4),
        "obj_bounding_radius": args.data.setdefault("obj_bounding_radius",
                                                    1.0),
        "batched": args.data.get("batch_size") is not None,
        "perturb": args.model.setdefault("perturb", True),
        "white_bkgd": args.model.setdefault("white_bkgd", False),
        "bounded_near_far": args.model.setdefault("bounded_near_far", False),
    }
    if loss_weights["eikonal"] > 0:
        render_kwargs_train["calc_normal"] = True
    render_kwargs_test = copy.deepcopy(render_kwargs_train)
    render_kwargs_test["rayschunk"] = args.data.setdefault("val_rayschunk",
                                                           4096)
    render_kwargs_test["perturb"] = False

    trainer = Trainer(model, loss_weights)
    return (model, trainer, render_kwargs_train, render_kwargs_test,
            SingleRenderer(model))
