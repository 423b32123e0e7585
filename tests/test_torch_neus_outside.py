"""NeuS without a mask loss (loss_weights.mask = 0), port vs the JAX
package: the builder requires a positive model:N_outside and the model
then carries the NeRF++ background net (nerf_outside), whose parameter
tree params_from_jax fills from the JAX builder's; the renderer composes
no outside model in either package, so one train step's losses and
gradients equal the JAX step's (jax.value_and_grad at "highest", the
params' ln_s a de-aliased copy as in test_torch_train_step)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neumesh_tpu.config import ConfigDict as JConfig
from neumesh_tpu.models import build_framework as jax_build
from neumesh_tpu.nn import f32_matmul_precision
from neumesh_tpu.ops.rays import get_rays as jax_get_rays
from neumesh_tpu_torch.config import ConfigDict
from neumesh_tpu_torch.models import build_framework
from neumesh_tpu_torch.utils.state import params_from_jax
from test_torch_basics import camera
from test_torch_train_step import (  # noqa: F401
    ATOL, RTOL, assert_close, one_torch_thread)

H = W = 16
N_RAYS = 64


def cfg(C, n_outside=32):
    model = {"framework": "NeuS", "obj_bounding_radius": 1.0,
             "W_geometry_feature": 16, "N_samples": 32, "N_importance": 16,
             "N_upsample_iters": 2, "perturb": False,
             "surface": {"D": 3, "W": 32, "skips": [2], "embed_multires": 2,
                         "radius_init": 0.5},
             "radiance": {"D": 2, "W": 32, "embed_multires_view": 2}}
    if n_outside is not None:
        model["N_outside"] = n_outside
    return C({"data": {"batch_size": 1}, "model": model,
              "training": {"speed_factor": 10.0,
                           "loss_weights": {"img": 1.0, "mask": 0.0,
                                            "eikonal": 0.1}}})


@pytest.fixture(scope="module")
def built():
    t, j = cfg(ConfigDict), cfg(JConfig)
    port = build_framework(t, "NeuS", device="cpu")
    jax_out = jax_build(j, "NeuS", key=jax.random.PRNGKey(3))
    params_from_jax(jax.tree.map(np.asarray, jax_out[1]), port[0])
    return t, j, port, jax_out


def test_builder_and_the_parameter_tree(built):
    t, j, (model, trainer, rk_train, rk_test, _), \
        (jm, jp, _, jk_train, jk_test, _) = built
    assert model.use_outside_nerf and "nerf_outside" in jp
    assert rk_train == jk_train and rk_test == jk_test
    assert t.to_dict() == j.to_dict()
    # the same leaves, part by part
    for part in ("implicit_surface", "radiance_net", "nerf_outside"):
        want = sorted(x.shape for x in jax.tree.leaves(jp[part]))
        got = sorted(tuple(p.shape) for p in getattr(model, part)
                     .parameters())
        assert [int(np.prod(s)) for s in got] == \
            [int(np.prod(s)) for s in want], part
    assert sum(p.numel() for p in model.parameters()) == \
        sum(x.size for x in jax.tree.leaves(jp))
    # params_from_jax filled the background net: its forward agrees
    rng = np.random.default_rng(0)
    x = rng.uniform(-2, 2, (50, 4)).astype(np.float32)
    d = rng.normal(size=(50, 3)).astype(np.float32)
    want = jm.nerf_outside.forward(jp["nerf_outside"], jnp.asarray(x),
                                   jnp.asarray(d))
    with torch.no_grad():
        got = model.nerf_outside.forward(torch.from_numpy(x),
                                         torch.from_numpy(d))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5,
                                   rtol=1e-4)
    for n in (None, 0):
        with pytest.raises(ValueError, match="N_outside"):
            build_framework(cfg(ConfigDict, n), "NeuS", device="cpu")


def test_one_train_step_matches_jax(built):
    _, _, (model, trainer, rk_train, _, _), (_, jp, jt, jk_train, _, _) = \
        built
    rng = np.random.default_rng(1)
    c2w, K = camera(H, W)
    K4 = np.eye(4, dtype=np.float32)
    K4[:3, :3] = K
    mi = {"c2w": c2w[None], "intrinsics": K4[None],
          "object_mask": rng.random((1, H * W)) > 0.4}
    gt = {"rgb": rng.random((1, H * W, 3)).astype(np.float32)}
    key = jax.random.PRNGKey(5)
    k_rays, _ = jax.random.split(key)
    _, _, sel = jax_get_rays(jnp.asarray(mi["c2w"]),
                             jnp.asarray(mi["intrinsics"]), H, W,
                             N_rays=N_RAYS, key=k_rays)
    params = dict(jp, ln_s=jnp.array(np.asarray(jp["ln_s"])))

    def loss_fn(p):
        with f32_matmul_precision("highest"):
            ret = jt.render_and_loss(
                p, {k: jnp.asarray(v) for k, v in mi.items()},
                {k: jnp.asarray(v) for k, v in gt.items()}, key,
                dict(jk_train), N_RAYS, H, W)
        return ret["losses"]["total"], ret["losses"]

    (total, losses), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    model.requires_grad_(True)
    model.ln_s.requires_grad_(False)
    ret = trainer.render_and_loss(
        {k: torch.from_numpy(np.asarray(v)) for k, v in mi.items()},
        {k: torch.from_numpy(v) for k, v in gt.items()}, dict(rk_train),
        N_RAYS, H, W, select_inds=torch.from_numpy(np.asarray(sel)[0]
                                                   .copy()))
    ret["losses"]["total"].backward()
    assert set(ret["losses"]) == set(losses)
    assert "loss_mask" not in losses
    for k, v in losses.items():
        g = float(ret["losses"][k].detach())
        assert np.isfinite(g) and abs(g - float(v)) <= \
            ATOL + RTOL * abs(float(v)), (k, g, float(v))
    want = jax.tree.map(np.asarray, grads)
    for part in ("implicit_surface", "radiance_net"):
        layers = getattr(model, part).layers
        assert len(layers) == len(want[part])
        for i, (lin, lw) in enumerate(zip(layers, want[part])):
            named = dict(lin.named_parameters())
            assert set(named) == set(lw)
            for name, w in lw.items():
                g = named[name].grad.numpy()
                assert_close(f"{part}.{i}.{name}", g.reshape(w.shape), w)
    # the background net takes no gradient in either package
    assert all(np.all(np.asarray(x) == 0)
               for x in jax.tree.leaves(want["nerf_outside"]))
    assert all(p.grad is None or not p.grad.any()
               for p in model.nerf_outside.parameters())
