"""Texture painting, port vs the JAX package: one painting step of a tiny
NeuMesh distilled from a tiny NeuS (paint rays with random colour
directions, background rays with distillation): every loss term and the
masked gradients against jax.value_and_grad of the JAX painting loss at
"highest" with the JAX gradient mask; after the Adam step every frozen
parameter bit-identical, the painted rows of color_features moved. The
paint rays' random directions are the JAX package's (drawn from its key
and handed to the port's renderer)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neumesh_tpu.editing.paint_train import make_grad_mask as jax_grad_mask
from neumesh_tpu.nn import f32_matmul_precision
from neumesh_tpu.train.trainer import Trainer as JTrainer
from neumesh_tpu_torch.config import ConfigDict
from neumesh_tpu_torch.editing.paint_train import (get_optimized_features,
                                                   make_grad_mask)
from neumesh_tpu_torch.train.loop import build_train_step
from neumesh_tpu_torch.train.optimizers import get_optimizer
from neumesh_tpu_torch.train.trainer import Trainer
from test_torch_basics import block_rays, small_scene
from test_torch_train_step import assert_close, grads_tree, tiny_teacher

# the loss weights update_paint_config sets
LOSS_W = dict(img=1.0, mask=0.0, eikonal=0.1, distill_density=1.0,
              distill_color=1.0, indicator_reg=1.0)
RENDER = dict(N_samples=16, N_importance=16, N_upsample_iters=2,
              obj_bounding_radius=1.0, perturb=False, white_bkgd=False,
              bounded_near_far=True)
B = 24


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch():
    """B paint rays (the frame's centre) and B background rays, random
    targets."""
    o, d = block_rays(16, 16, half_fov=0.25)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    rng = np.random.default_rng(7)
    paint = np.arange(96, 96 + B)
    bg = rng.choice(np.setdiff1d(np.arange(256), paint), B, replace=False)
    mi = {"rays_o_paint": o[paint], "rays_d_paint": d[paint],
          "mask_paint": np.ones(B, bool), "rays_o_bg": o[bg],
          "rays_d_bg": d[bg], "mask_bg": np.ones(B, bool)}
    gt = {"rgb_paint": np.ones((B, 3), np.float32),
          "rgb_bg": rng.random((B, 3)).astype(np.float32)}
    return mi, gt


@pytest.fixture(scope="module")
def paint_step():
    jm, jparams, tm = small_scene(seed=3, subdivisions=3, jitter=2e-3)
    jm.use_pallas = tm.use_pallas = False
    jn, jtp, tn = tiny_teacher()
    jparams["ln_s"] = jnp.array(np.asarray(jtp["ln_s"]))
    with torch.no_grad():
        tm.ln_s.copy_(tn.ln_s)
    mi, gt = _batch()
    idx = get_optimized_features(tm.mesh_grid, mi["rays_o_paint"],
                                 mi["rays_d_paint"])
    key = jax.random.PRNGKey(11)

    jt = JTrainer(jm, dict(LOSS_W), teacher_model=jn)

    def loss_fn(p):
        with f32_matmul_precision("highest"):
            ret = jt.render_and_loss_painting(
                p, {k: jnp.asarray(v) for k, v in mi.items()},
                {k: jnp.asarray(v) for k, v in gt.items()}, key,
                dict(RENDER), teacher_params=jtp)
        return ret["losses"]["total"], ret["losses"]

    (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jparams)
    mask = jax_grad_mask(jparams, idx)
    grads = jax.tree.map(lambda g, m: np.asarray(g * m), grads, mask)
    # the JAX renderer's colour directions of the paint group
    k_paint, _ = jax.random.split(key)
    ck = jax.random.split(k_paint, RENDER["N_upsample_iters"] + 1)[-1]
    n_mid = RENDER["N_samples"] + RENDER["N_importance"] - 1
    rnd = np.asarray(jax.random.uniform(ck, (B * n_mid * 3,)))

    cfg = ConfigDict({"training": {
        "lr": 1e-2, "num_iters": 10,
        "scheduler": {"type": "warmupcosine", "warmup_steps": 0}}})
    opt = get_optimizer(cfg, tm)
    step = build_train_step(Trainer(tm, dict(LOSS_W), teacher_model=tn),
                            opt, dict(RENDER), 0, 0, 0, painting=True,
                            grad_mask=make_grad_mask(tm, idx))
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    rand = torch.rand

    def jax_directions(*size, **kw):
        shape = size[0] if len(size) == 1 else size
        if int(np.prod(tuple(shape))) == rnd.size:
            return torch.from_numpy(rnd.reshape(tuple(shape)).copy())
        return rand(*size, **kw)
    torch.rand = jax_directions
    try:
        total, scalars = step(
            {k: torch.from_numpy(np.asarray(v)) for k, v in mi.items()},
            {k: torch.from_numpy(v) for k, v in gt.items()}, None)
    finally:
        torch.rand = rand
    return dict(want_losses={k: float(v) for k, v in losses.items()},
                want_grads=grads, total=total, scalars=scalars, model=tm,
                before=before, idx=idx, teacher=tn)


def test_painting_losses_match_jax(paint_step):
    want = paint_step["want_losses"]
    got = paint_step["scalars"]
    assert set(want) == {"loss_img", "loss_mask", "loss_density",
                         "loss_color", "total"}
    for k, v in want.items():
        g = float(got[k])
        assert np.isfinite(g) and abs(g - v) <= 2e-5 + 1e-4 * abs(v), (k, g,
                                                                     v)
    assert float(paint_step["total"]) == float(got["total"])


def test_painting_masked_gradients_match_jax(paint_step):
    """Only the painted rows of color_features carry a gradient, equal to
    the JAX package's (2e-5 + 1e-4 rel on >= 99%)."""
    idx = paint_step["idx"]
    assert 0 < len(idx) < paint_step["model"].num_vertices // 2
    got = grads_tree(paint_step["model"])
    want = paint_step["want_grads"]
    assert_close("color_features", got["color_features"],
                 want["color_features"])
    cf = got["color_features"]
    assert np.abs(cf[idx]).max() > 0
    assert np.abs(np.delete(cf, idx, axis=0)).max() == 0
    for key, w in want.items():
        if key == "color_features":
            continue
        for leaf in jax.tree_util.tree_leaves(got[key]):
            assert np.abs(leaf).max() == 0, key
        for leaf in jax.tree_util.tree_leaves(w):
            assert np.abs(leaf).max() == 0, key


def test_painting_step_moves_only_the_painted_rows(paint_step):
    """After the Adam step: every parameter but the painted colour rows
    bit-identical to its value before; those rows moved; the teacher has
    no gradient."""
    model, before, idx = (paint_step[k] for k in ("model", "before", "idx"))
    for name, p in model.named_parameters():
        p0 = before[name]
        if name == "color_features":
            rest = np.setdiff1d(np.arange(p.shape[0]), idx)
            assert torch.equal(p.detach()[rest], p0[rest])
            assert (p.detach()[idx] != p0[idx]).any(-1).all()
        else:
            assert torch.equal(p.detach(), p0), name
    assert all(p.grad is None for p in paint_step["teacher"].parameters())
