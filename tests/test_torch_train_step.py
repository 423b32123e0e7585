"""The training slice, port vs the JAX package: every loss term of
compute_loss, one full train step of a tiny NeuMesh distilled from a tiny
NeuS (loss and every parameter gradient against jax.value_and_grad of the
JAX loss at "highest"), three Adam + warmup-cosine steps against the optax
chain, and the teacher's ln_s untouched by two steps through the real
builder. The JAX reference student starts from a COPY of the teacher's
ln_s (its builder aliases the two, which its donated train step cannot
take)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neumesh_tpu.models.neus.model import NeuS as JNeuS
from neumesh_tpu.nn import f32_matmul_precision
from neumesh_tpu.ops.rays import get_rays as jax_get_rays
from neumesh_tpu.train.trainer import Trainer as JTrainer
from neumesh_tpu_torch.models.neus.model import NeuS
from neumesh_tpu_torch.train.trainer import Trainer
from neumesh_tpu_torch.utils.state import params_from_jax
from test_torch_basics import camera, small_scene

# gradients and losses: 2e-5 abs + 1e-4 rel on >= 99% of each tensor
ATOL, RTOL, FRAC = 2e-5, 1e-4, 0.99
LOSS_W = dict(img=1.0, mask=0.1, eikonal=0.1, distill_density=1.0,
              distill_color=1.0, indicator_reg=0.001)
SMALL_NEUS = dict(
    variance_init=0.05, speed_factor=10.0, W_geo_feat=16,
    obj_bounding_radius=1.0,
    surface_cfg=dict(D=3, W=32, skips=(2,), embed_multires=2,
                     radius_init=0.5),
    radiance_cfg=dict(D=2, W=32, embed_multires=-1, embed_multires_view=2))
RENDER = dict(N_samples=32, N_importance=16, N_upsample_iters=2,
              obj_bounding_radius=1.0, perturb=False, white_bkgd=False,
              bounded_near_far=True, calc_normal=True)
H = W = 16
N_RAYS = 64


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these small CPU tensors: the suite runs in
    several worker processes at once, and per-process thread pools
    oversubscribe the cores (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_teacher(seed=1):
    """(JAX NeuS, its params, the port's NeuS with the same params)."""
    jn = JNeuS(**SMALL_NEUS)
    jp = jn.init(jax.random.PRNGKey(seed))
    tn = NeuS(device="cpu", **SMALL_NEUS)
    params_from_jax(jax.tree.map(np.asarray, jp), tn)
    return jn, jp, tn


def batch(seed=0):
    """One view: numpy model_input / ground_truth of an HxW camera."""
    rng = np.random.default_rng(seed)
    c2w, K = camera(H, W)
    K4 = np.eye(4, dtype=np.float32)
    K4[:3, :3] = K
    mi = {"c2w": c2w[None], "intrinsics": K4[None],
          "object_mask": rng.random((1, H * W)) > 0.4}
    gt = {"rgb": rng.random((1, H * W, 3)).astype(np.float32)}
    return mi, gt


def grads_tree(model):
    """{top key: grad | [layer dicts] | layer dict} of a port model, in the
    JAX param tree's layout."""
    tree = {}
    for name, p in model.named_parameters():
        g = (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
        parts = [x for x in name.split(".") if x != "layers"]
        if len(parts) == 1:
            tree[parts[0]] = g
        elif len(parts) == 2:
            tree.setdefault(parts[0], {})[parts[1]] = g
        else:
            lst = tree.setdefault(parts[0], [])
            while len(lst) <= int(parts[1]):
                lst.append({})
            lst[int(parts[1])][parts[2]] = g
    return tree


def assert_close(name, got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    ok = np.abs(got - want) <= ATOL + RTOL * np.abs(want)
    assert ok.mean() >= FRAC, (name, ok.mean(), np.abs(got - want).max())


def _setup(seed=3):
    jm, jparams, tm = small_scene(seed=seed, subdivisions=3, jitter=2e-3)
    jm.use_pallas = tm.use_pallas = False
    jn, jtp, tn = tiny_teacher()
    # the student starts from a copy of the teacher's ln_s, in both packages
    jparams["ln_s"] = jnp.array(np.asarray(jtp["ln_s"]))
    with torch.no_grad():
        tm.ln_s.copy_(tn.ln_s)
    mi, gt = batch()
    key = jax.random.PRNGKey(5)
    k_rays, _ = jax.random.split(key)
    _, _, sel = jax_get_rays(jnp.asarray(mi["c2w"]),
                             jnp.asarray(mi["intrinsics"]), H, W,
                             N_rays=N_RAYS, key=k_rays)
    return jm, jparams, tm, jn, jtp, tn, mi, gt, key, np.asarray(sel)[0]


@pytest.fixture(scope="module")
def step_pair():
    """The JAX loss, its terms and gradients; the port's after backward."""
    jm, jparams, tm, jn, jtp, tn, mi, gt, key, sel = _setup()
    jt = JTrainer(jm, dict(LOSS_W), teacher_model=jn)

    def loss_fn(p):
        with f32_matmul_precision("highest"):
            ret = jt.render_and_loss(
                p, {k: jnp.asarray(v) for k, v in mi.items()},
                {k: jnp.asarray(v) for k, v in gt.items()}, key,
                dict(RENDER), N_RAYS, H, W, teacher_params=jtp)
        return ret["losses"]["total"], (ret["losses"],
                                        ret["extras"]["psnr"])

    (total, (losses, psnr)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(jparams)

    tt = Trainer(tm, dict(LOSS_W), teacher_model=tn)
    tm.requires_grad_(True)
    ret = tt.render_and_loss(
        {k: torch.from_numpy(np.asarray(v)) for k, v in mi.items()},
        {k: torch.from_numpy(v) for k, v in gt.items()}, dict(RENDER),
        N_RAYS, H, W, select_inds=torch.from_numpy(sel.copy()))
    ret["losses"]["total"].backward()
    return dict(want=(float(total), {k: float(v) for k, v in losses.items()},
                      float(psnr), jax.tree.map(np.asarray, grads)),
                got=ret, model=tm, teacher=tn)


def test_every_loss_term_matches_jax(step_pair):
    _, want_losses, want_psnr, _ = step_pair["want"]
    got = step_pair["got"]
    assert set(got["losses"]) == set(want_losses)
    assert set(want_losses) == {"loss_img", "loss_mask", "loss_eikonal",
                                "loss_density", "loss_color",
                                "loss_indicator_vector_reg", "total"}
    for k, v in want_losses.items():
        g = float(got["losses"][k].detach())
        assert np.isfinite(g) and abs(g - v) <= ATOL + RTOL * abs(v), (k, g, v)
    assert abs(float(got["extras"]["psnr"].detach()) - want_psnr) <= 1e-3


def test_train_step_gradients_match_jax(step_pair):
    """Every parameter's gradient, through the eikonal loss (reverse over
    the jvp of the context math), the distillation against the no-grad
    teacher, the mask BCE and the indicator regulariser."""
    _, _, _, want = step_pair["want"]
    got = grads_tree(step_pair["model"])
    assert set(got) == set(want)
    n = 0
    for key, w in want.items():
        if isinstance(w, list):
            for i, (gl, wl) in enumerate(zip(got[key], w)):
                for k in wl:
                    assert_close(f"{key}[{i}].{k}", gl[k], wl[k])
                    n += 1
        elif isinstance(w, dict):
            for k in w:
                assert_close(f"{key}.{k}", got[key][k], w[k])
                n += 1
        else:
            assert_close(key, got[key], w)
            n += 1
    # the gradient reaches every table (the contexts keep the codes'
    # gradient)
    for key in ("geometry_features", "color_features", "indicator_vector",
                "ln_s", "indicator_weight_raw"):
        assert np.abs(got[key]).max() > 0, key
    assert n >= 15
    # the teacher gets no gradient
    assert all(p.grad is None for p in step_pair["teacher"].parameters())


def test_adam_warmup_cosine_matches_optax():
    """Three steps of the port's Adam (per-group lr, warmup-cosine read at
    the pre-increment step) against the JAX package's optax chain, on the
    same gradients."""
    from neumesh_tpu.train.optimizers import get_optimizer as jax_opt
    from neumesh_tpu_torch.config import ConfigDict
    from neumesh_tpu_torch.train.optimizers import get_optimizer
    from neumesh_tpu_torch.utils.state import params_tree

    _, _, tm = small_scene(seed=4, subdivisions=2)
    cfg = ConfigDict({"training": {
        "lr": {"default": 5e-4, "geometry_features": 2e-3},
        "num_iters": 10, "scheduler": {"type": "warmupcosine",
                                       "warmup_steps": 2}}})
    jparams = jax.tree.map(jnp.asarray, params_tree(tm))
    jopt = jax_opt(cfg, jparams)
    jstate = jopt.init(jparams)
    opt = get_optimizer(cfg, tm)
    rng = np.random.default_rng(9)
    for step in range(3):
        grads = jax.tree.map(
            lambda x: rng.normal(size=x.shape).astype(np.float32), jparams)
        updates, jstate = jopt.update(grads, jstate, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, updates)
        gt = grads_layout(tm, grads)
        for name, p in tm.named_parameters():
            p.grad = torch.from_numpy(np.array(gt[name]))
        opt.step()
        want = jax.tree.map(np.asarray, jparams)
        got = params_tree(tm)
        # a few ulps apart at most: XLA contracts the moments' a * b + c
        for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                                jax.tree_util.tree_leaves(got)):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7,
                                       err_msg=f"step {step} {path}")
    assert opt.count == 3


def grads_layout(model, tree):
    """The JAX tree's leaves by the port's parameter names."""
    out = {}
    for name, _ in model.named_parameters():
        parts = [x for x in name.split(".") if x != "layers"]
        node = tree[parts[0]]
        for x in parts[1:]:
            node = node[int(x)] if isinstance(node, list) else node[x]
        out[name] = np.asarray(node)
    return out


def test_teacher_ln_s_untouched_through_the_builder(tmp_path):
    """Two train steps through build_framework: the student holds its own
    copy of the teacher's ln_s, trains it, and leaves the teacher's."""
    from neumesh_tpu_torch.config import ConfigDict, save_yaml
    from neumesh_tpu_torch.dataio.synthetic import icosphere_mesh
    from neumesh_tpu_torch.mesh.triangle_mesh import save_ply
    from neumesh_tpu_torch.models import build_framework
    from neumesh_tpu_torch.train.loop import build_train_step, to_device
    from neumesh_tpu_torch.train.optimizers import get_optimizer
    from neumesh_tpu_torch.utils.checkpoints import CheckpointIO

    teacher_cfg = ConfigDict({
        "expname": "teacher", "data": {"obj_bounding_radius": 1.0},
        "model": {"framework": "NeuS", "obj_bounding_radius": 1.0,
                  "W_geometry_feature": 16,
                  "surface": dict(D=3, W=32, skips=[2], embed_multires=2,
                                  radius_init=0.5),
                  "radiance": dict(D=2, W=32, embed_multires=-1,
                                   embed_multires_view=2)},
        "training": {"speed_factor": 10.0,
                     "loss_weights": {"img": 1.0, "mask": 1.0}}})
    save_yaml(teacher_cfg, str(tmp_path / "teacher.yaml"))
    teacher, *_ = build_framework(ConfigDict(teacher_cfg.to_dict()), "NeuS",
                                  device="cpu", seed=3)
    CheckpointIO(str(tmp_path)).save("latest.ckpt", model=teacher)
    save_ply(icosphere_mesh(0.5, 2), str(tmp_path / "mesh.ply"))
    cfg = ConfigDict({
        "expname": "student",
        "data": {"N_rays": 32, "batch_size": 1, "obj_bounding_radius": 1.0},
        "model": {"framework": "NeuMesh",
                  "prior_mesh": str(tmp_path / "mesh.ply"),
                  "D_density": 2, "D_color": 2, "W": 32, "geometry_dim": 8,
                  "color_dim": 8, "multires_d": 4, "multires_fg": 1,
                  "multires_ft": 1, "multires_view": 2,
                  "enable_nablas_input": True,
                  "learn_indicator_weight": True, "N_samples": 16,
                  "N_importance": 8, "N_upsample_iters": 2},
        "training": {"speed_factor": 1.0, "lr": 5e-4, "num_iters": 4,
                     "scheduler": {"type": "warmupcosine",
                                   "warmup_steps": 1},
                     "loss_weights": dict(LOSS_W),
                     "teacher_config": str(tmp_path / "teacher.yaml"),
                     "teacher_ckpt": str(tmp_path / "latest.ckpt")}})
    model, trainer, rk, _, _ = build_framework(cfg, "NeuMesh", device="cpu")
    t = trainer.teacher_model
    ln_s_teacher = t.ln_s.detach().clone()
    torch.testing.assert_close(model.ln_s.detach(), ln_s_teacher,
                               rtol=0, atol=0)
    assert model.ln_s.data_ptr() != t.ln_s.data_ptr()
    assert model.speed_factor == t.speed_factor == 10.0
    opt = get_optimizer(cfg, model)
    step = build_train_step(trainer, opt, rk, 32, H, W)
    mi, gt = batch(1)
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        total, scalars = step(to_device(mi, "cpu"), to_device(gt, "cpu"),
                              gen)
        assert np.isfinite(float(total))
        assert np.isfinite(float(scalars["grad_norm"]))
    torch.testing.assert_close(t.ln_s.detach(), ln_s_teacher, rtol=0,
                               atol=0)
    assert not torch.equal(model.ln_s.detach(), ln_s_teacher)
    assert not any(p.requires_grad for p in t.parameters())


def test_metrics_match_jax(rng):
    """psnr with and without a valid mask, and the Gaussian / box SSIM."""
    from neumesh_tpu.ops import metrics as jm
    from neumesh_tpu_torch.ops import metrics as tm
    a = rng.random((3, 12, 10)).astype(np.float32)
    b = np.clip(a + rng.normal(size=a.shape) * 0.05, 0, 1).astype(np.float32)
    m = rng.random((3, 12, 10)) > 0.3
    ta, tb, tmask = map(torch.from_numpy, (a, b, m))
    ja, jb, jmask = map(jnp.asarray, (a, b, m))
    for got, want in ((tm.psnr(ta, tb), jm.psnr(ja, jb)),
                      (tm.psnr(ta, tb, tmask), jm.psnr(ja, jb, jmask)),
                      (tm.ssim(ta, tb), jm.ssim(ja, jb)),
                      (tm.ssim(ta, tb, win=5, sigma=None),
                       jm.ssim(ja, jb, win=5, sigma=None)),
                      (tm.ssim(ta, tb, reduction="none"),
                       jm.ssim(ja, jb, reduction="none"))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("clip", [None, 0.05])
def test_density_distill_loss_matches_jax(rng, clip):
    """The plain L1 mean the reference ships, and the opt-in clip."""
    from neumesh_tpu.train.trainer import density_distill_loss as jax_loss
    from neumesh_tpu_torch.train.trainer import density_distill_loss
    pred = rng.normal(size=(2, 40, 1)).astype(np.float32) * 0.1
    gt = rng.normal(size=(2, 40, 1)).astype(np.float32) * 0.1
    want = jax_loss(jnp.asarray(pred), jnp.asarray(gt), clip)
    got = density_distill_loss(torch.from_numpy(pred), torch.from_numpy(gt),
                               clip)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_teacher_dtype_bf16_targets(step_pair):
    """teacher_dtype="bfloat16": the teacher runs under bf16 autocast and
    its targets come back in f32, within bf16 rounding of the f32 ones."""
    tn = step_pair["teacher"]
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.uniform(-0.6, 0.6, (64, 5, 3)).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(64, 5, 3)).astype(np.float32))
    f32 = Trainer(None, dict(LOSS_W), teacher_model=tn)._teacher(x, d)
    bf = Trainer(None, dict(LOSS_W), teacher_model=tn,
                 teacher_dtype="bfloat16")._teacher(x, d)
    for a, b in zip(bf, f32):
        assert a.dtype == torch.float32 and not a.requires_grad
        assert not torch.equal(a, b)
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-2)
