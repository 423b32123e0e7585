"""The NeuS teacher, port vs the JAX package: ImplicitSurface, RadianceNet
and NeuS forward, nablas and the volume render on numpy-seeded params
carried across by params_from_jax (f32: 1e-5 abs + 1e-4 rel), the
geometric init's sphere SDF, and the builder."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neumesh_tpu.models.base import ImplicitSurface as JSurface
from neumesh_tpu.models.base import RadianceNet as JRadiance
from neumesh_tpu.render.volume import volume_render_rays as jax_render
from neumesh_tpu_torch.models.base import ImplicitSurface, RadianceNet
from neumesh_tpu_torch.render.volume import volume_render_rays
from test_torch_basics import block_rays
from test_torch_train_step import (  # noqa: F401
    one_torch_thread, tiny_teacher)

ATOL, RTOL = 1e-5, 1e-4


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got.detach() if hasattr(
        got, "detach") else got), np.asarray(want), atol=atol, rtol=rtol)


def _share_close(got, want, atol=1e-4, rtol=1e-3, frac=0.99):
    """>= frac of the values within tolerance: a near-tie in the
    up-sampling's inverse-CDF rank count moves a sample between bins."""
    g, w = np.asarray(got), np.asarray(want)
    assert g.shape == w.shape
    ok = np.abs(g - w) <= atol + rtol * np.abs(w)
    assert ok.mean() >= frac, (ok.mean(), np.abs(g - w).max())


def _layers_from(jparams, module):
    """Copy a JAX layer list into the port module's layers."""
    from neumesh_tpu_torch.utils.state import _lin_from_tree
    for lin, p in zip(module.layers, jparams):
        _lin_from_tree(lin, jax.tree.map(np.asarray, p))


def test_implicit_surface_and_radiance_match_jax(rng):
    kw = dict(D=4, W=32, skips=(2,), W_geo_feat=8, embed_multires=3,
              radius_init=0.5)
    js = JSurface(**kw)
    jp = js.init(jax.random.PRNGKey(0))
    ts = ImplicitSurface(device="cpu", **kw)
    _layers_from(jp, ts)
    x = rng.uniform(-1, 1, (5, 7, 3)).astype(np.float32)
    # (sdf, nablas, geometry feature); forward's sdf and feature as well
    want = jax.jit(js.forward_with_nablas)(jp, jnp.asarray(x))
    got = ts.forward_with_nablas(torch.from_numpy(x))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w)
    tsdf, tfeat = ts.forward(torch.from_numpy(x), return_h=True)
    _close(tsdf, want[0])
    _close(tfeat, want[2])

    rkw = dict(D=2, W=32, W_geo_feat=8, embed_multires=-1,
               embed_multires_view=2)
    jr = JRadiance(**rkw)
    jrp = jr.init(jax.random.PRNGKey(1))
    tr = RadianceNet(device="cpu", **rkw)
    _layers_from(jrp, tr)
    v = rng.normal(size=(5, 7, 3)).astype(np.float32)
    n = rng.normal(size=(5, 7, 3)).astype(np.float32)
    f = rng.normal(size=(5, 7, 8)).astype(np.float32)
    want = jax.jit(jr.forward)(jrp, *map(jnp.asarray, (x, v, n, f)))
    got = tr.forward(*map(torch.from_numpy, (x, v, n, f)))
    _close(got, want)


def test_neus_forward_nablas_and_volume_render_match_jax(rng):
    jn, jp, tn = tiny_teacher(seed=2)
    x = rng.uniform(-0.8, 0.8, (6, 9, 3)).astype(np.float32)
    d = rng.normal(size=(6, 9, 3)).astype(np.float32)
    want = jax.jit(jn.forward)(jp, jnp.asarray(x), jnp.asarray(d))
    for g, w in zip(tn.forward(torch.from_numpy(x), torch.from_numpy(d)),
                    want):
        _close(g, w)
    # the nablas are checked in the render below (implicit_nablas)
    _close(tn.forward_with_nablas(torch.from_numpy(x))[0], want[0])
    _close(tn.forward_s(), jn.forward_s(jp))
    # the volume render of the teacher: sphere bounds, 32 + 2 x 8 samples,
    # detailed outputs and normals
    o, dd = block_rays(8, 16, half_fov=0.3)
    kw = dict(N_samples=32, N_importance=16, N_upsample_iters=2,
              calc_normal=True, perturb=False)
    want = jax.jit(lambda p, o, d: jax_render(
        jn, p, o, d, jax.random.PRNGKey(0), **kw))(
            jp, jnp.asarray(o), jnp.asarray(dd))
    with torch.no_grad():
        got = volume_render_rays(tn, torch.from_numpy(o),
                                 torch.from_numpy(dd), **kw)
    assert set(got) == set(want)
    for k in ("rgb", "depth_volume", "mask_volume", "normals_volume",
              "implicit_surface", "implicit_nablas", "visibility_weights",
              "d_final"):
        _share_close(got[k], want[k])


def test_geometric_init_is_a_sphere_sdf(rng):
    """At init the SDF net is close to |x| - radius_init (SAL/IDR init),
    in the port as in the JAX package, at the teacher config's width."""
    kw = dict(D=8, W=256, skips=(4,), W_geo_feat=256, embed_multires=6,
              radius_init=0.5)
    x = rng.uniform(-1, 1, (4096, 3)).astype(np.float32)
    want = np.linalg.norm(x, axis=-1) - 0.5
    ts = ImplicitSurface(device="cpu", **kw).init(0)
    js = JSurface(**kw)
    jsdf = np.asarray(jax.jit(js.forward)(js.init(jax.random.PRNGKey(0)),
                                          jnp.asarray(x)))
    with torch.no_grad():
        tsdf = ts.forward(torch.from_numpy(x)).numpy()
    r = np.linalg.norm(x, axis=-1)
    for sdf in (tsdf, jsdf):
        # both inits: ~0.9 correlation, ~0.1 mean error (seeds 0-2)
        assert np.corrcoef(sdf, want)[0, 1] > 0.85
        assert np.mean(np.abs(sdf - want)) < 0.15
        assert sdf[r < 0.25].max() < 0 < sdf[r > 0.9].min()
    # the statistics agree between the two packages' inits
    assert abs(np.mean(np.abs(tsdf - want))
               - np.mean(np.abs(jsdf - want))) < 0.05
    # skip layer: the octave rows of its input are zero
    v = ts.layers[4].v.detach().numpy()
    assert np.all(v[-(ts.input_ch - 3):] == 0)
    assert np.any(v[:-(ts.input_ch - 3)] != 0)
    # weight norm: g = ||v||_col at init
    for lin in ts.layers:
        np.testing.assert_allclose(
            lin.g.detach().numpy(),
            np.linalg.norm(lin.v.detach().numpy(), axis=0), rtol=1e-6)


def test_neus_builder_defaults_and_outside_nerf():
    from neumesh_tpu.config import ConfigDict as JConfig
    from neumesh_tpu.models import build_framework as jax_build
    from neumesh_tpu_torch.config import ConfigDict
    from neumesh_tpu_torch.models import build_framework

    def cfg(C, mask):
        return C({"data": {"batch_size": 1},
                  "model": {"framework": "NeuS", "obj_bounding_radius": 1.0,
                            "W_geometry_feature": 16,
                            "surface": {"D": 3, "W": 32, "skips": [2],
                                        "embed_multires": 2},
                            "radiance": {"D": 2, "W": 32}},
                  "training": {"loss_weights": {"img": 1.0, "mask": mask,
                                                "eikonal": 0.1}}})
    t, j = cfg(ConfigDict, 1.0), cfg(JConfig, 1.0)
    model, trainer, rk_train, rk_test, _ = build_framework(t, "NeuS",
                                                           device="cpu")
    _, _, _, jk_train, jk_test, _ = jax_build(j, "NeuS")
    assert rk_train == jk_train and rk_test == jk_test
    assert t.to_dict() == j.to_dict()          # defaults written back alike
    assert trainer.teacher_model is None and not model.use_outside_nerf
    assert sum(p.numel() for p in model.parameters()) > 0
    # no mask loss: a positive model:N_outside is required, and the model
    # then carries the NeRF++ background net (tests/test_torch_neus_outside)
    with pytest.raises(ValueError, match="N_outside"):
        build_framework(cfg(ConfigDict, 0.0), "NeuS", device="cpu")
    c = cfg(ConfigDict, 0.0)
    c.model["N_outside"] = 32
    model, *_ = build_framework(c, "NeuS", device="cpu")
    assert model.use_outside_nerf


def test_siren_pretraining_fits_the_sphere():
    """maybe_pretrain_siren fits a geometric-init SIREN surface to the
    sphere of its radius_init (L1 falls) and leaves other models alone."""
    from neumesh_tpu_torch.config import ConfigDict
    from neumesh_tpu_torch.models.base import pretrain_siren_sdf_loss
    from neumesh_tpu_torch.models.neus.model import NeuS
    from neumesh_tpu_torch.train.pretrain import maybe_pretrain_siren
    cfg = ConfigDict({"training": {"pretrain_num_iters": 40,
                                   "pretrain_lr": 1e-3,
                                   "pretrain_batch_points": 512}})
    surface = dict(D=3, W=32, skips=(), embed_multires=-1, radius_init=0.5,
                   use_siren=True)
    model = NeuS(device="cpu", W_geo_feat=8, surface_cfg=surface,
                 radiance_cfg=dict(D=1, W=16)).init(0)
    pts = torch.rand((2048, 3), generator=torch.Generator().manual_seed(1)) \
        * 2 - 1
    with torch.no_grad():
        before = float(pretrain_siren_sdf_loss(model.implicit_surface, pts))
    maybe_pretrain_siren(cfg, model)
    with torch.no_grad():
        after = float(pretrain_siren_sdf_loss(model.implicit_surface, pts))
    assert after < 0.5 * before, (before, after)
    assert not any(p.requires_grad for p in model.parameters())
    plain = NeuS(device="cpu", W_geo_feat=8,
                 surface_cfg=dict(surface, use_siren=False, skips=(1,),
                                  embed_multires=2),
                 radiance_cfg=dict(D=1, W=16)).init(0)
    ref = [p.clone() for p in plain.parameters()]
    maybe_pretrain_siren(cfg, plain)
    assert all(torch.equal(a, b) for a, b in zip(ref, plain.parameters()))
