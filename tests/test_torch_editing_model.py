"""TextureEditableNeuMesh, port vs the JAX package: the per-sample blend,
the per-ray bound blend (f32 and bf16), the volume render of an editable
model, the tiled surface render of an editable model (the same hits and
depth as the unedited main model, the edit engaged, the unedited region
untouched), and the kernel routes the editable exposes to the renderers.
Main and reference models bind identical candidate tables (the JAX
grid's) and numpy-seeded parameters; the JAX Pallas kernels run in
interpret mode, the port's plain versions on the CPU."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neumesh_tpu.editing.texture_model import (
    TextureEditableNeuMesh as JEditable, make_editable_params)
from neumesh_tpu_torch.editing.texture_model import TextureEditableNeuMesh
from neumesh_tpu_torch.utils.state import editable_from_jax
from test_torch_basics import block_rays, small_scene

# 180 degrees about y: the reference frame of the gate's swap
T_Y180 = np.diag([-1.0, 1.0, -1.0, 1.0])
TILE = 16
CFGS = {"N_steps": 16, "N_secant_steps": 3, "fill_inf": False}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _scenes(bf16: bool):
    """The main (seed 0) and reference (seed 1) scenes, built once a
    dtype."""
    kw_j = dict(compute_dtype=jnp.bfloat16) if bf16 else {}
    kw_t = dict(compute_dtype=torch.bfloat16) if bf16 else {}
    return (small_scene(seed=0, jax_kw=kw_j, torch_kw=kw_t, jitter=1e-3),
            small_scene(seed=1, jax_kw=kw_j, torch_kw=kw_t, jitter=1e-3))


def editable_pair(bf16=False, use_pallas=False):
    """(JAX editable, its params, the port's editable filled from them
    through editable_from_jax): the reference model's colour codes
    rotated into edit features, the camera-facing x > 0.1 region edited."""
    (jm, p_main, tm), (jr, p_ref, tr) = _scenes(bf16)
    for m in (jm, tm, jr, tr):
        m.use_pallas = use_pallas
        m.use_fused_locate = False
    verts = np.asarray(jm.mesh_grid.vertices)
    mask = (verts[:, 2] < -0.2) & (verts[:, 0] > 0.1)
    feats = np.asarray(p_ref["color_features"])[::-1].copy()
    jed = JEditable(jm, [jr], mask[None], T_r_m_list=[T_Y180])
    jp = make_editable_params(p_main, [p_ref], [feats])
    ted = TextureEditableNeuMesh(tm, [tr], mask[None], [T_Y180])
    editable_from_jax(jax.tree.map(np.asarray, jp), ted)
    return jed, jp, ted, mask


def _rays(n=64):
    o, d = block_rays(8, 8, block=(8, 8), half_fov=0.12)
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


def _samples(o, d, jn, jf, S=10):
    t = np.linspace(0.2, 0.3, S, dtype=np.float32)
    z = jn + (jf - jn) * t
    pts = (o[:, None] + z[..., None] * d[:, None]).astype(np.float32)
    return pts, np.broadcast_to(d[:, None], pts.shape).copy()


def _near_far(o, d):
    from neumesh_tpu.ops.rays import near_far_from_sphere
    jn, jf = near_far_from_sphere(jnp.asarray(o), jnp.asarray(d))
    return np.asarray(jn), np.asarray(jf)


def test_editable_from_jax_copies_every_table():
    jed, jp, ted, mask = editable_pair()
    assert ted.main_editing_masks.shape == (1, len(mask))
    np.testing.assert_array_equal(ted.main_editing_masks[0].numpy(), mask)
    np.testing.assert_array_equal(ted.edit_features(0).numpy(),
                                  np.asarray(jp["edit_color_features"][0]))
    np.testing.assert_array_equal(ted.rot_s_m[0].numpy(), T_Y180[:3, :3])
    np.testing.assert_array_equal(
        ted.ref_models[0].color_features.detach().numpy(),
        np.asarray(jp["refs"][0]["color_features"]))
    # a buffer of its own, not the caller's array
    ted.edit_features(0).add_(1.0)
    assert not np.array_equal(ted.edit_features(0).numpy(),
                              np.asarray(jp["edit_color_features"][0]))


def test_per_sample_blend_matches_jax():
    """The kNN through the grid per sample: sdf from the main model, the
    blend of the reference colour (rotated directions and nablas) where
    the paint weight is positive."""
    jed, jp, ted, _ = editable_pair()
    o, d = _rays()
    jn, jf = _near_far(o, d)
    pts, dirs = _samples(o, d, jn, jf)
    sdf_j, rgb_j = jax.jit(jed.forward)(jp, jnp.asarray(pts),
                                        jnp.asarray(dirs))
    sdf_t, rgb_t = ted.forward(torch.from_numpy(pts), torch.from_numpy(dirs))
    np.testing.assert_allclose(sdf_t.detach().numpy(), np.asarray(sdf_j),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(rgb_t.detach().numpy(), np.asarray(rgb_j),
                               atol=1e-4, rtol=1e-4)
    # geometry untouched, the colour engaged on part of the bundle only
    _, rgb_main = ted.main_model.forward(torch.from_numpy(pts),
                                         torch.from_numpy(dirs))
    diff = (rgb_t - rgb_main).abs().amax(-1).detach().numpy()
    assert diff.max() > 1e-3 and diff.min() < 1e-6


@pytest.mark.parametrize("dtype", [None, "bf16"])
def test_bound_blend_matches_jax(dtype):
    """The per-ray bound view: the context math plus the cached edit
    masks and features (the sentinel id N reads a zero row); f32 at 1e-4,
    bf16 at 2e-2 (tests/test_torch_rayctx.py's bf16 tolerance)."""
    jed, jp, ted, mask = editable_pair(bf16=dtype is not None)
    o, d = _rays()
    jn, jf = _near_far(o, d)
    pts, dirs = _samples(o, d, jn, jf)
    tb = ted.bind_rays(torch.from_numpy(o), torch.from_numpy(d),
                       torch.from_numpy(jn), torch.from_numpy(jf))
    ids = tb.bound.ctx["ids"]
    n = ted.main_model.num_vertices
    assert (ids == n).any()
    np.testing.assert_array_equal(tb._masks[0][ids == n].numpy(), 0.0)
    np.testing.assert_array_equal(
        tb._masks[0][ids < n].numpy(), mask[ids[ids < n].numpy()])
    sdf_j, rgb_j = jax.jit(lambda p, x, v: jed.bind_rays(
        p, *map(jnp.asarray, (o, d, jn, jf))).forward(p, x, v))(
            jp, jnp.asarray(pts), jnp.asarray(dirs))
    with torch.no_grad():
        sdf_t, rgb_t = tb.forward(torch.from_numpy(pts),
                                  torch.from_numpy(dirs))
        _, rgb_main = ted.main_model.bind_rays(
            torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(jn),
            torch.from_numpy(jf)).forward(torch.from_numpy(pts),
                                          torch.from_numpy(dirs))
    tol = dict(atol=1e-4, rtol=1e-4) if dtype is None else dict(atol=2e-2)
    np.testing.assert_allclose(sdf_t.float().numpy(),
                               np.asarray(sdf_j, np.float32), **tol)
    np.testing.assert_allclose(rgb_t.float().numpy(),
                               np.asarray(rgb_j, np.float32), **tol)
    diff = (rgb_t - rgb_main).abs().amax(-1).float().numpy()
    assert diff.max() > 1e-3, "edit region never engaged"
    assert diff.min() < 1e-6, "unedited region altered"


def test_volume_render_of_editable_matches_jax():
    """volume_render_rays over the editable: per-ray contexts, the
    up-sampling density through the bound's forward_density_only_nograd;
    rgb and depth within 1e-3 on >= 99% of the rays."""
    from neumesh_tpu.render.volume import volume_render_rays as jax_render
    from neumesh_tpu_torch.render.volume import volume_render_rays
    jed, jp, ted, _ = editable_pair()
    o, d = block_rays(8, 16, half_fov=0.25)
    kw = dict(detailed_output=False, N_samples=16, N_importance=16,
              N_upsample_iters=2, bounded_near_far=True, perturb=False)
    want = jax.jit(lambda p, o, d: jax_render(
        jed, p, o, d, jax.random.PRNGKey(0), **kw))(
            jp, jnp.asarray(o), jnp.asarray(d))
    with torch.no_grad():
        got = volume_render_rays(ted, torch.from_numpy(o),
                                 torch.from_numpy(d), **kw)
        main = volume_render_rays(ted.main_model, torch.from_numpy(o),
                                  torch.from_numpy(d), **kw)
    for k in ("rgb", "depth_volume"):
        err = np.abs(got[k].numpy() - np.asarray(want[k]))
        err = err.max(-1) if err.ndim > 1 else err
        assert (err <= 1e-3).mean() >= 0.99, (k, err.max())
    np.testing.assert_array_equal(got["depth_volume"].numpy(),
                                  main["depth_volume"].numpy())
    assert (got["rgb"] - main["rgb"]).abs().max() > 1e-3


def test_surface_render_of_editable_tiled():
    """The tile-bound editable on the surface pipeline (use_pallas: the
    scan and fused secant of the main model, plain versions here): the
    same hits and depth as the unedited main model, the rgb changed only
    on rays whose tile candidates include an edited vertex, and the whole
    render against the JAX package's."""
    from neumesh_tpu.render.ray_casting import surface_render as jax_surface
    from neumesh_tpu_torch.ops import kernels
    from neumesh_tpu_torch.render.ray_casting import surface_render
    jed, jp, ted, mask = editable_pair(use_pallas=True)
    o, d = block_rays(16, 16, half_fov=0.25)
    kw = dict(ray_tile=TILE, scan_mode="distance", tile_max_candidates=32)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    calls = []
    wrapped = kernels.secant_refine

    def count(*a, **k):
        calls.append(1)
        return wrapped(*a, **k)
    kernels.secant_refine = count
    try:
        rgb_t, dep_t, ex_t = surface_render(ted, to, td, device="cpu",
                                            ray_casting_cfgs=dict(CFGS), **kw)
    finally:
        kernels.secant_refine = wrapped
    assert calls, "the fused secant route was not taken"
    rgb_m, dep_m, ex_m = surface_render(ted.main_model, to, td, device="cpu",
                                        ray_casting_cfgs=dict(CFGS), **kw)
    hit = ex_t["mask_surface"].numpy()
    assert hit.mean() > 0.3
    np.testing.assert_array_equal(hit, ex_m["mask_surface"].numpy())
    np.testing.assert_array_equal(dep_t.numpy(), dep_m.numpy())
    diff = (rgb_t - rgb_m).abs().amax(-1).numpy()
    assert diff[hit].max() > 1e-3, "edit region never engaged"
    assert diff[hit].min() < 1e-6, "unedited region altered"
    # rays whose tile context holds no edited vertex keep the main colour
    # (the main model shades with the fused `full` route, the editable
    # with the context math: the same colour within 1e-5)
    from neumesh_tpu_torch.ops.rays import near_far_from_sphere
    tdn = td / torch.linalg.vector_norm(td, dim=-1, keepdim=True)
    near, far = near_far_from_sphere(to, tdn, keepdim=False)
    bound, _, _ = ted.bind_rays_tiled(to, tdn, near[:, None], far[:, None],
                                      tile=TILE, max_candidates=32)
    touched = np.repeat(bound._masks[0].numpy().any(-1), TILE)
    assert touched.any() and (~touched & hit).any()
    assert diff[~touched].max() <= 1e-5
    jrgb, jdep, jex = jax.jit(lambda p, o, d: jax_surface(
        jed, p, o, d, ray_casting_cfgs=dict(CFGS), **kw))(
            jp, jnp.asarray(o), jnp.asarray(d))
    jhit = np.asarray(jex["mask_surface"])
    assert (jhit == hit).mean() >= 0.995
    both = hit & jhit
    rgb_ok = (np.abs(rgb_t.numpy() - np.asarray(jrgb)).max(-1) <= 1e-4)
    dep_ok = np.abs(dep_t.numpy() - np.asarray(jdep)) <= 1e-4
    assert rgb_ok[both].mean() >= 0.99 and dep_ok[both].mean() >= 0.99


def test_editable_exposes_the_main_routes_and_no_forward_full():
    """The renderers probe the model for kernel routes: the editable
    carries the main model's use_pallas / use_fused_locate, its bound
    view delegates forward_density_only_nograd, fused_secant and
    fused_locate, and has no forward_full (the surface render would shade
    with it and skip the blend)."""
    from neumesh_tpu_torch.models.neumesh.model import RayBoundNeuMesh
    jed, jp, ted, _ = editable_pair(use_pallas=True)
    ted.main_model.use_fused_locate = True
    assert ted.use_pallas and ted.use_fused_locate
    assert ted.secant_rebracket == ted.main_model.secant_rebracket
    assert ted.device == ted.main_model.device
    o, d = _rays()
    jn, jf = _near_far(o, d)
    args = (torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(jn),
            torch.from_numpy(jf))
    for bound in (ted.bind_rays(*args),
                  ted.bind_rays_tiled(*args, tile=TILE)[0]):
        for name in ("forward_density_only_nograd", "fused_secant",
                     "fused_locate", "forward_with_nablas",
                     "compute_distance", "forward_density_only"):
            assert callable(getattr(bound, name)), name
        assert not hasattr(bound, "forward_full")
        assert isinstance(bound.bound, RayBoundNeuMesh)
        assert bound.model is ted.main_model
        pts = torch.from_numpy(_samples(o, d, jn, jf, 4)[0])
        np.testing.assert_array_equal(
            bound.forward_density_only_nograd(pts).numpy(),
            bound.bound.forward_density_only_nograd(pts).numpy())
    # the JAX bound view lacks it too
    from neumesh_tpu.editing.texture_model import RayBoundTextureEditable
    assert not hasattr(RayBoundTextureEditable, "forward_full")
