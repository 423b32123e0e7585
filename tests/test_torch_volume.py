"""The whole slice: tile-context volume render of a NeuMesh, port vs the
JAX package (use_pallas=True: its field_fused / secant_refine run as
Pallas kernels in interpret mode), in both sampling structures."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neumesh_tpu.render.volume import volume_render_rays as jax_render
from neumesh_tpu_torch.ops import kernels
from neumesh_tpu_torch.render.volume import render_image, volume_render
from test_torch_basics import block_rays, camera, small_scene

TILE = 16
# reference structure: 64 coarse + 4x16 up-sampling, colour at midpoints
REF = dict(ray_tile=TILE, tile_max_candidates=128, N_samples=64,
           N_importance=64, N_upsample_iters=4, reuse_upsample_sdf=True,
           detailed_output=False)
# root-anchored serving structure at the serving knobs
VOL_MODEL = dict(tile_kp_per_probe=12, tile_cell_budget=64, scan_knn_k=1)
VOL = dict(root_anchored=True, root_n_fine=8, root_steps=16, root_secant=3,
           root_win_frac=0.25, color_topk=4, ray_tile=TILE,
           tile_max_candidates=64, N_samples=64, N_importance=64,
           N_upsample_iters=4, reuse_upsample_sdf=True,
           detailed_output=False)


def _both(jax_kw, torch_kw, render_kw, H=16, W=16):
    jm, params, tm = small_scene(seed=1, jax_kw=jax_kw, torch_kw=torch_kw)
    o, d = block_rays(H, W, half_fov=0.25)
    want = jax_render(jm, params, jnp.asarray(o), jnp.asarray(d),
                      jax.random.PRNGKey(0), perturb=False,
                      bounded_near_far=True, **render_kw)
    kernels.reset_launch_counts()
    rgb, depth, _ = volume_render(tm, torch.from_numpy(o),
                                  torch.from_numpy(d), device="cpu",
                                  **render_kw)
    return ({k: np.asarray(v) for k, v in want.items()}, rgb.numpy(),
            depth.numpy(), tm)


def _share_close(a, b, atol):
    err = np.abs(a - b)
    if err.ndim > 1:
        err = err.max(-1)
    return float((err <= atol).mean()), float(err.max())


def test_reference_structure_f32_matches_jax():
    want, rgb, depth, _ = _both({}, {}, REF)
    assert np.isfinite(rgb).all() and np.isfinite(depth).all()
    share, worst = _share_close(rgb, want["rgb"], 1e-3)
    assert share >= 0.99, (share, worst)
    share, worst = _share_close(depth, want["depth_volume"], 1e-3)
    assert share >= 0.99, (share, worst)
    # 64 coarse + 4 up-sampling density launches, one colour launch (the
    # CPU tensors count no kernel launch: the plain versions ran)
    assert sum(kernels.LAUNCHES["field_fused"].values()) == 0


def test_root_anchored_structure_bf16_matches_jax():
    kw = dict(compute_dtype=jnp.bfloat16, **VOL_MODEL)
    tkw = dict(compute_dtype=torch.bfloat16, **VOL_MODEL)
    want, rgb, depth, _ = _both(kw, tkw, VOL)
    assert np.isfinite(rgb).all() and np.isfinite(depth).all()
    share, worst = _share_close(rgb, want["rgb"], 1e-2)
    assert share >= 0.97, (share, worst)


def test_render_image_restores_raster_order():
    """render_image = block-ordered render + inverse permutation."""
    _, _, tm = small_scene(seed=2)
    c2w, K = camera(16, 16)
    rgb, depth, ret = render_image(tm, c2w, K, 16, 16, device="cpu", **REF)
    assert rgb.shape == (16, 16, 3) and depth.shape == (16, 16)
    o, d = block_rays(16, 16)
    rgb_b, _, _ = volume_render(tm, torch.from_numpy(o), torch.from_numpy(d),
                                device="cpu", **REF)
    from neumesh_tpu_torch.ops.rays import block_order_indices
    perm, _ = block_order_indices(16, 16, 8, 16)
    np.testing.assert_array_equal(rgb.reshape(-1, 3).numpy()[perm],
                                  rgb_b.numpy())
    # chunked rendering (tile-aligned chunks) gives the same frame
    rgb_c, _, _ = volume_render(tm, torch.from_numpy(o), torch.from_numpy(d),
                                device="cpu", rayschunk=128, **REF)
    np.testing.assert_allclose(rgb_c.numpy(), rgb_b.numpy(), atol=1e-6)


@pytest.mark.parametrize("refine,rebracket", [(False, True), (True, True),
                                              (True, False)])
def test_root_finding_unfused_matches_jax(refine, rebracket):
    """The scan + bracket + (re-bracket) + secant loop without a fused
    override, on analytic fields: a sphere proxy and a bumpier density."""
    from neumesh_tpu.render.ray_casting import \
        root_finding_surface_points as jax_roots
    from neumesh_tpu_torch.render.ray_casting import \
        root_finding_surface_points

    o, d = block_rays(16, 16, half_fov=0.3)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    near = np.full(o.shape[0], 1.5, np.float32)
    far = np.full(o.shape[0], 3.5, np.float32)

    def fields(lib):
        def norm(p):
            if lib is jnp:
                return jnp.linalg.norm(p, axis=-1)
            return torch.linalg.vector_norm(p, dim=-1)

        def proxy(p):
            return norm(p) - 0.5

        def density(p):
            return (norm(p) - 0.52
                    + 0.01 * lib.sin(7.0 * p[..., 0]) * lib.cos(5.0 * p[..., 1]))
        return proxy, (density if refine else None)

    jp, jd = fields(jnp)
    tp, td = fields(torch)
    want = jax_roots(jp, jnp.asarray(o), jnp.asarray(d), jnp.asarray(near),
                     jnp.asarray(far), N_steps=16, N_secant_steps=4,
                     fill_inf=False, refine_query_fn=jd, rebracket=rebracket)
    got = root_finding_surface_points(
        tp, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(near),
        torch.from_numpy(far), N_steps=16, N_secant_steps=4, fill_inf=False,
        refine_query_fn=td, rebracket=rebracket)
    mask = np.asarray(want[2])
    assert 0.2 < mask.mean() < 1.0
    np.testing.assert_array_equal(got[2].numpy(), mask)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=1e-5)
