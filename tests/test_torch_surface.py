"""The surface render: surface_locate's plain version against the JAX
Pallas kernel (interpret mode), the bound model's colour routes without
nablas input, and the port's whole surface_render against the JAX
surface_render (use_pallas=True, its kernels in interpret mode) in the
composed, fused-locate, shade-composite and no-nablas-input structures,
f32 and bf16. The CUDA kernels are held against the plain versions on a
card in test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neumesh_tpu.ops.pallas_kernels import surface_locate as jax_locate
from neumesh_tpu.render.ray_casting import surface_render as jax_surface
from neumesh_tpu_torch.render.ray_casting import (render_surface_image,
                                                  surface_render)
from test_torch_basics import block_rays, camera, small_scene
from test_torch_cuda import (assert_locate_close, locate_rays,
                             low_precision_mask, no_tie_mask, random_context,
                             torch_locate)

TILE = 16
# the surface serving knobs (bench.py SERVING, TPU-only knobs dropped)
SURF_MODEL = dict(tile_kp_per_probe=8, f32_layers=("d0", "dh", "c0", "ch"),
                  secant_full_precision=False, scan_knn_k=1,
                  tile_cell_budget=64)
SURF = dict(ray_tile=TILE, scan_mode="distance", tile_max_candidates=64)
CFGS = {"N_steps": 16, "N_secant_steps": 3, "fill_inf": False}
STRUCTURES = {
    "composed": ({}, {}),
    "fused_locate": (dict(use_fused_locate=True), {}),
    "shade_composite": ({}, dict(shade_composite=8, shade_topk=4,
                                 shade_win_frac=0.25)),
    "no_nablas_input": (dict(enable_nablas_input=False), {}),
}


def _jax_locate(inp, lr, dtype, n_steps):
    gd = inp["kw"]["geometry_dim"]
    low = low_precision_mask(inp["dws"], dtype)
    ws = [jnp.asarray(w).astype(jnp.bfloat16) if lo else jnp.asarray(w)
          for w, lo in zip(inp["dws"], low)]
    out = jax_locate(
        *[jnp.asarray(lr[n]) for n in ("rays_o", "rays_d", "near", "far")],
        jnp.asarray(inp["geo"]), jnp.asarray(inp["feat"][..., :gd]),
        inp["w1"], ws, n_steps=n_steps, n_secant=3,
        multires_d=inp["kw"]["multires_d"],
        multires_fg=inp["kw"]["multires_fg"], geometry_dim=gd,
        dtype=None if dtype is None else jnp.bfloat16, interpret=True)
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("dtype", [None, "bf16"])
def test_surface_locate_plain_matches_pallas(dtype):
    inp = random_context(seed=21, B=3, C=70, outward=True)
    lr = locate_rays(22, 3, 16, 16)
    ok = no_tie_mask(lr["scan"], inp["geo"]).reshape(-1, 16).all(-1)
    assert ok.mean() > 0.9
    got = torch_locate(inp, lr, dtype, 16)
    want = _jax_locate(inp, lr, dtype, 16)
    assert got[0].shape == (48,) and 0.3 < want[1].mean()
    assert_locate_close(got, want, ok, dtype)


@pytest.mark.parametrize("dtype,T", [(None, 37), ("bf16", 37), (None, 100)])
def test_surface_locate_plain_matches_pallas_on_ragged_tiles(dtype, T):
    """Tiles of T rays that are no multiple of the CUDA kernel's 64-ray
    block (nor of 8): the plain version against the interpreted TPU
    kernel, mask bits equal and d_pred as assert_roots_close (f32: 2e-5 +
    1e-4 rel on >= 99% of the rays without a kNN near-tie at a scan point;
    bf16: 2e-3 on >= 97%)."""
    inp = random_context(seed=23, B=2, C=70, outward=True)
    lr = locate_rays(24, 2, T, 16)
    ok = no_tie_mask(lr["scan"], inp["geo"]).reshape(-1, 16).all(-1)
    assert ok.mean() > 0.9
    got = torch_locate(inp, lr, dtype, 16)
    want = _jax_locate(inp, lr, dtype, 16)
    assert got[0].shape == (2 * T,) and 0.3 < want[1].mean()
    assert_locate_close(got, want, ok, dtype)


def _scene(kw, dtype, seed=1):
    jkw = dict(SURF_MODEL, **kw)
    tkw = dict(SURF_MODEL, **kw)
    if dtype is not None:
        jkw["compute_dtype"] = jnp.bfloat16
        tkw["compute_dtype"] = torch.bfloat16
    return small_scene(seed=seed, jax_kw=jkw, torch_kw=tkw)


def _bound_pair(jm, params, tm, o, d):
    from neumesh_tpu.ops.rays import near_far_from_sphere as jnf
    from neumesh_tpu_torch.ops.rays import near_far_from_sphere
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    near, far = jnf(jo, jd)
    jb, _, _ = jm.bind_rays_tiled(params, jo, jd, near, far, tile=TILE,
                                  max_candidates=64)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    tn, tf = near_far_from_sphere(to, td)
    tb, _, _ = tm.bind_rays_tiled(to, td, tn, tf, tile=TILE,
                                  max_candidates=64)
    return jb, tb


@pytest.mark.parametrize("dtype", [None, "bf16"])
def test_forward_without_nablas_input_matches_jax(dtype):
    """enable_nablas_input=False: forward runs candidate_field_v3 + the
    plain-torch MLPs (it raised before); forward_full adds the nablas from
    one density_nabla launch."""
    jm, params, tm = _scene(dict(enable_nablas_input=False), dtype, seed=3)
    o, d = block_rays(8, 16, half_fov=0.2)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    jb, tb = _bound_pair(jm, params, tm, o, d)
    t = np.linspace(2.0, 2.2, 4, dtype=np.float32)
    pts = o[:, None] + t[None, :, None] * d[:, None]
    dirs = np.broadcast_to(d[:, None], pts.shape).copy()
    want = jb.forward_full(params, jnp.asarray(pts), jnp.asarray(dirs))
    got = tb.forward_full(torch.from_numpy(pts), torch.from_numpy(dirs))
    names = ("sdf", "rgb", "nablas")
    for name, g, w in zip(names, got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape and np.isfinite(g).all(), name
        err = np.abs(g - w)
        if dtype is None:
            np.testing.assert_allclose(g, w, atol=2e-5 if name != "nablas"
                                       else 1e-4, rtol=1e-4, err_msg=name)
        else:
            assert (err <= 1e-2).mean() >= 0.97, (name, err.max())


def _surface_both(structure, dtype, H=16, W=16):
    model_kw, shade_kw = STRUCTURES[structure]
    jm, params, tm = _scene(model_kw, dtype)
    o, d = block_rays(H, W, half_fov=0.25)
    jrgb, jdep, jex = jax_surface(jm, params, jnp.asarray(o), jnp.asarray(d),
                                  ray_casting_cfgs=dict(CFGS), **SURF,
                                  **shade_kw)
    rgb, dep, ex = surface_render(tm, torch.from_numpy(o),
                                  torch.from_numpy(d),
                                  ray_casting_cfgs=dict(CFGS), **SURF,
                                  **shade_kw, device="cpu")
    want = dict(rgb=np.asarray(jrgb), depth=np.asarray(jdep),
                mask=np.asarray(jex["mask_surface"]),
                normals=np.asarray(jex["normals_surface"]))
    got = dict(rgb=rgb.numpy(), depth=dep.numpy(),
               mask=ex["mask_surface"].numpy(),
               normals=ex["normals_surface"].numpy())
    return got, want


@pytest.mark.parametrize("structure", list(STRUCTURES))
@pytest.mark.parametrize("dtype", [None, "bf16"])
def test_surface_render_matches_jax(structure, dtype):
    """f32: masks equal on >= 99.5% of rays, depth and rgb within 1e-4 on
    >= 99% of the rays both hit; bf16: masks on >= 97%, rgb within 1e-2 on
    >= 97% of them."""
    got, want = _surface_both(structure, dtype)
    for v in got.values():
        assert np.isfinite(v).all()
    assert got["rgb"].shape == (256, 3) and got["depth"].shape == (256,)
    assert 0.2 < want["mask"].mean() < 0.9
    same = (got["mask"] == want["mask"]).mean()
    both = got["mask"] & want["mask"]
    rgb_ok = (np.abs(got["rgb"] - want["rgb"]).max(-1) <= (
        1e-4 if dtype is None else 1e-2))[both].mean()
    if dtype is None:
        assert same >= 0.995, same
        assert rgb_ok >= 0.99, rgb_ok
        dep_ok = (np.abs(got["depth"] - want["depth"]) <= 1e-4)[both].mean()
        assert dep_ok >= 0.99, dep_ok
    else:
        assert same >= 0.97, same
        assert rgb_ok >= 0.97, rgb_ok


def test_render_surface_image_restores_raster_order():
    """render_surface_image = pixel-block-ordered surface_render (2x8
    blocks at tile 16) + the inverse permutation; tile-aligned chunks
    give the same frame."""
    from neumesh_tpu_torch.ops.rays import block_order_indices, get_rays
    _, _, tm = small_scene(seed=2, torch_kw=SURF_MODEL)
    c2w, K = camera(16, 16)
    kw = dict(ray_tile=TILE, scan_mode="distance", tile_max_candidates=64,
              N_steps=16, N_secant_steps=3)
    rgb, depth, ex = render_surface_image(tm, c2w, K, 16, 16, device="cpu",
                                          **kw)
    assert rgb.shape == (16, 16, 3) and depth.shape == (16, 16)
    assert ex["normals_surface"].shape == (16, 16, 3)
    o, d = get_rays(torch.from_numpy(c2w), torch.from_numpy(K), 16, 16)
    perm, _ = block_order_indices(16, 16, 2, 8)
    rgb_b, dep_b, _ = surface_render(
        tm, o[perm], d[perm], ray_tile=TILE, scan_mode="distance",
        tile_max_candidates=64, device="cpu",
        ray_casting_cfgs=dict(CFGS))
    np.testing.assert_array_equal(rgb.reshape(-1, 3).numpy()[perm],
                                  rgb_b.numpy())
    np.testing.assert_array_equal(depth.reshape(-1).numpy()[perm],
                                  dep_b.numpy())
    assert float(ex["mask_surface"].float().mean()) > 0.2
    rgb_c, _, _ = render_surface_image(tm, c2w, K, 16, 16, device="cpu",
                                       rayschunk=100, **kw)
    np.testing.assert_allclose(rgb_c.numpy(), rgb.numpy(), atol=1e-6)


def test_surface_entry_points_default_to_cuda_and_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    _, _, tm = small_scene(seed=2)
    c2w, K = camera(16, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render_surface_image(tm, c2w, K, 16, 16, ray_tile=TILE)
    o, d = block_rays(16, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        surface_render(tm, torch.from_numpy(o), torch.from_numpy(d),
                       ray_tile=TILE)
    # ray_tile 0 on the CPU renders through per-ray contexts
    rgb, depth, _ = surface_render(tm, torch.from_numpy(o),
                                   torch.from_numpy(d), ray_tile=0,
                                   device="cpu")
    assert rgb.shape == (256, 3) and bool(torch.isfinite(depth).all())


def test_sphere_tracing_matches_jax():
    """Sphere tracing on an analytic field (a sphere's distance with a
    bump): depths, points and masks as the JAX function's."""
    from neumesh_tpu.render.ray_casting import \
        sphere_tracing_surface_points as jax_trace
    from neumesh_tpu_torch.render.ray_casting import \
        sphere_tracing_surface_points

    o, d = block_rays(16, 16, half_fov=0.35)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)

    def field(lib, norm):
        def f(p):
            return (norm(p) - 0.5
                    + 0.02 * lib.sin(6.0 * p[..., 0]) * lib.cos(4.0 * p[..., 1]))
        return f

    want = jax_trace(field(jnp, lambda p: jnp.linalg.norm(p, axis=-1)),
                     jnp.asarray(o), jnp.asarray(d), near=1.0, far=4.0,
                     N_iters=12)
    got = sphere_tracing_surface_points(
        field(torch, lambda p: torch.linalg.vector_norm(p, dim=-1)),
        torch.from_numpy(o), torch.from_numpy(d), near=1.0, far=4.0,
        N_iters=12)
    mask = np.asarray(want[2])
    assert 0.2 < mask.mean() < 1.0
    np.testing.assert_array_equal(got[2].numpy(), mask)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-5)
