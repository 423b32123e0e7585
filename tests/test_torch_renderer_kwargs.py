"""The renderers' keywords, port vs the JAX package: every detailed and
samples_output key of volume_render_rays, color_topk only without
detailed_output, near_bypass / far_bypass, batched (B, N, 3) rays,
random_color_direction, and the surface root finding's `method`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neumesh_tpu.render.volume import volume_render_rays as jax_render
from neumesh_tpu_torch.render.volume import volume_render_rays
from test_torch_basics import block_rays, small_scene
from test_torch_train_step import one_torch_thread  # noqa: F401

KW = dict(N_samples=16, N_importance=8, N_upsample_iters=2, perturb=False)
DETAILED = ("implicit_surface", "radiance", "alpha", "cdf",
            "visibility_weights", "d_final", "implicit_nablas")
SAMPLES = ("xyz", "dirs", "density", "colors")


@pytest.fixture(scope="module")
def scene():
    jm, params, tm = small_scene(seed=11, subdivisions=3, jitter=2e-3)
    jm.use_pallas = tm.use_pallas = False
    o, d = block_rays(8, 16, half_fov=0.25)
    return jm, params, tm, o, d


def _render_both(scene, **kw):
    jm, params, tm, o, d = scene
    want = jax.jit(lambda p, o, d: jax_render(
        jm, p, o, d, jax.random.PRNGKey(0), **kw))(
            params, jnp.asarray(o), jnp.asarray(d))
    with torch.no_grad():
        got = volume_render_rays(tm, torch.from_numpy(o),
                                 torch.from_numpy(d), **kw)
    return got, {k: np.asarray(v) for k, v in want.items()}


def _share(got, want, atol=1e-4, rtol=1e-3):
    g = got.numpy() if hasattr(got, "numpy") else got
    assert g.shape == want.shape
    return float((np.abs(g - want) <= atol + rtol * np.abs(want)).mean())


def test_detailed_and_samples_outputs_match_jax(scene):
    got, want = _render_both(scene, calc_normal=True, samples_output=True,
                             **KW)
    assert set(got) == set(want)
    assert set(DETAILED + SAMPLES) <= set(got)
    for k in want:
        assert _share(got[k], want[k]) >= 0.99, k
    # the defaults: detailed_output on, no samples_output, no nablas
    with torch.no_grad():
        got = volume_render_rays(scene[2], torch.from_numpy(scene[3]),
                                 torch.from_numpy(scene[4]), **KW)
    assert set(got) == {"rgb", "depth_volume", "mask_volume"} | (
        set(DETAILED) - {"implicit_nablas"})


def test_color_topk_and_bypass_match_jax(scene):
    """At the defaults (detailed_output=True) color_topk is off: the render
    equals the one without it; with detailed_output=False it applies, as
    in the JAX package, here together with near_bypass / far_bypass."""
    _, _, tm, o, d = scene
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    with torch.no_grad():
        full = volume_render_rays(tm, to, td, **KW)
        topk_default = volume_render_rays(tm, to, td, color_topk=2, **KW)
        topk = volume_render_rays(tm, to, td, color_topk=2,
                                  detailed_output=False, **KW)
        bypass = volume_render_rays(tm, to, td, near_bypass=1.8,
                                    far_bypass=3.2, **KW)["d_final"]
    torch.testing.assert_close(topk_default["rgb"], full["rgb"], rtol=0,
                               atol=0)
    assert not torch.equal(topk["rgb"], full["rgb"])
    assert set(topk) == {"rgb", "depth_volume", "mask_volume"}
    assert float(bypass.min()) >= 1.8 - 1e-6
    assert float(bypass.max()) <= 3.2 + 1e-6
    got, want = _render_both(scene, color_topk=2, detailed_output=False,
                             near_bypass=1.8, far_bypass=3.2, **KW)
    for k in ("rgb", "depth_volume", "mask_volume"):
        assert _share(got[k], want[k]) >= 0.99, k


def test_batched_rays_and_random_color_direction(scene):
    """(B, N, 3) rays render as their flattening, reshaped; random colour
    directions are unit vectors with positive components (uniform draws),
    and they switch color_topk off."""
    _, _, tm, o, d = scene
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    with torch.no_grad():
        flat = volume_render_rays(tm, to, td, samples_output=True, **KW)
        batched = volume_render_rays(tm, to.reshape(2, -1, 3),
                                     td.reshape(2, -1, 3),
                                     samples_output=True, **KW)
        gen = torch.Generator().manual_seed(0)
        rnd = volume_render_rays(tm, to, td, samples_output=True,
                                 random_color_direction=True, color_topk=2,
                                 detailed_output=True, generator=gen, **KW)
    for k, v in flat.items():
        assert tuple(batched[k].shape) == (2, v.shape[0] // 2) + \
            tuple(v.shape[1:]), k
        torch.testing.assert_close(batched[k].reshape(v.shape), v)
    dirs = rnd["dirs"]
    assert tuple(dirs.shape) == tuple(flat["dirs"].shape)
    torch.testing.assert_close(torch.linalg.vector_norm(dirs, dim=-1),
                               torch.ones(dirs.shape[:-1]))
    assert float(dirs.min()) >= 0
    torch.testing.assert_close(rnd["d_final"], flat["d_final"])


@pytest.mark.parametrize("method", ["secant", "none"])
def test_root_finding_method_matches_jax(method):
    """method="secant" refines; any other method returns d_pred = 1 at the
    hits (the reference's behaviour), in both packages; surface_render
    takes keywords it does not use."""
    from neumesh_tpu.render.ray_casting import \
        root_finding_surface_points as jax_roots
    from neumesh_tpu_torch.render.ray_casting import (
        root_finding_surface_points, surface_render)
    o, d = block_rays(8, 16, half_fov=0.3)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    near = np.full(o.shape[0], 1.5, np.float32)
    far = np.full(o.shape[0], 3.5, np.float32)
    want = jax.jit(lambda o, d, n, f: jax_roots(
        lambda p: jnp.linalg.norm(p, axis=-1) - 0.5, o, d, n, f, N_steps=16,
        N_secant_steps=4, method=method, fill_inf=False))(
            jnp.asarray(o), jnp.asarray(d), jnp.asarray(near),
            jnp.asarray(far))
    got = root_finding_surface_points(
        lambda p: torch.linalg.vector_norm(p, dim=-1) - 0.5,
        torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(near),
        torch.from_numpy(far), N_steps=16, N_secant_steps=4, method=method,
        fill_inf=False)
    mask = got[2].numpy()
    assert 0.2 < mask.mean() < 1.0
    np.testing.assert_array_equal(mask, np.asarray(want[2]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-5, rtol=1e-5)
    if method != "secant":
        np.testing.assert_array_equal(got[0].numpy()[mask], 1.0)
    _, _, tm = small_scene(seed=12, subdivisions=2)
    tm.use_pallas = False
    rgb, _, _ = surface_render(tm, torch.from_numpy(o), torch.from_numpy(d),
                               ray_casting_cfgs={"N_steps": 16,
                                                 "method": method},
                               device="cpu", N_samples=64,
                               detailed_output=False)
    assert tuple(rgb.shape) == (o.shape[0], 3)
