"""The per-ray candidate path, port vs the JAX package: make_ray_context,
candidate_bounded_near_far, the differentiable context math (ds, density,
nabla, rgb; f32 and bf16, the tolerances of tests/test_rayctx.py), the
bound model's fused routes at one context a ray (the port's plain versions
against the Pallas kernels in interpret mode), the per-sample protocol on
the grid and brute-force kNN."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neumesh_tpu.models.neumesh.model import \
    candidate_bounded_near_far as jax_bounds
from neumesh_tpu.ops.rays import near_far_from_sphere as jax_near_far
from neumesh_tpu_torch.models.neumesh.model import candidate_bounded_near_far
from neumesh_tpu_torch.ops.rays import near_far_from_sphere
from test_torch_basics import block_rays, small_scene

# tests/test_rayctx.py: ds / density / rgb, nablas; bf16 against f32
TOL = {"value": dict(atol=8e-4, rtol=2e-3), "nabla": dict(atol=5e-3,
                                                          rtol=1e-2)}
BF16_ATOL = 2e-2


def _rays(H=16, W=16):
    o, d = block_rays(H, W, block=(8, min(16, W)))
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


def _bound_rays(jm, params, tm, o, d):
    """Both packages' rays with their candidate-bounded near/far and
    per-ray contexts: (jax ctx, torch ctx, near, far) as numpy bounds."""
    jn, jf = jax_near_far(jnp.asarray(o), jnp.asarray(d))
    pre = jm.make_ray_context(params, jnp.asarray(o), jnp.asarray(d), jn, jf,
                              n_probes=16, for_bounds=True)
    jn, jf = jax_bounds(pre, jnp.asarray(o), jnp.asarray(d), jn, jf)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    tn, tf = near_far_from_sphere(to, td)
    tpre = tm.make_ray_context(to, td, tn, tf, n_probes=16, for_bounds=True)
    tn, tf = candidate_bounded_near_far(tpre, to, td, tn, tf)
    return (jm.make_ray_context(params, jnp.asarray(o), jnp.asarray(d), jn,
                                jf),
            tm.make_ray_context(to, td, tn, tf), np.asarray(jn),
            np.asarray(jf), tn.numpy(), tf.numpy())


def _samples(o, d, near, far, S, seed=0):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 1, (o.shape[0], S)), -1).astype(np.float32)
    z = near + (far - near) * t
    return (o[:, None] + z[..., None] * d[:, None]).astype(np.float32)


def test_ray_context_and_bounds_match_jax():
    jm, params, tm = small_scene(seed=3)
    o, d = _rays()
    jctx, tctx, jn, jf, tn, tf = _bound_rays(jm, params, tm, o, d)
    np.testing.assert_allclose(tn, jn, atol=1e-6)
    np.testing.assert_allclose(tf, jf, atol=1e-6)
    assert tctx["ids"].shape[1] == 96
    np.testing.assert_array_equal(tctx["ids"].numpy(), np.asarray(jctx["ids"]))
    for k in ("pts", "pp", "ind", "vn", "feat"):
        np.testing.assert_allclose(tctx[k].numpy(), np.asarray(jctx[k]),
                                   atol=1e-6)
    pre_j = jm.make_ray_context(params, jnp.asarray(o), jnp.asarray(d),
                                jnp.asarray(jn), jnp.asarray(jf),
                                for_bounds=True)
    pre_t = tm.make_ray_context(torch.from_numpy(o), torch.from_numpy(d),
                                torch.from_numpy(tn), torch.from_numpy(tf),
                                for_bounds=True)
    np.testing.assert_allclose(pre_t["pts"].numpy(), np.asarray(pre_j["pts"]))


@pytest.mark.parametrize("dtype", [None, "bf16"])
def test_context_math_matches_jax(dtype):
    kw_j = {} if dtype is None else dict(compute_dtype=jnp.bfloat16)
    kw_t = {} if dtype is None else dict(compute_dtype=torch.bfloat16)
    jm, params, tm = small_scene(seed=4, jax_kw=kw_j, torch_kw=kw_t)
    o, d = _rays()
    jctx, tctx, jn, jf, _, _ = _bound_rays(jm, params, tm, o, d)
    xyz = _samples(o, d, jn, jf, 16)
    dirs = np.broadcast_to(d[:, None], xyz.shape).copy()
    tx = torch.from_numpy(xyz)
    ds_j, W_j, dh_j = jm._ctx_distance_parts(params, jctx, jnp.asarray(xyz),
                                             want_grad=True)
    ds_t, W_t, dh_t = tm._ctx_distance_parts(tctx, tx, want_grad=True)
    np.testing.assert_allclose(ds_t.numpy(), np.asarray(ds_j), **TOL["value"])
    np.testing.assert_allclose(W_t.numpy(), np.asarray(W_j), atol=1e-5)
    np.testing.assert_allclose(dh_t.numpy(), np.asarray(dh_j), **TOL["nabla"])
    dens_j, nab_j, demb_j, _, ft_j = jm._ctx_density_and_nabla(
        params, jctx, jnp.asarray(xyz), with_ft=True)
    dens_t, nab_t, demb_t, _, ft_t = tm._ctx_density_and_nabla(
        tctx, tx, with_ft=True)
    rgb_j = jm._color_from_interp(params, demb_j, jnp.asarray(dirs), ft_j,
                                  nab_j)
    rgb_t = tm._color_from_interp(demb_t, torch.from_numpy(dirs), ft_t, nab_t)
    # the colour from the context's features alone is the same colour
    np.testing.assert_array_equal(
        tm._ctx_color(tctx, demb_t, torch.from_numpy(dirs), W_t, nab_t)
        .float().numpy(), rgb_t.float().numpy())
    if dtype is None:
        np.testing.assert_allclose(dens_t.numpy(), np.asarray(dens_j),
                                   **TOL["value"])
        np.testing.assert_allclose(nab_t.numpy(), np.asarray(nab_j),
                                   **TOL["nabla"])
        np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j),
                                   **TOL["value"])
    else:
        for got, want in ((dens_t, dens_j), (rgb_t, rgb_j)):
            np.testing.assert_allclose(got.float().numpy(),
                                       np.asarray(want, np.float32),
                                       atol=BF16_ATOL)
        np.testing.assert_allclose(nab_t.float().numpy(),
                                   np.asarray(nab_j, np.float32),
                                   atol=BF16_ATOL, rtol=1e-2)


@pytest.mark.parametrize("route", ["context_math", "fused"])
def test_bound_model_routes_match_jax_at_one_context_a_ray(route):
    """RayBoundNeuMesh at B = R contexts, S = 16 samples, C = 96: the
    context math, or (use_pallas) the fused kernels' plain versions
    against the JAX Pallas kernels in interpret mode."""
    jm, params, tm = small_scene(seed=5)
    jm.use_pallas = tm.use_pallas = route == "fused"
    o, d = _rays(8, 8)
    jctx, _, jn, jf, tn, tf = _bound_rays(jm, params, tm, o, d)
    from neumesh_tpu.models.neumesh.model import RayBoundNeuMesh as JBound
    jb = JBound(jm, jctx, (o.shape[0],))
    tb = tm.bind_rays(torch.from_numpy(o), torch.from_numpy(d),
                      torch.from_numpy(tn), torch.from_numpy(tf))
    assert tb.ctx["geo"].shape == (64, 8, 96)
    xyz = _samples(o, d, jn, jf, 16, seed=1)
    dirs = np.broadcast_to(d[:, None], xyz.shape).copy()
    jx, tx = jnp.asarray(xyz), torch.from_numpy(xyz)
    tol = dict(atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tb.compute_distance(tx)[0].numpy(),
                               np.asarray(jb.compute_distance(params, jx)[0]),
                               **tol)
    np.testing.assert_allclose(
        tb.forward_density_only(tx).numpy(),
        np.asarray(jb.forward_density_only(params, jx)), **tol)
    sdf_t, nab_t = tb.forward_with_nablas(tx)
    sdf_j, nab_j = jb.forward_with_nablas(params, jx)
    np.testing.assert_allclose(sdf_t.numpy(), np.asarray(sdf_j), **tol)
    np.testing.assert_allclose(nab_t.numpy(), np.asarray(nab_j), atol=1e-3,
                               rtol=1e-3)
    sdf_t, rgb_t, _ = tb.forward_full(tx, torch.from_numpy(dirs))
    sdf_j, rgb_j, _ = jb.forward_full(params, jx, jnp.asarray(dirs))
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), **tol)
    # the up-sampling density takes forward_density_only's route on the CPU
    np.testing.assert_array_equal(tb.forward_density_only_nograd(tx).numpy(),
                                  tb.forward_density_only(tx).numpy())


@pytest.mark.parametrize("method", ["grid", "brute"])
def test_per_sample_protocol_matches_jax(method):
    """The unbound model: kNN through the grid (or brute force), the
    interpolated distance, density, nablas and colour."""
    from neumesh_tpu.ops.knn import knn_brute as jax_knn
    from neumesh_tpu_torch.ops.knn import knn_brute
    jm, params, tm = small_scene(seed=6)
    if method == "brute":
        jm.mesh_grid.grid = None
        tm.mesh_grid.grid = None
    o, d = _rays(8, 8)
    jn, jf = jax_near_far(jnp.asarray(o), jnp.asarray(d))
    xyz = _samples(o, d, np.asarray(jn), np.asarray(jf), 8, seed=2)
    dirs = np.broadcast_to(d[:, None], xyz.shape).copy()
    jx, tx = jnp.asarray(xyz), torch.from_numpy(xyz)
    ds_j, idx_j, w_j = jm.compute_distance(params, jx)
    ds_t, idx_t, w_t = tm.compute_distance(tx)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), atol=1e-6)
    np.testing.assert_allclose(ds_t.numpy(), np.asarray(ds_j), atol=1e-6)
    sdf_t, nab_t = tm.forward_with_nablas(tx)
    sdf_j, nab_j = jm.forward_with_nablas(params, jx)
    np.testing.assert_allclose(sdf_t.numpy(), np.asarray(sdf_j), **TOL["value"])
    np.testing.assert_allclose(nab_t.numpy(), np.asarray(nab_j), **TOL["nabla"])
    sdf_t, rgb_t = tm.forward(tx, torch.from_numpy(dirs))
    sdf_j, rgb_j = jm.forward(params, jx, jnp.asarray(dirs))
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), **TOL["value"])
    np.testing.assert_allclose(
        tm.forward_density_only(tx).numpy(),
        np.asarray(jm.forward_density_only(params, jx)), **TOL["value"])
    verts = tm.mesh_grid.vertices
    sq_t, i_t = knn_brute(tx.reshape(-1, 3), verts, 8, q_chunk=100)
    sq_j, i_j = jax_knn(jnp.asarray(xyz.reshape(-1, 3)),
                        jnp.asarray(verts.numpy()), 8, q_chunk=100)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(sq_t.numpy(), np.asarray(sq_j), atol=1e-6)


def test_untiled_volume_and_surface_renders_match_jax():
    """volume_render_rays and surface_render at ray_tile 0 (per-ray
    contexts after the closed-form bounds) with calc_normal, on the
    context math and on the fused route."""
    import jax
    from neumesh_tpu.render.ray_casting import surface_render as jax_surface
    from neumesh_tpu.render.volume import volume_render_rays as jax_volume
    from neumesh_tpu_torch.render.ray_casting import surface_render
    from neumesh_tpu_torch.render.volume import volume_render_rays
    jm, params, tm = small_scene(seed=7, jitter=2e-3)
    jm.use_pallas = tm.use_pallas = False
    o, d = _rays()
    jo, jd, to, td = jnp.asarray(o), jnp.asarray(d), torch.from_numpy(o), \
        torch.from_numpy(d)
    want = jax.jit(lambda p, o, d: jax_volume(
        jm, p, o, d, jax.random.PRNGKey(0), detailed_output=False,
        perturb=False, calc_normal=True, reuse_upsample_sdf=True))(
            params, jo, jd)
    with torch.no_grad():
        got = volume_render_rays(tm, to, td, calc_normal=True,
                                 reuse_upsample_sdf=True)
    for k in ("rgb", "depth_volume", "normals_volume"):
        # share within 1e-3, as tests/test_torch_volume.py holds the tiled
        # path (a near-tie in the kNN selection may flip a ray)
        err = np.abs(got[k].numpy() - np.asarray(want[k]))
        err = err.max(-1) if err.ndim > 1 else err
        assert (err <= 1e-3).mean() >= 0.99, (k, (err <= 1e-3).mean())
    cfgs = {"N_steps": 32, "N_secant_steps": 4, "fill_inf": False}
    want = jax.jit(lambda p, o, d: jax_surface(
        jm, p, o, d, ray_casting_cfgs=dict(cfgs), scan_mode="distance"))(
            params, jo, jd)
    got = surface_render(tm, to, td, ray_casting_cfgs=dict(cfgs),
                         scan_mode="distance", device="cpu")
    assert 0.2 < float(got[2]["mask_surface"].float().mean()) < 1.0
    assert (got[2]["mask_surface"].numpy()
            == np.asarray(want[2]["mask_surface"])).mean() >= 0.99
    for g, w in ((got[0], want[0]), (got[1], want[1]),
                 (got[2]["normals_surface"], want[2]["normals_surface"])):
        err = np.abs(g.numpy() - np.asarray(w))
        err = err.max(-1) if err.ndim > 1 else err
        assert (err <= 1e-4).mean() >= 0.99


def test_brute_mode_volume_render_matches_jax():
    """Without a candidate grid: near/far from the 256-probe distance scan
    (compute_bounded_near_far) and every query through the per-sample
    protocol on brute-force kNN."""
    import jax
    from neumesh_tpu.render.volume import volume_render_rays as jax_volume
    from neumesh_tpu_torch.render.volume import volume_render_rays
    jm, params, tm = small_scene(seed=8, jitter=2e-3, subdivisions=2)
    jm.mesh_grid.grid = tm.mesh_grid.grid = None
    o, d = _rays(8, 8)
    kw = dict(N_samples=16, N_importance=16, N_upsample_iters=2)
    want = jax.jit(lambda p, o, d: jax_volume(
        jm, p, o, d, jax.random.PRNGKey(0), detailed_output=False,
        perturb=False, **kw))(params, jnp.asarray(o), jnp.asarray(d))
    with torch.no_grad():
        got = volume_render_rays(tm, torch.from_numpy(o), torch.from_numpy(d),
                                 **kw)
    for k in ("rgb", "depth_volume"):
        err = np.abs(got[k].numpy() - np.asarray(want[k]))
        err = err.max(-1) if err.ndim > 1 else err
        assert (err <= 1e-3).mean() >= 0.98, (k, (err <= 1e-3).mean())


def test_context_math_dh_beside_a_vertex():
    """Samples 2e-4 from a vertex: the closed-form dh of the context math
    against autograd of the same interpolated distance in float64 from
    the differences x - v, at the context math's own kNN weights (the
    expanded d2 = |x|^2 + |v|^2 - 2 x.v cancels to about 0 there)."""
    from neumesh_tpu_torch.dataio.synthetic import icosphere_mesh
    from neumesh_tpu_torch.mesh.grid import MeshGrid
    from neumesh_tpu_torch.models.neumesh.model import NeuMesh
    from test_torch_basics import SMALL

    tm = NeuMesh(MeshGrid(icosphere_mesh(0.5, 3), device="cpu"),
                 device="cpu", **SMALL).init(0)
    v = tm.mesh_grid.vertices
    n = tm.indicator_vector.detach()
    gen = torch.Generator().manual_seed(0)
    at = torch.randperm(v.shape[0], generator=gen)[:64]
    t = torch.randn(64, 3, generator=gen)
    x = (v[at] + 2e-4 * t / torch.linalg.vector_norm(t, dim=-1,
                                                     keepdim=True))
    C = v.shape[0]
    ctx = {"pts": v.expand(64, C, 3), "pp": torch.sum(v * v, -1).expand(
        64, C), "ind": n.expand(64, C, 3), "vn": torch.sum(v * n, -1).expand(
        64, C)}
    with torch.no_grad():
        _, W, dh = tm._ctx_distance_parts(ctx, x[:, None, :], want_grad=True)
    w1 = float(tm.forward_indicator_weight())
    x64 = x.double().requires_grad_(True)
    diff = x64[:, None, :] - v.double()[None]
    d = torch.linalg.vector_norm(diff, dim=-1)
    term = w1 * torch.sum(diff * n.double()[None], -1) + d ** 3
    ds = torch.sum(W[:, 0].double() * term / (w1 + d), -1)
    want, = torch.autograd.grad(ds.sum(), x64)
    assert torch.isfinite(dh).all()
    np.testing.assert_allclose(dh[:, 0].double().numpy(), want.numpy(),
                               atol=1e-3, rtol=1e-3)


def test_context_math_picks_exactly_k_at_a_rank_tie():
    """The index perturbation of the kNN ranks can make two candidates'
    ranks equal: a sample at the origin, candidate 0 at 0.30000028 and
    candidate 8 at 0.30000004 (d2 (1 + 8 * 2e-7) rounds to candidate 0's
    d2), candidates 1-7 nearer: exactly K = 8 picks, the tie to the lower
    index."""
    from neumesh_tpu_torch.dataio.synthetic import icosphere_mesh
    from neumesh_tpu_torch.mesh.grid import MeshGrid
    from neumesh_tpu_torch.models.neumesh.model import NeuMesh
    from test_torch_basics import SMALL

    tm = NeuMesh(MeshGrid(icosphere_mesh(0.5, 1), device="cpu"),
                 device="cpu", **SMALL).init(0)
    r = [0.30000028] + [0.1 + 0.01 * i for i in range(1, 8)] \
        + [0.30000004, 0.6, 0.6, 0.6]
    pts = torch.zeros(1, len(r), 3)
    pts[0, :, 0] = torch.tensor(r)
    ind = torch.zeros_like(pts)
    ind[..., 2] = 1.0
    ctx = {"pts": pts, "pp": torch.sum(pts * pts, -1), "ind": ind,
           "vn": torch.sum(pts * ind, -1)}
    d2 = ctx["pp"][0]
    assert float(d2[0]) == float(d2[8] * (1.0 + torch.tensor(8.0) * 2e-7))
    _, W = tm._ctx_distance_parts(ctx, torch.zeros(1, 1, 3))
    picked = (W[0, 0] > 0).nonzero()[:, 0].tolist()
    assert picked == list(range(8))
