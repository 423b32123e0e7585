"""The editing slice's host pieces, port vs the JAX package on the same
numpy inputs: geometry helpers, Umeyama / ICP / the transform estimate,
the uv normalisation, the swap and fill transition weights (both
packages' native KD-trees), rodrigues and deform_model's indicators,
ARAP against the native library, the ray cast against the native BVH and
the numpy caster, the paint dataset, the gradient mask and the PLY
previews."""
import numpy as np
import pytest
import torch

from neumesh_tpu.cpp import native
from neumesh_tpu.dataio.synthetic import icosphere_mesh as jax_icosphere
from neumesh_tpu_torch.dataio.synthetic import icosphere_mesh
from test_torch_basics import small_scene


def _rotation(rng):
    R, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(R) < 0:
        R[:, 0] *= -1
    return R


def _jittered_icosphere(seed=0, sub=3, jitter=2e-3):
    jm, tm = jax_icosphere(0.5, sub), icosphere_mesh(0.5, sub)
    noise = np.random.default_rng(seed).normal(
        size=jm.vertices.shape) * jitter
    for m in (jm, tm):
        m.vertices = m.vertices + noise
        m.compute_vertex_normals()
    return jm, tm


def test_geo_helpers_match_jax(rng):
    from neumesh_tpu.ops import geo as jgeo
    from neumesh_tpu_torch.ops import geo
    p, a, b, c = (rng.normal(size=(5, 7, 3)) for _ in range(4))
    want = jgeo.barycentric_coordinates(p, a, b, c)
    got = geo.barycentric_coordinates(*(torch.from_numpy(x)
                                        for x in (p, a, b, c)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    R, t = _rotation(rng) * 1.3, rng.normal(size=3)
    v = rng.normal(size=(11, 3))
    np.testing.assert_allclose(
        geo.transform_vertices(R, t, torch.from_numpy(v)).numpy(),
        jgeo.transform_vertices(R, t, v), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        geo.transform_direction(R, torch.from_numpy(v)).numpy(),
        jgeo.transform_direction(R, v), rtol=1e-12, atol=1e-12)


def test_alignment_matches_jax(rng):
    """Umeyama, ICP from a perturbed start and the corr estimate: the same
    transforms to 1e-9 (float64 throughout)."""
    from neumesh_tpu.editing import align as jalign
    from neumesh_tpu_torch.editing import align
    src = rng.normal(size=(300, 3))
    R, s, t = _rotation(rng), 1.3, np.array([0.1, -0.2, 0.3])
    dst = s * src @ R.T + t + rng.normal(size=src.shape) * 1e-3
    np.testing.assert_allclose(align.umeyama(src, dst),
                               jalign.umeyama(src, dst), atol=1e-12)
    np.testing.assert_allclose(align.umeyama(src, dst, False),
                               jalign.umeyama(src, dst, False), atol=1e-12)
    T0 = jalign.umeyama(src[:5], dst[:5])
    T0[:3, 3] += 0.02
    np.testing.assert_allclose(
        align.icp_point_to_point(src, dst, 0.2, init=T0),
        jalign.icp_point_to_point(src, dst, 0.2, init=T0), atol=1e-9)
    corr = np.stack([np.arange(8), np.arange(8)], 1)
    for refine in (False, True):
        np.testing.assert_allclose(
            align.estimate_transform_from_corr(src, dst, corr, 0.1, refine),
            jalign.estimate_transform_from_corr(src, dst, corr, 0.1, refine),
            atol=1e-9)


def test_uv_normalisation_and_clamp_match_jax(rng):
    from neumesh_tpu.editing.editable import EditingParams as JParams
    from neumesh_tpu_torch.editing.editable import EditingParams
    uv = rng.uniform(-0.2, 1.3, size=(40, 2)) * [1.0, 0.6]
    mask = rng.random(60) > 0.5
    ids = rng.choice(60, 40, replace=False)
    for keep_wh in (True, False):
        j = JParams(mask.copy(), uv.copy(), ids.copy())
        p = EditingParams(mask.copy(), uv.copy(), ids.copy())
        j.clamp_and_normalize_params(keep_wh=keep_wh)
        p.clamp_and_normalize_params(keep_wh=keep_wh)
        np.testing.assert_array_equal(p.get_uv(), j.get_uv())
        np.testing.assert_array_equal(p.get_editing_mask(),
                                      j.get_editing_mask())
        np.testing.assert_array_equal(p.get_vertex_ind_of_uv(),
                                      j.get_vertex_ind_of_uv())
        np.testing.assert_array_equal(p.get_size_of_uv(), j.get_size_of_uv())


def test_swap_transition_weights_match_jax(rng):
    """Kc = 4 inverse-distance weights and reference ids of the masked
    main vertices under a similarity transform (float32 weights)."""
    from neumesh_tpu.editing.editable import EditingParams as JParams
    from neumesh_tpu.editing.swap import TextureSwappingRender as JSwap
    from neumesh_tpu_torch.editing.editable import EditingParams
    from neumesh_tpu_torch.editing.swap import TextureSwappingRender
    mv = rng.normal(size=(400, 3))
    rv = rng.normal(size=(350, 3))
    mm, rm = rng.random(400) > 0.4, rng.random(350) > 0.3
    T = np.eye(4)
    T[:3, :3] = _rotation(rng) * 0.9
    T[:3, 3] = [0.1, 0.0, -0.2]
    assert native.available()
    want = JSwap.compute_transition_weights(mv, JParams(mm), rv, JParams(rm),
                                            T, 4)
    got = TextureSwappingRender.compute_transition_weights(
        mv, EditingParams(mm), rv, EditingParams(rm), T, 4)
    assert got[0].dtype == np.float32
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("steps", [1, 2, 3])
def test_fill_transition_weights_match_jax(steps):
    """The uv tiling, with its int32 truncation of the tile coordinate,
    and the Kc-NN in uv space."""
    from neumesh_tpu.editing.editable import EditingParams as JParams
    from neumesh_tpu.editing.fill import TextureFillingRender as JFill
    from neumesh_tpu_torch.editing.editable import EditingParams
    from neumesh_tpu_torch.editing.fill import TextureFillingRender
    rng = np.random.default_rng(steps)
    main_uv = rng.uniform(0, 1, size=(200, 2)) * [1.0, 0.7]
    ref_uv = rng.uniform(0, 1, size=(120, 2)) * [0.5, 1.0]
    mi, ri = rng.permutation(300)[:200], rng.permutation(200)[:120]
    out = []
    for P in (JParams, EditingParams):
        mp = P(np.ones(300, bool), main_uv.copy(), mi.copy())
        rp = P(np.ones(200, bool), ref_uv.copy(), ri.copy())
        mp.clamp_and_normalize_params()
        rp.clamp_and_normalize_params()
        fn = (JFill if P is JParams
              else TextureFillingRender).compute_transition_weights
        out.append(fn(mp, rp, steps, 4))
    want, got = out
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


def test_exact_nn_asserts_misalignment():
    from neumesh_tpu_torch.editing.fill import _exact_nn
    v = np.random.default_rng(0).normal(size=(30, 3))
    np.testing.assert_array_equal(_exact_nn(v, v[::-1]), np.arange(30)[::-1])
    with pytest.raises(AssertionError, match="Misalignment"):
        _exact_nn(v, v + 1e-5)


def test_rodrigues_matches_jax(rng):
    from neumesh_tpu.editing.geometry import rodrigues as jrod
    from neumesh_tpu_torch.editing.geometry import rodrigues
    aa = rng.normal(size=(50, 3))
    aa[:3] = 0.0
    aa[3] = [np.pi, 0, 0]
    R = rodrigues(aa)
    np.testing.assert_allclose(R, jrod(aa), atol=1e-15)
    np.testing.assert_allclose(R[:3], np.broadcast_to(np.eye(3), (3, 3, 3)))
    np.testing.assert_allclose(np.einsum("nij,nkj->nik", R, R),
                               np.broadcast_to(np.eye(3), R.shape),
                               atol=1e-12)


def test_deform_model_matches_jax():
    """The wave-deformed scaffold: the port's new MeshGrid (on the model's
    device) and indicator vectors equal the JAX package's, with one vertex
    pushed through the centre (its normal turned through a wide angle)."""
    from neumesh_tpu.editing.geometry import deform_model as jdeform
    from neumesh_tpu.mesh.triangle_mesh import TriangleMesh as JMesh
    from neumesh_tpu_torch.editing.geometry import deform_model
    from neumesh_tpu_torch.mesh.triangle_mesh import TriangleMesh
    from neumesh_tpu_torch.tools.make_example_scene import deformed_mesh
    jm, params, tm = small_scene(seed=2, subdivisions=3, jitter=1e-3)
    wave = deformed_mesh(tm.mesh_grid.mesh, amp=0.08, freq=6.0)
    v = wave.vertices.copy()
    flip = 7
    t_new = wave.triangles.copy()
    v[flip] = -0.3 * v[flip]
    params2 = jdeform(JMesh(v.copy(), t_new.copy()), jm, params)
    deform_model(TriangleMesh(v.copy(), t_new.copy()), tm)
    assert tm.mesh_grid.device.type == "cpu" and tm.mesh_grid.grid is not None
    np.testing.assert_allclose(tm.mesh_grid.vertices.numpy(),
                               np.asarray(jm.mesh_grid.vertices))
    np.testing.assert_allclose(tm.mesh_grid.vertex_normals.numpy(),
                               np.asarray(jm.mesh_grid.vertex_normals))
    got = tm.indicator_vector.detach().numpy()
    want = np.asarray(params2["indicator_vector"])
    np.testing.assert_allclose(got, want, atol=1e-6)
    moved = np.abs(got - np.asarray(params["indicator_vector"])).max(-1)
    assert (moved > 1e-3).mean() > 0.5


def test_arap_matches_native():
    """The port's ARAP against the JAX package's native library: handles
    pulled, a band pinned, 20 rounds of CG-solved global steps; the
    default (the port's copy of the library) to 1e-12, the numpy backend
    to 1e-8."""
    from neumesh_tpu_torch.mesh.arap import arap
    assert native.available()
    jmesh, _ = _jittered_icosphere(seed=4)
    v, t = jmesh.vertices, jmesh.triangles
    pinned = np.where(v[:, 2] < 0.0)[0]
    handles = np.where(v[:, 2] > 0.45)[0]
    cids = np.concatenate([pinned, handles])
    cpos = np.concatenate([v[pinned], v[handles] + [0.06, -0.02, 0.1]])
    want = native.arap(v, t, cids, cpos, max_iter=20)
    got = arap(v, t, cids, cpos, max_iter=20)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    got_np = arap(v, t, cids, cpos, max_iter=20, backend="numpy")
    np.testing.assert_allclose(got_np, want, atol=1e-8)
    for g in (got, got_np):
        np.testing.assert_array_equal(g[cids], cpos)
        assert np.abs(g - v).max() > 0.05
    for backend in ("native", "numpy"):
        with pytest.raises(ValueError):
            arap(v, t, np.array([len(v)]), np.zeros((1, 3)),
                 backend=backend)


def _marching_sphere(method, n=16):
    from neumesh_tpu_torch.mesh.marching_cubes import extract_isosurface
    g = np.linspace(-1.0, 1.0, n)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    f = (np.sqrt(X * X + Y * Y + Z * Z) - 0.7).astype(np.float32)
    m = extract_isosurface(f, 0.0, origin=(-1.0, -1.0, -1.0),
                           spacing=(2.0 / (n - 1),) * 3, method=method)
    return m.vertices.astype(np.float64), m.triangles


@pytest.mark.parametrize("method,rounds,atol", [("mc", 20, 1e-8),
                                                ("mt", 1, 1e-8),
                                                ("mt", 20, 0.05)])
def test_arap_numpy_matches_native_on_marching_meshes(method, rounds, atol):
    """The numpy ARAP against the native library on a 16^3 marching
    sphere (the port's own extraction; a band pinned, a cap pulled). The
    rotation fit follows the library's step by step, so the marching
    cubes mesh agrees to 1e-8 over 20 rounds. The tetrahedra mesh has
    planar one-rings, whose covariance has a zero column: both fits take
    that singular direction from roundoff (an eigenvalue ~1e-21 under the
    1e-18 floor) and disagree there by up to ~0.08, so the two backends
    agree to 1e-8 after one round and to 0.032 after 20 (measured on the
    CPU; 0.05 held)."""
    from neumesh_tpu_torch.mesh.arap import arap
    v, t = _marching_sphere(method)
    pinned = np.where(v[:, 2] < -0.2)[0]
    handles = np.where(v[:, 2] > 0.55)[0]
    cids = np.concatenate([pinned, handles])
    cpos = np.concatenate([v[pinned], v[handles] + [0.06, -0.02, 0.1]])
    want = native.arap(v, t, cids, cpos, max_iter=rounds)
    got = arap(v, t, cids, cpos, max_iter=rounds, backend="numpy")
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    np.testing.assert_array_equal(got[cids], cpos)
    assert np.abs(want - v).max() > 0.05


def test_arap_fit_follows_the_native_fit_at_full_rank():
    """The numpy rotation fit of full-rank covariances: proper rotations
    equal to the polar factor of the SVD (the library's eigen route and
    numpy's SVD agree away from rank loss)."""
    from neumesh_tpu_torch.mesh.arap import fit_rotations
    S = np.random.default_rng(3).normal(size=(500, 3, 3))
    R = fit_rotations(S)
    U, _, Vt = np.linalg.svd(S)
    d = np.sign(np.linalg.det(U @ Vt))
    U[:, :, 2] *= d[:, None]
    np.testing.assert_allclose(R, U @ Vt, atol=1e-9)
    np.testing.assert_allclose(R @ R.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), R.shape),
                               atol=1e-9)


def test_ray_cast_matches_native_and_numpy(rng):
    """MeshGrid's cast (the port's BVH by default) and the torch caster
    (float64, backend="device") against the JAX package's native BVH and
    numpy caster: the same primitive ids, misses included, and t to
    1e-12."""
    from neumesh_tpu.mesh.raycast import _cast_rays_numpy
    from neumesh_tpu_torch.mesh.grid import MeshGrid
    jmesh, tmesh = _jittered_icosphere(seed=5)
    o = rng.normal(size=(300, 3))
    o = 2.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o + rng.normal(size=o.shape) * 0.3
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_nat, p_nat = native.BVH(jmesh.vertices, jmesh.triangles).cast(o, d)
    t_np, p_np = _cast_rays_numpy(jmesh, o, d)
    mg = MeshGrid(tmesh, device="cpu", distance_method="brute")
    t_got, p_got = mg.cast_ray(o, d)
    np.testing.assert_array_equal(t_got, t_nat)
    from neumesh_tpu_torch.mesh.raycast import cast_rays
    t_dev, p_dev = cast_rays(tmesh, o, d, backend="device", device="cpu")
    assert 0.3 < np.isfinite(t_got).mean() < 1.0
    for t_g, p_g in ((t_got, p_got), (t_dev, p_dev)):
        for t_w, p_w in ((t_nat, p_nat), (t_np, p_np)):
            np.testing.assert_array_equal(p_g, p_w)
            hit = np.isfinite(t_w)
            np.testing.assert_array_equal(np.isfinite(t_g), hit)
            np.testing.assert_allclose(t_g[hit], t_w[hit], rtol=1e-12)
    # small chunks: the same answer
    t2, p2 = cast_rays(tmesh, o, d, backend="device", device="cpu",
                       pairs_per_chunk=5000)
    np.testing.assert_array_equal(p2, p_dev)
    with pytest.raises(ValueError, match="backend"):
        cast_rays(tmesh, o, d, backend="numpy")


def test_paint_dataset_matches_jax(tmp_path):
    """The paint/background split, the rays of every pixel and the epoch
    batches from an explicit generator."""
    from neumesh_tpu.dataio.dtu import SceneDataset as JScene
    from neumesh_tpu.dataio.paint import PaintDataset as JPaint
    from neumesh_tpu_torch.config import ConfigDict
    from neumesh_tpu_torch.dataio import get_data
    from neumesh_tpu_torch.dataio.synthetic import generate_sphere_scene
    from neumesh_tpu_torch.tools.make_example_scene import paint_dataset
    generate_sphere_scene(str(tmp_path / "data"), n_views=3, H=12, W=16)
    paint_dataset(str(tmp_path / "data"), str(tmp_path / "paint"))
    want = JPaint(JScene(train_cameras=False, data_dir=str(tmp_path /
                                                           "paint")))
    got = get_data(ConfigDict({"data": {
        "data_dir": str(tmp_path / "paint"), "downscale": 1,
        "paint_dataset": True}}))
    assert got.num_paint == want.num_paint > 0
    assert got.num_bg == want.num_bg > 0 and len(got) == len(want)
    for k in ("rays_o_paint", "rays_d_paint", "rgb_paint", "rays_o_bg",
              "rays_d_bg", "rgb_bg"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    for a, b in zip(got.epoch_batches(5, np.random.default_rng(3)),
                    want.epoch_batches(5, np.random.default_rng(3))):
        np.testing.assert_array_equal(a[0], b[0])
        for i in (1, 2):
            for k in b[i]:
                np.testing.assert_array_equal(a[i][k], b[i][k])


def test_grad_mask_and_ray_cast_vertices():
    """make_grad_mask keeps only the painted rows of color_features; the
    paint rays at the north pole touch only vertices near it."""
    from neumesh_tpu_torch.editing.paint_train import (
        get_optimized_features, make_grad_mask)
    _, _, tm = small_scene(seed=0, subdivisions=3)
    idx = np.array([3, 7, 11])
    mask = make_grad_mask(tm, idx)
    assert set(mask) == {n for n, _ in tm.named_parameters()}
    for name, p in tm.named_parameters():
        g = torch.ones_like(p) * mask[name]
        if name == "color_features":
            assert (g[idx] == 1).all() and g.sum() == 3 * g.shape[1]
        else:
            assert (g == 0).all(), name
    n = 32
    rng = np.random.default_rng(0)
    o = np.tile([[0.0, 0.0, 2.0]], (n, 1)) + rng.normal(size=(n, 3)) * 0.01
    d = np.tile([[0.0, 0.0, -1.0]], (n, 1))
    ids = get_optimized_features(tm.mesh_grid, o, d, batch_size=10)
    assert len(ids) > 0
    assert tm.mesh_grid.vertices.numpy()[ids][:, 2].min() > 0.4


def test_vis_mesh_exports(tmp_path):
    from neumesh_tpu_torch.mesh.triangle_mesh import load_ply
    from neumesh_tpu_torch.utils.vis_mesh import (preview_transfer_on_mesh,
                                                  vis_and_painting)
    mesh = icosphere_mesh(0.5, 1)
    mask = np.zeros(mesh.n_vertices, bool)
    mask[:10] = True
    m = load_ply(vis_and_painting(mesh, mask, str(tmp_path / "mask.ply")))
    assert (m.vertex_colors[:10, 0] > 0.9).all()
    ref_idx = np.random.default_rng(0).integers(0, mesh.n_vertices, (10, 4))
    p1, p2 = preview_transfer_on_mesh(
        mesh, mesh, ref_idx, np.full((10, 4), 0.25), np.arange(10),
        out_prefix=str(tmp_path / "transfer"))
    assert load_ply(p1).vertex_colors is not None
    assert load_ply(p2).vertex_colors is not None
