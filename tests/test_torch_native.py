"""The port's host-geometry library (neumesh_tpu_torch.cpp, its own copy of
neumesh_tpu/cpp) against the JAX package's, and the port's defaults
against the JAX package's defaults with nothing patched: both packages
take their C++ library wherever g++ exists, as it does here."""
import os
import subprocess
import sys

import numpy as np
import pytest

from neumesh_tpu.cpp import native as jnative
from neumesh_tpu.dataio.synthetic import icosphere_mesh as jax_icosphere
from neumesh_tpu.ops.knn import build_candidate_grid as jax_build
from neumesh_tpu_torch.cpp import native
from neumesh_tpu_torch.ops.knn import build_candidate_grid


def test_default_candidate_grid_equals_jax_default():
    """On the unjittered icosphere (exact distance ties everywhere) the
    port's default build equals the JAX package's: cell_row and cand_idx,
    candidate order within a row included (the kernels break kNN ties by
    slot)."""
    pts = jax_icosphere(0.5, 4).vertices
    g_t = build_candidate_grid(pts, use_cache=False)
    g_j = jax_build(pts, use_cache=False)
    assert g_t.dims == tuple(g_j.dims)
    np.testing.assert_array_equal(g_t.cell_row.numpy(),
                                  np.asarray(g_j.cell_row))
    np.testing.assert_array_equal(g_t.cand_idx.numpy(),
                                  np.asarray(g_j.cand_idx))
    np.testing.assert_array_equal(g_t.cand_pts, g_j.cand_pts)


def _blob(seed, n=28):
    """min of seeded spheres plus noise: ambiguous faces, many
    components."""
    rng = np.random.default_rng(seed)
    xs = np.linspace(-1, 1, n)
    X, Y, Z = np.meshgrid(xs, xs, xs, indexing="ij")
    f = np.full(X.shape, 0.4)
    for _ in range(5):
        c = rng.uniform(-0.5, 0.5, 3)
        f = np.minimum(f, np.sqrt((X - c[0])**2 + (Y - c[1])**2
                                  + (Z - c[2])**2) - rng.uniform(0.15, 0.45))
    return (f + 0.02 * rng.normal(size=f.shape)).astype(np.float32)


@pytest.mark.parametrize("fn", ["marching_tetrahedra", "marching_cubes"])
@pytest.mark.parametrize("seed", [0, 1])
def test_marching_arrays_equal_jax_native(fn, seed):
    field = _blob(seed)
    for iso in (0.0, 0.05):
        got = getattr(native, fn)(field, iso)
        want = getattr(jnative, fn)(field, iso)
        assert len(got[1]) > 100
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    empty = getattr(native, fn)(np.ones((6, 6, 6), np.float32), 0.0)
    assert empty[0].shape == (0, 3) and empty[1].shape == (0, 3)


@pytest.mark.parametrize("k", [1, 6, 20])
def test_kdtree_equals_jax_on_exact_ties(k):
    """A lattice queried at lattice points, cell centres and face centres:
    every query has many neighbours at exactly equal distances, so the
    indices pin down the traversal order, not only the distances."""
    g = np.arange(7, dtype=np.float64)
    pts = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    rng = np.random.default_rng(2)
    q = np.concatenate([pts[::5], pts[::7] + 0.5,
                        pts[::3] + [0.5, 0.5, 0.0],
                        rng.uniform(-1, 7, (200, 3))])
    got = native.KDTree(pts).query(q, k=k)
    want = jnative.KDTree(pts).query(q, k=k)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].dtype == np.int64 and got[1].shape == (len(q), k)
    # ties are real: some query has its k-th and (k+1)-th neighbours equal
    d = native.KDTree(pts).query(q, k=k + 1)[0]
    assert (d[:, k - 1] == d[:, k]).any()
    # fewer points than k: inf / -1 past the end
    d, i = native.KDTree(pts[:3]).query(q[:4], k=5)
    assert np.isinf(d[:, 3:]).all() and (i[:, 3:] == -1).all()


def test_many_queries_threaded_equal_jax():
    """Above 4,096 queries the tree answers on every hardware thread."""
    rng = np.random.default_rng(3)
    pts = np.round(rng.uniform(-1, 1, (5000, 3)), 2)
    q = np.round(rng.uniform(-1, 1, (9000, 3)), 2)
    got = native.KDTree(pts).query(q, k=8)
    want = jnative.KDTree(pts).query(q, k=8)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])


def test_bvh_equals_jax():
    """Rays from a sphere around an icosphere towards it, through its
    vertices (edge and corner hits) and away from it."""
    mesh = jax_icosphere(0.5, 3)
    rng = np.random.default_rng(4)
    o = rng.normal(size=(6000, 3))
    o = 1.5 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o + 0.4 * rng.normal(size=o.shape)
    d[:500] = mesh.vertices[:500] - o[:500]
    d[-500:] = o[-500:]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    got = native.BVH(mesh.vertices, mesh.triangles).cast(o, d)
    want = jnative.BVH(mesh.vertices, mesh.triangles).cast(o, d)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    hit = np.isfinite(got[0])
    assert 0.3 < hit.mean() < 0.95
    assert (got[1][~hit] == -1).all()


def test_arap_equals_jax():
    mesh = jax_icosphere(0.5, 3)
    v, t = mesh.vertices, mesh.triangles
    pinned = np.where(v[:, 1] < -0.1)[0]
    handles = np.where(v[:, 1] > 0.4)[0]
    cids = np.concatenate([pinned, handles, handles[:3]])
    cpos = np.concatenate([v[pinned], v[handles] + [0.05, 0.1, -0.03],
                           v[handles[:3]] + 0.2])
    got = native.arap(v, t, cids, cpos, max_iter=12)
    want = jnative.arap(v, t, cids, cpos, max_iter=12)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(got[handles[:3]], cpos[-3:])
    with pytest.raises(ValueError):
        native.arap(v, t, np.array([len(v)]), np.zeros((1, 3)))
    with pytest.raises(ValueError):
        native.arap(v, t, cids, cpos[:-1])


def test_scipy_backend_and_the_cache_key(tmp_path, monkeypatch):
    """backend="scipy" stays an explicit choice: the same cell_row and the
    same candidate sets (ties aside); the `.npz` cache is keyed by the
    backend, so a scipy table is never served to a native build."""
    monkeypatch.setenv("NEUMESH_TORCH_GRID_CACHE", str(tmp_path))
    pts = jax_icosphere(0.5, 5).vertices            # 10,242 > 5,000: cached
    g_n = build_candidate_grid(pts)
    g_s = build_candidate_grid(pts, backend="scipy")
    assert len(list(tmp_path.iterdir())) == 2
    np.testing.assert_array_equal(g_n.cell_row.numpy(), g_s.cell_row.numpy())
    p = np.asarray(pts, np.float32).astype(np.float64)
    centre = p[g_n.cand_idx.numpy()[:, 0]]
    d_n = np.linalg.norm(p[g_n.cand_idx.numpy()] - centre[:, None], axis=-1)
    d_s = np.linalg.norm(p[g_s.cand_idx.numpy()] - centre[:, None], axis=-1)
    assert np.abs(np.sort(d_n, -1) - np.sort(d_s, -1)).max() < 0.05
    assert (g_n.cand_idx.numpy() != g_s.cand_idx.numpy()).any()
    # served from the cache, each its own
    again = build_candidate_grid(pts)
    np.testing.assert_array_equal(again.cand_idx.numpy(),
                                  g_n.cand_idx.numpy())
    with pytest.raises(ValueError, match="backend"):
        build_candidate_grid(pts[:100], backend="brute")


def test_a_failed_build_raises(tmp_path, monkeypatch):
    """No silent fallback: a missing compiler, a missing source or a
    source that does not compile raises, with the compiler's output."""
    from neumesh_tpu_torch.ops import _build
    bad = tmp_path / "bad.cpp"
    bad.write_text("int f( { return 0; }\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        _build.build_host(str(bad), str(tmp_path / "b"))
    assert "error" in str(err.value)
    with pytest.raises(RuntimeError, match="not found"):
        _build.build_host(str(tmp_path / "none.cpp"), str(tmp_path / "b"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        _build.build_host(_build.HOST_SRC, str(tmp_path / "b"))
    # and through the wrappers: an unloaded library builds, and raises
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "b"))
    monkeypatch.setattr(_build.build_host, "__defaults__",
                        (_build.HOST_SRC, str(tmp_path / "b")))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.KDTree(np.zeros((4, 3)))
    assert not (tmp_path / "b").exists() or not any(
        (tmp_path / "b").iterdir())


def test_extract_cli_writes_the_jax_default_ply(tmp_path):
    """The port's extraction CLI and the repository's extract_mesh.py on
    one NeuS checkpoint, each on its defaults with nothing patched: the
    same triangles (so the same vertex order), vertices to the grid
    SDF's f32 agreement, colours within one 8-bit level."""
    import jax

    from neumesh_tpu.utils.checkpoints import CheckpointIO as JCheckpointIO
    from neumesh_tpu_torch.cli import extract_mesh as textract
    from neumesh_tpu_torch.config import load_yaml, save_yaml
    from neumesh_tpu_torch.mesh.triangle_mesh import load_ply
    from test_torch_extract_mesh import RANGE, _neus_config, models
    jm, jp, tm = models("neus")
    cfg = _neus_config(tmp_path)
    c = load_yaml(cfg)
    c["data"]["batch_size"] = 1          # the JAX builder reads it
    save_yaml(c, cfg)
    ckpt = JCheckpointIO(str(tmp_path / "jax")).save(
        "latest.ckpt", model=jax.tree.map(np.asarray, jp), global_step=1)
    th = float(np.median(textract.evaluate_grid_sdf(tm, 14, RANGE, RANGE,
                                                    RANGE)))
    flags = ["--config", cfg, "--ckpt_path", ckpt, "--N_grid", "14",
             "--sdf_th", repr(th), "--x_range", "-0.8", "0.8",
             "--y_range", "-0.8", "0.8", "--z_range", "-0.8", "0.8"]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for method in ("mt", "mc"):
        out_t = str(tmp_path / f"t{method}")
        out_j = str(tmp_path / f"j{method}")
        textract.main(flags + ["--method", method, "--output_dir", out_t,
                               "--device", "cpu"])
        env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_PLATFORM_NAME="cpu")
        subprocess.run([sys.executable, os.path.join(repo, "extract_mesh.py"),
                        *flags, "--method", method, "--output_dir", out_j],
                       check=True, cwd=repo, env=env, timeout=300)
        a = load_ply(os.path.join(out_t, "extracted_0.ply"))
        b = load_ply(os.path.join(out_j, "extracted_0.ply"))
        assert a.n_triangles > 50
        np.testing.assert_array_equal(a.triangles, b.triangles)
        np.testing.assert_allclose(a.vertices, b.vertices, atol=1e-5)
        assert np.abs(a.vertex_colors - b.vertex_colors).max() \
            <= 1 / 255 + 1e-9


def test_swap_with_arap_equals_jax(tmp_path):
    """Texture swapping with use_arap on the port's example scene, the
    port's TextureSwappingRender against the JAX package's on the same
    files, each on its defaults: T_r_m, the ARAP-deformed reference mesh
    (1e-12) and the transferred codes."""
    import json

    from neumesh_tpu.config import ConfigDict as JConfig
    from neumesh_tpu.editing.swap import TextureSwappingRender as JSwap
    from neumesh_tpu_torch.config import ConfigDict
    from neumesh_tpu_torch.editing.swap import TextureSwappingRender
    from neumesh_tpu_torch.tools import make_example_scene
    root = str(tmp_path / "scene")
    make_example_scene.main(root, 0, n_views=2, hw=16, device="cpu")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "configs", "editing",
                           "texture_swapping_sphere.json")) as f:
        raw = json.loads(f.read().replace("examples/scene", root))
    raw["use_arap"] = True
    outs = []
    for swap, cfg, kw in ((JSwap(), JConfig(raw), {}),
                          (TextureSwappingRender(), ConfigDict(raw),
                           {"device": "cpu"})):
        main, _, _ = swap.read_data(cfg.main_config, cfg.main_mask_mesh,
                                    cfg.main_ckpt, **kw)
        ref, _, _ = swap.read_data(cfg.ref_config[0],
                                   [cfg.ref_mask_mesh[0]], cfg.ref_ckpt[0],
                                   **kw)
        T = swap.transfer_texture_features(cfg, main, [ref])
        outs.append((np.asarray(T), np.asarray(ref.get_mesh().vertices),
                     main))
    (T_j, v_j, main_j), (T_t, v_t, main_t) = outs
    np.testing.assert_allclose(T_t, T_j, rtol=0, atol=1e-12)
    np.testing.assert_allclose(v_t, v_j, rtol=0, atol=1e-12)
    moved = np.abs(v_t - make_example_scene.icosphere_mesh(0.5, 3).vertices)
    assert moved.max() > 1e-3
    want = np.asarray(main_j.edit_color_features)
    assert np.abs(want).sum() > 0
    np.testing.assert_array_equal(main_t.edit_color_features.numpy(), want)
