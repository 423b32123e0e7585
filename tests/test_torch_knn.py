"""Candidate grid and tile contexts of the port against the JAX package."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neumesh_tpu.dataio.synthetic import icosphere_mesh as jax_icosphere
from neumesh_tpu.models.neumesh.model import \
    candidate_bounded_near_far_tiled as jax_bounds
from neumesh_tpu.ops.knn import build_candidate_grid as jax_build
from neumesh_tpu_torch.models.neumesh.model import \
    candidate_bounded_near_far_tiled
from neumesh_tpu_torch.ops.knn import build_candidate_grid
from neumesh_tpu_torch.ops.rays import near_far_from_sphere
from test_torch_basics import block_rays, small_scene


@pytest.mark.parametrize("subdivisions", [3, 4])
def test_candidate_grid_matches_jax(subdivisions):
    pts = jax_icosphere(0.5, subdivisions).vertices
    g_t = build_candidate_grid(pts, use_cache=False)
    g_j = jax_build(pts, use_cache=False)
    assert g_t.dims == tuple(g_j.dims)
    assert g_t.Kp == g_j.Kp
    np.testing.assert_array_equal(g_t.origin.numpy(), np.asarray(g_j.origin))
    assert float(g_t.inv_h) == float(g_j.inv_h)
    np.testing.assert_array_equal(g_t.cell_row.numpy(),
                                  np.asarray(g_j.cell_row))
    # candidate lists: the same distances from each row's cell centre
    # (ids may differ only between equidistant vertices). Rows are the
    # near-surface cells (occupancy dilated twice) in raster order.
    from scipy import ndimage

    from neumesh_tpu_torch.ops.knn import _host_knn
    pf = np.asarray(pts, np.float32)
    d8, _ = _host_knn(pf, pf, 9)
    cs = float(np.percentile(d8[:, -1], 90) + 1e-6)
    assert np.float32(1.0 / cs) == float(g_t.inv_h)
    lo = g_t.origin.numpy()
    dims = np.asarray(g_t.dims)
    occ = np.zeros(tuple(dims), bool)
    ijk = np.clip(np.floor((pf - lo) / cs).astype(np.int64), 0, dims - 1)
    occ[ijk[:, 0], ijk[:, 1], ijk[:, 2]] = True
    centres = (lo + (np.argwhere(ndimage.binary_dilation(
        occ, iterations=2)) + 0.5) * cs).astype(np.float32)
    assert len(centres) == g_t.cand_idx.shape[0]
    p = pf.astype(np.float64)
    d_t = np.linalg.norm(p[g_t.cand_idx.numpy()] - centres[:, None], axis=-1)
    d_j = np.linalg.norm(p[np.asarray(g_j.cand_idx)] - centres[:, None],
                         axis=-1)
    np.testing.assert_allclose(np.sort(d_t, -1), np.sort(d_j, -1), atol=1e-6)
    np.testing.assert_allclose(g_t.cand_pts,
                               p[g_t.cand_idx.numpy()].astype(np.float32))
    # the host query agrees with the JAX grid query
    q = (p[::7] * 1.02).astype(np.float32)
    sq_t, _ = g_t.query_np(q, k=8)
    sq_j, _ = g_j.query(jnp.asarray(q), k=8)
    np.testing.assert_allclose(sq_t, np.asarray(sq_j), atol=1e-6)


@pytest.mark.parametrize("cell_budget,max_cand", [(0, 128), (64, 64),
                                                  (0, 40)])
def test_tile_context_matches_jax(cell_budget, max_cand):
    kw = dict(tile_kp_per_probe=12, tile_cell_budget=cell_budget)
    jm, params, tm = small_scene(seed=0, jax_kw=kw, torch_kw=kw)
    o, d = block_rays(16, 32)
    near, far = near_far_from_sphere(torch.from_numpy(o),
                                     torch.from_numpy(d))
    want = jm.make_tile_context(
        params, jnp.asarray(o), jnp.asarray(d), jnp.asarray(near.numpy()),
        jnp.asarray(far.numpy()), 16, 16, kp_per_probe=12,
        max_candidates=max_cand)
    got = tm.make_tile_context(torch.from_numpy(o), torch.from_numpy(d),
                               near, far, 16, 16, kp_per_probe=12,
                               max_candidates=max_cand)
    assert got["_ranked"] == want["_ranked"]
    np.testing.assert_array_equal(got["ids"].numpy(),
                                  np.asarray(want["ids"]))
    for key in ("pts", "pp", "ind", "vn", "feat"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-6, atol=1e-6)
    nj, fj = jax_bounds(want, jnp.asarray(o), jnp.asarray(d),
                        jnp.asarray(near.numpy()), jnp.asarray(far.numpy()),
                        16)
    nt, ft = candidate_bounded_near_far_tiled(
        got, torch.from_numpy(o), torch.from_numpy(d), near, far, 16)
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), atol=1e-5)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), atol=1e-5)
