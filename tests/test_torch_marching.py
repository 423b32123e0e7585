"""The port's marching tetrahedra / marching cubes (neumesh_tpu_torch.mesh.
marching_cubes) against the JAX package's numpy path: every case of
tests/test_marching.py on the port, arrays EQUAL to
neumesh_tpu.mesh.marching_cubes.extract_isosurface(..., backend="numpy")
on seeded fields, the triangle-mesh hygiene helpers against the JAX
package's, and backend="native" raising."""
import numpy as np
import pytest

from neumesh_tpu.mesh import marching_cubes as jmc
from neumesh_tpu.mesh import triangle_mesh as jtm
from neumesh_tpu_torch.mesh import marching_cubes as tmc
from neumesh_tpu_torch.mesh import triangle_mesh as ttm
from neumesh_tpu_torch.mesh.marching_cubes import extract_isosurface

METHODS = ["mt", "mc"]


def sphere_field(n=48, r=0.5, bound=1.0):
    xs = np.linspace(-bound, bound, n)
    X, Y, Z = np.meshgrid(xs, xs, xs, indexing="ij")
    field = np.sqrt(X**2 + Y**2 + Z**2) - r
    spacing = (xs[1] - xs[0],) * 3
    origin = (-bound,) * 3
    return field, origin, spacing


def blob_field(seed, n=24, noise=0.0):
    """min of a few seeded spheres (ambiguous faces), plus noise."""
    rng = np.random.default_rng(seed)
    xs = np.linspace(-1, 1, n)
    X, Y, Z = np.meshgrid(xs, xs, xs, indexing="ij")
    field = np.full(X.shape, 0.4)
    for _ in range(6):
        c = rng.uniform(-0.5, 0.5, 3)
        r = rng.uniform(0.15, 0.45)
        d = np.sqrt((X - c[0])**2 + (Y - c[1])**2 + (Z - c[2])**2)
        field = np.minimum(field, d - r)
    return field + noise * rng.normal(size=field.shape)


def edge_counts(t):
    edges = np.concatenate([t[:, [0, 1]], t[:, [1, 2]], t[:, [2, 0]]])
    _, counts = np.unique(np.sort(edges, axis=1), axis=0, return_counts=True)
    return counts


@pytest.mark.parametrize("method", METHODS)
def test_sphere_isosurface_vertices_on_sphere(method):
    field, origin, spacing = sphere_field()
    mesh = extract_isosurface(field, 0.0, origin, spacing, method=method)
    assert mesh.n_vertices > 500
    radii = np.linalg.norm(mesh.vertices, axis=-1)
    np.testing.assert_allclose(radii, 0.5, atol=0.01)


@pytest.mark.parametrize("method", METHODS)
def test_sphere_normals_outward(method):
    field, origin, spacing = sphere_field()
    mesh = extract_isosurface(field, 0.0, origin, spacing, method=method)
    normals = mesh.compute_vertex_normals()
    dots = np.sum(normals * mesh.vertices, axis=-1) / np.maximum(
        np.linalg.norm(mesh.vertices, axis=-1), 1e-9)
    assert (dots > 0.9).mean() > 0.99


@pytest.mark.parametrize("method", METHODS)
def test_watertight_sphere_area_and_no_degenerate(method):
    field, origin, spacing = sphere_field(n=64)
    mesh = extract_isosurface(field, 0.0, origin, spacing, method=method)
    v, t = mesh.vertices, mesh.triangles
    fn = np.cross(v[t[:, 1]] - v[t[:, 0]], v[t[:, 2]] - v[t[:, 0]])
    area = 0.5 * np.linalg.norm(fn, axis=-1).sum()
    np.testing.assert_allclose(area, 4 * np.pi * 0.25, rtol=0.03)
    assert not mesh.degenerate_triangle_mask().any()
    assert (edge_counts(t) == 2).all()


@pytest.mark.parametrize("method", METHODS)
def test_nonzero_iso_level(method):
    field, origin, spacing = sphere_field()
    mesh = extract_isosurface(field, 0.1, origin, spacing, method=method)
    radii = np.linalg.norm(mesh.vertices, axis=-1)
    np.testing.assert_allclose(radii, 0.6, atol=0.01)


@pytest.mark.parametrize("method", METHODS)
def test_empty_field(method):
    mesh = extract_isosurface(np.ones((8, 8, 8)), 0.0, method=method)
    assert mesh.n_vertices == 0 and mesh.n_triangles == 0


def _crossed_edge_count(field, iso):
    """Grid edges whose endpoints straddle iso: classic MC's vertex
    count by construction."""
    ins = field < iso
    n = 0
    for ax in range(3):
        a = np.swapaxes(ins, 0, ax)
        n += int((a[:-1] != a[1:]).sum())
    return n


@pytest.mark.parametrize("method", METHODS)
def test_crossed_edges_and_vertices_on_grid_edges(method):
    """mc: one vertex per crossed grid edge, on that edge. mt: every
    vertex on a tetrahedron edge, lo + t * d with d in {0, 1}^3 (cell
    edges, face and body diagonals), so its fractional coordinates are 0
    or all the same t."""
    field, _, _ = sphere_field(n=32)
    mesh = extract_isosurface(field, 0.0, method=method)
    v = mesh.vertices
    frac = v - np.floor(v)
    on = (frac > 1e-9) & (frac < 1 - 1e-9)
    if method == "mc":
        assert mesh.n_vertices == _crossed_edge_count(field, 0.0)
        assert (on.sum(1) <= 1).all()
    else:
        assert mesh.n_vertices > _crossed_edge_count(field, 0.0)
        hi = np.where(on, frac, -np.inf).max(1)
        lo = np.where(on, frac, np.inf).min(1)
        assert (on.sum(1) == 3).any()
        assert (np.where(on.any(1), hi - lo, 0.0) < 1e-9).all()


@pytest.mark.parametrize("method", METHODS)
def test_mc_half_the_triangles_of_mt(method):
    """Counted from either side: mc has < 0.65x mt's triangles and
    vertices on the same field."""
    field, _, _ = sphere_field(n=48)
    mesh = extract_isosurface(field, 0.0, method=method)
    other = extract_isosurface(field, 0.0,
                               method="mt" if method == "mc" else "mc")
    mc, mt = (mesh, other) if method == "mc" else (other, mesh)
    assert mc.n_triangles < 0.65 * mt.n_triangles
    assert mc.n_vertices < 0.65 * mt.n_vertices


@pytest.mark.parametrize("method", METHODS)
def test_ambiguous_faces_watertight(method):
    """A blob field with 4-crossing faces: the same pairing on both cells
    of a face, so no edge is open."""
    mesh = extract_isosurface(blob_field(3), 0.0, method=method)
    assert mesh.n_triangles > 100
    assert (edge_counts(mesh.triangles) == 2).all()


@pytest.mark.parametrize("method", METHODS)
def test_ply_roundtrip(tmp_path, method):
    """An extracted mesh with colours and uvs through save_ply / load_ply,
    and the JAX package's reader reads the port's file the same."""
    field, origin, spacing = sphere_field(n=16)
    m = extract_isosurface(field, 0.0, origin, spacing, method=method)
    rng = np.random.default_rng(0)
    m.vertex_uvs = rng.uniform(size=(m.n_vertices, 2))
    m.vertex_colors = rng.uniform(size=(m.n_vertices, 3))
    p = str(tmp_path / "m.ply")
    ttm.save_ply(m, p)
    m2, mj = ttm.load_ply(p), jtm.load_ply(p)
    np.testing.assert_allclose(m2.vertex_uvs, m.vertex_uvs, atol=1e-6)
    np.testing.assert_allclose(m2.vertices, m.vertices, atol=1e-6)
    np.testing.assert_array_equal(m2.triangles, m.triangles)
    for a in ("vertices", "triangles", "vertex_colors", "vertex_uvs"):
        np.testing.assert_array_equal(getattr(m2, a), getattr(mj, a))


FIELDS = {
    "sphere": lambda: sphere_field(n=40)[0],
    "blob": lambda: blob_field(7, n=28),
    "noisy_blob": lambda: blob_field(11, n=30, noise=0.03),
    "anisotropic": lambda: blob_field(5, n=24)[:, :19, 3:],
}


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("field", list(FIELDS))
@pytest.mark.parametrize("iso", [0.0, 0.05])
def test_arrays_equal_the_jax_numpy_path(method, field, iso):
    f = FIELDS[field]()
    origin, spacing = (-1.0, -0.5, 0.25), (0.05, 0.07, 0.03)
    want = jmc.extract_isosurface(f, iso, origin, spacing, backend="numpy",
                                  method=method)
    got = extract_isosurface(f, iso, origin, spacing, method=method)
    assert got.n_triangles > 0
    np.testing.assert_array_equal(got.vertices, want.vertices)
    np.testing.assert_array_equal(got.triangles, want.triangles)
    assert got.vertices.dtype == np.float64
    # the grid-space functions too, on a float32 field
    fn = tmc.marching_cubes if method == "mc" else tmc.marching_tetrahedra
    jfn = jmc.marching_cubes if method == "mc" else jmc.marching_tetrahedra
    for a, b in zip(fn(f.astype(np.float32), iso),
                    jfn(f.astype(np.float32), iso)):
        np.testing.assert_array_equal(a, b)


def test_native_backend_raises_and_the_overflow_guard():
    field = sphere_field(n=8)[0]
    with pytest.raises(NotImplementedError, match="item 6"):
        extract_isosurface(field, 0.0, backend="native")
    with pytest.raises(ValueError, match="backend"):
        extract_isosurface(field, 0.0, backend="cuda")
    with pytest.raises(ValueError, match="method"):
        extract_isosurface(field, 0.0, method="dc")

    class Huge:
        shape = (2000, 2000, 1000)
    for fn in (tmc.marching_tetrahedra, tmc.marching_cubes):
        with pytest.raises(ValueError, match="int64"):
            fn(Huge())


def test_mesh_hygiene_matches_jax():
    """triangle_normals, degenerate_triangle_mask,
    remove_duplicated_triangles, isolated_vertex_mask and transform of
    the port's TriangleMesh against the JAX package's on one mesh with
    duplicates, a degenerate and an isolated vertex."""
    mesh = extract_isosurface(sphere_field(n=12)[0], 0.0)
    rng = np.random.default_rng(2)
    t = mesh.triangles
    tris = np.concatenate([t, t[:5, ::-1], [[0, 0, 1], [1, 2, 1]]])
    verts = np.concatenate([mesh.vertices, rng.normal(size=(2, 3))])
    T = np.eye(4)
    T[:3, :3] = rng.normal(size=(3, 3))
    T[:3, 3] = rng.normal(size=3)
    meshes = [mod.TriangleMesh(verts.copy(), tris.copy())
              for mod in (ttm, jtm)]
    for m in meshes:
        m.compute_vertex_normals()
    tm, jm = meshes
    for normalized in (True, False):
        np.testing.assert_array_equal(tm.triangle_normals(normalized),
                                      jm.triangle_normals(normalized))
    np.testing.assert_array_equal(tm.degenerate_triangle_mask(),
                                  jm.degenerate_triangle_mask())
    assert tm.degenerate_triangle_mask()[-2:].all()
    np.testing.assert_array_equal(tm.isolated_vertex_mask(),
                                  jm.isolated_vertex_mask())
    assert tm.isolated_vertex_mask()[-2:].all()
    tm.remove_duplicated_triangles()
    jm.remove_duplicated_triangles()
    np.testing.assert_array_equal(tm.triangles, jm.triangles)
    assert tm.n_triangles == len(tris) - 5
    tm.transform(T)
    jm.transform(T)
    np.testing.assert_array_equal(tm.vertices, jm.vertices)
    np.testing.assert_array_equal(tm.vertex_normals, jm.vertex_normals)
