"""The port's extraction CLI (neumesh_tpu_torch.cli.extract_mesh) against
the repository's extract_mesh.py: the grid SDF and the vertex colours of
a tiny NeuS and a tiny NeuMesh (numpy-seeded parameters carried across,
the NeuMesh on the JAX package's candidate tables and a jittered mesh)
within 2e-5 + 1e-4 rel; the whole extract_mesh fed the JAX grid gives the
same PLY and bbox JSON; the CLI reads the port's and the JAX package's
checkpoints alike and raises without a card; the synthetic scene writers
and the UV sphere equal the JAX package's."""
import json
import os
import sys

import imageio.v2 as imageio
import jax
import numpy as np
import pytest
import torch

from neumesh_tpu.utils.checkpoints import CheckpointIO as JCheckpointIO
from neumesh_tpu_torch.cli import extract_mesh as textract
from neumesh_tpu_torch.mesh.triangle_mesh import load_ply
from neumesh_tpu_torch.utils.checkpoints import CheckpointIO
from test_torch_basics import SMALL, small_scene
from test_torch_train_step import SMALL_NEUS, tiny_teacher

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL, RTOL = 2e-5, 1e-4
RANGE = (-0.8, 0.8)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_extract():
    sys.path.insert(0, REPO)
    import extract_mesh
    return extract_mesh


def models(kind):
    """(JAX model, JAX params, port model)."""
    if kind == "neus":
        return tiny_teacher(seed=3)
    jm, jp, tm = small_scene(seed=4, subdivisions=2, jitter=2e-3)
    return jm, jp, tm


@pytest.mark.parametrize("kind", ["neus", "neumesh"])
def test_grid_sdf_and_vertex_colors_match_jax(jax_extract, kind):
    jm, jp, tm = models(kind)
    N, chunk = 14, 1000            # a partial last chunk
    want = jax_extract.evaluate_grid_sdf(jm, jp, N, RANGE, RANGE, RANGE,
                                         chunk=chunk)
    got = textract.evaluate_grid_sdf(tm, N, RANGE, RANGE, RANGE, chunk=chunk)
    assert got.shape == (N, N, N) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)

    # vertices on the median level set (a random NeuMesh's SDF need not
    # cross 0 in the box)
    from neumesh_tpu_torch.mesh.marching_cubes import extract_isosurface
    mesh = extract_isosurface(want, float(np.median(want)), (RANGE[0],) * 3,
                              ((RANGE[1] - RANGE[0]) / (N - 1),) * 3)
    normals = mesh.compute_vertex_normals()
    assert mesh.n_vertices > 50
    want_c = jax_extract.evaluate_vertex_colors(jm, jp, mesh.vertices,
                                                normals, chunk=300)
    got_c = textract.evaluate_vertex_colors(tm, mesh.vertices, normals,
                                            chunk=300)
    assert got_c.shape == (mesh.n_vertices, 3)
    np.testing.assert_allclose(got_c, want_c, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("method", ["mt", "mc"])
def test_extract_mesh_fed_the_jax_grid_matches(jax_extract, tmp_path,
                                               monkeypatch, method):
    """Both extract_mesh functions on the same grid (the JAX package's,
    through its numpy marching): the same PLY (vertices and triangles
    equal, colours within one 8-bit level) and bbox JSON."""
    from neumesh_tpu.cpp import native
    jm, jp, tm = models("neus")
    N = 16
    grid = jax_extract.evaluate_grid_sdf(jm, jp, N, RANGE, RANGE, RANGE)
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(textract, "evaluate_grid_sdf",
                        lambda *a, **k: grid)
    kw = dict(N_grid=N, x_range=RANGE, y_range=RANGE, z_range=RANGE,
              sdf_th=0.0, chunk=4096, scale_factor=1.5, obj_id="7",
              method=method)
    jmesh = jax_extract.extract_mesh(jm, jp, output_dir=str(tmp_path / "j"),
                                     **kw)
    stats = {}
    tmesh = textract.extract_mesh(tm, output_dir=str(tmp_path / "t"),
                                  stats=stats, **kw)
    assert set(stats) == {"grid_s", "march_s", "color_s"}
    np.testing.assert_array_equal(tmesh.vertices, jmesh.vertices)
    np.testing.assert_array_equal(tmesh.triangles, jmesh.triangles)
    a = load_ply(str(tmp_path / "t" / "extracted_7.ply"))
    b = load_ply(str(tmp_path / "j" / "extracted_7.ply"))
    np.testing.assert_array_equal(a.vertices, b.vertices)
    np.testing.assert_array_equal(a.triangles, b.triangles)
    assert np.abs(a.vertex_colors - b.vertex_colors).max() <= 1 / 255 + 1e-9
    ja = json.load(open(tmp_path / "t" / "bbox_7.json"))
    jb = json.load(open(tmp_path / "j" / "bbox_7.json"))
    assert ja.keys() == jb.keys() == {"max_bound", "min_bound", "size"}
    for k in ja:
        np.testing.assert_array_equal(ja[k], jb[k])


def _neus_config(tmp_path):
    from neumesh_tpu_torch.config import ConfigDict, save_yaml
    s, r = SMALL_NEUS["surface_cfg"], SMALL_NEUS["radiance_cfg"]
    cfg = ConfigDict({
        "expname": "x", "data": {},
        "model": {"framework": "NeuS", "obj_bounding_radius": 1.0,
                  "W_geometry_feature": SMALL_NEUS["W_geo_feat"],
                  "surface": dict(s, skips=list(s["skips"])),
                  "radiance": dict(r)},
        "training": {"speed_factor": 10.0, "exp_dir": str(tmp_path / "exp"),
                     "loss_weights": {"img": 1.0, "mask": 1.0}}})
    path = str(tmp_path / "neus.yaml")
    save_yaml(cfg, path)
    return path


def _neumesh_config(tmp_path, mesh):
    from neumesh_tpu_torch.config import ConfigDict, save_yaml
    from neumesh_tpu_torch.mesh.triangle_mesh import save_ply
    save_ply(mesh, str(tmp_path / "mesh.ply"))
    cfg = ConfigDict({
        "expname": "x", "data": {},
        "model": {"framework": "NeuMesh",
                  "prior_mesh": str(tmp_path / "mesh.ply"),
                  **{k: v for k, v in SMALL.items() if k != "speed_factor"}},
        "training": {"speed_factor": 10.0, "exp_dir": str(tmp_path / "exp"),
                     "loss_weights": {"eikonal": 0.1}}})
    path = str(tmp_path / "neumesh.yaml")
    save_yaml(cfg, path)
    return path


@pytest.mark.parametrize("kind", ["neus", "neumesh"])
def test_cli_reads_both_checkpoint_kinds(tmp_path, monkeypatch, kind):
    """The CLI on a JAX-package `.ckpt` (msgpack) and on the port's
    `.ckpt` (torch zip) of the same parameters: the same mesh, equal to
    extract_mesh on the model itself; without --ckpt_path the last
    checkpoint of training.exp_dir; a level the SDF does not reach raises,
    and so does a run without --device cpu (no card here)."""
    jm, jp, tm = models(kind)
    if kind == "neus":
        cfg = _neus_config(tmp_path)
    else:
        cfg = _neumesh_config(tmp_path, tm.mesh_grid.mesh)
    jpath = JCheckpointIO(str(tmp_path / "jax")).save(
        "latest.ckpt", model=jax.tree.map(np.asarray, jp), global_step=1)
    tpath = CheckpointIO(str(tmp_path / "exp" / "ckpts")).save(
        "latest.ckpt", model=tm)
    # the median level set: a random NeuMesh's SDF need not cross 0
    th = float(np.median(textract.evaluate_grid_sdf(tm, 12, RANGE, RANGE,
                                                    RANGE)))
    base = ["--config", cfg, "--N_grid", "12", "--chunk", "700",
            "--sdf_th", repr(th),
            "--x_range", "-0.8", "0.8", "--y_range", "-0.8", "0.8",
            "--z_range", "-0.8", "0.8", "--device", "cpu"]
    meshes = {}
    for tag, extra in (("jax", ["--ckpt_path", jpath]), ("port", [])):
        out = str(tmp_path / tag)
        meshes[tag] = textract.main(base + extra + ["--output_dir", out])
        assert os.path.exists(os.path.join(out, "extracted_0.ply"))
        assert os.path.exists(os.path.join(out, "bbox_0.json"))
    if kind == "neumesh":
        # the CLI's model builds its own candidate grid: hold it to the
        # same model on it, not to the JAX tables of small_scene
        tm, _ = textract.load_model(_cli_config(cfg, tpath))
    direct = textract.extract_mesh(tm, 12, RANGE, RANGE, RANGE, th, 700,
                                   1.0, str(tmp_path / "direct"), "0")
    for m in meshes.values():
        assert m.n_triangles > 20
        np.testing.assert_array_equal(m.triangles, direct.triangles)
        np.testing.assert_allclose(m.vertices, direct.vertices, atol=1e-6)
        np.testing.assert_allclose(m.vertex_colors, direct.vertex_colors,
                                   atol=1e-5)
    with pytest.raises(ValueError, match="no isosurface"):
        textract.main(base + ["--sdf_th", "1e3", "--output_dir",
                              str(tmp_path / "empty")])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            textract.main(base[:-2] + ["--output_dir", str(tmp_path / "x")])


def _cli_config(cfg_path, ckpt):
    from neumesh_tpu_torch.config import load_yaml
    cfg = load_yaml(cfg_path)
    cfg["device"], cfg["ckpt_path"] = "cpu", ckpt
    return cfg


def test_synthetic_writers_equal_the_jax_package(tmp_path):
    """generate_torus_scene (PNG pixels, masks, cameras.npz), the SDF
    scene render, torus_union_sdf and sphere_mesh: equal arrays."""
    from neumesh_tpu.dataio import synthetic as js
    from neumesh_tpu_torch.dataio import synthetic as ts
    from neumesh_tpu_torch.utils.image_io import read_png
    kw = dict(n_views=3, H=20, W=24, focal=30.0)
    js.generate_torus_scene(str(tmp_path / "j"), **kw)
    ts.generate_torus_scene(str(tmp_path / "t"), **kw)
    for sub in ("image", "mask"):
        names = sorted(os.listdir(tmp_path / "j" / sub))
        assert names == sorted(os.listdir(tmp_path / "t" / sub))
        assert len(names) == 3
        for n in names:
            got = read_png(str(tmp_path / "t" / sub / n))
            np.testing.assert_array_equal(
                got, imageio.imread(tmp_path / "j" / sub / n))
            np.testing.assert_array_equal(
                got, imageio.imread(tmp_path / "t" / sub / n))
        if sub == "image":
            assert got.max() > 0
    cj = np.load(tmp_path / "j" / "cameras.npz")
    ct = np.load(tmp_path / "t" / "cameras.npz")
    assert sorted(cj.files) == sorted(ct.files)
    for k in cj.files:
        np.testing.assert_array_equal(ct[k], cj[k])
    rng = np.random.default_rng(0)
    p = rng.uniform(-0.6, 0.6, (200, 3))
    np.testing.assert_array_equal(ts.torus_union_sdf(p),
                                  js.torus_union_sdf(p))
    ro = np.tile([[0.0, 0.0, -2.5]], (64, 1))
    rd = rng.normal(size=(64, 3)) * 0.1 + [0, 0, 1]
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    for a, b in zip(ts.sdf_scene_rgb(ro, rd, ts.torus_union_sdf),
                    js.sdf_scene_rgb(ro, rd, js.torus_union_sdf)):
        np.testing.assert_array_equal(a, b)
    for args in ((), (0.3, 10, 20)):
        a, b = ts.sphere_mesh(*args), js.sphere_mesh(*args)
        np.testing.assert_array_equal(a.vertices, b.vertices)
        np.testing.assert_array_equal(a.triangles, b.triangles)
        np.testing.assert_array_equal(a.vertex_normals, b.vertex_normals)
