"""PyTorch port (neumesh_tpu_torch) against the JAX package: shared small
scene helpers, nn/alpha/rays primitives, weights carried across, the
device rule and the import rule.

Every input is made by numpy from a seed and handed to both packages as
numpy arrays; JAX stays on the CPU (tests/conftest.py)."""
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neumesh_tpu.dataio.synthetic import icosphere_mesh as jax_icosphere
from neumesh_tpu.mesh import MeshGrid as JMeshGrid
from neumesh_tpu.models.neumesh.model import NeuMesh as JNeuMesh
from neumesh_tpu_torch.dataio.synthetic import icosphere_mesh
from neumesh_tpu_torch.mesh.grid import MeshGrid
from neumesh_tpu_torch.models.neumesh.model import NeuMesh
from neumesh_tpu_torch.ops.knn import CandidateGrid

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the small configuration of every parity test
SMALL = dict(D_density=3, D_color=2, W=32, geometry_dim=8, color_dim=8,
             multires_d=4, multires_fg=1, multires_ft=1, multires_view=2,
             enable_nablas_input=True, learn_indicator_weight=True,
             speed_factor=10.0)


def small_scene(seed=0, jax_kw=None, torch_kw=None, subdivisions=3,
                jitter=0.0):
    """(jax model, jax params, torch model) on the icosphere at
    `subdivisions`, binding IDENTICAL candidate tables (the JAX grid's,
    adopted through CandidateGrid.from_arrays) and identical numpy-seeded
    parameters; both on the fused route (use_pallas=True). jitter moves
    the vertices by that much Gaussian noise, which removes the sphere's
    exact kNN ties."""
    jmesh, tmesh = (jax_icosphere(0.5, subdivisions),
                    icosphere_mesh(0.5, subdivisions))
    if jitter:
        noise = np.random.default_rng(seed + 100).normal(
            size=jmesh.vertices.shape) * jitter
        for mesh in (jmesh, tmesh):
            mesh.vertices = mesh.vertices + noise
            mesh.compute_vertex_normals()
    jm = JNeuMesh(JMeshGrid(jmesh, "grid"),
                  use_pallas=True, **{**SMALL, **(jax_kw or {})})
    g = jm.mesh_grid.grid
    grid = CandidateGrid.from_arrays(
        np.asarray(g.cell_row), np.asarray(g.cand_idx),
        np.asarray(g.cand_pts), np.asarray(g.origin), np.asarray(g.inv_h),
        g.dims)
    tm = NeuMesh(MeshGrid(tmesh, device="cpu", grid=grid),
                 device="cpu", use_pallas=True,
                 **{**SMALL, **(torch_kw or {})}).init(seed)
    return jm, jax_params_of(tm), tm


def jax_params_of(tm):
    """The torch model's parameters as a JAX NeuMesh param tree."""
    def a(t):
        return jnp.asarray(t.detach().numpy().copy())

    def lin(m):
        if hasattr(m, "g"):
            return {"g": a(m.g), "v": a(m.v), "b": a(m.b)}
        return {"w": a(m.w), "b": a(m.b)}

    return {
        "ln_s": a(tm.ln_s), "geometry_features": a(tm.geometry_features),
        "color_features": a(tm.color_features),
        "indicator_vector": a(tm.indicator_vector),
        "indicator_weight_raw": a(tm.indicator_weight_raw),
        "pts_linears": [lin(m) for m in tm.pts_linears],
        "density_linear": lin(tm.density_linear),
        "views_linears": [lin(m) for m in tm.views_linears],
        "color_linear": lin(tm.color_linear),
    }


def camera(H, W, half_fov=0.25):
    """Camera at (0, 0, -2.5) looking down +z at the unit-radius scene."""
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = -2.5
    f = (W / 2) / half_fov
    K = np.array([[f, 0, (W - 1) / 2], [0, f, (H - 1) / 2], [0, 0, 1]],
                 np.float32)
    return c2w, K


def block_rays(H, W, block=(8, 16), half_fov=0.25):
    """Numpy (rays_o, rays_d) of an HxW camera in 8x16 pixel-block order."""
    from neumesh_tpu_torch.ops.rays import block_order_indices, get_rays
    c2w, K = camera(H, W, half_fov)
    o, d = get_rays(torch.from_numpy(c2w), torch.from_numpy(K), H, W)
    perm, _ = block_order_indices(H, W, *block)
    return o.numpy()[perm].copy(), d.numpy()[perm].copy()


# ---------------------------------------------------------------------------
# nn, alpha, rays
# ---------------------------------------------------------------------------

def test_nn_primitives_match_jax(rng):
    from neumesh_tpu import nn as jnn
    from neumesh_tpu_torch import nn as tnn
    v = rng.normal(size=(17, 5)).astype(np.float32)
    g = rng.uniform(0.5, 2, size=(5,)).astype(np.float32)
    want = jnn.wnorm_weight({"g": jnp.asarray(g), "v": jnp.asarray(v)})
    got = tnn.wnorm_weight(torch.from_numpy(g), torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    x = np.concatenate([rng.normal(size=200) * 0.05,
                        [0.2, 0.2000001, 0.19999, -0.3]]).astype(np.float32)
    np.testing.assert_allclose(
        tnn.softplus100(torch.from_numpy(x)).numpy(),
        np.asarray(jnn.softplus100(jnp.asarray(x))), rtol=1e-6, atol=1e-8)
    xe = rng.normal(size=(64, 3)).astype(np.float32)
    for multires in (4, 1, 0):
        for exact in (True, False):
            je, jd = jnn.get_embedder(multires, 3, exact=exact)
            te, td = tnn.get_embedder(multires, 3, exact=exact)
            assert jd == td
            np.testing.assert_allclose(te(torch.from_numpy(xe)).numpy(),
                                       np.asarray(je(jnp.asarray(xe))),
                                       atol=2e-6)


@pytest.mark.parametrize("dtype", [None, "bf16"])
def test_maybe_wnorm_apply_matches_jax(rng, dtype):
    """A weight-norm linear on one input and on split parts: true f32
    without a dtype; with bf16 each part's product is rounded to bf16 and
    the sum runs in bf16 (one bf16 ulp of slack for the rounding points)."""
    from neumesh_tpu import nn as jnn
    from neumesh_tpu_torch import nn as tnn
    v = rng.normal(size=(12, 6)).astype(np.float32)
    g = rng.uniform(0.5, 2, size=(6,)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32)
    xa = rng.normal(size=(40, 5)).astype(np.float32)
    xb = rng.normal(size=(40, 7)).astype(np.float32)

    lin = SimpleNamespace(
        weight=lambda: tnn.wnorm_weight(torch.from_numpy(g),
                                        torch.from_numpy(v)),
        b=torch.from_numpy(b))
    p = {"g": jnp.asarray(g), "v": jnp.asarray(v), "b": jnp.asarray(b)}
    jdt = None if dtype is None else jnp.bfloat16
    tdt = None if dtype is None else torch.bfloat16
    want = [jnn.maybe_wnorm_apply(p, jnp.asarray(np.concatenate(
                [xa, xb], -1)), jdt),
            jnn.maybe_wnorm_apply_parts(p, [jnp.asarray(xa),
                                            jnp.asarray(xb)], jdt)]
    got = [tnn.maybe_wnorm_apply(lin, torch.from_numpy(np.concatenate(
               [xa, xb], -1)), tdt),
           tnn.maybe_wnorm_apply_parts(lin, [torch.from_numpy(xa),
                                             torch.from_numpy(xb)], tdt)]
    for gt, w in zip(got, want):
        w = np.asarray(w.astype(jnp.float32))
        assert gt.dtype == (torch.float32 if dtype is None else tdt)
        tol = (dict(atol=1e-5, rtol=1e-5) if dtype is None
               else dict(atol=2e-2, rtol=1e-2))
        np.testing.assert_allclose(gt.float().numpy(), w, **tol)


def test_alpha_matches_jax(rng):
    from neumesh_tpu.ops import alpha as ja
    from neumesh_tpu_torch.ops import alpha as ta
    sdf = (rng.normal(size=(6, 20)) * 0.1).astype(np.float32)
    for s in (1.0, 64.0):
        jc, jal = ja.sdf_to_alpha(jnp.asarray(sdf), s)
        tc, tal = ta.sdf_to_alpha(torch.from_numpy(sdf), s)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6)
        np.testing.assert_allclose(tal.numpy(), np.asarray(jal), atol=1e-6)
        np.testing.assert_allclose(ta.alpha_to_w(tal).numpy(),
                                   np.asarray(ja.alpha_to_w(jal)),
                                   atol=1e-6)


def test_rays_match_jax(rng):
    from neumesh_tpu.ops import rays as jr
    from neumesh_tpu_torch.ops import rays as tr
    c2w, K = camera(8, 16)
    jo, jd, _ = jr.get_rays(jnp.asarray(c2w), jnp.asarray(K), 8, 16)
    to, td = tr.get_rays(torch.from_numpy(c2w), torch.from_numpy(K), 8, 16)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6)
    for keep in (True, False):
        jn, jf = jr.near_far_from_sphere(jo, jd, keepdim=keep)
        tn, tf = tr.near_far_from_sphere(to, td, keepdim=keep)
        np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-6)
        np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-6)
    bins = np.sort(rng.uniform(1, 3, size=(5, 12)), -1).astype(np.float32)
    w = rng.uniform(0, 1, size=(5, 11)).astype(np.float32)
    want = jr.sample_pdf(jnp.asarray(bins), jnp.asarray(w), 9, det=True)
    got = tr.sample_pdf(torch.from_numpy(bins), torch.from_numpy(w), 9,
                        det=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # random probes: the same uniforms handed to both
    want = jr.sample_pdf(jnp.asarray(bins), jnp.asarray(w), 9, det=False,
                         key=jax.random.PRNGKey(0))
    got = tr.sample_pdf(torch.from_numpy(bins), torch.from_numpy(w), 9,
                        u=torch.from_numpy(np.array(
                            jax.random.uniform(jax.random.PRNGKey(0),
                                               (5, 9)))))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    gen = torch.Generator().manual_seed(0)
    a = tr.sample_pdf(torch.from_numpy(bins), torch.from_numpy(w), 9,
                      generator=gen)
    assert a.shape == (5, 9)
    assert bool((a >= torch.from_numpy(bins[:, :1])).all())
    p1, i1 = jr.block_order_indices(16, 32, 8, 16)
    p2, i2 = tr.block_order_indices(16, 32, 8, 16)
    assert np.array_equal(p1, p2) and np.array_equal(i1, i2)


# ---------------------------------------------------------------------------
# weights and state carried across
# ---------------------------------------------------------------------------

def test_params_from_jax_matches_reference_pt(tmp_path):
    from neumesh_tpu.utils.torch_ckpt import save_torch_checkpoint
    from neumesh_tpu_torch.utils.state import (load_reference_pt,
                                               params_from_jax,
                                               save_reference_pt)
    jm, params, tm = small_scene(seed=3)
    params_np = jax.tree_util.tree_map(lambda a: np.array(a), params)
    path = str(tmp_path / "ref.pt")
    save_torch_checkpoint(path, params, jm)

    def fresh():
        return NeuMesh(tm.mesh_grid, device="cpu", **SMALL)

    a, b = fresh(), fresh()
    params_from_jax(params_np, a)
    load_reference_pt(path, b)
    for (na, pa), (nb, pb) in zip(a.named_parameters(),
                                  b.named_parameters()):
        assert na == nb
        assert torch.equal(pa, pb), na
        assert torch.equal(pa, dict(tm.named_parameters())[na]), na
    # copies, never aliases of the caller's arrays
    params_np["ln_s"][0] = 123.0
    assert float(a.ln_s[0]) != 123.0
    # the port's own writer round-trips and is readable by the JAX reader
    path2 = str(tmp_path / "port.pt")
    save_reference_pt(path2, b)
    c = fresh()
    load_reference_pt(path2, c)
    assert all(torch.equal(x, y) for x, y in
               zip(b.parameters(), c.parameters()))
    from neumesh_tpu.utils.torch_ckpt import (load_torch_checkpoint,
                                              neumesh_state_dict_to_params)
    back = neumesh_state_dict_to_params(
        load_torch_checkpoint(path2)["model"], jm)
    np.testing.assert_array_equal(np.asarray(back["pts_linears"][1]["v"]),
                                  params_np["pts_linears"][1]["v"])


def test_ply_round_trip(tmp_path):
    from neumesh_tpu.mesh.triangle_mesh import load_ply as jload
    from neumesh_tpu_torch.mesh.triangle_mesh import load_ply, save_ply
    mesh = icosphere_mesh(0.5, 2)
    save_ply(mesh, str(tmp_path / "m.ply"))
    a, b = load_ply(str(tmp_path / "m.ply")), jload(str(tmp_path / "m.ply"))
    np.testing.assert_array_equal(a.vertices, b.vertices)
    np.testing.assert_array_equal(a.triangles, b.triangles)
    np.testing.assert_array_equal(a.vertex_normals, b.vertex_normals)


# ---------------------------------------------------------------------------
# device rule and import rule
# ---------------------------------------------------------------------------

def test_entry_points_default_to_cuda_and_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    from neumesh_tpu_torch.render.volume import render_image
    mesh = icosphere_mesh(0.5, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MeshGrid(mesh)
    mg = MeshGrid(mesh, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NeuMesh(mg, **SMALL)
    tm = NeuMesh(mg, device="cpu", **SMALL)
    c2w, K = camera(8, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render_image(tm, c2w, K, 8, 16, ray_tile=16)


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    code = (
        "import sys, neumesh_tpu_torch, neumesh_tpu_torch.render.volume, "
        "neumesh_tpu_torch.render.ray_casting, "
        "neumesh_tpu_torch.utils.state, neumesh_tpu_torch.ops.kernels, "
        "neumesh_tpu_torch.ops._build, neumesh_tpu_torch.cli.render, "
        "neumesh_tpu_torch.models.neumesh, neumesh_tpu_torch.dataio.dtu, "
        "neumesh_tpu_torch.utils.checkpoints, "
        "neumesh_tpu_torch.cli.extract_mesh, neumesh_tpu_torch.cli.eval, "
        "neumesh_tpu_torch.ops.lpips, neumesh_tpu_torch.mesh.marching_cubes, "
        "neumesh_tpu_torch.dataio.synthetic, "
        "neumesh_tpu_torch.tools.parity_eval, "
        "neumesh_tpu_torch.tools.quality_gate\n"
        "bad = [m for m in sys.modules if m.startswith('jax') or "
        "m == 'neumesh_tpu' or m.startswith('neumesh_tpu.') or "
        "m.split('.')[0] in ('yaml', 'PIL', 'cv2', 'msgpack', 'flax', "
        "'imageio')]\n"
        "print(repr(bad)); sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_port_modules_import_none_of_the_missing_packages():
    """Every import statement of every module of the port, module level or
    inside a function: none of jax, neumesh_tpu, PyYAML, Pillow, OpenCV,
    msgpack or flax (the card machine has none of them); imageio only
    inside a function of the CLI (its optional video writer)."""
    import ast
    banned = {"jax", "jaxlib", "neumesh_tpu", "yaml", "PIL", "cv2",
              "msgpack", "flax"}
    pkg = os.path.join(REPO, "neumesh_tpu_torch")
    found = []
    for root, _, files in os.walk(pkg):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(root, name)
            tree = ast.parse(open(path).read(), path)
            top = {id(n) for n in tree.body}
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    mods = [node.module]
                else:
                    continue
                for m in mods:
                    head = m.split(".")[0]
                    rel = os.path.relpath(path, REPO)
                    if head in banned or (head == "imageio" and (
                            rel != os.path.join("neumesh_tpu_torch", "cli",
                                                "render.py")
                            or id(node) in top)):
                        found.append((rel, m))
    assert not found, found
