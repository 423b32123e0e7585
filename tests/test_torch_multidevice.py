"""The port's multi-device code on the CPU (counterparts of
tests/test_multidevice.py): ray-sharded volume and surface renders over
two CPU replicas (devices=["cpu", "cpu"]) against the one-device render,
a ragged frame through the volume frame entry's padding, the one-device short
cut and force_shard_map, replicas (of a model and of an editable) and
MeshGrid.to, and the global masked
mean of the image loss over a gloo pair against the JAX package's masked
mean on the concatenated rays.

Tolerances: the two renders run the same per-ray arithmetic, but the
plain versions' matmuls see other row counts, and the CPU's BLAS may sum
in another order; f32 rounding, as test_multidevice.py allows GSPMD."""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_train_step import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TILE = 16
SMALL = dict(D_density=2, D_color=2, W=32, geometry_dim=8, color_dim=8,
             multires_d=4, multires_fg=1, multires_ft=1, multires_view=2,
             enable_nablas_input=True, learn_indicator_weight=True,
             speed_factor=10.0)
VOL = dict(root_anchored=True, root_n_fine=8, root_steps=8, root_secant=3,
           color_topk=4, ray_tile=TILE, tile_max_candidates=64,
           N_samples=16, N_importance=8, N_upsample_iters=2,
           reuse_upsample_sdf=True, detailed_output=False)
SURF = dict(ray_tile=TILE, scan_mode="distance", tile_max_candidates=64,
            ray_casting_cfgs={"N_steps": 8, "N_secant_steps": 3})
CLOSE = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def model():
    """A small NeuMesh on the fused route (the plain versions on the CPU)
    over a jittered 642-vertex icosphere, codes from a numpy seed."""
    from neumesh_tpu_torch.dataio.synthetic import icosphere_mesh
    from neumesh_tpu_torch.mesh.grid import MeshGrid
    from neumesh_tpu_torch.models.neumesh.model import NeuMesh
    mesh = icosphere_mesh(0.5, 3)
    rng = np.random.default_rng(9)
    mesh.vertices = mesh.vertices + rng.normal(size=mesh.vertices.shape) \
        * 2e-3
    mesh.compute_vertex_normals()
    return NeuMesh(MeshGrid(mesh, device="cpu"), device="cpu",
                   use_pallas=True, tile_kp_per_probe=8, **SMALL).init(3)


def rays(n, side=16, half=0.15):
    """n rays from (0, 0, -2.5) over a side x (n / side) fan, one tile a
    row of `side` pixels."""
    h = n // side
    ax, ay = np.meshgrid(np.linspace(-half, half, side, dtype=np.float32),
                         np.linspace(-half, half, h, dtype=np.float32))
    o = np.tile(np.array([[0.0, 0.0, -2.5]], np.float32), (n, 1))
    d = np.stack([ax.ravel(), ay.ravel(), np.ones(n, np.float32)], -1)
    return torch.from_numpy(o), torch.from_numpy(d)


def replicas_on(model, devices):
    from neumesh_tpu_torch.parallel import replicate
    return [model] + [replicate(model, d) for d in devices[1:]]


def assert_dicts_close(got, want):
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], **CLOSE, msg=k)


def test_sharded_volume_render_matches_single_device(model):
    """The volume serving structure (tile contexts, root-anchored samples,
    top-k colour), 4 tiles split over two replicas."""
    from neumesh_tpu_torch.parallel import sharded_volume_render
    from neumesh_tpu_torch.render.volume import volume_render_rays
    o, d = rays(4 * TILE)
    devices = ["cpu", "cpu"]
    with torch.no_grad():
        want = volume_render_rays(model, o, d, **VOL)
        got = sharded_volume_render(replicas_on(model, devices), o, d,
                                    devices, **VOL)
    assert float(want["rgb"].std()) > 1e-3
    assert_dicts_close(got, want)


def test_sharded_surface_render_matches_single_device(model):
    """The surface serving structure (tile contexts, distance scan, fused
    secant), 4 tiles split over two replicas: rgb, depth, hit mask."""
    from neumesh_tpu_torch.parallel import sharded_surface_render
    from neumesh_tpu_torch.render.ray_casting import surface_render
    o, d = rays(4 * TILE)
    devices = ["cpu", "cpu"]
    with torch.no_grad():
        want = surface_render(model, o, d, device="cpu", **SURF)
        got = sharded_surface_render(replicas_on(model, devices), o, d,
                                     devices, **SURF)
    assert 0 < float(want[2]["mask_surface"].float().mean()) < 1
    torch.testing.assert_close(got[0], want[0], **CLOSE)
    torch.testing.assert_close(got[1], want[1], **CLOSE)
    assert torch.equal(got[2]["mask_surface"], want[2]["mask_surface"])
    assert_dicts_close(got[2], want[2])


def test_ragged_ray_count_through_the_cli_padding(model):
    """A 9 x 3 frame (27 rays) over two devices: sharded_volume_render
    refuses its rays; render_image, the CLI's volume entry, edge-pads each
    chunk to a multiple of the device count and returns the 27 rays of the
    direct render, in raster order."""
    from neumesh_tpu_torch.ops.rays import get_rays
    from neumesh_tpu_torch.parallel import sharded_volume_render
    from neumesh_tpu_torch.render.volume import (render_image,
                                                 volume_render_rays)
    from test_torch_basics import camera
    H, W = 3, 9
    c2w, K = camera(H, W)
    o, d = get_rays(torch.from_numpy(c2w), torch.from_numpy(K), H, W)
    kw = dict(N_samples=16, N_importance=8, N_upsample_iters=2,
              detailed_output=False)
    devices = ["cpu", "cpu"]
    with pytest.raises(ValueError, match="not divisible"):
        sharded_volume_render(replicas_on(model, devices), o, d, devices,
                              **kw)
    with torch.no_grad():
        want = volume_render_rays(model, o, d, **kw)
    rgb, depth, ret = render_image(model, c2w, K, H, W, block=(1, W),
                                   rayschunk=10, device="cpu",
                                   replicas=replicas_on(model, devices), **kw)
    assert rgb.shape == (H, W, 3) and bool(torch.isfinite(rgb).all())
    assert 0 < float(want["mask_volume"].mean()) < 1
    torch.testing.assert_close(rgb.reshape(-1, 3), want["rgb"], **CLOSE)
    torch.testing.assert_close(depth.reshape(-1), want["depth_volume"],
                               **CLOSE)


@pytest.mark.parametrize("force", [False, True])
def test_one_device_short_cut_and_force_shard_map(model, force):
    """One device renders directly, or, with force_shard_map, through the
    split and gather at n = 1: the same numbers either way."""
    from neumesh_tpu_torch.parallel import (sharded_surface_render,
                                            sharded_volume_render)
    from neumesh_tpu_torch.render.ray_casting import surface_render
    from neumesh_tpu_torch.render.volume import volume_render_rays
    o, d = rays(2 * TILE)
    with torch.no_grad():
        vol = sharded_volume_render([model], o, d, ["cpu"],
                                    force_shard_map=force, **VOL)
        surf = sharded_surface_render([model], o, d, ["cpu"],
                                      force_shard_map=force, **SURF)
        want_v = volume_render_rays(model, o, d, **VOL)
        want_s = surface_render(model, o, d, device="cpu", **SURF)
    for k in want_v:
        assert torch.equal(vol[k], want_v[k]), k
    for g, w in zip(surf[:2], want_s[:2]):
        assert torch.equal(g, w)
    for k in want_s[2]:
        assert torch.equal(surf[2][k], want_s[2][k]), k


def test_replicate_and_mesh_grid_to_copy_the_tables(model):
    """MeshGrid.to returns a copy whose tables (vertices, normals, the
    candidate grid) are on the target device, the source untouched;
    replicate copies every parameter there, never sharing one. The meta
    device stands in for a second card."""
    from neumesh_tpu_torch.parallel import replicate
    mg = model.mesh_grid
    moved = mg.to("meta")
    assert moved is not mg and moved.device == torch.device("meta")
    tables = [moved.vertices, moved.vertex_normals, moved.grid.cell_row,
              moved.grid.cand_idx, moved.grid.origin, moved.grid.inv_h]
    assert all(t.device.type == "meta" for t in tables)
    assert mg.vertices.device.type == "cpu" and mg.grid.cand_idx.is_cpu
    copy = mg.to("cpu")
    assert copy.vertices.data_ptr() != mg.vertices.data_ptr()
    torch.testing.assert_close(copy.vertices, mg.vertices, rtol=0, atol=0)
    rep = replicate(model, "meta")
    assert rep.device == torch.device("meta")
    assert rep.mesh_grid.vertices.device.type == "meta"
    assert all(p.device.type == "meta" for p in rep.parameters())
    rep_cpu = replicate(model, "cpu")
    for (n, a), b in zip(model.named_parameters(), rep_cpu.parameters()):
        assert a.data_ptr() != b.data_ptr(), n
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=n)


def test_replicate_copies_an_editable_and_its_nested_models(model):
    """A TextureEditableNeuMesh (its device a property of the main model)
    replicated: the main and reference models, their mesh tables and
    every parameter and buffer on the target device, the source
    untouched. The meta device stands in for a second card."""
    from neumesh_tpu_torch.editing.texture_model import TextureEditableNeuMesh
    from neumesh_tpu_torch.parallel import replicate
    masks = np.zeros((1, model.num_vertices), bool)
    masks[0, :100] = True
    editable = TextureEditableNeuMesh(model, [replicate(model, "cpu")], masks,
                                      [np.eye(4)])
    rep = replicate(editable, "meta")
    meta = torch.device("meta")
    assert rep.device == meta
    for m in (rep.main_model, rep.ref_models[0]):
        assert m.device == meta
        assert m.mesh_grid.vertices.device == meta
        assert m.mesh_grid.grid.cand_idx.device == meta
    assert all(t.device == meta for t in rep.parameters())
    assert all(t.device == meta for t in rep.buffers())
    assert editable.device.type == "cpu" and model.device.type == "cpu"
    assert model.mesh_grid.vertices.is_cpu


# ---------------------------------------------------------------------------
# the global masked mean over a gloo pair

_LOSS_WORKER = r"""
import os, sys
sys.path.insert(0, os.environ["NEUMESH_REPO"])
import numpy as np
import torch
torch.set_num_threads(1)
from neumesh_tpu_torch.config import ConfigDict
from neumesh_tpu_torch.parallel import dist
from neumesh_tpu_torch.train.trainer import Trainer

dist.init_env(ConfigDict({"device": "cpu"}))
rank, world = dist.process_index(), dist.process_count()
data = np.load(os.environ["NM_DATA"])
n = data["rgb"].shape[1] // world
sl = slice(rank * n, (rank + 1) * n)


class Model:
    def forward_s(self):
        return torch.tensor(1.0)


rgb = torch.tensor(data["rgb"][:, sl], requires_grad=True)
ret = Trainer(Model(), {"img": 1.0, "mask": 0.1}).compute_loss(
    rgb, torch.tensor(data["target"][:, sl]),
    {"mask_volume": torch.tensor(data["acc"][:, sl])},
    mask=torch.tensor(data["mask"][:, sl]),
    mask_ignore=torch.tensor(data["ignore"][:, sl]))
ret["losses"]["loss_img"].backward()
# the gradient averaging over the ranks (all_reduce_grads) scales each
# rank's contribution by 1 / world
np.savez(os.environ["NM_OUT"] + f"_{rank}.npz",
         loss_img=ret["losses"]["loss_img"].detach().numpy(),
         psnr=ret["extras"]["psnr"].numpy(), grad=rgb.grad.numpy() / world)
dist.shutdown()
print("LOSS_OK")
"""


def test_global_masked_image_loss_matches_jax(tmp_path):
    """Two gloo ranks, each with half of every image's rays: the ranks'
    image-loss terms average to the JAX package's masked mean over the
    concatenated rays, each rank's psnr is the concatenated psnr, and the
    ranks' rgb gradients, averaged as all_reduce_grads averages, are the
    JAX gradient."""
    import jax
    import jax.numpy as jnp
    from neumesh_tpu.train.trainer import Trainer as JTrainer

    rng = np.random.default_rng(4)
    B, N = 2, 24
    data = {"rgb": rng.random((B, N, 3)).astype(np.float32),
            "target": rng.random((B, N, 3)).astype(np.float32),
            "acc": rng.random((B, N)).astype(np.float32),
            # counts that differ between the halves of the rays
            "mask": np.concatenate([rng.random((B, N // 2)) > 0.2,
                                    rng.random((B, N // 2)) > 0.7], 1),
            "ignore": rng.random((B, N)) > 0.1}
    np.savez(tmp_path / "data.npz", **data)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(2):
        env = dict(os.environ, NEUMESH_REPO=REPO,
                   NM_DATA=str(tmp_path / "data.npz"),
                   NM_OUT=str(tmp_path / "out"), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), RANK=str(rank), WORLD_SIZE="2",
                   LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE="2",
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _LOSS_WORKER], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("loss worker timed out:\n" + "\n".join(outs))
    for rank, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "LOSS_OK" in o, f"rank {rank}:\n{o}"

    class JModel:
        def forward_s(self, params):
            return jnp.float32(1.0)

    jt = JTrainer(JModel(), {"img": 1.0, "mask": 0.1})

    def loss_img(rgb):
        ret = jt.compute_loss(
            None, rgb, jnp.asarray(data["target"]),
            {"mask_volume": jnp.asarray(data["acc"])},
            mask=jnp.asarray(data["mask"]),
            mask_ignore=jnp.asarray(data["ignore"]))
        return ret["losses"]["loss_img"], ret["extras"]["psnr"]

    (want, want_psnr), want_grad = jax.value_and_grad(
        loss_img, has_aux=True)(jnp.asarray(data["rgb"]))
    got = [np.load(tmp_path / f"out_{r}.npz") for r in range(2)]
    np.testing.assert_allclose(np.mean([g["loss_img"] for g in got]),
                               float(want), rtol=1e-6)
    for g in got:
        np.testing.assert_allclose(g["psnr"], float(want_psnr), rtol=1e-6)
    np.testing.assert_allclose(
        np.concatenate([g["grad"] for g in got], 1),
        np.asarray(want_grad), rtol=1e-6, atol=1e-9)
