"""Data-parallel training in the port (neumesh_tpu_torch.parallel) on the
CPU: the SLURM helpers against the JAX package's on the inputs of
tests/test_dist.py; live gloo process groups through the port's real
main_function (2 ranks x batch 1, and 2 hosts x 2 local ranks splitting
each image's rays), each update equal to the 1-process update on the
concatenated batch (rtol 2e-5, atol 2e-6, the JAX test's limits) in the
parameters and in Adam's moments (the gradients); and that 1-process
batch-2 step against jax.value_and_grad of the JAX loss.

The config is tests/test_dist.py's (icosphere subdivision 2, W 16, 16
rays a view, the masked image loss), with the warm-up of the schedule at
0 steps so that the one update moves the parameters (at warmup_steps 5
its learning rate is 0). The scene is the synthetic torus scene at 4
views of 20x20 (focal 30): its silhouettes cover part of each view and
differ between views, so the ranks' masked-loss counts differ (the
sphere scene of tests/test_dist.py fills every pixel)."""
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neumesh_tpu.parallel import dist as jdist
from neumesh_tpu_torch.parallel import dist as tdist_helpers
from test_torch_train_step import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("node_list", [
    "nodeA", "nodeA,nodeB", "cluster-[003-010,012]", "node[1,5-7]",
    "gpu-[12]", "nodeA,nodeB[01-05]", "nodeB[01-05],nodeA",
    "n[01-02].cluster,other"])
def test_first_slurm_node_matches_jax(node_list):
    assert (tdist_helpers.first_slurm_node(node_list)
            == jdist.first_slurm_node(node_list))


@pytest.mark.parametrize("env,port", [
    ({"SLURM_PROCID": "3", "SLURM_NTASKS": "8",
      "SLURM_NODELIST": "tpu-host-[004-011]"}, None),
    ({"SLURM_PROCID": "0", "SLURM_NTASKS": "2", "SLURM_NODELIST": "n1,n2",
      "MASTER_PORT": "4444"}, None),
    ({"SLURM_PROCID": "0", "SLURM_NTASKS": "2", "SLURM_NODELIST": "n1,n2",
      "MASTER_PORT": "4444"}, 5555),
    ({}, None),
    ({"SLURM_PROCID": "0"}, None)])
def test_slurm_coordinator_spec_matches_jax(env, port):
    assert (tdist_helpers.slurm_coordinator_spec(env, port=port)
            == jdist.slurm_coordinator_spec(env, port=port))


def test_process_env_torchrun_then_slurm():
    """torchrun's variables win; SLURM's are synthesised with the local
    rank and the tasks of a node; neither: no group."""
    env = {"MASTER_ADDR": "h0", "MASTER_PORT": "29500", "RANK": "5",
           "WORLD_SIZE": "8", "LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "4",
           "SLURM_PROCID": "0", "SLURM_NTASKS": "2", "SLURM_NODELIST": "n1"}
    spec, synthesised = tdist_helpers.process_env(env, port=7)
    assert not synthesised
    assert spec == {"MASTER_ADDR": "h0", "MASTER_PORT": 29500, "RANK": 5,
                    "WORLD_SIZE": 8, "LOCAL_RANK": 1, "LOCAL_WORLD_SIZE": 4}
    slurm = {"SLURM_PROCID": "6", "SLURM_NTASKS": "8", "SLURM_LOCALID": "2",
             "SLURM_TASKS_PER_NODE": "4(x2)", "SLURM_NODELIST": "g[07-08]"}
    spec, synthesised = tdist_helpers.process_env(slurm, port=5555)
    assert synthesised
    assert spec == {"MASTER_ADDR": "g07", "MASTER_PORT": 5555, "RANK": 6,
                    "WORLD_SIZE": 8, "LOCAL_RANK": 2, "LOCAL_WORLD_SIZE": 4}
    assert tdist_helpers.process_env({}) is None


def test_grid_batch_and_draws_without_a_group():
    """One process: the 1 x 1 grid, the whole batch, the plain draws."""
    from neumesh_tpu_torch.parallel import (ShardedGenerator,
                                            get_global_mesh,
                                            make_global_batch)
    from neumesh_tpu_torch.ops.rays import rand
    grid = get_global_mesh()
    assert (grid.batch, grid.data, grid.host, grid.local) == (1, 1, 0, 0)
    x = np.arange(6).reshape(2, 3)
    np.testing.assert_array_equal(make_global_batch(grid, {"x": x})["x"], x)
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    torch.testing.assert_close(
        rand((10, 4), ShardedGenerator(g1, grid, 2), "cpu"),
        torch.rand((10, 4), generator=g2), rtol=0, atol=0)


@pytest.mark.parametrize("batch,data", [(2, 1), (1, 2), (2, 2)])
def test_sharded_draws_are_the_global_draws_rows(batch, data):
    """Every rank of a (batch x data) grid draws the global tensor and
    keeps its rows: the ranks' rows put back together are the draw of one
    process over the global batch (2 images a host, 8 rays an image)."""
    from neumesh_tpu_torch.parallel import ProcessGrid, ShardedGenerator
    from neumesh_tpu_torch.ops.rays import rand
    b, n, s = 2, 8, 5
    want = torch.rand((batch * b, n, s),
                      generator=torch.Generator().manual_seed(1))
    want_rays = torch.randint(0, 20, (n,),
                              generator=torch.Generator().manual_seed(2))
    for host in range(batch):
        for local in range(data):
            grid = ProcessGrid(batch, data, host, local)
            m = n // data
            got = rand((b * m, s), ShardedGenerator(
                torch.Generator().manual_seed(1), grid, b), "cpu")
            torch.testing.assert_close(
                got.reshape(b, m, s),
                want[host * b:(host + 1) * b, local * m:(local + 1) * m],
                rtol=0, atol=0)
            rays = ShardedGenerator(torch.Generator().manual_seed(2), grid,
                                    b).rays(20, n, "cpu")
            torch.testing.assert_close(
                rays, want_rays[local * m:(local + 1) * m], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# live gloo groups through main_function

_WORKER = r"""
import os, sys
sys.path.insert(0, os.environ["NEUMESH_REPO"])
import numpy as np
import torch
torch.set_num_threads(1)
from neumesh_tpu_torch.config import ConfigDict
from neumesh_tpu_torch.train.loop import main_function

rank = int(os.environ.get("RANK", 0))
args = ConfigDict({
    "expname": "nm_dp", "device": "cpu",
    "data": {"type": "DTU", "data_dir": os.environ["NM_SCENE"],
             "downscale": 1, "N_rays": 16,
             "batch_size": int(os.environ["NM_BATCH"]),
             "val_downscale": 4.0, "val_rayschunk": 64,
             "obj_bounding_radius": 1.0},
    "model": {"framework": "NeuMesh", "prior_mesh": os.environ["NM_MESH"],
              "distance_method": "grid", "D_density": 2, "D_color": 2,
              "W": 16, "geometry_dim": 4, "color_dim": 4, "multires_d": 2,
              "multires_fg": 1, "multires_ft": 1, "multires_view": 1,
              "bounded_near_far": False, "enable_nablas_input": True,
              "learn_indicator_weight": True, "N_upsample_iters": 1,
              "N_samples": 12, "use_pallas": False},
    "training": {"speed_factor": 10.0, "lr": 1e-2,
                 "num_iters": int(os.environ["NM_ITERS"]),
                 "scheduler": {"type": "warmupcosine", "warmup_steps": 0},
                 "loss_weights": {"img": 1.0, "mask": 0.1, "eikonal": 0.1,
                                  "distill_density": 0.0,
                                  "distill_color": 0.0,
                                  "indicator_reg": 0.01},
                 "log_root_dir": os.environ["NM_LOGS"],
                 "i_val": -1, "i_backup": -1, "i_save": 10000,
                 "i_log": 1, "monitoring": "none"},
})
out = main_function(args)
assert out["it"] == int(os.environ["NM_ITERS"]), out["it"]
if rank == 0:
    opt = out["optimizer"]
    assert opt.count == 1, opt.count
    arrays = {}
    for name, p in out["model"].named_parameters():
        arrays["p:" + name] = p.detach().numpy()
        arrays["mu:" + name] = opt.mu[name].numpy()
        arrays["nu:" + name] = opt.nu[name].numpy()
    np.savez(os.environ["NM_OUT"], **arrays)
    print("TRAIN_OK", len(arrays))
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_dp_train(scene, mesh_path, out, logs, hosts, local, batch_size):
    """hosts x local live worker processes (one without a group when both
    are 1) through the real main_function; num_iters is the batch axis's
    size, so each run takes exactly one optimizer update."""
    world = hosts * local
    port = _free_port()
    procs = []
    for rank in range(world):
        env = {k: v for k, v in os.environ.items()
               if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                            "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                            "MASTER_PORT", "SLURM_PROCID",
                            "SLURM_NODELIST")}
        env.update({"NEUMESH_REPO": REPO, "NM_SCENE": str(scene),
                    "NM_MESH": str(mesh_path), "NM_OUT": str(out),
                    "NM_LOGS": str(logs), "NM_BATCH": str(batch_size),
                    "NM_ITERS": str(hosts), "OMP_NUM_THREADS": "1"})
        if world > 1:
            env.update({"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                        "RANK": str(rank), "WORLD_SIZE": str(world),
                        "LOCAL_RANK": str(rank % local),
                        "LOCAL_WORLD_SIZE": str(local)})
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER], env=env, cwd=str(logs.parent),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("train worker timed out:\n" + "\n".join(outs))
    for rank, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{o[-3000:]}"
    assert "TRAIN_OK" in outs[0], outs[0][-2000:]


@pytest.fixture(scope="module")
def dp_scene(tmp_path_factory):
    """The scene, the prior mesh and the 1-process update on the
    concatenated 2-image batch."""
    from neumesh_tpu_torch.dataio.dtu import load_mask
    from neumesh_tpu_torch.dataio.synthetic import (generate_torus_scene,
                                                    icosphere_mesh)
    from neumesh_tpu_torch.mesh.triangle_mesh import save_ply
    root = tmp_path_factory.mktemp("tdp")
    scene = root / "scene"
    generate_torus_scene(str(scene), n_views=4, H=20, W=20, focal=30.0)
    masks = [load_mask(str(p)) for p in sorted((scene / "mask").iterdir())]
    # partial silhouettes that differ between views: the masked image loss
    # divides by counts that differ between the ranks
    assert len({int(m.sum()) for m in masks}) > 1
    assert all(0 < m.mean() < 1 for m in masks)
    mesh_path = root / "prior.ply"
    save_ply(icosphere_mesh(radius=0.5, subdivisions=2), str(mesh_path))
    single = root / "single.npz"
    _run_dp_train(scene, mesh_path, single, root / "logs_single", 1, 1, 2)
    return {"root": root, "scene": scene, "mesh_path": mesh_path,
            "single": single}


def _assert_update_matches(got, want, what):
    a, b = np.load(got), np.load(want)
    assert set(a.files) == set(b.files) and len(a.files) > 0
    moved = 0
    for k in a.files:
        np.testing.assert_allclose(
            a[k], b[k], rtol=2e-5, atol=2e-6,
            err_msg=f"{k}: {what} vs the 1-process concatenated batch")
        if k.startswith("mu:"):
            moved += int(np.abs(b[k]).max() > 0)
    # the update reached the codes, the MLPs and the indicator parameters
    assert moved >= 10, moved


@pytest.mark.parametrize("hosts,local", [(2, 1), (2, 2)],
                         ids=["2ranks_batch1", "2hosts_x_2local"])
def test_live_gloo_update_matches_concatenated_batch(dp_scene, hosts,
                                                     local):
    """One update of `hosts` x `local` gloo ranks (batch 1 a host; with
    local > 1 each image's 16 rays split over the host's ranks) equals
    the 1-process batch-2 update: the parameters, Adam's first moments
    (the averaged gradient) and second moments."""
    out = dp_scene["root"] / f"dp_{hosts}x{local}.npz"
    _run_dp_train(dp_scene["scene"], dp_scene["mesh_path"], out,
                  dp_scene["root"] / f"logs_{hosts}x{local}", hosts, local,
                  1)
    _assert_update_matches(out, dp_scene["single"],
                           f"{hosts} hosts x {local} local ranks")


# ---------------------------------------------------------------------------
# the 1-process batch-2 step against the JAX loss

def test_batch2_step_matches_jax_value_and_grad():
    """The concatenated-batch step the DP runs are held to: two views,
    every loss term and every parameter gradient of a tiny NeuMesh against
    jax.value_and_grad of the JAX loss at "highest" (the student's ln_s a
    copy of the teacher's, the JAX package's select_inds, perturb off)."""
    from neumesh_tpu.nn import f32_matmul_precision
    from neumesh_tpu.ops.rays import get_rays as jax_get_rays
    from neumesh_tpu.train.trainer import Trainer as JTrainer
    from neumesh_tpu_torch.train.trainer import Trainer
    from test_torch_basics import camera, small_scene
    from test_torch_train_step import (H, LOSS_W, N_RAYS, RENDER, W,
                                       assert_close, grads_tree,
                                       tiny_teacher)

    jm, jparams, tm = small_scene(seed=3, subdivisions=3, jitter=2e-3)
    jm.use_pallas = tm.use_pallas = False
    jn, jtp, tn = tiny_teacher()
    jparams["ln_s"] = jnp.array(np.asarray(jtp["ln_s"]))
    with torch.no_grad():
        tm.ln_s.copy_(tn.ln_s)
    rng = np.random.default_rng(11)
    c2w, K = camera(H, W)
    c2w2 = c2w.copy()
    c2w2[0, 3] += 0.15
    K4 = np.eye(4, dtype=np.float32)
    K4[:3, :3] = K
    mi = {"c2w": np.stack([c2w, c2w2]), "intrinsics": np.stack([K4, K4]),
          "object_mask": rng.random((2, H * W)) > 0.4}
    gt = {"rgb": rng.random((2, H * W, 3)).astype(np.float32)}
    key = jax.random.PRNGKey(8)
    k_rays, _ = jax.random.split(key)
    _, _, sel = jax_get_rays(jnp.asarray(mi["c2w"]),
                             jnp.asarray(mi["intrinsics"]), H, W,
                             N_rays=N_RAYS, key=k_rays)
    sel = np.asarray(sel)
    assert (sel[0] == sel[1]).all()       # shared by the batch's views

    jt = JTrainer(jm, dict(LOSS_W), teacher_model=jn)

    def loss_fn(p):
        with f32_matmul_precision("highest"):
            ret = jt.render_and_loss(
                p, {k: jnp.asarray(v) for k, v in mi.items()},
                {k: jnp.asarray(v) for k, v in gt.items()}, key,
                dict(RENDER), N_RAYS, H, W, teacher_params=jtp)
        return ret["losses"]["total"], ret["losses"]

    (_, want_losses), want = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(jparams)
    want = jax.tree.map(np.asarray, want)

    tt = Trainer(tm, dict(LOSS_W), teacher_model=tn)
    tm.requires_grad_(True)
    ret = tt.render_and_loss(
        {k: torch.from_numpy(np.asarray(v)) for k, v in mi.items()},
        {k: torch.from_numpy(v) for k, v in gt.items()}, dict(RENDER),
        N_RAYS, H, W, select_inds=torch.from_numpy(sel[0].copy()))
    ret["losses"]["total"].backward()
    assert set(ret["losses"]) == set(want_losses)
    for k, v in want_losses.items():
        g = float(ret["losses"][k].detach())
        assert abs(g - float(v)) <= 2e-5 + 1e-4 * abs(float(v)), (k, g, v)
    got = grads_tree(tm)
    n = 0
    for key_, w in want.items():
        items = (enumerate(w) if isinstance(w, list) else
                 [(None, w)])
        for i, wl in items:
            gl = got[key_] if i is None else got[key_][i]
            if isinstance(wl, dict):
                for k in wl:
                    assert_close(f"{key_}[{i}].{k}", gl[k], wl[k])
                    n += 1
            else:
                assert_close(key_, gl, wl)
                n += 1
    assert n >= 15
