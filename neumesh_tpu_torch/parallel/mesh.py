"""Process grid, replicas and ray-axis sharding (counterpart of
neumesh_tpu/parallel/mesh.py) on torch.distributed.

Training: one process per GPU, the ranks a (batch x data) grid
(ProcessGrid). The batch axis holds one row per host and the images of a
global batch shard over it (make_global_batch); the data axis holds a
host's GPUs and the rays of each image shard over it (ray_sharder). Every
rank draws its random numbers at the global shape and keeps its rows
(ShardedGenerator), computes its losses over global denominators
(global_sum), and all-reduces its gradients (all_reduce_grads): one
update on any grid gives the parameters of one single-process update on
the concatenated global batch.

Serving: one process splits the ray axis over local devices, a replica of
the model on each (replicate), and gathers the shards on the first device
(sharded_surface_render, sharded_volume_render, on the frame layer's
render/frame.py::render_sharded, which the frame entries call directly).
"""
from __future__ import annotations

import copy
from dataclasses import dataclass

import torch
import torch.distributed as tdist

from ..render.frame import render_sharded
from ..render.ray_casting import surface_render
from ..render.volume import volume_render_rays
from . import dist


def get_device_mesh(n_devices: int | None = None, devices=None) -> list:
    """The devices to serve over: `devices` (repeats allowed, e.g. two
    replicas on one card), else the first n_devices of the visible cards
    (default all)."""
    if devices is None:
        count = torch.cuda.device_count()
        n = count if n_devices is None else n_devices
        if not 0 < n <= count:
            raise RuntimeError(f"{n} devices asked for, {count} CUDA "
                               "devices visible")
        devices = [torch.device("cuda", i) for i in range(n)]
    return [torch.device(d) for d in devices]


@dataclass(frozen=True)
class ProcessGrid:
    """The (batch x data) grid of a group's ranks: `batch` hosts of `data`
    ranks each; this rank is at (host, local)."""
    batch: int = 1
    data: int = 1
    host: int = 0
    local: int = 0


def get_global_mesh(split_rays: bool = True) -> ProcessGrid:
    """This process's place in the group's (batch, data) grid: a row per
    host (LOCAL_WORLD_SIZE ranks each), the rank's local index its data
    coordinate. split_rays=False puts every rank on the batch axis (each
    takes whole images). Without a group: the 1 x 1 grid."""
    world, rank = dist.process_count(), dist.process_index()
    data = dist.local_world_size() if split_rays else 1
    if world % data:
        raise ValueError(f"world size {world} is not a multiple of "
                         f"LOCAL_WORLD_SIZE {data}")
    return ProcessGrid(batch=world // data, data=data, host=rank // data,
                       local=rank % data)


def make_global_batch(grid: ProcessGrid, batch: dict) -> dict:
    """This host's rows of a global batch {key: (grid.batch * b, ...)}: the
    stride host * b .. (host + 1) * b of the shared image order."""
    out = {}
    for k, v in batch.items():
        b, rem = divmod(v.shape[0], grid.batch)
        if rem:
            raise ValueError(f"{k}: global batch {v.shape[0]} does not "
                             f"split over {grid.batch} hosts")
        out[k] = v[grid.host * b:(grid.host + 1) * b]
    return out


def ray_sharder(grid: ProcessGrid):
    """n -> this rank's contiguous slice of a ray axis of n rays (the data
    axis splits every image's rays; n must divide)."""
    def shard(n: int) -> slice:
        if n % grid.data:
            raise ValueError(f"{n} rays do not split over {grid.data} "
                             "ranks of the data axis")
        m = n // grid.data
        return slice(grid.local * m, (grid.local + 1) * m)
    return shard


class ShardedGenerator:
    """A torch.Generator whose draws keep the global shape. Every rank
    holds the same generator state and draws each tensor whose leading
    axis carries the batch and ray axes at the global shape, then keeps
    its rows: its host's images and its local slice of their rays. That
    is what one program over the global batch draws, so the rays and
    perturbations of a rank are the concatenated batch's own.

    rays(high, n): n global ray draws (torch.randint(0, high)) -> this
    rank's slice. rand(shape): shape[0] = b * N_local flattened (image,
    ray) rows of this rank -> torch.rand of the global (B * N) rows, this
    rank's rows kept."""

    def __init__(self, generator: torch.Generator, grid: ProcessGrid,
                 batch_size: int):
        self.generator = generator
        self.grid = grid
        self.batch_size = batch_size
        self.shard = ray_sharder(grid)

    def rays(self, high: int, n: int, device) -> torch.Tensor:
        full = torch.randint(0, high, (n,), generator=self.generator,
                             device=device)
        return full[self.shard(n)]

    def rand(self, shape, device) -> torch.Tensor:
        b, g = self.batch_size, self.grid
        n_local, rem = divmod(shape[0], b)
        if rem:
            raise ValueError(f"{shape[0]} rows are not {b} images of rays")
        n = n_local * g.data
        full = torch.rand((g.batch * b * n,) + tuple(shape[1:]),
                          generator=self.generator, device=device)
        img = torch.arange(g.host * b, (g.host + 1) * b, device=device)
        ray = torch.arange(n, device=device)[self.shard(n)]
        rows = (img[:, None] * n + ray[None, :]).reshape(-1)
        return full[rows]


def replicate(model, device):
    """A copy of `model` on `device`: every parameter and buffer copied
    (never shared across devices), each (sub)module's mesh scaffold too
    (MeshGrid.to), every (sub)module's own `device` set; a model that
    holds others (TextureEditableNeuMesh) reads its device from them."""
    dev = torch.device(device)
    memo = {}
    for p in model.parameters():
        memo[id(p)] = torch.nn.Parameter(p.detach().to(dev, copy=True),
                                         requires_grad=p.requires_grad)
    for b in model.buffers():
        memo[id(b)] = b.detach().to(dev, copy=True)
    for m in model.modules():
        grid = getattr(m, "mesh_grid", None)
        if grid is not None:
            memo[id(grid)] = grid.to(dev)
    rep = copy.deepcopy(model, memo)
    for m in rep.modules():
        if "device" in vars(m):
            m.device = dev
    return rep


def sharded_surface_render(replicas, rays_o, rays_d, devices,
                           force_shard_map: bool = False, **surface_kwargs):
    """ray_casting.surface_render over the ray axis of (R, 3) rays: shard
    i (R / n contiguous rays) renders on devices[i] with replicas[i], the
    outputs gathered on devices[0] (render/frame.py::render_sharded). R
    must divide by the device count (and each shard by ray_tile when
    tiling: callers pad). One device renders directly unless
    force_shard_map (the split and gather then run with n = 1). Returns
    what surface_render returns."""
    def render(rep, o, d):
        rgb, depth, extras = surface_render(rep, o, d, device=rep.device,
                                            **surface_kwargs)
        return {"rgb": rgb, "depth": depth, **extras}

    out = render_sharded(render, replicas, rays_o, rays_d, devices,
                         force_shard_map)
    return out.pop("rgb"), out.pop("depth"), out


def sharded_volume_render(replicas, rays_o, rays_d, devices,
                          force_shard_map: bool = False, **volume_kwargs):
    """render/volume.py::volume_render_rays over the ray axis of (R, 3)
    rays, sharded as sharded_surface_render. Serving runs perturb=False;
    a generator would be shared by the shards in turn. Returns
    volume_render_rays' dict."""
    return render_sharded(
        lambda rep, o, d: volume_render_rays(rep, o, d, **volume_kwargs),
        replicas, rays_o, rays_d, devices, force_shard_map)


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the group's ranks, without gradient (loss
    denominators, logged statistics); `t` itself without a group."""
    if not dist.is_initialized():
        return t
    t = t.detach().clone()
    tdist.all_reduce(t, op=tdist.ReduceOp.SUM)
    return t


def broadcast_params(params, src: int = 0) -> None:
    """Copy rank `src`'s values of `params` to every rank, in place (the
    start of data-parallel training: each rank built its own model)."""
    if not dist.is_initialized():
        return
    with torch.no_grad():
        for p in params:
            tdist.broadcast(p.data, src)


def all_reduce_grads(params) -> None:
    """Average the gradients of `params` over the group's ranks, in place:
    one flat buffer (a missing gradient counts as zero), all_reduce(SUM),
    divided by the world size; every parameter then holds its gradient."""
    params = list(params)
    if not params or not dist.is_initialized():
        return
    flat = torch.cat([(p.grad if p.grad is not None
                       else torch.zeros_like(p)).reshape(-1)
                      for p in params])
    tdist.all_reduce(flat, op=tdist.ReduceOp.SUM)
    flat /= dist.process_count()
    for p, g in zip(params, torch.split(flat, [p.numel() for p in params])):
        p.grad = g.view_as(p)


__all__ = ["ProcessGrid", "ShardedGenerator", "all_reduce_grads",
           "broadcast_params", "get_device_mesh", "get_global_mesh",
           "global_sum", "make_global_batch", "ray_sharder", "replicate",
           "sharded_surface_render", "sharded_volume_render"]
