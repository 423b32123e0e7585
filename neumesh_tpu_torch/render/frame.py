"""The frame layer under the two frame entries (volume.py::render_image,
ray_casting.py::render_surface_image), the one code path that renders a
whole frame: camera rays in pixel-block order built on the device
(frame_rays) -> chunks, the last edge-padded (render_chunks) -> each
chunk split over the model's replicas and gathered on the first
(render_sharded) -> raster order (render_frame). parallel.mesh's sharded
renders split their rays here too."""
from __future__ import annotations

import torch

from .. import resolve_device, set_fp32_precision
from ..ops.rays import block_order, get_rays, raster_order
from ..utils.trace import count, span


def render_device(model, device) -> torch.device:
    """`device` resolved, refused unless the model lives there; on a card
    matmuls in true f32."""
    dev = resolve_device(device)
    if model.device.type != dev.type:
        raise ValueError(f"model on {model.device}, device={dev}")
    if dev.type == "cuda":
        set_fp32_precision()
    return dev


def frame_rays(model, c2w, K, H: int, W: int, block, device):
    """A frame entry's host work, all of it before the frame's first
    launch: c2w and K copied from pageable host memory, w1 read back once
    for every binding of the frame (None where they do not use it), then
    the rays of the H x W pixels in block_h x block_w block order, built on
    the device. The contexts' dims are the frame's only later host read.
    Returns (rays_o, rays_d (H*W, 3), w1)."""
    count("host_read", 2)
    c2w = torch.as_tensor(c2w, dtype=torch.float32).to(device)
    K = torch.as_tensor(K, dtype=torch.float32).to(device)
    w1 = getattr(model, "frame_indicator_weight", lambda: None)()
    rays_o, rays_d, _ = get_rays(c2w, K, H, W,
                                 select_inds=block_order(H, W, *block,
                                                         device))
    return rays_o, rays_d, w1


def render_chunks(render, rays_o, rays_d, rayschunk: int = 0,
                  quantum: int = 1) -> dict:
    """render(o, d) -> {name: (c, ...)} over (n, 3) rays in chunks of
    rayschunk rays (0, or more than n: all of them) rounded up to a
    multiple of `quantum`, the last chunk edge-padded; each output's rows
    concatenated and cut to n."""
    n = rays_o.shape[0]
    chunk = -(-min(rayschunk or n, n) // quantum) * quantum
    pad = (-n) % chunk
    if pad:
        rays_o = torch.cat([rays_o, rays_o[-1:].expand(pad, 3)], 0)
        rays_d = torch.cat([rays_d, rays_d[-1:].expand(pad, 3)], 0)
    outs = [render(rays_o[i:i + chunk], rays_d[i:i + chunk])
            for i in range(0, n + pad, chunk)]
    with span("render.assemble"):
        return {k: torch.cat([o[k] for o in outs], 0)[:n] for k in outs[0]}


def render_sharded(render, replicas, rays_o, rays_d, devices,
                   force_shard_map: bool = False) -> dict:
    """render(replica, o, d) -> {name: (r, ...)} over the ray axis of
    (R, 3) rays: shard i (R / n contiguous rays) renders on devices[i]
    with replicas[i], the outputs gathered on devices[0]. R must divide
    by the device count (render_frame pads its chunks). One device
    renders directly unless force_shard_map (the split and gather then
    run with n = 1)."""
    devices = [torch.device(d) for d in devices]
    if len(replicas) != len(devices):
        raise ValueError(f"{len(replicas)} replicas for {len(devices)} "
                         "devices")
    n_dev = len(devices)
    if n_dev == 1 and not force_shard_map:
        return render(replicas[0], rays_o, rays_d)
    n = rays_o.shape[0]
    if n % n_dev:
        raise ValueError(f"ray count {n} not divisible by {n_dev} devices; "
                         "pad the ray batch (the frame entries pad chunks)")
    m = n // n_dev
    outs = [render(rep, rays_o[i * m:(i + 1) * m].to(dev),
                   rays_d[i * m:(i + 1) * m].to(dev))
            for i, (rep, dev) in enumerate(zip(replicas, devices))]
    return {k: torch.cat([o[k].to(devices[0]) for o in outs], 0)
            for k in outs[0]}


def render_frame(model, c2w, K, H: int, W: int, block, device, replicas,
                 rayschunk: int, ray_tile: int, render,
                 rays_output: bool = False,
                 force_shard_map: bool = False) -> dict:
    """The frame entries' body: camera rays in block_h x block_w block
    order (frame_rays) -> chunks of a multiple of len(replicas) x
    max(ray_tile, 1) rays (render_chunks), each split over the replicas
    (render_sharded) and rendered by render(replica, o, d, w1) ->
    {name: (c, ...)} -> raster order. replicas: the model and its copies
    on further devices (parallel.replicate); None, the model alone
    (force_shard_map: split and gathered all the same). rays_output adds
    the camera rays, "rays_o" and "rays_d". Returns {name: (H, W, ...)}."""
    dev = render_device(model, device)
    replicas = list(replicas or [model])
    devices = [r.device for r in replicas]
    with span("render.rays"):
        rays_o, rays_d, w1 = frame_rays(model, c2w, K, H, W, block, dev)
    out = render_chunks(
        lambda o, d: render_sharded(
            lambda rep, o, d: render(rep, o, d, w1), replicas, o, d,
            devices, force_shard_map),
        rays_o, rays_d, rayschunk, len(replicas) * max(ray_tile, 1))
    if rays_output:
        out.update(rays_o=rays_o, rays_d=rays_d)
    with span("render.assemble"):
        return {k: raster_order(v, H, W, *block) for k, v in out.items()}
