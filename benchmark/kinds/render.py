"""Frames back to back along a camera path: the render traffic kind.

Set-up builds the configuration's NeuMesh on the benchmark's icosphere with
weights from the seed and warms the frame's shapes up. The window renders
frames along the render CLI's spiral path, from a view the seed picks, each
frame ending with its outputs on the host. Which pixels the check compares
is drawn from the seed before the window: one frame out of each run of
check["every"] frames, check["per_frame"] pixels of it. Of a drawn frame
the window keeps those pixels' outputs and, on the host, the candidate ids
of their tile contexts; of the others nothing. The check renders
check["rays"] of the kept pixels again with the plain reference, each ray
bound to the candidate ids its tile was bound to, and reads how often
those ids miss a point's nearest vertices of the whole mesh, found by
brute force. traffic["structure"] is
"volume" (the frame entry render/volume.py::render_image) or "surface"
(render/ray_casting.py::render_surface_image).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import scene, weights
from ..reference import surface as ref_surface
from ..reference import volume as ref_volume
from ..reference.neumesh import NeuMeshField
from . import log

# runs of check["every"] frames that a window can draw a frame from
BLOCKS = 1024


class Render:
    def __init__(self, cfg, traffic, seed, device, check=None):
        from neumesh_tpu_torch.mesh.grid import MeshGrid
        from neumesh_tpu_torch.mesh.triangle_mesh import TriangleMesh
        from neumesh_tpu_torch.models.neumesh import model as nm_model
        from neumesh_tpu_torch.render import ray_casting, volume

        self.cfg, self.t = cfg, traffic
        self.seed, self.device = seed, device
        self.surface = traffic["structure"] == "surface"
        mesh = cfg["mesh"]
        v, f = scene.icosphere(mesh["radius"], mesh["subdivisions"])
        self.mesh_grid = MeshGrid(TriangleMesh(v, f), device=device)
        log(f"mesh and candidate grid: {len(v)} vertices")
        knobs = dict(cfg["model"], **traffic.get("model", {}))
        dtype = knobs.pop("compute_dtype", None)
        self.model = nm_model.NeuMesh(
            self.mesh_grid, device=device, speed_factor=cfg["speed_factor"],
            compute_dtype=None if dtype is None else getattr(torch, dtype),
            **knobs)
        self.ref_weights = weights.neumesh(
            self.model, torch.as_tensor(v, dtype=torch.float32,
                                        device=device), seed, cfg["ln_s"])
        log("model and weights")
        cam = traffic["cameras"]
        poses, K = scene.dtu_cameras(cam)
        self.path = scene.spiral_path(poses, traffic["path_views"])
        self.K = scene.scaled_intrinsics(K, traffic["downscale"])
        self.H = int(cam["H"] / traffic["downscale"])
        self.W = int(cam["W"] / traffic["downscale"])
        self.first_view = seed % len(self.path)
        self.r = traffic["render"]
        if self.surface:
            self.render_fn = ray_casting.render_surface_image
            self.kwargs = dict(self.r)
        else:
            self.render_fn = volume.render_image
            self.kwargs = dict(self.r, block=tuple(traffic["block"]))
        self._plan(check or {})
        self._orig = make = nm_model.NeuMesh.make_tile_context
        self._bound = []    # ids of the tile contexts a frame binds

        def recorded(model, *a, **kw):
            ctx = make(model, *a, **kw)
            self._bound.append(ctx["ids"])
            return ctx
        nm_model.NeuMesh.make_tile_context = recorded
        self.views, self.kept = [], []
        for i in range(traffic["warmup_frames"]):
            self.frame(self.first_view + i)
        log(f"{traffic['warmup_frames']} warm-up frames")

    def _plan(self, check):
        """The window's sample, from the seed: in each run of `every`
        frames the frame drawn, and its pixels with their tiles."""
        self.every = check.get("every", 1)
        per = check.get("per_frame", 0)
        rng = np.random.default_rng([self.seed, 17])
        self.pick = rng.integers(self.every, size=BLOCKS)
        self.pix = rng.integers(self.H * self.W, size=(BLOCKS, per))
        perm = _block_order(self.H, self.W, *self.t["block"])
        inv = np.empty_like(perm)
        inv[perm] = np.arange(perm.size)
        self.pix_tile = inv[self.pix] // self.r["ray_tile"]
        self.pix_tile_dev = torch.as_tensor(self.pix_tile,
                                            device=self.device)
        self.sentinel = self.ref_weights["vertices"].shape[0]

    def frame(self, view: int):
        """One frame; its outputs on the host (rgb, depth and the surface's
        normals and hit mask)."""
        self._bound = []
        view %= len(self.path)
        rgb, depth, extras = self.render_fn(
            self.model, self.path[view], self.K, self.H, self.W,
            device=self.device, **self.kwargs)
        out = {"rgb": rgb.cpu(), "depth": depth.cpu()}
        if self.surface:
            out["normal"] = extras["normals_surface"].cpu()
            out["mask"] = extras["mask_surface"].cpu()
        return out

    def _keep(self, n: int, view: int, out: dict):
        """Keep the drawn pixels of the window's n-th frame, if drawn."""
        b = n // self.every
        if b >= BLOCKS or n % self.every != self.pick[b]:
            return
        pix = self.pix[b]
        C = max(t.shape[1] for t in self._bound)
        # every chunk is a whole number of tiles: the frame's tiles in
        # order, padded with the missing-vertex id to one width
        ids = torch.cat([torch.nn.functional.pad(
            t, (0, C - t.shape[1]), value=self.sentinel)
            for t in self._bound])
        self.kept.append((view, pix, self.pix_tile[b], {
            k: v.reshape(self.H * self.W, -1)[pix] for k, v in out.items()},
            ids[self.pix_tile_dev[b]].to(torch.int32).cpu()))

    def rays_per_frame(self) -> int:
        return self.H * self.W

    def window(self, seconds: float, limit: int = 0):
        """Frames back to back until `seconds` have passed (or `limit`
        frames): [(start, end)] host times, each frame ending on the
        host."""
        times = []
        self.views, self.kept = [], []
        t_end = time.perf_counter() + seconds
        view = self.first_view
        while True:
            t0 = time.perf_counter()
            out = self.frame(view)
            times.append((t0, time.perf_counter()))
            self._keep(len(self.views), view % len(self.path), out)
            self.views.append(view % len(self.path))
            view += 1
            if (limit and len(times) >= limit) or (
                    not limit and times[-1][1] >= t_end):
                return times

    def end_to_end(self, times) -> dict:
        lat = np.array([b - a for a, b in times])
        span = times[-1][1] - times[0][0]
        return {"render_mrays": len(times) * self.rays_per_frame()
                / span / 1e6,
                "frame_ms_p95": float(np.percentile(lat * 1e3, 95))}

    def model_flops(self, work) -> float:
        """Model FLOPs of the window's frames (work: the yardstick)."""
        per_ray = (work.surface_ray_flops if self.surface
                   else work.volume_ray_flops)(self.cfg["model"], self.r)
        K = torch.as_tensor(self.K, dtype=torch.float32)
        total = 0.0
        for view in self.views:
            o, d = scene.pixel_rays(
                torch.as_tensor(self.path[view], dtype=torch.float32), K,
                torch.arange(self.H * self.W), self.W)
            total += per_ray * int(scene.hits_sphere(
                o, d, self.r["obj_bounding_radius"]).sum())
        return total

    def release(self):
        from neumesh_tpu_torch.models.neumesh import model as nm_model
        nm_model.NeuMesh.make_tile_context = self._orig
        self.model = self.mesh_grid = None

    def _sample(self, check):
        """check["rays"] of the kept pixels, drawn from the seed: their
        rays, the program's outputs, the candidate ids each ray was bound
        to and the tile each lies in."""
        dev = self.device
        K = torch.as_tensor(self.K, dtype=torch.float32, device=dev)
        os_, ds, tiles, ids, got = [], [], [], [], []
        C = max(k[4].shape[1] for k in self.kept)
        for view, pix, tile, outs, cand in self.kept:
            c2w = torch.as_tensor(self.path[view], dtype=torch.float32,
                                  device=dev)
            o, d = scene.pixel_rays(c2w, K, torch.as_tensor(pix, device=dev),
                                    self.W)
            os_.append(o)
            ds.append(d)
            tiles.append(torch.as_tensor(tile))
            ids.append(torch.nn.functional.pad(
                cand.to(torch.int64), (0, C - cand.shape[1]),
                value=self.sentinel))
            got.append(outs)
        n = sum(len(t) for t in tiles)
        take = torch.as_tensor(np.sort(np.random.default_rng(
            [self.seed, 19]).choice(n, min(n, check["rays"]),
                                    replace=False)))
        return {"o": torch.cat(os_)[take.to(dev)],
                "d": torch.cat(ds)[take.to(dev)],
                "ids": torch.cat(ids)[take].to(dev),
                "tile": torch.cat(tiles)[take],
                "got": {k: torch.cat([g[k] for g in got])[take]
                        for k in got[0]}}

    def reference(self, check, mode="f32", ids=None):
        """{output: (n, ...)} of the sample by the plain reference at
        `mode`, in blocks of rays (ids: the candidate ids, by default
        those the program bound)."""
        field = self._field(mode)
        render = (ref_surface.render_rays if self.surface
                  else ref_volume.render_rays)
        s = self.sample
        ids = s["ids"] if ids is None else ids
        parts = []
        for a in range(0, len(ids), check["block_rays"]):
            b = slice(a, a + check["block_rays"])
            got = render(field, s["o"][b], s["d"][b], ids[b], self.r)
            parts.append([g.cpu() for g in got])
        names = (["rgb", "depth", "normal", "mask"] if self.surface
                 else ["rgb", "depth", "acc"])
        return {k: torch.cat([p[i] for p in parts]).reshape(
            -1, 3 if k in ("rgb", "normal") else 1)
            for i, k in enumerate(names)}

    def _field(self, mode):
        """The reference field at `mode`; "<mode>-sel" keeps the
        configuration's f32_layers in float32."""
        mode, sel, _ = mode.partition("-sel")
        return NeuMeshField(self.ref_weights, self.cfg["model"]
                            | {"speed_factor": self.cfg["speed_factor"]},
                            mode, self.cfg["model"]["f32_layers"] if sel
                            else ())

    def program(self):
        return self.sample["got"]

    def check(self, check: dict) -> dict:
        """Numbers of the program's sampled pixels against the reference,
        and of the candidate ids against a brute-force kNN."""
        self.sample = self._sample(check)
        self.ref = self.reference(check)
        self.knn = self.knn_miss_shares(check)
        return self.numbers(self.program(), check)

    def numbers(self, got, check, knn=None, ref=None) -> dict:
        """Numbers of outputs `got` of the sample against the reference
        (after check; or `ref`), with the kNN shares of the ids they were
        bound to."""
        knn = self.knn if knn is None else knn
        return dict(render_numbers(got, self.ref if ref is None else ref,
                                   check),
                    knn_miss_share=knn[0], nn_miss_share=knn[1])

    def knn_miss_shares(self, check, ids=None):
        """Shares of the points where the sampled rays first pass the mesh
        whose NeuMeshField.K nearest candidates, and whose nearest
        candidate, are not their nearest vertices of the whole mesh (nan
        where no sampled ray passes it). Those points are the feet on each
        ray of the check["knn_points"] vertices within check["knn_band"]
        of it that lie first along it."""
        s = self.sample
        ids = s["ids"] if ids is None else ids
        verts = self.ref_weights["vertices"]
        x, ok = near_mesh_points(verts, s["o"], s["d"], check["knn_band"],
                                 check["knn_points"])
        if not bool(ok.any()):
            return float("nan"), float("nan")
        return knn_miss_shares(verts, ids, x, ok, NeuMeshField.K)

    def control(self, check: dict, mode: str, fault=None) -> dict:
        """Numbers (after check) of the reference at `mode` put in the
        program's place, or of a planted fault: "tile_lost" and
        "tile_scaled" take the program's outputs with one tile in ten lost
        (black, no hit) or its colour x 1.01; "cand_half" binds every ray
        to every other of its candidates, reference and kNN alike."""
        if fault in ("tile_lost", "tile_scaled"):
            got = {k: v.clone() for k, v in self.program().items()}
            bad = self.sample["tile"] % 10 == 0
            if fault == "tile_scaled":
                got["rgb"][bad] *= 1.01
            else:
                for k in got:
                    got[k][bad] = 0
            return self.numbers(got, check)
        if fault is None:
            return self.numbers(self.reference(check, mode), check)
        if fault != "cand_half":
            raise ValueError(f"unknown fault {fault!r}")
        ids = self.sample["ids"].clone()
        ids[:, 1::2] = self.sentinel
        return self.numbers(self.reference(check, mode, ids), check,
                            self.knn_miss_shares(check, ids))


def render_numbers(got, ref, check) -> dict:
    """Over the sampled rays that both sides hit (every ray of the volume):
    the median and 90th percentile of each output's largest channel gap
    (rgb, depth and the surface's unit normals). Over every sampled ray,
    where a lost hit shows as a colour against black: the 99th percentile
    and the largest rgb gap and the share of rays whose rgb gap passes each
    of check["bad_rgb"]; the surface's share of rays whose hit mask differs
    and `no_hits`, 1 where either side hit none of them."""
    out = {}
    both = torch.ones(ref["rgb"].shape[0], dtype=torch.bool)
    if "mask" in ref:
        gm, rm = got["mask"][:, 0].bool(), ref["mask"][:, 0].bool()
        out["mask_share"] = float((gm != rm).float().mean())
        out["no_hits"] = float(not (gm.any() and rm.any()))
        both = gm & rm
    for k in ("rgb", "depth", "normal"):
        if k in ref:
            e = torch.amax(torch.abs(got[k].float() - ref[k].float()),
                           -1)[both].numpy()
            out[f"{k}_p50"] = float(np.median(e)) if e.size else 0.0
            out[f"{k}_p90"] = float(np.percentile(e, 90)) if e.size else 0.0
    e = torch.amax(torch.abs(got["rgb"].float() - ref["rgb"]), -1).numpy()
    out["rgb_p99"] = float(np.percentile(e, 99))
    out["rgb_max"] = float(e.max())
    for t in check["bad_rgb"]:
        out[f"rgb_over_{t:g}"] = float(np.mean(e > t))
    return out


def near_mesh_points(verts, o, d, band: float, m: int, block: int = 64):
    """Points (R, m, 3) where rays o + t d (R, 3) first pass the mesh: the
    feet on each ray of the m vertices (V, 3) within `band` of it that lie
    nearest its origin along it (t > 0), and which of them are there
    (R, m)."""
    xs, oks = [], []
    for a in range(0, len(o), block):
        ob, db = o[a:a + block], d[a:a + block]
        db = db / torch.linalg.vector_norm(db, dim=-1, keepdim=True)
        ov = verts[None] - ob[:, None]                        # (r, V, 3)
        t = torch.sum(ov * db[:, None], -1)
        d2 = torch.sum(ov * ov, -1) - t * t
        key = torch.where((t > 0) & (d2 < band * band), t,
                          torch.full_like(t, float("inf")))
        first = torch.topk(key, min(m, len(verts)), -1, largest=False)
        tt = torch.gather(t, -1, first.indices)
        xs.append(ob[:, None] + tt[..., None] * db[:, None])
        oks.append(torch.isfinite(first.values))
    return torch.cat(xs), torch.cat(oks)


def knn_miss_shares(verts, ids, x, ok, k: int, block: int = 1024):
    """Shares of the points x (R, P, 3) where ok (R, P) whose k-th, and
    whose first, nearest vertex among the candidate ids (R, C) of their
    ray (missing-vertex id len(verts)) lies farther than the k-th (the
    first) nearest of all vertices (V, 3). Distances are exact float32
    differences on both sides; the whole mesh is first cut to each point's
    4k nearest by a matrix product, which float32 rounding cannot reorder
    by more than that margin."""
    P = x.shape[1]
    vpad = torch.cat([verts, verts.new_full((1, 3), 1e9)])
    vv = torch.sum(verts * verts, -1)
    miss = torch.zeros(2, dtype=torch.int64)
    step = max(1, block // P)
    for a in range(0, x.shape[0], step):
        xb, okb = x[a:a + step], ok[a:a + step].reshape(-1)
        cand = vpad[ids[a:a + len(xb)]]                       # (r, C, 3)
        d2c = torch.sum((xb[:, :, None, :] - cand[:, None]) ** 2, -1)
        kc = torch.topk(d2c, k, -1, largest=False).values.reshape(-1, k)
        xf = xb.reshape(-1, 3)
        coarse = (torch.sum(xf * xf, -1, keepdim=True) + vv
                  - 2.0 * xf @ verts.T)
        near = torch.topk(coarse, min(4 * k, len(verts)), -1,
                          largest=False).indices
        d2a = torch.sum((xf[:, None, :] - verts[near]) ** 2, -1)
        ka = torch.topk(d2a, k, -1, largest=False).values
        far = kc[:, [-1, 0]] > ka[:, [-1, 0]] * (1 + 1e-5)
        miss += torch.sum(far & okb[:, None], 0).cpu()
    return tuple(float(m) / int(ok.sum()) for m in miss)


def _block_order(H, W, bh, bw):
    idx = np.arange(H * W).reshape(H // bh, bh, W // bw, bw)
    return idx.transpose(0, 2, 1, 3).reshape(-1)
