"""A closed loop of the texture-painting step: the paint traffic kind.

Set-up builds the training kind's NeuMesh student and NeuS teacher
(kinds/train.py, from the seed) and the analytic views on the device, then
the paint: u is the unit vector toward the mean centre of the cameras;
the cfg["paint"]["views"] views whose centres lie nearest u are painted
where their pixel's ray meets the object's sphere within
cfg["paint"]["cap_deg"] of u, in the colour cfg["paint"]["rgb"]. The paint
pool holds those pixels; the background pool every object-mask pixel of
every view less the painted ones. The program's step is the paint CLI's
own: editing/paint_train.py::build_paint_step (the cast of every paint
ray, Adam over color_features alone, the painting train step). Each step
draws traffic["N_rays"] rays from each pool, on the device, from the seed.

The check follows the program's first ref_steps steps with
reference/paint.py from the same weights and batches, each ray bound to
the program's candidate ids and depths and each paint sample to the
program's colour direction: loss_rel, grad_rel and step_rel
(kinds/train.py::train_numbers, over color_features), unpainted_rows_moved
(the largest change of a color_features row outside the painted set) and
frozen_moved (the largest change of any other parameter of the student).
Faults of the reference put in the program's place: "true_view" (the
paint rays shaded along their own direction), "all_rows" (every row of
color_features trained) and "geometry" (the geometry codes trained too).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import scene, weights
from ..reference import neus as ref_neus
from ..reference import paint as ref_paint
from . import log
from .train import Train, train_numbers

FAULTS = ("true_view", "all_rows", "geometry")


def paint_step_flops(m: dict, teacher: dict, r: dict, paint_rays: int,
                     bg_rays: int, work) -> float:
    """Model FLOPs of one painting step over the paint and background rays
    that meet the bounding sphere (work: the yardstick's module), as
    torch.utils.flop_counter.FlopCounterMode counts the plain reference
    step (benchmark/tests/test_nmb_paint.py holds the two equal). Only the
    codes train, so backward runs toward the inputs of the frozen MLPs and
    never toward their weights. A ray, at every sorted depth: the
    up-sampling's density, the shade's density and its backward (3 x the
    density MLP); at every midpoint: the density and its gradient (2 x),
    the colour MLP, and backward through the colour MLP and twice through
    the density MLP below its head (the gradient's own graph). A
    background midpoint adds its sdf's backward through the head (the
    rest is shared) and the teacher's sdf, normal (2 x the sdf net) and
    radiance, without gradient."""
    dens, col = work.neumesh_mlp_flops(m)
    head = 2.0 * m["W"]                     # the density head, W -> 1
    sdf, rad = work.neus_mlp_flops(teacher)
    n = r["N_samples"] + r["N_importance"]
    ray = 3 * n * dens + (n - 1) * (4 * dens - 2 * head + 2 * col)
    return ((paint_rays + bg_rays) * ray
            + bg_rays * (n - 1) * (head + 2 * sdf + rad))


class Paint(Train):
    def __init__(self, cfg, traffic, seed, device, check=None):
        # first: a program without the paint CLI's shared set-up stops here
        from neumesh_tpu_torch.editing.paint_train import build_paint_step

        self.cfg, self.device = cfg, device
        self._build_student(cfg, seed, device)
        log("models and weights")
        cam = traffic["cameras"]
        poses, K = scene.dtu_cameras(cam)
        self.H, self.W = cam["H"], cam["W"]
        self.pairs = traffic["N_rays"]
        self.n_rays = 2 * self.pairs
        self.c2w = torch.as_tensor(poses, dtype=torch.float32, device=device)
        self.K = torch.as_tensor(K, dtype=torch.float32, device=device)
        self._paint_pools(cfg["paint"], traffic["object_radius"])
        o, d = self._rays(self.paint_pool)
        self.step_fn, self.opt, painted = build_paint_step(
            self.args, self.trainer, self.rkw, o.cpu().numpy(),
            d.cpu().numpy())
        self.rows = torch.zeros(self.model.num_vertices, dtype=torch.bool,
                                device=device)
        self.rows[torch.as_tensor(painted, device=device)] = True
        log(f"paint: {len(self.paint_pool)} paint rays cast, "
            f"{len(painted)} of {self.model.num_vertices} vertices "
            f"painted; {len(self.bg_pool)} background rays")
        self.feed_gen = weights.generator(seed * 2 + 1, device)
        self.gen = weights.generator(seed * 2 + 2, device)
        self.batches = []           # (paint ids, background ids) a step
        self.bound, self.dirs = [], []
        self.prog = {"loss": []}
        undo = self._record_contexts()
        for k in range(traffic["ref_steps"]):
            total, _ = self.step()
            self.prog["loss"].append(float(total))
            if k == 0:
                self.prog["grad"] = {n: self.opt.mu[n] / (1 - self.opt.b1)
                                     for n, _ in self.opt.params}
        undo()
        self.prog["params"] = {n: p.detach().clone()
                               for n, p in self.model.named_parameters()}
        self.ref_batches = list(self.batches)
        log(f"{traffic['ref_steps']} steps kept for the check")
        for _ in range(traffic["warmup_steps"]):
            self.step()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        log(f"{traffic['warmup_steps']} warm-up steps")

    def _paint_pools(self, paint, radius):
        """The analytic views, the paint pool (flat view * H * W + pixel
        ids of the painted pixels, int32) and the background pool."""
        centres = self.c2w[:, :3, 3].double().cpu().numpy()
        u = centres.mean(0)
        u /= np.linalg.norm(u)
        near_u = np.argsort(-(centres / np.linalg.norm(
            centres, axis=-1, keepdims=True)) @ u, kind="stable")
        painted_views = set(near_u[:paint["views"]].tolist())
        cos_cap = math.cos(math.radians(paint["cap_deg"]))
        u_t = torch.as_tensor(u, dtype=torch.float32, device=self.device)
        hw = self.H * self.W
        pix = torch.arange(hw, device=self.device)
        rgb, paint_ids, bg_ids = [], [], []
        for v in range(len(self.c2w)):
            c, m = scene.analytic_view(self.c2w[v], self.K, self.H, self.W,
                                       radius)
            rgb.append(c)
            painted = torch.zeros_like(m)
            if v in painted_views:
                o, d = scene.pixel_rays(self.c2w[v], self.K, pix, self.W)
                b = torch.sum(o * d, -1)
                t = -b - torch.sqrt(torch.clamp(
                    b * b - torch.sum(o * o, -1) + radius * radius,
                    min=0.0))
                p = o + t[:, None] * d
                painted = m & (p @ u_t >= cos_cap * radius)
            paint_ids.append((v * hw + pix[painted]).to(torch.int32))
            bg_ids.append((v * hw + pix[m & ~painted]).to(torch.int32))
        self.rgb = torch.stack(rgb)
        self.paint_pool = torch.cat(paint_ids)
        self.bg_pool = torch.cat(bg_ids)
        self.paint_rgb = torch.tensor(paint["rgb"], dtype=torch.float32,
                                      device=self.device)

    def _rays(self, flat):
        """Rays (o, d) through the pixel centres of flat view * H * W +
        pixel ids, as scene.pixel_rays makes them."""
        flat = flat.long()
        view, pix = flat // (self.H * self.W), flat % (self.H * self.W)
        i = (pix % self.W).float()
        j = (pix // self.W).float()
        K = self.K
        x = (i - K[0, 2]) / K[0, 0]
        y = (j - K[1, 2]) / K[1, 1]
        d = torch.stack([x, y, torch.ones_like(x)], -1)
        d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
        c2w = self.c2w[view]
        d = torch.einsum("nij,nj->ni", c2w[:, :3, :3], d)
        return c2w[:, :3, 3], d

    def _batch(self, flat_p, flat_b):
        """The paint CLI's batch: (model_input, ground_truth)."""
        o_p, d_p = self._rays(flat_p)
        o_b, d_b = self._rays(flat_b)
        ones = torch.ones(len(flat_p), dtype=torch.bool, device=self.device)
        return ({"rays_o_paint": o_p, "rays_d_paint": d_p,
                 "mask_paint": ones, "rays_o_bg": o_b, "rays_d_bg": d_b,
                 "mask_bg": ones},
                {"rgb_paint": self.paint_rgb.expand(len(flat_p), 3),
                 "rgb_bg": self.rgb.reshape(-1, 3)[flat_b.long()]})

    def _record_contexts(self):
        """The training kind's record of candidate ids and depths (paint
        group, then background, each step), and the paint group's uniform
        colour-direction draws; returns the undo."""
        from neumesh_tpu_torch.render import volume
        undo_ctx = super()._record_contexts()
        rand = volume.rand

        def recorded(*a, **kw):
            r = rand(*a, **kw)
            self.dirs.append(r)
            return r
        volume.rand = recorded

        def undo():
            volume.rand = rand
            undo_ctx()
        return undo

    def step(self):
        ip = torch.randint(0, len(self.paint_pool), (self.pairs,),
                           generator=self.feed_gen, device=self.device)
        ib = torch.randint(0, len(self.bg_pool), (self.pairs,),
                           generator=self.feed_gen, device=self.device)
        flat_p, flat_b = self.paint_pool[ip], self.bg_pool[ib]
        self.batches.append((flat_p, flat_b))
        model_input, ground_truth = self._batch(flat_p, flat_b)
        return self.step_fn(model_input, ground_truth, self.gen)

    def model_flops(self, work) -> float:
        """Model FLOPs of the window's steps (work: the yardstick)."""
        r = self.rkw["obj_bounding_radius"]
        total = 0.0
        for flat_p, flat_b in self.batches:
            hits = [int(scene.hits_sphere(*self._rays(f), r).sum())
                    for f in (flat_p, flat_b)]
            total += paint_step_flops(self.cfg["model"], self.teacher_cfg,
                                      self.rkw, *hits, work)
        return total

    def reference(self, mode="f32", fault=None):
        """The first steps by reference/paint.py at `mode` from the same
        weights, batches, candidate ids, depths and colour directions ->
        {"loss", "grad", "params"}; fault one of FAULTS, planted in the
        reference put in the program's place."""
        tr = self.cfg["training"]
        params = {n: t.clone() for n, t in self.ref_weights.items()}
        names = ("color_features", "geometry_features") \
            if fault == "geometry" else ("color_features",)
        trained = {n: params[n].requires_grad_(True) for n in names}
        sch = tr["scheduler"]
        opt = ref_neus.Adam(trained, tr["lr"],
                            lambda c: ref_neus.warmup_cosine(
                                c, tr["num_iters"], sch["warmup_steps"]))
        rows = None if fault == "all_rows" else self.rows
        tm = self.teacher_cfg
        sf = {"speed_factor": tm["training"]["speed_factor"]}
        teacher = ref_neus.NeuSField(self.teacher_weights, tm["model"] | sf,
                                     mode)
        out = {"loss": []}
        for k, (flat_p, flat_b) in enumerate(self.ref_batches):
            mi, gt = self._batch(flat_p, flat_b)
            ids_p, z_p, ids_b, z_b = self.bound[4 * k:4 * k + 4]
            dirs = (None if fault == "true_view"
                    else ref_paint.unit(self.dirs[k]))
            losses = ref_paint.render_and_loss(
                ref_paint.PaintField(params, self.cfg["model"] | sf, mode),
                teacher,
                {"o": mi["rays_o_paint"], "d": mi["rays_d_paint"],
                 "z": z_p, "ids": ids_p, "dirs": dirs,
                 "rgb": gt["rgb_paint"]},
                {"o": mi["rays_o_bg"], "d": mi["rays_d_bg"], "z": z_b,
                 "ids": ids_b, "rgb": gt["rgb_bg"]},
                tr["loss_weights"])
            grads = ref_paint.masked_grads(losses["total"], trained, rows)
            out["loss"].append(float(losses["total"].detach()))
            if k == 0:
                out["grad"] = grads
            opt.step(grads)
        out["params"] = {n: p.detach() for n, p in trained.items()}
        return out

    def numbers(self, got) -> dict:
        """train_numbers of got against the reference, and how far got
        moved what must not move."""
        start = self.ref_weights
        out = train_numbers(got, self.ref, start)
        moved = torch.amax(torch.abs(got["params"]["color_features"]
                                     - start["color_features"]), dim=-1)
        out["unpainted_rows_moved"] = float(torch.amax(moved[~self.rows]))
        out["frozen_moved"] = max(
            [float(torch.amax(torch.abs(p - start[n])))
             for n, p in got["params"].items() if n != "color_features"],
            default=0.0)
        return out

    def check(self, check: dict) -> dict:
        """Numbers of the program's first steps against the reference; a
        step that bound another number of rays than it was fed, or drew no
        colour directions for its paint rays, fails every number."""
        steps = len(self.ref_batches)
        if len(self.bound) != 4 * steps or len(self.dirs) != steps or any(
                t.shape[0] != self.pairs for t in self.bound):
            return dict.fromkeys(check["limits"], float("inf"))
        self.ref = self.reference()
        return self.numbers(self.prog)

    def control(self, check: dict, mode: str, fault=None) -> dict:
        """Numbers of the reference at `mode` (with `fault` planted) put in
        the program's place (after check)."""
        return self.numbers(self.reference(mode, fault))
