"""A closed loop of the training step: the train traffic kind.

Set-up builds the configuration's model, trainer and Adam (for a NeuMesh
student, its NeuS teacher from the configuration the student names, with
weights from the same seed), makes the analytic views on the device and
drives the very step the window calls through its first `ref_steps`
steps, keeping what the check compares: each step's loss, the first
gradient as Adam holds it (its first moment over 1 - beta1) and the
parameters after the last of them. The check follows those steps with the
plain reference from the same weights, batches and uniforms. A student's
reference follows the program's own state where NeuMesh's kNN would
otherwise diverge: each ray is bound to the candidate vertices the
program bound it to, and sampled at the depths the program's up-sampling
placed (that stage is judged on its own in the render and NeuS cells).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import scene, weights
from ..harness import load_json, HERE
from ..reference import distill as ref_distill
from ..reference import neus as ref_neus
from ..reference.neumesh import NeuMeshField
from . import log


def _neus(cfg, seed, device):
    """(model, trainer, train render kwargs, reference weights, program
    config) of a NeuS configuration, through the program's builder."""
    from neumesh_tpu_torch.config import ConfigDict
    from neumesh_tpu_torch.models import build_framework
    args = ConfigDict(cfg["program"])
    model, trainer, rkw, _, _ = build_framework(args, "NeuS", device=device)
    return model, trainer, rkw, weights.neus(model, seed, device), args


class Train:
    def __init__(self, cfg, traffic, seed, device, check=None):
        from neumesh_tpu_torch.train.loop import build_train_step
        from neumesh_tpu_torch.train.optimizers import get_optimizer

        self.cfg, self.t, self.seed, self.device = cfg, traffic, seed, device
        self.student = "teacher" in cfg
        if self.student:
            self._build_student(cfg, seed, device)
        else:
            (self.model, self.trainer, self.rkw, self.ref_weights,
             self.args) = _neus(cfg, seed, device)
        self.opt = get_optimizer(self.args, self.model)
        log("models, weights and optimizer")
        cam = traffic["cameras"]
        poses, K = scene.dtu_cameras(cam)
        self.H, self.W = cam["H"], cam["W"]
        self.n_rays = traffic["N_rays"]
        self.c2w = torch.as_tensor(poses, dtype=torch.float32, device=device)
        self.K = torch.as_tensor(K, dtype=torch.float32, device=device)
        views = [scene.analytic_view(self.c2w[v], self.K, self.H, self.W,
                                     traffic["object_radius"])
                 for v in range(len(poses))]
        self.rgb = torch.stack([v[0] for v in views])
        self.mask = torch.stack([v[1] for v in views])
        log(f"{len(views)} analytic views")
        self.step_fn = build_train_step(
            self.trainer, self.opt, self.rkw, self.n_rays, self.H, self.W,
            matmul_precision=self.args.training.get("matmul_precision",
                                                    "default"))
        self.feed_rng = np.random.default_rng([seed, 3])
        self.feed_gen = weights.generator(seed * 2 + 1, device)
        self.perturb_seed = seed * 2 + 2
        self.gen = weights.generator(self.perturb_seed, device)
        self.batches = []           # (view, select_inds) of every step
        self.prog = {"loss": []}
        self.bound = []     # a student's ray ids and depths, per step
        undo = self._record_contexts() if self.student else None
        for k in range(traffic["ref_steps"]):
            total, _ = self.step()
            self.prog["loss"].append(float(total))
            if k == 0:
                self.prog["grad"] = {n: self.opt.mu[n] / (1 - self.opt.b1)
                                     for n, _ in self.opt.params}
        if undo:
            undo()
        self.prog["params"] = {n: p.detach().clone()
                               for n, p in self.opt.params}
        self.ref_batches = list(self.batches)
        log(f"{traffic['ref_steps']} steps kept for the check")
        for _ in range(traffic["warmup_steps"]):
            self.step()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        log(f"{traffic['warmup_steps']} warm-up steps")

    def _build_student(self, cfg, seed, device):
        """The NeuMesh student on the benchmark's icosphere with its NeuS
        teacher (the configuration cfg["teacher"] names) from the same
        seed, wired as the program's NeuMesh builder wires them."""
        from neumesh_tpu_torch.config import ConfigDict
        from neumesh_tpu_torch.mesh.grid import MeshGrid
        from neumesh_tpu_torch.mesh.triangle_mesh import TriangleMesh
        from neumesh_tpu_torch.models.neumesh.model import NeuMesh
        from neumesh_tpu_torch.train.trainer import Trainer

        tcfg = load_json(HERE, "configs", cfg["teacher"] + ".json")
        teacher, _, _, self.teacher_weights, _ = _neus(tcfg, seed, device)
        teacher.requires_grad_(False)
        self.teacher_cfg = tcfg["program"]
        v, f = scene.icosphere(cfg["mesh"]["radius"],
                               cfg["mesh"]["subdivisions"])
        self.normals = torch.as_tensor(ref_distill.vertex_normals(v, f),
                                       dtype=torch.float32, device=device)
        mg = MeshGrid(TriangleMesh(v, f), device=device)
        self.model = NeuMesh(mg, device=device,
                             speed_factor=teacher.speed_factor,
                             **cfg["model"])
        self.ref_weights = weights.neumesh(
            self.model, torch.as_tensor(v, dtype=torch.float32,
                                        device=device), seed,
            float(teacher.ln_s[0]))
        tr = cfg["training"]
        self.trainer = Trainer(self.model, tr["loss_weights"],
                               teacher_model=teacher)
        self.rkw = dict(cfg["render_train"])
        self.args = ConfigDict({"training": tr})

    def _record_contexts(self):
        """Keep, per step, each ray's candidate ids and the sorted depths
        the up-sampling placed; returns the undo."""
        from neumesh_tpu_torch.models.neumesh import model as nm_model
        from neumesh_tpu_torch.render import volume
        make, upsample = nm_model.NeuMesh.make_ray_context, volume._upsample

        def recorded(model, *a, for_bounds=False, **kw):
            ctx = make(model, *a, for_bounds=for_bounds, **kw)
            if not for_bounds:
                self.bound.append(ctx["ids"])
            return ctx

        def placed(*a, **kw):
            z, sdf = upsample(*a, **kw)
            self.bound.append(z)
            return z, sdf
        nm_model.NeuMesh.make_ray_context = recorded
        volume._upsample = placed

        def undo():
            nm_model.NeuMesh.make_ray_context = make
            volume._upsample = upsample
        return undo

    def step(self):
        v = int(self.feed_rng.integers(len(self.c2w)))
        inds = torch.randint(0, self.H * self.W, (self.n_rays,),
                             generator=self.feed_gen, device=self.device)
        self.batches.append((v, inds))
        model_input = {"c2w": self.c2w[v][None],
                       "intrinsics": self.K[None],
                       "object_mask": self.mask[v][None]}
        return self.step_fn(model_input, {"rgb": self.rgb[v][None]},
                            self.gen, select_inds=inds)

    def rays_per_frame(self) -> int:
        return self.n_rays

    def window(self, seconds: float, limit: int = 0):
        """Steps back to back until `seconds` have passed (or `limit`
        steps), closed by a synchronize: [(start, end)] host times, the
        last end after the synchronize."""
        self.batches.clear()
        times = []
        t_end = time.perf_counter() + seconds
        while True:
            t0 = time.perf_counter()
            self.step()
            times.append((t0, time.perf_counter()))
            if (limit and len(times) >= limit) or (
                    not limit and times[-1][1] >= t_end):
                break
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        times[-1] = (times[-1][0], time.perf_counter())
        return times

    def end_to_end(self, times) -> dict:
        return {"train_rays_s": len(times) * self.n_rays
                / (times[-1][1] - times[0][0])}

    def model_flops(self, work) -> float:
        """Model FLOPs of the window's steps (work: the yardstick)."""
        total = 0.0
        r = self.rkw["obj_bounding_radius"]
        for v, inds in self.batches:
            o, d = scene.pixel_rays(self.c2w[v].cpu(), self.K.cpu(),
                                    inds.cpu(), self.W)
            hit = int(scene.hits_sphere(o, d, r).sum())
            if self.student:
                total += work.distill_step_flops(
                    self.cfg["model"], self.teacher_cfg, self.rkw, hit)
            else:
                total += work.neus_step_flops(self.cfg["program"], self.rkw,
                                              hit)
        return total

    def release(self):
        self.model = self.trainer = self.opt = self.step_fn = None

    def reference(self, mode="f32", fault=None):
        """The first steps by the plain reference at `mode` from the same
        weights, batches and uniforms -> {"loss", "grad", "params"}.
        fault: "half_batch" (the losses over the first half of each batch)
        or "altered" (the rendered colour scaled by 1.01), planted in the
        reference put in the program's place."""
        tr = (self.cfg["training"] if self.student
              else self.cfg["program"]["training"])
        params = {n: t.clone().requires_grad_(n != "vertices")
                  for n, t in self.ref_weights.items()}
        trained = {n: p for n, p in params.items() if n != "vertices"}
        sch = tr["scheduler"]
        opt = ref_neus.Adam(trained, tr["lr"],
                            lambda c: ref_neus.warmup_cosine(
                                c, tr["num_iters"], sch["warmup_steps"]))
        gen = weights.generator(self.perturb_seed, self.device)
        r = self.rkw
        per = r["N_importance"] // r["N_upsample_iters"]
        rows = slice(0, self.n_rays // 2 if fault == "half_batch"
                     else self.n_rays)
        scale = 1.01 if fault == "altered" else 1.0
        out = {"loss": []}
        for k, (v, inds) in enumerate(self.ref_batches):
            uni = [torch.rand((self.n_rays, per), generator=gen,
                              device=self.device)[rows]
                   for _ in range(r["N_upsample_iters"])]
            o, d = scene.pixel_rays(self.c2w[v], self.K, inds, self.W)
            o, d, inds = o[rows], d[rows], inds[rows]
            tgt, msk = self.rgb[v][inds], self.mask[v][inds]
            if self.student:
                tm = self.teacher_cfg
                sf = {"speed_factor": tm["training"]["speed_factor"]}
                losses = ref_distill.render_and_loss(
                    NeuMeshField(params, self.cfg["model"] | sf, mode),
                    ref_neus.NeuSField(self.teacher_weights,
                                       tm["model"] | sf, mode),
                    o, d, tgt, msk, self.bound[2 * k + 1][rows],
                    self.bound[2 * k][rows], self.normals,
                    tr["loss_weights"], rgb_scale=scale)
            else:
                losses = ref_neus.render_and_loss(
                    ref_neus.NeuSField(params, self.cfg["program"]["model"]
                                       | {"speed_factor":
                                          tr["speed_factor"]}, mode),
                    o, d, tgt, msk, uni, r, tr["loss_weights"],
                    rgb_scale=scale)
            grads = torch.autograd.grad(losses["total"],
                                        list(trained.values()),
                                        allow_unused=True)
            grads = {n: torch.zeros_like(p) if g is None else g
                     for (n, p), g in zip(trained.items(), grads)}
            out["loss"].append(float(losses["total"].detach()))
            if k == 0:
                out["grad"] = grads
            opt.step(grads)
        out["params"] = {n: p.detach() for n, p in trained.items()}
        return out

    def check(self, check: dict) -> dict:
        """Numbers of the program's first steps against the reference; a
        student that bound another number of rays than each step was fed
        fails every number."""
        if any(t.shape[0] != self.n_rays for t in self.bound):
            return dict.fromkeys(("loss_rel", "grad_rel", "step_rel"),
                                 float("inf"))
        self.ref = self.reference()
        return train_numbers(self.prog, self.ref, self.ref_weights)

    def control(self, check: dict, mode: str, fault=None) -> dict:
        """Numbers of the reference at `mode` (with `fault` planted) put in
        the program's place (after check)."""
        return train_numbers(self.reference(mode, fault), self.ref,
                             self.ref_weights)


def _norm(t):
    return float(torch.linalg.vector_norm(t.double()))


def train_numbers(got, ref, start) -> dict:
    """loss_rel: the widest relative gap of a step's loss; grad_rel and
    step_rel: the widest gap between got's and the reference's norm of a
    leaf's first gradient and of its change over the steps, over the
    larger of that leaf's reference norm and the median leaf's. Leaves
    whose reference gradient is under a thousandth of the median leaf's
    are left out (reported as leaves_left_out)."""
    loss_rel = max(abs(p - r) / abs(r) for p, r in zip(got["loss"],
                                                       ref["loss"]))
    g_ref = {n: _norm(g) for n, g in ref["grad"].items()}
    med_g = float(np.median(list(g_ref.values())))
    kept = [n for n in g_ref if g_ref[n] >= 1e-3 * med_g]
    d_ref = {n: _norm(ref["params"][n] - start[n]) for n in kept}
    d_got = {n: _norm(got["params"][n] - start[n]) for n in kept}
    med_d = float(np.median(list(d_ref.values())))

    def worst(r, g, med):
        return max(abs(g[n] - r[n]) / max(r[n], med, 1e-30) for n in kept)
    return {"loss_rel": loss_rel,
            "grad_rel": worst(g_ref, {n: _norm(got["grad"][n])
                                      for n in kept}, med_g),
            "step_rel": worst(d_ref, d_got, med_d),
            "leaves_left_out": float(len(g_ref) - len(kept))}
