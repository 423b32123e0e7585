"""Plain texture-painting step of NeuMesh (NeuMesh, ECCV 2022, sec. 4.3;
the published editing/paint.py with Trainer.forward_painting): a batch of
paint rays and one of background rays through the NeuS volume structure
on the student's field, the paint rays shaded along random colour
directions (the colour decoded independently of the view), the background
rays with the teacher's distillation targets at their midpoints; the
losses over both groups concatenated: L1 colour, the mask's cross-entropy
(all rays inside the object) and the sdf and colour distillation. Adam
steps the colour codes alone, their gradient kept on the painted rows.
Imports nothing of the program.

Departures from the published step, each where NeuMesh's kNN or the
program's random draws would otherwise diverge (the same as
reference/distill.py's): the kNN follows the rule NeuMeshField states
(PaintField keeps its tie to the lower candidate index exactly); every
ray is bound to the candidate vertex ids the program bound it to and
sampled at the sorted depths the program's up-sampling placed (that
stage is judged on its own in the render and NeuS cells); the paint
group's colour directions are the program's uniform draws, normalised;
the painted rows are the program's cast of the paint rays (the vertices
of the triangles they hit).
"""
from __future__ import annotations

import torch

from .neumesh import NeuMeshField
from .volume import alpha_from_sdf, composite, visibility


def unit(v):
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


class PaintField(NeuMeshField):
    """NeuMeshField with its kNN rule kept exactly: K picks by the
    perturbed rank, a tie of two ranks to the lower candidate index.
    torch.topk leaves the order of equal ranks open (on the CPU it took
    the higher index), and one such pick moves a training step's loss by
    up to 1e-4 relative."""

    def neighbours(self, x: torch.Tensor, ids: torch.Tensor, k: int = 0):
        x = x.detach()
        p = self.verts[ids]                                    # (R, C, 3)
        x0, x1, x2 = (x[..., i:i + 1] for i in range(3))
        p0, p1, p2 = (p[:, None, :, i] for i in range(3))
        xv = x0 * p0 + x1 * p1 + x2 * p2
        xx = torch.sum(x * x, -1, keepdim=True)
        pp = torch.sum(p * p, -1)[:, None, :]
        d2 = torch.clamp(xx + pp - 2.0 * xv, min=0.0)
        rank = d2 * (1.0 + torch.arange(ids.shape[1], device=x.device,
                                        dtype=x.dtype) * 2e-7)
        sel = torch.sort(rank, dim=-1, stable=True).indices[..., :k or self.K]
        w = 1.0 / (torch.sqrt(torch.gather(d2, -1, sel)) + 1e-7)
        w = w / torch.sum(w, -1, keepdim=True)
        vid = torch.gather(ids[:, None, :].expand(-1, x.shape[1], -1), -1,
                           sel)
        return vid, w


def render_group(field: PaintField, o, d, z, ids, dirs=None):
    """Rays (R, 3) bound to candidate ids (R, C), sampled at the sorted
    depths z (R, N): -> (rgb (R, 3), opacity (R,), the midpoints (R, N-1,
    3), their sdf (R, N-1), colour (R, N-1, 3) and view directions). The
    colour at the midpoints looks along dirs (R, N-1, 3), or along the
    ray when None."""
    d = unit(d)

    def at(t):
        return o[:, None, :] + t[..., None] * d[:, None, :]

    sdf = field.density(at(z), ids)
    z_mid = 0.5 * (z[..., 1:] + z[..., :-1])
    x_mid = at(z_mid)
    view = d[:, None, :].expand_as(x_mid) if dirs is None else dirs
    sdf_mid, _, rad = field.full(x_mid, ids, view, create_graph=True)
    rgb, _, acc = composite(visibility(alpha_from_sdf(sdf, field.s())),
                            rad, z_mid)
    return rgb, acc, x_mid, sdf_mid, rad, view


def render_and_loss(student: PaintField, teacher, paint: dict, bg: dict,
                    w: dict):
    """Losses of one painting step. paint and bg: {"o", "d" (R, 3), "z"
    (R, N), "ids" (R, C), "rgb" (R, 3) targets}; paint["dirs"] (R, N-1, 3)
    the colour directions (None: along the ray). The mask targets are all
    ones: both groups lie inside the object mask."""
    rgb_p, acc_p, _, _, _, _ = render_group(
        student, paint["o"], paint["d"], paint["z"], paint["ids"],
        paint["dirs"])
    rgb_b, acc_b, x_b, sdf_b, rad_b, view_b = render_group(
        student, bg["o"], bg["d"], bg["z"], bg["ids"])
    with torch.no_grad():
        t_sdf, t_n, t_feat = teacher.with_normals(x_b, create_graph=False)
        t_rad = teacher.radiance(x_b, view_b, t_n, t_feat)
    rgb = torch.cat([rgb_p, rgb_b])
    target = torch.cat([paint["rgb"], bg["rgb"]])
    acc = torch.clamp(torch.cat([acc_b, acc_p]), 1e-3, 1.0 - 1e-3)
    m = torch.ones_like(acc)
    losses = {
        "loss_density": w["distill_density"] * torch.mean(
            torch.abs(t_sdf - sdf_b)),
        "loss_color": w["distill_color"] * torch.mean((rad_b - t_rad) ** 2),
        "loss_mask": w["mask"] * torch.mean(
            -(m * torch.log(acc) + (1.0 - m) * torch.log(1.0 - acc))),
        "loss_img": torch.sum(w["img"] * torch.abs(rgb - target)
                              * m[:, None]) / (torch.sum(m) + 1e-10)}
    losses["total"] = sum(losses.values())
    return losses


def masked_grads(total, params: dict, rows) -> dict:
    """{name: gradient of total} over params, color_features' zeroed off
    the painted rows (V,) bool (rows None: every row kept); a parameter
    the loss does not reach gets zeros."""
    grads = torch.autograd.grad(total, list(params.values()),
                                allow_unused=True)
    out = {n: torch.zeros_like(p) if g is None else g
           for (n, p), g in zip(params.items(), grads)}
    if rows is not None and "color_features" in out:
        out["color_features"] = out["color_features"] * rows[:, None]
    return out
