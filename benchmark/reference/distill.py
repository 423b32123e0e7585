"""Plain NeuMesh training step by distillation from a NeuS teacher
(NeuMesh, ECCV 2022, sec. 3.4): the NeuS volume structure on the student's
field (rays bound to candidate vertex sets), the teacher's sdf and colour
at the student's midpoints as targets, and every loss of the published
configuration: L1 colour over the mask, the mask's cross-entropy, the
eikonal loss, the sdf and colour distillation losses and the indicator
vectors held to the mesh normals. Imports nothing of the program.
"""
from __future__ import annotations

import numpy as np
import torch

from .neumesh import NeuMeshField
from .volume import alpha_from_sdf, composite, visibility


def vertex_normals(v: np.ndarray, f: np.ndarray) -> np.ndarray:
    """Area-weighted face normals summed at each vertex, normalised."""
    fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    n = np.zeros_like(v)
    for i in range(3):
        np.add.at(n, f[:, i], fn)
    return n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)


def render_and_loss(student: NeuMeshField, teacher, o, d, target_rgb,
                    target_mask, z, ids, normals, w: dict,
                    rgb_scale: float = 1.0):
    """Losses of one step on rays (R, 3) sampled at the sorted depths
    z (R, N), ids (R, C) the ray's candidate vertices. rgb_scale alters the
    rendered colour (a planted fault)."""
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)

    def at(t):
        return o[:, None, :] + t[..., None] * d[:, None, :]

    sdf, nablas = student.density_nabla(at(z), ids, create_graph=True)
    z_mid = 0.5 * (z[..., 1:] + z[..., :-1])
    x_mid = at(z_mid)
    view = d[:, None, :].expand_as(x_mid)
    sdf_mid, _, rad = student.full(x_mid, ids, view, create_graph=True)
    rgb, _, acc = composite(visibility(alpha_from_sdf(sdf, student.s())),
                            rad, z_mid)
    rgb = rgb * rgb_scale
    with torch.no_grad():
        t_sdf, t_n, t_feat = teacher.with_normals(x_mid, create_graph=False)
        t_rad = teacher.radiance(x_mid, view, t_n, t_feat)
    m = target_mask.to(torch.float32)
    acc = torch.clamp(acc, 1e-3, 1.0 - 1e-3)
    norm = torch.sqrt(torch.sum(nablas * nablas, -1) + 1e-12)
    losses = {
        "loss_eikonal": w["eikonal"] * torch.mean((norm - 1.0) ** 2),
        "loss_density": w["distill_density"] * torch.mean(
            torch.abs(t_sdf.detach() - sdf_mid)),
        "loss_color": w["distill_color"] * torch.mean(
            (rad - t_rad.detach()) ** 2),
        "loss_indicator_vector_reg": w["indicator_reg"] * torch.mean(
            (student.p["indicator_vector"] - normals) ** 2),
        "loss_mask": w["mask"] * torch.mean(
            -(m * torch.log(acc) + (1.0 - m) * torch.log(1.0 - acc))),
        "loss_img": torch.sum(w["img"] * torch.abs(rgb - target_rgb)
                              * m[:, None]) / (torch.sum(m) + 1e-10)}
    losses["total"] = sum(losses.values())
    return losses
