"""Plain NeuMesh texture swapping (NeuMesh, ECCV 2022, sec. 3.5; the
published editing/texture_neumesh/texture_neumesh.py): the edited field
is two NeuMesh fields in one. Geometry and the base colour come from the
main field. A sample whose K nearest main vertices include masked ones
also decodes a second colour with the reference field's colour MLP, on
the main field's interpolated distance, on the main kNN weights masked
to the edited vertices and renormalised over the transferred codes, and
with the view direction and the normal rotated into the reference's
frame by T_r_m. The two colours mix by the paint weight, the share of
the kNN weight on masked vertices, where it is positive.

The transferred codes follow the published transfer: each masked main
vertex, moved by T_r_m, takes the inverse-distance average of the
colour codes of its Kc nearest masked reference vertices.

Departures, each as the rest of the reference has them:
  - rays are bound to candidate vertex ids (the program's tile ids) and
    the K nearest are found among them by brute force (NeuMeshField);
  - the transfer's nearest vertices are found by brute force in float64
    over every masked reference vertex, where the published code queries
    a KD-tree;
  - T_r_m is given as the configuration states it (an exact rotation),
    where the published pipeline estimates it from picked pairs;
  - the rotation is applied as a float32 sum of products, not a matrix
    product, so no TF32 setting can touch it.

Imports nothing of the program; float32 products with TF32 off.
"""
from __future__ import annotations

import math

import torch

from .neumesh import NeuMeshField


def rotation(axis, degrees: float) -> torch.Tensor:
    """The 4 x 4 rotation by `degrees` about `axis` (Rodrigues), float64."""
    a = torch.as_tensor(axis, dtype=torch.float64)
    a = a / torch.linalg.vector_norm(a)
    t = math.radians(degrees)
    k = torch.tensor([[0.0, -a[2], a[1]], [a[2], 0.0, -a[0]],
                      [-a[1], a[0], 0.0]], dtype=torch.float64)
    T = torch.eye(4, dtype=torch.float64)
    T[:3, :3] = (torch.eye(3, dtype=torch.float64) + math.sin(t) * k
                 + (1.0 - math.cos(t)) * (k @ k))
    return T


def transfer(main_verts, main_mask, ref_verts, ref_mask, ref_codes, T,
             kc: int = 4, block: int = 4096) -> torch.Tensor:
    """The main field's edit codes (V_main, F): at each masked main vertex
    the inverse-distance average (1 / (d + 1e-8)) of the codes of its kc
    nearest masked reference vertices after T; zero elsewhere. Distances
    in float64."""
    T = T.to(main_verts.device)
    src = main_verts[main_mask].to(torch.float64)
    src = src @ T[:3, :3].T + T[:3, 3]
    dst = ref_verts[ref_mask].to(torch.float64)
    codes = ref_codes[ref_mask]
    out = torch.zeros(main_verts.shape[0], ref_codes.shape[1],
                      device=ref_codes.device)
    new = []
    for a in range(0, src.shape[0], block):
        d = torch.cdist(src[a:a + block], dst,
                        compute_mode="donot_use_mm_for_euclid_dist")
        near = torch.topk(d, kc, dim=-1, largest=False)
        w = 1.0 / (near.values + 1e-8)
        w = (w / torch.sum(w, -1, keepdim=True)).to(torch.float32)
        new.append(torch.sum(w[..., None] * codes[near.indices], -2))
    out[main_mask] = torch.cat(new)
    return out


def _rotate(v, R):
    """v (..., 3) by the rotation R (3, 3): sum_j R[i, j] v[j]."""
    return torch.sum(v[..., None, :] * R, -1)


class SwapField:
    """The texture-swapped field, with NeuMeshField's interface (s,
    density, full, verts), so the volume reference renders it unchanged.

    main, ref: NeuMeshField; mask (V,) bool, the main field's edited
    vertices; codes (V, F) the transferred codes; T (4, 4) main ->
    reference."""

    K = NeuMeshField.K

    def __init__(self, main: NeuMeshField, ref: NeuMeshField, mask, codes,
                 T):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.main, self.ref = main, ref
        self.verts = main.verts
        dev = main.verts.device
        self.mask = torch.cat([mask.to(torch.float32),
                               torch.zeros(1, device=dev)])
        self.codes = torch.cat([codes, codes.new_zeros((1, codes.shape[1]))])
        self.R = T[:3, :3].to(torch.float32).to(dev)

    def s(self):
        return self.main.s()

    def density(self, x, ids):
        return self.main.density(x, ids)

    def paint(self, x, ids):
        """The paint weight (R, S) at x (R, S, 3)."""
        vid, w = self.main.neighbours(x, ids)
        return torch.sum(w * self.mask[vid], -1)

    def full(self, x, ids, view, create_graph: bool = False):
        """(sdf (R, S), nablas (R, S, 3), rgb (R, S, 3))."""
        main = self.main
        sdf, nabla, h, feats = main._field(x, ids, create_graph)
        rgb = main.color_mlp(nabla, h, view, feats[..., main.gd:])
        vid, w = main.neighbours(x, ids)
        wm = w * self.mask[vid]
        paint = torch.sum(wm, -1, keepdim=True)
        w_ref = wm / (paint + 1e-8)
        ft = torch.sum(w_ref[..., None] * self.codes[vid], -2)
        rgb_ref = self.ref.color_mlp(_rotate(nabla, self.R), h,
                                     _rotate(view, self.R), ft)
        mixed = rgb * (1.0 - paint) + rgb_ref * paint
        return sdf, nabla, torch.where(paint > 0, mixed, rgb)
