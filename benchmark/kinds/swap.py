"""Frames of a texture-swapped scene back to back: the swap traffic kind.

The render kind's frames (kinds/render.py), on the configuration's NeuMesh
wrapped as the editing CLI wraps it for texture swapping
(editing/texture_model.py::TextureEditableNeuMesh) and rendered by the
same frame entry. Set-up, after the render kind's model and weights:

  - the edit region: the vertices within cfg["edit"]["cap_deg"] of u,
    the unit vector toward the mean centre of the traffic's cameras; the
    reference region the same cap about -u;
  - the reference model: the main model itself (one student, as the
    published config loads the same checkpoint twice);
  - correspondence pairs: the main vertices nearest the cap's centre and
    nearest four points cfg["edit"]["corr_spread_deg"] off it, each with
    the vertex nearest its image under the configuration's rotation;
    T_r_m from them by the program's Umeyama (editing/align.py);
  - the codes moved by the program's transfer (editing/swap.py,
    Kc = cfg["edit"]["Kc"]).

The check's reference is reference/swap.py's field, whose rotation is
the configuration's own and whose transfer is its own. Besides the render
kind's numbers it reads rgb_p50_painted, the median rgb gap over the
sampled rays that hit the surface (the reference's opacity above
check["hit_opacity"]) where the paint weight at the reference's depth is
positive, and painted_share, their share of the sampled hit rays. Faults
of the reference put in the program's place: "no_rotation" (T_r_m left
out) and "no_edit" (the main codes in place of the transferred ones).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import scene
from ..reference import swap as ref_swap
from . import log
from .render import Render

FAULTS = ("no_rotation", "no_edit")


def swap_ray_flops(work, m: dict, r: dict) -> float:
    """Model FLOPs of one ray of the reference volume structure on the
    swapped field: work.volume_ray_flops and, at every midpoint, the
    reference's colour head, which runs at every shaded sample."""
    _, col = work.neumesh_mlp_flops(m)
    n = r["N_samples"] + r["N_importance"]
    return work.volume_ray_flops(m, r) + (n - 1) * col


def edit_regions(verts: np.ndarray, u: np.ndarray, cap_deg: float):
    """(main mask, reference mask) (V,) bool: the vertices within cap_deg
    of the direction u, and of -u."""
    cos_v = verts @ u / np.linalg.norm(verts, axis=-1)
    c = math.cos(math.radians(cap_deg))
    return cos_v >= c, -cos_v >= c


def corr_pairs(verts: np.ndarray, u: np.ndarray, R: np.ndarray,
               spread_deg: float) -> np.ndarray:
    """(5, 2) vertex ids: the vertices nearest the cap's centre and nearest
    the four points spread_deg off it, toward +-e1 and +-e2 (e1, e2 normal
    to u), each paired with the vertex nearest its image under R."""
    radius = float(np.median(np.linalg.norm(verts, axis=-1)))
    e1 = np.cross(u, [1.0, 0.0, 0.0] if abs(u[0]) < 0.9 else [0.0, 1.0, 0.0])
    e1 /= np.linalg.norm(e1)
    e2 = np.cross(u, e1)
    s = math.radians(spread_deg)
    dirs = [u] + [math.cos(s) * u + math.sin(s) * e for e in
                  (e1, -e1, e2, -e2)]

    def nearest(p):
        return int(np.argmin(np.sum((verts - p) ** 2, -1)))

    main = [nearest(radius * d) for d in dirs]
    return np.array([[i, nearest(R @ verts[i])] for i in main], np.int64)


class Swap(Render):
    def __init__(self, cfg, traffic, seed, device, check=None):
        from neumesh_tpu_torch.editing.align import \
            estimate_transform_from_corr
        from neumesh_tpu_torch.editing.editable import (EditablePrimitive,
                                                        EditingParams)
        from neumesh_tpu_torch.editing.swap import TextureSwappingRender
        from neumesh_tpu_torch.editing.texture_model import \
            TextureEditableNeuMesh

        super().__init__(cfg, dict(traffic, warmup_frames=0), seed, device,
                         check)
        self.t = traffic
        self._fault = None
        e = cfg["edit"]
        poses, _ = scene.dtu_cameras(traffic["cameras"])
        u = poses[:, :3, 3].mean(0)
        u /= np.linalg.norm(u)
        main = self.main = self.model
        verts = np.asarray(main.mesh_grid.mesh.vertices, np.float64)
        main_mask, ref_mask = edit_regions(verts, u, e["cap_deg"])
        self.T_ref = ref_swap.rotation(e["rotation"]["axis"],
                                       e["rotation"]["degrees"])
        corr = corr_pairs(verts, u, self.T_ref[:3, :3].numpy(),
                          e["corr_spread_deg"])
        T = estimate_transform_from_corr(verts, verts, corr, refine=False)
        prim = EditablePrimitive(main, [EditingParams(main_mask)])
        ref_prim = EditablePrimitive(main, [EditingParams(ref_mask)])
        TextureSwappingRender().transfer(
            prim, prim.get_editing_params(0), ref_prim,
            ref_prim.get_editing_params(0), T, Kc=e["Kc"])
        self.model = TextureEditableNeuMesh(
            main, [main], prim.get_editing_masks(), [T],
            [prim.edit_color_features])
        self.masks = [torch.as_tensor(m, device=device)
                      for m in (main_mask, ref_mask)]
        log(f"edit: {int(main_mask.sum())} of {len(verts)} vertices "
            f"swapped, T_r_m from pairs {corr.tolist()}")
        for i in range(traffic["warmup_frames"]):
            self.frame(self.first_view + i)
        log(f"{traffic['warmup_frames']} warm-up frames")

    def model_flops(self, work) -> float:
        m = self.cfg["model"]
        return (super().model_flops(work) * swap_ray_flops(work, m, self.r)
                / work.volume_ray_flops(m, self.r))

    def release(self):
        super().release()
        self.main = None

    def _field(self, mode):
        """The swapped reference field at `mode`, with the fault planted
        by control() if any."""
        main = super()._field(mode)
        codes = (main.p["color_features"] if self._fault == "no_edit"
                 else self.codes)
        T = (torch.eye(4, dtype=torch.float64)
             if self._fault == "no_rotation" else self.T_ref)
        return ref_swap.SwapField(main, main, self.masks[0], codes, T)

    def check(self, check: dict) -> dict:
        w = self.ref_weights
        self.codes = ref_swap.transfer(
            w["vertices"], self.masks[0], w["vertices"], self.masks[1],
            w["color_features"], self.T_ref, self.cfg["edit"]["Kc"])
        self.sample = self._sample(check)
        self.ref = self.reference(check)
        self.painted = self._painted(check)
        self.knn = self.knn_miss_shares(check)
        return self.numbers(self.program(), check)

    def _painted(self, check):
        """(hit, painted) (n,) bool over the sample: the reference's
        opacity above check["hit_opacity"], and of those the rays whose
        paint weight at the reference's depth is positive."""
        field, s = self._field("f32"), self.sample
        x = s["o"] + self.ref["depth"].to(s["o"].device) * s["d"]
        paint = []
        for a in range(0, len(x), check["block_rays"]):
            b = slice(a, a + check["block_rays"])
            paint.append(field.paint(x[b, None], s["ids"][b])[:, 0].cpu())
        hit = self.ref["acc"][:, 0] > check["hit_opacity"]
        return hit, hit & (torch.cat(paint) > 0)

    def numbers(self, got, check, knn=None, ref=None) -> dict:
        out = super().numbers(got, check, knn, ref)
        ref = self.ref if ref is None else ref
        hit, painted = self.painted
        e = torch.amax(torch.abs(got["rgb"].float() - ref["rgb"]),
                       -1)[painted].numpy()
        out["rgb_p50_painted"] = (float(np.median(e)) if e.size
                                  else float("nan"))
        out["painted_share"] = float(painted.sum()) / max(1, int(hit.sum()))
        return out

    def control(self, check: dict, mode: str, fault=None) -> dict:
        """The render kind's controls, and the faults of FAULTS: the
        reference at `mode` with the fault, in the program's place."""
        if fault not in FAULTS:
            return super().control(check, mode, fault)
        self._fault = fault
        try:
            ref = self.reference(check, mode)
        finally:
            self._fault = None
        return self.numbers(ref, check)
