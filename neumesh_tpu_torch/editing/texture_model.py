"""TextureEditableNeuMesh: the editing model wrapper (counterpart of
neumesh_tpu/editing/texture_model.py).

It answers the renderers' model protocol, so the volume and surface
renderers drive it unmodified. Geometry and SDF always come from the main
model. The colour is a per-sample blend: the paint weight is the sum of
the kNN weights whose vertex is edit-masked, the unpaint weight its
complement; the edit region queries the REFERENCE model's colour MLP with
the transferred edit_color_features, view directions and nablas rotated
into the reference frame by T_r_m. The reference colour is computed for
every sample and blended where the paint weight is positive.

Kernel routes. The renderers find them by probing the model: the
editable exposes the main model's use_pallas / use_fused_locate /
secant_rebracket, and its bound view delegates fused_secant,
fused_locate and forward_density_only_nograd (the up-sampling density on
field_fused) to the main model's bound view. The bound view has NO
forward_full on purpose: the surface renderer would shade with it and
skip the blend.

The bound shade (RayBoundTextureEditable.forward) takes one of two
routes:
  - the fused route, where the main model has use_pallas and nablas input
    (the condition of the unedited bound forward's `full` launch), every
    reference has nablas input and there are at most EDIT_REFS
    references: one ops/kernels.py::field_fused_edit call a chunk (the
    field_fused_edit kernel on the card, its plain version on the CPU),
    on the main model's folded weights and evaluation contexts, each
    reference's colour weights folded as the main model's and its edit
    rows [codes times mask, mask] gathered once a binding;
  - else the context math in plain torch (_shade): the bound shade holds
    (tiles, samples, candidates) temporaries, a dozen of them live at once
    in the context math and the blend, so it runs over slices of whole
    tiles, each at most SLICE_ELEMS elements a temporary (per-tile math,
    so a slice gives the bits the whole chunk gives).

Spans: edit.shade (the blended shade, bound and per sample),
edit.ref_color (each reference's colour on the context math); counters
edit.samples_shaded (samples shaded, from the shapes) and
edit.samples_painted (samples with a positive paint weight, summed over
the references; a device count, under a profiler only: on the fused route
the kernel adds it up).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
from torch import nn

from ..models.neumesh.model import fold_color_weights
from ..ops import kernels
from ..ops._build import EDIT_REFS
from ..utils.trace import count, count_device, enabled, span, spanned

# elements of one (tiles, samples, candidates) temporary of a shade slice
SLICE_ELEMS = 1 << 28


class TextureEditableNeuMesh(nn.Module):
    def __init__(self, main_model, ref_models: List,
                 main_editing_masks, T_r_m_list: Optional[list] = None,
                 edit_color_features: Optional[list] = None):
        """main_editing_masks (R, N_main) bool; T_r_m_list R 4x4
        main -> reference transforms (None: no rotation);
        edit_color_features R (N_main, F) arrays or tensors (None: zeros),
        one buffer per reference."""
        super().__init__()
        self.main_model = main_model
        self.ref_models = nn.ModuleList(ref_models)
        dev = main_model.device
        self.register_buffer("main_editing_masks", torch.as_tensor(
            np.asarray(main_editing_masks, bool), device=dev))
        if T_r_m_list is not None:
            T = torch.as_tensor(np.asarray(T_r_m_list, np.float32),
                                device=dev)
            self.register_buffer("rot_s_m", T[:, :3, :3].contiguous())
        else:
            self.rot_s_m = None
        for i in range(len(self.ref_models)):
            f = (None if edit_color_features is None
                 else edit_color_features[i])
            if f is None:
                f = torch.zeros_like(main_model.color_features).detach()
            self.register_buffer(f"edit_color_features_{i}", torch.as_tensor(
                f, dtype=torch.float32, device=dev).clone())

    # ---- the main model's knobs, as the renderers probe them ---------------
    @property
    def device(self):
        return self.main_model.device

    @property
    def use_pallas(self):
        return self.main_model.use_pallas

    @property
    def use_fused_locate(self):
        return self.main_model.use_fused_locate

    @property
    def secant_rebracket(self):
        return self.main_model.secant_rebracket

    def frame_indicator_weight(self):
        """The main model's w1 read once for every binding of a frame."""
        return self.main_model.frame_indicator_weight()

    def edit_features(self, i: int) -> torch.Tensor:
        return getattr(self, f"edit_color_features_{i}")

    def _ref_frame(self, i, view_dirs, nabla):
        """View directions and nablas rotated into reference i's frame."""
        if self.rot_s_m is None:
            return view_dirs, nabla
        R = self.rot_s_m[i]
        return (view_dirs @ R.T,
                None if nabla is None else nabla @ R.T)

    # ---- protocol delegation ------------------------------------------------
    def compute_distance(self, xyz, K: int = 8):
        return self.main_model.compute_distance(xyz, K)

    def forward_s(self):
        return self.main_model.forward_s()

    def forward_density_only(self, xyz):
        return self.main_model.forward_density_only(xyz)

    def forward_with_nablas(self, xyz):
        return self.main_model.forward_with_nablas(xyz)

    # ---- blended colour, per sample ----------------------------------------
    @spanned("edit.shade")
    def forward(self, xyz, view_dirs):
        """(sdf (...), rgb (..., 3)) with the kNN through the mesh grid."""
        main = self.main_model
        count("edit.samples_shaded", xyz.numel() // 3)
        ds, indices, weights = main.compute_distance(xyz)
        if main.enable_nablas_input:
            sdf, nabla, d_emb = main._density_and_nabla(xyz, indices,
                                                        weights)
        else:
            sdf, d_emb = main._density_from_parts(ds, indices, weights)
            nabla = None
        sdf = sdf[..., 0]
        blend = main._color_from_parts(d_emb, view_dirs, indices, weights,
                                       nabla)
        for i, ref_model in enumerate(self.ref_models):
            m_at = self.main_editing_masks[i][indices].to(weights.dtype)
            paint_w = torch.sum(weights * m_at, dim=-1)
            unpaint_w = torch.sum(weights * (1.0 - m_at), dim=-1)
            paint_region = paint_w > 0
            count_device("edit.samples_painted", paint_region)
            sum_w = paint_w + unpaint_w
            paint_w = paint_w / sum_w
            unpaint_w = unpaint_w / sum_w
            ref_weights = weights * m_at
            ref_weights = ref_weights / (
                torch.sum(ref_weights, dim=-1, keepdim=True) + 1e-8)
            with span("edit.ref_color"):
                ref_dir, ref_nabla = self._ref_frame(i, view_dirs, nabla)
                ref_color = ref_model.forward_color(
                    ds, ref_dir, self.edit_features(i), indices,
                    ref_weights, nabla=ref_nabla)
            mixed = (blend * unpaint_w[..., None]
                     + ref_color * paint_w[..., None])
            blend = torch.where(paint_region[..., None], mixed, blend)
        return sdf, blend

    # ---- candidate contexts -------------------------------------------------
    def make_ray_context(self, rays_o, rays_d, near, far, **kw):
        """The main model's contexts (the renderers' near/far pre-pass)."""
        return self.main_model.make_ray_context(rays_o, rays_d, near, far,
                                                **kw)

    def bind_rays(self, rays_o, rays_d, near, far, n_probes: int = 8,
                  w1=None):
        """Per-ray binding: geometry and base colour from the main model's
        candidate cache; the edit masks and transferred features are
        gathered into the same per-ray cache, so the blend runs as batched
        products. None without a candidate grid."""
        bound = self.main_model.bind_rays(rays_o, rays_d, near, far,
                                          n_probes, w1)
        if bound is None:
            return None
        return RayBoundTextureEditable(self, bound)

    def bind_rays_tiled(self, rays_o, rays_d, near, far, tile: int,
                        max_candidates=None, w1=None):
        """Tile-shared binding: the main model's tile contexts drive the
        scan and secant (texture edits never move the surface), the edit
        caches ride the same tile ids. Returns (bound, near, far) or
        None."""
        tb = self.main_model.bind_rays_tiled(rays_o, rays_d, near, far,
                                             tile=tile,
                                             max_candidates=max_candidates,
                                             w1=w1)
        if tb is None:
            return None
        bound, near_b, far_b = tb
        return RayBoundTextureEditable(self, bound), near_b, far_b


class RayBoundTextureEditable(nn.Module):
    """The editable bound to the main model's per-ray or tile contexts."""

    def __init__(self, editable: TextureEditableNeuMesh, bound):
        super().__init__()
        self.editable = editable
        self.bound = bound               # RayBoundNeuMesh / TileBoundNeuMesh
        # the surface renderer reads the main model's knobs here
        self.model = bound.model
        ids = bound.ctx["ids"]           # (B, C); sentinel id = N_main
        self._masks, self._efeat = [], []
        for i in range(len(editable.ref_models)):
            mask = editable.main_editing_masks[i].to(torch.float32)
            mask_ext = torch.cat([mask, mask.new_zeros(1)], 0)
            self._masks.append(mask_ext[ids])                  # (B, C)
            ef = editable.edit_features(i)
            ef_ext = torch.cat([ef, ef.new_zeros((1, ef.shape[-1]))], 0)
            self._efeat.append(ef_ext[ids])                    # (B, C, F)
        self._refs = None    # the fused route's references, once built

    # ---- geometry: the main model's bound view, kernels included
    def forward_s(self):
        return self.bound.forward_s()

    def compute_distance(self, xyz, K: int = 8):
        return self.bound.compute_distance(xyz, K)

    def forward_density_only(self, xyz):
        return self.bound.forward_density_only(xyz)

    def forward_density_only_nograd(self, xyz):
        return self.bound.forward_density_only_nograd(xyz)

    def forward_with_nablas(self, xyz):
        return self.bound.forward_with_nablas(xyz)

    def fused_secant(self, *args, **kwargs):
        return self.bound.fused_secant(*args, **kwargs)

    def fused_locate(self, *args, **kwargs):
        return self.bound.fused_locate(*args, **kwargs)

    # ---- blended colour: one fused launch, or the context math
    @spanned("edit.shade")
    def forward(self, xyz, view_dirs):
        """(sdf (R, S), rgb (R, S, 3)): one field_fused_edit call on the
        fused route; else density, nablas and base colour by the main
        model's context math, the reference colours from the cached edit
        features, over slices of whole contexts where one (contexts,
        samples, candidates) temporary of the whole would pass
        SLICE_ELEMS."""
        b = self.bound
        x, v = b._flat(xyz), b._flat(view_dirs)
        B, S = x.shape[:2]
        count("edit.samples_shaded", B * S)
        if self._fused_route():
            sdf, rgb = self._fused_shade(x, v)
            return b._unflat(sdf), b._unflat(rgb)
        step = max(1, SLICE_ELEMS // (S * b.ctx["ids"].shape[1]))
        parts = [self._shade(x[a:a + step], v[a:a + step], slice(a, a + step))
                 for a in range(0, B, step)]
        return (b._unflat(torch.cat([p[0] for p in parts])),
                b._unflat(torch.cat([p[1] for p in parts])))

    def _fused_route(self) -> bool:
        ed = self.editable
        main = ed.main_model
        return (main.use_pallas and main.enable_nablas_input
                and len(ed.ref_models) <= EDIT_REFS
                and all(r.enable_nablas_input for r in ed.ref_models))

    def _fused_shade(self, x, v):
        """x, v (B, S, 3) -> (sdf (B, S), rgb (B, S, 3)) by one
        field_fused_edit call on the main model's evaluation contexts."""
        b = self.bound
        m = b.model
        dws, cws = b._field_weights()
        geo, feat = b._eval_ctx_slice()
        painted = (torch.zeros(1, dtype=torch.int64, device=x.device)
                   if enabled() else None)
        out = kernels.field_fused_edit(
            x, geo, feat, b._indicator_weight(), dws, cws, v,
            self._edit_refs(),
            multires_d=m.embed_fn_d.multires,
            multires_fg=m.embed_fn_fg.multires,
            multires_ft=m.embed_fn_ft.multires,
            multires_view=m.embed_fn_view.multires,
            geometry_dim=m.geometry_dim, dtype=m.compute_dtype,
            painted=painted)
        if painted is not None:
            count_device("edit.samples_painted", painted)
        return out[0], torch.stack(out[1:4], dim=-1)

    def _edit_refs(self):
        """The fused route's references (kernels.EditRef) at the candidates
        of the evaluation contexts (_eval_ctx_slice), built once a binding:
        each reference's edit rows, its transferred codes (rounded to its
        compute dtype) times its edit mask, then the mask; its colour
        weights folded as the main model's; its rotation, _ref_frame's
        image of the axes (the one definition of the reference frame)."""
        if self._refs is None:
            ed = self.editable
            C = self.bound._eval_ctx_slice()[0].shape[2]
            eye = torch.eye(3, device=ed.device)
            self._refs = []
            for i, ref in enumerate(ed.ref_models):
                dt = ref.compute_dtype
                ef = self._efeat[i][:, :C]
                if dt is not None:
                    ef = ef.to(dt).to(torch.float32)
                mask = self._masks[i][:, :C, None]
                with span("weights.fold"):
                    cws = fold_color_weights(ref)
                rot = ed._ref_frame(i, eye, None)[0].t().contiguous()
                self._refs.append(kernels.EditRef(
                    torch.cat([ef * mask, mask], -1).contiguous(), cws, rot,
                    dt, ref.embed_fn_ft.multires,
                    ref.embed_fn_view.multires))
        return self._refs

    def _shade(self, x, v, rows: slice):
        """The blended shade of the contexts `rows`: x, v (n, S, 3) ->
        (sdf (n, S), rgb (n, S, 3))."""
        ed = self.editable
        main = ed.main_model
        ctx = {k: t[rows] if torch.is_tensor(t) else t
               for k, t in self.bound.ctx.items()}
        if main.enable_nablas_input:
            density, nabla, d_emb, W, ft = main._ctx_density_and_nabla(
                ctx, x, with_ft=True)
        else:
            ds, W = main._ctx_distance_parts(ctx, x)
            feats = main._ctx_interp_feats(ctx, W)
            density, d_emb = main._density_from_interp(
                ds, feats[..., :main.geometry_dim])
            ft = feats[..., main.geometry_dim:]
            nabla = None
        blend = main._color_from_interp(d_emb, v, ft, nabla)
        for i, ref_model in enumerate(ed.ref_models):
            Wm = W * self._masks[i][rows, None, :]             # (n, S, C)
            paint_w = torch.sum(Wm, dim=-1)
            paint_region = paint_w > 0
            count_device("edit.samples_painted", paint_region)
            # the weights sum to 1: the unpaint share is the complement
            W_ref = Wm / (torch.sum(Wm, dim=-1, keepdim=True) + 1e-8)
            with span("edit.ref_color"):
                ref_dir, ref_nabla = ed._ref_frame(i, v, nabla)
                dt = ref_model.compute_dtype
                ef = self._efeat[i][rows]
                if dt is None:
                    ft_ref = torch.matmul(W_ref, ef)
                else:
                    # operands rounded to the compute dtype, f32 accumulation
                    ft_ref = torch.matmul(W_ref.to(dt).to(torch.float32),
                                          ef.to(dt).to(torch.float32))
                ref_color = ref_model._color_from_interp(d_emb, ref_dir,
                                                         ft_ref, ref_nabla)
            mixed = (blend * (1.0 - paint_w)[..., None]
                     + ref_color * paint_w[..., None])
            blend = torch.where(paint_region[..., None], mixed, blend)
        return density[..., 0], blend
