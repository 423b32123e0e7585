"""NeuMesh on tile-shared candidate contexts (counterpart of
neumesh_tpu/models/neumesh/model.py, the render path).

Per-vertex geometry/colour feature codes and learnable indicator vectors
on a fixed mesh scaffold, decoded by a density MLP (input: the embedded
kNN-interpolated signed distance and geometry feature) and a colour MLP
(input: [nabla, d_emb, view_emb, ft_emb]).

Coherent camera rays are grouped into tiles of `tile` consecutive rays
that share ONE candidate set (make_tile_context); every sample query of
the bound model (TileBoundNeuMesh) then runs the fused field kernels of
ops/kernels.py against the tile's (8, C) packed geometry and (C, F)
features.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ... import resolve_device
from ...mesh.grid import MeshGrid
from ...nn import get_embedder, wnorm_weight
from ...ops import kernels


class _WNLinear(nn.Module):
    """Weight-normalised linear in the JAX layout: g (out,), v (in, out)."""

    def __init__(self, in_dim, out_dim, device):
        super().__init__()
        z = dict(device=device, dtype=torch.float32)
        self.g = nn.Parameter(torch.ones(out_dim, **z), requires_grad=False)
        self.v = nn.Parameter(torch.zeros(in_dim, out_dim, **z),
                              requires_grad=False)
        self.b = nn.Parameter(torch.zeros(out_dim, **z), requires_grad=False)

    def weight(self):
        return wnorm_weight(self.g, self.v)


class _Linear(nn.Module):
    """Plain linear in the JAX layout: w (in, out)."""

    def __init__(self, in_dim, out_dim, device):
        super().__init__()
        z = dict(device=device, dtype=torch.float32)
        self.w = nn.Parameter(torch.zeros(in_dim, out_dim, **z),
                              requires_grad=False)
        self.b = nn.Parameter(torch.zeros(out_dim, **z), requires_grad=False)

    def weight(self):
        return self.w


class NeuMesh(nn.Module):
    """NeuMesh field. Knob names follow the JAX NeuMesh so a JAX
    configuration reads the same here (TPU-only knobs are dropped)."""

    def __init__(self, mesh_grid: MeshGrid, D_density: int = 3,
                 D_color: int = 4, W: int = 256, geometry_dim: int = 32,
                 color_dim: int = 32, multires_view: int = 4,
                 multires_d: int = 8, multires_fg: int = 2,
                 multires_ft: int = 2, enable_nablas_input: bool = False,
                 ln_s: float = 0.2996, speed_factor: float = 1.0,
                 learn_indicator_weight: bool = True, compute_dtype=None,
                 max_candidates: int = 96, f32_layers: tuple = (),
                 scan_candidates: int = 0, tile_kp_per_probe: int = 0,
                 secant_full_precision: bool = True, scan_knn_k: int = 0,
                 tile_cell_budget: int = 0, secant_rebracket: bool = True,
                 secant_frozen_knn: bool = False, eval_candidates: int = 0,
                 device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        if mesh_grid.device.type != dev.type:
            raise ValueError(f"mesh_grid on {mesh_grid.device}, model on "
                             f"{dev}")
        self.device = dev
        self.mesh_grid = mesh_grid
        self.num_vertices = mesh_grid.get_number_of_vertices()
        self.D_density, self.D_color, self.W = D_density, D_color, W
        self.geometry_dim, self.color_dim = geometry_dim, color_dim
        self.speed_factor = speed_factor
        self.ln_s_init = ln_s
        self.learn_indicator_weight = learn_indicator_weight
        self.enable_nablas_input = enable_nablas_input
        self.compute_dtype = compute_dtype
        self.max_candidates = max_candidates
        self.f32_layers = tuple(f32_layers)
        self.scan_candidates = scan_candidates
        self.tile_kp_per_probe = tile_kp_per_probe
        self.secant_full_precision = secant_full_precision
        self.scan_knn_k = scan_knn_k
        self.tile_cell_budget = tile_cell_budget
        self.secant_rebracket = secant_rebracket
        self.secant_frozen_knn = secant_frozen_knn
        self.eval_candidates = eval_candidates

        exact = compute_dtype is None
        # the field kernels take a scalar distance and 3-d view directions
        self.embed_fn_d, self.input_ch_d = get_embedder(
            multires_d, input_dim=1, exact=exact)
        self.embed_fn_view, self.input_ch_view = get_embedder(
            multires_view, input_dim=3, exact=exact)
        self.embed_fn_fg, self.input_ch_fg = get_embedder(
            multires_fg, input_dim=geometry_dim, exact=exact)
        self.embed_fn_ft, self.input_ch_ft = get_embedder(
            multires_ft, input_dim=color_dim, exact=exact)
        self.input_ch_pts = self.input_ch_d + self.input_ch_fg
        self.input_ch_color = (self.input_ch_view + self.input_ch_ft
                               + self.input_ch_d
                               + (3 if enable_nablas_input else 0))

        z = dict(device=dev, dtype=torch.float32)
        N = self.num_vertices

        def par(t):
            return nn.Parameter(t, requires_grad=False)

        self.ln_s = par(torch.full((1,), ln_s, **z))
        self.geometry_features = par(torch.zeros(N, geometry_dim, **z))
        self.color_features = par(torch.zeros(N, color_dim, **z))
        self.indicator_vector = par(mesh_grid.vertex_normals.clone())
        self.indicator_weight_raw = (par(torch.full((1,), -2.0, **z))
                                     if learn_indicator_weight else None)
        self.pts_linears = nn.ModuleList(
            [_WNLinear(self.input_ch_pts, W, dev)]
            + [_WNLinear(W, W, dev) for _ in range(D_density - 1)])
        self.density_linear = _WNLinear(W, 1, dev)
        self.views_linears = nn.ModuleList(
            [_Linear(self.input_ch_color, W, dev)]
            + [_Linear(W, W, dev) for _ in range(D_color - 1)])
        self.color_linear = _Linear(W, 3, dev)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def init(self, seed: int = 0) -> "NeuMesh":
        """Parameters from a numpy seed: N(0, 1) feature codes, indicator
        vectors = vertex normals, torch-default uniform linears with
        weight-norm g = ||v||_col."""
        rng = np.random.default_rng(seed)

        def put(p, a):
            p.copy_(torch.as_tensor(np.asarray(a, np.float32)))

        put(self.ln_s, [self.ln_s_init])
        put(self.geometry_features, rng.standard_normal(
            tuple(self.geometry_features.shape)))
        put(self.color_features, rng.standard_normal(
            tuple(self.color_features.shape)))
        self.indicator_vector.copy_(self.mesh_grid.vertex_normals)
        if self.indicator_weight_raw is not None:
            put(self.indicator_weight_raw, [-2.0])
        for lin in [*self.pts_linears, self.density_linear,
                    *self.views_linears, self.color_linear]:
            w = lin.weight()
            bound = 1.0 / math.sqrt(w.shape[0])
            wv = rng.uniform(-bound, bound, tuple(w.shape))
            put(lin.b, rng.uniform(-bound, bound, tuple(lin.b.shape)))
            if isinstance(lin, _WNLinear):
                put(lin.v, wv)
                put(lin.g, np.linalg.norm(wv, axis=0))
            else:
                put(lin.w, wv)
        return self

    def forward_s(self):
        return torch.exp(self.ln_s[0] * self.speed_factor)

    def forward_indicator_weight(self):
        if self.learn_indicator_weight:
            return torch.sigmoid(self.indicator_weight_raw[0])
        return torch.tensor(0.1, device=self.device)

    # ------------------------------------------------------------------
    # tile-shared candidate contexts
    # ------------------------------------------------------------------
    def make_tile_context(self, rays_o, rays_d, near, far, tile: int,
                          n_probes: int = 16, kp_per_probe=None,
                          max_candidates=None):
        """Tile-shared candidate cache. rays_o/d (R, 3) with consecutive
        rays grouped into tiles of `tile`; near/far (R, 1). Returns a dict
        of (R // tile, C, ...) tensors; candidates are proximity-ranked
        (nearest the tile's centroid segment first) when more than
        max_candidates survive the dedup."""
        grid = self.mesh_grid.grid
        dev = rays_o.device
        R = rays_o.shape[0]
        T = tile
        Rt = R // T
        n_verts = self.num_vertices
        if max_candidates is None:
            max_candidates = max(self.max_candidates, 128)

        # staggered probe depths: ray r of a tile probes at (p + r/T)/P
        r_in_tile = (torch.arange(R, device=dev) % T).to(torch.float32)
        t = (torch.arange(n_probes, device=dev,
                          dtype=torch.float32)[None, :]
             + r_in_tile[:, None] / T) / n_probes
        z = near + (far - near) * t
        probes = rays_o[:, None, :] + z[..., None] * rays_d[:, None, :]
        dims = grid.dims
        flat = self._flat_cells(probes)                        # (R, P)
        kp = (min(kp_per_probe, grid.Kp) if kp_per_probe is not None
              else grid.Kp)

        cb = self.tile_cell_budget
        if cb and cb < T * flat.shape[-1]:
            # cell-level pre-rank: dedup the tile's probe cells and expand
            # only the cb cells nearest the tile's centroid segment
            cells = torch.sort(flat.reshape(Rt, -1), dim=-1).values
            dupc = torch.cat(
                [torch.zeros((Rt, 1), dtype=torch.bool, device=dev),
                 cells[:, 1:] == cells[:, :-1]], dim=-1)
            d12 = dims[1] * dims[2]
            c0 = cells // d12
            c1 = (cells // dims[2]) % dims[1]
            c2 = cells % dims[2]
            h = 1.0 / grid.inv_h
            ccx = grid.origin[0] + (c0.to(torch.float32) + 0.5) * h
            ccy = grid.origin[1] + (c1.to(torch.float32) + 0.5) * h
            ccz = grid.origin[2] + (c2.to(torch.float32) + 0.5) * h
            o_cc, d_cc, nr_t, fr_t = _tile_segment(rays_o, rays_d, near,
                                                   far, Rt, T)
            d2c = _segment_d2(ccx, ccy, ccz, o_cc, d_cc, nr_t, fr_t)
            key = torch.where(dupc, torch.full_like(d2c, math.inf), d2c)
            order = torch.sort(key, dim=-1, stable=True).indices
            flat = torch.gather(cells, -1, order)[:, :cb]

        cand = grid.cand_idx[:, :kp][grid.cell_row[flat]]
        ids = torch.sort(cand.reshape(Rt, -1).to(torch.int64),
                         dim=-1).values
        dup = torch.cat([torch.zeros((Rt, 1), dtype=torch.bool, device=dev),
                         ids[:, 1:] == ids[:, :-1]], dim=-1)
        ids = torch.where(dup, torch.full_like(ids, n_verts), ids)

        ranked = ids.shape[1] > max_candidates
        if ranked:
            o_c, d_c, near_t, far_t = _tile_segment(rays_o, rays_d, near,
                                                    far, Rt, T)
            vp = self._verts_ext()[ids]                       # (Rt, C0, 3)
            d2_seg = _segment_d2(vp[..., 0], vp[..., 1], vp[..., 2], o_c,
                                 d_c, near_t, far_t)
            order = torch.sort(d2_seg, dim=-1, stable=True).indices
            ids = torch.gather(ids, -1, order)[:, :max_candidates]

        ctx = self._pack_ctx(ids)
        ctx["_ranked"] = ranked
        return ctx

    def _flat_cells(self, probes):
        grid = self.mesh_grid.grid
        dims = torch.as_tensor(grid.dims, device=probes.device)
        cell = torch.floor((probes - grid.origin) * grid.inv_h).to(
            torch.int64)
        cell = torch.minimum(torch.clamp(cell, min=0), dims - 1)
        return (cell[..., 0] * dims[1] + cell[..., 1]) * dims[2] \
            + cell[..., 2]

    def _verts_ext(self):
        v = self.mesh_grid.vertices
        return torch.cat([v, torch.full((1, 3), 1e9, device=v.device)], 0)

    def _pack_ctx(self, ids):
        """Candidate tables for compacted ids; id == num_vertices is the
        duplicate/missing sentinel (vertex at 1e9, zero indicator and
        features)."""
        pts = self._verts_ext()[ids]                          # (Rt, C, 3)
        ind_ext = torch.cat([self.indicator_vector,
                             torch.zeros((1, 3), device=ids.device)], 0)
        ind = ind_ext[ids]
        pp = torch.sum(pts * pts, dim=-1)
        vn = torch.sum(pts * ind, dim=-1)
        ctx = {"ids": ids, "pts": pts, "pp": pp, "ind": ind, "vn": vn,
               "geo": torch.cat([pts.transpose(1, 2), ind.transpose(1, 2),
                                 pp[:, None, :], vn[:, None, :]],
                                dim=1).contiguous()}
        feat = torch.cat([self.geometry_features, self.color_features], -1)
        feat_ext = torch.cat(
            [feat, torch.zeros((1, feat.shape[1]), device=ids.device)], 0)
        ctx["feat"] = feat_ext[ids]
        return ctx

    def bind_rays_tiled(self, rays_o, rays_d, near, far, tile: int,
                        max_candidates=None):
        """One tile-shared candidate cache over [near, far], near/far
        tightened from the same candidate geometry. Returns
        (TileBoundNeuMesh, near, far), or None for tile <= 1 or a ray count
        that is not a tile multiple."""
        if tile <= 1:
            return None
        # the tile's union covers tile * n_probes staggered depths, so the
        # per-ray probe count shrinks as tiles grow
        n_probes = int(min(16, max(2, 256 // tile)))
        ro = rays_o.reshape(-1, 3)
        rd = rays_d.reshape(-1, 3)
        if ro.shape[0] % tile:
            return None
        nr = near.reshape(-1, 1)
        fr = far.reshape(-1, 1)
        ctx = self.make_tile_context(
            ro, rd, nr, fr, tile, n_probes,
            kp_per_probe=self.tile_kp_per_probe or None,
            max_candidates=max_candidates)
        near_new, far_new = candidate_bounded_near_far_tiled(
            ctx, ro, rd, nr, fr, tile)
        return (TileBoundNeuMesh(self, ctx, tile),
                near_new.reshape(near.shape), far_new.reshape(far.shape))


def _tile_segment(rays_o, rays_d, near, far, Rt, T):
    """Per tile: centroid origin, unit centroid direction, min near and
    max far, each (Rt, 1)-broadcastable."""
    # sequential sums (the reduction order of the JAX reference on the
    # CPU; the ranking is a heuristic, any order is valid on the card)
    o_c = torch.cumsum(rays_o.reshape(Rt, T, 3), dim=1)[:, -1] / T
    d_c = torch.cumsum(rays_d.reshape(Rt, T, 3), dim=1)[:, -1] / T
    d_c = d_c / torch.clamp(
        torch.linalg.vector_norm(d_c, dim=-1, keepdim=True), min=1e-12)
    near_t = torch.amin(near.reshape(Rt, T), dim=1)[:, None]
    far_t = torch.amax(far.reshape(Rt, T), dim=1)[:, None]
    return o_c, d_c, near_t, far_t


def _segment_d2(px, py, pz, o, d, lo, hi):
    """Squared distance of points (Rt, n) to the segment o + u d, u in
    [lo, hi]: |ov|^2 - (2 t - u) u with t = ov.d, u = clip(t, lo, hi)."""
    ov0 = px - o[:, None, 0]
    ov1 = py - o[:, None, 1]
    ov2 = pz - o[:, None, 2]
    t_c = ov0 * d[:, None, 0] + ov1 * d[:, None, 1] + ov2 * d[:, None, 2]
    u = torch.minimum(torch.maximum(t_c, lo), hi)
    return ov0 * ov0 + ov1 * ov1 + ov2 * ov2 - (2.0 * t_c - u) * u


def candidate_bounded_near_far_tiled(ctx, rays_o, rays_d, near, far,
                                     tile: int,
                                     distance_thresh: float = 0.1):
    """Per-ray near/far tightened to where the ray passes within
    distance_thresh of a tile candidate vertex (closed form), clamped to
    the input bounds, with the reference's 'too close' widening."""
    R = rays_o.shape[0]
    Rt = R // tile
    pts = ctx["pts"]
    o = rays_o.reshape(Rt, tile, 1, 3)
    d = rays_d.reshape(Rt, tile, 1, 3)
    ov = pts[:, None, :, :] - o                              # (Rt, T, C, 3)
    t_c = torch.sum(ov * d, dim=-1)
    d_perp2 = torch.sum(ov * ov, dim=-1) - t_c * t_c
    s2 = distance_thresh * distance_thresh - d_perp2
    covered = s2 > 0
    s = torch.sqrt(torch.where(covered, s2, torch.ones_like(s2))) * covered
    nr = near.reshape(Rt, tile, 1)
    fr = far.reshape(Rt, tile, 1)
    t_lo = torch.where(covered, t_c - s, torch.full_like(s, 1e10))
    t_hi = torch.where(covered, t_c + s, torch.full_like(s, -1e10))
    near_new = torch.amin(t_lo, dim=-1, keepdim=True)
    far_new = torch.amax(t_hi, dim=-1, keepdim=True)
    near_new = torch.minimum(torch.maximum(near_new, nr), fr)
    far_new = torch.minimum(torch.maximum(far_new, nr), fr)
    hit = torch.any(covered, dim=-1, keepdim=True)
    near_new = torch.where(hit, near_new, nr)
    far_new = torch.where(hit, far_new, fr)
    too_close = (far_new - near_new) < 0.1
    far_new = torch.where(too_close, far_new + 0.05, far_new)
    near_new = torch.where(too_close, near_new - 0.05, near_new)
    return near_new.reshape(R, 1), far_new.reshape(R, 1)


class TileBoundNeuMesh:
    """A NeuMesh bound to tile-shared candidate caches: `tile` consecutive
    rays share one (C, ...) candidate set; a sample query (R, S, 3) is
    answered as (R // tile, tile * S) samples per tile by the fused
    kernels."""

    def __init__(self, model: NeuMesh, ctx: dict, tile: int):
        self.model = model
        self.ctx = ctx
        self.tile = tile
        self._weights = {}
        self._w1 = None

    def _flat(self, x):
        """(R, S, d) -> (R // tile, tile * S, d)."""
        return x.reshape(-1, self.tile * x.shape[1], *x.shape[2:])

    def _unflat(self, y):
        """(R // tile, tile * S, ...) -> (R, S, ...)."""
        return y.reshape(-1, y.shape[1] // self.tile, *y.shape[2:])

    def forward_s(self):
        return self.model.forward_s()

    def _indicator_weight(self) -> float:
        """w1 as a host float, read back from the device once per binding
        (each read waits for the device's queue)."""
        if self._w1 is None:
            self._w1 = float(self.model.forward_indicator_weight())
        return self._w1

    def _field_weights(self, f32_override=None):
        """Weight-norm folded (in, out) weights and (1, out) f32 biases,
        cast to the serving dtype except for layers tagged in f32_layers
        ('density', 'd0', 'dh', 'color', 'c0', 'ch'); the density first
        layer split into its d-embedding / fg row blocks. f32_override
        replaces the tag set (() for the low-precision secant)."""
        key = None if f32_override is None else tuple(f32_override)
        if key in self._weights:
            return self._weights[key]
        m = self.model
        dt = m.compute_dtype
        f32 = m.f32_layers if f32_override is None else f32_override

        def eff(lin, *tags):
            w = lin.weight()
            if dt is None or any(t in f32 for t in tags):
                return w.contiguous()
            return w.to(dt).contiguous()

        p0 = m.pts_linears[0]
        w0 = eff(p0, "density", "d0")
        dws = [w0[:m.input_ch_d], w0[m.input_ch_d:], p0.b[None]]
        for p in m.pts_linears[1:]:
            dws += [eff(p, "density"), p.b[None]]
        dws += [eff(m.density_linear, "density", "dh"),
                m.density_linear.b[None]]
        c0 = m.views_linears[0]
        cws = [eff(c0, "color", "c0"), c0.b[None]]
        for p in m.views_linears[1:]:
            cws += [eff(p, "color"), p.b[None]]
        cws += [eff(m.color_linear, "color", "ch"), m.color_linear.b[None]]
        self._weights[key] = (tuple(dws), tuple(cws))
        return self._weights[key]

    def _scan_ctx_slice(self, geo, feat=None):
        """(geo, feat) cut to the scan_candidates nearest prefix when the
        context is proximity-ranked."""
        cs = self.model.scan_candidates
        if cs and self.ctx.get("_ranked", False):
            cs = min(cs, geo.shape[2])
            geo = geo[:, :, :cs].contiguous()
            feat = None if feat is None else feat[:, :cs]
        return geo, feat

    def _eval_ctx_slice(self):
        geo, feat = self.ctx["geo"], self.ctx["feat"]
        ec = self.model.eval_candidates
        if ec and self.ctx.get("_ranked", False) and ec < geo.shape[2]:
            return geo[:, :, :ec].contiguous(), feat[:, :ec]
        return geo, feat

    def _fused_field(self, xyz, want: str, dirs=None):
        m = self.model
        w1 = self._indicator_weight()
        if want == "distance":
            geo, _ = self._scan_ctx_slice(self.ctx["geo"])
            return kernels.field_fused(
                xyz, geo, geo.new_zeros((geo.shape[0], geo.shape[2], 1)),
                w1, (), want="distance", k=m.scan_knn_k or 8)
        dws, cws = self._field_weights()
        geo, feat = self._eval_ctx_slice()
        feat = feat if want == "full" else feat[..., :m.geometry_dim]
        return kernels.field_fused(
            xyz, geo, feat, w1, dws, cws if want == "full" else None, dirs,
            want=want, multires_d=m.embed_fn_d.multires,
            multires_fg=m.embed_fn_fg.multires,
            multires_ft=m.embed_fn_ft.multires,
            multires_view=m.embed_fn_view.multires,
            geometry_dim=m.geometry_dim, dtype=m.compute_dtype)

    def fused_secant(self, rays_o, rays_d, d_low, d_high, f_low, f_high,
                     n_iters: int = 6, logit_tau: float = 0.0,
                     d_low_w=None, d_high_w=None):
        """All secant iterations in one kernel launch; rays in binding
        order. d_low_w/d_high_w fold the density re-bracket into the same
        launch. Returns d_pred (R,)."""
        m = self.model
        dws, _ = self._field_weights(
            f32_override=None if m.secant_full_precision else ())
        geo, feat = self._scan_ctx_slice(
            self.ctx["geo"], self.ctx["feat"][..., :m.geometry_dim])
        return kernels.secant_refine(
            rays_o, rays_d, d_low, d_high, f_low, f_high, geo, feat,
            self._indicator_weight(), dws, n_iters=n_iters,
            multires_d=m.embed_fn_d.multires,
            multires_fg=m.embed_fn_fg.multires,
            geometry_dim=m.geometry_dim, dtype=m.compute_dtype,
            logit_tau=logit_tau, d_low_w=d_low_w, d_high_w=d_high_w,
            frozen_knn=m.secant_frozen_knn)

    def compute_distance(self, xyz):
        """Interpolated mesh distance (R, S, 1) (the scan proxy, k =
        scan_knn_k or 8)."""
        out = self._fused_field(self._flat(xyz), "distance")
        return self._unflat(out[0][..., None])

    def forward_density_only(self, xyz):
        """sdf (R, S)."""
        return self._unflat(self._fused_field(self._flat(xyz),
                                              "density")[0])

    def forward(self, xyz, view_dirs):
        """(sdf (R, S), rgb (R, S, 3)) from one fused 'full' launch."""
        if not self.model.enable_nablas_input:
            raise NotImplementedError(
                "the fused colour path needs enable_nablas_input=True")
        out = self._fused_field(self._flat(xyz), "full",
                                dirs=self._flat(view_dirs))
        return (self._unflat(out[0]),
                self._unflat(torch.stack(out[4:7], dim=-1)))
