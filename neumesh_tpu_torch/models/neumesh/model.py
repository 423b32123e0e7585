"""NeuMesh (counterpart of neumesh_tpu/models/neumesh/model.py, the
render path).

Per-vertex geometry/colour feature codes and learnable indicator vectors
on a fixed mesh scaffold, decoded by a density MLP (input: the embedded
kNN-interpolated signed distance and geometry feature) and a colour MLP
(input: [nabla, d_emb, view_emb, ft_emb]).

Three ways to answer a sample query:
  - unbound (NeuMesh.forward...): kNN through the mesh grid per sample
    (the per-sample protocol; brute-force kNN without a grid);
  - per-ray contexts (make_ray_context / bind_rays -> RayBoundNeuMesh):
    each ray gathers its own candidate set once, every sample of the ray
    is answered from it;
  - tile-shared contexts (make_tile_context / bind_rays_tiled ->
    TileBoundNeuMesh): `tile` consecutive rays share ONE candidate set.
A bound model runs the fused field kernels of ops/kernels.py against its
contexts' (8, C) packed geometry and (C, F) features when use_pallas is
set, else the differentiable context math of NeuMesh._ctx_* in plain
torch (the JAX package's XLA route, the one training differentiates).
The renderer's up-sampling density takes the field_fused kernel on the
card either way (forward_density_only_nograd).
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ... import resolve_device
from ...mesh.grid import MeshGrid
from ...nn import (Linear, WNLinear, get_embedder, maybe_wnorm_apply,
                   maybe_wnorm_apply_parts, softplus100)
from ...ops import interp, kernels
from ...utils.trace import count, span, spanned


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
                 use_pallas: bool = False,
                 max_candidates: int = 96, f32_layers: tuple = (),
                 scan_candidates: int = 0, tile_kp_per_probe: int = 0,
                 use_fused_locate: bool = False,
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
        # the fused field kernels on the bound models' routes; off, they
        # run the context math (forward_density_only_nograd excepted)
        self.use_pallas = use_pallas
        self.max_candidates = max_candidates
        self.f32_layers = tuple(f32_layers)
        self.scan_candidates = scan_candidates
        self.tile_kp_per_probe = tile_kp_per_probe
        # the surface render's whole root search in one surface_locate
        # launch instead of the scan + fused secant
        self.use_fused_locate = use_fused_locate
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
            [WNLinear(self.input_ch_pts, W, dev)]
            + [WNLinear(W, W, dev) for _ in range(D_density - 1)])
        self.density_linear = WNLinear(W, 1, dev)
        self.views_linears = nn.ModuleList(
            [Linear(self.input_ch_color, W, dev)]
            + [Linear(W, W, dev) for _ in range(D_color - 1)])
        self.color_linear = Linear(W, 3, dev)

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
            if isinstance(lin, WNLinear):
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

    def read_indicator_weight(self) -> float:
        """w1 read back to the host; the read waits for the device's
        queue."""
        w1 = self.forward_indicator_weight()
        count("host_read")          # blocks: a read back to the host
        with span("sync.indicator_weight"):
            return float(w1)

    def frame_indicator_weight(self):
        """w1 on the host for every binding of one frame, read where they
        will use it (use_pallas with a candidate grid), else None. A frame
        entry calls it before its first launch, while the queue is
        empty."""
        if self.use_pallas and self.mesh_grid.grid is not None:
            return self.read_indicator_weight()
        return None

    # ------------------------------------------------------------------
    # MLPs on interpolated inputs (plain torch, outside any kernel)
    # ------------------------------------------------------------------
    def _density_from_interp(self, ds, fg):
        """Geometry MLP on (embedded ds, embedded fg) -> (density (..., 1)
        f32, d_emb). Every layer runs in compute_dtype (f32_layers do not
        apply here); d_emb stays f32 and fg is embedded after the cast.
        With the geometry codes frozen (the painting step) fg carries no
        gradient: it blends the codes alone, but from a context tensor
        whose colour columns train, so autograd would otherwise run the
        density, the sample weights and the nablas backward for nothing."""
        if not self.geometry_features.requires_grad:
            fg = fg.detach()
        return self._density_mlp(ds, fg, self.compute_dtype)

    def _density_mlp(self, ds, fg, dt):
        d_emb = self.embed_fn_d(ds)
        fg_emb = self.embed_fn_fg(fg if dt is None else fg.to(dt))
        h = softplus100(maybe_wnorm_apply_parts(self.pts_linears[0],
                                                [d_emb, fg_emb], dt))
        for p in self.pts_linears[1:]:
            h = softplus100(maybe_wnorm_apply(p, h, dt))
        density = maybe_wnorm_apply(self.density_linear, h, dt)
        return density.to(torch.float32), d_emb

    def _color_from_interp(self, d_emb, view_dirs, ft, nabla):
        """Colour MLP on [nabla (with nablas input), d_emb, view_emb,
        ft_emb] -> rgb (..., 3) f32, every layer in compute_dtype."""
        return self._color_mlp(d_emb, view_dirs, ft, nabla,
                               self.compute_dtype)

    def _color_mlp(self, d_emb, view_dirs, ft, nabla, dt):
        parts = [nabla] if self.enable_nablas_input else []
        parts += [d_emb, self.embed_fn_view(view_dirs),
                  self.embed_fn_ft(ft if dt is None else ft.to(dt))]
        h = torch.relu(maybe_wnorm_apply_parts(self.views_linears[0], parts,
                                               dt))
        for p in self.views_linears[1:]:
            h = torch.relu(maybe_wnorm_apply(p, h, dt))
        logits = maybe_wnorm_apply(self.color_linear, h, dt)
        return torch.sigmoid(logits.to(torch.float32))

    # ------------------------------------------------------------------
    # per-sample protocol: kNN through the mesh grid, every layer in f32
    # ------------------------------------------------------------------
    def compute_distance(self, xyz, K: int = 8):
        """(ds (..., 1), indices (..., K), weights (..., K))."""
        return self.mesh_grid.compute_distance(
            xyz, indicator_vector=self.indicator_vector,
            indicator_weight=self.forward_indicator_weight(), K=K)

    def _knn(self, xyz, K: int = 8):
        sq, idx = self.mesh_grid.knn(xyz, K)
        return interp.knn_weights(sq), idx

    def _density_from_parts(self, ds, indices, weights):
        fg = interp.interpolate_features(self.geometry_features, indices,
                                         weights)
        return self._density_mlp(ds, fg, None)

    def _color_from_parts(self, d_emb, view_dirs, indices, weights, nabla):
        ft = interp.interpolate_features(self.color_features, indices,
                                         weights)
        return self._color_mlp(d_emb, view_dirs, ft, nabla, None)

    def _density_and_nabla(self, xyz, indices, weights):
        """(density, nabla, d_emb) with the kNN selection fixed: the
        density depends on xyz only through the scalar h, so nabla =
        dDensity/dh * grad_x h (one scalar-tangent jvp through the MLP
        and the gradient of h)."""
        indices, weights = indices.detach(), weights.detach()
        ds, dh_dx = interp.interpolated_distance_and_grad(
            xyz, self.mesh_grid.vertices[indices],
            self.indicator_vector[indices], weights,
            self.forward_indicator_weight())
        fg = interp.interpolate_features(self.geometry_features, indices,
                                         weights)
        (density, d_emb), (dD_dh, _) = torch.func.jvp(
            lambda d: self._density_mlp(d, fg, None), (ds,),
            (torch.ones_like(ds),))
        return density, dD_dh * dh_dx, d_emb

    def forward(self, xyz, view_dirs):
        """(sdf (...,), rgb (..., 3))."""
        ds, indices, weights = self.compute_distance(xyz)
        if self.enable_nablas_input:
            density, nabla, d_emb = self._density_and_nabla(xyz, indices,
                                                            weights)
        else:
            density, d_emb = self._density_from_parts(ds, indices, weights)
            nabla = None
        color = self._color_from_parts(d_emb, view_dirs, indices, weights,
                                       nabla)
        return density[..., 0], color

    def forward_density_only(self, xyz):
        ds, indices, weights = self.compute_distance(xyz)
        return self._density_from_parts(ds, indices, weights)[0][..., 0]

    def forward_color(self, ds, view_dirs, color_features, indices, weights,
                      nabla=None):
        """Colour from externally supplied per-vertex colour features (the
        editing hook): the colour MLP on [nabla, embedded ds, view, the
        kNN blend of color_features], every layer in f32."""
        ft = interp.interpolate_features(color_features, indices, weights)
        return self._color_mlp(self.embed_fn_d(ds), view_dirs, ft, nabla,
                               None)

    def forward_with_nablas(self, xyz):
        weights, indices = self._knn(xyz)
        density, nabla, _ = self._density_and_nabla(xyz, indices, weights)
        return density[..., 0], nabla

    # ------------------------------------------------------------------
    # the differentiable context math (the bound models' route without
    # use_pallas): kNN selection, interpolated distance and feature blend
    # over a context's C candidates as batched tensor math
    # ------------------------------------------------------------------
    def _ctx_distance_parts(self, ctx, xyz, K: int = 8,
                            want_grad: bool = False):
        """xyz (B, S, 3) against (B, C, ...) contexts -> (ds (B, S, 1), W
        (B, S, C) detached kNN weights[, dh (B, S, 3)]). ds is analytic in
        xyz and the indicator parameters; want_grad adds the closed-form
        spatial gradient of the interpolated distance,

            dh = A @ n + (sum_c B_c) x - B @ v,
            A_c = W_c w1 / (w1 + d_c)
            B_c = W_c (3 d_c^2 (w1 + d_c) - term_c) / ((w1 + d_c)^2 d_c).

        The kNN selection and its weights take the expanded d2 = |x|^2 +
        |v|^2 - 2 x.v, the rule the kernels and the JAX package state (x.v
        and x.n are exact f32 broadcasts, never a (TF32) dot: a ~1e-3 error
        in x.v flips the selection). The distance d of the analytic terms
        comes from the differences x - v: the expanded form cancels to 0
        for a sample ~2e-4 from a vertex, and the 1 / d of B_c then sends
        dh to thousands."""
        w1 = self.forward_indicator_weight()
        x0, x1, x2 = xyz[..., 0:1], xyz[..., 1:2], xyz[..., 2:3]
        pts, ind = ctx["pts"], ctx["ind"]
        p0, p1, p2 = (pts[:, None, :, k] for k in range(3))
        xv = x0 * p0 + x1 * p1 + x2 * p2                      # (B, S, C)
        xx = torch.sum(xyz * xyz, dim=-1)
        d2_rank = torch.clamp(xx[..., None] + ctx["pp"][:, None, :]
                              - 2.0 * xv, min=0.0).detach()
        # K argmin passes, exactly K picks: the index-proportional
        # perturbation sends near-ties toward the lower candidate index, and
        # a rank it makes equal goes to the lower index too (argmin's first
        # occurrence), where picking every candidate at the K-th rank took
        # K + 1 neighbours
        iota = torch.arange(d2_rank.shape[-1], device=d2_rank.device,
                            dtype=torch.float32) * 2e-7
        cur = d2_rank * (1.0 + iota)
        mask = torch.zeros_like(cur, dtype=torch.bool)
        for _ in range(min(K, cur.shape[-1])):
            pick = torch.argmin(cur, dim=-1, keepdim=True)
            mask.scatter_(-1, pick, True)
            cur.scatter_(-1, pick, math.inf)
        w_raw = mask * (1.0 / (torch.sqrt(d2_rank) + 1e-7))
        W = (w_raw / torch.sum(w_raw, dim=-1, keepdim=True)).detach()

        d2 = (x0 - p0) ** 2 + (x1 - p1) ** 2 + (x2 - p2) ** 2
        d = torch.sqrt(torch.clamp(d2, min=1e-20))            # analytic
        xn = (x0 * ind[:, None, :, 0] + x1 * ind[:, None, :, 1]
              + x2 * ind[:, None, :, 2])
        inv = 1.0 / (w1 + d)
        term = w1 * (xn - ctx["vn"][:, None, :]) + d * d2
        ds = torch.sum(W * term * inv, dim=-1, keepdim=True)
        if not want_grad:
            return ds, W
        A = W * (w1 * inv)
        Bc = W * (3.0 * d2 * (w1 + d) - term) * inv * inv / d
        dh = torch.stack(
            [torch.sum(A * ind[:, None, :, k] - Bc * pts[:, None, :, k],
                       dim=-1) for k in range(3)], dim=-1) \
            + torch.sum(Bc, dim=-1, keepdim=True) * xyz
        return ds, W, dh

    def _ctx_interp_feats(self, ctx, W, lo=None, hi=None):
        """One batched product W @ feat[..., lo:hi] -> (B, S, F): true f32
        in the f32 mode; in a low-precision mode both operands rounded to
        it, products exact and sums in f32."""
        dt = self.compute_dtype
        feat = ctx["feat"][..., lo:hi]
        if dt is None:
            return torch.matmul(W, feat)
        return torch.matmul(W.to(dt).to(torch.float32),
                            feat.to(dt).to(torch.float32))

    def _ctx_density(self, ctx, ds, W):
        fg = self._ctx_interp_feats(ctx, W, hi=self.geometry_dim)
        return self._density_from_interp(ds, fg)

    def _ctx_density_and_nabla(self, ctx, xyz, with_ft: bool = False):
        """(density, nabla, d_emb, W, ft | None); with_ft blends the colour
        features in the same product as the geometry features."""
        ds, W, dh_dx = self._ctx_distance_parts(ctx, xyz, want_grad=True)
        gd = self.geometry_dim
        if with_ft:
            feats = self._ctx_interp_feats(ctx, W)
            fg, ft = feats[..., :gd], feats[..., gd:]
        else:
            fg, ft = self._ctx_interp_feats(ctx, W, hi=gd), None
        (density, d_emb), (dD_dh, _) = torch.func.jvp(
            lambda d: self._density_from_interp(d, fg), (ds,),
            (torch.ones_like(ds),))
        return density, dD_dh * dh_dx, d_emb, W, ft

    def _ctx_color(self, ctx, d_emb, view_dirs, W, nabla):
        ft = self._ctx_interp_feats(ctx, W, lo=self.geometry_dim)
        return self._color_from_interp(d_emb, view_dirs, ft, nabla)

    # ------------------------------------------------------------------
    # per-ray candidate contexts
    # ------------------------------------------------------------------
    @spanned("ctx.build")
    def make_ray_context(self, rays_o, rays_d, near, far, n_probes: int = 8,
                         kp_per_probe=None, max_candidates=None,
                         for_bounds: bool = False):
        """Per-ray candidate cache: the union of the candidate lists of
        n_probes cells along each ray. rays_o/d (R, 3), near/far (R, 1).
        Returns a dict of (R, C, ...) tensors, or None without a grid
        (brute mode). Duplicates become the sentinel id; more than
        max_candidates survivors keep the ones nearest the ray segment.
        for_bounds=True returns only {"pts"} of the raw lists (enough for
        candidate_bounded_near_far: min/max ignore duplicates)."""
        grid = self.mesh_grid.grid
        if grid is None:
            return None
        R = rays_o.shape[0]
        dev = rays_o.device
        t = torch.linspace(0.0, 1.0, n_probes, device=dev)
        z = near + (far - near) * t                            # (R, P)
        probes = rays_o[:, None, :] + z[..., None] * rays_d[:, None, :]
        flat = self._flat_cells(probes)
        kp = (min(kp_per_probe, grid.Kp) if kp_per_probe is not None
              else grid.Kp)
        ids = grid.cand_idx[:, :kp][grid.cell_row[flat]].reshape(R, -1) \
            .to(torch.int64)
        if for_bounds:
            return {"pts": self._verts_ext()[ids]}
        if max_candidates is None:
            max_candidates = self.max_candidates
        ids = torch.sort(ids, dim=-1).values
        dup = torch.cat([torch.zeros((R, 1), dtype=torch.bool, device=dev),
                         ids[:, 1:] == ids[:, :-1]], dim=-1)
        ids = torch.where(dup, torch.full_like(ids, self.num_vertices), ids)
        if max_candidates is not None and ids.shape[1] > max_candidates:
            vp = self._verts_ext()[ids]                        # (R, C0, 3)
            d2_seg = _segment_d2(vp[..., 0], vp[..., 1], vp[..., 2], rays_o,
                                 rays_d, near, far)
            order = torch.sort(d2_seg, dim=-1, stable=True).indices
            ids = torch.gather(ids, -1, order)[:, :max_candidates]
        return self._pack_ctx(ids)

    def bind_rays(self, rays_o, rays_d, near, far, n_probes: int = 8,
                  w1=None):
        """A per-ray candidate binding of (R, 3) rays: RayBoundNeuMesh, or
        None without a grid. w1: the indicator weight already on the host
        (None: the binding reads it when its kernels first need it)."""
        ctx = self.make_ray_context(rays_o.reshape(-1, 3),
                                    rays_d.reshape(-1, 3),
                                    near.reshape(-1, 1), far.reshape(-1, 1),
                                    n_probes)
        return None if ctx is None else RayBoundNeuMesh(self, ctx, w1)

    # ------------------------------------------------------------------
    # tile-shared candidate contexts
    # ------------------------------------------------------------------
    @spanned("ctx.build")
    def make_tile_context(self, rays_o, rays_d, near, far, tile: int,
                          n_probes: int = 16, kp_per_probe=None,
                          max_candidates=None):
        """Tile-shared candidate cache. rays_o/d (R, 3) with consecutive
        rays grouped into tiles of `tile`; near/far (R, 1). Returns a dict
        of (R // tile, C, ...) tensors (None without a grid); candidates
        are proximity-ranked (nearest the tile's centroid segment first)
        when more than max_candidates survive the dedup."""
        grid = self.mesh_grid.grid
        if grid is None:
            return None
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
        # blocks: a copy from pageable host memory waits for the device's
        # queue
        count("host_read")
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
                        max_candidates=None, w1=None):
        """One tile-shared candidate cache over [near, far], near/far
        tightened from the same candidate geometry. Returns
        (TileBoundNeuMesh, near, far), or None for tile <= 1 or a ray count
        that is not a tile multiple. w1 as in bind_rays."""
        if self.mesh_grid.grid is None or tile <= 1:
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
            ctx, ro, rd, nr, fr, tile, fused=self.use_pallas)
        return (TileBoundNeuMesh(self, ctx, tile, w1),
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


@spanned("ctx.bounds")
def candidate_bounded_near_far_tiled(ctx, rays_o, rays_d, near, far,
                                     tile: int,
                                     distance_thresh: float = 0.1, *,
                                     fused: bool = False):
    """Per-ray near/far tightened to where the ray passes within
    distance_thresh of a tile candidate vertex (closed form), clamped to
    the input bounds, with the reference's 'too close' widening: one
    candidate_bounds launch with fused (the model's use_pallas) on CUDA,
    else candidate_bounds_plain, the same bits."""
    bounds = (kernels.candidate_bounds if fused
              else kernels.candidate_bounds_plain)
    return bounds(rays_o, rays_d, near, far, ctx["pts"], tile,
                  distance_thresh)


@spanned("ctx.bounds")
def candidate_bounded_near_far(ctx, rays_o, rays_d, near, far,
                               distance_thresh: float = 0.1):
    """Per-ray near/far tightened to where the ray passes within
    distance_thresh of one of its candidate vertices (closed form: t_c =
    <v - o, d>, d_perp^2 = |v - o|^2 - t_c^2, covered for t in t_c -+
    sqrt(thresh^2 - d_perp^2)), clamped to the input bounds, with the
    reference's 'too close' widening. rays (R, 3), near/far (R, 1)."""
    ov = ctx["pts"] - rays_o[:, None, :]                     # (R, C, 3)
    t_c = torch.sum(ov * rays_d[:, None, :], dim=-1)
    d_perp2 = torch.sum(ov * ov, dim=-1) - t_c * t_c
    s2 = distance_thresh * distance_thresh - d_perp2
    covered = s2 > 0
    s = torch.sqrt(torch.where(covered, s2, torch.ones_like(s2))) * covered
    t_lo = torch.where(covered, t_c - s, torch.full_like(s, 1e10))
    t_hi = torch.where(covered, t_c + s, torch.full_like(s, -1e10))
    near_new = torch.amin(t_lo, dim=-1, keepdim=True)
    far_new = torch.amax(t_hi, dim=-1, keepdim=True)
    near_new = torch.minimum(torch.maximum(near_new, near), far)
    far_new = torch.minimum(torch.maximum(far_new, near), far)
    hit = torch.any(covered, dim=-1, keepdim=True)
    near_new = torch.where(hit, near_new, near)
    far_new = torch.where(hit, far_new, far)
    too_close = (far_new - near_new) < 0.1
    far_new = torch.where(too_close, far_new + 0.05, far_new)
    near_new = torch.where(too_close, near_new - 0.05, near_new)
    return near_new, far_new


def _folder(m: NeuMesh, f32):
    """eff(linear, *tags): the layer's weight-norm folded (in, out) weight,
    cast to m.compute_dtype unless one of its tags is in f32."""
    dt = m.compute_dtype

    def eff(lin, *tags):
        w = lin.weight()
        if dt is None or any(t in f32 for t in tags):
            return w.contiguous()
        return w.to(dt).contiguous()
    return eff


def fold_color_weights(m: NeuMesh, f32=None):
    """The colour MLP's half of RayBoundNeuMesh._fold_weights: (w0, b0,
    [Wi, bi]..., wh, bh), the weights folded and cast to m.compute_dtype
    but the layers tagged in f32 (m.f32_layers by default: 'color', 'c0',
    'ch'), the biases (1, out) f32."""
    eff = _folder(m, m.f32_layers if f32 is None else f32)
    c0 = m.views_linears[0]
    cws = [eff(c0, "color", "c0"), c0.b[None]]
    for p in m.views_linears[1:]:
        cws += [eff(p, "color"), p.b[None]]
    cws += [eff(m.color_linear, "color", "ch"), m.color_linear.b[None]]
    return tuple(cws)


class RayBoundNeuMesh:
    """A NeuMesh bound to per-ray candidate caches: a sample query (R, S,
    3) of the R bound rays is answered from each ray's (C, ...) context,
    by the fused kernels with use_pallas, else by the context math."""

    def __init__(self, model: NeuMesh, ctx: dict, w1=None):
        self.model = model
        self.ctx = ctx
        self._weights = {}
        self._w1 = w1

    def _flat(self, x):
        """(R, S, d) -> (contexts, samples per context, d)."""
        return x

    def _unflat(self, y):
        return y

    def forward_s(self):
        return self.model.forward_s()

    def _indicator_weight(self) -> float:
        """w1 as a host float: the one the binding was made with, else read
        back from the device once per binding."""
        if self._w1 is None:
            self._w1 = self.model.read_indicator_weight()
        return self._w1

    def _field_weights(self, f32_override=None):
        """Weight-norm folded (in, out) weights and (1, out) f32 biases,
        cast to the serving dtype except for layers tagged in f32_layers
        ('density', 'd0', 'dh', 'color', 'c0', 'ch'); the density first
        layer split into its d-embedding / fg row blocks. f32_override
        replaces the tag set (() for the low-precision secant)."""
        key = None if f32_override is None else tuple(f32_override)
        if key not in self._weights:
            self._weights[key] = self._fold_weights(f32_override)
        return self._weights[key]

    @spanned("weights.fold")
    def _fold_weights(self, f32_override):
        m = self.model
        f32 = m.f32_layers if f32_override is None else f32_override
        eff = _folder(m, f32)
        p0 = m.pts_linears[0]
        w0 = eff(p0, "density", "d0")
        dws = [w0[:m.input_ch_d], w0[m.input_ch_d:], p0.b[None]]
        for p in m.pts_linears[1:]:
            dws += [eff(p, "density"), p.b[None]]
        dws += [eff(m.density_linear, "density", "dh"),
                m.density_linear.b[None]]
        return tuple(dws), fold_color_weights(m, f32)

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
        if torch.is_grad_enabled() and any(p.requires_grad
                                           for p in m.parameters()):
            # the kernels have no backward: the training route is the
            # context math (use_pallas off)
            raise RuntimeError("the fused field kernels have no backward; "
                               "train with model.use_pallas off")
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

    def _fused_density(self, xyz, need_ft: bool):
        """Density from the candidate_field_v3 kernel (ds + feature blend,
        full context) and the plain-torch density MLP ->
        (density (B, S', 1), d_emb, ft | None). The reachable branch of the
        JAX _fused_density_nabla: its callers never ask for nablas."""
        m = self.model
        gd = m.geometry_dim
        feat = self.ctx["feat"] if need_ft else self.ctx["feat"][..., :gd]
        ds, _, feats = kernels.candidate_field_v3(
            xyz, self.ctx["geo"], feat, self._indicator_weight(),
            want_dh=False)
        density, d_emb = m._density_from_interp(ds, feats[..., :gd])
        return density, d_emb, feats[..., gd:] if need_ft else None

    def fused_locate(self, rays_o, rays_d, near, far, n_steps: int = 24,
                     n_secant: int = 6, logit_tau: float = 0.0):
        """The whole surface root search (distance scan, bracket, density
        re-bracket, secant) in one surface_locate launch; rays in binding
        order, near/far (R,). The kernel's default k = 8 governs both the
        scan and the density, and the f32_layers are kept. Returns (d_pred,
        mask, mask_sign_change, val0_pos)."""
        m = self.model
        dws, _ = self._field_weights()
        geo, feat = self._scan_ctx_slice(
            self.ctx["geo"], self.ctx["feat"][..., :m.geometry_dim])
        return kernels.surface_locate(
            rays_o, rays_d, near, far, geo, feat, self._indicator_weight(),
            dws, n_steps=n_steps, n_secant=n_secant,
            multires_d=m.embed_fn_d.multires,
            multires_fg=m.embed_fn_fg.multires, geometry_dim=m.geometry_dim,
            dtype=m.compute_dtype, logit_tau=logit_tau)

    def compute_distance(self, xyz, K: int = 8):
        """(ds (R, S, 1), None, None): the renderers' bounded near/far and
        the surface scan consume only ds (k = scan_knn_k or K)."""
        m = self.model
        x = self._flat(xyz)
        if m.use_pallas:
            ds = self._fused_field(x, "distance")[0][..., None]
        else:
            ds, _ = m._ctx_distance_parts(self.ctx, x, m.scan_knn_k or K)
        return self._unflat(ds), None, None

    def forward_density_only(self, xyz):
        """sdf (R, S)."""
        m = self.model
        x = self._flat(xyz)
        if m.use_pallas:
            return self._unflat(self._fused_field(x, "density")[0])
        ds, W = m._ctx_distance_parts(self.ctx, x)
        return self._unflat(m._ctx_density(self.ctx, ds, W)[0][..., 0])

    @torch.no_grad()
    def forward_density_only_nograd(self, xyz):
        """The renderer's up-sampling density (sample placement, no
        gradient): the field_fused density kernel on the card whatever
        use_pallas says, as the JAX package runs it on the TPU; on the CPU
        the route of forward_density_only. Runs under no_grad on detached
        inputs, so neither the kernel nor the folded weights it is given
        carry a gradient."""
        xyz = xyz.detach()
        if not xyz.is_cuda:
            return self.forward_density_only(xyz)
        return self._unflat(self._fused_field(self._flat(xyz),
                                              "density")[0])

    def forward_with_nablas(self, xyz):
        """(sdf (R, S), nablas (R, S, 3)): one fused 'density_nabla'
        launch, or the context math with the closed-form dh."""
        m = self.model
        x = self._flat(xyz)
        if m.use_pallas:
            out = self._fused_field(x, "density_nabla")
            return (self._unflat(out[0]),
                    self._unflat(torch.stack(out[1:4], dim=-1)))
        density, nabla, _, _, _ = m._ctx_density_and_nabla(self.ctx, x)
        return self._unflat(density[..., 0]), self._unflat(nabla)

    def forward_full(self, xyz, view_dirs):
        """(sdf, rgb, nablas) at the same points: one fused 'full' launch
        with use_pallas and nablas input, else forward +
        forward_with_nablas."""
        m = self.model
        if m.use_pallas and m.enable_nablas_input and view_dirs is not None:
            out = self._fused_field(self._flat(xyz), "full",
                                    dirs=self._flat(view_dirs))
            return (self._unflat(out[0]),
                    self._unflat(torch.stack(out[4:7], dim=-1)),
                    self._unflat(torch.stack(out[1:4], dim=-1)))
        sdf, rgb = self.forward(xyz, view_dirs)
        _, nablas = self.forward_with_nablas(xyz)
        return sdf, rgb, nablas

    def forward(self, xyz, view_dirs):
        """(sdf (R, S), rgb (R, S, 3)). use_pallas: one fused 'full' launch
        with nablas input, else candidate_field_v3 and the plain-torch
        MLPs; without it the context math."""
        m = self.model
        x, v = self._flat(xyz), self._flat(view_dirs)
        if m.use_pallas and m.enable_nablas_input:
            out = self._fused_field(x, "full", dirs=v)
            return (self._unflat(out[0]),
                    self._unflat(torch.stack(out[4:7], dim=-1)))
        if m.use_pallas:
            density, d_emb, ft = self._fused_density(x, need_ft=True)
            nabla = None
        elif m.enable_nablas_input:
            density, nabla, d_emb, _, ft = m._ctx_density_and_nabla(
                self.ctx, x, with_ft=True)
        else:
            ds, W = m._ctx_distance_parts(self.ctx, x)
            feats = m._ctx_interp_feats(self.ctx, W)
            density, d_emb = m._density_from_interp(
                ds, feats[..., :m.geometry_dim])
            ft = feats[..., m.geometry_dim:]
            nabla = None
        color = m._color_from_interp(d_emb, v, ft, nabla)
        return self._unflat(density[..., 0]), self._unflat(color)


class TileBoundNeuMesh(RayBoundNeuMesh):
    """A NeuMesh bound to tile-shared candidate caches: `tile` consecutive
    rays share one (C, ...) candidate set; a sample query (R, S, 3) is
    answered as (R // tile, tile * S) samples per tile."""

    def __init__(self, model: NeuMesh, ctx: dict, tile: int, w1=None):
        super().__init__(model, ctx, w1)
        self.tile = tile

    def _flat(self, x):
        """(R, S, d) -> (R // tile, tile * S, d)."""
        return x.reshape(-1, self.tile * x.shape[1], *x.shape[2:])

    def _unflat(self, y):
        """(R // tile, tile * S, ...) -> (R, S, ...)."""
        return y.reshape(-1, y.shape[1] // self.tile, *y.shape[2:])
