"""The two fused NeuMesh field kernels of the volume path: wrappers,
launch counters and plain PyTorch versions.

  field_fused    <- neumesh_tpu/ops/pallas_kernels.py::_field_kernel
                    (csrc/field_fused.cu)
  secant_refine  <- neumesh_tpu/ops/pallas_kernels.py::_secant_kernel
                    (csrc/secant_refine.cu)

A wrapper launches its CUDA kernel for CUDA tensors (or raises) and uses
the plain version only for CPU tensors; nothing falls back. The plain
versions repeat the kernels' arithmetic with the same rounding points:
exact f32 element-wise candidate math, the d2*(1 + c*2e-7) tie-break
(lowest index wins), per-layer precision following each weight's dtype
(a bf16 layer rounds its inputs to bf16 and multiplies exactly in f32
with f32 accumulation; biases are f32), and the bf16 serving embeddings
of the TPU kernels.
"""
from __future__ import annotations

import math

import torch

from ..nn import softplus100, softplus100_grad

_N_OUT = {"distance": 1, "density": 1, "density_nabla": 4, "full": 7}

# launches of each kernel per mode, counted where the kernel is launched
LAUNCHES = {
    "field_fused": {w: 0 for w in _N_OUT},
    "secant_refine": {"plain": 0, "rebracket": 0, "frozen": 0,
                      "frozen_rebracket": 0},
}


def reset_launch_counts() -> None:
    for modes in LAUNCHES.values():
        for m in modes:
            modes[m] = 0


def secant_mode(rebracket: bool, frozen: bool) -> str:
    if frozen:
        return "frozen_rebracket" if rebracket else "frozen"
    return "rebracket" if rebracket else "plain"


# ---------------------------------------------------------------------------
# plain versions: shared pieces
# ---------------------------------------------------------------------------

def _emb_cols(x, n_freq: int, tangent: bool = False):
    """x (..., D) -> (..., D*2*n_freq) columns [sin(f0 x), cos(f0 x),
    sin(f1 x), ...] as one sin over a tiled copy, cos(z) = sin(z + pi/2);
    tangent=True also returns d cols / dx. None for n_freq <= 0."""
    if n_freq <= 0:
        return (None, None) if tangent else None
    D = x.shape[-1]
    xt = torch.cat([x] * (2 * n_freq), dim=-1)
    blk = torch.arange(D * 2 * n_freq, device=x.device) // D
    freq = torch.exp2((blk // 2).to(torch.float32))
    phase = (blk % 2).to(torch.float32) * (math.pi / 2.0)
    z = xt * freq + phase
    cols = torch.sin(z)
    if not tangent:
        return cols
    return cols, freq * torch.sin(z + math.pi / 2.0)


def _emb_cols_rec(x, n_freq: int):
    """Same columns by the double-angle recursion in x's dtype (bf16
    serving): base sin/cos in f32, rounded to x's dtype."""
    if n_freq <= 0:
        return None
    xf = x.to(torch.float32)
    s = torch.sin(xf).to(x.dtype)
    c = torch.cos(xf).to(x.dtype)
    parts = [s, c]
    for _ in range(n_freq - 1):
        s, c = 2.0 * s * c, c * c - s * s
        parts += [s, c]
    return torch.cat(parts, dim=-1)


def _emb_cols_wide(x, n_freq: int, dtype):
    return _emb_cols(x, n_freq) if dtype is None else _emb_cols_rec(x, n_freq)


def _cat(parts):
    parts = [p.to(torch.float32) for p in parts if p is not None]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


def _dot(a, w):
    """Per-layer precision follows the weight dtype: f32 weight -> true f32
    product; low-precision weight -> inputs rounded to its dtype, exact
    products, f32 accumulation."""
    if w.dtype == torch.float32:
        return a.to(torch.float32) @ w
    return a.to(w.dtype).to(torch.float32) @ w.to(torch.float32)


def _feat_dot(W, feat):
    """kNN feature blend W @ feat, precision following the feature dtype."""
    if feat.dtype == torch.float32:
        return W @ feat
    return W.to(feat.dtype).to(torch.float32) @ feat.to(torch.float32)


def _geo_rows(geo):
    return [geo[:, i:i + 1, :] for i in range(8)]          # (B, 1, C) each


def _interp_distance(x0, x1, x2, geo, w1, k: int, want_dh: bool):
    """Interpolated distance of (B, S, 1) points against (B, 8, C) contexts
    -> (ds (B, S, 1), W (B, S, C)[, (dhx, dhy, dhz)])."""
    px, py, pz, ix, iy, iz, pp, vn = _geo_rows(geo)
    C = geo.shape[-1]
    iota = torch.arange(C, device=geo.device, dtype=torch.float32)
    xv = x0 * px + x1 * py + x2 * pz
    xx = x0 * x0 + x1 * x1 + x2 * x2
    d2 = torch.clamp(xx + pp - 2.0 * xv, min=0.0)
    d2_tb = d2 * (1.0 + iota * 2e-7)

    if k == 1 and not want_dh:
        # nearest-tangent-plane proxy: one-hot argmin, then the sqrt/divide
        # chain on a single column
        thr1 = torch.amin(d2_tb, dim=-1, keepdim=True)
        fm = (d2_tb <= thr1).to(torch.float32)
        xn1 = x0 * ix + x1 * iy + x2 * iz
        d2s = torch.sum(fm * d2, dim=-1, keepdim=True)
        nvs = torch.sum(fm * (xn1 - vn), dim=-1, keepdim=True)
        dsel = torch.sqrt(torch.clamp(d2s, min=1e-20))
        return (w1 * nvs + dsel * d2s) / (w1 + dsel), fm

    cur = d2_tb
    thr = None
    for _ in range(k):
        thr = torch.amin(cur, dim=-1, keepdim=True)
        cur = torch.where(cur <= thr, torch.full_like(cur, math.inf), cur)
    mask = d2_tb <= thr
    d0 = torch.sqrt(d2)
    d = torch.clamp(d0, min=1e-10)
    w_raw = torch.where(mask, 1.0 / (d0 + 1e-7), torch.zeros_like(d0))
    W = w_raw / torch.sum(w_raw, dim=-1, keepdim=True)
    xn = x0 * ix + x1 * iy + x2 * iz
    inv = 1.0 / (w1 + d)
    term = w1 * (xn - vn) + d * d2
    ds = torch.sum(W * term * inv, dim=-1, keepdim=True)
    if not want_dh:
        return ds, W
    A = W * (w1 * inv)
    B = W * (3.0 * d2 * (w1 + d) - term) * inv * inv / d
    sB = torch.sum(B, dim=-1, keepdim=True)
    dhx = torch.sum(A * ix - B * px, dim=-1, keepdim=True) + sB * x0
    dhy = torch.sum(A * iy - B * py, dim=-1, keepdim=True) + sB * x1
    dhz = torch.sum(A * iz - B * pz, dim=-1, keepdim=True) + sB * x2
    return ds, W, (dhx, dhy, dhz)


def _density_mlp(ds, fg, dens_ws, multires_d, multires_fg, dtype,
                 want_tangent: bool):
    """Density MLP on interpolated inputs -> (dens, d_emb[, dD/dh])."""
    n_dens = (len(dens_ws) - 3) // 2
    w0d, w0f, b0 = dens_ws[0], dens_ws[1], dens_ws[2]
    if dtype is not None:
        fg = fg.to(dtype)
    if want_tangent:
        dcols, ddcols = _emb_cols(ds, multires_d, tangent=True)
        t = _dot(_cat([torch.ones_like(ds), ddcols]), w0d)
    else:
        dcols = _emb_cols(ds, multires_d)
    d_emb = _cat([ds, dcols])
    fg_emb = _emb_cols_wide(fg, multires_fg, dtype)
    head = _cat([ds, dcols, fg])
    nfg = fg.shape[-1]
    w_head = torch.cat([w0d, w0f[:nfg]], dim=0)
    pre = _dot(head, w_head) + b0[0]
    if fg_emb is not None:
        pre = pre + _dot(fg_emb, w0f[nfg:])
    h = softplus100(pre)
    if want_tangent:
        t = t * softplus100_grad(pre)
    wi = 3
    for _ in range(n_dens - 1):
        wl, bl = dens_ws[wi], dens_ws[wi + 1]
        wi += 2
        pre = _dot(h, wl) + bl[0]
        h = softplus100(pre)
        if want_tangent:
            t = _dot(t, wl) * softplus100_grad(pre)
    wh, bh = dens_ws[wi], dens_ws[wi + 1]
    dens = _dot(h, wh) + bh[0]
    if not want_tangent:
        return dens, d_emb
    return dens, d_emb, _dot(t, wh)


def _color_mlp(nabla, d_emb, vdir, ft, col_ws, multires_ft, multires_view,
               dtype):
    """Colour MLP on [nabla, d_emb, vdir, view_emb, ft | ft_emb] -> rgb."""
    n_col = (len(col_ws) - 2) // 2
    if dtype is not None:
        ft = ft.to(dtype)
    ft_emb = _emb_cols_wide(ft, multires_ft, dtype)
    col_head = _cat([*nabla, d_emb, vdir, _emb_cols(vdir, multires_view),
                     ft])
    nh = col_head.shape[-1]
    cw0, cb0 = col_ws[0], col_ws[1]
    pre = _dot(col_head, cw0[:nh]) + cb0[0]
    if ft_emb is not None:
        pre = pre + _dot(ft_emb, cw0[nh:])
    h = torch.relu(pre)
    wi = 2
    for _ in range(n_col - 1):
        h = torch.relu(_dot(h, col_ws[wi]) + col_ws[wi + 1][0])
        wi += 2
    return torch.sigmoid(_dot(h, col_ws[wi]) + col_ws[wi + 1][0])


# ---------------------------------------------------------------------------
# field_fused
# ---------------------------------------------------------------------------

def field_fused_plain(xyz, geo, feat, w1, dens_ws=(), col_ws=None,
                      dirs=None, *, k: int = 8, want: str = "density",
                      multires_d: int = 8, multires_fg: int = 2,
                      multires_ft: int = 2, multires_view: int = 4,
                      geometry_dim: int = 32, dtype=None):
    """Plain PyTorch version of field_fused (same signature)."""
    if dtype is not None:
        feat = feat.to(dtype)
    x0, x1, x2 = xyz[..., 0:1], xyz[..., 1:2], xyz[..., 2:3]
    if want == "distance":
        ds, _ = _interp_distance(x0, x1, x2, geo, w1, k, False)
        return [ds[..., 0]]
    nabla_w = want in ("density_nabla", "full")
    if nabla_w:
        ds, W, dh = _interp_distance(x0, x1, x2, geo, w1, k, True)
    else:
        ds, W = _interp_distance(x0, x1, x2, geo, w1, k, False)
    feats = _feat_dot(W, feat)
    fg = feats[..., :geometry_dim]
    if not nabla_w:
        dens, _ = _density_mlp(ds, fg, dens_ws, multires_d, multires_fg,
                               dtype, False)
        return [dens[..., 0]]
    dens, d_emb, dDdh = _density_mlp(ds, fg, dens_ws, multires_d,
                                     multires_fg, dtype, True)
    nab = [dDdh * dh[0], dDdh * dh[1], dDdh * dh[2]]
    outs = [dens] + nab
    if want == "full":
        rgb = _color_mlp(nab, d_emb, dirs, feats[..., geometry_dim:], col_ws,
                         multires_ft, multires_view, dtype)
        outs += [rgb[..., 0:1], rgb[..., 1:2], rgb[..., 2:3]]
    return [o[..., 0] for o in outs]


def field_fused(xyz, geo, feat, w1, dens_ws=(), col_ws=None, dirs=None, *,
                k: int = 8, want: str = "density", multires_d: int = 8,
                multires_fg: int = 2, multires_ft: int = 2,
                multires_view: int = 4, geometry_dim: int = 32, dtype=None):
    """Fused NeuMesh field evaluation of (B, S, 3) samples against (B, 8, C)
    tile contexts (rows [px py pz ix iy iz pp vn]) and (B, C, F) features.

    dens_ws: (w0d (d_emb, W), w0f (fg + fg_emb, W), b0 (1, W),
    [Wi (W, W), bi (1, W)]..., wh (W, 1), bh (1, 1)), weight-norm folded,
    each weight f32 or `dtype`. col_ws (want='full'): (w0, b0, [Wi, bi]...,
    wh (W, 3), bh (1, 3)) on [nabla, d_emb, view_emb, ft_emb]. want in
    distance | density | density_nabla | full -> list of 1/1/4/7 (B, S) f32
    arrays [sdf, nx, ny, nz, r, g, b]."""
    kw = dict(k=k, want=want, multires_d=multires_d,
              multires_fg=multires_fg, multires_ft=multires_ft,
              multires_view=multires_view, geometry_dim=geometry_dim,
              dtype=dtype)
    if not xyz.is_cuda:
        return field_fused_plain(xyz, geo, feat, w1, dens_ws, col_ws, dirs,
                                 **kw)
    from . import _build

    B, S, _ = xyz.shape
    C = geo.shape[2]
    if dtype is not None:
        feat = feat.to(dtype)
    feat = feat.contiguous()
    F = feat.shape[-1]
    _check_inputs(xyz, geo, feat, dirs if want == "full" else None)
    n_out = _N_OUT[want]
    out = torch.empty((n_out, B, S), device=xyz.device, dtype=torch.float32)
    if B == 0 or S == 0:
        return list(out)
    keep = []
    if want == "distance":
        dens_d = col_d = None
        ldx = 4
    else:
        dens_d, ldx_d = _mlp_desc(_dens_layers(dens_ws, geometry_dim), keep)
        col_d, ldx_c = (_mlp_desc(_col_layers(col_ws, F - geometry_dim,
                                              multires_d, multires_view),
                                  keep) if want == "full" else (None, 0))
        ldx = max(ldx_d, ldx_c)
    d = dirs.contiguous() if want == "full" else None
    args = _build.FieldArgs(
        xyz=_ptr(xyz.contiguous(), keep), dirs=_ptr(d, keep),
        geo=_ptr(geo.contiguous(), keep), feat=_ptr(feat, keep),
        out=out.data_ptr(), feat_bf16=int(feat.dtype == torch.bfloat16),
        # _N_OUT's order is the kernel's Mode enum
        B=B, S=S, C=C, F=F, k=k, mode=list(_N_OUT).index(want),
        md=multires_d, mfg=multires_fg, mft=multires_ft, mv=multires_view,
        gd=geometry_dim, lowp=int(dtype is not None), ldx=ldx,
        w1=float(w1))
    if dens_d is not None:
        args.dens = dens_d
    if col_d is not None:
        args.col = col_d
    _build.launch("field_fused", args)
    LAUNCHES["field_fused"][want] += 1
    return list(out)


# ---------------------------------------------------------------------------
# secant_refine
# ---------------------------------------------------------------------------

def secant_pred(f_low, f_high, d_low, d_high):
    """Secant root estimate of a bracket, the denominator clamped at
    1e-12."""
    denom = f_high - f_low
    denom = torch.where(torch.abs(denom) < 1e-12,
                        torch.full_like(denom, 1e-12), denom)
    return -f_low * (d_high - d_low) / denom + d_low


def secant_refine_plain(rays_o, rays_d, d_low, d_high, f_low, f_high, geo,
                        feat, w1, dens_ws, *, n_iters: int = 6, k: int = 8,
                        multires_d: int = 8, multires_fg: int = 2,
                        geometry_dim: int = 32, dtype=None,
                        logit_tau: float = 0.0, d_low_w=None,
                        d_high_w=None, frozen_knn: bool = False):
    """Plain PyTorch version of secant_refine (same signature)."""
    R = rays_o.shape[0]
    B = geo.shape[0]
    T = R // B
    if dtype is not None:
        feat = feat.to(dtype)

    def tiles(v):
        return v.reshape(B, T, 1)

    o = [tiles(rays_o[:, i]) for i in range(3)]
    r = [tiles(rays_d[:, i]) for i in range(3)]
    d_low, d_high = tiles(d_low), tiles(d_high)
    f_low, f_high = tiles(f_low), tiles(f_high)
    rebracket = d_low_w is not None

    def density(ds, W):
        fg = _feat_dot(W, feat)[..., :geometry_dim]
        f, _ = _density_mlp(ds, fg, dens_ws, multires_d, multires_fg, dtype,
                            False)
        return f - logit_tau

    def field_full(d_eval):
        x0 = o[0] + d_eval * r[0]
        x1 = o[1] + d_eval * r[1]
        x2 = o[2] + d_eval * r[2]
        ds, W = _interp_distance(x0, x1, x2, geo, w1, k, False)
        return density(ds, W)

    field = field_full
    if frozen_knn:
        # candidate selection frozen at the bracket midpoint; quadratic in
        # the depth offset de = d - d_mid for the selected candidates
        if rebracket:
            d_mid = 0.5 * (tiles(d_low_w) + tiles(d_high_w))
        else:
            d_mid = 0.5 * (d_low + d_high)
        px, py, pz, ix, iy, iz, pp, vn = _geo_rows(geo)
        C = geo.shape[-1]
        xm = [o[i] + d_mid * r[i] for i in range(3)]
        dx, dy, dz = xm[0] - px, xm[1] - py, xm[2] - pz
        Aq = dx * dx + dy * dy + dz * dz
        Bq = dx * r[0] + dy * r[1] + dz * r[2]
        Eq = (xm[0] * ix + xm[1] * iy + xm[2] * iz) - vn
        Fq = r[0] * ix + r[1] * iy + r[2] * iz
        d2m = Aq + pp * (pp >= 1e11).to(torch.float32)
        iota = torch.arange(C, device=geo.device, dtype=torch.float32)
        cur = d2m * (1.0 + iota * 2e-7)
        masks = []
        for _ in range(k):
            thr = torch.amin(cur, dim=-1, keepdim=True)
            fm = (cur <= thr).to(torch.float32)
            cur = torch.where(fm > 0.0, torch.full_like(cur, math.inf), cur)
            masks.append(fm)

        def pick(q):
            return torch.cat([torch.sum(m * q, dim=-1, keepdim=True)
                              for m in masks], dim=-1)        # (B, T, k)

        A8, B8, E8, F8 = pick(Aq), pick(Bq), pick(Eq), pick(Fq)

        def field(d_eval):  # noqa: F811
            de = d_eval - d_mid
            d2 = torch.clamp(A8 + (2.0 * de) * B8 + de * de, min=1e-20)
            d = torch.sqrt(d2)
            w_raw = 1.0 / (d + 1e-7)
            W8 = w_raw / torch.sum(w_raw, dim=-1, keepdim=True)
            term = w1 * (E8 + de * F8) + d * d2
            ds = torch.sum(W8 * term / (w1 + d), dim=-1, keepdim=True)
            W_C = masks[0] * W8[..., 0:1]
            for i in range(1, k):
                W_C = W_C + masks[i] * W8[..., i:i + 1]
            return density(ds, W_C)

    if rebracket:
        d_lw, d_hw = tiles(d_low_w), tiles(d_high_w)
        f_hr = field(d_hw)
        f_lr = field(d_lw)
        ok = (f_hr > 0) & (f_lr < 0)
        f_high = torch.where(ok, f_hr, f_high)
        f_low = torch.where(ok, f_lr, f_low)
        d_high = torch.where(ok, d_hw, d_high)
        d_low = torch.where(ok, d_lw, d_low)

    d_pred = secant_pred(f_low, f_high, d_low, d_high)
    for _ in range(n_iters):
        f_mid = field(d_pred)
        low = f_mid < 0
        d_low = torch.where(low, d_pred, d_low)
        f_low = torch.where(low, f_mid, f_low)
        d_high = torch.where(low, d_high, d_pred)
        f_high = torch.where(low, f_high, f_mid)
        d_pred = secant_pred(f_low, f_high, d_low, d_high)
    return d_pred.reshape(R)


def secant_refine(rays_o, rays_d, d_low, d_high, f_low, f_high, geo, feat,
                  w1, dens_ws, *, n_iters: int = 6, k: int = 8,
                  multires_d: int = 8, multires_fg: int = 2,
                  geometry_dim: int = 32, dtype=None, logit_tau: float = 0.0,
                  d_low_w=None, d_high_w=None, frozen_knn: bool = False):
    """All n_iters secant iterations of root refinement per ray in one
    launch. rays_o/d (R, 3) with consecutive rays grouped into R // B
    tiles matching geo (B, 8, C) / feat (B, C, F); brackets (R,).
    d_low_w/d_high_w fold the density re-bracket at the half-step-widened
    endpoints into the kernel; frozen_knn freezes the candidate selection
    at the bracket midpoint. Returns d_pred (R,)."""
    kw = dict(n_iters=n_iters, k=k, multires_d=multires_d,
              multires_fg=multires_fg, geometry_dim=geometry_dim,
              dtype=dtype, logit_tau=logit_tau, d_low_w=d_low_w,
              d_high_w=d_high_w, frozen_knn=frozen_knn)
    if not rays_o.is_cuda:
        return secant_refine_plain(rays_o, rays_d, d_low, d_high, f_low,
                                   f_high, geo, feat, w1, dens_ws, **kw)
    from . import _build

    R = rays_o.shape[0]
    B, _, C = geo.shape
    if R % B:
        raise ValueError(f"secant_refine: {R} rays do not tile {B} contexts")
    if dtype is not None:
        feat = feat.to(dtype)
    feat = feat.contiguous()
    _check_inputs(rays_o, geo, feat, rays_d)
    for v in (d_low, d_high, f_low, f_high, d_low_w, d_high_w):
        if v is not None and tuple(v.shape) != (R,):
            raise ValueError(f"secant_refine: bracket {tuple(v.shape)}, "
                             f"want ({R},)")
    rebracket = d_low_w is not None
    if k > 16:
        raise ValueError("secant_refine: k <= 16")
    out = torch.empty((R,), device=rays_o.device, dtype=torch.float32)
    if R == 0:
        return out
    keep = []
    dens_d, ldx = _mlp_desc(_dens_layers(dens_ws, geometry_dim), keep)
    vec = [v.to(torch.float32).contiguous()
           for v in (d_low, d_high, f_low, f_high)]
    wvec = ([d_low_w.to(torch.float32).contiguous(),
             d_high_w.to(torch.float32).contiguous()] if rebracket
            else [None, None])
    args = _build.SecantArgs(
        rays_o=_ptr(rays_o.contiguous(), keep),
        rays_d=_ptr(rays_d.contiguous(), keep),
        d_low=_ptr(vec[0], keep), d_high=_ptr(vec[1], keep),
        f_low=_ptr(vec[2], keep), f_high=_ptr(vec[3], keep),
        d_low_w=_ptr(wvec[0], keep), d_high_w=_ptr(wvec[1], keep),
        geo=_ptr(geo.contiguous(), keep), feat=_ptr(feat, keep),
        out=out.data_ptr(), feat_bf16=int(feat.dtype == torch.bfloat16),
        R=R, B=B, T=R // B, C=C, F=feat.shape[-1], k=k, n_iters=n_iters,
        md=multires_d, mfg=multires_fg, gd=geometry_dim,
        lowp=int(dtype is not None), ldx=ldx, rebracket=int(rebracket),
        frozen=int(frozen_knn), w1=float(w1), tau=float(logit_tau),
        dens=dens_d)
    _build.launch("secant_refine", args)
    LAUNCHES["secant_refine"][secant_mode(rebracket, frozen_knn)] += 1
    return out


# ---------------------------------------------------------------------------
# kernel argument packing
# ---------------------------------------------------------------------------

def _align4(n: int) -> int:
    return (n + 3) // 4 * 4


def _dens_layers(dens_ws, geometry_dim):
    """[(w (K, N), b (N,), split)] with the first layer's d-embedding and
    fg/fg-embedding row blocks joined: rows [ds, dcols, fg | fg_emb], bias
    added after the first `split` rows."""
    w0d, w0f, b0 = dens_ws[0], dens_ws[1], dens_ws[2]
    if w0d.dtype != w0f.dtype:
        raise ValueError("field kernels: w0d and w0f must share a dtype")
    layers = [(torch.cat([w0d, w0f], dim=0), b0,
               w0d.shape[0] + geometry_dim)]
    for i in range(3, len(dens_ws), 2):
        layers.append((dens_ws[i], dens_ws[i + 1], 0))
    return layers


def _col_layers(col_ws, color_dim, multires_d, multires_view):
    nh = 3 + (1 + 2 * max(multires_d, 0)) + 3 \
        + 3 * 2 * max(multires_view, 0) + color_dim
    layers = [(col_ws[0], col_ws[1], nh)]
    for i in range(2, len(col_ws), 2):
        layers.append((col_ws[i], col_ws[i + 1], 0))
    return layers


def _mlp_desc(layers, keep):
    """ctypes MLP descriptor + the row stride (floats) of the activation
    buffer: wide enough for every layer's input (the second row block of
    a first layer starts at a multiple of 4) and output."""
    from . import _build

    if len(layers) > _build.MAX_LAYERS:
        raise ValueError(f"field kernels: at most {_build.MAX_LAYERS} layers")
    desc = _build.MLPDesc()
    desc.n = len(layers)
    ldx = 4
    for i, (w, b, split) in enumerate(layers):
        if w.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"field kernels: weight dtype {w.dtype}")
        K, N = w.shape
        if i < len(layers) - 1 and N > _build.NT:
            raise ValueError(f"field kernels: width {N} > {_build.NT}")
        w = w.contiguous()
        b = b.reshape(-1).to(torch.float32).contiguous()
        desc.l[i].w = _ptr(w, keep)
        desc.l[i].b = _ptr(b, keep)
        desc.l[i].K, desc.l[i].N = K, N
        desc.l[i].bf16 = int(w.dtype == torch.bfloat16)
        desc.l[i].split = split
        ldx = max(ldx, _align4(split) + K - split if split else K, N)
    return desc, _align4(ldx)


def _ptr(t, keep):
    if t is None:
        return None
    keep.append(t)
    return t.data_ptr()


def _check_inputs(xyz, geo, feat, dirs):
    """Device, dtype and shape checks before any pointer reaches a kernel:
    xyz (B, S, 3) samples (or (R, 3) rays), geo (B, 8, C), feat (B, C, F),
    dirs shaped like xyz."""
    if geo.dim() != 3 or geo.shape[1] != 8:
        raise ValueError(f"field kernels: geo {tuple(geo.shape)}, want "
                         "(B, 8, C)")
    B, C = geo.shape[0], geo.shape[2]
    if feat.dim() != 3 or tuple(feat.shape[:2]) != (B, C):
        raise ValueError(f"field kernels: feat {tuple(feat.shape)}, want "
                         f"({B}, {C}, F)")
    if xyz.shape[-1] != 3 or (xyz.dim() == 3 and xyz.shape[0] != B):
        raise ValueError(f"field kernels: points {tuple(xyz.shape)} against "
                         f"{B} contexts")
    if dirs is not None and dirs.shape != xyz.shape:
        raise ValueError(f"field kernels: dirs {tuple(dirs.shape)} vs "
                         f"points {tuple(xyz.shape)}")
    dev = xyz.device
    for name, t in (("geo", geo), ("feat", feat), ("dirs", dirs)):
        if t is not None and t.device != dev:
            raise ValueError(f"field kernels: {name} on {t.device}, "
                             f"samples on {dev}")
    for name, t in (("xyz", xyz), ("geo", geo), ("dirs", dirs)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"field kernels: {name} must be float32")
    if feat.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"field kernels: feat dtype {feat.dtype}")


__all__ = ["field_fused", "field_fused_plain", "secant_refine",
           "secant_refine_plain", "secant_pred", "LAUNCHES",
           "reset_launch_counts"]
