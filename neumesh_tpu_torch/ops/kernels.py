"""The NeuMesh field kernels: wrappers, launch counters and plain PyTorch
versions.

  field_fused         <- neumesh_tpu/ops/pallas_kernels.py::_field_kernel
                         (csrc/field_fused.cu; want="distance":
                         csrc/field_distance.cu)
  secant_refine       <- ::_secant_kernel (csrc/secant_refine.cu)
  surface_locate      <- ::_locate_kernel (csrc/surface_locate.cu)
  candidate_field_v3  <- ::_v3_kernel (csrc/candidate_field.cu)
  candidate_field     <- ::_kernel, v2 (csrc/candidate_field.cu)

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

import functools
import math

import torch

from ..nn import softplus100, softplus100_grad
from ..utils import trace

_N_OUT = {"distance": 1, "density": 1, "density_nabla": 4, "full": 7}
_CAND_MODES = ("ds_feat", "ds_nofeat", "ds_dh_feat", "ds_dh_nofeat")

# launches of each kernel per mode, counted where the kernel is launched:
# views of the counters "launch.<kernel>.<mode>" of utils.trace
LAUNCHES = {
    name: trace.CounterView(f"launch.{name}.", modes) for name, modes in (
        ("field_fused", _N_OUT),
        ("secant_refine", ("plain", "rebracket", "frozen",
                           "frozen_rebracket")),
        ("surface_locate", ("bf16", "f32")),
        ("candidate_field_v3", _CAND_MODES),
        ("candidate_field", _CAND_MODES))}


def reset_launch_counts() -> None:
    trace.reset("launch.")


def secant_mode(rebracket: bool, frozen: bool) -> str:
    if frozen:
        return "frozen_rebracket" if rebracket else "frozen"
    return "rebracket" if rebracket else "plain"


def candidate_mode(want_dh: bool, want_feat: bool) -> str:
    return ("ds_dh" if want_dh else "ds") + ("_feat" if want_feat
                                            else "_nofeat")


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


def softplus100_pair(x):
    """The tile kernels' exact epilogue (csrc softplus100_pair) in torch
    f32: softplus100(x) and softplus100_grad(x) from one exponential e =
    exp(-|100 x|), h = (max(100 x, 0) + log1p(e)) / 100 (softplus100's own
    arithmetic), g = 1 / (1 + e) for 100 x >= 0, else e / (1 + e), 0 where
    sigmoid's exp(-100 x) overflows; above 100 x = 20 h = x, g = 1."""
    bx = 100.0 * x
    e = torch.exp(-bx.abs())
    h = torch.where(bx > 20.0, x, (bx.clamp(min=0.0) + torch.log1p(e)) / 100.0)
    neg = torch.where(e < 2.9387359e-39, torch.zeros_like(e), e / (1.0 + e))
    g = torch.where(bx > 20.0, torch.ones_like(x),
                    torch.where(bx >= 0.0, 1.0 / (1.0 + e), neg))
    return h, g


def softplus100_bf16_form(x):
    """The algebra of the kernels' epilogue for outputs rounded to bf16
    (csrc softplus100_fast) with exact exp / log in place of the hardware's
    approximate ones: log1p(e) as e (1 - e (1 / 2 - e / 3)) below e =
    2^-7, else log(1 + e); h = (max(100 x, 0) + that) * 0.01, g = r or
    e r with r = 1 / (1 + e)."""
    bx = 100.0 * x
    e = torch.exp(-bx.abs())
    lg = torch.where(e < 0.0078125, e * (1.0 - e * (0.5 - e / 3.0)),
                     torch.log(1.0 + e))
    h = torch.where(bx > 20.0, x, (bx.clamp(min=0.0) + lg) * 0.01)
    r = 1.0 / (1.0 + e)
    g = torch.where(bx > 20.0, torch.ones_like(x),
                    torch.where(bx >= 0.0, r, e * r))
    return h, g


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


def _interp_distance(x0, x1, x2, geo, w1, k: int, want_dh: bool,
                     k1_proxy: bool = True, v2_dh: bool = False):
    """Interpolated distance of (B, S, 1) points against (B, 8, C) contexts
    -> (ds (B, S, 1), W (B, S, C)[, (dhx, dhy, dhz)]). k1_proxy: k = 1
    without dh takes the field kernels' nearest-tangent-plane proxy;
    v2_dh: dh in candidate_field (v2)'s summation order."""
    px, py, pz, ix, iy, iz, pp, vn = _geo_rows(geo)
    C = geo.shape[-1]
    iota = torch.arange(C, device=geo.device, dtype=torch.float32)
    xv = x0 * px + x1 * py + x2 * pz
    xx = x0 * x0 + x1 * x1 + x2 * x2
    d2 = torch.clamp(xx + pp - 2.0 * xv, min=0.0)
    d2_tb = d2 * (1.0 + iota * 2e-7)

    if k1_proxy and k == 1 and not want_dh:
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
    B = W * (3.0 * d2 * (w1 + d) - term) * inv * inv / d
    sB = torch.sum(B, dim=-1, keepdim=True)
    if v2_dh:
        A = W * w1 * inv

        def col(n, p, x):
            return (torch.sum(A * n, dim=-1, keepdim=True) + sB * x
                    - torch.sum(B * p, dim=-1, keepdim=True))
        return ds, W, (col(ix, px, x0), col(iy, py, x1), col(iz, pz, x2))
    A = W * (w1 * inv)
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
    out, launched = _field_launch(xyz, geo, feat, w1, dens_ws, col_ws, dirs,
                                  **kw)
    trace.count(f"launch.field_fused.{want}", launched)
    return out


def _field_launch(xyz, geo, feat, w1, dens_ws, col_ws, dirs, *, k, want,
                  multires_d, multires_fg, multires_ft, multires_view,
                  geometry_dim, dtype, prof=None):
    """Launch field_fused's kernel (prof: the address of the timing
    instantiation's record buffer, stage_split): (its outputs, whether it
    launched); counts nothing."""
    from . import _build

    _no_grad(xyz, geo, feat, w1, dens_ws, col_ws, dirs)
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
        return list(out), False
    keep = []
    if want == "distance":
        dens_d = col_d = None
        ldx = 4
    else:
        dens_d, ldx_d = _mlp_desc(_dens_layers(dens_ws, geometry_dim), keep)
        col_d, ldx_c = (_mlp_desc(_col_layers(col_ws, F - geometry_dim,
                                              multires_d, multires_view),
                                  keep)
                        if want == "full" else (None, 0))
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
    args.prof = prof
    _build.launch("field_distance" if want == "distance" else "field_fused",
                  args, xyz)
    return list(out), True


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
    out, launched = _secant_launch(rays_o, rays_d, d_low, d_high, f_low,
                                   f_high, geo, feat, w1, dens_ws, **kw)
    trace.count("launch.secant_refine."
                + secant_mode(d_low_w is not None, frozen_knn), launched)
    return out


def _secant_launch(rays_o, rays_d, d_low, d_high, f_low, f_high, geo, feat,
                   w1, dens_ws, *, n_iters, k, multires_d, multires_fg,
                   geometry_dim, dtype, logit_tau, d_low_w, d_high_w,
                   frozen_knn, prof=None):
    """Launch secant_refine's kernel (prof as _field_launch's): (d_pred,
    whether it launched); counts nothing."""
    from . import _build

    _no_grad(rays_o, rays_d, d_low, d_high, f_low, f_high, geo, feat, w1,
             dens_ws, d_low_w, d_high_w)
    R = rays_o.shape[0]
    for v in (d_low, d_high, f_low, f_high, d_low_w, d_high_w):
        if v is not None and tuple(v.shape) != (R,):
            raise ValueError(f"secant_refine: bracket {tuple(v.shape)}, "
                             f"want ({R},)")
    rebracket = d_low_w is not None
    if k > 16:
        raise ValueError("secant_refine: k <= 16")
    out = torch.empty((R,), device=rays_o.device, dtype=torch.float32)
    if R == 0:
        return out, False
    keep = []
    field = _ray_field("secant_refine", rays_o, rays_d, geo, feat, w1,
                       dens_ws, out, k, multires_d, multires_fg,
                       geometry_dim, dtype, logit_tau, keep)
    vec = [v.to(torch.float32).contiguous()
           for v in (d_low, d_high, f_low, f_high)]
    wvec = ([d_low_w.to(torch.float32).contiguous(),
             d_high_w.to(torch.float32).contiguous()] if rebracket
            else [None, None])
    args = _build.SecantArgs(
        f=field, d_low=_ptr(vec[0], keep), d_high=_ptr(vec[1], keep),
        f_low=_ptr(vec[2], keep), f_high=_ptr(vec[3], keep),
        d_low_w=_ptr(wvec[0], keep), d_high_w=_ptr(wvec[1], keep),
        n_iters=n_iters, rebracket=int(rebracket), frozen=int(frozen_knn),
        prof=prof)
    _build.launch("secant_refine", args, rays_o)
    return out, True


# ---------------------------------------------------------------------------
# surface_locate
# ---------------------------------------------------------------------------

def _pad_candidates(geo, feat=None):
    """C padded to a multiple of 128 with (v = 0, pp = 1e12) sentinel
    columns and zero features, as the TPU kernels pad. The sentinel d2 ~
    1e12 is never selected while k real candidates exist and keeps
    d * d2 ~ 1e18 finite (a 1e9 position with pp = 0 would clamp d2 to 0
    and make the pad the nearest candidate)."""
    B, _, C = geo.shape
    cpad = (-C) % 128
    if not cpad:
        return geo, feat
    fill = torch.zeros((B, 8, cpad), device=geo.device, dtype=geo.dtype)
    fill[:, 6] = 1e12
    geo = torch.cat([geo, fill], dim=2)
    if feat is not None:
        feat = torch.cat([feat, feat.new_zeros((B, cpad, feat.shape[-1]))],
                         dim=1)
    return geo, feat


def surface_locate_plain(rays_o, rays_d, near, far, geo, feat, w1, dens_ws,
                         *, n_steps: int = 24, n_secant: int = 6, k: int = 8,
                         multires_d: int = 8, multires_fg: int = 2,
                         geometry_dim: int = 32, dtype=None,
                         logit_tau: float = 0.0):
    """Plain PyTorch version of surface_locate (same signature)."""
    R = rays_o.shape[0]
    B = geo.shape[0]
    T = R // B
    geo, feat = _pad_candidates(geo, feat)
    if dtype is not None:
        feat = feat.to(dtype)

    def tiles(v):
        return v.reshape(B, T, 1)

    o = [tiles(rays_o[:, i]) for i in range(3)]
    r = [tiles(rays_d[:, i]) for i in range(3)]
    near, far = tiles(near), tiles(far)
    step = (far - near) / max(n_steps - 1, 1)

    def interp(dv):
        return _interp_distance(o[0] + dv * r[0], o[1] + dv * r[1],
                                o[2] + dv * r[2], geo, w1, k, False)

    def dist(dv):
        return interp(dv)[0] - logit_tau

    def dens(dv):
        ds, W = interp(dv)
        fg = _feat_dot(W, feat)[..., :geometry_dim]
        f, _ = _density_mlp(ds, fg, dens_ws, multires_d, multires_fg, dtype,
                            False)
        return f - logit_tau

    # first sign change of the distance, carried as f32 0/1 flags and
    # arithmetic selects like the TPU kernel
    f_prev = dist(near)
    d_prev = near
    one = torch.ones_like(f_prev)
    val0_pos = (f_prev > 0).to(torch.float32)
    found = torch.zeros_like(f_prev)
    pos2neg = torch.zeros_like(f_prev)
    d_high, f_high, d_low, f_low = near, one, far, -one
    for j in range(1, n_steps):
        dv = near + step * j
        f_cur = dist(dv)
        crossed = (torch.sign(f_prev) * torch.sign(f_cur) < 0).to(
            torch.float32)
        cross = crossed * (1.0 - found)
        d_high = d_high + cross * (d_prev - d_high)
        f_high = f_high + cross * (f_prev - f_high)
        d_low = d_low + cross * (dv - d_low)
        f_low = f_low + cross * (f_cur - f_low)
        pos2neg = pos2neg + cross * (f_prev > 0).to(torch.float32)
        found = found + cross
        d_prev, f_prev = dv, f_cur
    mask = found * pos2neg * val0_pos

    # density re-bracket at the half-step-widened endpoints
    d_high_w = torch.maximum(d_high - 0.5 * step, near)
    d_low_w = torch.minimum(d_low + 0.5 * step, far)
    f_high_r = dens(d_high_w)
    f_low_r = dens(d_low_w)
    ok = ((f_high_r > 0) & (f_low_r < 0)).to(torch.float32)
    f_high = f_high + ok * (f_high_r - f_high)
    f_low = f_low + ok * (f_low_r - f_low)
    d_high = d_high + ok * (d_high_w - d_high)
    d_low = d_low + ok * (d_low_w - d_low)

    d_pred = secant_pred(f_low, f_high, d_low, d_high)
    for _ in range(n_secant):
        f_mid = dens(d_pred)
        low = f_mid < 0
        d_low = torch.where(low, d_pred, d_low)
        f_low = torch.where(low, f_mid, f_low)
        d_high = torch.where(low, d_high, d_pred)
        f_high = torch.where(low, f_high, f_mid)
        d_pred = secant_pred(f_low, f_high, d_low, d_high)
    return (d_pred.reshape(R), mask.reshape(R) > 0.5,
            found.reshape(R) > 0.5, val0_pos.reshape(R) > 0.5)


def surface_locate(rays_o, rays_d, near, far, geo, feat, w1, dens_ws, *,
                   n_steps: int = 24, n_secant: int = 6, k: int = 8,
                   multires_d: int = 8, multires_fg: int = 2,
                   geometry_dim: int = 32, dtype=None,
                   logit_tau: float = 0.0):
    """The whole surface root search in one launch: the n_steps distance
    scan over [near, far], the first crossing, the density re-bracket at
    the half-step-widened endpoints and n_secant secant steps. rays_o/d
    (R, 3) with consecutive rays grouped into R // B tiles matching geo
    (B, 8, C) / feat (B, C, F); near/far (R,). Returns (d_pred (R,),
    mask, mask_sign_change, val0_pos (R,) bool)."""
    kw = dict(n_steps=n_steps, n_secant=n_secant, k=k,
              multires_d=multires_d, multires_fg=multires_fg,
              geometry_dim=geometry_dim, dtype=dtype, logit_tau=logit_tau)
    if not rays_o.is_cuda:
        return surface_locate_plain(rays_o, rays_d, near, far, geo, feat, w1,
                                    dens_ws, **kw)
    from . import _build

    _no_grad(rays_o, rays_d, near, far, geo, feat, w1, dens_ws)
    out = torch.empty((4, rays_o.shape[0]), device=rays_o.device,
                      dtype=torch.float32)
    if rays_o.shape[0] == 0:
        return out[0], *(out[1:] > 0.5)
    args, _keep = _locate_args(rays_o, rays_d, near, far, geo, feat, w1,
                               dens_ws, out, **kw)
    _build.launch("surface_locate", args, rays_o)
    trace.count("launch.surface_locate." + ("f32" if dtype is None
                                             else "bf16"))
    return out[0], out[1] > 0.5, out[2] > 0.5, out[3] > 0.5


def _locate_args(rays_o, rays_d, near, far, geo, feat, w1, dens_ws, out, *,
                 n_steps, n_secant, k, multires_d, multires_fg, geometry_dim,
                 dtype, logit_tau):
    """surface_locate's argument block (C padded to a multiple of 128, the
    density MLP described for the tile stage) and the tensors it points
    into."""
    from . import _build

    R = rays_o.shape[0]
    geo, feat = _pad_candidates(geo, feat)
    for v in (near, far):
        if tuple(v.shape) != (R,) or v.device != rays_o.device:
            raise ValueError(f"surface_locate: near/far {tuple(v.shape)} on "
                             f"{v.device}, want ({R},) on {rays_o.device}")
    keep = []
    field = _ray_field("surface_locate", rays_o, rays_d, geo, feat, w1,
                       dens_ws, out, k, multires_d, multires_fg,
                       geometry_dim, dtype, logit_tau, keep)
    args = _build.LocateArgs(
        f=field, near=_ptr(near.to(torch.float32).contiguous(), keep),
        far=_ptr(far.to(torch.float32).contiguous(), keep),
        n_steps=n_steps, n_secant=n_secant)
    return args, keep


# ---------------------------------------------------------------------------
# candidate_field_v3 and candidate_field (v2)
# ---------------------------------------------------------------------------

def _candidate_plain(xyz, geo, feat, w1, k, want_dh, want_feat, v2):
    x0, x1, x2 = xyz[..., 0:1], xyz[..., 1:2], xyz[..., 2:3]
    out = _interp_distance(x0, x1, x2, geo, w1, k, want_dh, k1_proxy=False,
                           v2_dh=v2)
    dh = torch.cat(out[2], dim=-1) if want_dh else None
    feats = out[1] @ feat.to(torch.float32) if want_feat else None
    return out[0], dh, feats


def candidate_field_v3_plain(xyz, geo, feat, w1, *, k: int = 8,
                             want_dh: bool = True, want_feat: bool = True):
    """Plain PyTorch version of candidate_field_v3 (same signature)."""
    geo, feat = _pad_candidates(geo, feat if want_feat else None)
    return _candidate_plain(xyz, geo, feat, w1, k, want_dh, want_feat, False)


def candidate_field_v3(xyz, geo, feat, w1, *, k: int = 8,
                       want_dh: bool = True, want_feat: bool = True):
    """The candidate stage alone for (B, S, 3) samples against (B, 8, C)
    tile contexts: ds, optionally the closed-form dh, optionally the kNN
    feature blend of (B, C, F) features in exact f32; C is padded to a
    multiple of 128 with sentinels. Returns (ds (B, S, 1), dh (B, S, 3) |
    None, feats (B, S, F) | None)."""
    if not xyz.is_cuda:
        return candidate_field_v3_plain(xyz, geo, feat, w1, k=k,
                                        want_dh=want_dh, want_feat=want_feat)
    from . import _build

    _no_grad(xyz, geo, feat)
    geo, feat = _pad_candidates(geo, feat if want_feat else None)
    B, S, _ = xyz.shape
    C = geo.shape[2]
    feat = (feat.to(torch.float32).contiguous() if want_feat
            else geo.new_zeros((B, C, 1)))
    _check_inputs(xyz, geo, feat, None)
    F = feat.shape[-1] if want_feat else 0
    dev = xyz.device
    packed = torch.empty((B, S, 4 if want_dh else 1), device=dev,
                         dtype=torch.float32)
    feats = (torch.empty((B, S, F), device=dev, dtype=torch.float32)
             if want_feat else None)
    if B and S:
        keep = []
        args = _build.CandArgs(
            xyz=_ptr(xyz.contiguous(), keep), geo=_ptr(geo.contiguous(), keep),
            feat=_ptr(feat, keep), out_d=packed.data_ptr(),
            out_feat=_ptr(feats, keep), B=B, S=S, C=C, F=F, k=k,
            want_dh=int(want_dh), want_feat=int(want_feat), w1=float(w1))
        _build.launch("candidate_field_v3", args, xyz)
        trace.count("launch.candidate_field_v3."
                    + candidate_mode(want_dh, want_feat))
    return (packed[..., 0:1], packed[..., 1:4] if want_dh else None, feats)


def candidate_field_plain(xyz, pts, pp, ind, vn, feat, w1, *, k: int = 8,
                          want_dh: bool = True, want_feat: bool = True):
    """Plain PyTorch version of candidate_field (same signature)."""
    geo = torch.cat([pts.transpose(1, 2), ind.transpose(1, 2),
                     pp[:, None, :], vn[:, None, :]], dim=1)
    return _candidate_plain(xyz, geo, feat, w1, k, want_dh, want_feat, True)


def candidate_field(xyz, pts, pp, ind, vn, feat, w1, *, k: int = 8,
                    want_dh: bool = True, want_feat: bool = True):
    """candidate_field_v3's maths in the per-ray layout: xyz (R, S, 3)
    against each ray's own candidates pts/ind (R, C, 3), pp/vn (R, C),
    feat (R, C, F); C is not padded and dh sums in v2's order. Returns
    (ds (R, S, 1), dh (R, S, 3) | None, feats (R, S, F) | None)."""
    if not xyz.is_cuda:
        return candidate_field_plain(xyz, pts, pp, ind, vn, feat, w1, k=k,
                                     want_dh=want_dh, want_feat=want_feat)
    from . import _build

    _no_grad(xyz, pts, pp, ind, vn, feat)
    R, S, _ = xyz.shape
    C = pts.shape[1]
    for name, t, shape in (("pts", pts, (R, C, 3)), ("ind", ind, (R, C, 3)),
                           ("pp", pp, (R, C)), ("vn", vn, (R, C)),
                           ("xyz", xyz, (R, S, 3))):
        if tuple(t.shape) != shape or t.dtype != torch.float32 \
                or t.device != xyz.device:
            raise ValueError(f"candidate_field: {name} {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}, want {shape} "
                             f"float32 on {xyz.device}")
    if want_feat and (feat.dim() != 3 or tuple(feat.shape[:2]) != (R, C)
                      or feat.device != xyz.device):
        raise ValueError(f"candidate_field: feat {tuple(feat.shape)}, want "
                         f"({R}, {C}, F)")
    dev = xyz.device
    F = feat.shape[-1] if want_feat else 0
    ds = torch.empty((R, S, 1), device=dev, dtype=torch.float32)
    dh = (torch.empty((R, S, 3), device=dev, dtype=torch.float32)
          if want_dh else None)
    feats = (torch.empty((R, S, F), device=dev, dtype=torch.float32)
             if want_feat else None)
    if R and S:
        keep = []
        args = _build.CandArgs(
            xyz=_ptr(xyz.contiguous(), keep), pts=_ptr(pts.contiguous(), keep),
            pp=_ptr(pp.contiguous(), keep), ind=_ptr(ind.contiguous(), keep),
            vn=_ptr(vn.contiguous(), keep),
            feat=_ptr(feat.to(torch.float32).contiguous() if want_feat
                      else None, keep),
            out_d=ds.data_ptr(), out_dh=_ptr(dh, keep),
            out_feat=_ptr(feats, keep), B=R, S=S, C=C, F=F, k=k,
            want_dh=int(want_dh), want_feat=int(want_feat), w1=float(w1))
        _build.launch("candidate_field", args, xyz)
        trace.count("launch.candidate_field."
                    + candidate_mode(want_dh, want_feat))
    return ds, dh, feats


# ---------------------------------------------------------------------------
# kernel argument packing
# ---------------------------------------------------------------------------

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


def _pad16(n: int) -> int:
    return (n + 15) // 16 * 16


def split_planes(w):
    """An f32 tensor as three bf16 planes (hi, mid, lo): hi = bf16(w), mid =
    bf16(w - hi), lo = bf16(w - hi - mid), each rounding to nearest even.
    hi + mid + lo == w exactly (each rounding leaves at most 16, then 8
    significant bits), so the six products hi.hi, mid.hi, lo.hi, hi.mid,
    mid.mid, hi.lo of two split operands give their f32 product to terms
    of order 2^-24 (the split of the TPU's precision="highest" dot)."""
    hi = w.to(torch.bfloat16)
    r = w - hi.to(torch.float32)
    mid = r.to(torch.bfloat16)
    lo = (r - mid.to(torch.float32)).to(torch.bfloat16)
    return hi, mid, lo


def _packed_rows(K: int, split: int):
    """The source row of each of a hidden layer's kp packed rows (-1: a
    zero pad row) and kp1: row blocks [0, split) and [split, K) of a first
    layer each zero-padded to a multiple of 16 rows, a later layer (split
    0) to NPAD rows, the width of the activation it reads."""
    from ._build import NPAD

    if split:
        blocks = [(0, split), (split, K)]
    else:
        if K > NPAD:
            raise ValueError(f"field kernels: hidden K {K} > {NPAD}")
        blocks = [(0, K)]
    rows = []
    for lo, hi in blocks:
        n = _pad16(hi - lo) if split else NPAD
        rows += list(range(lo, hi)) + [-1] * (n - (hi - lo))
    return rows, (_pad16(split) if split else len(rows))


@functools.lru_cache(maxsize=64)
def _pack_index(shapes, device):
    """For hidden layers of shapes ((K, N, split, bf16), ...), all bf16 or
    all f32: the flat index, into the concatenation of their row-major
    weights and one zero, of every element of their packed planes in
    packed order (one plane: a bf16 layer's, or each of an f32 layer's
    three), with each layer's (kp1, kp). Depends on the shapes alone, so
    it is built once per shape; the weights are gathered through it on
    every call."""
    from ._build import KS, KSF, NPAD

    total = sum(K * N for K, N, _, _ in shapes)
    parts, dims, base = [], [], 0
    n = torch.arange(NPAD)
    for K, N, split, bf16 in shapes:
        rows, kp1 = _packed_rows(K, split)
        r = torch.tensor(rows)[:, None]
        # (kp, NPAD): the source element, or the zero at `total`
        src = torch.where((r >= 0) & (n < N), base + r * N + n, total)
        # each slice's transpose as 8 x 8 core matrices, in the order
        # (n // 8, k // 8, n % 8, k % 8)
        step = KS if bf16 else KSF
        for k0 in range(0, len(rows), step):
            ks = min(step, len(rows) - k0)
            parts.append(src[k0:k0 + ks].t().reshape(NPAD // 8, 8, ks // 8, 8)
                         .permute(0, 2, 1, 3).reshape(-1))
        dims.append((kp1, len(rows)))
        base += K * N
    return torch.cat(parts).to(device), tuple(dims)


@trace.spanned("weights.pack")
def _pack(layers):
    """Hidden layers [(w (K, N), split)], all bf16 or all f32, in the tile
    stage's layout -> (packed bf16, [(offset, kp1, kp)] per layer; offset
    in elements). Each layer's rows are padded as _packed_rows says, N to
    NPAD columns; the transpose (K-major) of each slice, KS rows of a bf16
    layer or KSF rows of each of an f32 layer's three split_planes, laid
    out as 8 x 8 core matrices (_pack_index), the three planes of an f32
    slice one after the other: the order the kernel's bulk copies and
    wgmma descriptors read. One gather for all the layers (and, f32, one
    split); packed per call, never cached, so a weight edited in place
    cannot go stale."""
    from ._build import KSF, NPAD

    ws = [w for w, _ in layers]
    bf16 = ws[0].dtype == torch.bfloat16
    idx, dims = _pack_index(
        tuple((*w.shape, split, bf16) for w, split in layers), ws[0].device)
    src = torch.cat([w.reshape(-1) for w in ws] + [ws[0].new_zeros(1)])
    g = src[idx]
    P = 1 if bf16 else 3
    if not bf16:
        g = torch.stack(split_planes(g.view(-1, KSF * NPAD)), 1).view(-1)
    offs, o = [], 0
    for kp1, kp in dims:
        offs.append((o, kp1, kp))
        o += P * kp * NPAD
    return g, offs


def pack_layer(w, split: int):
    """One (K, N) hidden-layer weight, f32 or bf16, in the tile stage's
    layout (_pack) -> (packed (P * kp * NPAD,) bf16, P = 1 for bf16 and 3
    for f32, kp1, kp)."""
    if w.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"field kernels: weight dtype {w.dtype}")
    packed, [(_, kp1, kp)] = _pack([(w.contiguous(), split)])
    return packed, kp1, kp


def _mlp_desc(layers, keep):
    """ctypes MLP descriptor for the tensor-core tile stage + the row
    stride (floats) of the f32 activation rows. The hidden layers are
    packed by _pack, the bf16 ones and the f32 ones in one call each, and
    given their input width kp (a bf16 layer reads a bf16 tile that wide,
    an f32 layer that many columns of its f32 rows), a bf16 head its tile
    width NPAD; the row stride is a multiple of 32 (the kernel's swizzle),
    at least NPAD and every f32 layer's kp."""
    from . import _build

    if len(layers) > _build.MAX_LAYERS:
        raise ValueError(f"field kernels: at most {_build.MAX_LAYERS} layers")
    desc = _build.MLPDesc()
    desc.n = len(layers)
    ldx = _build.NPAD
    hidden = {}             # bf16 -> [(layer, w, split)]
    for i, (w, b, split) in enumerate(layers):
        if w.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"field kernels: weight dtype {w.dtype}")
        K, N = w.shape
        bf16 = int(w.dtype == torch.bfloat16)
        w = w.contiguous()
        b = b.reshape(-1).to(torch.float32).contiguous()
        desc.l[i].w = _ptr(w, keep)
        desc.l[i].b = _ptr(b, keep)
        desc.l[i].K, desc.l[i].N = K, N
        desc.l[i].bf16 = bf16
        desc.l[i].split = split
        if i < len(layers) - 1:
            if N > _build.NPAD:
                raise ValueError(f"field kernels: width {N} > {_build.NPAD}")
            hidden.setdefault(bf16, []).append((i, w, split))
        elif bf16:
            desc.l[i].kp = _build.NPAD
    for bf16, group in hidden.items():
        packed, offs = _pack([(w, split) for _, w, split in group])
        keep.append(packed)
        for (i, _, _), (o, kp1, kp) in zip(group, offs):
            desc.l[i].wp = packed.data_ptr() + 2 * o
            desc.l[i].kp1, desc.l[i].kp = kp1, kp
            if not bf16:
                ldx = max(ldx, kp)
    return desc, -(-ldx // 32) * 32


def block_plan(B: int, R: int):
    """The tile kernels' rows (csrc/field_common.cuh TileRows) for B
    contexts of R rows (samples or rays) each: (ctx, row, live), three
    (blocks, 64) tensors, row t of block i computing row row[i, t] of
    context ctx[i, t] where live[i, t]. R >= 64: 64 consecutive rows of one
    context a block, ceil(R / 64) blocks a context; fewer: the flattened
    (context, row) order cut into blocks of 64 rows. A ragged row takes
    the context of its block's first row, row 0, and is not live."""
    from ._build import TS

    t = torch.arange(TS)
    if R >= TS:
        nblk = -(-R // TS)
        blk = torch.arange(B * nblk)[:, None]
        ctx = (blk // nblk).expand(-1, TS)
        row = blk % nblk * TS + t
        live = row < R
    else:
        g = torch.arange(-(-B * R // TS))[:, None] * TS + t
        live = g < B * R
        ctx, row = g // R, g % R
    ctx = torch.where(live, ctx, ctx[:, :1])
    return ctx, torch.where(live, row, 0), live


def tile_blocks(B: int, R: int) -> int:
    """Row blocks (tiles) of a tile-kernel call (csrc tile_blocks):
    ceil(R / 64) a context from 64 rows a context, else ceil(B R / 64)."""
    from ._build import TS

    return B * -(-R // TS) if R >= TS else -(-B * R // TS)


def persistent_schedule(B: int, R: int, sms: int):
    """The warp-specialised tile kernels' persistent grid (csrc
    persistent_grid and the kernels' tile loop) for B contexts of R rows on
    a card of `sms` SMs: one list of tiles (block_plan's row blocks) a
    block, block b taking tiles b, b + grid, ... of the grid's min(tiles,
    sms) blocks."""
    n = tile_blocks(B, R)
    grid = max(min(n, sms), 1)
    return [list(range(b, n, grid)) for b in range(grid)]


def _block_contexts_max(B: int, R: int) -> int:
    from ._build import TS

    n = 1 if R >= TS else 1 + (TS - 1 + R - 1) // R
    return min(n, B)


def _act_bytes(layers, ldx: int) -> int:
    """One activation buffer (csrc act_bytes) of an MLP given as [(bf16,
    kp)] a layer (the head's kp: NPAD in bf16, 0 in f32)."""
    from ._build import TS

    b = max(TS * kp * 2 if bf16 else TS * ldx * 4 for bf16, kp in layers)
    return -(-b // 128) * 128


def _mlp_meta(layers):
    """[(bf16, kp)] of _dens_layers / _col_layers' output and the f32 row
    stride, as _mlp_desc gives them (shapes and dtypes only)."""
    from ._build import NPAD

    meta, ldx = [], NPAD
    for i, (w, _, split) in enumerate(layers):
        bf16 = w.dtype == torch.bfloat16
        if i < len(layers) - 1:
            kp = len(_packed_rows(w.shape[0], split)[0])
            if not bf16:
                ldx = max(ldx, kp)
        else:
            kp = NPAD if bf16 else 0
        meta.append((bf16, kp))
    return meta, -(-ldx // 32) * 32


def tile_smem_plan(name: str, *args, **kw) -> dict:
    """The shared-memory plan of a field_fused / secant_refine launch (csrc
    field_smem / field_staged, secant_smem / secant_staged, tile_plan) from
    the wrapper's arguments (shapes and dtypes alone; any device): "ws",
    whether the instantiation is warp-specialised (all but the f32 secant
    without the frozen selection),
    "bytes" of a block, "ring" slots (2..RING_MAX where warp-specialised,
    24 KB each where every hidden layer is f32, else 32 KB; else 2 of 32
    KB), "staged" contexts a block (0:
    read from L2), "fits" (bytes <= SMEM_MAX; the C entry refuses the
    launch otherwise)."""
    import inspect

    from ._build import (KL, KSEL, RING_MAX, SLOT_BYTES, SLOT_F32_BYTES,
                         SMEM_MAX, TS)

    fn = {"field_fused": field_fused, "secant_refine": secant_refine}[name]
    a = inspect.signature(fn).bind(*args, **kw)
    a.apply_defaults()
    a = a.arguments
    gd = a["geometry_dim"]
    dens = _mlp_meta(_dens_layers(a["dens_ws"], gd))
    F = a["feat"].shape[-1]
    C = a["geo"].shape[2]
    if name == "field_fused":
        want = a["want"]
        B, R = a["xyz"].shape[:2]
        col = (_mlp_meta(_col_layers(a["col_ws"], F - gd, a["multires_d"],
                                     a["multires_view"]))
               if want == "full" else None)
        tang = want in ("density_nabla", "full")

        def rest(nst):
            return 4 * (TS * 20 + TS * F + TS * (KL // 2 + 1) + TS
                        + 8 * C * nst)
    else:
        B = a["geo"].shape[0]
        R = a["rays_o"].shape[0] // B
        col, tang = None, False
        frozen = (4 * 5 * TS * KSEL + -(-TS * C // 8) * 8
                  if a["frozen_knn"] else 0)

        def rest(nst):
            ray = (TS * 14 + TS * F + TS * (KL // 2 + 1) + TS + 8 * C * nst)
            return 4 * (ray + 2 * TS) + frozen
    ldx = max(dens[1], col[1] if col else 0)
    xb = _act_bytes(dens[0], ldx)
    tb = xb if tang else 0
    if col:
        xb = max(xb, _act_bytes(col[0], ldx))
    act = max(xb + tb, -(-TS * C * 4 // 128) * 128)
    hidden = [bf16 for m in (dens, col) if m for bf16, _ in m[0][:-1]]
    # csrc secant_ws: every instantiation but the f32 secant without the
    # frozen selection (field_fused: every one)
    f32 = not all(hidden)
    ws = name == "field_fused" or not f32 or a["frozen_knn"]
    bars = 2 * RING_MAX * 8 if ws else 16
    slot = SLOT_F32_BYTES if ws and not any(hidden) else SLOT_BYTES

    def plan(nst):
        r = rest(nst)
        room = max(SMEM_MAX - act - bars - r, 0) // slot
        ring = min(max(room, 2), RING_MAX) if ws else 2
        return ring, ring * slot + act + bars + r
    n = _block_contexts_max(B, R)
    staged = n if plan(n)[1] <= SMEM_MAX else 0
    ring, nbytes = plan(staged)
    return {"bytes": nbytes, "ring": ring, "staged": staged,
            "fits": nbytes <= SMEM_MAX, "ws": ws}


def stage_split(name: str, *args, **kw) -> dict:
    """Run the timing instantiation of `name` ("field_fused" or
    "secant_refine", CUDA tensors, the wrapper's arguments) once and
    return where a block's time goes: "share" {stage: share of the
    warpgroups' cycles} (csrc Stage, _build.STAGES), "cycles_per_tile"
    {stage: cycles a tile, the mean over warpgroups}, "us_per_tile" (the
    blocks' %globaltimer span over their tiles), "blocks", "tiles". Not a
    main-path launch: counts nothing."""
    import inspect

    from . import _build

    fn = {"field_fused": field_fused, "secant_refine": secant_refine}[name]
    bound = inspect.signature(fn).bind(*args, **kw)
    bound.apply_defaults()
    a = dict(bound.arguments)
    if name == "field_fused":
        B, R = a["xyz"].shape[:2]
        dev, launch = a["xyz"].device, _field_launch
    else:
        B = a["geo"].shape[0]
        R = a["rays_o"].shape[0] // B
        dev, launch = a["rays_o"].device, _secant_launch
    n = len(_build.STAGES)
    rec = torch.zeros((tile_blocks(B, R), 4, n + 3), dtype=torch.int64,
                      device=dev)
    pos = list(a)[:len(args)]
    launch(*[a.pop(p) for p in pos], **a, prof=rec.data_ptr())
    torch.cuda.synchronize(dev)
    rec = rec[rec[:, 0, n + 2] > 0].double()
    tiles = float(rec[:, 0, n + 2].sum())
    cyc = rec[:, :, :n].sum((0, 1)) / 4 / tiles
    return {"share": dict(zip(_build.STAGES,
                              (cyc / cyc.sum()).tolist())),
            "cycles_per_tile": dict(zip(_build.STAGES, cyc.tolist())),
            "us_per_tile": float((rec[:, 0, n + 1]).sum()) / tiles / 1e3,
            "blocks": int(rec.shape[0]), "tiles": int(tiles)}


def distance_block_plan(B: int, S: int, C: int, k: int):
    """field_fused(want="distance")'s blocks (csrc/field_distance.cu
    DistPlan and the kernel's rows) for B contexts of S samples, C
    candidates and k: (ctx, row, live, staged), the first three (blocks,
    spt * rows) tensors, slot j * rows + q of block i (sample slot q's j-th
    sample) computing row row[i, slot] of context ctx[i, slot] where live;
    staged: the contexts in shared memory, rows = 128 (a thread a sample),
    else read from L2, rows = 16 at k = 1 (8 threads a sample), 32 (a
    thread a sample) at k > 1. S >= 128: one context a block, spt samples
    a slot `rows` rows apart (staged: k = 1 up to 8, the list scan, 2 <= k
    <= 8 and C <= 128, up to 2; else 1), ceil(S / (spt * rows)) blocks a
    context; fewer: the flattened (context, row) order cut into blocks of
    `rows`. A ragged slot takes the context of its block's first row, row
    0, and is not live."""
    from ._build import (DIST_K1_LANES, DIST_SMEM, DIST_SPT, DIST_SPT_LIST,
                         DL, DT, DT_L2, LIST_C)

    one = S >= DT
    nctx = 1 if one else min(B, 1 + (DT - 1 + S - 1) // S)
    cp = -(-C // 32) * 32
    staged = (nctx * 32 + 4) * cp <= DIST_SMEM
    rows = DT if staged else DT // DIST_K1_LANES if k == 1 else DT_L2
    most = (1 if not staged else DIST_SPT if k == 1
            else DIST_SPT_LIST if k <= DL and C <= LIST_C else 1)
    spt = 1
    while spt * 2 <= most and S >= spt * 2 * DT:
        spt *= 2
    slot = torch.arange(spt * rows)
    if one:
        per = -(-S // (spt * rows))
        blk = torch.arange(B * per)[:, None]
        ctx = (blk // per).expand(-1, spt * rows)
        row = blk % per * (spt * rows) + slot
        live = row < S
    else:
        g = torch.arange(-(-B * S // rows))[:, None] * rows + slot
        live = g < B * S
        ctx, row = g // S, g % S
    ctx = torch.where(live, ctx, ctx[:, :1])
    return ctx, torch.where(live, row, 0), live, staged


def _ray_field(name, rays_o, rays_d, geo, feat, w1, dens_ws, out, k,
               multires_d, multires_fg, geometry_dim, dtype, logit_tau, keep):
    """The RayField block shared by secant_refine and surface_locate: R
    rays in R // B consecutive tiles of geo (B, 8, C) / feat (B, C, F)."""
    from . import _build

    R = rays_o.shape[0]
    B, _, C = geo.shape
    if R % B:
        raise ValueError(f"{name}: {R} rays do not tile {B} contexts")
    if dtype is not None:
        feat = feat.to(dtype)
    feat = feat.contiguous()
    _check_inputs(rays_o, geo, feat, rays_d)
    dens_d, ldx = _mlp_desc(_dens_layers(dens_ws, geometry_dim), keep)
    return _build.RayField(
        rays_o=_ptr(rays_o.contiguous(), keep),
        rays_d=_ptr(rays_d.contiguous(), keep),
        geo=_ptr(geo.contiguous(), keep), feat=_ptr(feat, keep),
        out=out.data_ptr(), feat_bf16=int(feat.dtype == torch.bfloat16),
        R=R, B=B, T=R // B, C=C, F=feat.shape[-1], k=k, md=multires_d,
        mfg=multires_fg, gd=geometry_dim, lowp=int(dtype is not None),
        ldx=ldx, w1=float(w1), tau=float(logit_tau), dens=dens_d)


def _ptr(t, keep):
    if t is None:
        return None
    keep.append(t)
    return t.data_ptr()


def _no_grad(*ts):
    """A kernel has no backward: under grad mode a tensor that requires
    grad raises instead of leaving the output silently without gradient."""
    if not torch.is_grad_enabled():
        return
    for t in ts:
        for x in (t if isinstance(t, (list, tuple)) else (t,)):
            if isinstance(x, torch.Tensor) and x.requires_grad:
                raise RuntimeError(
                    "field kernels have no backward: call them under "
                    "torch.no_grad() or on detached tensors (an input "
                    "requires grad)")


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


__all__ = ["field_fused", "field_fused_plain", "pack_layer", "split_planes",
           "block_plan", "tile_blocks", "stage_split", "persistent_schedule",
           "tile_smem_plan", "softplus100_pair", "softplus100_bf16_form",
           "secant_refine",
           "secant_refine_plain", "secant_pred", "surface_locate",
           "surface_locate_plain", "candidate_field_v3",
           "candidate_field_v3_plain", "candidate_field",
           "candidate_field_plain", "LAUNCHES", "reset_launch_counts"]
