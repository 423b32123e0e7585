"""The port's CUDA kernels against their plain PyTorch versions on a card
(marker `cuda`; they skip without one), the CPU routing of the kernel
wrappers, and the JAX-free input helpers the other port tests share.

This file imports neither jax nor the JAX package, so on the GPU machine
it runs alone:
    python -m pytest -m cuda --noconftest tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from neumesh_tpu_torch.ops import kernels

FIELD_CASES = [("distance", 1, None, ()), ("distance", 8, None, ()),
               ("density", 8, None, ()), ("density", 8, "bf16", ()),
               ("density_nabla", 8, None, ()),
               ("density_nabla", 8, "bf16", ()),
               ("full", 8, None, ()), ("full", 8, "bf16", ()),
               ("full", 8, "bf16", ("d0", "dh", "c0", "ch"))]
SECANT_CASES = [(rb, fr, dt) for rb in (True, False) for fr in (False, True)
                for dt in (None, "bf16")]
SEL_F32 = ("d0", "dh", "c0", "ch")
# flagship widths (W = 256, dims 32/32, multires 8/2/2/4)
WIDE = dict(W=256, gd=32, cd=32, md=8, mfg=2, mft=2, mv=4)
# on the card, FIELD_CASES and more, each with its random_context
# overrides: the edges of the 64-sample tile (S = 1, 63, 64, 65, 130 and
# B = 1); first-layer row blocks that are not multiples of 16 or empty
# (md = 0, mfg = mft = 0); the flagship width; selective-f32 layers with
# the tangent; C > 128, where the candidate passes leave the registers, and
# C = 300, where a lane's picks take a second 32-bit mask
CARD_FIELD_CASES = ([(*c, {}) for c in FIELD_CASES]
                    + [("density_nabla", 8, "bf16", SEL_F32, {})]
                    + [("full", 8, "bf16", (), dict(B=1, S=n))
                       for n in (1, 63, 64, 65, 130)]
                    + [("density", 1, None, (), dict(B=1, S=65)),
                       ("density_nabla", 8, "bf16", (), dict(md=0)),
                       ("full", 8, "bf16", (), dict(mfg=0, mft=0)),
                       ("full", 8, "bf16", (), WIDE),
                       ("full", 8, None, (), WIDE),
                       ("density_nabla", 8, "bf16", SEL_F32, WIDE),
                       ("density", 8, None, (), dict(C=192)),
                       ("full", 8, "bf16", (), dict(C=192)),
                       ("full", 8, "bf16", SEL_F32, dict(WIDE, C=256)),
                       ("full", 8, "bf16", (), dict(C=300))])
# on the card, SECANT_CASES at T = 100 rays a tile and more: (..., tags,
# T, random_context overrides); T = 100 and 37 are not multiples of the
# 64-ray block; C = 192 and 256 leave the registers in the candidate passes
CARD_SECANT_CASES = ([(*c, (), 100, {}) for c in SECANT_CASES]
                     + [(True, False, "bf16", SEL_F32, 100, {}),
                        (True, True, "bf16", SEL_F32, 37, {}),
                        (True, False, "bf16", (), 37, WIDE),
                        (False, False, "bf16", (), 64, dict(md=0, mfg=0)),
                        (True, False, "bf16", (), 100, dict(C=192)),
                        (True, False, None, (), 100, dict(C=192)),
                        (True, True, "bf16", (), 100, dict(WIDE, C=256))])
# the per-ray path's shapes (one context a ray, C = 96 candidates, F = 64):
# up-sampling S = 16, surface shading S = 1, colour at S = 127 midpoints;
# below 64 samples a context a block spans several contexts (S = 1, 16,
# 37, 63), from 64 one (65, 127)
PER_RAY_S = (1, 16, 37, 63, 65, 127)
PER_RAY_FIELD_CASES = [(want, dt, S) for S in PER_RAY_S
                       for want in ("density", "density_nabla", "full")
                       for dt in (None, "bf16")] + \
    [("distance", None, S) for S in (1, 16, 128)]
# the secant at the per-ray shapes: (T rays a context, rebracket, frozen,
# dtype, tags); T = 1 is the render CLI's surface
PER_RAY_SECANT_CASES = ([(T, rb, fr, dt, ()) for T in (1, 16, 37, 63)
                         for rb in (True, False) for fr in (False, True)
                         for dt in (None, "bf16")]
                        + [(T, True, fr, "bf16", SEL_F32) for T in (1, 37)
                           for fr in (False, True)])
# field_fused(want="distance") on the card (csrc/field_distance.cu): k = 1
# (the serving scan), 2 and 8 (the register list), 16 (masked-min scans);
# C = 8 (below k = 16), 96, 128, 200; S = 1, 16, 63 (several contexts a
# block, S = 1 read from L2), 64, 65 (two or three contexts a block), 2048
# (one context a block, several samples a thread)
DIST_CASES = [(k, C, S) for k in (1, 2, 8, 16) for C in (8, 96, 128, 200)
              for S in (1, 16, 63, 64, 65, 2048)]
# the distance kernel at the edges: (k, distance_context kind)
DIST_EDGE_CASES = [(k, kind) for k in (1, 2, 8, 16)
                   for kind in ("ties", "pads")]
# (want_dh, want_feat, k) of candidate_field_v3 / candidate_field
CAND_CASES = [(True, True, 8), (False, True, 8), (True, False, 8),
              (False, False, 8), (True, True, 1)]
# on the card, more: ray_contexts overrides (S, C, F) and k. S around the
# 32-sample block; C = 96 / 128 keep a lane's candidates in registers, 192 /
# 256 stride, 70 / 150 are no multiple of the 8 lanes (v2 does not pad),
# 300 takes a second 32-bit pick mask a lane;
# F = 1 and 3 leave the 16-byte stores; k = 40 selects more picks than the
# blend's list holds
CARD_CAND_SHAPES = ([(dict(S=n), 8) for n in (1, 31, 32, 33, 65)]
                    + [(dict(C=n), 8) for n in (70, 128, 150, 192, 256, 300)]
                    + [(dict(F=n), 8) for n in (1, 3, 32, 64)]
                    + [({}, k) for k in (1, 4, 16, 40)]
                    + [(dict(S=33, C=192, F=64), 16),
                       (dict(S=65, C=256, F=1), 4),
                       (dict(S=31, C=128, F=32), 1)])
# surface_locate on the card: (dtype, tags, T, n_steps, n_secant,
# random_context overrides). T below, at and above the 64-ray block; C = 192
# / 256 stride over the candidates; n_steps = 1 scans nothing, 2 one step
CARD_LOCATE_CASES = ([(dt, (), T, 16, 3, {}) for dt in (None, "bf16")
                      for T in (1, 37, 63, 64, 65, 100, 128)]
                     + [("bf16", SEL_F32, 100, 16, 3, {}),
                        ("bf16", SEL_F32, 37, 16, 3, WIDE),
                        ("bf16", (), 100, 16, 3, WIDE),
                        (None, (), 64, 16, 3, WIDE),
                        ("bf16", (), 100, 16, 3, dict(B=1)),
                        ("bf16", (), 100, 16, 3, dict(C=192)),
                        (None, (), 100, 16, 3, dict(C=192)),
                        ("bf16", SEL_F32, 100, 16, 3, dict(WIDE, C=256)),
                        ("bf16", (), 64, 16, 3, dict(md=0)),
                        ("bf16", (), 65, 16, 3, dict(mfg=0)),
                        (None, (), 100, 1, 3, {}), ("bf16", (), 100, 2, 3, {}),
                        ("bf16", (), 100, 16, 0, {}),
                        (None, (), 37, 16, 0, {})])


# ---------------------------------------------------------------------------
# inputs (numpy, from a seed)
# ---------------------------------------------------------------------------

def random_context(seed=0, B=3, S=75, C=70, gd=8, cd=8, W=32, md=4, mfg=1,
                   mft=1, mv=2, outward=False):
    """Numpy inputs of the field kernels: samples near a random (8, C)
    candidate context per tile (C and S deliberately not multiples of any
    block), features, and density / colour weight lists in the field
    kernels' layout. Candidates lie on the 0.5-sphere; their indicator
    vectors are random, or the outward normals (a signed distance with a
    surface to find)."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(B, C, 3))
    pts = 0.5 * pts / np.linalg.norm(pts, axis=-1, keepdims=True)
    ind = rng.normal(size=(B, C, 3))
    if outward:
        ind = pts / 0.5
    xyz = pts[:, rng.integers(0, C, S)] + rng.normal(size=(B, S, 3)) * 0.03
    dirs = rng.normal(size=(B, S, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    geo = np.concatenate([pts.transpose(0, 2, 1), ind.transpose(0, 2, 1),
                          np.sum(pts * pts, -1)[:, None],
                          np.sum(pts * ind, -1)[:, None]], 1)

    def lin(i, o):
        return (rng.uniform(-1, 1, (i, o)) / np.sqrt(i),
                rng.uniform(-1, 1, (1, o)) / np.sqrt(i))

    nd = 1 + 2 * md
    w0, b0 = lin(nd + gd * (1 + 2 * mfg), W)
    dws = [w0[:nd], w0[nd:], b0]
    for _ in range(2):
        dws += list(lin(W, W))
    dws += list(lin(W, 1))
    cws = list(lin(3 + nd + 3 + 6 * mv + cd * (1 + 2 * mft), W))
    cws += list(lin(W, W)) + list(lin(W, 3))
    f32 = np.float32
    return dict(xyz=xyz.astype(f32), dirs=dirs.astype(f32),
                geo=geo.astype(f32),
                feat=rng.normal(size=(B, C, gd + cd)).astype(f32),
                dws=[w.astype(f32) for w in dws],
                cws=[w.astype(f32) for w in cws], w1=0.12,
                kw=dict(multires_d=md, multires_fg=mfg, multires_ft=mft,
                        multires_view=mv, geometry_dim=gd))


def brackets(seed, R):
    """Rays from (0, 0, -2.5) into the 0.5-sphere candidate shell, with
    secant brackets around depth ~2 and their proxy values."""
    rng = np.random.default_rng(seed)
    rd = rng.normal(size=(R, 3)) * 0.08 + np.array([0.0, 0.0, 1.0])
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    ro = np.tile([[0.0, 0.0, -2.5]], (R, 1))
    d_low = 2.2 + rng.normal(size=R) * 0.02
    d_high = np.full(R, 1.9)
    f = np.float32
    return dict(rays_o=ro.astype(f), rays_d=rd.astype(f),
                d_low=d_low.astype(f), d_high=d_high.astype(f),
                f_low=(-np.abs(rng.normal(size=R)) * 0.1).astype(f),
                f_high=(np.abs(rng.normal(size=R)) * 0.1).astype(f),
                d_low_w=(d_low - 0.05).astype(f),
                d_high_w=(d_high + 0.05).astype(f))


def low_precision_mask(ws, dtype, keep_f32=(), n_first=2):
    """Per weight of a list in the field kernels' layout (n_first first-
    layer matrices, then bias, weight, bias, ...): True where the matrix
    goes to `dtype` (never a bias, never the positions in keep_f32; all
    False for f32)."""
    return [dtype is not None and not (i >= n_first and (i - n_first) % 2 == 0)
            and i not in keep_f32 for i, w in enumerate(ws)]


def kept_f32(tags, first, head):
    """Weight positions a selective-f32 tag set keeps in f32."""
    keep = set()
    if "d0" in tags or "c0" in tags:
        keep |= set(first)
    if "dh" in tags or "ch" in tags:
        keep |= {head}
    return keep


FLAGSHIP_PRECISIONS = {"f32": (None, ()), "bf16": ("bf16", ()),
                       "bf16_sel_f32": ("bf16", ("d0", "dh", "c0", "ch"))}


def flagship_weights(prec, seed=0):
    """The flagship MLPs (W = 256, dims 32/32, multires 8/2/2/4) in one of
    FLAGSHIP_PRECISIONS, CPU tensors, with random_context's kw."""
    dtype, tags = FLAGSHIP_PRECISIONS[prec]
    inp = random_context(seed=seed, B=1, S=1, C=8, **WIDE)

    def ws(lst, first, head):
        low = low_precision_mask(lst, dtype, kept_f32(tags, first, head),
                                 len(first))
        return [torch.from_numpy(w).to(torch.bfloat16) if lo
                else torch.from_numpy(w) for w, lo in zip(lst, low)]
    return (ws(inp["dws"], (0, 1), len(inp["dws"]) - 2),
            ws(inp["cws"], (0,), len(inp["cws"]) - 2), inp["kw"])


def no_tie_mask(xyz, geo, k=8, eps=1e-6):
    """(B, S) samples whose k-th and k+1-th candidate distances are well
    separated (near-ties legitimately select differently)."""
    p = geo[:, :3].transpose(0, 2, 1)
    d2 = np.sum((xyz[:, :, None, :] - p[:, None]) ** 2, -1)
    srt = np.sort(d2, axis=-1)
    return (np.diff(srt[..., :k + 1], axis=-1) > eps).all(-1)


def torch_field(inp, want, k, dtype, tags, device="cpu", plain=False):
    """field_fused (or its plain version) on `inp` as torch tensors."""
    def t(a):
        return torch.from_numpy(a).to(device)

    def ws(lst, first, head):
        low = low_precision_mask(lst, dtype, kept_f32(tags, first, head),
                                 len(first))
        return [t(w).to(torch.bfloat16) if lo else t(w)
                for w, lo in zip(lst, low)]

    F = inp["feat"].shape[-1] if want == "full" else inp["kw"]["geometry_dim"]
    dws = ws(inp["dws"], (0, 1), len(inp["dws"]) - 2)
    cws = ws(inp["cws"], (0,), len(inp["cws"]) - 2)
    fn = kernels.field_fused_plain if plain else kernels.field_fused
    return fn(t(inp["xyz"]), t(inp["geo"]), t(inp["feat"][..., :F]),
              inp["w1"], dws if want != "distance" else (),
              cws if want == "full" else None,
              t(inp["dirs"]) if want == "full" else None, k=k, want=want,
              dtype=None if dtype is None else torch.bfloat16,
              **inp["kw"])


def torch_secant(inp, br, rebracket, frozen, dtype, device="cpu",
                 plain=False, tags=()):
    """secant_refine (or its plain version) on `inp`/`br` as tensors."""
    def t(a):
        return torch.from_numpy(a).to(device)

    gd = inp["kw"]["geometry_dim"]
    low = low_precision_mask(inp["dws"], dtype,
                             kept_f32(tags, (0, 1), len(inp["dws"]) - 2))
    ws = [t(w).to(torch.bfloat16) if lo else t(w)
          for w, lo in zip(inp["dws"], low)]
    kw = dict(n_iters=3, multires_d=inp["kw"]["multires_d"],
              multires_fg=inp["kw"]["multires_fg"], geometry_dim=gd,
              frozen_knn=frozen,
              dtype=None if dtype is None else torch.bfloat16)
    if rebracket:
        kw.update(d_low_w=t(br["d_low_w"]), d_high_w=t(br["d_high_w"]))
    names = ["rays_o", "rays_d", "d_low", "d_high", "f_low", "f_high"]
    fn = kernels.secant_refine_plain if plain else kernels.secant_refine
    return fn(*[t(br[n]) for n in names], t(inp["geo"]),
              t(inp["feat"][..., :gd]), inp["w1"], ws, **kw)


def assert_field_close(got, want, mask, mode, dtype):
    """f32: ds 1e-5; sdf/rgb 2e-5 + 1e-4 rel; nabla 1e-4 + 1e-4 rel, on
    the no-tie samples. bf16: 2e-3 on >= 97% of the values of each
    output."""
    if dtype is None:
        for i, (g, w) in enumerate(zip(got, want)):
            g, w = np.asarray(g)[mask], np.asarray(w)[mask]
            if mode == "distance":
                np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)
            elif i in (1, 2, 3):
                np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4)
            else:
                np.testing.assert_allclose(g, w, atol=2e-5, rtol=1e-4)
    else:
        for i, (g, w) in enumerate(zip(got, want)):
            share = float((np.abs(np.asarray(g) - np.asarray(w))
                           <= 2e-3).mean())
            assert share >= 0.97, (i, share)


def edit_inputs(seed=0, B=3, S=75, C=70, n_refs=1, clean=(), rotate=True,
                **ctx):
    """random_context's inputs and n_refs references of field_fused_edit:
    each an edit mask on about a third of the candidates (none in the
    contexts `clean`), transferred codes, a colour MLP of its own (another
    random_context's) and a random rotation (the identity without
    `rotate`)."""
    inp = random_context(seed=seed, B=B, S=S, C=C, **ctx)
    rng = np.random.default_rng(seed + 100)
    cd = inp["feat"].shape[-1] - inp["kw"]["geometry_dim"]
    refs = []
    for r in range(n_refs):
        mask = (rng.random((B, C)) < 0.35).astype(np.float32)
        mask[list(clean)] = 0.0
        rot, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        other = random_context(seed=seed + 10 + r, B=1, S=1, C=8, **ctx)
        refs.append(dict(codes=rng.normal(size=(B, C, cd)).astype(np.float32),
                         mask=mask, cws=other["cws"],
                         rot=(rot if rotate else np.eye(3)).astype(
                             np.float32)))
    inp["refs"] = refs
    return inp


def edit_subset(inp, ctxs):
    """edit_inputs' inputs of the contexts `ctxs` alone."""
    out = dict(inp, refs=[dict(r, codes=r["codes"][ctxs], mask=r["mask"][ctxs])
                          for r in inp["refs"]])
    for k in ("xyz", "dirs", "geo", "feat"):
        out[k] = inp[k][ctxs]
    return out


def torch_edit(inp, dtype, tags=(), device="cpu", plain=False,
               painted=None):
    """field_fused_edit (or its plain version) on edit_inputs' `inp` as
    torch tensors: [sdf, r, g, b]."""
    def t(a):
        return torch.from_numpy(a).to(device)

    def ws(lst, first, head):
        low = low_precision_mask(lst, dtype, kept_f32(tags, first, head),
                                 len(first))
        return [t(w).to(torch.bfloat16) if lo else t(w)
                for w, lo in zip(lst, low)]

    low = None if dtype is None else torch.bfloat16
    refs = []
    for r in inp["refs"]:
        codes = t(r["codes"])
        if low is not None:
            codes = codes.to(low).to(torch.float32)
        m = t(r["mask"])[..., None]
        refs.append(kernels.EditRef(
            torch.cat([codes * m, m], -1), tuple(ws(r["cws"], (0,),
                                                    len(r["cws"]) - 2)),
            t(r["rot"]), low,
            inp["kw"]["multires_ft"], inp["kw"]["multires_view"]))
    fn = kernels.field_fused_edit_plain if plain else kernels.field_fused_edit
    return fn(t(inp["xyz"]), t(inp["geo"]), t(inp["feat"]), inp["w1"],
              ws(inp["dws"], (0, 1), len(inp["dws"]) - 2),
              ws(inp["cws"], (0,), len(inp["cws"]) - 2), t(inp["dirs"]),
              refs, k=8, dtype=low, painted=painted, **inp["kw"])


def assert_edit_close(got, want, mask, dtype):
    """field_fused_edit's [sdf, r, g, b] at the `full` mode's tolerances:
    f32 2e-5 + 1e-4 rel on the no-tie samples, bf16 2e-3 on >= 97% of the
    values of each output."""
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        if dtype is None:
            np.testing.assert_allclose(g[mask], w[mask], atol=2e-5,
                                       rtol=1e-4)
        else:
            share = float((np.abs(g - w) <= 2e-3).mean())
            assert share >= 0.97, (i, share)


def assert_roots_close(got, want, dtype):
    """f32: 2e-5 + 1e-4 rel on >= 99% of rays (a kNN near-tie can move a
    root); bf16: 2e-3 on >= 97%."""
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all()
    if dtype is None:
        ok = np.abs(got - want) <= 2e-5 + 1e-4 * np.abs(want)
        assert ok.mean() >= 0.99, ok.mean()
    else:
        assert (np.abs(got - want) <= 2e-3).mean() >= 0.97


def ray_contexts(seed=0, R=4, S=16, C=32, F=16, n_sentinel=0):
    """Numpy inputs of the candidate kernels in the per-ray layout: xyz
    (R, S, 3) near each ray's C candidates pts (R, C, 3) on the
    0.5-sphere, ind, pp = |p|^2, vn = p.n, feat (R, C, F); the last
    n_sentinel candidates of every ray are 1e9 sentinel vertices with zero
    indicators."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(R, C, 3))
    pts = 0.5 * pts / np.linalg.norm(pts, axis=-1, keepdims=True)
    xyz = pts[:, np.arange(S) % C] + rng.normal(size=(R, S, 3)) * 0.02
    ind = rng.normal(size=(R, C, 3))
    feat = rng.normal(size=(R, C, F))
    if n_sentinel:
        pts[:, -n_sentinel:] = 1e9
        ind[:, -n_sentinel:] = 0.0
    f = np.float32
    pts, ind = pts.astype(f), ind.astype(f)
    return dict(xyz=xyz.astype(f), pts=pts, ind=ind,
                pp=np.sum(pts * pts, -1), vn=np.sum(pts * ind, -1),
                feat=feat.astype(f))


def tie_contexts(seed=7, R=3, S=6, C=40, F=8):
    """ray_contexts whose candidates 3 and 17 of every ray are one vertex,
    (0.5, 0, 0) (every product exact in f32), with sample 0 placed on it:
    both have d2 = 0, so both tie-broken values are 0, one masked-min pass
    removes both and k passes select k + 1 candidates."""
    c = ray_contexts(seed=seed, R=R, S=S, C=C, F=F)
    for j in (3, 17):
        c["pts"][:, j] = (0.5, 0.0, 0.0)
    c["xyz"][:, 0] = (0.5, 0.0, 0.0)
    c["pp"] = np.sum(c["pts"] * c["pts"], -1)
    c["vn"] = np.sum(c["pts"] * c["ind"], -1)
    return c


def distance_context(kind, seed=0, B=5, S=40, C=48):
    """random_context samples and contexts with the distance scan's edge
    cases built in (B >= 3, C >= 24):
     - "ties": candidates 3 and 17 of every context one vertex, (0.5, 0,
       0), candidates 5 and 6 one vertex, and samples 0 and 1 on the first
       (d2 = 0 twice, every product exact: the tie-broken values tie at 0);
     - "pads": the last 4 candidates of every context pad columns
       (position 0, indicator 0, pp = 1e12, vn = 0), the 2 before them 1e9
       sentinel vertices (zero indicator), and context 0 with 3 live
       candidates only (fewer than k).
    Returns random_context's dict and `held`, the (B, S) samples whose
    k-th and k+1-th tie-broken distances (float64) are well apart for
    every k of DIST_EDGE_CASES, or that sit on a vertex: their selection
    is the same in any order of the d2 chain's operations (the card's
    kernel and plain version run the same order: every sample holds)."""
    inp = random_context(seed=seed, B=B, S=S, C=C)
    geo, xyz = inp["geo"], inp["xyz"]
    if kind == "ties":
        for j in (3, 17):
            geo[:, 0:3, j] = (0.5, 0.0, 0.0)
        geo[:, 0:3, 6] = geo[:, 0:3, 5]
        xyz[:, 0:2] = (0.5, 0.0, 0.0)
        exact = np.zeros(xyz.shape[:2], bool)
        exact[:, 0:2] = True
    else:
        pad = np.zeros(C, bool)
        pad[C - 4:] = True
        pad = np.broadcast_to(pad, (B, C)).copy()
        pad[0, 3:] = True
        geo[:, 0:6][:, :, C - 6:C - 4] = 0.0
        geo[:, 0:3, C - 6:C - 4] = 1e9
        geo[:, 0:6].transpose(0, 2, 1)[pad] = 0.0
        exact = np.zeros(xyz.shape[:2], bool)
    f32 = np.float32
    p, n = geo[:, 0:3], geo[:, 3:6]
    geo[:, 6] = np.sum(p * p, 1, dtype=f32)
    geo[:, 7] = np.sum(p * n, 1, dtype=f32)
    if kind == "pads":
        geo[:, 6][pad] = 1e12
        geo[:, 7][pad] = 0.0
    x = xyz.astype(np.float64)
    pt = geo[:, 0:3].astype(np.float64).transpose(0, 2, 1)
    d2 = (np.sum(x * x, -1)[..., None] + geo[:, 6][:, None].astype(np.float64)
          - 2.0 * np.einsum("bsi,bci->bsc", x, pt))
    tb = np.sort(np.maximum(d2, 0.0) * (1.0 + np.arange(C) * 2e-7), -1)
    gap = np.diff(tb, axis=-1) > 1e-6
    held = exact | np.all([gap[..., k - 1] for k in (1, 2, 8, 16)
                           if k < C], 0)
    return dict(inp, held=held)


def torch_distance(inp, k, device="cpu", plain=False):
    """field_fused(want="distance") (or its plain version) -> (B, S)
    numpy."""
    fn = kernels.field_fused_plain if plain else kernels.field_fused
    B, C = inp["geo"].shape[0], inp["geo"].shape[2]
    return fn(torch.from_numpy(inp["xyz"]).to(device),
              torch.from_numpy(inp["geo"]).to(device),
              torch.zeros((B, C, 1), device=device), inp["w1"], k=k,
              want="distance")[0].cpu().numpy()


def assert_distance_close(got, want, held):
    """2e-5 + 1e-4 rel on the held samples, finite everywhere."""
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[held], want[held], atol=2e-5, rtol=1e-4)


def pack_geo(c):
    """(R, 8, C) packed rows [px py pz ix iy iz pp vn] of ray_contexts."""
    return np.concatenate([c["pts"].transpose(0, 2, 1),
                           c["ind"].transpose(0, 2, 1), c["pp"][:, None],
                           c["vn"][:, None]], 1)


def torch_candidate(c, v3, want_dh, want_feat, k, device="cpu",
                    plain=False):
    """candidate_field_v3 (v3) / candidate_field (or a plain version) on
    ray_contexts `c` -> numpy (ds, dh | None, feats | None)."""
    def t(a):
        return torch.from_numpy(a).to(device)

    kw = dict(k=k, want_dh=want_dh, want_feat=want_feat)
    if v3:
        fn = (kernels.candidate_field_v3_plain if plain
              else kernels.candidate_field_v3)
        out = fn(t(c["xyz"]), t(pack_geo(c)), t(c["feat"]), 0.12, **kw)
    else:
        fn = kernels.candidate_field_plain if plain else kernels.candidate_field
        out = fn(*[t(c[n]) for n in ("xyz", "pts", "pp", "ind", "vn",
                                     "feat")], 0.12, **kw)
    return [None if o is None else o.cpu().numpy() for o in out]


def assert_candidate_close(got, want, ok):
    """ds 1e-5 + 1e-4 rel, dh 1e-4 + 1e-3 rel, feats 5e-5 + 1e-4 rel on the
    no-tie samples `ok` (the tolerances of tests/test_pallas.py)."""
    for g, w, (atol, rtol) in zip(got, want, ((1e-5, 1e-4), (1e-4, 1e-3),
                                              (5e-5, 1e-4))):
        assert (g is None) == (w is None)
        if g is not None:
            assert np.isfinite(g).all()
            np.testing.assert_allclose(g[ok], w[ok], atol=atol, rtol=rtol)


def locate_rays(seed, B, T, n_steps):
    """Rays from (0, 0, -2.5) into the 0.5-sphere with near/far of the unit
    sphere, and the (B, T * n_steps, 3) scan points of each tile."""
    rng = np.random.default_rng(seed)
    R = B * T
    rd = rng.normal(size=(R, 3)) * 0.12 + np.array([0.0, 0.0, 1.0])
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    ro = np.tile([[0.0, 0.0, -2.5]], (R, 1))
    mid = -np.sum(ro * rd, -1)
    near, far = mid - 1.0, mid + 1.0
    f = np.float32
    step = (far - near) / max(n_steps - 1, 1)
    d = near[:, None] + step[:, None] * np.arange(n_steps)
    scan = (ro[:, None] + d[..., None] * rd[:, None]).reshape(B, -1, 3)
    return dict(rays_o=ro.astype(f), rays_d=rd.astype(f),
                near=near.astype(f), far=far.astype(f), scan=scan)


def torch_locate(inp, lr, dtype, n_steps, device="cpu", plain=False,
                 n_secant=3, tags=()):
    """surface_locate (or its plain version) -> numpy (d_pred, mask,
    mask_sign_change, val0_pos)."""
    def t(a):
        return torch.from_numpy(a).to(device)

    gd = inp["kw"]["geometry_dim"]
    low = low_precision_mask(inp["dws"], dtype,
                             kept_f32(tags, (0, 1), len(inp["dws"]) - 2))
    ws = [t(w).to(torch.bfloat16) if lo else t(w)
          for w, lo in zip(inp["dws"], low)]
    fn = kernels.surface_locate_plain if plain else kernels.surface_locate
    out = fn(t(lr["rays_o"]), t(lr["rays_d"]), t(lr["near"]), t(lr["far"]),
             t(inp["geo"]), t(inp["feat"][..., :gd]), inp["w1"], ws,
             n_steps=n_steps, n_secant=n_secant,
             multires_d=inp["kw"]["multires_d"],
             multires_fg=inp["kw"]["multires_fg"], geometry_dim=gd,
             dtype=None if dtype is None else torch.bfloat16)
    return [o.cpu().numpy() for o in out]


def assert_locate_close(got, want, ok, dtype):
    """On the rays `ok` (no kNN tie at a scan point): mask bits equal, and
    d_pred as assert_roots_close."""
    for i in (1, 2, 3):
        np.testing.assert_array_equal(got[i][ok], want[i][ok])
    assert_roots_close(got[0][ok], want[0][ok], dtype)


# ---------------------------------------------------------------------------
# CPU routing and argument packing
# ---------------------------------------------------------------------------

def test_wrappers_take_the_plain_version_on_cpu_tensors():
    inp = random_context(seed=5, S=20, C=40)
    kernels.reset_launch_counts()
    out = torch_field(inp, "full", 8, "bf16", ())
    ref = torch_field(inp, "full", 8, "bf16", (), plain=True)
    assert len(out) == 7 and all(o.shape == (3, 20) for o in out)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    br = brackets(1, 3 * 8)
    d = torch_secant(inp, br, True, False, None)
    assert torch.equal(d, torch_secant(inp, br, True, False, None,
                                       plain=True))
    assert all(v == 0 for modes in kernels.LAUNCHES.values()
               for v in modes.values())


def test_kernel_layer_descriptors():
    """Joined first-layer rows, the bias split point and the activation
    row stride the kernels are given."""
    from neumesh_tpu_torch.ops import _build
    inp = random_context(seed=2)
    dws = [torch.from_numpy(w) for w in inp["dws"]]
    cws = [torch.from_numpy(w).to(torch.bfloat16) if w.shape[0] > 1
           else torch.from_numpy(w) for w in inp["cws"]]
    keep = []
    layers = kernels._dens_layers(dws, 8)
    assert layers[0][0].shape == (9 + 8 + 16, 32) and layers[0][2] == 9 + 8
    desc, ldx = kernels._mlp_desc(layers, keep)
    assert desc.n == 4 and ldx % 32 == 0
    assert desc.l[0].kp1 == 32 and desc.l[0].kp == 48 and ldx >= 48
    cdesc, cldx = kernels._mlp_desc(kernels._col_layers(cws, 8, 4, 2), keep)
    nh = 3 + 9 + 3 + 12 + 8
    assert cdesc.l[0].split == nh and cdesc.l[0].bf16 == 1
    assert cdesc.l[0].K == nh + 16 and cldx % 32 == 0
    assert (cdesc.l[0].kp1, cdesc.l[0].kp) == (48, 64)
    assert cdesc.n == len(cws) // 2 <= _build.MAX_LAYERS


def unpack_layer(packed, kp):
    """pack_layer's (kp, NPAD) zero-padded weight back from its slices."""
    from neumesh_tpu_torch.ops._build import KS, NPAD
    rows, off = [], 0
    for k0 in range(0, kp, KS):
        ks = min(KS, kp - k0)
        blk = packed[off:off + ks * NPAD].reshape(NPAD // 8, ks // 8, 8, 8)
        rows.append(blk.permute(0, 2, 1, 3).reshape(NPAD, ks).t())
        off += ks * NPAD
    assert off == packed.numel()
    return torch.cat(rows)


@pytest.mark.parametrize("ctx", [{}, dict(md=0), dict(mfg=0, mft=0), WIDE])
def test_packed_layers_unpack_to_their_weights(ctx):
    """Every bf16 hidden layer unpacks to its weight, each row block at a
    multiple of 16 rows, with only zero rows and columns added."""
    from neumesh_tpu_torch.ops._build import NPAD
    inp = random_context(seed=3, **ctx)
    gd = inp["kw"]["geometry_dim"]
    dws = [torch.from_numpy(w).to(torch.bfloat16) for w in inp["dws"]]
    cws = [torch.from_numpy(w).to(torch.bfloat16) for w in inp["cws"]]
    cd = inp["feat"].shape[-1] - gd
    kw = inp["kw"]
    for layers in (kernels._dens_layers(dws, gd),
                   kernels._col_layers(cws, cd, kw["multires_d"],
                                       kw["multires_view"])):
        for w, _, split in layers[:-1]:
            packed, kp1, kp = kernels.pack_layer(w, split)
            K, N = w.shape
            assert packed.dtype == torch.bfloat16 and kp1 % 16 == 0
            assert kp % 16 == 0 and packed.numel() == kp * NPAD
            full = unpack_layer(packed, kp)
            blocks = ([(0, 0, split), (kp1, split, K)] if split
                      else [(0, 0, K)])
            seen = torch.zeros(kp, dtype=torch.bool)
            for dst, lo, hi in blocks:
                assert torch.equal(full[dst:dst + hi - lo, :N], w[lo:hi])
                seen[dst:dst + hi - lo] = True
            assert not full[~seen].any() and not full[:, N:].any()
            if split:
                assert kp1 == -(-split // 16) * 16
                assert kp - kp1 == -(-(K - split) // 16) * 16
            else:
                assert kp1 == kp == NPAD


def test_tile_descriptors_pack_only_bf16_hidden_layers():
    """The tile stage's descriptors: every hidden layer packed (a bf16 one
    as one plane, an f32 one as its three split planes), a bf16 head
    reading an NPAD-wide tile, an f32 head none; f32 rows of stride >=
    NPAD, a multiple of 32."""
    from neumesh_tpu_torch.ops._build import NPAD
    inp = random_context(seed=4)
    low = low_precision_mask(inp["dws"], "bf16", kept_f32(SEL_F32, (0, 1),
                                                          len(inp["dws"]) - 2))
    dws = [torch.from_numpy(w).to(torch.bfloat16) if lo
           else torch.from_numpy(w) for w, lo in zip(inp["dws"], low)]
    layers = kernels._dens_layers(dws, 8)
    keep = []
    desc, ldx = kernels._mlp_desc(layers, keep)
    assert ldx >= NPAD and ldx % 32 == 0
    assert (desc.l[0].bf16, desc.l[0].kp1, desc.l[0].kp) == (0, 32, 48)
    assert desc.l[0].wp
    for i in (1, 2):
        assert desc.l[i].bf16 == 1 and desc.l[i].wp
        assert desc.l[i].kp1 == desc.l[i].kp == NPAD
    assert (desc.l[3].bf16, desc.l[3].kp) == (0, 0)
    all_bf = [torch.from_numpy(w).to(torch.bfloat16) if w.shape[0] > 1
              else torch.from_numpy(w) for w in inp["dws"]]
    bdesc, _ = kernels._mlp_desc(kernels._dens_layers(all_bf, 8), keep)
    assert bdesc.l[0].wp and bdesc.l[0].kp1 == 32 and bdesc.l[0].kp == 48
    assert bdesc.l[3].kp == NPAD and not bdesc.l[3].wp


@pytest.mark.parametrize("dtype,tags", [("bf16", ()), ("bf16", SEL_F32),
                                        (None, ())])
def test_surface_locate_descriptor_is_a_tile_descriptor(dtype, tags):
    """surface_locate's argument block describes its density MLP for the
    tensor-core tile stage, as secant_refine's does: bf16 hidden layers
    packed with their tile widths, f32 layers unpacked on rows of stride
    >= NPAD, C padded to 128, and the C entry's tile_mlp_ok conditions."""
    from neumesh_tpu_torch.ops._build import NPAD
    inp = random_context(seed=4, C=70)
    lr = locate_rays(3, 3, 37, 16)
    low = low_precision_mask(inp["dws"], dtype,
                             kept_f32(tags, (0, 1), len(inp["dws"]) - 2))
    ws = [torch.from_numpy(w).to(torch.bfloat16) if lo
          else torch.from_numpy(w) for w, lo in zip(inp["dws"], low)]
    out = torch.empty((4, 111))
    args, keep = kernels._locate_args(
        *[torch.from_numpy(lr[n]) for n in ("rays_o", "rays_d", "near",
                                            "far")],
        torch.from_numpy(inp["geo"]), torch.from_numpy(inp["feat"][..., :8]),
        inp["w1"], ws, out, n_steps=16, n_secant=3, k=8, multires_d=4,
        multires_fg=1, geometry_dim=8,
        dtype=None if dtype is None else torch.bfloat16, logit_tau=0.0)
    f = args.f
    assert (f.R, f.B, f.T, f.C, f.F, f.k) == (111, 3, 37, 128, 8, 8)
    assert f.ldx >= NPAD and f.ldx % 32 == 0 and f.dens.n == 4
    assert (args.n_steps, args.n_secant) == (16, 3) and keep
    for i in range(4):
        L, hidden = f.dens.l[i], i < 3
        bf = int(low[(0, 3, 5, 7)[i]])
        assert L.bf16 == bf and (L.kp > 0) == bool(bf or hidden)
        assert bool(L.wp) == hidden and L.kp % 16 == 0
        if L.wp:
            assert L.kp1 % 16 == 0 and L.kp1 <= L.kp and L.N <= NPAD
    if dtype is not None and not tags:
        assert f.dens.l[0].kp1 == 32 and f.dens.l[0].kp == 48
        assert f.dens.l[1].kp1 == f.dens.l[1].kp == NPAD
        assert f.dens.l[3].kp == NPAD


@pytest.mark.parametrize("T", [37, 100])
def test_surface_locate_wrapper_takes_the_plain_version_on_cpu_tiles(T):
    """CPU tensors reach surface_locate's plain version at ray counts that
    are no multiple of the kernel's 64-ray block; no kernel is counted."""
    inp = random_context(seed=11, C=70, outward=True)
    lr = locate_rays(12, 3, T, 8)
    kernels.reset_launch_counts()
    for dtype, tags in ((None, ()), ("bf16", SEL_F32)):
        got = torch_locate(inp, lr, dtype, 8, tags=tags)
        want = torch_locate(inp, lr, dtype, 8, plain=True, tags=tags)
        assert got[0].shape == (3 * T,) and got[1].dtype == np.bool_
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
        assert np.isfinite(got[0]).all() and got[2].any()
    assert all(v == 0 for modes in kernels.LAUNCHES.values()
               for v in modes.values())


def listed_picks(W):
    """The kernel's pick list of one sample from its weight row W (C,):
    lane l of the sample's 8 holds candidates l, l + 8, ... as a bit mask;
    a pick's place in the list is the number of picks on lower slots of
    any lane plus those on its own slot on lower lanes. Returns the
    candidate ids in list order."""
    C = W.shape[0]
    masks = [sum(1 << i for i in range((C - l + 7) // 8) if W[l + 8 * i] != 0)
             for l in range(8)]
    order = {}
    for l in range(8):
        i, mk = 0, masks[l]
        while mk:
            if mk & 1:
                low = (1 << i) - 1
                pos = sum(bin(masks[j] & low).count("1")
                          + (j < l and (masks[j] >> i) & 1) for j in range(8))
                assert pos not in order
                order[pos] = l + 8 * i
            mk >>= 1
            i += 1
    return [order[p] for p in range(len(order))]


@pytest.mark.parametrize("C,k", [(40, 8), (128, 8), (70, 1), (192, 16)])
def test_listed_picks_sum_to_the_row_sum_bit_for_bit(C, k):
    """The candidate kernels' blend sums w feat over each sample's listed
    picks instead of over the whole weight row. The list ascends, so the
    f32 sum (one fused multiply-add a pick) equals the row scan's bit for
    bit, here against a sequential f32 row scan and, to rounding, against
    the plain version's W @ feat."""
    c = ray_contexts(seed=9, R=2, S=5, C=C, F=6)
    geo, feat = torch.from_numpy(pack_geo(c)), c["feat"]
    x = torch.from_numpy(c["xyz"])
    _, W = kernels._interp_distance(x[..., 0:1], x[..., 1:2], x[..., 2:3],
                                    geo, 0.12, k, False, k1_proxy=False)
    W = W.numpy()

    def fma(a, b, acc):      # one rounding, as fmaf
        return np.float32(np.float64(a) * np.float64(b) + np.float64(acc))

    for r in range(2):
        for s in range(5):
            picks = listed_picks(W[r, s])
            assert picks == sorted(picks) == list(np.nonzero(W[r, s])[0])
            assert len(picks) >= k
            for f in range(6):
                row = lst = np.float32(0)
                for cc in range(C):
                    if W[r, s, cc] != 0:
                        row = fma(W[r, s, cc], feat[r, cc, f], row)
                for cc in picks:
                    lst = fma(W[r, s, cc], feat[r, cc, f], lst)
                assert row == lst
            want = kernels._feat_dot(torch.from_numpy(W[r, s:s + 1]),
                                     torch.from_numpy(feat[r]))[0].numpy()
            got = [sum(np.float64(W[r, s, cc]) * feat[r, cc, f]
                       for cc in picks) for f in range(6)]
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_wrappers_take_the_plain_version_for_cpu_tiles():
    """CPU tensors reach the plain versions at the tile stage's edges too
    (S = 65, selective-f32 layers, an empty second row block), and no
    kernel is counted."""
    kernels.reset_launch_counts()
    for ctx, tags in ((dict(B=1, S=65), ()), ({}, SEL_F32),
                      (dict(mfg=0, mft=0), ())):
        inp = random_context(seed=8, **ctx)
        out = torch_field(inp, "full", 8, "bf16", tags)
        ref = torch_field(inp, "full", 8, "bf16", tags, plain=True)
        assert all(torch.equal(a, b) for a, b in zip(out, ref))
    inp = random_context(seed=8)
    br = brackets(2, 3 * 37)
    d = torch_secant(inp, br, True, True, "bf16", tags=SEL_F32)
    assert torch.equal(d, torch_secant(inp, br, True, True, "bf16",
                                       plain=True, tags=SEL_F32))
    assert all(v == 0 for modes in kernels.LAUNCHES.values()
               for v in modes.values())


# ---------------------------------------------------------------------------
# on the card: CUDA kernel against the plain version
# ---------------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("want,k,dtype,tags,ctx", CARD_FIELD_CASES)
def test_field_fused_kernel_matches_plain_on_card(want, k, dtype, tags, ctx):
    _need_card()
    inp = random_context(seed=6, **dict(dict(B=8, S=300, C=128), **ctx))
    mask = no_tie_mask(inp["xyz"], inp["geo"], k=k)
    kernels.reset_launch_counts()
    got = [o.cpu().numpy() for o in
           torch_field(inp, want, k, dtype, tags, device="cuda")]
    assert kernels.LAUNCHES["field_fused"][want] == 1
    ref = [o.cpu().numpy() for o in
           torch_field(inp, want, k, dtype, tags, device="cuda", plain=True)]
    assert_field_close(got, ref, mask, want, dtype)


def _launched_libraries(monkeypatch):
    """The names _build.launch is called with, in order."""
    from neumesh_tpu_torch.ops import _build
    names, launch = [], _build.launch

    def record(name, args, operand):
        names.append(name)
        launch(name, args, operand)
    monkeypatch.setattr(_build, "launch", record)
    return names


@pytest.mark.cuda
@pytest.mark.parametrize("k,C,S", DIST_CASES)
def test_field_distance_kernel_matches_plain_on_card(k, C, S, monkeypatch):
    """The distance kernel (field_distance.cu, not the tile kernel) against
    the plain version at B = 7 contexts (with S = 63 / 65 no block
    boundary meets a context's), every sample within 2e-5 + 1e-4 rel."""
    _need_card()
    inp = random_context(seed=50 + k + C + S, B=7, S=S, C=C)
    names = _launched_libraries(monkeypatch)
    kernels.reset_launch_counts()
    got = torch_distance(inp, k, "cuda")
    assert names == ["field_distance"]
    assert kernels.LAUNCHES["field_fused"]["distance"] == 1
    want = torch_distance(inp, k, "cuda", plain=True)
    assert_distance_close(got, want, np.ones(got.shape, bool))


@pytest.mark.cuda
@pytest.mark.parametrize("k,kind", DIST_EDGE_CASES)
@pytest.mark.parametrize("S", [16, 300])
def test_field_distance_kernel_at_ties_and_pads_on_card(k, kind, S):
    """distance_context's exact ties (duplicate vertices, samples on a
    vertex: every candidate at the least tie-broken value counts), pad
    columns, 1e9 sentinels and a context with fewer live candidates than
    k, at several contexts a block (S = 16) and one (S = 300)."""
    _need_card()
    inp = distance_context(kind, seed=60 + k, B=9, S=S, C=96)
    got = torch_distance(inp, k, "cuda")
    want = torch_distance(inp, k, "cuda", plain=True)
    assert_distance_close(got, want, np.ones(got.shape, bool))


@pytest.mark.cuda
@pytest.mark.parametrize("rebracket,frozen,dtype,tags,T,ctx",
                         CARD_SECANT_CASES)
def test_secant_refine_kernel_matches_plain_on_card(rebracket, frozen,
                                                    dtype, tags, T, ctx):
    _need_card()
    inp = random_context(seed=9, **dict(dict(B=8, C=128), **ctx))
    br = brackets(10, 8 * T)
    kernels.reset_launch_counts()
    got = torch_secant(inp, br, rebracket, frozen, dtype, "cuda", tags=tags)
    assert kernels.LAUNCHES["secant_refine"][
        kernels.secant_mode(rebracket, frozen)] == 1
    ref = torch_secant(inp, br, rebracket, frozen, dtype, "cuda", plain=True,
                       tags=tags)
    assert_roots_close(got.cpu().numpy(), ref.cpu().numpy(), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("v3", [True, False])
@pytest.mark.parametrize("want_dh,want_feat,k", CAND_CASES)
def test_candidate_kernels_match_plain_on_card(v3, want_dh, want_feat, k):
    _need_card()
    c = ray_contexts(seed=12, R=64, S=150, C=96, F=40, n_sentinel=4)
    ok = no_tie_mask(c["xyz"], pack_geo(c), k=k)
    name = "candidate_field_v3" if v3 else "candidate_field"
    kernels.reset_launch_counts()
    got = torch_candidate(c, v3, want_dh, want_feat, k, device="cuda")
    assert kernels.LAUNCHES[name][kernels.candidate_mode(want_dh,
                                                         want_feat)] == 1
    want = torch_candidate(c, v3, want_dh, want_feat, k, device="cuda",
                           plain=True)
    assert_candidate_close(got, want, ok)


@pytest.mark.cuda
@pytest.mark.parametrize("v3", [True, False])
@pytest.mark.parametrize("want_dh,want_feat", [(True, True), (False, True),
                                               (False, False)])
@pytest.mark.parametrize("ctx,k", CARD_CAND_SHAPES)
def test_candidate_kernels_match_plain_at_block_edges_on_card(ctx, k, v3,
                                                              want_dh,
                                                              want_feat):
    _need_card()
    c = ray_contexts(seed=15, **dict(dict(R=6, S=70, C=96, F=40), **ctx))
    ok = no_tie_mask(c["xyz"], pack_geo(c), k=k)
    got = torch_candidate(c, v3, want_dh, want_feat, k, device="cuda")
    want = torch_candidate(c, v3, want_dh, want_feat, k, device="cuda",
                           plain=True)
    assert_candidate_close(got, want, ok)


@pytest.mark.cuda
@pytest.mark.parametrize("v3", [True, False])
@pytest.mark.parametrize("k", [1, 8, 31, 32])
def test_candidate_kernels_sum_every_tied_pick_on_card(v3, k):
    """A sample on a duplicated candidate selects k + 1 picks (k = 32: one
    more than the blend's list holds); its feats and ds must be the plain
    version's, which sums the whole weight row."""
    _need_card()
    c = tie_contexts(S=40, C=96, F=16)
    got = torch_candidate(c, v3, False, True, k, device="cuda")
    want = torch_candidate(c, v3, False, True, k, device="cuda", plain=True)
    geo = torch.from_numpy(pack_geo(c))
    x = torch.from_numpy(c["xyz"])
    _, W = kernels._interp_distance(x[..., 0:1], x[..., 1:2], x[..., 2:3],
                                    geo, 0.12, k, False, k1_proxy=False)
    assert ((W[:, 0] != 0).sum(-1) == k + 1).all()
    np.testing.assert_allclose(got[2][:, 0], want[2][:, 0], atol=5e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(got[0][:, 0], want[0][:, 0], atol=1e-5,
                               rtol=1e-4)
    ok = no_tie_mask(c["xyz"], pack_geo(c), k=k)
    assert_candidate_close(got, want, ok)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tags,T,n_steps,n_secant,ctx",
                         CARD_LOCATE_CASES)
def test_surface_locate_kernel_matches_plain_on_card(dtype, tags, T, n_steps,
                                                     n_secant, ctx):
    _need_card()
    inp = random_context(seed=13, **dict(dict(B=8, C=128, outward=True),
                                         **ctx))
    B = inp["geo"].shape[0]
    lr = locate_rays(14, B, T, n_steps)
    ok = no_tie_mask(lr["scan"], inp["geo"]).reshape(-1, n_steps).all(-1)
    kernels.reset_launch_counts()
    got = torch_locate(inp, lr, dtype, n_steps, device="cuda",
                       n_secant=n_secant, tags=tags)
    assert kernels.LAUNCHES["surface_locate"][
        "f32" if dtype is None else "bf16"] == 1
    want = torch_locate(inp, lr, dtype, n_steps, device="cuda", plain=True,
                        n_secant=n_secant, tags=tags)
    assert got[0].shape == (B * T,)
    if n_steps >= 16 and B * T >= 64:
        assert got[1].mean() > 0.5
    assert_locate_close(got, want, ok, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("want,dtype,S", PER_RAY_FIELD_CASES)
def test_field_fused_at_per_ray_shapes_on_card(want, dtype, S):
    """B = 509 contexts (B S no multiple of the 64-row block: the last
    block ragged)."""
    _need_card()
    inp = random_context(seed=31, B=509, S=S, C=96, gd=32, cd=32)
    mask = no_tie_mask(inp["xyz"], inp["geo"])
    got = [o.cpu().numpy() for o in
           torch_field(inp, want, 8, dtype, (), device="cuda")]
    ref = [o.cpu().numpy() for o in
           torch_field(inp, want, 8, dtype, (), device="cuda", plain=True)]
    assert_field_close(got, ref, mask, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("want", ["density", "density_nabla", "full"])
@pytest.mark.parametrize("S", PER_RAY_S)
def test_field_fused_selective_f32_at_per_ray_shapes_on_card(want, S):
    """bf16 serving with the selective-f32 layers (d0, dh, c0, ch) at the
    per-ray shapes and the flagship width: the f32 first layers on the
    tensor-core split beside bf16 layers, B = 509 contexts."""
    _need_card()
    inp = random_context(seed=39, **dict(WIDE, B=509, S=S, C=96))
    mask = no_tie_mask(inp["xyz"], inp["geo"])
    got = [o.cpu().numpy() for o in
           torch_field(inp, want, 8, "bf16", SEL_F32, device="cuda")]
    ref = [o.cpu().numpy() for o in
           torch_field(inp, want, 8, "bf16", SEL_F32, device="cuda",
                       plain=True)]
    assert_field_close(got, ref, mask, want, "bf16")


@pytest.mark.cuda
@pytest.mark.parametrize("prec", list(FLAGSHIP_PRECISIONS))
def test_field_fused_edit_at_the_swap_cells_shapes_on_card(prec):
    """The swap cell's chunk: 469 tile contexts of 128 rays x 127 samples,
    C = 128, the flagship width, two rotated references; the kernel on the
    whole call (one launch), its plain version on four of the contexts."""
    _need_card()
    dtype, tags = FLAGSHIP_PRECISIONS[prec]
    inp = edit_inputs(seed=21, B=469, S=16256, C=128, n_refs=2, **WIDE)
    kernels.reset_launch_counts()
    got = torch_edit(inp, dtype, tags, device="cuda")
    assert kernels.LAUNCHES["field_fused_edit"]["full"] == 1
    pick = [0, 155, 310, 468]
    sub = edit_subset(inp, pick)
    want = torch_edit(sub, dtype, tags, device="cuda", plain=True)
    assert_edit_close([g[pick].cpu() for g in got], [w.cpu() for w in want],
                      no_tie_mask(sub["xyz"], sub["geo"]), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, "bf16"])
@pytest.mark.parametrize("B,S", [(509, 1), (509, 16), (7, 300)])
def test_field_fused_edit_matches_plain_on_card(dtype, B, S):
    """The per-ray shapes (S = 1 and 16 at C = 96; B S no multiple of the
    64-row block, so the last block is ragged) and a ragged tile shape (S
    = 300), two references, the flagship width: the kernel against its
    plain version, and the samples with a positive paint weight counted
    alike on both."""
    _need_card()
    inp = edit_inputs(seed=23 + S, B=B, S=S, C=96, n_refs=2, **WIDE)
    painted = [torch.zeros(1, dtype=torch.int64, device="cuda")
               for _ in range(2)]
    got = torch_edit(inp, dtype, device="cuda", painted=painted[0])
    want = torch_edit(inp, dtype, device="cuda", plain=True,
                      painted=painted[1])
    assert_edit_close([g.cpu() for g in got], [w.cpu() for w in want],
                      no_tie_mask(inp["xyz"], inp["geo"]), dtype)
    assert int(painted[0]) == int(painted[1]) > 0


@pytest.mark.cuda
def test_field_fused_edit_launch_errors_raise_on_card():
    """A reference the C entry refuses (codes wider than the main
    features) fails the launch's error check and raises; nothing falls
    back."""
    _need_card()
    inp = edit_inputs(seed=9, B=4, S=70, C=40, n_refs=1)
    wide = random_context(seed=10, B=1, S=1, C=8, cd=17)
    inp["refs"][0].update(
        codes=np.ones((4, 40, 17), np.float32), cws=wide["cws"])
    kernels.reset_launch_counts()
    with pytest.raises(RuntimeError, match="field_fused_edit launch failed"):
        torch_edit(inp, None, device="cuda")
    assert kernels.LAUNCHES["field_fused_edit"]["full"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("T,rebracket,frozen,dtype,tags",
                         PER_RAY_SECANT_CASES)
def test_secant_refine_at_per_ray_shapes_on_card(T, rebracket, frozen, dtype,
                                                 tags):
    """The secant below 64 rays a context (a block spans several
    contexts), every option, f32, bf16 and selective f32, at the flagship
    width; B T no multiple of 64 (the last block ragged), one launch."""
    _need_card()
    B = 1021 if T == 1 else 67
    inp = random_context(seed=40 + T, **dict(WIDE, B=B, S=1, C=96))
    br = brackets(41 + T, B * T)
    kernels.reset_launch_counts()
    got = torch_secant(inp, br, rebracket, frozen, dtype, "cuda", tags=tags)
    assert sum(kernels.LAUNCHES["secant_refine"].values()) == 1
    ref = torch_secant(inp, br, rebracket, frozen, dtype, "cuda", plain=True,
                       tags=tags)
    assert_roots_close(got.cpu().numpy(), ref.cpu().numpy(), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, "bf16"])
def test_secant_and_candidate_v3_at_one_ray_a_context_on_card(dtype):
    """T = 1: the secant of the per-ray surface render and the no-nablas
    colour stage at S = 1, one context a ray."""
    _need_card()
    inp = random_context(seed=32, B=1024, S=1, C=96, gd=32, cd=32)
    br = brackets(33, 1024)
    got = torch_secant(inp, br, True, False, dtype, "cuda")
    ref = torch_secant(inp, br, True, False, dtype, "cuda", plain=True)
    assert_roots_close(got.cpu().numpy(), ref.cpu().numpy(), dtype)
    c = ray_contexts(seed=34, R=1024, S=1, C=96, F=64)
    ok = no_tie_mask(c["xyz"], pack_geo(c))
    assert_candidate_close(
        torch_candidate(c, True, False, True, 8, device="cuda"),
        torch_candidate(c, True, False, True, 8, device="cuda", plain=True),
        ok)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["field_fused", "secant_refine",
                                  "surface_locate", "candidate_field_v3"])
def test_kernels_launch_more_than_65535_contexts_on_card(name):
    """B = 70,000 contexts, one sample or ray each (a per-ray chunk of more
    than 65,535 rays): every launcher takes them and agrees with the plain
    version."""
    _need_card()
    B = 70000
    inp = random_context(seed=35, B=B, S=1, C=96, outward=True)
    kernels.reset_launch_counts()
    if name == "field_fused":
        got = torch_field(inp, "distance", 8, None, (), device="cuda")
        ref = torch_field(inp, "distance", 8, None, (), device="cuda",
                          plain=True)
        mask = no_tie_mask(inp["xyz"], inp["geo"])
        assert_field_close([o.cpu().numpy() for o in got],
                           [o.cpu().numpy() for o in ref], mask, "distance",
                           None)
    elif name == "secant_refine":
        br = brackets(36, B)
        got = torch_secant(inp, br, True, False, None, "cuda")
        ref = torch_secant(inp, br, True, False, None, "cuda", plain=True)
        assert_roots_close(got.cpu().numpy(), ref.cpu().numpy(), None)
    elif name == "surface_locate":
        lr = locate_rays(37, B, 1, 16)
        ok = no_tie_mask(lr["scan"], inp["geo"]).reshape(-1, 16).all(-1)
        got = torch_locate(inp, lr, None, 16, device="cuda")
        want = torch_locate(inp, lr, None, 16, device="cuda", plain=True)
        assert_locate_close(got, want, ok, None)
    else:
        c = ray_contexts(seed=38, R=B, S=1, C=96, F=16)
        ok = no_tie_mask(c["xyz"], pack_geo(c))
        assert_candidate_close(
            torch_candidate(c, True, False, True, 8, device="cuda"),
            torch_candidate(c, True, False, True, 8, device="cuda",
                            plain=True), ok)
    assert sum(kernels.LAUNCHES[name].values()) == 1


def test_new_wrappers_take_the_plain_version_on_cpu_tensors():
    c = ray_contexts(seed=3, R=3, S=10, C=40, F=8)
    kernels.reset_launch_counts()
    for v3 in (True, False):
        got = torch_candidate(c, v3, True, True, 8)
        want = torch_candidate(c, v3, True, True, 8, plain=True)
        assert got[0].shape == (3, 10, 1) and got[1].shape == (3, 10, 3)
        assert got[2].shape == (3, 10, 8)
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
    inp = random_context(seed=5, S=20, C=40, outward=True)
    lr = locate_rays(2, 3, 8, 6)
    got = torch_locate(inp, lr, None, 6)
    want = torch_locate(inp, lr, None, 6, plain=True)
    assert got[0].shape == (24,) and got[1].dtype == np.bool_
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert all(v == 0 for modes in kernels.LAUNCHES.values()
               for v in modes.values())


def test_params_from_jax_fills_a_no_nablas_model():
    """A parameter tree in the JAX layout (numpy) for enable_nablas_input=
    False: the colour MLP's first layer takes 3 fewer rows; a tree of the
    nablas-input model does not fit it."""
    from neumesh_tpu_torch.dataio.synthetic import icosphere_mesh
    from neumesh_tpu_torch.mesh.grid import MeshGrid
    from neumesh_tpu_torch.models.neumesh.model import NeuMesh
    from neumesh_tpu_torch.utils.state import params_from_jax

    cfg = dict(D_density=2, D_color=2, W=16, geometry_dim=4, color_dim=4,
               multires_d=2, multires_fg=1, multires_ft=1, multires_view=1)
    mg = MeshGrid(icosphere_mesh(0.5, 1), device="cpu")
    rng = np.random.default_rng(0)

    def tree(model):
        def arr(t):
            return rng.normal(size=tuple(t.shape)).astype(np.float32)

        def lin(m):
            return ({"g": arr(m.g), "v": arr(m.v), "b": arr(m.b)}
                    if hasattr(m, "g") else {"w": arr(m.w), "b": arr(m.b)})
        p = {n: arr(getattr(model, n)) for n in
             ("ln_s", "geometry_features", "color_features",
              "indicator_vector", "indicator_weight_raw")}
        p.update(pts_linears=[lin(m) for m in model.pts_linears],
                 density_linear=lin(model.density_linear),
                 views_linears=[lin(m) for m in model.views_linears],
                 color_linear=lin(model.color_linear))
        return p

    plain = NeuMesh(mg, device="cpu", enable_nablas_input=False, **cfg)
    with_nablas = NeuMesh(mg, device="cpu", enable_nablas_input=True, **cfg)
    assert plain.views_linears[0].w.shape[0] + 3 == \
        with_nablas.views_linears[0].w.shape[0]
    p = tree(plain)
    params_from_jax(p, plain)
    np.testing.assert_array_equal(plain.views_linears[0].w.numpy(),
                                  p["views_linears"][0]["w"])
    np.testing.assert_array_equal(plain.pts_linears[1].v.numpy(),
                                  p["pts_linears"][1]["v"])
    with pytest.raises(RuntimeError):
        params_from_jax(tree(with_nablas), plain)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [64, 16])
def test_field_fused_training_shapes_on_card(S):
    """The training path's no-grad up-sampling density: 512 per-ray
    contexts of C = 96 candidates at the flagship width, S = 64 (coarse)
    and S = 16 (each up-sampling round), f32."""
    _need_card()
    inp = random_context(seed=21, **dict(WIDE, B=512, S=S, C=96))
    mask = no_tie_mask(inp["xyz"], inp["geo"], k=8)
    kernels.reset_launch_counts()
    with torch.no_grad():
        got = [o.cpu().numpy() for o in
               torch_field(inp, "density", 8, None, (), device="cuda")]
        ref = [o.cpu().numpy() for o in
               torch_field(inp, "density", 8, None, (), device="cuda",
                           plain=True)]
    assert kernels.LAUNCHES["field_fused"]["density"] == 1
    assert_field_close(got, ref, mask, "density", None)


@pytest.mark.cuda
def test_kernel_wrappers_raise_on_inputs_that_require_grad():
    """A kernel has no backward: under grad mode an input that requires
    grad raises; under no_grad (or detached) the same call runs."""
    _need_card()
    inp = random_context(seed=22, B=2, S=16, C=64)
    xyz = torch.as_tensor(inp["xyz"], device="cuda").requires_grad_(True)
    geo = torch.as_tensor(inp["geo"], device="cuda")
    feat = torch.as_tensor(inp["feat"], device="cuda")
    with pytest.raises(RuntimeError, match="no backward"):
        kernels.field_fused(xyz, geo, feat, 0.1, want="distance")
    with pytest.raises(RuntimeError, match="no backward"):
        kernels.candidate_field_v3(xyz, geo, feat, 0.1)
    with torch.no_grad():
        out = kernels.field_fused(xyz, geo, feat, 0.1, want="distance")
    assert torch.isfinite(out[0]).all()
    kernels.field_fused(xyz.detach(), geo, feat, 0.1, want="distance")


@pytest.mark.cuda
@pytest.mark.parametrize("want,dtype", [("density", None), ("full", "bf16")])
def test_field_fused_launches_on_its_operands_device_and_stream(want,
                                                                dtype):
    """The launch takes the device of its first operand and that device's
    current stream: inside torch.cuda.stream(s) the kernel runs on s (the
    result is read after s alone is synchronised), and, with a second
    card, on tensors on cuda:1 while cuda:0 is current. Each equals its
    plain version."""
    _need_card()
    inp = random_context(seed=8, B=8, S=300, C=128)
    mask = no_tie_mask(inp["xyz"], inp["geo"])
    dt = None if dtype is None else "bf16"
    ref = [o.cpu().numpy() for o in
           torch_field(inp, want, 8, dt, (), device="cuda", plain=True)]
    s = torch.cuda.Stream()
    with torch.cuda.stream(s):
        outs = torch_field(inp, want, 8, dt, (), device="cuda")
    s.synchronize()
    assert_field_close([o.cpu().numpy() for o in outs], ref, mask, want, dt)
    if torch.cuda.device_count() < 2:
        return
    with torch.cuda.device(0):
        kernels.reset_launch_counts()
        got = [o.cpu().numpy() for o in
               torch_field(inp, want, 8, dt, (), device="cuda:1")]
        assert torch.cuda.current_device() == 0
    assert kernels.LAUNCHES["field_fused"][want] == 1
    assert_field_close(got, ref, mask, want, dt)


# ---------------------------------------------------------------------------
# the warp-specialised tile kernels' persistent grid and shared-memory plan
# ---------------------------------------------------------------------------

def _sm_count():
    return torch.cuda.get_device_properties(0).multi_processor_count


# tile counts against the persistent grid (one block an SM): below, equal,
# one above, more than two tiles a block
GRID_OFFSETS = ("below", "equal", "above", "twice")


def _tiles(offset):
    n = _sm_count()
    return {"below": n - 1, "equal": n, "above": n + 1,
            "twice": 2 * n + 5}[offset]


@pytest.mark.cuda
@pytest.mark.parametrize("offset", GRID_OFFSETS)
@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("want,dtype", [("density", None),
                                        ("density", "bf16"),
                                        ("density_nabla", "bf16"),
                                        ("full", None), ("full", "bf16")])
def test_field_fused_persistent_tile_counts_on_card(want, dtype, k, offset):
    """field_fused at tile counts below, equal to and above the persistent
    grid and at more than two tiles a block: S = 64 (one tile a context),
    and S = 100 (two tiles a context, the second ragged) on half as many
    contexts; every held sample against the plain version, one launch."""
    _need_card()
    n = _tiles(offset)
    for B, S in ((n, 64), (-(-n // 2), 100)):
        inp = random_context(seed=70 + n + S + k, B=B, S=S, C=96)
        mask = no_tie_mask(inp["xyz"], inp["geo"], k=k)
        kernels.reset_launch_counts()
        got = [o.cpu().numpy() for o in
               torch_field(inp, want, k, dtype, (), device="cuda")]
        assert kernels.LAUNCHES["field_fused"][want] == 1
        ref = [o.cpu().numpy() for o in
               torch_field(inp, want, k, dtype, (), device="cuda",
                           plain=True)]
        assert_field_close(got, ref, mask, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", GRID_OFFSETS)
@pytest.mark.parametrize("rebracket,frozen", [(True, False), (False, False),
                                              (False, True), (True, True)])
@pytest.mark.parametrize("dtype", [None, "bf16"])
def test_secant_refine_persistent_tile_counts_on_card(dtype, rebracket,
                                                      frozen, offset):
    """secant_refine at ray-block counts below, equal to and above the
    persistent grid and beyond twice it (T = 64 rays a context), every
    option, against the plain version."""
    _need_card()
    B = _tiles(offset)
    inp = random_context(seed=80 + B, B=B, C=96)
    br = brackets(81 + B, B * 64)
    got = torch_secant(inp, br, rebracket, frozen, dtype, "cuda")
    ref = torch_secant(inp, br, rebracket, frozen, dtype, "cuda", plain=True)
    assert_roots_close(got.cpu().numpy(), ref.cpu().numpy(), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ties", "pads"])
@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("want,dtype", [("density", None),
                                        ("density_nabla", "bf16"),
                                        ("full", None), ("full", "bf16")])
@pytest.mark.parametrize("B,S", [(1, 300), (9, 16)])
def test_field_fused_at_ties_and_pads_on_card(B, S, want, dtype, k, kind):
    """distance_context's exact ties (duplicate vertices, samples on a
    vertex) and pads (pad columns, 1e9 sentinels, a context with fewer
    live candidates than k) through the tile kernel, one context (B = 1)
    and several a block: the kernel and the plain version pick the same
    candidates, so every held sample agrees at the tolerances."""
    _need_card()
    inp = distance_context(kind, seed=90 + k, B=max(B, 3), S=S, C=96)
    if B < 3:
        inp = dict(inp, **{n: inp[n][:B] for n in ("xyz", "dirs", "geo",
                                                   "feat", "held")})
    got = [o.cpu().numpy() for o in
           torch_field(inp, want, k, dtype, (), device="cuda")]
    ref = [o.cpu().numpy() for o in
           torch_field(inp, want, k, dtype, (), device="cuda", plain=True)]
    assert_field_close(got, ref, inp["held"], want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("prec", ["f32", "bf16", "bf16_sel_f32"])
def test_smem_plan_mirror_matches_the_c_entries_on_card(prec, monkeypatch):
    """kernels.tile_smem_plan against the libraries' own `_smem` entries
    (field_smem / edit_smem / secant_smem) at the flagship width: the same
    bytes for every mode, the edited shade and the secant, at tile and
    per-ray shapes."""
    import ctypes

    from neumesh_tpu_torch.ops import _build
    _need_card()
    seen, launch = [], _build.launch

    def probed(name, args, operand):
        launch(name, args, operand)
        src, entry = _build.ENTRY[name]
        fn = getattr(_build._lib(src), entry + "_smem")
        seen.append(fn(ctypes.addressof(args)))
    monkeypatch.setattr(_build, "launch", probed)
    dws, cws, kw = flagship_weights(prec)
    dws = [w.cuda() for w in dws]
    cws = [w.cuda() for w in cws]
    low = torch.bfloat16 if prec != "f32" else None
    for C, B, S in ((128, 8, 1024), (96, 509, 1), (96, 509, 16),
                    (70, 3, 37)):
        for want in ("density", "density_nabla", "full"):
            F = 64 if want == "full" else 32
            xyz = torch.rand(B, S, 3, device="cuda")
            geo = torch.rand(B, 8, C, device="cuda")
            feat = torch.rand(B, C, F, device="cuda")
            args = (xyz, geo, feat, 0.1, dws,
                    cws if want == "full" else None, xyz)
            call = dict(want=want, dtype=low, **kw)
            kernels.field_fused(*args, **call)
            assert seen.pop() == kernels.tile_smem_plan(
                "field_fused", *args, **call)["bytes"], (C, B, S, want)
        refs = [kernels.EditRef(torch.rand(B, C, 33, device="cuda"),
                                tuple(cws), torch.eye(3, device="cuda"),
                                low, kw["multires_ft"],
                                kw["multires_view"])] * 2
        eargs = (xyz, geo, torch.rand(B, C, 64, device="cuda"), 0.1, dws,
                 cws, xyz, refs)
        kernels.field_fused_edit(*eargs, dtype=low, **kw)
        assert seen.pop() == kernels.tile_smem_plan(
            "field_fused_edit", *eargs, dtype=low, **kw)["bytes"], (C, B, S)
        rays = torch.rand(B * S, 3, device="cuda")
        d = torch.rand(B * S, device="cuda")
        sargs = (rays, rays, d, d, d, d, geo, feat[..., :32], 0.1, dws)
        skw = dict(multires_d=kw["multires_d"], multires_fg=kw["multires_fg"],
                   geometry_dim=32, dtype=low)
        kernels.secant_refine(*sargs, **skw)
        assert seen.pop() == kernels.tile_smem_plan(
            "secant_refine", *sargs, **skw)["bytes"], (C, B, S)


# each warpgroup's epilogue writes a layer's outputs over the inputs that
# the other warpgroups' products read: at the flagship width with the
# selective-f32 layers (d0 reads f32 rows and writes a bf16 tile over the
# same bytes) and several tiles a persistent block, a missing barrier
# shows as launches that differ, where a 97% share against the plain
# version could still pass
@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("want", ["density", "density_nabla", "full"])
def test_field_fused_layers_in_place_at_many_tiles_a_block_on_card(want,
                                                                   seed):
    """bf16 with f32 d0, dh, c0, ch at W = 256 on 4 x SMs + 3 tiles (S =
    64): three launches bit-equal, and against the plain version."""
    _need_card()
    inp = random_context(seed=100 + seed, B=4 * _sm_count() + 3, S=64, C=96,
                         **WIDE)
    runs = [[o.cpu().numpy() for o in
             torch_field(inp, want, 8, "bf16", SEL_F32, device="cuda")]
            for _ in range(3)]
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            np.testing.assert_array_equal(a, b)
    ref = [o.cpu().numpy() for o in
           torch_field(inp, want, 8, "bf16", SEL_F32, device="cuda",
                       plain=True)]
    assert_field_close(runs[0], ref, no_tie_mask(inp["xyz"], inp["geo"]),
                       want, "bf16")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("frozen", [False, True])
def test_secant_refine_layers_in_place_at_many_tiles_a_block_on_card(
        frozen, seed):
    """The re-bracketing secant, bf16 with f32 d0 and dh at W = 256 on 4 x
    SMs + 3 ray blocks: three launches bit-equal, and against the plain
    version."""
    _need_card()
    B = 4 * _sm_count() + 3
    inp = random_context(seed=110 + seed, B=B, C=96, **WIDE)
    br = brackets(120 + seed, B * 64)
    runs = [torch_secant(inp, br, True, frozen, "bf16", "cuda",
                         tags=SEL_F32).cpu().numpy() for _ in range(3)]
    for other in runs[1:]:
        np.testing.assert_array_equal(runs[0], other)
    ref = torch_secant(inp, br, True, frozen, "bf16", "cuda", plain=True,
                       tags=SEL_F32)
    assert_roots_close(runs[0], ref.cpu().numpy(), "bf16")


# ---------------------------------------------------------------------------
# the frame entries against the assembly they replaced
# ---------------------------------------------------------------------------

def numpy_assembled_frame(model, kind, c2w, K, H, W, block, *, device,
                          ray_tile=128, rayschunk=0, N_steps=128,
                          N_secant_steps=8, scan_mode="density", **kw):
    """One frame assembled as the frame entries once did it: raster rays
    gathered by block_order_indices' numpy perm (tables copied to the
    device), the chunks rendered, their rows gathered back by its inv.
    kind "surface" (render_surface_image's knobs) or "volume"
    (render_image's). Returns {name: (H, W, ...)}."""
    from neumesh_tpu_torch.ops.rays import block_order_indices, get_rays
    from neumesh_tpu_torch.render.ray_casting import surface_render
    from neumesh_tpu_torch.render.volume import volume_render
    c2w = torch.as_tensor(np.asarray(c2w, np.float32), device=device)
    K = torch.as_tensor(np.asarray(K, np.float32), device=device)
    rays_o, rays_d = get_rays(c2w, K, H, W)
    perm, inv = block_order_indices(H, W, *block)
    perm = torch.as_tensor(perm, device=device)
    inv = torch.as_tensor(inv, device=device)
    ro, rd = rays_o[perm], rays_d[perm]
    n = H * W
    if kind == "volume":
        # chunks of whole tiles, as the entries round them
        q = max(ray_tile, 1)
        _, _, ret = volume_render(model, ro, rd, device=device,
                                  ray_tile=ray_tile,
                                  rayschunk=-(-rayschunk // q) * q, **kw)
        return {k: v[inv].reshape(H, W, *v.shape[1:])
                for k, v in ret.items()}
    chunk = -(-(rayschunk or n) // ray_tile) * ray_tile
    pad = (-n) % chunk
    if pad:
        ro = torch.cat([ro, ro[-1:].expand(pad, 3)], 0)
        rd = torch.cat([rd, rd[-1:].expand(pad, 3)], 0)
    cfgs = {"N_steps": N_steps, "N_secant_steps": N_secant_steps,
            "fill_inf": False}
    outs = [surface_render(model, ro[i:i + chunk], rd[i:i + chunk],
                           calc_normal=True, ray_tile=ray_tile,
                           scan_mode=scan_mode, ray_casting_cfgs=cfgs,
                           device=device, **kw)
            for i in range(0, n + pad, chunk)]

    def frame(parts):
        return torch.cat(parts, 0)[:n][inv].reshape(H, W,
                                                     *parts[0].shape[1:])

    got = {"rgb": frame([o[0] for o in outs]),
           "depth": frame([o[1] for o in outs])}
    for k in ("normals_surface", "mask_surface"):
        got[k] = frame([o[2][k] for o in outs])
    return got


def entry_frame(model, kind, c2w, K, H, W, block, *, device, **kw):
    """The same frame through render_surface_image or render_image ->
    {name: (H, W, ...)}."""
    from neumesh_tpu_torch.render.ray_casting import render_surface_image
    from neumesh_tpu_torch.render.volume import render_image
    if kind == "volume":
        _, _, ret = render_image(model, c2w, K, H, W, block=block,
                                 device=device, **kw)
        return ret
    rgb, depth, extras = render_surface_image(model, c2w, K, H, W,
                                              device=device, **kw)
    return {"rgb": rgb, "depth": depth, **extras}


def assert_frames_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k


# the serving knobs of the surface preview (800 x 600, every layer in bf16)
# and of the f32 quality render (400 x 300, two chunks), at the flagship
# widths on a 163,842-vertex icosphere
CARD_FRAMES = {
    "surface": (600, 800, (8, 16), dict(
        compute_dtype=torch.bfloat16, f32_layers=()), dict(
        ray_tile=128, tile_max_candidates=128, scan_mode="distance",
        N_steps=16, N_secant_steps=3, rayschunk=0,
        obj_bounding_radius=1.0)),
    "volume": (300, 400, (4, 16), dict(compute_dtype=None), dict(
        ray_tile=128, tile_max_candidates=128, N_samples=64,
        N_importance=64, N_upsample_iters=4, reuse_upsample_sdf=True,
        detailed_output=False, rayschunk=60032, obj_bounding_radius=1.0)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(CARD_FRAMES))
def test_frame_entry_matches_the_numpy_assembly_on_card(kind):
    """Rays built in block order on the device and rows restored by a view:
    the frame bit-equal to the one assembled by numpy tables and gathers."""
    _need_card()
    from neumesh_tpu_torch.dataio.synthetic import icosphere_mesh
    from neumesh_tpu_torch.mesh.grid import MeshGrid
    from neumesh_tpu_torch.models.neumesh.model import NeuMesh
    H, W, block, prec, kw = CARD_FRAMES[kind]
    model = NeuMesh(MeshGrid(icosphere_mesh(0.5, 7), device="cuda"),
                    device="cuda", use_pallas=True, D_density=3, D_color=4,
                    W=256, geometry_dim=32, color_dim=32, multires_d=8,
                    multires_fg=2, multires_ft=2, multires_view=4,
                    enable_nablas_input=True, learn_indicator_weight=True,
                    speed_factor=10.0, tile_kp_per_probe=8,
                    tile_cell_budget=64, scan_knn_k=1, **prec).init(0)
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = -2.5
    f = 1446.0 * W / 800
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    want = numpy_assembled_frame(model, kind, c2w, K, H, W, block,
                                 device="cuda", **kw)
    got = entry_frame(model, kind, c2w, K, H, W, block, device="cuda", **kw)
    assert_frames_equal(got, want)
    if kind == "surface":
        assert 0.1 < float(got["mask_surface"].float().mean()) < 0.9


# ---------------------------------------------------------------------------
# candidate_bounds: the tile contexts' near/far
# ---------------------------------------------------------------------------

def bounds_inputs(seed=0, Rt=64, T=128, C=128):
    """Torch CPU inputs of candidate_bounds: Rt tiles of T rays from about
    (0, 0, -2.5) toward a patch of the 0.5-sphere, the tile's C candidates
    on that patch. A tenth of the candidates, and all of the last tile's,
    are the 1e9 sentinel vertex; a sixth of the rays aim elsewhere (nothing
    covers most of them), a sixth have a narrow input [near, far] around
    their hit (clamped to it, then widened), a sixth a far just past their
    hit (clamped to it), the rest [1, 4]."""
    rng = np.random.default_rng(seed)

    def on_sphere(x):
        return 0.5 * x / np.linalg.norm(x, axis=-1, keepdims=True)
    centre = on_sphere(rng.normal(size=(Rt, 1, 3)) * 0.3
                       + np.array([0.0, 0.0, -1.0]))
    pts = on_sphere(centre + rng.normal(size=(Rt, C, 3)) * 0.08)
    pts[rng.random((Rt, C)) < 0.1] = 1e9
    pts[-1] = 1e9
    o = (np.array([0.0, 0.0, -2.5]) + rng.normal(size=(Rt, 1, 3)) * 0.05
         + rng.normal(size=(Rt, T, 3)) * 0.01)
    target = centre + rng.normal(size=(Rt, T, 3)) * 0.08
    kind = rng.integers(0, 6, (Rt, T))
    target[kind == 0] = rng.normal(size=(int((kind == 0).sum()), 3)) * 3.0
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    near = 1.0 + rng.uniform(0.0, 0.2, (Rt, T))
    far = 4.0 + rng.uniform(0.0, 0.2, (Rt, T))
    hit = np.linalg.norm(target - o, axis=-1)
    narrow = kind == 1
    near[narrow] = hit[narrow] - 0.01
    far[narrow] = hit[narrow] + 0.03
    short = kind == 2
    far[short] = hit[short] + 0.02

    def t(x, *shape):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)
                                .reshape(shape))
    R = Rt * T
    return (t(o, R, 3), t(d, R, 3), t(near, R, 1), t(far, R, 1),
            t(pts, Rt, C, 3))


def bounds_cases(inp, got, tile):
    """How many rays of bounds_inputs no candidate covers, how many end
    clamped to an input bound, and how many the 'too close' rule widens."""
    o, d, near, far, pts = inp
    Rt = pts.shape[0]
    ov = pts[:, None].double() - o.reshape(Rt, tile, 1, 3).double()
    tc = (ov * d.reshape(Rt, tile, 1, 3).double()).sum(-1)
    covered = ((ov * ov).sum(-1) - tc * tc < 0.01).any(-1).reshape(-1, 1)
    widened = got[0] < near
    clamped = covered & ~widened & ((got[0] == near) | (got[1] == far))
    return {"uncovered": int((~covered).sum()),
            "clamped": int(clamped.sum()), "widened": int(widened.sum())}


def test_bounds_inputs_cover_every_case():
    """bounds_inputs, as the card tests use it, holds sentinels, rays
    nothing covers, rays clamped to their input bounds and rays the 'too
    close' rule widens."""
    for C in (128, 100):
        inp = bounds_inputs(seed=C, C=C)
        got = kernels.candidate_bounds_plain(*inp, 128)
        assert (inp[4] == 1e9).any() and torch.isfinite(got[0]).all()
        cases = bounds_cases(inp, got, 128)
        assert min(cases.values()) > 200, cases


def test_candidate_bounds_wrapper_takes_the_plain_version_on_cpu():
    inp = bounds_inputs(seed=3, Rt=4, T=16, C=40)
    kernels.reset_launch_counts()
    got = kernels.candidate_bounds(*inp, 16)
    want = kernels.candidate_bounds_plain(*inp, 16)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert got[0].shape == (64, 1) and got[1].shape == (64, 1)
    assert all(v == 0 for modes in kernels.LAUNCHES.values()
               for v in modes.values())


def bounds_model(device, use_pallas):
    from neumesh_tpu_torch.dataio.synthetic import icosphere_mesh
    from neumesh_tpu_torch.mesh.grid import MeshGrid
    from neumesh_tpu_torch.models.neumesh.model import NeuMesh
    return NeuMesh(MeshGrid(icosphere_mesh(0.5, 3), device=device),
                   device=device, use_pallas=use_pallas, D_density=2,
                   D_color=2, W=16, geometry_dim=4, color_dim=4, multires_d=2,
                   multires_fg=1, multires_ft=1, multires_view=1,
                   tile_kp_per_probe=8, tile_cell_budget=64).init(0)


def bind_and_bound(model, tile=16):
    """bind_rays_tiled over 8 tiles of rays at the sphere -> (launches of
    candidate_bounds, its near/far, the plain version's near/far on the
    binding's context)."""
    o, d, near, far, _ = bounds_inputs(seed=9, Rt=8, T=tile, C=8)
    dev = model.mesh_grid.device
    o, d, near, far = (x.to(dev) for x in (o, d, near, far))
    kernels.reset_launch_counts()
    tb, n, f = model.bind_rays_tiled(o, d, near, far, tile)
    launched = dict(kernels.LAUNCHES["candidate_bounds"])
    want = kernels.candidate_bounds_plain(o, d, near, far, tb.ctx["pts"],
                                          tile)
    return launched, (n, f), want


@pytest.mark.parametrize("use_pallas", [True, False])
def test_bind_rays_tiled_takes_the_plain_bounds_on_cpu(use_pallas):
    """On the CPU, with use_pallas on or off, the tile bounds are the plain
    version's and the kernel is never counted."""
    launched, got, want = bind_and_bound(bounds_model("cpu", use_pallas))
    assert launched == {"tiled": 0}
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (got[1] > got[0]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("Rt,T,C", [(64, 128, 128), (64, 128, 100),
                                    (64, 100, 300), (64, 256, 64),
                                    (3750, 128, 128)])
def test_candidate_bounds_kernel_matches_plain_on_card(Rt, T, C):
    """The kernel's near/far bit-equal to the plain version's on the card,
    a launch counted a call. T = 100 leaves a block ragged, 256 takes two
    blocks a tile, C = 300 two staged slices; 3,750 tiles of 128 rays and
    128 candidates are the 800 x 600 surface frame's, where the plain
    version's sums over the 3-vector run at their largest size."""
    _need_card()
    inp = [x.cuda() for x in bounds_inputs(seed=T + C, Rt=Rt, T=T, C=C)]
    want = kernels.candidate_bounds_plain(*inp, T)
    kernels.reset_launch_counts()
    for call in (1, 2):
        got = kernels.candidate_bounds(*inp, T)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["candidate_bounds"]["tiled"] == call
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    cases = bounds_cases(inp, got, T)
    assert min(cases.values()) > 0, cases


@pytest.mark.cuda
@pytest.mark.parametrize("use_pallas", [True, False])
def test_bind_rays_tiled_routes_the_bounds_on_card(use_pallas):
    """On the card the binding launches candidate_bounds once with
    use_pallas, never without, and its near/far are the plain version's
    either way."""
    _need_card()
    launched, got, want = bind_and_bound(bounds_model("cuda", use_pallas))
    assert launched == {"tiled": int(use_pallas)}
    assert all(torch.equal(a, b) for a, b in zip(got, want))
