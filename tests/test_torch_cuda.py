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


# ---------------------------------------------------------------------------
# inputs (numpy, from a seed)
# ---------------------------------------------------------------------------

def random_context(seed=0, B=3, S=75, C=70, gd=8, cd=8, W=32, md=4, mfg=1,
                   mft=1, mv=2):
    """Numpy inputs of the field kernels: samples near a random (8, C)
    candidate context per tile (C and S deliberately not multiples of any
    block), features, and density / colour weight lists in the field
    kernels' layout."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(B, C, 3))
    pts = 0.5 * pts / np.linalg.norm(pts, axis=-1, keepdims=True)
    ind = rng.normal(size=(B, C, 3))
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


def low_precision_mask(ws, dtype, keep_f32=()):
    """Per weight: True where the matrix goes to `dtype` (never the (1, N)
    biases, never the positions in keep_f32; all False for f32)."""
    return [dtype is not None and w.shape[0] > 1 and i not in keep_f32
            for i, w in enumerate(ws)]


def kept_f32(tags, first, head):
    """Weight positions a selective-f32 tag set keeps in f32."""
    keep = set()
    if "d0" in tags or "c0" in tags:
        keep |= set(first)
    if "dh" in tags or "ch" in tags:
        keep |= {head}
    return keep


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
        low = low_precision_mask(lst, dtype, kept_f32(tags, first, head))
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
                 plain=False):
    """secant_refine (or its plain version) on `inp`/`br` as tensors."""
    def t(a):
        return torch.from_numpy(a).to(device)

    gd = inp["kw"]["geometry_dim"]
    low = low_precision_mask(inp["dws"], dtype)
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
    assert desc.n == 4 and ldx % 4 == 0
    assert ldx >= kernels._align4(17) + 16
    cdesc, cldx = kernels._mlp_desc(kernels._col_layers(cws, 8, 4, 2), keep)
    nh = 3 + 9 + 3 + 12 + 8
    assert cdesc.l[0].split == nh and cdesc.l[0].bf16 == 1
    assert cdesc.l[0].K == nh + 16 and cldx >= kernels._align4(nh) + 16
    assert cdesc.n == len(cws) // 2 <= _build.MAX_LAYERS


# ---------------------------------------------------------------------------
# on the card: CUDA kernel against the plain version
# ---------------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("want,k,dtype,tags", FIELD_CASES)
def test_field_fused_kernel_matches_plain_on_card(want, k, dtype, tags):
    _need_card()
    inp = random_context(seed=6, B=8, S=300, C=128)
    mask = no_tie_mask(inp["xyz"], inp["geo"], k=k)
    kernels.reset_launch_counts()
    got = [o.cpu().numpy() for o in
           torch_field(inp, want, k, dtype, tags, device="cuda")]
    assert kernels.LAUNCHES["field_fused"][want] == 1
    ref = [o.cpu().numpy() for o in
           torch_field(inp, want, k, dtype, tags, device="cuda", plain=True)]
    assert_field_close(got, ref, mask, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("rebracket,frozen,dtype", SECANT_CASES)
def test_secant_refine_kernel_matches_plain_on_card(rebracket, frozen,
                                                    dtype):
    _need_card()
    inp = random_context(seed=9, B=8, C=128)
    br = brackets(10, 8 * 100)
    kernels.reset_launch_counts()
    got = torch_secant(inp, br, rebracket, frozen, dtype, "cuda")
    assert kernels.LAUNCHES["secant_refine"][
        kernels.secant_mode(rebracket, frozen)] == 1
    ref = torch_secant(inp, br, rebracket, frozen, dtype, "cuda", plain=True)
    assert_roots_close(got.cpu().numpy(), ref.cpu().numpy(), dtype)
