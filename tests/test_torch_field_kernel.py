"""field_fused: the port's plain version against the JAX Pallas kernel
(interpret mode), every mode in f32 and bf16 (and bf16 with the
selective-f32 layers once); the kernel's f32 layers (three bf16 weight
planes, the six-product split) emulated on the CPU against exact f32. The
CUDA kernel is held against the plain version on a card in
test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neumesh_tpu.ops.pallas_kernels import field_fused as jax_field
from neumesh_tpu_torch.ops import kernels
from test_torch_cuda import (FIELD_CASES, FLAGSHIP_PRECISIONS, WIDE,
                             assert_distance_close, assert_field_close,
                             distance_context, flagship_weights, kept_f32,
                             low_precision_mask, no_tie_mask, random_context,
                             torch_distance, torch_field)


def _jax_field(inp, want, k, dtype, tags):
    def ws(lst, first, head):
        low = low_precision_mask(lst, dtype, kept_f32(tags, first, head),
                                 len(first))
        return [jnp.asarray(w).astype(jnp.bfloat16) if lo else jnp.asarray(w)
                for w, lo in zip(lst, low)]

    F = inp["feat"].shape[-1] if want == "full" else inp["kw"]["geometry_dim"]
    dws = ws(inp["dws"], (0, 1), len(inp["dws"]) - 2)
    cws = ws(inp["cws"], (0,), len(inp["cws"]) - 2)
    return [np.asarray(o) for o in jax_field(
        jnp.asarray(inp["xyz"]), jnp.asarray(inp["geo"]),
        jnp.asarray(inp["feat"][..., :F]), inp["w1"],
        dws if want != "distance" else (), cws if want == "full" else None,
        jnp.asarray(inp["dirs"]) if want == "full" else None, k=k,
        want=want, dtype=None if dtype is None else jnp.bfloat16,
        interpret=True, **inp["kw"])]


@pytest.mark.parametrize("want,k,dtype,tags", FIELD_CASES)
def test_field_fused_plain_matches_pallas(want, k, dtype, tags):
    inp = random_context(seed=4)
    mask = no_tie_mask(inp["xyz"], inp["geo"], k=k)
    assert mask.mean() > 0.9
    got = [o.numpy() for o in torch_field(inp, want, k, dtype, tags)]
    ref = _jax_field(inp, want, k, dtype, tags)
    assert len(got) == len(ref) == {"distance": 1, "density": 1,
                                    "density_nabla": 4, "full": 7}[want]
    assert all(g.shape == (3, 75) for g in got)
    assert_field_close(got, ref, mask, want, dtype)


@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("kind", ["ties", "pads"])
def test_field_distance_plain_matches_pallas_at_ties_and_pads(kind, k):
    """want="distance" at the scan's edges (distance_context): duplicate
    vertices with samples on one (exact ties at d2 = 0: k = 1 sums every
    tied candidate, k = 8 takes both as one distinct value), pad columns
    (pp = 1e12), 1e9 sentinels and a context with 3 live candidates (k =
    8 picks pads): the port's plain version against the JAX kernel in
    interpret mode, 2e-5 + 1e-4 rel on the held samples (with every
    sample on a vertex)."""
    inp = distance_context(kind, seed=70 + k)
    held = inp["held"]
    assert held.mean() > 0.8 and (kind == "pads" or held[:, :2].all())
    got = torch_distance(inp, k)
    ref = _jax_field(inp, "distance", k, None, ())[0]
    assert got.shape == ref.shape == (5, 40)
    assert_distance_close(got, ref, held)
    if kind == "pads" and k == 8:
        # context 0 holds 3 live candidates: its samples lean on the pads
        assert np.abs(got[0]).min() > 100.0 * np.abs(got[1:]).max()


@pytest.mark.parametrize("k", [1, 8, 16])
def test_distance_block_plan_covers_every_sample_once(k):
    """kernels.distance_block_plan (field_distance.cu's blocks) over a
    sweep of B, S and C: every (context, row) computed by exactly one live
    slot; a block spans at most its planned contexts; one context a block
    from 128 samples a context; 128 samples a staged block; from L2, 16
    (8 threads each) at k = 1, else 32."""
    from neumesh_tpu_torch.ops._build import DIST_SMEM, DT, DT_L2
    for B in (1, 2, 7, 509):
        for S in (1, 2, 16, 37, 63, 64, 65, 127, 128, 129, 300, 511, 512,
                  513, 1024, 2048, 2049):
            for C in (8, 96, 4000):
                ctx, row, live, staged = kernels.distance_block_plan(
                    B, S, C, k)
                flat = (ctx * S + row)[live]
                assert torch.equal(torch.sort(flat).values,
                                   torch.arange(B * S)), (B, S, C)
                assert bool((row[live] < S).all())
                span = ctx.max(1).values - ctx.min(1).values + 1
                if S >= DT:
                    assert bool((span == 1).all())
                else:
                    assert int(span.max()) <= 1 + (DT - 1 + S - 1) // S
                # staged: the contexts a block spans fit its shared memory
                # (C padded to whole 32-candidate words)
                cp = -(-C // 32) * 32
                fits = (int(span.max()) * 32 + 4) * cp <= DIST_SMEM
                assert fits if staged else not (S >= DT and fits)
                rows = DT if staged else DT // 8 if k == 1 else DT_L2
                assert ctx.shape[1] % rows == 0
    # the render CLI's shapes: S = 1 reads its contexts from L2, S = 16 and
    # one context a block stage them
    assert [kernels.distance_block_plan(4096, S, 96, k)[3]
            for S in (1, 16, 128)] == [False, True, True]


def unpack_planes(packed, kp, P, rows):
    """pack_layer's P planes, each the (kp, NPAD) zero-padded weight, back
    from its slices of `rows` K rows (the P planes of a slice one after
    the other)."""
    from neumesh_tpu_torch.ops._build import NPAD
    planes, off = [[] for _ in range(P)], 0
    for k0 in range(0, kp, rows):
        ks = min(rows, kp - k0)
        for p in range(P):
            blk = packed[off:off + ks * NPAD].reshape(NPAD // 8, ks // 8, 8, 8)
            planes[p].append(blk.permute(0, 2, 1, 3).reshape(NPAD, ks).t())
            off += ks * NPAD
    assert off == packed.numel()
    return [torch.cat(p) for p in planes]


def split_dot(orig):
    """_dot with the kernel's f32 layers: the six products hi.hi, mid.hi,
    lo.hi, hi.mid, mid.mid, hi.lo of both operands' split_planes (exact
    products of bf16 values, f32 sums); the heads (N <= 3) stay exact f32,
    as on the card's CUDA cores."""
    def dot(a, w):
        if w.dtype != torch.float32 or w.shape[-1] <= 3:
            return orig(a, w)
        A = kernels.split_planes(a.to(torch.float32))
        W = kernels.split_planes(w)
        out = None
        for i, j in ((0, 0), (1, 0), (2, 0), (0, 1), (1, 1), (0, 2)):
            p = A[i].to(torch.float32) @ W[j].to(torch.float32)
            out = p if out is None else out + p
        return out
    return dot


def test_f32_layers_pack_as_three_planes_that_sum_to_the_weight():
    """Every f32 hidden layer of the flagship density and colour MLPs
    packs as three bf16 planes hi = bf16(w), mid, lo, in slices of 16 K
    rows, whose sum is the zero-padded f32 weight bit for bit (in f32 and
    in f64), each row block at a multiple of 16 rows."""
    from neumesh_tpu_torch.ops._build import KSF, NPAD
    inp = random_context(seed=3, **WIDE)
    gd = inp["kw"]["geometry_dim"]
    dws = [torch.from_numpy(w) for w in inp["dws"]]
    cws = [torch.from_numpy(w) for w in inp["cws"]]
    kw = inp["kw"]
    for layers in (kernels._dens_layers(dws, gd),
                   kernels._col_layers(cws, inp["feat"].shape[-1] - gd,
                                       kw["multires_d"],
                                       kw["multires_view"])):
        for w, _, split in layers[:-1]:
            packed, kp1, kp = kernels.pack_layer(w, split)
            assert packed.dtype == torch.bfloat16
            assert packed.numel() == 3 * kp * NPAD and kp % 16 == 0
            hi, mid, lo = unpack_planes(packed, kp, 3, KSF)
            K, N = w.shape
            full = torch.zeros((kp, NPAD), dtype=torch.float32)
            blocks = [(0, 0, split), (kp1, split, K)] if split else [(0, 0, K)]
            for dst, a, b in blocks:
                full[dst:dst + b - a, :N] = w[a:b]
            assert torch.equal(hi, full.to(torch.bfloat16))
            f32 = (hi.float() + mid.float()) + lo.float()
            f64 = hi.double() + mid.double() + lo.double()
            assert torch.equal(f32, full) and torch.equal(f64, full.double())
            assert (mid.float().abs() <= hi.float().abs() * 2 ** -8).all()


@pytest.mark.parametrize("want", ["density", "density_nabla", "full"])
def test_split_f32_layers_meet_the_f32_tolerances(want, monkeypatch):
    """The kernel's f32 design emulated on the CPU: every f32 hidden layer
    of the flagship MLPs (W = 256, seeded weights, the real embeddings)
    as the six-product bf16 split, through field_fused's plain version,
    against exact f32: sdf and rgb within 2e-5 + 1e-4 rel, nabla (the
    tangent through every layer) within 1e-4 + 1e-4 rel, on every
    sample."""
    inp = random_context(seed=12, **WIDE)
    exact = torch_field(inp, want, 8, None, (), plain=True)
    monkeypatch.setattr(kernels, "_dot", split_dot(kernels._dot))
    got = torch_field(inp, want, 8, None, (), plain=True)
    assert any(not torch.equal(g, e) for g, e in zip(got, exact))
    every = np.ones(inp["xyz"].shape[:2], bool)
    assert_field_close([g.numpy() for g in got], [e.numpy() for e in exact],
                       every, want, None)


def _ulps(a, b):
    """|a - b| in units in the last place of float32 (ordered bit
    patterns: 0 and -0 one value)."""
    ia, ib = a.view(torch.int32).long(), b.view(torch.int32).long()
    ia = torch.where(ia < 0, -2 ** 31 - ia, ia)
    ib = torch.where(ib < 0, -2 ** 31 - ib, ib)
    return (ia - ib).abs()


def _softplus_grid():
    """A dense float32 grid over 100 x in [-300, 300] (both branches of
    the threshold at 100 x = 20, exp(-100 x) overflowing below -88.7) and
    log-spaced magnitudes from 1e-8 to 1e2 of either sign."""
    mags = torch.logspace(-8, 2, 20001)
    return torch.cat([torch.linspace(-3, 3, 1200001), mags, -mags,
                      torch.tensor([0.0, 0.2, -0.2, 0.19999999])])


def test_one_exponential_softplus_matches_softplus100():
    """kernels.softplus100_pair (the tile kernels' exact epilogue: softplus
    and its derivative from one exp(-|100 x|)) against nn.softplus100 /
    softplus100_grad: the value bit for bit; the derivative within 3 ulp
    of sigmoid's 1 / (1 + exp(-100 x)) and within 2 ulp of the float64
    value (at the float32 100 x) where that is a normal float32, as
    accurate as sigmoid itself
    (which errs by up to 2 ulp there: the two forms round differently,
    so no form with one exponential agrees with it to 1 ulp everywhere);
    0 where sigmoid's exponential overflows."""
    from neumesh_tpu_torch.nn import softplus100, softplus100_grad
    x = _softplus_grid()
    h, g = kernels.softplus100_pair(x)
    assert torch.equal(h, softplus100(x))
    ref = softplus100_grad(x)
    assert int(_ulps(g, ref).max()) <= 3
    # the float64 derivative at the float32 product 100 x both forms take
    bx = 100.0 * x
    truth = torch.where(bx > 20.0, torch.ones_like(x),
                        torch.sigmoid(bx.double()).float())
    normal = truth.abs() >= torch.finfo(torch.float32).tiny
    assert int(_ulps(g, truth)[normal].max()) <= \
        int(_ulps(ref, truth)[normal].max()) <= 2
    over = 100.0 * x < -88.8
    assert bool(over.any()) and bool((g[over] == 0).all())
    assert bool((g[100.0 * x > 20.0] == 1).all())


def test_bf16_epilogue_form_is_within_its_rounding():
    """kernels.softplus100_bf16_form (the algebra of the epilogue whose
    output is rounded to bf16 next: the series for log1p below e = 2^-7,
    the product 0.01, e r) against the float64 softplus100 and its
    derivative: relative error below 2^-16, far under bf16's 2^-9."""
    from neumesh_tpu_torch.nn import softplus100, softplus100_grad
    x = _softplus_grid()
    h, g = kernels.softplus100_bf16_form(x)
    th, tg = softplus100(x.double()), softplus100_grad(x.double())
    for got, want in ((h, th), (g, tg)):
        held = want.abs() > 1e-30
        rel = (got.double() - want).abs()[held] / want.abs()[held]
        assert float(rel.max()) < 2.0 ** -16


@pytest.mark.parametrize("C", [1, 8, 70, 96, 128])
@pytest.mark.parametrize("want", ["density", "density_nabla", "full"])
@pytest.mark.parametrize("prec", list(FLAGSHIP_PRECISIONS))
def test_field_smem_plan_fits_at_flagship_width(prec, want, C):
    """kernels.tile_smem_plan (the mirror of field_fused.cu's shared-memory
    plan) at the flagship width for C <= 128 candidates, every mode, in
    bf16, selective-f32 and f32, at the A/B's tile shape and the render
    CLI's per-ray ones: every block within the 227 KB a block may use;
    warp-specialised with a weight ring of 2..8 slots, at least 3 in bf16
    at the tile shape."""
    dws, cws, kw = flagship_weights(prec)
    F = 64 if want == "full" else 32
    for B, S in ((512, 1024), (512, 512), (4096, 1), (4096, 16),
                 (4096, 127), (7, 37), (1, 65)):
        xyz = torch.zeros(B, S, 3)
        plan = kernels.tile_smem_plan(
            "field_fused", xyz, torch.zeros(B, 8, C), torch.zeros(B, C, F),
            0.1, dws, cws if want == "full" else None, xyz, want=want, **kw)
        assert plan["fits"] and plan["bytes"] <= 227 * 1024, (B, S, plan)
        assert plan["ws"]
        assert 2 <= plan["ring"] <= 8
        if prec == "bf16" and (B, S) == (512, 1024):
            assert plan["ring"] >= 3 and plan["staged"] == 1
