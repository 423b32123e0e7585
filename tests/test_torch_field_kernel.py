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
from test_torch_cuda import (FIELD_CASES, WIDE, assert_field_close, kept_f32,
                             low_precision_mask, no_tie_mask, random_context,
                             torch_field)


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
