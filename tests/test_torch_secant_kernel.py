"""secant_refine: the port's plain version against the JAX Pallas kernel
(interpret mode) with the re-bracket and the frozen selection on and off,
f32 and bf16; the tile kernels' block plan (one context a block from 64
rays a context, else 64 consecutive rays of several) and the secant
through the emulated f32 split at one ray a context. The CUDA kernel is
held against the plain version on a card in test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neumesh_tpu.ops.pallas_kernels import secant_refine as jax_secant
from neumesh_tpu_torch.ops import kernels
from test_torch_cuda import (SECANT_CASES, WIDE, assert_roots_close,
                             brackets, low_precision_mask, random_context,
                             torch_secant)
from test_torch_field_kernel import split_dot


def _jax_secant(inp, br, rebracket, frozen, dtype):
    gd = inp["kw"]["geometry_dim"]
    low = low_precision_mask(inp["dws"], dtype)
    ws = [jnp.asarray(w).astype(jnp.bfloat16) if lo else jnp.asarray(w)
          for w, lo in zip(inp["dws"], low)]
    kw = dict(n_iters=3, multires_d=inp["kw"]["multires_d"],
              multires_fg=inp["kw"]["multires_fg"], geometry_dim=gd,
              frozen_knn=frozen)
    if rebracket:
        kw.update(d_low_w=jnp.asarray(br["d_low_w"]),
                  d_high_w=jnp.asarray(br["d_high_w"]))
    names = ["rays_o", "rays_d", "d_low", "d_high", "f_low", "f_high"]
    return np.asarray(jax_secant(
        *[jnp.asarray(br[n]) for n in names], jnp.asarray(inp["geo"]),
        jnp.asarray(inp["feat"][..., :gd]), inp["w1"], ws,
        dtype=None if dtype is None else jnp.bfloat16, interpret=True, **kw))


@pytest.mark.parametrize("rebracket,frozen,dtype", SECANT_CASES)
def test_secant_refine_plain_matches_pallas(rebracket, frozen, dtype):
    inp = random_context(seed=7, B=3, C=70)
    br = brackets(8, 3 * 24)
    got = torch_secant(inp, br, rebracket, frozen, dtype).numpy()
    ref = _jax_secant(inp, br, rebracket, frozen, dtype)
    assert got.shape == (72,)
    # the refinement moved the roots off the initial bracket
    assert np.abs(got - br["d_low"]).max() > 1e-3
    assert_roots_close(got, ref, dtype)


@pytest.mark.parametrize("R", [1, 16, 37, 63, 64, 65, 127])
def test_block_plan_maps_every_row_to_one_block_row(R):
    """block_plan (the Python mirror of the kernels' TileRows) at B
    contexts no multiple of 64 / R: every (context, row) at exactly one
    live block row, in flat order; below 64 rows a context the blocks cut
    the flat order (ceil(B R / 64) blocks, the ragged rows at the end of
    the last, at most 1 + ceil(63 / R) consecutive contexts a block), from
    64 one context a block (ceil(R / 64) a context, each context's last
    block ragged); a ragged row sits in its block's first context."""
    B = 3 * max(64 // R, 1) + 1
    ctx, row, live = kernels.block_plan(B, R)
    flat = ctx * R + row
    assert torch.equal(flat[live], torch.arange(B * R))
    n_ctx = torch.tensor([len(set(c[m].tolist())) for c, m in zip(ctx, live)])
    if R < 64:
        assert ctx.shape[0] == -(-B * R // 64)
        assert live.reshape(-1).tolist() == [True] * (B * R) + \
            [False] * (ctx.numel() - B * R)
        assert n_ctx.max() <= 1 + -(-63 // R) and n_ctx.max() > 1
        first, last = ctx[:, 0], ctx.masked_fill(~live, -1).max(1).values
        assert torch.equal(last - first + 1, n_ctx)
    else:
        nblk = -(-R // 64)
        assert ctx.shape[0] == B * nblk and (n_ctx == 1).all()
        assert (live.sum(1).reshape(B, nblk)[:, :-1] == 64).all()
    first = ctx[:, :1].expand_as(ctx)
    assert torch.equal(ctx[~live], first[~live]) and (row[~live] == 0).all()


@pytest.mark.parametrize("rebracket,frozen", [(True, False), (False, False),
                                              (False, True)])
def test_secant_through_split_f32_layers_at_one_ray_a_context(
        rebracket, frozen, monkeypatch):
    """The render CLI's per-ray surface secant (one ray a context, W =
    256): the plain version with the kernel's f32 layers emulated (the
    six-product bf16 split, heads exact) against exact f32, at the f32
    root tolerance (2e-5 + 1e-4 rel on >= 99% of rays)."""
    inp = random_context(seed=13, B=48, S=1, C=70, **WIDE)
    br = brackets(14, 48)
    exact = torch_secant(inp, br, rebracket, frozen, None, plain=True)
    monkeypatch.setattr(kernels, "_dot", split_dot(kernels._dot))
    got = torch_secant(inp, br, rebracket, frozen, None, plain=True)
    assert not torch.equal(got, exact)
    assert_roots_close(got.numpy(), exact.numpy(), None)
