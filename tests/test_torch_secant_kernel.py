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
                             brackets, flagship_weights, low_precision_mask,
                             random_context, torch_secant)
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


@pytest.mark.parametrize("sms", [7, 132, 100_000])
@pytest.mark.parametrize("R", [1, 16, 37, 64, 65, 1024])
def test_persistent_schedule_covers_every_row_once(R, sms):
    """kernels.persistent_schedule (the warp-specialised kernels' grid of
    min(tiles, SMs) blocks, block b taking tiles b, b + grid, ...) with
    block_plan's rows, for B in {1, 7, 509, 512} contexts of R rows (S or
    T) and grids smaller and larger than the SM count: every (context,
    row) computed once by one live row of one tile of one block; every
    block takes at least one tile, the loads of two blocks differ by at
    most one tile."""
    for B in (1, 7, 509, 512):
        ctx, row, live = kernels.block_plan(B, R)
        sched = kernels.persistent_schedule(B, R, sms)
        n = kernels.tile_blocks(B, R)
        assert n == ctx.shape[0]
        assert len(sched) == min(n, sms)
        tiles = [t for blk in sched for t in blk]
        assert sorted(tiles) == list(range(n))
        sizes = [len(blk) for blk in sched]
        assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
        order = torch.tensor(tiles)
        flat = (ctx[order] * R + row[order])[live[order]]
        assert torch.equal(torch.sort(flat).values, torch.arange(B * R))


@pytest.mark.parametrize("C", [1, 8, 70, 96, 128])
@pytest.mark.parametrize("prec", ["f32", "bf16", "bf16_sel_f32"])
def test_secant_smem_plan_fits_at_flagship_width(prec, C):
    """kernels.tile_smem_plan for secant_refine at the flagship width, C
    <= 128, in bf16, selective-f32 and f32, with and without the frozen
    selection (whose picks only its instantiations carve), at the serving
    shape (128 rays a tile) and the per-ray ones (T = 1, 16, 37, 63):
    within 227 KB; warp-specialised (every instantiation but f32 layers
    without the frozen selection) with a ring of 2..8 slots, at least 3 in
    bf16, else the two slots of the serial block."""
    dws, _, kw = flagship_weights(prec)
    for frozen in (False, True):
        for B, T in ((512, 128), (4096, 1), (4096, 16), (64, 37), (3, 63)):
            rays = torch.zeros(B * T, 3)
            d = torch.zeros(B * T)
            plan = kernels.tile_smem_plan(
                "secant_refine", rays, rays, d, d, d, d,
                torch.zeros(B, 8, C), torch.zeros(B, C, 32), 0.1, dws,
                multires_d=kw["multires_d"], multires_fg=kw["multires_fg"],
                geometry_dim=32, frozen_knn=frozen)
            assert plan["fits"] and plan["bytes"] <= 227 * 1024, \
                (B, T, plan)
            assert plan["ws"] == (frozen or prec == "bf16")
            assert (2 <= plan["ring"] <= 8 if plan["ws"]
                    else plan["ring"] == 2)
            if prec == "bf16":
                assert plan["ring"] >= 3
