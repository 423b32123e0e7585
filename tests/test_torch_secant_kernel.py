"""secant_refine: the port's plain version against the JAX Pallas kernel
(interpret mode) with the re-bracket and the frozen selection on and off,
f32 and bf16. The CUDA kernel is held against the plain version on a card
in test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest

from neumesh_tpu.ops.pallas_kernels import secant_refine as jax_secant
from test_torch_cuda import (SECANT_CASES, assert_roots_close, brackets,
                             low_precision_mask, random_context, torch_secant)


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
