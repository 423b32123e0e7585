"""field_fused: the port's plain version against the JAX Pallas kernel
(interpret mode), every mode in f32 and bf16 (and bf16 with the
selective-f32 layers once). The CUDA kernel is held against the plain
version on a card in test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest

from neumesh_tpu.ops.pallas_kernels import field_fused as jax_field
from test_torch_cuda import (FIELD_CASES, assert_field_close, kept_f32,
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
