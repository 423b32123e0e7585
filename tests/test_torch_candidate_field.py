"""candidate_field_v3 and candidate_field (v2): the port's plain versions
against the JAX Pallas kernels (interpret mode) in every want_dh /
want_feat variant, at k = 8 and k = 1, with ragged sample and ray counts
and with 1e9 sentinel candidates, at the tolerances of
tests/test_pallas.py. The CUDA kernels are held against the plain versions
on a card in test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest

from neumesh_tpu.ops.pallas_kernels import candidate_field as jax_v2
from neumesh_tpu.ops.pallas_kernels import candidate_field_v3 as jax_v3
from test_torch_cuda import (CAND_CASES, assert_candidate_close, no_tie_mask,
                             pack_geo, ray_contexts, tie_contexts,
                             torch_candidate)


def _jax_candidate(c, v3, want_dh, want_feat, k, **kw):
    if v3:
        out = jax_v3(jnp.asarray(c["xyz"]), jnp.asarray(pack_geo(c)),
                     jnp.asarray(c["feat"]), 0.12, k=k, want_dh=want_dh,
                     want_feat=want_feat, interpret=True, **kw)
    else:
        out = jax_v2(*[jnp.asarray(c[n]) for n in ("xyz", "pts", "pp", "ind",
                                                   "vn", "feat")],
                     0.12, k=k, want_dh=want_dh, want_feat=want_feat,
                     interpret=True, **kw)
    return [None if o is None else np.asarray(o) for o in out]


@pytest.mark.parametrize("want_dh,want_feat,k", CAND_CASES)
def test_candidate_field_v3_plain_matches_pallas(want_dh, want_feat, k):
    # S = 13 is not a sample-block multiple; C = 40 pads to 128
    c = ray_contexts(seed=5, R=3, S=13, C=40, F=12)
    ok = no_tie_mask(c["xyz"], pack_geo(c), k=k)
    assert ok.mean() > 0.9
    got = torch_candidate(c, True, want_dh, want_feat, k)
    want = _jax_candidate(c, True, want_dh, want_feat, k, sample_block=32)
    assert got[0].shape == (3, 13, 1)
    assert_candidate_close(got, want, ok)


@pytest.mark.parametrize("want_dh,want_feat,k", CAND_CASES)
def test_candidate_field_v2_plain_matches_pallas(want_dh, want_feat, k):
    # 5 rays in blocks of 4 exercise the kernel's ray padding; C unpadded
    c = ray_contexts(seed=2, R=5, S=12, C=32, F=16)
    ok = no_tie_mask(c["xyz"], pack_geo(c), k=k)
    assert ok.mean() > 0.9
    got = torch_candidate(c, False, want_dh, want_feat, k)
    want = _jax_candidate(c, False, want_dh, want_feat, k, rays_per_block=4)
    assert got[0].shape == (5, 12, 1)
    assert_candidate_close(got, want, ok)


@pytest.mark.parametrize("v3", [True, False])
def test_candidate_sentinels_are_never_selected(v3):
    """1e9 sentinel vertices (the context's duplicate/missing ids) next to
    the 128-padding's pp = 1e12 columns: never selected, every output
    finite, ds as the JAX kernel's, and every output equal to the same
    contexts without them."""
    c = ray_contexts(seed=1, R=4, S=16, C=40, F=8, n_sentinel=8)
    got = torch_candidate(c, v3, True, True, 8)
    want = _jax_candidate(c, v3, True, True, 8)
    assert all(np.isfinite(a).all() for a in got)
    np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=1e-4)
    cut = {n: (a[:, :-8] if n != "xyz" else a) for n, a in c.items()}
    trimmed = torch_candidate(cut, v3, True, True, 8)
    for a, b in zip(got, trimmed):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-6)


def _masked_min_weights(c, k):
    """Numpy model (float32 throughout) of the kernels' selection rule on
    ray_contexts `c`: d2 = max(xx + pp - 2 x.v, 0), tie-broken by
    (1 + c 2e-7), k passes that each remove everything <= the pass
    minimum, inverse-distance weights on all that were removed."""
    f = np.float32
    x, p = c["xyz"][:, :, None, :], c["pts"][:, None]
    xv = (x[..., 0] * p[..., 0] + x[..., 1] * p[..., 1]) + x[..., 2] * p[..., 2]
    xx = (x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]) + x[..., 2] * x[..., 2]
    d2 = np.maximum((xx + c["pp"][:, None]) - f(2) * xv, f(0)).astype(f)
    tb = d2 * (f(1) + np.arange(d2.shape[-1], dtype=f) * f(2e-7))
    cur = tb.copy()
    for _ in range(k):
        thr = cur.min(-1, keepdims=True)
        cur = np.where(cur <= thr, np.inf, cur)
    raw = np.where(tb <= thr, f(1) / (np.sqrt(d2) + f(1e-7)), f(0)).astype(f)
    return raw / raw.sum(-1, keepdims=True)


@pytest.mark.parametrize("v3", [True, False])
@pytest.mark.parametrize("k", [1, 8])
def test_candidate_plain_sums_every_tied_pick(v3, k):
    """A sample exactly on a duplicated candidate: one masked-min pass
    removes both copies, so k passes select k + 1 candidates and the blend
    must sum them all. The plain version is held to the interpreted TPU
    kernel on that sample (ds 1e-5 + 1e-4 rel, feats 5e-5 + 1e-4 rel, the
    tolerances of the no-tie samples) and to a numpy model of the
    masked-min rule (k + 1 nonzero weights, feats 5e-5 + 1e-4 rel)."""
    c = tie_contexts()
    got = torch_candidate(c, v3, False, True, k)
    want = _jax_candidate(c, v3, False, True, k)
    W = _masked_min_weights(c, k)
    assert ((W[:, 0] != 0).sum(-1) == k + 1).all()
    assert (W[:, 0, 3] == W[:, 0, 17]).all() and (W[:, 0, 3] > 0.49).all()
    model = np.einsum("rsc,rcf->rsf", W.astype(np.float64),
                      c["feat"].astype(np.float64))
    np.testing.assert_allclose(got[2][:, 0], model[:, 0], atol=5e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(got[2][:, 0], want[2][:, 0], atol=5e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(got[0][:, 0], want[0][:, 0], atol=1e-5,
                               rtol=1e-4)
    ok = no_tie_mask(c["xyz"], pack_geo(c), k=k)
    assert not ok[:, 0].any() and ok.mean() > 0.5
    assert_candidate_close(got, want, ok)


@pytest.mark.parametrize("threads", [2, 4, 8])
def test_candidate_field_v3_plain_does_not_move_with_threads(threads):
    """The plain version on the inputs of
    test_candidate_field_v3_plain_matches_pallas (seed 5, k = 8, ds, dh
    and feats) gives the same bits at 1 and at `threads` torch threads,
    and with its operands at another buffer alignment: its sums do not
    depend on the intra-op thread count."""
    import torch
    c = ray_contexts(seed=5, R=3, S=13, C=40, F=12)
    n0 = torch.get_num_threads()
    try:
        torch.set_num_threads(1)
        one = torch_candidate(c, True, True, True, 8)
        torch.set_num_threads(threads)
        many = torch_candidate(c, True, True, True, 8)
        shifted = {}
        for n in ("xyz", "pts", "ind", "pp", "vn", "feat"):
            buf = np.zeros(c[n].size + 3, c[n].dtype)
            buf[3:] = c[n].reshape(-1)
            shifted[n] = buf[3:].reshape(c[n].shape)
        moved = torch_candidate(shifted, True, True, True, 8)
    finally:
        torch.set_num_threads(n0)
    for got in (many, moved):
        assert all(np.array_equal(a, b) for a, b in zip(got, one))
