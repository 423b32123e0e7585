"""As-rigid-as-possible mesh deformation on the host. By default
(backend="native") the C++ ARAP of the host library (cpp/native.py, the
port's copy of neumesh_tpu/cpp), as the JAX package takes it;
backend="numpy" runs the same algorithm vectorised in numpy and
scipy.sparse, equal to it to ~1e-8 (the sums run in another order).

Cotangent weights 0.5 cot summed per edge and clamped at 1e-8; max_iter
local/global rounds: the local step fits each vertex's rotation to the
SVD of its weighted edge covariance (the reflection fixed on the
smallest singular value), the global step solves the Laplacian system on
the free vertices by conjugate gradients (the three coordinates in one
CG with shared step sizes, at most 200 iterations, stopping at
|r|^2 <= 1e-16, warm-started from the current positions). A direct
sparse solve would converge further than the capped CG on large meshes,
and so would not give the same deformation.
"""
from __future__ import annotations

import numpy as np
from scipy import sparse


def cotangent_edges(vertices: np.ndarray, triangles: np.ndarray):
    """(a (E,), b (E,), w (E,)): each undirected edge once (a < b) with
    its summed 0.5 cot weight clamped at 1e-8."""
    v = np.asarray(vertices, np.float64)
    t = np.asarray(triangles, np.int64)
    p0, p1, p2 = v[t[:, 0]], v[t[:, 1]], v[t[:, 2]]

    def cot(a, b):
        c = np.sum(a * b, -1)
        s = np.linalg.norm(np.cross(a, b), axis=-1)
        return c / np.maximum(s, 1e-12)

    # the angle at each corner weighs the opposite edge
    c0 = cot(p1 - p0, p2 - p0)
    c1 = cot(p0 - p1, p2 - p1)
    c2 = cot(p0 - p2, p1 - p2)
    ea = np.concatenate([t[:, 1], t[:, 0], t[:, 0]])
    eb = np.concatenate([t[:, 2], t[:, 2], t[:, 1]])
    ew = 0.5 * np.concatenate([c0, c1, c2])
    lo, hi = np.minimum(ea, eb), np.maximum(ea, eb)
    key, inv = np.unique(lo * len(v) + hi, return_inverse=True)
    w = np.bincount(inv.reshape(-1), weights=ew, minlength=len(key))
    return key // len(v), key % len(v), np.maximum(w, 1e-8)


def fit_rotations(S: np.ndarray) -> np.ndarray:
    """(N, 3, 3) rotations R nearest each covariance S = sum w e' e^T
    (R e ~ e'): R = U diag(1, 1, det) V^T of S's SVD."""
    U, _, Vt = np.linalg.svd(S)
    d = np.sign(np.linalg.det(U @ Vt))
    d = np.where(d == 0, 1.0, d)
    U = U.copy()
    U[:, :, 2] *= d[:, None]
    return U @ Vt


def arap(vertices: np.ndarray, triangles: np.ndarray,
         constraint_ids: np.ndarray, constraint_pos: np.ndarray,
         max_iter: int = 20, backend: str = "native") -> np.ndarray:
    """Deformed (N, 3) float64 vertices with constraint_ids pinned at
    constraint_pos (a repeated id takes its last position). backend:
    "native" (the C++ library) or "numpy"."""
    if backend == "native":
        from ..cpp import native

        return native.arap(vertices, triangles, constraint_ids,
                           constraint_pos, max_iter=max_iter)
    if backend != "numpy":
        raise ValueError(f"unknown ARAP backend {backend!r}: 'native' or "
                         "'numpy'")
    V = np.asarray(vertices, np.float64)
    nv = len(V)
    cids = np.asarray(constraint_ids, np.int64).reshape(-1)
    cpos = np.asarray(constraint_pos, np.float64).reshape(-1, 3)
    if len(cids) and (cids.min() < 0 or cids.max() >= nv):
        raise ValueError("arap: constraint id out of range")
    a, b, w = cotangent_edges(V, triangles)
    # directed edges i -> j, both ways
    I = np.concatenate([a, b])
    J = np.concatenate([b, a])
    Wd = np.concatenate([w, w])
    fixed = np.zeros(nv, bool)
    fixed[cids] = True
    P = V.copy()
    P[cids] = cpos
    free = np.where(~fixed)[0]
    # scatter of directed-edge rows into their source vertex
    gather = sparse.csr_matrix((np.ones(len(I)), (I, np.arange(len(I)))),
                               shape=(nv, len(I)))
    wsum = gather @ Wd
    # the Laplacian on the free vertices: wsum on the diagonal (every
    # neighbour), -w towards free neighbours
    pos = -np.ones(nv, np.int64)
    pos[free] = np.arange(len(free))
    ff = (~fixed[I]) & (~fixed[J])
    L = (sparse.csr_matrix((-Wd[ff], (pos[I[ff]], pos[J[ff]])),
                           shape=(len(free), len(free)))
         + sparse.diags(wsum[free]))
    to_fixed = fixed[J] & ~fixed[I]
    e = V[J] - V[I]                                    # source edges
    for _ in range(max_iter):
        # local: rotations from the edge covariances
        ep = P[J] - P[I]
        S = (gather @ (Wd[:, None] * (ep[:, :, None] * e[:, None, :])
                       .reshape(-1, 9))).reshape(nv, 3, 3)
        R = fit_rotations(S)
        # global: rhs_i = sum_j w_ij (R_i + R_j)/2 (v_i - v_j) + fixed terms
        Rs = 0.5 * (R[I] + R[J])
        contrib = Wd[:, None] * np.einsum("eab,eb->ea", Rs, -e)
        contrib[to_fixed] += Wd[to_fixed, None] * P[J[to_fixed]]
        rhs = (gather @ contrib)[free]
        P[free] = _cg(L, rhs, P[free])
    return P


def _cg(L, rhs, x, iters: int = 200):
    """Conjugate gradients on L x = rhs for (n, 3) x, one shared step size
    over the three columns, at most `iters` iterations."""
    x = x.copy()
    r = rhs - L @ x
    p = r.copy()
    rr = float(np.sum(r * r))
    for _ in range(iters):
        if rr <= 1e-16:
            break
        Ap = L @ p
        pAp = float(np.sum(p * Ap))
        if pAp <= 0:
            break
        alpha = rr / pAp
        x += alpha * p
        r -= alpha * Ap
        rr_new = float(np.sum(r * r))
        p = r + (rr_new / rr) * p
        rr = rr_new
    return x
