"""As-rigid-as-possible mesh deformation on the host. By default
(backend="native") the C++ ARAP of the host library (cpp/native.py, the
port's copy of neumesh_tpu/cpp), as the JAX package takes it;
backend="numpy" runs the same algorithm vectorised in numpy and
scipy.sparse (the sums run in another order): equal to it to ~1e-8 where
every one-ring spans 3-D, as on a marching-cubes or a jittered icosphere
mesh. Planar one-rings (marching tetrahedra on a grid) give a covariance
with a zero column; both backends then take that singular direction from
roundoff and can differ by ~1e-2 after a few rounds (0.032 after 20 on a
16^3 tetrahedra sphere, tests/test_torch_editing.py).

Cotangent weights 0.5 cot summed per edge and clamped at 1e-8; max_iter
local/global rounds: the local step fits each vertex's rotation to its
weighted edge covariance step by step as the library does (a Jacobi
eigendecomposition of the covariance's Gram matrix in the library's
sweep order, U = S v / sigma normalised with a coordinate axis below
1e-12, the column of the least eigenvalue flipped on a reflection), the
global step solves the Laplacian system on
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


def _mul(a, b):
    """Batched 3x3 products summed in the library's order (M3::mul)."""
    r = np.zeros(np.broadcast_shapes(a.shape, b.shape))
    for i in range(3):
        for j in range(3):
            s = 0.0
            for k in range(3):
                s = s + a[..., i, k] * b[..., k, j]
            r[..., i, j] = s
    return r


def _apply(m, v):
    """Batched m v summed in the library's order (M3::apply)."""
    return np.stack([m[..., i, 0] * v[..., 0] + m[..., i, 1] * v[..., 1]
                     + m[..., i, 2] * v[..., 2] for i in range(3)], -1)


def _det(m):
    return (m[:, 0, 0] * (m[:, 1, 1] * m[:, 2, 2] - m[:, 1, 2] * m[:, 2, 1])
            - m[:, 0, 1] * (m[:, 1, 0] * m[:, 2, 2] - m[:, 1, 2] * m[:, 2, 0])
            + m[:, 0, 2] * (m[:, 1, 0] * m[:, 2, 1] - m[:, 1, 1] * m[:, 2, 0]))


def _sym_eig(A):
    """The library's Jacobi eigendecomposition (sym_eig) of (N, 3, 3)
    symmetric matrices, vectorised: up to 32 sweeps over the pairs (0, 1),
    (0, 2), (1, 2), a matrix leaving once its off-diagonal sum is below
    1e-15, a pair skipped below 1e-18. Returns (eigenvectors as columns,
    eigenvalues)."""
    a = A.copy()
    V = np.broadcast_to(np.eye(3), A.shape).copy()
    eye = np.eye(3)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        for _ in range(32):
            live = (np.abs(a[:, 0, 1]) + np.abs(a[:, 0, 2])
                    + np.abs(a[:, 1, 2])) >= 1e-15
            if not live.any():
                break
            for p, q in ((0, 1), (0, 2), (1, 2)):
                apq = a[:, p, q]
                on = live & (np.abs(apq) >= 1e-18)
                theta = (a[:, q, q] - a[:, p, p]) / (2 * apq)
                t = (np.where(theta >= 0, 1.0, -1.0)
                     / (np.abs(theta) + np.sqrt(theta * theta + 1)))
                c = 1 / np.sqrt(t * t + 1)
                s = t * c
                J = np.broadcast_to(eye, A.shape).copy()
                J[:, p, p] = c
                J[:, q, q] = c
                J[:, p, q] = s
                J[:, q, p] = -s
                on3 = on[:, None, None]
                a = np.where(on3, _mul(_mul(J.transpose(0, 2, 1), a), J), a)
                V = np.where(on3, _mul(V, J), V)
    return V, np.stack([a[:, i, i] for i in range(3)], -1)


def fit_rotations(S: np.ndarray) -> np.ndarray:
    """(N, 3, 3) rotations R nearest each covariance S = sum w e' e^T
    (R e ~ e'), as the library's fit_rotation computes them: M = S^T,
    the Jacobi eigenvectors v_j and eigenvalues w_j of M^T M, U's columns
    M v_j / sqrt(max(w_j, 1e-18)) normalised (the j-th axis where the norm
    falls below 1e-12), R = (U V^T)^T, and on a negative determinant U's
    column of the least eigenvalue flipped."""
    S = np.asarray(S, np.float64)
    M = S.transpose(0, 2, 1)
    Vm, w = _sym_eig(_mul(M.transpose(0, 2, 1), M))
    U = np.empty_like(M)
    for j in range(3):
        sigma = np.sqrt(np.maximum(w[:, j], 1e-18))
        uj = _apply(M, Vm[:, :, j]) * (1.0 / sigma)[:, None]
        nrm = np.sqrt(uj[:, 0] * uj[:, 0] + uj[:, 1] * uj[:, 1]
                      + uj[:, 2] * uj[:, 2])
        small = nrm < 1e-12
        uj[small] = np.eye(3)[j]
        nrm = np.where(small, 1.0, nrm)
        U[:, :, j] = uj * (1.0 / nrm)[:, None]
    Vt = Vm.transpose(0, 2, 1)
    R = _mul(U, Vt)
    neg = _det(R) < 0
    if neg.any():
        # the first least eigenvalue, as the library's strict < scan
        jmin = np.argmin(w[neg], axis=-1)
        Un = U[neg]
        Un[np.arange(len(jmin)), :, jmin] *= -1
        U[neg] = Un
        R[neg] = _mul(Un, Vt[neg])
    return R.transpose(0, 2, 1)


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
