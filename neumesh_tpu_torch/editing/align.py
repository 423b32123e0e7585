"""Mesh alignment on the host (counterpart of neumesh_tpu/editing/align.py):
a similarity transform from index correspondences (Umeyama), refined by
point-to-point ICP with the host library's KD-tree (cpp/native.py) for
the nearest neighbours.

umeyama() is Open3D's TransformationEstimationPointToPoint(with_scaling=
True); icp_point_to_point() its registration_icp with a distance
threshold.
"""
from __future__ import annotations

import numpy as np

from ..cpp import native


def umeyama(src: np.ndarray, dst: np.ndarray,
            with_scaling: bool = True) -> np.ndarray:
    """Least-squares similarity transform T (4x4) with T @ src ~= dst."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    sc = src - mu_s
    dc = dst - mu_d
    cov = dc.T @ sc / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scaling:
        var_s = (sc ** 2).sum() / len(src)
        scale = np.trace(np.diag(D) @ S) / var_s
    else:
        scale = 1.0
    t = mu_d - scale * R @ mu_s
    T = np.eye(4)
    T[:3, :3] = scale * R
    T[:3, 3] = t
    return T


def icp_point_to_point(source: np.ndarray, target: np.ndarray,
                       threshold: float = 0.03, init: np.ndarray = None,
                       with_scaling: bool = True,
                       max_iter: int = 30) -> np.ndarray:
    """Point-to-point ICP: each round re-fits Umeyama on the source points
    whose nearest target lies within threshold; stops on fewer than 3
    inliers or a mean-distance change below 1e-9."""
    T = np.eye(4) if init is None else np.asarray(init, np.float64).copy()
    src = np.asarray(source, np.float64)
    tgt = np.asarray(target)
    tree = native.KDTree(tgt)
    prev_err = np.inf
    for _ in range(max_iter):
        moved = src @ T[:3, :3].T + T[:3, 3]
        dist, idx = tree.query(moved, k=1)
        dist, idx = dist[:, 0], idx[:, 0]
        inlier = dist < threshold
        if inlier.sum() < 3:
            break
        T_new = umeyama(src[inlier], tgt[idx[inlier]], with_scaling)
        err = float(dist[inlier].mean())
        T = T_new
        if abs(prev_err - err) < 1e-9:
            break
        prev_err = err
    return T


def estimate_transform_from_corr(main_pts: np.ndarray, ref_pts: np.ndarray,
                                 corr: np.ndarray, threshold: float = 0.03,
                                 refine: bool = True) -> np.ndarray:
    """T_r_m mapping main -> reference space from index correspondences
    (corr[:, 0] main vertex ids, corr[:, 1] reference vertex ids),
    optionally ICP-refined over the full clouds."""
    corr = np.asarray(corr, np.int64)
    T = umeyama(main_pts[corr[:, 0]], ref_pts[corr[:, 1]], with_scaling=True)
    if refine:
        T = icp_point_to_point(main_pts, ref_pts, threshold, init=T,
                               with_scaling=True)
    return T
