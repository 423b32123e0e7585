"""Camera math on the host in numpy (own copy of the parts of
neumesh_tpu/ops/cameras.py the render entry needs): a pure-numpy RQ
decomposition of DTU projection matrices, look-at / view matrices and
the spiral camera track."""
from __future__ import annotations

import numpy as np


def rq_decompose(M: np.ndarray):
    """RQ decomposition M = R @ Q with R upper-triangular (positive diagonal)
    and Q orthonormal. 3x3 only."""
    # RQ via QR of the flipped matrix: if P = flip(M).T, P = QR, then
    # M = flip(R.T) @ flip(Q.T) with flip(R.T) upper triangular.
    P = np.flipud(M).T
    Q, R = np.linalg.qr(P)
    Rr = np.flipud(R.T)[:, ::-1]
    Qr = np.flipud(Q.T)
    s = np.sign(np.diag(Rr))
    s[s == 0] = 1.0
    S = np.diag(s)
    return Rr @ S, S @ Qr


def load_K_Rt_from_P(P: np.ndarray):
    """3x4 projection matrix -> (intrinsics (4, 4) normalised by K[2, 2],
    camera-to-world pose (4, 4) f32: rotation R^T, translation the camera
    centre), as cv2.decomposeProjectionMatrix gives them."""
    P = np.asarray(P, dtype=np.float64)[:3, :4]
    M = P[:3, :3]
    K, R = rq_decompose(M)
    c = -np.linalg.solve(M, P[:, 3])
    K = K / K[2, 2]
    intrinsics = np.eye(4)
    intrinsics[:3, :3] = K
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = R.T.astype(np.float32)
    pose[:3, 3] = c.astype(np.float32)
    return intrinsics, pose


def normalize(vec: np.ndarray) -> np.ndarray:
    return vec / (np.linalg.norm(vec, axis=-1, keepdims=True) + 1e-9)


def view_matrix(forward: np.ndarray, up: np.ndarray,
                cam_location: np.ndarray):
    rot_z = normalize(forward)
    rot_x = normalize(np.cross(up, rot_z))
    rot_y = normalize(np.cross(rot_z, rot_x))
    mat = np.stack((rot_x, rot_y, rot_z, cam_location), axis=-1)
    hom_vec = np.array([[0.0, 0.0, 0.0, 1.0]])
    if len(mat.shape) > 2:
        hom_vec = np.tile(hom_vec, [mat.shape[0], 1, 1])
    return np.concatenate((mat, hom_vec), axis=-2)


def look_at(cam_location, point, up=np.array([0.0, -1.0, 0.0])):
    """OpenCV convention: camera looks along +z."""
    return view_matrix(normalize(point - cam_location), up, cam_location)


def rot_to_quat(R: np.ndarray) -> np.ndarray:
    """(..., 3, 3) rotations -> (..., 4) wxyz quaternions."""
    R = np.asarray(R)
    q = np.ones(R.shape[:-2] + (4,), dtype=R.dtype)
    qw = np.sqrt(np.maximum(
        1.0 + R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2], 0)) / 2
    q[..., 0] = qw
    q[..., 1] = (R[..., 2, 1] - R[..., 1, 2]) / (4 * qw)
    q[..., 2] = (R[..., 0, 2] - R[..., 2, 0]) / (4 * qw)
    q[..., 3] = (R[..., 1, 0] - R[..., 0, 1]) / (4 * qw)
    return q


def quat_to_rot(q: np.ndarray) -> np.ndarray:
    """(..., 4) wxyz quaternions (normalised here) -> (..., 3, 3) float64
    rotations."""
    q = np.asarray(q, dtype=np.float64)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    qr, qi, qj, qk = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = np.empty(q.shape[:-1] + (3, 3), dtype=np.float64)
    R[..., 0, 0] = 1 - 2 * (qj ** 2 + qk ** 2)
    R[..., 0, 1] = 2 * (qj * qi - qk * qr)
    R[..., 0, 2] = 2 * (qi * qk + qr * qj)
    R[..., 1, 0] = 2 * (qj * qi + qk * qr)
    R[..., 1, 1] = 1 - 2 * (qi ** 2 + qk ** 2)
    R[..., 1, 2] = 2 * (qj * qk - qi * qr)
    R[..., 2, 0] = 2 * (qk * qi - qj * qr)
    R[..., 2, 1] = 2 * (qj * qk + qi * qr)
    R[..., 2, 2] = 1 - 2 * (qi ** 2 + qj ** 2)
    return R


def poses_avg(poses: np.ndarray) -> np.ndarray:
    """Average c2w pose of (N, 4, 4) poses."""
    center = poses[:, :3, 3].mean(0)
    forward = poses[:, :3, 2].sum(0)
    up = poses[:, :3, 1].sum(0)
    return view_matrix(forward, up, center)


def c2w_track_spiral(c2w: np.ndarray, up_vec: np.ndarray, rads: np.ndarray,
                     focus: float, zrate: float, rots: int, N: int,
                     zdelta: float = 0.0):
    """N camera poses on a spiral around the anchor c2w, each looking at
    the anchor's focus point (OpenCV convention)."""
    c2w_tracks = []
    rads = np.array(list(rads) + [1.0])
    focus_in_world = c2w[:3, :4] @ np.array([0, 0, focus, 1.0])
    for theta in np.linspace(0.0, 2.0 * np.pi * rots, N + 1)[:-1]:
        cam_location = c2w[:3, :4] @ (
            np.array([np.cos(theta), np.sin(theta),
                      np.sin(theta * zrate), 1.0]) * rads)
        c2w_tracks.append(look_at(cam_location, focus_in_world, up=up_vec))
    return c2w_tracks
