"""k-nearest-neighbour search over mesh vertices (counterpart of
neumesh_tpu/ops/knn.py): the exact brute force `knn_brute`, and the
per-cell precomputed-candidate grid.

A dense grid over the query domain maps every cell to a candidate ROW
(`cell_row`); rows (`cand_idx`) hold the Kp vertices nearest the cell
centre and exist only for near-surface cells, far cells pointing at the
row of their nearest near-surface cell (EDT feature transform).

The build runs on the host in numpy. Its exact kNN (float64) is by
default the port's copy of the JAX package's C++ KD-tree (cpp/native.py),
which keeps the first of equal distances it visits: the tables then equal
the JAX package's default build, ties and the order within a row
included. backend="scipy" takes scipy's cKDTree, whose ties differ. Same
validation (kNN distances against exact search, Kp doubled while the
mean relative error exceeds 5e-3) and the same `.npz` cache format, in
its own directory, keyed by the backend too.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass
class CandidateGrid:
    """cell_row (n_cells,) int32, cand_idx (n_rows, Kp) int32 tensors;
    cand_pts (n_rows, Kp, 3) f32 numpy (host only); origin (3,) f32 and
    inv_h () f32 tensors; dims a 3-tuple."""
    cell_row: torch.Tensor
    cand_idx: torch.Tensor
    cand_pts: np.ndarray
    origin: torch.Tensor
    inv_h: torch.Tensor
    dims: Tuple[int, int, int]

    @property
    def Kp(self) -> int:
        return int(self.cand_idx.shape[1])

    @classmethod
    def from_arrays(cls, cell_row, cand_idx, cand_pts, origin, inv_h, dims,
                    device="cpu") -> "CandidateGrid":
        """Adopt tables built elsewhere (e.g. by the JAX package), as numpy
        arrays or array-likes."""
        dev = torch.device(device)
        return cls(
            cell_row=torch.as_tensor(np.array(cell_row, np.int32),
                                     device=dev),
            cand_idx=torch.as_tensor(np.array(cand_idx, np.int32),
                                     device=dev),
            cand_pts=np.ascontiguousarray(np.asarray(cand_pts, np.float32)),
            origin=torch.as_tensor(np.array(origin, np.float32),
                                   device=dev),
            inv_h=torch.as_tensor(np.array(inv_h, np.float32), device=dev),
            dims=tuple(int(d) for d in dims))

    def to(self, device) -> "CandidateGrid":
        return dataclasses.replace(
            self, cell_row=self.cell_row.to(device),
            cand_idx=self.cand_idx.to(device),
            origin=self.origin.to(device), inv_h=self.inv_h.to(device))

    def query(self, xyz: torch.Tensor, k: int = 8, q_chunk: int = 262144):
        """Device kNN through the table: xyz (..., 3) -> (sq_dist (..., k)
        ascending, indices (..., k) int64); the k nearest of each query
        cell's Kp candidates, ties to the lower candidate slot."""
        shape = xyz.shape[:-1]
        q = xyz.reshape(-1, 3)
        parts = [self._query_chunk(q[i:i + q_chunk], k)
                 for i in range(0, q.shape[0], q_chunk)] or \
            [self._query_chunk(q, k)]
        sq = torch.cat([a for a, _ in parts], 0)
        idx = torch.cat([b for _, b in parts], 0)
        return sq.reshape(shape + (k,)), idx.reshape(shape + (k,))

    def _pts_device(self, device) -> torch.Tensor:
        """cand_pts on `device`, copied there at first use (the tile and
        ray contexts only need cand_idx)."""
        cache = self.__dict__.setdefault("_pts_dev", {})
        if device not in cache:
            cache[device] = torch.as_tensor(self.cand_pts, device=device)
        return cache[device]

    def _query_chunk(self, q, k: int):
        dims = torch.as_tensor(self.dims, device=q.device)
        cell = torch.floor((q - self.origin) * self.inv_h).to(torch.int64)
        cell = torch.minimum(torch.clamp(cell, min=0), dims - 1)
        flat = (cell[:, 0] * dims[1] + cell[:, 1]) * dims[2] + cell[:, 2]
        row = self.cell_row[flat].to(torch.int64)
        cpts = self._pts_device(q.device)[row]               # (Q, Kp, 3)
        cidx = self.cand_idx[row].to(torch.int64)            # (Q, Kp)
        d2 = torch.sum((cpts - q[:, None, :]) ** 2, dim=-1)
        d2s, sel = torch.sort(d2, dim=-1, stable=True)
        return (torch.clamp(d2s[:, :k], min=0.0),
                torch.gather(cidx, -1, sel[:, :k]))

    def query_np(self, q: np.ndarray, k: int = 8):
        """Host kNN through the table: q (Q, 3) -> (sq_dist (Q, k)
        ascending, indices (Q, k))."""
        dims = np.asarray(self.dims)
        origin = self.origin.cpu().numpy()
        inv_h = np.float32(self.inv_h.cpu().numpy())
        q = np.asarray(q, np.float32)
        cell = np.floor((q - origin) * inv_h).astype(np.int64)
        cell = np.clip(cell, 0, dims - 1)
        flat = (cell[:, 0] * dims[1] + cell[:, 1]) * dims[2] + cell[:, 2]
        row = self.cell_row.cpu().numpy()[flat]
        cpts = self.cand_pts[row]
        cidx = self.cand_idx.cpu().numpy()[row]
        d2 = np.sum((cpts - q[:, None, :]) ** 2, axis=-1)
        sel = np.argsort(d2, axis=-1, kind="stable")[:, :k]
        return (np.maximum(np.take_along_axis(d2, sel, -1), 0.0),
                np.take_along_axis(cidx, sel, -1))


def knn_brute(query: torch.Tensor, points: torch.Tensor, k: int,
              q_chunk: int = 8192):
    """Exact kNN: query (Q, 3), points (N, 3) -> (sq_dist (Q, k)
    ascending, indices (Q, k) int64), ties to the lower index. d2 =
    |q|^2 + |p|^2 - 2 q.p with a true-f32 product (set_fp32_precision on
    the card: a TF32 product would wreck the cancellation)."""
    k = min(k, points.shape[0])
    pp = torch.sum(points * points, dim=-1)
    sqs, idxs = [], []
    for i in range(0, max(query.shape[0], 1), q_chunk):
        q = query[i:i + q_chunk]
        d2 = (torch.sum(q * q, dim=-1, keepdim=True) + pp[None, :]
              - 2.0 * (q @ points.T))
        d2s, idx = torch.sort(d2, dim=-1, stable=True)
        sqs.append(torch.clamp(d2s[:, :k], min=0.0))
        idxs.append(idx[:, :k])
    return torch.cat(sqs, 0), torch.cat(idxs, 0)


KNN_BACKENDS = ("native", "scipy")


def _host_knn(points: np.ndarray, queries: np.ndarray, kp: int,
              backend: str = "native"):
    """Exact kp-NN in float64: (dist (Q, kp), idx (Q, kp) int32)."""
    if backend == "native":
        from ..cpp import native

        d, idx = native.KDTree(points.astype(np.float64)).query(
            queries.astype(np.float64), k=kp)
        return d, idx.astype(np.int32)
    from scipy.spatial import cKDTree

    tree = cKDTree(np.asarray(points, np.float64))
    # a list of ranks keeps the (Q, kp) shape for kp == 1 too
    d, idx = tree.query(np.asarray(queries, np.float64),
                        k=list(range(1, kp + 1)), workers=-1)
    return d, idx.astype(np.int32)


def _grid_cache_path(points: np.ndarray, kp: int, cell_size,
                     domain_margin, backend: str) -> str:
    h = hashlib.sha1()
    h.update(np.ascontiguousarray(points, np.float32).tobytes())
    h.update(f"{kp}|{cell_size}|{domain_margin}|{backend}|v5".encode())
    cache_dir = os.environ.get(
        "NEUMESH_TORCH_GRID_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "neumesh_tpu_torch"))
    os.makedirs(cache_dir, exist_ok=True)
    return os.path.join(cache_dir, f"grid_{h.hexdigest()[:20]}.npz")


def build_candidate_grid(points, kp: int = 24, cell_size=None,
                         domain_margin=None, max_cells: int = 2 << 20,
                         validate: bool = True, use_cache: bool = True,
                         backend: str = "native") -> CandidateGrid:
    """Build the two-level candidate grid on the host (CPU tensors; move
    with `.to(device)`). cell_size defaults to the 90th-percentile 8th-NN
    distance; the domain is the vertex bbox grown by 3 cells. backend:
    the exact kNN, "native" (the C++ KD-tree, as the JAX package) or
    "scipy"."""
    if backend not in KNN_BACKENDS:
        raise ValueError(f"unknown kNN backend {backend!r}: one of "
                         f"{KNN_BACKENDS}")
    pts = np.asarray(points, dtype=np.float32)
    n = pts.shape[0]
    kp = min(kp, n)

    cache_path = None
    if use_cache and n > 5000:
        cache_path = _grid_cache_path(pts, kp, cell_size, domain_margin,
                                      backend)
        if os.path.exists(cache_path):
            z = np.load(cache_path)
            return CandidateGrid.from_arrays(
                z["cell_row"], z["cand_idx"], z["cand_pts"], z["origin"],
                z["inv_h"], z["dims"])

    if cell_size is None:
        sample = pts if n <= 20000 else pts[
            np.random.default_rng(0).choice(n, 20000, replace=False)]
        d, _ = _host_knn(pts, sample, min(9, n), backend)
        cell_size = float(np.percentile(d[:, -1], 90) + 1e-6)

    def layout(cs):
        margin = 3.0 * cs if domain_margin is None else float(domain_margin)
        lo = pts.min(0) - margin
        hi = pts.max(0) + margin
        extent = np.maximum(hi - lo, 1e-3)
        return lo, np.maximum(np.ceil(extent / cs).astype(np.int64), 1)

    lo, dims = layout(cell_size)
    while int(dims.prod()) > max_cells:
        cell_size *= 1.26
        lo, dims = layout(cell_size)

    from scipy import ndimage

    cell_of = np.clip(np.floor((pts - lo) / cell_size).astype(np.int64),
                      0, dims - 1)
    occ = np.zeros(tuple(dims), bool)
    occ[cell_of[:, 0], cell_of[:, 1], cell_of[:, 2]] = True
    near_mask = ndimage.binary_dilation(occ, iterations=2)
    near_ijk = np.argwhere(near_mask)
    centers_near = (lo + (near_ijk + 0.5) * cell_size).astype(np.float32)
    _, cand_near = _host_knn(pts, centers_near, kp, backend)

    edt_idx = ndimage.distance_transform_edt(
        ~near_mask, return_distances=False, return_indices=True)
    near_row = np.full(tuple(dims), -1, np.int64)
    near_row[near_ijk[:, 0], near_ijk[:, 1], near_ijk[:, 2]] = \
        np.arange(len(near_ijk))
    cell_row = near_row[edt_idx[0], edt_idx[1], edt_idx[2]].reshape(-1)

    grid = CandidateGrid.from_arrays(
        cell_row, cand_near, pts[cand_near], lo.astype(np.float32),
        np.float32(1.0 / cell_size), dims)

    if validate and n > 8:
        rng = np.random.default_rng(1)
        m = min(2000, n)
        sel = rng.choice(n, m, replace=False)
        qv = pts[sel] + rng.normal(size=(m, 3)).astype(np.float32) \
            * (0.25 * cell_size)
        sq_g, _ = grid.query_np(qv, k=min(8, n))
        d_g = np.sqrt(sq_g)
        d_b, _ = _host_knn(pts, qv, min(8, n), backend)
        rel_err = float(np.mean(np.abs(d_g - d_b) / np.maximum(d_b, 1e-6)))
        if rel_err > 5e-3 and kp < 96:
            return build_candidate_grid(
                points, kp=kp * 2, cell_size=cell_size,
                domain_margin=domain_margin, max_cells=max_cells,
                validate=validate, use_cache=use_cache, backend=backend)

    if cache_path is not None:
        np.savez(cache_path, cell_row=grid.cell_row.numpy(),
                 cand_idx=grid.cand_idx.numpy(), cand_pts=grid.cand_pts,
                 origin=grid.origin.numpy(), inv_h=grid.inv_h.numpy(),
                 dims=np.asarray(grid.dims))
    return grid


def build_uniform_grid(points, cell_size=None, **kwargs) -> CandidateGrid:
    """The JAX package's older name of build_candidate_grid."""
    for name in ("capacity_cap", "coarse_factor", "coarse_capacity_cap",
                 "k_ref", "verbose"):
        kwargs.pop(name, None)
    return build_candidate_grid(points, cell_size=cell_size, **kwargs)
