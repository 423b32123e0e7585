"""kNN feature interpolation and the interpolated signed distance
(counterpart of neumesh_tpu/ops/interp.py).

The kNN indices and inverse-distance weights are detached; the signed
distance stays analytic in the query point and in the indicator vectors
and weight, so its gradient is exact.
"""
from __future__ import annotations

import torch


def knn_weights(sq_dist: torch.Tensor) -> torch.Tensor:
    """Normalised inverse-distance weights w = 1/(d + 1e-7) of detached
    squared kNN distances (..., K)."""
    w = 1.0 / (torch.sqrt(sq_dist) + 1e-7)
    return w / torch.sum(w, dim=-1, keepdim=True)


def interpolate_features(features: torch.Tensor, indices: torch.Tensor,
                         weights: torch.Tensor) -> torch.Tensor:
    """f(x) = sum_k w_k F[idx_k]: features (N, F), indices/weights (..., K)
    -> (..., F)."""
    return torch.sum(features[indices] * weights[..., None], dim=-2)


def interpolated_distance(xyz, vertices, indices, weights,
                          indicator_vectors, indicator_weight):
    """Interpolated signed distance h(x) (..., 1):

        dir_k = x - v_k,  w2_k = |dir_k|
        mid_k = (n_k w1 + dir_k w2_k) / (w1 + w2_k)
        h(x)  = sum_k w_k <dir_k, mid_k>

    xyz (..., 3); vertices / indicator_vectors (N, 3); indices / weights
    (..., K) (detached here); indicator_weight the scalar w1."""
    indices = indices.detach()
    weights = weights.detach()
    return interpolated_distance_from_parts(
        xyz, vertices[indices], indicator_vectors[indices], weights,
        indicator_weight)


def interpolated_distance_from_parts(xyz, nbr_pts, nbr_ind, weights,
                                     indicator_weight):
    """The same formula on gathered neighbour data: nbr_pts / nbr_ind
    (..., K, 3), weights (..., K)."""
    w1 = indicator_weight
    dir_vec = xyz[..., None, :] - nbr_pts
    # safe norm: a bounded gradient where a query sits on a vertex
    w2 = torch.sqrt(torch.sum(dir_vec * dir_vec, dim=-1, keepdim=True)
                    + 1e-20)
    middle_vec = (nbr_ind * w1 + dir_vec * w2) / (w1 + w2)
    per_k = weights[..., None] * torch.sum(dir_vec * middle_vec, dim=-1,
                                           keepdim=True)
    return torch.sum(per_k, dim=-2)


def interpolated_distance_and_grad(xyz, nbr_pts, nbr_ind, weights,
                                   indicator_weight):
    """(h(x) (..., 1), grad_x h (..., 3)) from one vector-Jacobian
    product (torch.func.vjp, so it also runs inside torch.no_grad)."""
    def f(x):
        return interpolated_distance_from_parts(
            x, nbr_pts, nbr_ind, weights, indicator_weight)[..., 0]

    h, vjp_fn = torch.func.vjp(f, xyz)
    (grad,) = vjp_fn(torch.ones_like(h))
    return h[..., None], grad
