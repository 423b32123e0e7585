"""NN primitives of the port (counterpart of neumesh_tpu/nn.py).

Linear weights keep the JAX layout `w: (in, out)` (apply is x @ w + b);
weight-normalised layers store `g: (out,)`, `v: (in, out)` with the
effective weight v * g / max(||v||_col, 1e-12), per output column
(torch.nn.utils.weight_norm(dim=0) semantics of the reference).
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn


class WNLinear(nn.Module):
    """Weight-normalised linear in the JAX layout: g (out,), v (in, out).
    Parameters are made frozen; a trainer turns on their gradients."""

    def __init__(self, in_dim, out_dim, device):
        super().__init__()
        z = dict(device=device, dtype=torch.float32)
        self.g = nn.Parameter(torch.ones(out_dim, **z), requires_grad=False)
        self.v = nn.Parameter(torch.zeros(in_dim, out_dim, **z),
                              requires_grad=False)
        self.b = nn.Parameter(torch.zeros(out_dim, **z), requires_grad=False)

    def weight(self):
        return wnorm_weight(self.g, self.v)

    @torch.no_grad()
    def set_weight(self, w, b) -> None:
        """Effective weight (in, out) and bias from numpy: v = w, g =
        ||w||_col (torch weight-norm init)."""
        w = np.asarray(w, np.float32)
        self.v.copy_(torch.as_tensor(w))
        self.g.copy_(torch.as_tensor(np.linalg.norm(w, axis=0)))
        self.b.copy_(torch.as_tensor(np.asarray(b, np.float32)))


class Linear(nn.Module):
    """Plain linear in the JAX layout: w (in, out)."""

    def __init__(self, in_dim, out_dim, device):
        super().__init__()
        z = dict(device=device, dtype=torch.float32)
        self.w = nn.Parameter(torch.zeros(in_dim, out_dim, **z),
                              requires_grad=False)
        self.b = nn.Parameter(torch.zeros(out_dim, **z), requires_grad=False)

    def weight(self):
        return self.w

    @torch.no_grad()
    def set_weight(self, w, b) -> None:
        self.w.copy_(torch.as_tensor(np.asarray(w, np.float32)))
        self.b.copy_(torch.as_tensor(np.asarray(b, np.float32)))


def maybe_wnorm_linear(in_dim, out_dim, weight_norm: bool, device):
    return (WNLinear if weight_norm else Linear)(in_dim, out_dim, device)


def torch_default_init(rng, in_dim, out_dim):
    """U(-1/sqrt(in), 1/sqrt(in)) weight (in, out) and bias, from numpy."""
    bound = 1.0 / math.sqrt(in_dim)
    return (rng.uniform(-bound, bound, (in_dim, out_dim)),
            rng.uniform(-bound, bound, (out_dim,)))


def wnorm_weight(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Effective weight-norm weight (in, out) = v * g / max(||v||_0, 1e-12)."""
    norm = torch.linalg.vector_norm(v, dim=0, keepdim=True)
    return v * (g / torch.clamp(norm, min=1e-12))


def maybe_wnorm_apply(layer, x: torch.Tensor, dtype=None) -> torch.Tensor:
    """x @ w + b for a layer with `weight()` (in, out) and `b` (out,).
    With `dtype` the product is rounded to it and the bias added in it
    (the layer runs and returns in `dtype`); without, true f32."""
    return maybe_wnorm_apply_parts(layer, [x], dtype)


def maybe_wnorm_apply_parts(layer, parts, dtype=None) -> torch.Tensor:
    """linear(concat(parts, -1)) as a sum of per-part products over the
    matching weight row blocks, starting from the bias; with `dtype` each
    product is rounded to it and the sum runs in it."""
    w = layer.weight()
    out = layer.b if dtype is None else layer.b.to(dtype)
    lo = 0
    for x in parts:
        wi = w[lo:lo + x.shape[-1]]
        lo += x.shape[-1]
        if dtype is None:
            out = out + x.to(torch.float32) @ wi
        else:
            out = out + x.to(dtype) @ wi.to(dtype)
    return out


def softplus100(x: torch.Tensor) -> torch.Tensor:
    """Softplus with beta=100 and torch's threshold 20 (identity above)."""
    bx = 100.0 * x
    return torch.where(bx > 20.0, x, _softplus(bx) / 100.0)


def softplus100_grad(x: torch.Tensor) -> torch.Tensor:
    bx = 100.0 * x
    return torch.where(bx > 20.0, torch.ones_like(x), torch.sigmoid(bx))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) as max(x, 0) + log1p(exp(-|x|)) (jax.nn.softplus)."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


class Embedder:
    """NeRF positional encoding, output order
    [x, sin(f0 x), cos(f0 x), sin(f1 x), cos(f1 x), ...] with frequencies
    2**linspace(0, multires-1, multires).

    exact=True: per-frequency sin/cos (the f32 parity mode).
    exact=False: double-angle recursion from sin/cos of x (serving)."""

    def __init__(self, multires: int, input_dim: int = 3,
                 exact: bool = True):
        self.input_dim = input_dim
        self.multires = multires
        self.exact = exact
        if multires < 0:
            self.out_dim = input_dim
            self.freqs: tuple = ()
        else:
            n = multires
            if n > 1:
                self.freqs = tuple(float(2.0 ** ((n - 1) * i / (n - 1)))
                                   for i in range(n))
            elif n == 1:
                self.freqs = (1.0,)
            else:
                self.freqs = ()
            self.out_dim = input_dim * (1 + 2 * n)
        self._doubling = (
            not exact and len(self.freqs) >= 1 and self.freqs[0] == 1.0
            and all(self.freqs[i + 1] == 2.0 * self.freqs[i]
                    for i in range(len(self.freqs) - 1)))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.multires < 0:
            return x
        parts = [x]
        if self._doubling:
            s, c = torch.sin(x), torch.cos(x)
            parts += [s, c]
            for _ in self.freqs[1:]:
                s, c = 2.0 * s * c, c * c - s * s
                parts += [s, c]
        else:
            for f in self.freqs:
                xf = x * f
                parts += [torch.sin(xf), torch.cos(xf)]
        return torch.cat(parts, dim=-1)


def get_embedder(multires: int, input_dim: int = 3, exact: bool = True):
    e = Embedder(multires, input_dim, exact=exact)
    return e, e.out_dim
