"""NN primitives of the port (counterpart of neumesh_tpu/nn.py).

Linear weights keep the JAX layout `w: (in, out)` (apply is x @ w + b);
weight-normalised layers store `g: (out,)`, `v: (in, out)` with the
effective weight v * g / max(||v||_col, 1e-12), per output column
(torch.nn.utils.weight_norm(dim=0) semantics of the reference).
"""
from __future__ import annotations

import torch


def wnorm_weight(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Effective weight-norm weight (in, out) = v * g / max(||v||_0, 1e-12)."""
    norm = torch.linalg.vector_norm(v, dim=0, keepdim=True)
    return v * (g / torch.clamp(norm, min=1e-12))


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
