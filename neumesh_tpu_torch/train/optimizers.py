"""Optimizer and LR schedules (counterpart of
neumesh_tpu/train/optimizers.py).

One Adam over every parameter of the model, whose per-parameter learning
rate is the product of a per-group base lr (the lr dict of the config,
keyed by top-level parameter name, 'default' for the rest) and a global
schedule factor (warmup-cosine, exponential or multistep). Step for step
it is the JAX package's optax chain (scale_by_adam, then -lr * factor):

    mu = (1 - b1) g + b1 mu,   nu = (1 - b2) g^2 + b2 nu,   t = count + 1
    u  = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)
    p += -u * lr * factor(count * step_scale)

with the schedule read at the pre-increment count and a missing gradient
counted as zero, as a JAX gradient tree has every leaf.
"""
from __future__ import annotations

import math
import numbers
from typing import Callable

import torch

from ..utils.trace import spanned


def _f32(x):
    return torch.as_tensor(x, dtype=torch.float32)


def warmup_cosine_factor(total_steps: int, warmup_steps: int,
                         min_factor: float = 0.1) -> Callable:
    def fn(step):
        step = _f32(step)
        warm = step / max(warmup_steps, 1)
        cos = (torch.cos(math.pi * (step - warmup_steps)
                         / (total_steps - warmup_steps)) + 1.0) \
            * 0.5 * (1 - min_factor) + min_factor
        return torch.where(step < warmup_steps, warm, cos)
    return fn


def exponential_factor(total_steps: int, min_factor: float = 0.1) -> Callable:
    def fn(step):
        t = torch.clamp(_f32(step) / total_steps, 0.0, 1.0)
        return torch.exp(t * math.log(min_factor))
    return fn


def multistep_factor(milestones, gamma: float) -> Callable:
    """torch MultiStepLR semantics."""
    ms = _f32(sorted(milestones))

    def fn(step):
        return _f32(gamma) ** torch.sum(_f32(step) >= ms).to(torch.float32)
    return fn


def get_schedule_factor(args) -> Callable:
    sch = args.training.scheduler
    if sch.type == "warmupcosine":
        return warmup_cosine_factor(args.training.num_iters,
                                    sch.warmup_steps,
                                    sch.setdefault("min_factor", 0.1))
    if sch.type == "exponential_step":
        return exponential_factor(args.training.num_iters,
                                  sch.setdefault("min_factor", 0.1))
    if sch.type == "multistep":
        return multistep_factor(sch.milestones, sch.gamma)
    raise NotImplementedError(f"unknown scheduler type: {sch.type}")


def _top_key(name: str) -> str:
    return name.split(".")[0]


def _lr_of(names, lr_cfg) -> dict:
    """Base lr of each parameter name from the lr config: a number, or a
    dict keyed by top-level parameter name with a 'default'."""
    if isinstance(lr_cfg, numbers.Number):
        return {n: float(lr_cfg) for n in names}
    lr_dict = dict(lr_cfg)
    default_lr = float(lr_dict.pop("default"))
    tops = {_top_key(n) for n in names}
    for k in lr_dict:
        if k not in tops:
            raise RuntimeError(f"wrong lr key: {k}")
    return {n: float(lr_dict.get(_top_key(n), default_lr)) for n in names}


class Adam:
    """Adam with per-parameter base lr times a schedule factor (see the
    module docstring). `params` are (name, tensor) pairs."""

    def __init__(self, params, lr_of: dict, factor_fn: Callable,
                 step_scale: int = 1, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.params = list(params)
        self.lr_of = lr_of
        self.factor_fn = factor_fn
        self.step_scale = step_scale
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.mu = {n: torch.zeros_like(p) for n, p in self.params}
        self.nu = {n: torch.zeros_like(p) for n, p in self.params}

    def zero_grad(self) -> None:
        for _, p in self.params:
            p.grad = None

    @torch.no_grad()
    @spanned("train.adam")
    def step(self) -> None:
        f = float(self.factor_fn(self.count * self.step_scale))
        t = self.count + 1
        bc1 = float(1.0 - _f32(self.b1) ** t)
        bc2 = float(1.0 - _f32(self.b2) ** t)
        for n, p in self.params:
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            mu, nu = self.mu[n], self.nu[n]
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            p.add_(-u * self.lr_of[n] * f)
        self.count = t

    def state_dict(self) -> dict:
        def cpu(d):
            return {n: v.detach().to("cpu").clone() for n, v in d.items()}
        return {"count": self.count, "mu": cpu(self.mu), "nu": cpu(self.nu)}

    def load_state_dict(self, sd: dict) -> None:
        for key in ("mu", "nu"):
            for n, v in sd[key].items():
                getattr(self, key)[n].copy_(v)
        self.count = int(sd["count"])


def get_optimizer(args, model, step_scale: int = 1, names=None) -> Adam:
    """Adam over every parameter of `model` (or the parameters `names`
    lists), with betas (0.9, 0.999) and eps 1e-8. step_scale maps the
    update count to the global iteration the schedule reads (the world
    size under data parallelism)."""
    params = [(n, p) for n, p in model.named_parameters()
              if names is None or n in names]
    return Adam(params, _lr_of([n for n, _ in params], args.training.lr),
                get_schedule_factor(args), step_scale=step_scale)


def current_lr(args, step) -> float:
    """The default group's lr at `step` (for logging)."""
    lr_cfg = args.training.lr
    base = lr_cfg if isinstance(lr_cfg, numbers.Number) else lr_cfg["default"]
    return float(base) * float(get_schedule_factor(args)(step))
