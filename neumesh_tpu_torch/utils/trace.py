"""Spans and counters of the port: its one tracing facility.

Spans name the stages of a frame or a training step in a torch.profiler
trace. span(name) opens torch.profiler.record_function("nm." + name) while
a profiler session is active, and a shared null context otherwise: a flag
read, where a record_function costs tens of times more even with no
profiler running. So spans appear in any session, the benchmark's traced
run, a training.profile_dir run or a caller's own, as user_annotation
events of the same Kineto trace as the CUDA kernels and runtime calls: on
the device trace's clock, nested on their thread.

Counters live in one registry and are always on. count adds a number the
host already holds (a shape, a call); count_device adds a device tensor's
sum to a device-side int64 accumulator, only while a profiler session is
active, so it never waits for the device and costs nothing otherwise.
counters() reads everything, the device accumulators with one sync per
device. CounterView shows part of the registry as a mapping
(ops.kernels.LAUNCHES).

Spans (each "nm." + name):
  render.frame, render.rays, render.assemble       the frame entries
  ctx.build, ctx.bounds, weights.fold               contexts and weights
  weights.pack                                      a kernel call's weights
  sync.indicator_weight                             a bound model's w1 read
  volume.coarse, volume.upsample, volume.root, volume.shade
  surface.scan, surface.secant, surface.shade
  train.step, train.forward, train.render, train.loss, train.backward,
  train.grad_norm, train.adam, train.teacher, field.nablas
Counters:
  host_read               each call that makes the host wait for the
                          device's queue: a read back to the host, or a
                          copy from pageable host memory (it synchronises
                          the stream)
  secant.rays_refined     rays handed to the secant (host)
  secant.rays_bracketed   of those, the rays with a bracket (device)
  launch.<kernel>.<mode>  kernel launches (ops.kernels.LAUNCHES)
"""
from __future__ import annotations

import contextlib
import functools
from collections.abc import Mapping

import torch
from torch.autograd import profiler as _autograd_profiler

PREFIX = "nm."
_NULL = contextlib.nullcontext()

# host counters by name; device accumulators (int64 scalars) by name
COUNTS: dict = {}
_DEVICE: dict = {}

if hasattr(_autograd_profiler, "_is_profiler_enabled"):
    def enabled() -> bool:
        """Whether a torch.profiler session is active (the flag torch keeps
        for fast Python checks)."""
        return _autograd_profiler._is_profiler_enabled
else:
    enabled = torch._C._autograd._profiler_enabled


def span(name: str):
    """A context manager: the block as span "nm." + name while a profiler
    session is active, else a shared null context."""
    if not enabled():
        return _NULL
    return torch.profiler.record_function(PREFIX + name)


def spanned(name: str):
    """Decorator: every call of the function inside span(name)."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add n to the host counter `name`."""
    COUNTS[name] = COUNTS.get(name, 0) + int(n)


def count_device(name: str, t: torch.Tensor) -> None:
    """Add t.sum() to the device counter `name` while a profiler session
    is active; launches nothing and reads nothing otherwise."""
    if not enabled():
        return
    s = t.sum(dtype=torch.int64)
    acc = _DEVICE.get(name)
    _DEVICE[name] = s if acc is None else acc + s.to(acc.device)


def counters() -> dict:
    """A snapshot of every counter {name: int}; the device accumulators
    read with one sync per device."""
    out = dict(COUNTS)
    by_dev = {}
    for name, acc in _DEVICE.items():
        by_dev.setdefault(acc.device, []).append(name)
    for names in by_dev.values():
        vals = torch.stack([_DEVICE[n] for n in names]).tolist()
        for n, v in zip(names, vals):
            out[n] = out.get(n, 0) + int(v)
    return out


def reset(prefix: str = "") -> None:
    """Zero every counter whose name starts with prefix (all by default);
    host counters keep their names."""
    for name in COUNTS:
        if name.startswith(prefix):
            COUNTS[name] = 0
    for name in [n for n in _DEVICE if n.startswith(prefix)]:
        del _DEVICE[name]


class CounterView(Mapping):
    """The host counters named prefix + key, for the given keys, as a
    read-only mapping key -> count (each declared at 0)."""

    def __init__(self, prefix: str, keys):
        self._prefix = prefix
        self._keys = tuple(keys)
        for k in self._keys:
            COUNTS.setdefault(prefix + k, 0)

    def __getitem__(self, key):
        if key not in self._keys:
            raise KeyError(key)
        return COUNTS[self._prefix + key]

    def __iter__(self):
        return iter(self._keys)

    def __len__(self) -> int:
        return len(self._keys)

    def __repr__(self) -> str:
        return repr(dict(self))
