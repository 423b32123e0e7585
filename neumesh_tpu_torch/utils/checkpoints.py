"""Checkpoint files (counterpart of neumesh_tpu/utils/checkpoints.py).

File naming and order as the JAX package keeps them: latest.ckpt
(rolling), {it:08d}.ckpt (backups), final_{it:08d}.ckpt; sorted_ckpts
orders numbered backups first, then latest, then final_*.

Reading: both kinds the JAX package reads.
  - A torch zip (reference `.pt`, and every file the port writes):
    {"model": reference-layout state dict, "optimizer", "global_step",
    "epoch_idx"}.
  - The JAX package's native `.ckpt`: flax's msgpack_serialize of numpy
    trees ({"model": param tree, "optimizer": optax state, ...}), read by
    the stdlib decoder below (no msgpack or flax needed).
Load-time key filtering (ckpt_ignore_keys / ckpt_only_use_keys) keeps the
model's own values for the top-level parameter keys it drops.

Writing: CheckpointIO.save writes the torch zip in the reference layout
(which the JAX package's load_checkpoint reads through its zip sniff),
through a temp file and os.replace.
"""
from __future__ import annotations

import os
import struct
from typing import Iterable, Optional

import numpy as np
import torch

from .state import (load_reference_state, params_from_jax, params_tree,
                    reference_state_dict)


def sorted_ckpts(ckpt_dir: str) -> list:
    """Order: numbered backups ascending, then latest, then final_*."""
    if not os.path.isdir(ckpt_dir):
        return []
    names = [n for n in os.listdir(ckpt_dir)
             if n.endswith((".ckpt", ".pt"))]
    numbered, latest, final = [], [], []
    for n in names:
        stem = os.path.splitext(n)[0]
        if stem.startswith("final_"):
            final.append(n)
        elif stem == "latest":
            latest.append(n)
        else:
            numbered.append(n)
    numbered.sort()
    final.sort()
    return [os.path.join(ckpt_dir, n) for n in numbered + latest + final]


# ---------------------------------------------------------------------------
# msgpack (flax.serialization) reader
# ---------------------------------------------------------------------------

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


class _Reader:
    """A msgpack decoder: maps, arrays, str (str), bin (bytes), ints,
    floats, nil/bool, and ext types through `ext`."""

    def __init__(self, data: bytes, ext=None):
        self.b = memoryview(data)
        self.i = 0
        self.ext = ext

    def _take(self, n):
        if self.i + n > len(self.b):
            raise ValueError("msgpack: truncated data")
        out = self.b[self.i:self.i + n]
        self.i += n
        return out

    def _unpack(self, fmt):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self._take(size))[0]

    def read(self):
        c = self._take(1)[0]
        if c <= 0x7f:
            return c
        if c >= 0xe0:
            return c - 0x100
        if 0x80 <= c <= 0x8f:
            return self._map(c & 0x0f)
        if 0x90 <= c <= 0x9f:
            return self._array(c & 0x0f)
        if 0xa0 <= c <= 0xbf:
            return str(self._take(c & 0x1f), "utf-8")
        fixed = {0xc0: None, 0xc2: False, 0xc3: True}
        if c in fixed:
            return fixed[c]
        fmt = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I",
               0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
        if c in fmt:
            return self._unpack(fmt[c])
        lens = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I"}
        if c in lens:
            return bytes(self._take(self._unpack(lens[c])))
        lens = {0xd9: ">B", 0xda: ">H", 0xdb: ">I"}
        if c in lens:
            return str(self._take(self._unpack(lens[c])), "utf-8")
        if c in (0xdc, 0xdd):
            return self._array(self._unpack(">H" if c == 0xdc else ">I"))
        if c in (0xde, 0xdf):
            return self._map(self._unpack(">H" if c == 0xde else ">I"))
        if 0xd4 <= c <= 0xd8:
            return self._ext(1 << (c - 0xd4))
        if c in (0xc7, 0xc8, 0xc9):
            return self._ext(self._unpack({0xc7: ">B", 0xc8: ">H",
                                           0xc9: ">I"}[c]))
        raise ValueError(f"msgpack: unknown type byte 0x{c:02x}")

    def _array(self, n):
        return [self.read() for _ in range(n)]

    def _map(self, n):
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def _ext(self, n):
        code = self._unpack(">b")
        data = bytes(self._take(n))
        if self.ext is None:
            raise ValueError(f"msgpack: ext type {code} without a decoder")
        return self.ext(code, data)


def msgpack_unpackb(data: bytes, ext=None):
    """Decode one msgpack object; the whole buffer must be consumed."""
    r = _Reader(data, ext)
    out = r.read()
    if r.i != len(r.b):
        raise ValueError("msgpack: trailing data")
    return out


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    shape, dtype_name, buf = msgpack_unpackb(data)
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    if dtype_name == "bfloat16":
        bits = np.frombuffer(buf, dtype=np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(
        shape).copy()


def _flax_ext(code, data):
    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    if code == _EXT_COMPLEX:
        re_, im = msgpack_unpackb(data)
        return complex(re_, im)
    raise ValueError(f"msgpack: unknown ext type {code}")


def _unchunk(tree):
    """flax splits arrays above its chunk size into
    {"__msgpack_chunked_array__", "shape", "chunks"} dicts."""
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            shape = tuple(tree["shape"][str(i)]
                          for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def msgpack_restore(data: bytes):
    """flax.serialization.msgpack_restore in the standard library: nested
    dicts (lists become {"0": ..} dicts in flax's state dicts) of numpy
    arrays and python scalars."""
    return _unchunk(msgpack_unpackb(data, _flax_ext))


# ---------------------------------------------------------------------------
# loading
# ---------------------------------------------------------------------------

def load_checkpoint(path: str) -> dict:
    """A torch zip (reference `.pt`, the port's `.ckpt`) as a dict of CPU
    tensors and numbers, or a native msgpack `.ckpt` as numpy trees."""
    with open(path, "rb") as f:
        head = f.read(4)
    if head[:2] == b"PK":
        return torch.load(path, map_location="cpu", weights_only=True)
    with open(path, "rb") as f:
        data = f.read()
    try:
        ckpt = msgpack_restore(data)
    except (ValueError, struct.error, UnicodeDecodeError) as e:
        raise ValueError(f"{path}: not a checkpoint (neither a torch zip "
                         f"nor a msgpack tree: {e})") from e
    if not isinstance(ckpt, dict):
        raise ValueError(f"{path}: not a checkpoint (neither a torch zip "
                         "nor a msgpack tree)")
    return ckpt


def restore_into(template, loaded):
    """`loaded` in the structure of `template`: dicts by key, lists and
    tuples from lists or from {"0": ..} dicts; array leaves as numpy of
    the template's shape and dtype."""
    if isinstance(template, dict):
        return {k: restore_into(template[k], loaded[k]) for k in template}
    if isinstance(template, (list, tuple)):
        items = ([loaded[str(i)] for i in range(len(template))]
                 if isinstance(loaded, dict) else list(loaded))
        out = [restore_into(t, v) for t, v in zip(template, items)]
        return out if isinstance(template, list) else tuple(out)
    if not hasattr(template, "shape"):
        return loaded
    arr = np.asarray(loaded.numpy() if hasattr(loaded, "numpy") else loaded)
    if arr.shape != tuple(template.shape):
        raise ValueError(f"shape mismatch restoring checkpoint: {arr.shape} "
                         f"vs {tuple(template.shape)}")
    return arr.astype(template.dtype)


def is_reference_layout(state: dict) -> bool:
    """A reference state dict (dotted keys with weight_v / weight) rather
    than a JAX parameter tree."""
    return any(str(k).endswith((".weight_v", ".weight")) for k in state)


def _top_key(k: str) -> str:
    return str(k).split(".")[0]


def _filter(keys, ignore_keys, only_use_keys):
    if ignore_keys and only_use_keys:
        raise ValueError("ckpt_ignore_keys and ckpt_only_use_keys are "
                         "exclusive")
    if only_use_keys:
        return {k for k in keys if _top_key(k) in only_use_keys}
    return {k for k in keys if _top_key(k) not in (ignore_keys or ())}


def load_model_state(state: dict, model, ignore_keys=None,
                     only_use_keys=None) -> None:
    """Copy a checkpoint's "model" entry into `model` (NeuMesh or NeuS),
    in either layout; a top-level key the filters drop keeps the model's
    own value."""
    if is_reference_layout(state):
        merged = reference_state_dict(model)
        for k in _filter(merged, ignore_keys, only_use_keys):
            if k in state:
                merged[k] = state[k]
        load_reference_state(merged, model)
        return
    template = params_tree(model)
    kept = _filter(template, ignore_keys, only_use_keys)
    merged = {k: (state[k] if k in kept and k in state else v)
              for k, v in template.items()}
    params_from_jax(restore_into(template, merged), model)


class CheckpointIO:
    """Checkpoint directory: writes the port's checkpoints, reads both
    kinds."""

    def __init__(self, checkpoint_dir: str = "./chkpts"):
        self.checkpoint_dir = checkpoint_dir

    def save(self, filename: str, model, optimizer=None,
             global_step: int = 0, epoch_idx: int = 0) -> str:
        """{"model": reference state dict, "optimizer", "global_step",
        "epoch_idx"} as a torch zip, written to a temp file and moved into
        place."""
        if not os.path.isabs(filename):
            filename = os.path.join(self.checkpoint_dir, filename)
        os.makedirs(os.path.dirname(os.path.abspath(filename)),
                    exist_ok=True)
        payload = {"model": reference_state_dict(model),
                   "global_step": int(global_step),
                   "epoch_idx": int(epoch_idx)}
        if optimizer is not None:
            payload["optimizer"] = optimizer
        tmp = filename + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, filename)
        return filename

    def load_file(self, filepath: str, model=None,
                  ignore_keys: Optional[Iterable[str]] = None,
                  only_use_keys: Optional[Iterable[str]] = None) -> dict:
        """Load a checkpoint (a relative path missing from the working
        directory is looked up in checkpoint_dir); with `model`, its
        "model" entry is copied into the model's parameters through the
        key filters. Returns the checkpoint dict."""
        if not os.path.isabs(filepath) and not os.path.exists(filepath):
            cand = os.path.join(self.checkpoint_dir, filepath)
            if os.path.exists(cand):
                filepath = cand
        ckpt = load_checkpoint(filepath)
        if model is not None:
            load_model_state(ckpt.get("model", ckpt), model, ignore_keys,
                             only_use_keys)
        return ckpt

    def latest_path(self) -> Optional[str]:
        ckpts = sorted_ckpts(self.checkpoint_dir)
        return ckpts[-1] if ckpts else None


__all__ = ["CheckpointIO", "load_checkpoint", "load_model_state",
           "msgpack_restore", "restore_into", "sorted_ckpts"]
