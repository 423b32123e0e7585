"""Build and bind the CUDA kernels of csrc/.

Each kernel source is compiled by nvcc for sm_90a into its own shared
library with a plain C interface (no PyTorch headers: seconds, not
minutes), under build/neumesh_tpu_torch/ beside the package, at first
use. All sources are compiled in parallel, one nvcc process each. The
library name carries a hash of the sources, so an edit rebuilds. Calls
go through ctypes: every pointer and the stream is a c_void_p; each C
entry returns cudaGetLastError() after its launch and a nonzero code
raises here.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

MAX_LAYERS = 8      # csrc/field_common.cuh MAX_LAYERS
NT = 256            # threads per block (csrc/field_common.cuh NT)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build",
                         "neumesh_tpu_torch")
SOURCES = {"field_fused": "field_fused.cu",
           "secant_refine": "secant_refine.cu"}
ENTRY = {"field_fused": "nm_field_fused",
         "secant_refine": "nm_secant_refine"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


class LayerDesc(ctypes.Structure):
    _fields_ = [("w", ctypes.c_void_p), ("b", ctypes.c_void_p),
                ("K", ctypes.c_int), ("N", ctypes.c_int),
                ("bf16", ctypes.c_int), ("split", ctypes.c_int)]


class MLPDesc(ctypes.Structure):
    _fields_ = [("l", LayerDesc * MAX_LAYERS), ("n", ctypes.c_int),
                ("pad", ctypes.c_int)]


class FieldArgs(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_void_p)
                 for n in ("xyz", "dirs", "geo", "feat", "out")]
                + [(n, ctypes.c_int)
                   for n in ("feat_bf16", "B", "S", "C", "F", "k", "mode",
                             "md", "mfg", "mft", "mv", "gd", "lowp", "ldx")]
                + [("w1", ctypes.c_float), ("dens", MLPDesc),
                   ("col", MLPDesc)])


class SecantArgs(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_void_p)
                 for n in ("rays_o", "rays_d", "d_low", "d_high", "f_low",
                           "f_high", "d_low_w", "d_high_w", "geo", "feat",
                           "out")]
                + [(n, ctypes.c_int)
                   for n in ("feat_bf16", "R", "B", "T", "C", "F", "k",
                             "n_iters", "md", "mfg", "gd", "lowp", "ldx",
                             "rebracket", "frozen")]
                + [("w1", ctypes.c_float), ("tau", ctypes.c_float),
                   ("dens", MLPDesc)])


_LIBS: dict = {}
_LOCK = threading.Lock()
BUILD_LOG: dict = {}     # kernel -> {"seconds": s, "ptxas": text}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("neumesh_tpu_torch: nvcc not found (CUDA toolkit "
                       "needed to build the kernels)")


def _lib_path(name: str) -> str:
    h = hashlib.sha1()
    for f in sorted(os.listdir(CSRC)):
        if f.endswith((".cu", ".cuh")):
            with open(os.path.join(CSRC, f), "rb") as fh:
                h.update(f.encode() + fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:12]}.so")


def build_all() -> dict:
    """Compile every missing kernel library, all nvcc processes started
    together; returns {name: seconds} for the libraries built."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in SOURCES:
        path = _lib_path(name)
        if os.path.exists(path):
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path, time.perf_counter())
    built = {}
    for name, (proc, tmp, path, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {SOURCES[name]}:\n{log}")
        os.replace(tmp, path)
        built[name] = time.perf_counter() - t0
        BUILD_LOG[name] = {"seconds": built[name], "ptxas": log}
    return built


def _lib(name: str):
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = _lib_path(name)
            if not os.path.exists(path):
                build_all()
            lib = ctypes.CDLL(path)
            fn = getattr(lib, ENTRY[name])
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            lib.nm_error_string.argtypes = [ctypes.c_int]
            lib.nm_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def launch(name: str, args) -> None:
    """Launch kernel `name` on PyTorch's current stream."""
    lib = _lib(name)
    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(lib, ENTRY[name])(ctypes.addressof(args),
                                   ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cuda error {rc} "
                           f"({lib.nm_error_string(rc).decode()})")
