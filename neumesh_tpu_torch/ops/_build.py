"""Build and bind the CUDA kernels of csrc/, and build the host-geometry
library of cpp/.

Each kernel source is compiled by nvcc for sm_90a into its own shared
library with a plain C interface (no PyTorch headers: seconds, not
minutes), under build/neumesh_tpu_torch/ beside the package, at first
use. All sources are compiled in parallel, one nvcc process each. The
library name carries a hash of the sources, so an edit rebuilds. Calls
go through ctypes: every pointer and the stream is a c_void_p; each C
entry returns cudaGetLastError() after its launch and a nonzero code
raises here. The host library (cpp/src/host_lib.cpp, plain C++ for the
CPU) is compiled by g++ the same way, beside them, by build_host.
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
TS = 64             # rows of a tile-stage block (csrc TS)
KS = 64             # K rows per staged weight slice (csrc KS)
KSF = 16            # K rows per staged slice of an f32 layer (csrc KSF)
NPAD = 256          # packed layers' output width, the widest hidden layer
                    # (csrc NPAD)
# the tile blocks' shared-memory plan (csrc RING_MAX, SLOT_BYTES,
# SLOT_F32_BYTES, SMEM_MAX, KL, KSEL), mirrored by
# ops/kernels.py::tile_smem_plan
RING_MAX = 8        # ... of a warp-specialised block, at most
SLOT_BYTES = KS * NPAD * 2
SLOT_F32_BYTES = 3 * KSF * NPAD * 2   # where every hidden layer is f32
SMEM_MAX = 227 * 1024
WS_REGS = {"producer": 24, "consumer": 112}  # csrc PRODUCER_REGS,
                                             # CONSUMER_REGS (setmaxnreg)
# the warp-specialised kernels
WS_KERNELS = ("field_fused", "field_fused_edit", "secant_refine")
KL = 32             # listed kNN picks a row
KSEL = 16           # the frozen secant's neighbours, at most
EDIT_REFS = 4       # field_fused_edit's references, at most (csrc MAX_REFS)
EDIT_ROW = 36       # its per-row floats (csrc EDIT_ROW)
# field_distance.cu's block plan (csrc DT, DT_L2, K1_LANES, DL, SPT_K1,
# SPT_LIST, LIST_C, DIST_SMEM), mirrored by
# ops/kernels.py::distance_block_plan
DT = 128            # threads a distance block
DT_L2 = 32          # ... reading its contexts from L2 at k > 1
DIST_K1_LANES = 8   # threads a sample reading from L2 at k = 1
DL = 8              # the sorted list of the 2 <= k <= DL scan
DIST_SPT = 8        # samples a thread at most, k = 1
DIST_SPT_LIST = 2   # and with the list
LIST_C = 128        # candidates of the list scan, at most
DIST_SMEM = 64 * 1024   # staged contexts of a block, at most
# the tile kernels' timing instantiation (csrc/field_common.cuh Stage): a
# record of len(STAGES) + 3 longs a (block, warpgroup): the cycles of each
# stage, the block's cycles and %globaltimer ns, its tiles
STAGES = ("ctx", "cand", "blend", "emb", "copy", "mma", "sync", "epi",
          "head", "other")

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build",
                         "neumesh_tpu_torch")
SOURCES = {"field_fused": "field_fused.cu",
           "field_distance": "field_distance.cu",
           "field_fused_edit": "field_fused_edit.cu",
           "secant_refine": "secant_refine.cu",
           "surface_locate": "surface_locate.cu",
           "candidate_field": "candidate_field.cu",
           "candidate_bounds": "candidate_bounds.cu"}
# kernel -> (library built from SOURCES, C entry point)
ENTRY = {"field_fused": ("field_fused", "nm_field_fused"),
         "field_distance": ("field_distance", "nm_field_distance"),
         "field_fused_edit": ("field_fused_edit", "nm_field_fused_edit"),
         "secant_refine": ("secant_refine", "nm_secant_refine"),
         "surface_locate": ("surface_locate", "nm_surface_locate"),
         "candidate_field_v3": ("candidate_field", "nm_candidate_field_v3"),
         "candidate_field": ("candidate_field", "nm_candidate_field"),
         "candidate_bounds": ("candidate_bounds", "nm_candidate_bounds")}
HOST_SRC = os.path.join(_PKG, "cpp", "src", "host_lib.cpp")
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


class LayerDesc(ctypes.Structure):
    _fields_ = [("w", ctypes.c_void_p), ("b", ctypes.c_void_p),
                ("K", ctypes.c_int), ("N", ctypes.c_int),
                ("bf16", ctypes.c_int), ("split", ctypes.c_int),
                ("wp", ctypes.c_void_p), ("kp1", ctypes.c_int),
                ("kp", ctypes.c_int)]


class MLPDesc(ctypes.Structure):
    _fields_ = [("l", LayerDesc * MAX_LAYERS), ("n", ctypes.c_int),
                ("pad", ctypes.c_int)]


class FieldArgs(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_void_p)
                 for n in ("xyz", "dirs", "geo", "feat", "out")]
                + [(n, ctypes.c_int)
                   for n in ("feat_bf16", "B", "S", "C", "F", "k", "mode",
                             "md", "mfg", "mft", "mv", "gd", "lowp", "ldx",
                             "nst")]
                + [("w1", ctypes.c_float), ("dens", MLPDesc),
                   ("col", MLPDesc), ("prof", ctypes.c_void_p)])


class EditRef(ctypes.Structure):
    _fields_ = ([("rows", ctypes.c_void_p), ("rot", ctypes.c_void_p)]
                + [(n, ctypes.c_int) for n in ("cd", "lowp", "mft", "mv")]
                + [("col", MLPDesc)])


class EditArgs(ctypes.Structure):
    _fields_ = [("f", FieldArgs), ("ref", EditRef * EDIT_REFS),
                ("nref", ctypes.c_int), ("pad", ctypes.c_int),
                ("painted", ctypes.c_void_p)]


class RayField(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_void_p)
                 for n in ("rays_o", "rays_d", "geo", "feat", "out")]
                + [(n, ctypes.c_int)
                   for n in ("feat_bf16", "R", "B", "T", "C", "F", "k", "md",
                             "mfg", "gd", "lowp", "ldx", "nst")]
                + [("w1", ctypes.c_float), ("tau", ctypes.c_float),
                   ("dens", MLPDesc)])


class SecantArgs(ctypes.Structure):
    _fields_ = ([("f", RayField)]
                + [(n, ctypes.c_void_p)
                   for n in ("d_low", "d_high", "f_low", "f_high", "d_low_w",
                             "d_high_w")]
                + [(n, ctypes.c_int)
                   for n in ("n_iters", "rebracket", "frozen")]
                + [("prof", ctypes.c_void_p)])


class CandArgs(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_void_p)
                 for n in ("xyz", "geo", "pts", "pp", "ind", "vn", "feat",
                           "out_d", "out_dh", "out_feat")]
                + [(n, ctypes.c_int)
                   for n in ("B", "S", "C", "F", "k", "want_dh",
                             "want_feat")]
                + [("w1", ctypes.c_float)])


class BoundsArgs(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_void_p)
                 for n in ("rays_o", "rays_d", "near", "far", "pts",
                           "out_near", "out_far")]
                + [(n, ctypes.c_int) for n in ("R", "T", "C")]
                + [("thr2", ctypes.c_float)])


class LocateArgs(ctypes.Structure):
    _fields_ = ([("f", RayField), ("near", ctypes.c_void_p),
                 ("far", ctypes.c_void_p)]
                + [(n, ctypes.c_int) for n in ("n_steps", "n_secant")])


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
    """The library built from SOURCES[name], every entry point bound."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = _lib_path(name)
            if not os.path.exists(path):
                build_all()
            lib = ctypes.CDLL(path)
            for src, entry in ENTRY.values():
                if src == name:
                    fn = getattr(lib, entry)
                    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
                    fn.restype = ctypes.c_int
                    smem = getattr(lib, entry + "_smem")
                    smem.argtypes = [ctypes.c_void_p]
                    smem.restype = ctypes.c_size_t
            lib.nm_error_string.argtypes = [ctypes.c_int]
            lib.nm_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def launch(name: str, args, operand: torch.Tensor) -> None:
    """Launch kernel `name` on the device of `operand` (its first tensor
    operand), on PyTorch's current stream of that device, whatever device
    is current."""
    src, entry = ENTRY[name]
    lib = _lib(src)
    dev = operand.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, entry)(ctypes.addressof(args),
                                 ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cuda error {rc} "
                           f"({lib.nm_error_string(rc).decode()})")


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("neumesh_tpu_torch: g++ not found (needed to "
                           "build the host library cpp/src/host_lib.cpp)")
    return gxx


def host_lib_path(src: str = HOST_SRC, build_dir: str = BUILD_DIR) -> str:
    """Where build_host puts the library of `src`: named by a hash of the
    source, the g++ flags and the target options -march=native resolves
    to on this machine (a build directory shared with another CPU model
    then gets a library of its own)."""
    target = subprocess.run([_gxx(), "-march=native", "-Q", "--help=target"],
                            capture_output=True, text=True).stdout
    h = hashlib.sha1()
    with open(src, "rb") as fh:
        h.update(fh.read())
    h.update(" ".join(GXX_FLAGS).encode() + target.encode())
    return os.path.join(build_dir, f"libneumesh_host_{h.hexdigest()[:12]}.so")


def build_host(src: str = HOST_SRC, build_dir: str = BUILD_DIR) -> str:
    """The path of the host library built from `src`, compiled with g++
    first if it is missing (into a temporary name, then renamed, so
    processes building at once never load half a file). Raises
    RuntimeError with the compiler's output when g++ is missing or
    fails."""
    if not os.path.exists(src):
        raise RuntimeError(f"neumesh_tpu_torch: host library source {src} "
                           "not found")
    path = host_lib_path(src, build_dir)
    if os.path.exists(path):
        return path
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run([_gxx(), *GXX_FLAGS, "-o", tmp, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {src}:\n{proc.stderr}")
    os.replace(tmp, path)
    return path
