#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (neumesh_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase below, one card

Phases (any failure exits non-zero; nothing falls back to the CPU):
 1. device: CUDA required; card name and power limit; build every kernel
    from neumesh_tpu_torch/csrc (nvcc, all sources in parallel), timed;
    the [build] lines give each kernel function's registers and spills
    (ptxas), its HGMMA (wgmma) instructions (cuobjdump), and, after the
    main paths, each kernel's dynamic shared memory per block.
 2. the port's paths at full width: the 163,842-vertex icosphere NeuMesh
    (W=256, D_density=3, D_color=4, dims 32/32, multires 8/2/2/4) with
    parameters from a numpy seed, written as a reference-format .pt and
    .ply and loaded back, rendered in eight structures (STRUCTURES): the
    root-anchored bf16 volume serving structure and the reference f32
    volume structure; the surface render at the bf16 serving knobs
    (composed scan + fused secant, in f32 too, with the fused
    surface_locate, with the micro-composite shade); a model without
    nablas input in the surface and the volume serving structures. Each
    structure is rendered once with the launch counters set to 0 just
    before and read just after; every kernel mode it must run is asserted
    to have launched.
 3. every kernel mode against its plain PyTorch version on the card: every
    call each structure's render makes, as it made it, and more variants
    (f32, bf16, bf16 with selective-f32 layers) on the volume serving
    structure's inputs; candidate_field (v2, on no path) at R=4096, S=64,
    C=96 built from the no-nablas volume's contexts; kernel and plain
    times, roofline bound.
 4. 64x64 crops of every structure rendered through the kernels and
    through the plain versions, PSNR of rgb (and of the surface normals)
    between them; frame time, Mrays/s, peak memory and traced idle share
    of every structure.
 5. the render CLI (neumesh_tpu_torch.cli.render.main) on a 4-view
    synthetic DTU-format scene written by the port (128x128 PNGs,
    cameras.npz), with the phase-2 model's .pt and .ply and a config made
    from configs/neumesh_dtu_scan63.yaml, 2 spiral views a case
    (CLI_CASES): the shipped defaults (per-ray contexts, use_pallas off,
    f32), use_pallas on, the surface mode, the no-nablas model, volume
    with 128-ray scanline tiles. Each case renders once with the launch
    counters set to 0 just before and read just after (its kernel modes
    asserted; ms/view, Mrays/s, frame peak memory), then one view again
    with every kernel call recorded: each call replayed against its plain
    version, each (kernel, mode, samples a context) timed with its bound
    and the share of live rows in its blocks; the written PNGs decoded by
    the port's reader equal the returned frames.
 6. training (neumesh_tpu_torch.cli.train.main) on the same scene, at
    the flagship widths of the shipped configs: the NeuS teacher from
    configs/neus_dtu_scan63.yaml, then the NeuMesh student from
    configs/neumesh_dtu_scan63.yaml on the phase-2 icosphere, distilled
    from that teacher's latest.ckpt with every loss on, TRAIN_ITERS
    iterations each (i_log 1, validation at the last iteration). The
    launch counters are set to 0 just before the NeuMesh run and read just
    after. Checks: every loss term finite at every step; final_*.ckpt
    loads back and the render CLI renders one 64x64 view from it; the
    teacher's ln_s bit-equal to its checkpoint; every field_fused call of
    one training step against its plain version (f32 tolerances); the
    first step's total loss and global grad norm through the kernels and
    through the plain versions (TF32 off) within TRAIN_REL. Reports ms/it
    (median after TRAIN_WARMUP iterations) and rays/s as the loop logs
    them, a step's peak memory above the resident models, the device-time
    split of one NeuMesh step (CUDA events; idle share from the profiler),
    and the field_fused density time per call at 512 x 64 and 512 x 16.
 7. the pipeline after training: (a) on phase 6's latest.ckpt: the grid SDF
    of the teacher and of the full-width student on the card against the
    same model on the CPU on a 32^3 grid (f32 tolerances); the teacher
    through the extraction CLI (neumesh_tpu_torch.cli.extract_mesh.main)
    at N_grid 256 (grid, marching and colour ms, vertex and triangle
    counts; a finite mesh whose every edge two triangles share, open edges
    only on the grid box's faces); the student's 128^3 grid, timed (20
    steps from random codes leave it no zero level set); after (b), the
    gate's trained student through the CLI at 128^3 with the same mesh
    checks. (b) the port's quality gate
    (neumesh_tpu_torch.tools.quality_gate.run) on the sphere scene at
    PIPE_ITERS iterations a model: NeuS -> 96^3 mesh ->
    NeuMesh -> the four modes (volume_f32, volume_bf16, surface_f32,
    surface_fast), each counted alone (its kernel modes asserted); ms/it,
    rays/s, ms per view, every PSNR / SSIM and the gate JSON, all finite
    (the gates need not hold at this length); TF32 off after its training.
    (c) every kernel call of the four modes and of one distillation step
    on the trained weights replayed against its plain version (the surface
    modes' shading call on the hit rows; its rows at the missed rays'
    placeholder point, which the render discards, reported beside it:
    live_rows). (d) the
    eval CLI on two views of the gate scene with --save_renders: the PNGs
    equal the renders, the summary JSON its keys. (e) one LPIPS call of
    two 128x128 images on the card with seeded synthetic VGG16 weights
    against the same call on the CPU (LPIPS_REL).
Prints the card line, one {"cli": {...}} line, one {"training": {...}}
line, one {"pipeline": {...}} line, one {"kernels": [...]} line (each row
with its design, "wgmma" or "simt", and the launches of the gate modes in
launches_by_structure), and last {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

H100_BF16_FLOPS = 989e12        # dense tensor-core bf16
H100_F32_FLOPS = 67e12          # CUDA-core fp32
H100_BYTES = 3.35e12            # HBM3

TOL = {"f32": dict(atol=2e-5, rtol=1e-4, frac=0.99),
       "f32_nabla": dict(atol=1e-4, rtol=1e-4, frac=0.99),
       "bf16": dict(atol=2e-3, rtol=0.0, frac=0.97)}
# surface_locate: share of rays whose mask bits agree with the plain version
LOCATE_MASK_AGREE = {"bf16": 0.999, "f32": 1.0}

KERNELS = ("field_fused", "secant_refine", "surface_locate",
           "candidate_field_v3", "candidate_field")
# a row's design: its kernel runs the tensor-core tile stage, bf16 MLP
# layers on wgmma ("wgmma"), or it has no MLP and everything runs on the
# CUDA cores ("simt")
WGMMA_ROWS = {("field_fused", m) for m in ("density", "density_nabla",
                                            "full")} | \
    {("secant_refine", m) for m in ("plain", "rebracket", "frozen",
                                    "frozen_rebracket")} | \
    {("surface_locate", m) for m in ("bf16", "f32")}
SOURCES = {
    "field_fused": ("neumesh_tpu_torch/csrc/field_fused.cu",
                    "neumesh_tpu/ops/pallas_kernels.py:645"),
    "secant_refine": ("neumesh_tpu_torch/csrc/secant_refine.cu",
                      "neumesh_tpu/ops/pallas_kernels.py:1128"),
    "surface_locate": ("neumesh_tpu_torch/csrc/surface_locate.cu",
                       "neumesh_tpu/ops/pallas_kernels.py:952"),
    "candidate_field_v3": ("neumesh_tpu_torch/csrc/candidate_field.cu",
                           "neumesh_tpu/ops/pallas_kernels.py:203"),
    "candidate_field": ("neumesh_tpu_torch/csrc/candidate_field.cu",
                        "neumesh_tpu/ops/pallas_kernels.py:60"),
}

# root-anchored volume serving structure (the JAX bench's VOL settings)
VOL_MODEL = dict(tile_kp_per_probe=12, tile_cell_budget=64, scan_knn_k=1)
VOL_RENDER = dict(root_anchored=True, root_n_fine=8, root_steps=16,
                  root_secant=3, root_win_frac=0.25, color_topk=4,
                  ray_tile=128, tile_max_candidates=128, N_samples=64,
                  N_importance=64, N_upsample_iters=4,
                  reuse_upsample_sdf=True, detailed_output=False)
# reference structure: 64 coarse + 4x16 up-sampling, colour at midpoints
REF_RENDER = dict(ray_tile=128, tile_max_candidates=128, N_samples=64,
                  N_importance=64, N_upsample_iters=4,
                  reuse_upsample_sdf=True, detailed_output=False)
# surface serving knobs (the JAX bench's SERVING, TPU-only knobs dropped)
SURF_MODEL = dict(tile_kp_per_probe=8, f32_layers=("d0", "dh", "c0", "ch"),
                  secant_full_precision=False, scan_knn_k=1,
                  tile_cell_budget=64)
SURF_RENDER = dict(ray_tile=128, scan_mode="distance",
                   tile_max_candidates=128, N_steps=16, N_secant_steps=3)
SHADE = dict(shade_composite=8, shade_topk=4, shade_win_frac=0.25)
FLAGSHIP = dict(D_density=3, D_color=4, W=256, geometry_dim=32,
                color_dim=32, multires_view=4, multires_d=8, multires_fg=2,
                multires_ft=2, enable_nablas_input=True,
                learn_indicator_weight=True, speed_factor=10.0)

# model: (serving knobs, bf16?, other knobs)
MODELS = {
    "vol_bf16": (VOL_MODEL, True, {}),
    "vol_f32": (VOL_MODEL, False, {}),
    "surf_bf16": (SURF_MODEL, True, {}),
    "surf_f32": (SURF_MODEL, False, {}),
    "surf_locate": (SURF_MODEL, True, dict(use_fused_locate=True)),
    "nonablas_surf": (SURF_MODEL, True, dict(enable_nablas_input=False)),
    "nonablas_vol": (VOL_MODEL, True, dict(enable_nablas_input=False)),
}
FF, SR = "field_fused", "secant_refine"
_SURF_MODES = {(FF, "distance"), (SR, "rebracket"), (FF, "full")}
# structure: (model, renderer, frame side, render kwargs, kernel modes it
# must launch, timing reps)
STRUCTURES = {
    "serving_bf16": ("vol_bf16", "volume", 256, VOL_RENDER,
                     {(FF, "distance"), (FF, "density"), (FF, "full"),
                      (SR, "rebracket")}, 5),
    "reference_f32": ("vol_f32", "volume", 128, REF_RENDER,
                      {(FF, "density"), (FF, "full")}, 3),
    "surface_fast": ("surf_bf16", "surface", 256, SURF_RENDER, _SURF_MODES,
                     5),
    "surface_f32": ("surf_f32", "surface", 128, SURF_RENDER, _SURF_MODES, 5),
    "surface_locate": ("surf_locate", "surface", 256, SURF_RENDER,
                       {("surface_locate", "bf16"), (FF, "full")}, 5),
    "surface_shade": ("surf_bf16", "surface", 256, dict(SURF_RENDER, **SHADE),
                      {(FF, "density"), (FF, "full"), (FF, "density_nabla")},
                      5),
    "nonablas_surface": ("nonablas_surf", "surface", 256, SURF_RENDER,
                         {("candidate_field_v3", "ds_feat"),
                          (FF, "density_nabla")}, 5),
    "nonablas_volume": ("nonablas_vol", "volume", 256, VOL_RENDER,
                        {("candidate_field_v3", "ds_feat")}, 5),
}
# the render CLI's cases: (flags, the model with nablas input?, kernel modes
# it must launch). Per-ray contexts unless --ray_tile; without use_pallas
# only the up-sampling density is a kernel (forward_density_only_nograd)
CLI_CASES = {
    "cli_defaults": ([], True, {(FF, "density")}),
    "cli_pallas": (["--model:use_pallas", "true"], True,
                   {(FF, "density"), (FF, "density_nabla"), (FF, "full")}),
    "cli_surface": (["--render_mode", "surface", "--model:use_pallas",
                     "true"], True,
                    {(FF, "density"), (SR, "plain"), (FF, "full")}),
    "cli_nonablas": (["--model:use_pallas", "true",
                      "--model:enable_nablas_input", "false"], False,
                     {(FF, "density"), (FF, "density_nabla"),
                      ("candidate_field_v3", "ds_feat")}),
    "cli_tile128": (["--ray_tile", "128"], True, {(FF, "density")}),
}
CLI_SIDE, CLI_VIEWS = 128, 2
# training phase: iterations a run (depth cut; widths as shipped), warm-up
# iterations left out of the ms/it median, the kernel-vs-plain agreement of
# the first step's loss and grad norm (relative), the render of the trained
# student (side of the view)
TRAIN_ITERS, TRAIN_WARMUP, TRAIN_REL, TRAIN_RENDER_SIDE = 20, 3, 1e-4, 64
# rows of a kernel's block: samples (rays) of one context
BLOCK_ROWS = {"field_fused": 64, "secant_refine": 64, "surface_locate": 64,
              "candidate_field_v3": 32, "candidate_field": 32}
# crops through the plain versions: least PSNR of rgb (and of the surface
# normals, peak-to-peak 2) kernel vs plain, by the structure's model dtype
CROP_PSNR = {"bf16": 30.0, "f32": 55.0}
# the structure whose per-frame count a kernel's `launches` reports: the
# volume serving structure for the kernels of the first slice (as that
# slice printed it), the structure that brought each later kernel onto a
# path; candidate_field (v2) is on none
LAUNCHES_OF = {"field_fused": "serving_bf16", "secant_refine": "serving_bf16",
               "surface_locate": "surface_locate",
               "candidate_field_v3": "nonablas_surface",
               "candidate_field": None}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=5):
    import torch
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def compare(got, want, tol):
    """(max |err|, least share over the outputs of values within
    atol + rtol |want|): each output array is held to the share alone."""
    import torch
    err_max, share = 0.0, 1.0
    for g, w in zip(got, want):
        g, w = g.float().reshape(-1), w.float().reshape(-1)
        if not bool(torch.isfinite(g).all()):
            raise AssertionError("kernel produced non-finite values")
        err = (g - w).abs()
        ok = err <= tol["atol"] + tol["rtol"] * w.abs()
        err_max = max(err_max, float(err.max()))
        share = min(share, float(ok.float().mean()))
    return err_max, share


def mode_of(name, kw):
    """The launch-counter mode of a kernel call."""
    from neumesh_tpu_torch.ops import kernels
    if name == "field_fused":
        return kw.get("want", "density")
    if name == "secant_refine":
        return kernels.secant_mode(kw.get("d_low_w") is not None,
                                   kw.get("frozen_knn", False))
    if name == "surface_locate":
        return "f32" if kw.get("dtype") is None else "bf16"
    return kernels.candidate_mode(kw.get("want_dh", True),
                                  kw.get("want_feat", True))


@contextlib.contextmanager
def swap_kernels(make):
    """Replace every kernel wrapper by make(name, wrapper) for the block."""
    from neumesh_tpu_torch.ops import kernels
    saved = {n: getattr(kernels, n) for n in KERNELS}
    for n in KERNELS:
        setattr(kernels, n, make(n, saved[n]))
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(kernels, n, f)


def plain_on_card():
    """Route the model's kernel calls to the plain versions (the crop
    reference); the main path never does this."""
    from neumesh_tpu_torch.ops import kernels
    return swap_kernels(lambda n, f: getattr(kernels, n + "_plain"))


def record_calls(calls):
    """Append (kernel, mode, args, kw) of every kernel call."""
    def make(name, fn):
        def rec(*a, **kw):
            calls.append((name, mode_of(name, kw), a, dict(kw)))
            return fn(*a, **kw)
        return rec
    return swap_kernels(make)


# ---------------------------------------------------------------------------
# roofline bound from the shapes of one call
# ---------------------------------------------------------------------------

def _mlp_flops(ws):
    """(bf16 flops, f32 flops) of the weight matrices in ws."""
    import torch
    bf, f32 = 0.0, 0.0
    for w in ws:
        if w.dim() == 2 and w.shape[0] > 1:
            f = 2.0 * w.shape[0] * w.shape[1]
            if w.dtype == torch.bfloat16:
                bf += f
            else:
                f32 += f
    return bf, f32


def _nbytes(ts):
    return float(sum(t.numel() * t.element_size() for t in ts
                     if t is not None and hasattr(t, "numel")))


def field_bound(args, kw):
    xyz, geo, feat = args[0], args[1], args[2]
    dens_ws = args[4] if len(args) > 4 else kw.get("dens_ws", ())
    col_ws = args[5] if len(args) > 5 else kw.get("col_ws")
    dirs = args[6] if len(args) > 6 else kw.get("dirs")
    want, k = kw.get("want", "density"), kw.get("k", 8)
    B, S, _ = xyz.shape
    C, F = geo.shape[2], feat.shape[-1]
    n = float(B * S)
    f32 = n * C * (10 + (k if k > 1 else 1))          # d2 + selection
    bf = 0.0
    n_out = {"distance": 1, "density": 1, "density_nabla": 4, "full": 7}
    ins = [xyz, geo]
    if want != "distance":
        f32 += n * (30 * k + 2 * k * F)                # interp + blend
        b1, f1 = _mlp_flops(dens_ws)
        if want != "density":
            # the tangent dD/dh: w0d, the hidden layers and the head; fg and
            # its embedding (the w0f rows) do not depend on h
            bt, ft = _mlp_flops((dens_ws[0], *dens_ws[3:]))
            b1, f1 = b1 + bt, f1 + ft
        bf, f32 = bf + n * b1, f32 + n * f1
        ins += [feat, *dens_ws]
    if want == "full":
        b2, f2 = _mlp_flops(col_ws)
        bf, f32 = bf + n * b2, f32 + n * f2
        ins += [dirs, *col_ws]
    nbytes = _nbytes(ins) + n * 4 * n_out[want]
    return _bound(bf, f32, nbytes)


def secant_bound(args, kw):
    rays_o, geo, feat, dens_ws = args[0], args[6], args[7], args[9]
    R = rays_o.shape[0]
    C, F = geo.shape[2], feat.shape[-1]
    k = kw.get("k", 8)
    evals = kw.get("n_iters", 6) + (2 if kw.get("d_low_w") is not None
                                    else 0)
    b1, f1 = _mlp_flops(dens_ws)
    per_eval = (30 * k + 2 * k * F) + f1
    if kw.get("frozen_knn"):
        f32 = R * (C * (20 + k) + evals * per_eval)
    else:
        f32 = R * evals * (C * (10 + k) + per_eval)
    bf = R * evals * b1
    nbytes = _nbytes([geo, feat, *dens_ws]) + R * 4 * (6 + 6 + 1)
    return _bound(bf, f32, nbytes)


def locate_bound(args, kw):
    """n_steps distance evaluations and 2 + n_secant density evaluations
    per ray."""
    rays_o, geo, feat, dens_ws = args[0], args[4], args[5], args[7]
    R = rays_o.shape[0]
    C, F = geo.shape[2], feat.shape[-1]
    k = kw.get("k", 8)
    interp = C * (10 + k) + 30 * k
    n_dens = 2 + kw.get("n_secant", 6)
    b1, f1 = _mlp_flops(dens_ws)
    f32 = R * (kw.get("n_steps", 24) * interp
               + n_dens * (interp + 2 * k * F + f1))
    bf = R * n_dens * b1
    # rays_o, rays_d, near, far in; four planes out
    nbytes = _nbytes([geo, feat, *dens_ws]) + R * 4 * (3 + 3 + 2 + 4)
    return _bound(bf, f32, nbytes)


def candidate_bound(name, args, kw):
    """Selection and interpolation over the context's C candidates, plus
    2 k F for the feature blend."""
    xyz = args[0]
    n = float(xyz.shape[0] * xyz.shape[1])
    k = kw.get("k", 8)
    want_dh, want_feat = kw.get("want_dh", True), kw.get("want_feat", True)
    if name == "candidate_field_v3":
        C, ins, feat = args[1].shape[2], [xyz, args[1]], args[2]
    else:
        C, ins, feat = args[1].shape[1], list(args[:5]), args[5]
    F = feat.shape[-1] if want_feat else 0
    f32 = n * (C * (10 + k) + 30 * k + 2 * k * F)
    if want_feat:
        ins.append(feat)
    nbytes = _nbytes(ins) + n * 4 * ((4 if want_dh else 1) + F)
    return _bound(0.0, f32, nbytes)


def _bound(bf, f32, nbytes):
    t_ops = (bf / H100_BF16_FLOPS + f32 / H100_F32_FLOPS) * 1e3
    t_bytes = nbytes / H100_BYTES * 1e3
    return (max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def kernel_bound(name, args, kw):
    if name == "field_fused":
        return field_bound(args, kw)
    if name == "secant_refine":
        return secant_bound(args, kw)
    if name == "surface_locate":
        return locate_bound(args, kw)
    return candidate_bound(name, args, kw)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def hgmma_counts(lib_path):
    """{kernel function: HGMMA instructions in its SASS} of one library
    (cuobjdump --dump-sass), or None without cuobjdump."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "--dump-sass", lib_path],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts, fn = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            fn = ln.split("Function :")[1].strip()
            counts[fn] = 0
        elif fn and "HGMMA" in ln:
            counts[fn] += 1
    return counts


def build_kernels():
    """Build every library; per library the [build] line gives ptxas's
    registers and spills of each kernel function and the HGMMA (wgmma)
    instructions in each function's SASS."""
    from neumesh_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.build_all()
    secs = time.perf_counter() - t0
    for name, info in _build.BUILD_LOG.items():
        lines = [ln.replace("ptxas info    : ", "").strip()
                 for ln in info["ptxas"].splitlines()
                 if ("registers" in ln or "spill" in ln
                     or "Compiling entry" in ln) and "(C75" not in ln]
        counts = hgmma_counts(_build._lib_path(name))
        hg = ("no cuobjdump in the toolkit" if counts is None else
              "HGMMA " + ", ".join(f"{fn}: {n}" for fn, n in counts.items()))
        log(f"[build] {name}: {info['seconds']:.1f} s; " + " | ".join(lines)
            + f"; {hg}")
    return secs


@contextlib.contextmanager
def shared_memory_probe(smem):
    """For the block, every kernel launch also asks its library's `_smem`
    entry for the dynamic shared memory of a block at the launch's
    arguments, and keeps the largest per kernel in smem."""
    import ctypes
    from neumesh_tpu_torch.ops import _build
    launch = _build.launch

    def probed(name, args):
        launch(name, args)
        src, entry = _build.ENTRY[name]
        fn = getattr(_build._lib(src), entry + "_smem")
        smem[name] = max(smem.get(name, 0), fn(ctypes.addressof(args)))
    _build.launch = probed
    try:
        yield
    finally:
        _build.launch = launch


def fold_weights(model, dtype, f32_layers=()):
    """(dens_ws, col_ws) folded as the bound model would for `dtype`."""
    from neumesh_tpu_torch.models.neumesh.model import TileBoundNeuMesh
    saved = model.compute_dtype, model.f32_layers
    model.compute_dtype, model.f32_layers = dtype, tuple(f32_layers)
    try:
        return TileBoundNeuMesh(model, {}, 1)._field_weights()
    finally:
        model.compute_dtype, model.f32_layers = saved


def tol_key(name, kw):
    """The TOL entry a kernel call is held to: bf16 where it runs a bf16
    compute dtype, else f32 (the distance and candidate_field kernels run
    no MLP)."""
    if name.startswith("candidate_field") or kw.get("dtype") is None \
            or kw.get("want") == "distance":
        return "f32"
    return "bf16"


def v2_inputs(v3_call, rays_per_tile=8, n_cand=96):
    """candidate_field (v2) arguments in its per-ray layout from a recorded
    candidate_field_v3 call: each tile's samples split over rays_per_tile
    rays, each ray taking the tile's n_cand nearest-ranked candidates."""
    xyz, geo, feat, w1 = v3_call[0][:4]
    B, S, _ = xyz.shape
    C = min(n_cand, geo.shape[2])
    g = geo[:, :, :C].repeat_interleave(rays_per_tile, 0)
    return (xyz.reshape(B * rays_per_tile, S // rays_per_tile, 3).contiguous(),
            g[:, 0:3].transpose(1, 2).contiguous(), g[:, 6].contiguous(),
            g[:, 3:6].transpose(1, 2).contiguous(), g[:, 7].contiguous(),
            feat[:, :C].repeat_interleave(rays_per_tile, 0).contiguous(), w1)


def kernel_variants(rec, models):
    """([(kernel, mode, variant, call_args, call_kw, tol key)],
    {(kernel, mode): (variant, args, kw) it is timed at}):
     - every call each structure's render recorded, as it was made
       (variant: the structure);
     - field_fused and secant_refine in every mode on the volume serving
       structure's inputs with its model's weights folded in f32, in bf16
       and (field_fused) in bf16 with selective-f32 layers;
     - candidate_field_v3 in every mode on the no-nablas surface (S = 128)
       and volume (S = 512) inputs; candidate_field (v2) on v2_inputs;
     - surface_locate with its model's f32 weights."""
    import torch
    from neumesh_tpu_torch.ops import kernels
    bf16 = torch.bfloat16
    out, timed = [], {}
    for st, calls in rec.items():
        for (name, mode), (a, kw) in calls.items():
            out.append((name, mode, st, a, kw, tol_key(name, kw)))
    srv = rec["serving_bf16"]
    vol = models["vol_bf16"]
    f32w, bfw = fold_weights(vol, None), fold_weights(vol, bf16)
    sel = fold_weights(vol, bf16, ("d0", "dh", "c0", "ch"))
    a, kw = srv[(FF, "distance")]
    timed[(FF, "distance")] = ("serving_bf16", a, kw)
    out.append((FF, "distance", "serving_bf16:k8", a, dict(kw, k=8), "f32"))
    a_d, kw_d = srv[(FF, "density")]
    for mode in ("density", "density_nabla", "full"):
        a0, kw0 = srv.get((FF, mode), (a_d, kw_d))
        dirs = a0[6] if len(a0) > 6 else None
        for var, (dws, cws), dt in (("f32", f32w, None), ("bf16", bfw, bf16),
                                    ("bf16_sel_f32", sel, bf16)):
            args = (a0[0], a0[1], a0[2], a0[3], dws,
                    cws if mode == "full" else None, dirs)
            out.append((FF, mode, f"serving_bf16:{var}", args,
                        dict(kw0, want=mode, dtype=dt),
                        "f32" if dt is None else "bf16"))
        timed[(FF, mode)] = (("serving_bf16", a0, kw0) if (FF, mode) in srv
                             else ("serving_bf16:bf16", a0,
                                   dict(kw0, want=mode)))
    a_s, kw_s = srv[(SR, "rebracket")]
    for rb in (True, False):
        for fr in (False, True):
            mode = kernels.secant_mode(rb, fr)
            kw = dict(kw_s, frozen_knn=fr)
            if not rb:
                kw.update(d_low_w=None, d_high_w=None)
            for var, (dws, _), dt in (("bf16", bfw, bf16),
                                      ("f32", f32w, None)):
                out.append((SR, mode, f"serving_bf16:{var}",
                            a_s[:9] + (dws,), dict(kw, dtype=dt),
                            "f32" if dt is None else "bf16"))
            timed[(SR, mode)] = (("serving_bf16" if mode == "rebracket"
                                  else "serving_bf16:bf16"), a_s, kw)
    v3 = "candidate_field_v3"
    flags = [(dh, ft) for dh in (False, True) for ft in (True, False)]
    for st in ("nonablas_surface", "nonablas_volume"):
        a, kw0 = rec[st][(v3, "ds_feat")]
        for dh, ft in flags:
            mode = kernels.candidate_mode(dh, ft)
            kw = dict(kw0, want_dh=dh, want_feat=ft)
            if (v3, mode) not in rec[st]:
                out.append((v3, mode, st, a, kw, "f32"))
            # timed at the volume's S = 512
            timed[(v3, mode)] = (st, a, kw)
    a2 = v2_inputs(rec["nonablas_volume"][(v3, "ds_feat")])
    for dh, ft in flags:
        mode = kernels.candidate_mode(dh, ft)
        kw = dict(k=8, want_dh=dh, want_feat=ft)
        out.append(("candidate_field", mode, "R4096_S64_C96", a2, kw, "f32"))
        timed[("candidate_field", mode)] = ("R4096_S64_C96", a2, kw)
    a, kw = rec["surface_locate"][("surface_locate", "bf16")]
    a32 = a[:7] + (fold_weights(models["surf_locate"], None)[0],)
    kw32 = dict(kw, dtype=None)
    out.append(("surface_locate", "f32", "surface_locate:f32", a32, kw32,
                "f32"))
    timed[("surface_locate", "bf16")] = ("surface_locate", a, kw)
    timed[("surface_locate", "f32")] = ("surface_locate:f32", a32, kw32)
    return out, timed


def check_outputs(name, mode, key, got, want):
    """(max |err|, share within tol, passed, extra fields) of one kernel
    call against its plain version, at TOL[key]: each output array is held
    to the share alone; in f32 the gradient outputs (nabla, dh) at
    TOL["f32_nabla"]."""
    tol = TOL[key]
    if name == "surface_locate":
        # the three flag planes bit for bit; d_pred where both hit
        agree = min(float((g == w).float().mean())
                    for g, w in zip(got[1:], want[1:]))
        both = got[1] & want[1]
        if not bool(both.any()):
            raise AssertionError("surface_locate: no ray hit")
        err, share = compare([got[0][both]], [want[0][both]], tol)
        need = LOCATE_MASK_AGREE[key]
        return (err, share, share >= tol["frac"] and agree >= need,
                {"mask_agree": agree, "min_mask_agree": need})
    if name.startswith("candidate_field"):
        if (got[1] is None) != (want[1] is None) or \
                (got[2] is None) != (want[2] is None):
            raise AssertionError(f"{name}/{mode}: outputs differ in kind")
        e1, s1 = compare([g for g in (got[0], got[2]) if g is not None],
                         [w for w in (want[0], want[2]) if w is not None],
                         tol)
        if got[1] is not None:
            e2, s2 = compare([got[1]], [want[1]], TOL["f32_nabla"])
            e1, s1 = max(e1, e2), min(s1, s2)
        return e1, s1, s1 >= tol["frac"], {}
    got = got if isinstance(got, list) else [got]
    want = want if isinstance(want, list) else [want]
    if name == "field_fused" and mode in ("density_nabla", "full") \
            and key == "f32":
        # sdf and rgb at the f32 tolerance, nabla at its own
        idx = [0] + ([4, 5, 6] if mode == "full" else [])
        e1, s1 = compare([got[i] for i in idx], [want[i] for i in idx], tol)
        e2, s2 = compare(got[1:4], want[1:4], TOL["f32_nabla"])
        err, share = max(e1, e2), min(s1, s2)
    else:
        err, share = compare(got, want, tol)
    return err, share, share >= tol["frac"], {}


def check_kernels(variants):
    """Kernel vs plain on the card; returns {(kernel, mode): row}. A
    variant may carry a 7th element, a (B, S) mask of the rows held to
    the tolerance (the rows its caller consumes); the others are
    reported beside the check."""
    import torch
    from neumesh_tpu_torch.ops import kernels
    rows = {}
    for name, mode, var, args, kw, key, *live in variants:
        got = getattr(kernels, name)(*args, **kw)
        want = getattr(kernels, name + "_plain")(*args, **kw)
        torch.cuda.synchronize()
        extra_rows = {}
        if live:
            live = live[0]
            if not bool(live.any()):
                raise AssertionError(f"{name}/{mode} {var}: no row to hold")
            extra_rows = {"rows_held": int(live.sum()),
                          "rows_reported": int((~live).sum())}
            if bool((~live).any()):
                e_out, s_out = compare([g[~live] for g in got],
                                       [w[~live] for w in want], TOL[key])
                extra_rows.update(reported_max_abs_err=e_out,
                                  reported_frac_within_tol=s_out)
            got, want = [g[live] for g in got], [w[live] for w in want]
        err, share, ok, extra = check_outputs(name, mode, key, got, want)
        extra.update(extra_rows)
        log(f"[check] {name}/{mode} {var} ({key}): max|err| {err:.3e}, "
            f"within tol {share:.5f}"
            + "".join(f", {k} {v:.5f}" if isinstance(v, float)
                      else f", {k} {v}" for k, v in extra.items())
            + f" ({'ok' if ok else 'FAIL'})")
        if not ok:
            raise AssertionError(f"{name}/{mode} {var} disagrees with its "
                                 f"plain version: {share:.4f} within tol "
                                 f"{extra}")
        tol = TOL[key]
        row = rows.setdefault((name, mode), {"checks": []})
        row["checks"].append({"variant": var, "max_abs_err": err,
                              "frac_within_tol": share,
                              "atol": tol["atol"], "rtol": tol["rtol"],
                              "min_frac": tol["frac"], **extra})
    return rows


def time_kernels(timed, rows):
    """Kernel and plain ms, bound and shapes of each mode at its timed
    call; the headline error is that call's check."""
    from neumesh_tpu_torch.ops import kernels
    for (name, mode), row in rows.items():
        var, a, kw = timed[(name, mode)]
        fn = getattr(kernels, name)
        plain = getattr(kernels, name + "_plain")
        row["ms"] = cuda_ms(lambda: fn(*a, **kw))
        row["plain_ms"] = cuda_ms(lambda: plain(*a, **kw), reps=2)
        row["bound_ms"], row["bound_by"] = kernel_bound(name, a, kw)
        row["shapes"] = _shape_note(name, a)
        row["timed_variant"] = var
        row["max_abs_err"] = next(c["max_abs_err"] for c in row["checks"]
                                  if c["variant"] == var)


def profile_frame(fn):
    """Device time by kernel over one traced call of fn (torch.profiler):
    the port's kernels, every other device op, busy time against the
    traced wall time (the profiler's own overhead is in that wall)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by = {k: 0.0 for k in (*KERNELS, "other")}
    for ev in prof.key_averages():
        # only the device's own events: an aten op on the host carries the
        # time of the kernels it launched, which are listed besides
        if (ev.device_type != DeviceType.CUDA
                or getattr(ev, "is_user_annotation", False)):
            continue
        us = float(ev.self_device_time_total or 0.0)
        if us <= 0:
            continue
        # no kernel's symbol contains another's ("candidate_field_kernel"
        # is not in "candidate_field_v3_kernel")
        key = next((k for k in KERNELS if k + "_kernel" in ev.key), "other")
        by[key] += us / 1e3
    busy = sum(by.values())
    return {"traced_wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": (1.0 - busy / wall_ms) if busy > 0 else None,
            "device_ms_by_kernel": {k: v for k, v in by.items() if v}}


def _shape_note(name, a):
    if name == "field_fused" or name == "candidate_field_v3":
        B, S, _ = a[0].shape
        return {"B": B, "S": S, "C": a[1].shape[2], "F": a[2].shape[-1]}
    if name == "candidate_field":
        R, S, _ = a[0].shape
        return {"R": R, "S": S, "C": a[1].shape[1], "F": a[5].shape[-1]}
    geo, feat = (a[6], a[7]) if name == "secant_refine" else (a[4], a[5])
    return {"R": a[0].shape[0], "B": geo.shape[0], "C": geo.shape[2],
            "F": feat.shape[-1]}


def build_scene(tmp, device):
    """Every model of MODELS on the 163,842-vertex icosphere, parameters
    from a numpy seed (one source model with nablas input, one without),
    round-tripped through reference-format .pt files and a .ply."""
    import torch
    from neumesh_tpu_torch.dataio.synthetic import icosphere_mesh
    from neumesh_tpu_torch.mesh.grid import MeshGrid
    from neumesh_tpu_torch.mesh.triangle_mesh import load_ply, save_ply
    from neumesh_tpu_torch.models.neumesh.model import NeuMesh
    from neumesh_tpu_torch.utils.state import (load_reference_pt,
                                               save_reference_pt)
    t0 = time.perf_counter()
    mesh = icosphere_mesh(0.5, subdivisions=7)
    mg = MeshGrid(mesh, device=device)
    pts = {}
    for nablas in (True, False):
        src = NeuMesh(mg, device=device,
                      **dict(FLAGSHIP, enable_nablas_input=nablas)).init(
                          seed=0)
        pts[nablas] = save_reference_pt(
            os.path.join(tmp, f"neumesh_{int(nablas)}.pt"), src)
        if nablas:
            src_params = [p.clone() for p in src.parameters()]
        del src
    save_ply(mesh, os.path.join(tmp, "mesh.ply"))
    mg2 = MeshGrid(load_ply(os.path.join(tmp, "mesh.ply")), device=device)
    models = {}
    for tag, (serving, bf16, extra) in MODELS.items():
        kw = dict(FLAGSHIP, use_pallas=True, **serving, **extra)
        m = NeuMesh(mg2, device=device,
                    compute_dtype=torch.bfloat16 if bf16 else None, **kw)
        load_reference_pt(pts[kw["enable_nablas_input"]], m)
        models[tag] = m
    if not all(torch.equal(a, b) for a, b in
               zip(src_params, models["vol_f32"].parameters())):
        raise AssertionError("weights changed through the .pt round trip")
    log(f"[scene] {mg2.get_number_of_vertices()} vertices, grid dims "
        f"{mg2.grid.dims} Kp {mg2.grid.Kp}, {len(models)} models, "
        f"{time.perf_counter() - t0:.1f} s")
    return models


def camera(H, W, half_fov=0.2, crop=None):
    """Camera at (0, 0, -2.5) looking down +z; an HxW raster spanning
    +-half_fov (tan) of the full frame; crop=(h, w) keeps the central
    crop of that raster."""
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = -2.5
    f = (W / 2) / half_fov
    h, w = crop or (H, W)
    K = np.array([[f, 0, (w - 1) / 2], [0, f, (h - 1) / 2], [0, 0, 1]],
                 np.float32)
    return c2w, K, h, w


def render(model, kind, H, crop=None, **kw):
    """One HxH frame (or its central crop) through the volume or surface
    frame entry -> (rgb, depth, extras)."""
    from neumesh_tpu_torch.render.ray_casting import render_surface_image
    from neumesh_tpu_torch.render.volume import render_image
    c2w, K, h, w = camera(H, H, crop=crop)
    fn = render_image if kind == "volume" else render_surface_image
    return fn(model, c2w, K, h, w, device="cuda", **kw)


def counted(model, kind, H, **kw):
    """One render with the launch counters set to 0 just before and read
    just after."""
    import torch
    from neumesh_tpu_torch.ops import kernels
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    rgb, depth, ret = render(model, kind, H, **kw)
    torch.cuda.synchronize()
    counts = {k: dict(v) for k, v in kernels.LAUNCHES.items()}
    return rgb, depth, ret, counts


def check_image(tag, rgb, depth, H, W):
    import torch
    if tuple(rgb.shape) != (H, W, 3) or tuple(depth.shape) != (H, W):
        raise AssertionError(f"{tag}: shapes {rgb.shape} {depth.shape}")
    if not (bool(torch.isfinite(rgb).all())
            and bool(torch.isfinite(depth).all())):
        raise AssertionError(f"{tag}: non-finite output")
    if float(rgb.min()) < -1e-4 or float(rgb.max()) > 1.0 + 1e-4:
        raise AssertionError(f"{tag}: rgb outside [0, 1]")


@contextlib.contextmanager
def frame_peaks(cli, peaks):
    """For the block, every view the CLI renders appends its peak device
    memory above what was allocated before it (the model, its tables and
    the earlier views' results are not counted)."""
    import torch
    render_function = cli.render_function

    def measured(args, model, kwargs, render_fn):
        def fn(*a, **kw):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = render_fn(*a, **kw)
            torch.cuda.synchronize()
            peaks.append(torch.cuda.max_memory_allocated() - base)
            return out
        if hasattr(render_fn, "set_image_hw"):
            fn.set_image_hw = render_fn.set_image_hw
        return render_function(args, model, kwargs, fn)
    cli.render_function = measured
    try:
        yield
    finally:
        cli.render_function = render_function


def rows_per_context(name, args):
    """(contexts, samples or rays of each) of one kernel call."""
    if name in ("secant_refine", "surface_locate"):
        B = args[6].shape[0] if name == "secant_refine" else args[4].shape[0]
        return B, args[0].shape[0] // B
    return args[0].shape[0], args[0].shape[1]


def live_share(name, args):
    """Live rows over all rows of the call's blocks (a block serves one
    context)."""
    _, n = rows_per_context(name, args)
    rows = BLOCK_ROWS[name]
    return n / (rows * -(-n // rows))


def write_cli_inputs(tmp):
    """A 4-view synthetic DTU-format scene and the config: the shipped
    configs/neumesh_dtu_scan63.yaml pointed at it and at the phase-2 mesh,
    no teacher. Returns the config's path."""
    from neumesh_tpu_torch.config import load_yaml, save_yaml
    from neumesh_tpu_torch.dataio.synthetic import generate_sphere_scene
    root = os.path.dirname(os.path.abspath(__file__))
    scene = generate_sphere_scene(os.path.join(tmp, "scene"), n_views=4,
                                  H=CLI_SIDE, W=CLI_SIDE,
                                  focal=1.25 * CLI_SIDE)
    cfg = load_yaml(os.path.join(root, "configs", "neumesh_dtu_scan63.yaml"))
    cfg.expname = "cli"
    cfg.data.update(data_dir=scene, cam_file="cameras.npz", downscale=1)
    cfg.model.prior_mesh = os.path.join(tmp, "mesh.ply")
    cfg.training.update(teacher_config=None, teacher_ckpt=None)
    path = os.path.join(tmp, "cli.yaml")
    save_yaml(cfg, path)
    return path


def check_cli_frames(tag, out):
    """The returned frames: finite, in range, (H, W, 3); the written PNGs
    decode (port reader) to exactly the frames' 8-bit values."""
    from neumesh_tpu_torch.utils.image_io import read_png
    H, W = out["H"], out["W"]
    pngs = [f for f in out["files"] if "_rgb_" in os.path.basename(f)]
    normal_pngs = [f for f in out["files"] if "_normal_" in f]
    if len(pngs) != len(out["rgb"]) or len(normal_pngs) != len(out["rgb"]):
        raise AssertionError(f"{tag}: {len(pngs)} rgb and {len(normal_pngs)} "
                             f"normal PNGs for {len(out['rgb'])} views")
    for rgb, nrm, f_rgb, f_nrm in zip(out["rgb"], out["normals"], pngs,
                                      normal_pngs):
        if rgb.shape != (H, W, 3) or nrm.shape != (H, W, 3):
            raise AssertionError(f"{tag}: frame shapes {rgb.shape} "
                                 f"{nrm.shape}")
        if not (np.isfinite(rgb).all() and np.isfinite(nrm).all()):
            raise AssertionError(f"{tag}: non-finite frame")
        if rgb.min() < -1e-4 or rgb.max() > 1 + 1e-4 \
                or np.abs(nrm).max() > 1 + 1e-4:
            raise AssertionError(f"{tag}: rgb outside [0, 1] or normals "
                                 "outside [-1, 1]")
        for f, img in ((f_rgb, rgb), (f_nrm, nrm / 2.0 + 0.5)):
            want = (np.clip(img, 0, 1) * 255.0).astype(np.uint8)
            if not np.array_equal(read_png(f), want):
                raise AssertionError(f"{tag}: {f} is not the returned frame")


def run_cli(tmp):
    """Phase 5: every CLI case once counted, once recorded; returns
    ({case: stats}, {case: counts}, [variants to check], {(kernel, mode, n,
    case): timed call})."""
    import torch
    from neumesh_tpu_torch.cli import render as cli
    from neumesh_tpu_torch.ops import kernels
    cfg = write_cli_inputs(tmp)
    stats, counts, variants, timed = {}, {}, [], {}
    for tag, (flags, nablas, must) in CLI_CASES.items():
        argv = ["--config", cfg, "--load_pt",
                os.path.join(tmp, f"neumesh_{int(nablas)}.pt"),
                "--outbase", tag] + flags
        peaks = []
        with contextlib.chdir(tmp):
            with frame_peaks(cli, peaks):
                torch.cuda.synchronize()
                kernels.reset_launch_counts()
                out = cli.main(argv + ["--num_views", str(CLI_VIEWS)])
                torch.cuda.synchronize()
                cnt = {k: dict(v) for k, v in kernels.LAUNCHES.items()}
            peak = max(peaks)
            missed = [f"{k}/{md}" for k, md in sorted(must) if cnt[k][md] <= 0]
            if missed:
                raise AssertionError(f"{tag}: never launched {missed}")
            check_cli_frames(tag, out)
            calls = []
            with record_calls(calls):
                cli.main(argv + ["--num_views", "1", "--outbase",
                                 tag + "_rec"])
        counts[tag] = cnt
        per_call = {}
        for name, mode, a, kw in calls:
            B, n = rows_per_context(name, a)
            key = (name, mode, n)
            per_call.setdefault(key, {"calls": 0, "contexts": 0,
                                      "live_share": live_share(name, a)})
            per_call[key]["calls"] += 1
            per_call[key]["contexts"] += B
            timed.setdefault(key + (tag,), (a, kw))
            variants.append((name, mode, tag, a, kw, tol_key(name, kw)))
        view_s = out["view_s"]
        stats[tag] = {
            "flags": flags, "views": len(view_s), "side": out["H"],
            "view_s": view_s, "ms_per_view_steady": 1e3 * float(
                np.mean(view_s[1:])), "mrays_s": out["mrays_s"],
            "frame_peak_bytes": peak,
            "launches": {k: {md: v for md, v in modes.items() if v}
                         for k, modes in cnt.items()},
            "per_frame_calls": [
                {"kernel": k[0], "mode": k[1], "rows_per_context": k[2],
                 **v} for k, v in sorted(per_call.items())]}
        log(f"[cli] {tag}: {stats[tag]['ms_per_view_steady']:.1f} ms/view, "
            f"{out['mrays_s']:.4f} Mrays/s, frame peak {peak / 2**20:.0f} MB; "
            + ", ".join(f"{k[0]}/{k[1]} x{v['calls']} at {k[2]} rows "
                        f"(live {v['live_share']:.3f})"
                        for k, v in sorted(per_call.items())))
    return stats, counts, variants, timed


def time_cli_calls(timed, stats):
    """Kernel ms and bound of the first call of each (kernel, mode, rows a
    context) of each case, into the case's per_frame_calls."""
    from neumesh_tpu_torch.ops import kernels
    for (name, mode, n, tag), (a, kw) in timed.items():
        fn = getattr(kernels, name)
        ms = cuda_ms(lambda: fn(*a, **kw))
        bound, by = kernel_bound(name, a, kw)
        for row in stats[tag]["per_frame_calls"]:
            if (row["kernel"], row["mode"], row["rows_per_context"]) == \
                    (name, mode, n):
                row.update(ms=ms, bound_ms=bound, bound_by=by,
                           shapes=_shape_note(name, a))
        log(f"[cli] {tag}: {name}/{mode} at {n} rows a context: {ms:.3f} ms "
            f"(bound {bound:.4f}, {by})")


# ---------------------------------------------------------------------------
# phase 6: training
# ---------------------------------------------------------------------------

DEV = "cuda"


def write_train_inputs(tmp):
    """{"neus", "neumesh"}: config paths made from the shipped configs,
    pointed at the CLI phase's scene (with masks), the phase-2 mesh and the
    teacher's files; TRAIN_ITERS iterations, a log line every iteration,
    validation at the last one (and at 0, as the loop crosses it)."""
    from neumesh_tpu_torch.config import load_yaml, save_yaml
    root = os.path.dirname(os.path.abspath(__file__))
    logs = os.path.join(tmp, "logs")
    paths = {}
    for name in ("neus", "neumesh"):
        cfg = load_yaml(os.path.join(root, "configs",
                                     f"{name}_dtu_scan63.yaml"))
        cfg.expname = f"train_{name}"
        cfg.data.update(data_dir=os.path.join(tmp, "scene"),
                        cam_file="cameras.npz", downscale=1)
        cfg.training.update(num_iters=TRAIN_ITERS, i_log=1,
                            i_val=TRAIN_ITERS - 1, log_root_dir=logs)
        if name == "neumesh":
            teacher = os.path.join(logs, "train_neus")
            cfg.model.prior_mesh = os.path.join(tmp, "mesh.ply")
            cfg.training.update(
                teacher_config=os.path.join(teacher, "config.yaml"),
                teacher_ckpt=os.path.join(teacher, "ckpts", "latest.ckpt"))
        paths[name] = os.path.join(tmp, f"train_{name}.yaml")
        save_yaml(cfg, paths[name])
    return paths


class _Lines:
    """Collects the messages of the port's logger for a block."""

    def __enter__(self):
        import logging
        self.lines = []
        lines = self.lines

        class H(logging.Handler):
            def emit(self, record):
                lines.append(record.getMessage())
        self.h, self.lg = H(), logging.getLogger("neumesh_tpu_torch")
        self.level = self.lg.level
        self.lg.addHandler(self.h)
        self.lg.setLevel(logging.INFO)
        return self

    def __exit__(self, *exc):
        self.lg.removeHandler(self.h)
        self.lg.setLevel(self.level)


def train_run_stats(tag, out, lines, wall_s):
    """Every loss term and the grad norm finite at every step (the stats
    the loop logged); ms/it and rays/s of each iteration from its log
    lines; medians after TRAIN_WARMUP iterations."""
    import pickle
    import re
    import statistics
    with open(os.path.join(out["exp_dir"], "stats.p_0"), "rb") as f:
        stats = pickle.load(f)
    series = dict(stats["losses"], grad_norm=stats["extras"]["grad_norm"])
    for k, v in series.items():
        vals = [x for _, x in v]
        if len(vals) != TRAIN_ITERS or not np.isfinite(vals).all():
            raise AssertionError(f"{tag}: {k} not finite at every step: "
                                 f"{vals}")
    perf = [(float(m.group(1)), float(m.group(2).replace(",", "")))
            for m in re.finditer(r"\(([\d.]+) ms/it, ([\d,]+) rays/s\)",
                                 "\n".join(lines))]
    if len(perf) != TRAIN_ITERS:
        raise AssertionError(f"{tag}: {len(perf)} log lines for "
                             f"{TRAIN_ITERS} iterations")
    ms = [p[0] for p in perf]
    return {"iters": out["it"], "wall_s": wall_s, "ms_per_it": ms,
            "ms_per_it_median": statistics.median(ms[TRAIN_WARMUP:]),
            "rays_s_median": statistics.median(
                [p[1] for p in perf[TRAIN_WARMUP:]]),
            "losses_first": {k: v[0][1] for k, v in series.items()},
            "losses_last": {k: v[-1][1] for k, v in series.items()},
            "val_psnr": [x for _, x in stats.get("validation", {}).get(
                "psnr", [])]}


def train_batch(cfg_path):
    """View 0 of the config's dataset as device tensors, with (H, W,
    N_rays)."""
    from neumesh_tpu_torch.config import load_yaml
    from neumesh_tpu_torch.dataio import get_data
    from neumesh_tpu_torch.train.loop import to_device
    cfg = load_yaml(cfg_path)
    ds = get_data(cfg)
    _, mi, gt = ds.batch([0])
    return (to_device(mi, DEV), to_device(gt, DEV), ds.H, ds.W,
            cfg.data.N_rays)


def loss_and_grad_norm(trainer, rk, batch, seed=0):
    """Total loss and global grad norm of one step on `batch` (no optimizer
    step; exact f32 matmuls; rays and perturbations from a generator of
    `seed`)."""
    import torch
    from neumesh_tpu_torch.train.loop import _set_matmul_precision
    mi, gt, H, W, n = batch
    _set_matmul_precision("highest", DEV)
    model = trainer.model
    model.requires_grad_(True)
    model.zero_grad(set_to_none=True)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    total = trainer.render_and_loss(mi, gt, rk, n, H, W,
                                    generator=gen)["losses"]["total"]
    total.backward()
    gn = torch.sqrt(sum(torch.sum(p.grad * p.grad)
                        for p in model.parameters() if p.grad is not None))
    model.zero_grad(set_to_none=True)
    return float(total.detach()), float(gn)


@contextlib.contextmanager
def step_events(trainer, evs):
    """For the block, CUDA events around the up-sampling densities, the
    teacher, the whole forward (render + losses), backward and the
    optimizer step, appended to evs[name]."""
    import torch
    from neumesh_tpu_torch.models.neumesh.model import RayBoundNeuMesh
    from neumesh_tpu_torch.train.optimizers import Adam

    def timed(name, fn):
        def w(*a, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*a, **kw)
            e1.record()
            evs.setdefault(name, []).append((e0, e1))
            return out
        return w
    targets = [(RayBoundNeuMesh, "forward_density_only_nograd", "upsampling"),
               (trainer, "_teacher", "teacher"),
               (trainer, "render_and_loss", "forward"),
               (torch.Tensor, "backward", "backward"),
               (Adam, "step", "optimizer")]
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in targets]
    for (obj, attr, name), (_, _, fn) in zip(targets, saved):
        setattr(obj, attr, timed(name, fn))
    try:
        yield
    finally:
        for obj, attr, fn in saved:
            if obj is trainer:
                delattr(obj, attr)
            else:
                setattr(obj, attr, fn)


def step_split(run, trainer):
    """Device-time split (ms) of one step from CUDA events: the up-sampling
    field_fused calls, the teacher, the forward context math (the rest of
    the forward), backward, optimizer, other (grad norm, zero_grad)."""
    import torch
    evs = {}
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    with step_events(trainer, evs):
        torch.cuda.synchronize()
        e0.record()
        run()
        e1.record()
    torch.cuda.synchronize()
    t = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in evs.items()}
    total = e0.elapsed_time(e1)
    out = {"step_ms": total, "upsampling_field_fused": t["upsampling"],
           "teacher": t["teacher"],
           "forward_context_math": t["forward"] - t["upsampling"]
           - t["teacher"],
           "backward": t["backward"], "optimizer": t["optimizer"]}
    out["other"] = total - t["forward"] - t["backward"] - t["optimizer"]
    return out


def run_training(tmp, card):
    """Phase 6. Returns (the {"training"} dict, launch counts of the NeuMesh
    run, [kernel variants to check], the field_fused density rows)."""
    import torch
    from neumesh_tpu_torch.cli import render as render_cli
    from neumesh_tpu_torch.cli import train as train_cli
    from neumesh_tpu_torch.config import load_yaml
    from neumesh_tpu_torch.models import build_framework
    from neumesh_tpu_torch.ops import kernels
    from neumesh_tpu_torch.train.loop import build_train_step
    from neumesh_tpu_torch.train.optimizers import get_optimizer
    from neumesh_tpu_torch.utils.checkpoints import CheckpointIO
    paths = write_train_inputs(tmp)
    result, runs = {"card": card}, {}
    for name in ("neus", "neumesh"):
        with contextlib.chdir(tmp), _Lines() as cap:
            torch.cuda.synchronize()
            if name == "neumesh":
                kernels.reset_launch_counts()
            t0 = time.perf_counter()
            out = train_cli.main(["--config", paths[name], "--device", DEV])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if name == "neumesh":
                counts = {k: dict(v) for k, v in kernels.LAUNCHES.items()}
        runs[name] = out
        result[name] = train_run_stats(name, out, cap.lines, wall)
        log(f"[train] {name}: {result[name]['ms_per_it_median']:.1f} ms/it "
            f"(median after {TRAIN_WARMUP}), "
            f"{result[name]['rays_s_median']:.0f} rays/s, total loss "
            f"{result[name]['losses_first']['total']:.4f} -> "
            f"{result[name]['losses_last']['total']:.4f}, {wall:.1f} s")
    if counts["field_fused"]["density"] <= 0:
        raise AssertionError("training never launched field_fused/density")
    result["launches"] = {k: {m: v for m, v in modes.items() if v}
                          for k, modes in counts.items()}

    # the teacher: bit-equal to its checkpoint after the student's run
    student = runs["neumesh"]
    teacher = student["trainer"].teacher_model
    saved = torch.load(os.path.join(runs["neus"]["exp_dir"], "ckpts",
                                    "latest.ckpt"), weights_only=True)
    if not torch.equal(teacher.ln_s.detach().cpu(), saved["model"]["ln_s"]):
        raise AssertionError("the teacher's ln_s changed during training")
    if student["model"].ln_s.data_ptr() == teacher.ln_s.data_ptr():
        raise AssertionError("student and teacher share ln_s")

    # final_*.ckpt: loads back into a fresh build, renders through the CLI
    exp = student["exp_dir"]
    final = os.path.join(exp, "ckpts", f"final_{TRAIN_ITERS:08d}.ckpt")
    trained = {n: p.detach().clone() for n, p in
               student["model"].named_parameters()}
    del runs, student, teacher, saved
    torch.cuda.empty_cache()
    with contextlib.chdir(tmp):
        view = render_cli.main([
            "--config", os.path.join(exp, "config.yaml"), "--load_pt", final,
            "--num_views", "1", "--H", str(TRAIN_RENDER_SIDE), "--W",
            str(TRAIN_RENDER_SIDE), "--outbase", "train_render",
            "--device", DEV])
    rgb = view["rgb"][0]
    if rgb.shape != (TRAIN_RENDER_SIDE, TRAIN_RENDER_SIDE, 3) \
            or not np.isfinite(rgb).all() or rgb.min() < -1e-4 \
            or rgb.max() > 1 + 1e-4:
        raise AssertionError(f"render of the trained student: {rgb.shape}")
    result["render_view_s"] = view["view_s"]

    # a fresh build: the first step through the kernels and through the
    # plain versions; then steps for memory, split, calls and times
    cfg = load_yaml(paths["neumesh"])
    model, trainer, rk, _, _ = build_framework(cfg, "NeuMesh", device=DEV)
    batch = train_batch(paths["neumesh"])
    k_loss, k_gn = loss_and_grad_norm(trainer, rk, batch)
    with plain_on_card():
        p_loss, p_gn = loss_and_grad_norm(trainer, rk, batch)
    rel = max(abs(k_loss - p_loss) / abs(p_loss), abs(k_gn - p_gn) / p_gn)
    result["first_step"] = {"loss_kernel": k_loss, "loss_plain": p_loss,
                            "grad_norm_kernel": k_gn,
                            "grad_norm_plain": p_gn, "max_rel": rel,
                            "limit": TRAIN_REL}
    log(f"[train] first step, kernels vs plain (TF32 off): loss {k_loss:.6f}"
        f" / {p_loss:.6f}, grad norm {k_gn:.6f} / {p_gn:.6f}, rel {rel:.2e}")
    if not rel <= TRAIN_REL:
        raise AssertionError(f"first step: kernel and plain routes differ by "
                             f"{rel:.2e} (limit {TRAIN_REL})")

    opt = get_optimizer(cfg, model)
    mi, gt, H, W, n = batch
    step = build_train_step(trainer, opt, rk, n, H, W,
                            matmul_precision=cfg.training.get(
                                "matmul_precision", "default"))
    gen = torch.Generator(device=DEV).manual_seed(1)

    def run():
        step(mi, gt, gen)
    for _ in range(2):
        run()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    run()
    torch.cuda.synchronize()
    result["step_peak_bytes"] = torch.cuda.max_memory_allocated() - resident
    result["resident_bytes"] = resident
    result["split_ms"] = step_split(run, trainer)
    result["profile"] = profile_frame(run)
    # the kernel calls of one step's forward (the optimizer step would
    # move the weights they alias)
    calls = []
    with record_calls(calls):
        loss_and_grad_norm(trainer, rk, batch, seed=1)
    torch.cuda.synchronize()
    log(f"[train] step peak {result['step_peak_bytes'] / 2**20:.0f} MB above "
        f"{resident / 2**20:.0f} MB resident; split (ms) "
        + ", ".join(f"{k} {v:.2f}" for k, v in result["split_ms"].items())
        + f"; idle share {result['profile']['idle_share']}")

    # every kernel call of the step, and per-call times at each shape
    variants, rows, seen = [], [], set()
    torch.set_grad_enabled(False)
    for name, mode, a, kw in calls:
        B, S = rows_per_context(name, a)
        variants.append((name, mode, f"training:B{B}_S{S}", a, kw,
                         tol_key(name, kw)))
        if (name, mode, S) in seen:
            continue
        seen.add((name, mode, S))
        fn = getattr(kernels, name)
        plain = getattr(kernels, name + "_plain")
        bound, by = kernel_bound(name, a, kw)
        rows.append({"kernel": name, "mode": mode, "B": B, "S": S,
                     "C": a[1].shape[2],
                     "calls_per_step": sum(
                         1 for c in calls if c[0] == name and c[1] == mode
                         and rows_per_context(name, c[2])[1] == S),
                     "ms": cuda_ms(lambda: fn(*a, **kw)),
                     "plain_ms": cuda_ms(lambda: plain(*a, **kw), reps=2),
                     "bound_ms": bound, "bound_by": by,
                     "live_share": live_share(name, a)})
        log(f"[train] {name}/{mode} B={B} S={S} C={a[1].shape[2]}: "
            f"{rows[-1]['ms']:.3f} ms (plain {rows[-1]['plain_ms']:.3f}, "
            f"bound {bound:.4f} {by}), live rows {rows[-1]['live_share']:.3f}")
    torch.set_grad_enabled(True)
    if {r["S"] for r in rows if r["kernel"] == "field_fused"} != {64, 16}:
        raise AssertionError(f"training step kernel shapes: {rows}")
    result["field_fused_calls"] = rows

    # the final checkpoint equals the trained parameters
    CheckpointIO().load_file(final, model)
    bad = [n for n, p in model.named_parameters()
           if not torch.equal(p.detach(), trained[n])]
    if bad:
        raise AssertionError(f"final checkpoint differs in {bad}")
    del model, trainer, opt, step, calls
    torch.cuda.empty_cache()
    return result, counts, variants, rows


# ---------------------------------------------------------------------------
# phase 7: mesh extraction, the quality-gate pipeline, eval, LPIPS
# ---------------------------------------------------------------------------

# extraction grids of phase 6's models (the teacher at the CLI default, the
# 163,842-vertex student's per-sample kNN route cut to 128), the sub-grid
# held against the CPU; the gate pipeline's iterations a model (cut from
# 3000) and its log interval; the views the eval CLI renders; LPIPS images'
# side and its card-vs-CPU agreement (relative)
EXTRACT_GRID = {"neus": 256, "neumesh": 128}
EXTRACT_SUBGRID = 32
PIPE_ITERS, PIPE_LOG = 300, 50
EVAL_VIEWS = "1,6"
LPIPS_SIDE, LPIPS_REL = 128, 1e-4
# the kernel modes each gate mode must launch
GATE_MUST = {"volume_f32": {(FF, "density")},
             "volume_bf16": {(FF, "distance"), (FF, "density"), (FF, "full"),
                             (SR, "rebracket")},
             "surface_f32": _SURF_MODES, "surface_fast": _SURF_MODES}


def open_edges(mesh, lo, hi):
    """(edges not shared by exactly two triangles, those of them with an
    end off the grid box's faces): marching tetrahedra leaves edges open
    only where the surface leaves the box."""
    t = mesh.triangles
    e = np.sort(np.concatenate([t[:, [0, 1]], t[:, [1, 2]], t[:, [2, 0]]]),
                axis=1)
    key, n = np.unique(e[:, 0] * mesh.n_vertices + e[:, 1],
                       return_counts=True)
    ends = np.stack([key[n != 2] // mesh.n_vertices,
                     key[n != 2] % mesh.n_vertices], 1)
    v = mesh.vertices[ends]                         # (open, 2, 3)
    on_face = ((np.abs(v - lo) < 1e-9) | (np.abs(v - hi) < 1e-9)).any(-1)
    return len(ends), int((~on_face.all(1)).sum())


def extract_full_width(tmp):
    """(a), on phase 6's checkpoints: the grid SDF of the NeuS teacher and
    of the 163,842-vertex NeuMesh student on the card against the same
    model on the CPU on a 32^3 grid (f32 tolerances); the teacher through
    the extraction CLI at N_grid 256 (a non-empty finite mesh, every edge
    shared by two triangles, open edges only on the grid box's faces);
    the student's full-width grid at 128^3 through the CLI's
    evaluate_grid_sdf, timed. The student, TRAIN_ITERS distillation steps
    from random codes, has no zero level set yet: the mesh of a trained
    student comes from the gate's (run_pipeline)."""
    import torch
    from neumesh_tpu_torch.cli import extract_mesh as cli
    from neumesh_tpu_torch.config import load_yaml
    rng = (-1.0, 1.0)
    out = {}
    for name, n in EXTRACT_GRID.items():
        exp = os.path.join(tmp, "logs", f"train_{name}")
        cfg_path = os.path.join(exp, "config.yaml")
        ckpt = os.path.join(exp, "ckpts", "latest.ckpt")
        sdf = {}
        for dev in ("cpu", DEV):
            cfg = load_yaml(cfg_path)
            cfg.update(device=dev, ckpt_path=ckpt)
            model, _ = cli.load_model(cfg)
            sdf[dev] = cli.evaluate_grid_sdf(model, EXTRACT_SUBGRID, rng, rng,
                                             rng, chunk=65536)
        err, share = compare([torch.from_numpy(sdf[DEV])],
                             [torch.from_numpy(sdf["cpu"])], TOL["f32"])
        if share < TOL["f32"]["frac"]:
            raise AssertionError(f"extract {name}: card vs CPU grid SDF "
                                 f"{share:.4f} within tol")
        row = {"N_grid": n, "chunk": 65536,
               "subgrid_card_vs_cpu": {"N": EXTRACT_SUBGRID,
                                       "max_abs_err": err,
                                       "frac_within_tol": share,
                                       **TOL["f32"]}}
        if name == "neus":
            del model
            stats = {}
            t0 = time.perf_counter()
            mesh = cli.main(["--config", cfg_path, "--ckpt_path", ckpt,
                             "--N_grid", str(n), "--chunk", "65536",
                             "--output_dir", os.path.join(tmp, "mesh_neus"),
                             "--device", DEV], stats=stats)
            row["wall_s"] = time.perf_counter() - t0
            if mesh.n_triangles == 0 or not np.isfinite(mesh.vertices).all() \
                    or not np.isfinite(mesh.vertex_colors).all():
                raise AssertionError("extract neus: non-finite mesh")
            n_open, bad = open_edges(mesh, *rng)
            if bad:
                raise AssertionError(f"extract neus: {bad} edges inside the "
                                     "box not shared by two triangles")
            row.update({k[:-2] + "_ms": 1e3 * v for k, v in stats.items()},
                       n_vertices=mesh.n_vertices,
                       n_triangles=mesh.n_triangles,
                       open_edges_on_box_faces=n_open)
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            grid = cli.evaluate_grid_sdf(model, n, rng, rng, rng,
                                         chunk=65536)
            torch.cuda.synchronize()
            row["grid_ms"] = 1e3 * (time.perf_counter() - t0)
            row["sdf_range"] = [float(grid.min()), float(grid.max())]
            del model, grid
        torch.cuda.empty_cache()
        out[name] = row
        log(f"[extract] {name} N={n}: "
            + ", ".join(f"{k} {v:.4g}" if isinstance(v, float) else
                        f"{k} {v}" for k, v in row.items()
                        if k != "subgrid_card_vs_cpu")
            + f"; card vs CPU {EXTRACT_SUBGRID}^3 max|err| {err:.2e}, "
            f"within tol {share:.5f}")
    return out


def gate_train_stats(lines):
    """{expname: (median ms/it, median rays/s)} from the train loop's log
    lines, the first line of each run (warm-up) left out."""
    import re
    import statistics
    runs, cur = {}, None
    for ln in lines:
        m = re.search(r"=> Experiment: (\S+)", ln)
        if m:
            cur = m.group(1)
        m = re.search(r"\(([\d.]+) ms/it, ([\d,]+) rays/s\)", ln)
        if m and cur:
            runs.setdefault(cur, []).append(
                (float(m.group(1)), float(m.group(2).replace(",", ""))))
    out = {}
    for k, v in runs.items():
        if len(v) < 2:
            raise AssertionError(f"gate training {k}: {len(v)} log lines")
        out[k] = {"ms_per_it": [x[0] for x in v],
                  "ms_per_it_median": statistics.median(x[0] for x in v[1:]),
                  "rays_s_median": statistics.median(x[1] for x in v[1:])}
    return out


def live_rows(tag, name, a):
    """() or (mask,): the surface modes shade every ray with one field_fused
    call and discard the missed rays' values, which they evaluate at the
    placeholder point (1, 1, 1), outside the unit bounding sphere. On
    trained weights that point sits far from every candidate, where the f32
    nabla is ill-conditioned: kernel, plain version on the card and plain
    version on the CPU disagree there by up to ~5e-4 alike. Those rows are
    reported beside the check; the hit rows are held to the tolerance."""
    if not tag.startswith("surface") or name != "field_fused":
        return ()
    return (~(a[0] == 1.0).all(-1),)


def distill_calls(p):
    """The kernel calls of one distillation step's forward on the gate's
    trained student (its saved config and latest.ckpt), one view's rays."""
    import torch
    from neumesh_tpu_torch.config import load_yaml
    from neumesh_tpu_torch.models import build_framework
    from neumesh_tpu_torch.utils.checkpoints import CheckpointIO
    cfg_path = os.path.join(p["nm_dir"], "config.yaml")
    cfg = load_yaml(cfg_path)
    model, trainer, rk, _, _ = build_framework(cfg, "NeuMesh", device=DEV)
    CheckpointIO().load_file(os.path.join(p["nm_dir"], "ckpts",
                                          "latest.ckpt"), model)
    calls = []
    with record_calls(calls):
        loss_and_grad_norm(trainer, rk, train_batch(cfg_path))
    torch.cuda.synchronize()
    return calls


def run_pipeline(tmp, card):
    """Phase 7. Returns (the {"pipeline"} dict, {gate mode: launch
    counts})."""
    import torch
    from neumesh_tpu_torch.cli import eval as eval_cli
    from neumesh_tpu_torch.cli import extract_mesh as extract_cli
    from neumesh_tpu_torch.ops import kernels
    from neumesh_tpu_torch.ops.lpips import _CHANNELS, _VGG_CONVS, lpips
    from neumesh_tpu_torch.tools import quality_gate as qg
    from neumesh_tpu_torch.utils.image_io import read_png
    t_phase = time.perf_counter()
    result = {"card": card, "extract": extract_full_width(tmp)}

    # (b) the gate at PIPE_ITERS; (c) every kernel call of its four modes
    # recorded, each mode counted alone
    args = qg.create_parser().parse_args([
        "--iters", str(PIPE_ITERS), "--workdir", os.path.join(tmp, "qgate"),
        "--log-every", str(PIPE_LOG), "--device", DEV])
    counts, calls, first = {}, {}, []

    @contextlib.contextmanager
    def mode_context(tag):
        torch.cuda.synchronize()
        if not first:       # launches since the gate started: distillation
            first.append({k: dict(v) for k, v in kernels.LAUNCHES.items()})
        kernels.reset_launch_counts()
        calls[tag] = []
        with record_calls(calls[tag]):
            yield
        torch.cuda.synchronize()
        counts[tag] = {k: dict(v) for k, v in kernels.LAUNCHES.items()}

    with contextlib.chdir(tmp), _Lines() as cap:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        gate = qg.run(args, mode_context)
        gate_s = time.perf_counter() - t0
    if torch.backends.cuda.matmul.allow_tf32 \
            or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 still on after the gate's training")
    train = gate_train_stats(cap.lines)
    for tag, must in GATE_MUST.items():
        missed = [f"{k}/{md}" for k, md in sorted(must)
                  if counts[tag][k][md] <= 0]
        if missed:
            raise AssertionError(f"gate {tag}: never launched {missed}")
    if first[0]["field_fused"]["density"] <= 0:
        raise AssertionError("the gate's distillation never launched "
                             "field_fused/density")
    json_keys = [k for k in gate if k not in ("train", "scores", "paths")]
    for k in json_keys:
        v = gate[k]
        if isinstance(v, float) and not np.isfinite(v):
            raise AssertionError(f"gate {k} = {v}")
    for tag in qg.MODES:
        for r in gate["scores"][tag]["renders"]:
            if r.shape != (qg.SCENE["H"] * qg.SCENE["W"], 3) \
                    or not np.isfinite(r).all():
                raise AssertionError(f"gate {tag}: render {r.shape}")
    modes = {tag: {"psnr": s["psnr"], "ssim": s["ssim"],
                   "ms_per_view": [1e3 * x for x in s["view_s"]],
                   "launches": {k: {m: v for m, v in md.items() if v}
                                for k, md in counts[tag].items()}}
             for tag, s in gate["scores"].items()}
    result["gate"] = {
        "iters": PIPE_ITERS, "wall_s": gate_s, "train": train,
        "train_wall_s": gate["train"], "modes": modes,
        "distillation_launches": {k: {m: v for m, v in md.items() if v}
                                  for k, md in first[0].items()},
        "json": {k: gate[k] for k in json_keys}}
    for k, v in train.items():
        log(f"[gate] {k}: {v['ms_per_it_median']:.1f} ms/it, "
            f"{v['rays_s_median']:.0f} rays/s")
    log(f"[gate] extraction {gate['train']['extract']}")
    for tag, m in modes.items():
        log(f"[gate] {tag}: ms/view {[round(x, 1) for x in m['ms_per_view']]}"
            f", PSNR {[round(x, 2) for x in m['psnr']]}, SSIM "
            f"{[round(x, 4) for x in m['ssim']]}; launches {m['launches']}")
    log(f"[gate] {json.dumps(result['gate']['json'])}")

    # the gate's trained student at the zero level, through the CLI (its
    # last checkpoint by default), on the gate's extraction box
    stats, box = {}, [str(x) for x in qg.EXTRACT_RANGE]
    p = gate["paths"]
    mesh = extract_cli.main([
        "--config", os.path.join(p["nm_dir"], "config.yaml"),
        "--N_grid", str(EXTRACT_GRID["neumesh"]), "--x_range", *box,
        "--y_range", *box, "--z_range", *box, "--output_dir",
        os.path.join(tmp, "mesh_gate_student"), "--device", DEV],
        stats=stats)
    n_open, bad = open_edges(mesh, *qg.EXTRACT_RANGE)
    if bad or not np.isfinite(mesh.vertices).all():
        raise AssertionError(f"gate student mesh: {bad} open edges inside "
                             "the box")
    result["extract"]["gate_student"] = {
        "N_grid": EXTRACT_GRID["neumesh"], "sdf_th": 0.0,
        **{k[:-2] + "_ms": 1e3 * v for k, v in stats.items()},
        "n_vertices": mesh.n_vertices, "n_triangles": mesh.n_triangles,
        "open_edges_on_box_faces": n_open}
    log(f"[extract] the gate's student N={EXTRACT_GRID['neumesh']} level 0: "
        f"{result['extract']['gate_student']}")

    # replay: every recorded call of the modes and of one distillation
    # step, against its plain version, on the trained weights
    variants = [(name, mode, f"gate_{tag}", a, kw, tol_key(name, kw))
                + live_rows(tag, name, a)
                for tag, cs in calls.items() for name, mode, a, kw in cs]
    variants += [(name, mode, "gate_distillation", a, kw, tol_key(name, kw))
                 for name, mode, a, kw in distill_calls(gate["paths"])]
    del calls
    with torch.no_grad():
        rows = check_kernels(variants)
    result["gate"]["checks"] = {f"{k}/{m}": len(r["checks"])
                                for (k, m), r in rows.items()}
    result["gate"]["replays"] = len(variants)
    del variants, rows
    torch.cuda.empty_cache()

    # (d) the eval CLI on two views of the gate scene, renders saved
    renders, save = {}, os.path.join(tmp, "eval_renders")
    with contextlib.chdir(tmp):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        summary = eval_cli.main([
            "--config", os.path.join(p["nm_dir"], "config.yaml"),
            "--views", EVAL_VIEWS, "--save_renders", save, "--out_json",
            os.path.join(tmp, "eval.json"), "--device", DEV],
            renders=renders)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        eval_counts = {k: {m: v for m, v in md.items() if v}
                       for k, md in kernels.LAUNCHES.items()}
    views = [int(v) for v in EVAL_VIEWS.split(",")]
    if set(summary) != {"views", "mean_psnr", "mean_ssim"} \
            or [r["view"] for r in summary["views"]] != views \
            or any(set(r) != {"view", "psnr", "ssim"}
                   or not np.isfinite([r["psnr"], r["ssim"]]).all()
                   for r in summary["views"]):
        raise AssertionError(f"eval summary {summary}")
    with open(os.path.join(tmp, "eval.json")) as f:
        if json.load(f) != summary:
            raise AssertionError("eval.json is not the returned summary")
    names = sorted(os.listdir(os.path.join(p["scene"], "image")))
    for vi in views:
        png = read_png(os.path.join(save, names[vi]))
        if not np.array_equal(png, (np.clip(renders[vi], 0, 1) * 255.0)
                              .astype(np.uint8)):
            raise AssertionError(f"eval: {names[vi]} is not the render")
    if eval_counts.get("field_fused", {}).get("density", 0) <= 0:
        raise AssertionError("eval never launched field_fused/density")
    result["eval"] = {"summary": summary, "wall_s": eval_s,
                      "launches": eval_counts}
    log(f"[eval] {summary['mean_psnr']} dB, SSIM {summary['mean_ssim']} "
        f"over views {views}, {eval_s:.1f} s; launches {eval_counts}")

    # (e) one LPIPS call of two 128x128 images on the card, seeded
    # synthetic VGG16 weights, against the same call on the CPU
    rng = np.random.default_rng(0)
    w_np, in_c = {"convs": [], "lins": [], "calibrated": False}, 3
    for out_c, _ in _VGG_CONVS:
        w_np["convs"].append({
            "w": (rng.normal(size=(out_c, in_c, 3, 3))
                  / np.sqrt(in_c * 9)).astype(np.float32),
            "b": (rng.normal(size=out_c) * 0.01).astype(np.float32)})
        in_c = out_c
    w_np["lins"] = [np.abs(rng.normal(size=c)).astype(np.float32) / c
                    for c in _CHANNELS]
    w_card = {"convs": [{k: torch.as_tensor(v, device=DEV)
                         for k, v in c.items()} for c in w_np["convs"]],
              "lins": [torch.as_tensor(x, device=DEV)
                       for x in w_np["lins"]]}
    side = LPIPS_SIDE
    a = renders[views[0]][:side, :side]
    b = renders[views[1]][:side, :side]
    got = float(lpips(w_card, torch.as_tensor(a, device=DEV),
                      torch.as_tensor(b, device=DEV))[0])
    want = float(lpips(w_np, a, b, device="cpu")[0])
    rel = abs(got - want) / max(abs(want), 1e-12)
    ms = cuda_ms(lambda: lpips(w_card, torch.as_tensor(a, device=DEV),
                               torch.as_tensor(b, device=DEV)), reps=3)
    result["lpips"] = {"side": side, "card": got, "cpu": want, "rel": rel,
                       "limit": LPIPS_REL, "ms": ms}
    log(f"[lpips] {side}x{side}: card {got:.6f}, CPU {want:.6f}, rel "
        f"{rel:.2e}, {ms:.2f} ms")
    if not (np.isfinite(got) and rel <= LPIPS_REL):
        raise AssertionError(f"LPIPS card vs CPU: rel {rel:.2e}")
    result["phase_s"] = time.perf_counter() - t_phase
    return result, counts


def main() -> int:
    import torch
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; this script runs only on a GPU")
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import neumesh_tpu_torch

    neumesh_tpu_torch.set_fp32_precision()
    name = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"[device] {name} | {card}")
    build_s = build_kernels()
    log(f"[build] all kernels {build_s:.1f} s")

    with tempfile.TemporaryDirectory() as tmp:
        return run_all(tmp, name, card, build_s, t_start)


def run_all(tmp, name, card, build_s, t_start) -> int:
    import torch
    models = build_scene(tmp, "cuda")

    # ---- the main paths: counters around each structure's render, after a
    # warm-up render; the peak memory holds nothing kept by the checks
    frame, counts = {}, {}
    for st, (mkey, kind, H, kw, must, _) in STRUCTURES.items():
        m = models[mkey]
        render(m, kind, H, **kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        rgb, depth, ret, cnt = counted(m, kind, H, **kw)
        peak = torch.cuda.max_memory_allocated()
        check_image(st, rgb, depth, H, H)
        missed = [f"{k}/{md}" for k, md in sorted(must) if cnt[k][md] <= 0]
        if missed:
            raise AssertionError(f"{st}: never launched {missed}")
        counts[st] = cnt
        # the frame's own peak: above every model's resident parameters
        frame[st] = {"rays": H * H, "peak_mem_bytes": peak,
                     "frame_peak_bytes": peak - resident,
                     "resident_bytes": resident,
                     "launches": {k: {md: v for md, v in modes.items() if v}
                                  for k, modes in cnt.items()}}
        if kind == "surface":
            frame[st]["hit_share"] = float(
                ret["mask_surface"].float().mean())
        log(f"[render] {st}: launches {frame[st]['launches']}")

    # ---- kernels against their plain versions, on the inputs each
    # structure's render gives them; the renders that record those inputs
    # also read each kernel's shared memory per block
    rec, smem = {}, {}
    for st, (mkey, kind, H, kw, _, _) in STRUCTURES.items():
        calls = []
        with record_calls(calls), shared_memory_probe(smem):
            render(models[mkey], kind, H, **kw)
        rec[st] = {}
        for kname, mode, a, kwargs in calls:     # the first call of a mode
            rec[st].setdefault((kname, mode), (a, kwargs))
        del calls
    log("[build] dynamic shared memory per block on the main paths (the "
        "largest launch): "
        + ", ".join(f"{k} {v} B" for k, v in sorted(smem.items())))
    variants, timed = kernel_variants(rec, models)
    rows = check_kernels(variants)
    time_kernels(timed, rows)
    del rec, variants, timed

    # ---- crops through the plain versions on the card: rgb, and the
    # normals of the surface structures (peak-to-peak 2)
    psnr = {}
    for st, (mkey, kind, H, kw, _, _) in STRUCTURES.items():
        limit = CROP_PSNR["bf16" if MODELS[mkey][1] else "f32"]
        crop_k, _, ret_k = render(models[mkey], kind, 256, crop=(64, 64),
                                  **kw)
        with plain_on_card():
            crop_p, _, ret_p = render(models[mkey], kind, 256,
                                      crop=(64, 64), **kw)
        pairs = {"rgb": (crop_k, crop_p, 1.0)}
        if kind == "surface":
            pairs["normals"] = (ret_k["normals_surface"],
                                ret_p["normals_surface"], 2.0)
        for what, (a, b, peak) in pairs.items():
            mse = float(((a - b) ** 2).mean())
            db = 10 * math.log10(peak * peak / max(mse, 1e-20))
            psnr[f"{st}/{what}"] = db
            log(f"[crop] {st} {what}: kernel vs plain PSNR {db:.2f} dB "
                f"(limit {limit})")
            if db < limit:
                raise AssertionError(f"{st}: crop {what} disagrees with the "
                                     "plain path")

    # ---- throughput and the traced frame of every structure
    for st, (mkey, kind, H, kw, _, reps) in STRUCTURES.items():
        m = models[mkey]
        ms = cuda_ms(lambda: render(m, kind, H, **kw), reps=reps)
        frame[st].update(ms=ms, mrays_s=H * H / ms / 1e3,
                         profile=profile_frame(
                             lambda: render(m, kind, H, **kw)))
        log(f"[frame] {st}: {ms:.2f} ms, {H * H / ms / 1e3:.4f} Mrays/s, "
            f"idle share {frame[st]['profile']['idle_share']}")
    print(json.dumps({"frame": frame, "crop_psnr_db": psnr,
                      "build_s": build_s,
                      "total_s": time.perf_counter() - t_start,
                      "card": card}))

    # ---- the render CLI: the counted cases, then every recorded call
    # against its plain version, and the per-call times
    del models
    torch.cuda.empty_cache()
    cli_stats, cli_counts, cli_variants, cli_timed = run_cli(tmp)
    cli_rows = check_kernels(cli_variants)
    del cli_variants
    time_cli_calls(cli_timed, cli_stats)
    del cli_timed
    print(json.dumps({"cli": cli_stats, "card": card,
                      "checks": {f"{k}/{m}": len(r["checks"])
                                 for (k, m), r in cli_rows.items()},
                      "total_s": time.perf_counter() - t_start}))

    # ---- training: the NeuS teacher, the NeuMesh student, their checks
    train, train_counts, train_variants, _ = run_training(tmp, card)
    with torch.no_grad():
        train_rows = check_kernels(train_variants)
    del train_variants
    train["checks"] = {f"{k}/{m}": len(r["checks"])
                       for (k, m), r in train_rows.items()}
    train["total_s"] = time.perf_counter() - t_start
    print(json.dumps({"training": train}))

    # ---- extraction, the quality-gate pipeline, eval and LPIPS
    pipe, gate_counts = run_pipeline(tmp, card)
    pipe["total_s"] = time.perf_counter() - t_start
    print(json.dumps({"pipeline": pipe}))

    on_path = {km for st in STRUCTURES.values() for km in st[4]}
    kernels_out = []
    for (kname, mode), row in sorted(rows.items()):
        src, rep = SOURCES[kname]
        by_st = {st: counts[st][kname][mode] for st in STRUCTURES}
        home = LAUNCHES_OF[kname]
        all_st = sum(by_st.values())
        by_st.update({f"gate_{tag}": c[kname][mode]
                      for tag, c in gate_counts.items()})
        kernels_out.append({
            "name": f"{kname}/{mode}", "route": "cuda", "source": src,
            "replaces": rep, "launches": by_st[home] if home else 0,
            "launches_structure": home,
            "launches_all_structures": all_st,
            "launches_by_structure": by_st,
            "launches_reference_structure": by_st["reference_f32"],
            "launches_by_cli_case": {c: cli_counts[c][kname][mode]
                                     for c in CLI_CASES},
            "launches_training_neumesh": train_counts[kname][mode],
            "launches_gate_distillation": pipe["gate"][
                "distillation_launches"].get(kname, {}).get(mode, 0),
            "launches_eval": pipe["eval"]["launches"].get(kname, {}).get(
                mode, 0),
            "on_path": (kname, mode) in on_path,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None,
            "design": "wgmma" if (kname, mode) in WGMMA_ROWS else "simt",
            "card": card, "shapes": row["shapes"],
            "timed_variant": row["timed_variant"], "checks": row["checks"]})
    print(json.dumps({"kernels": kernels_out}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
