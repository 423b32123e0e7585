#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (neumesh_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase below, one card

Phases (any failure exits non-zero; nothing falls back to the CPU):
 1. device: CUDA required; card name and power limit; build every kernel
    from neumesh_tpu_torch/csrc (nvcc, all sources in parallel) and the
    host-geometry library from neumesh_tpu_torch/cpp (g++, beside them),
    timed;
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
    times, roofline bound. field_fused's distance mode (its own kernel,
    csrc/field_distance.cu) also timed and held at k = 8 on the serving
    scan's inputs and at the per-ray shapes made from them (4,096 contexts
    of 96 candidates, S = 1, 16, 128), beside its instruction floor.
    field_fused_edit (on no structure: the edited renders of phase 8) at
    the swap cell's shapes (EDIT_CELL_B = 469 contexts of S = 16,256
    samples, C = 128, one rotated reference; edit_cell_call), held
    against its plain version on every EDIT_CELL_EVERY-th context, the
    painted counts of both compared; kernel ms, the plain version's
    scaled from those contexts, bound. candidate_bounds (the tile
    contexts' near/far) held bit for bit against its plain version on
    every call the structures make and at the surface cell's shapes
    (BOUNDS_CELL_TILES = 3,750 tiles of 128 rays: the recorded surface
    tiles repeated, bounds_cell_call), timed there beside its plain
    version and its bound.
    Then the stage split (kernels.stage_split, the tile kernels' timing
    instantiation, launched nowhere else but ab_field_kernels.py): the
    share of a block's cycles and the microseconds a tile of each stage
    (SPLIT_ROWS: the serving structure's bf16 field_fused calls in every
    mode, its secant, the f32 density), each share finite and every
    row's shares summing to 1.
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
    version, each (kernel, mode, samples a context) timed with its plain
    version's time, its bound and the share of live rows in its blocks; the written PNGs decoded by
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
    through the extraction CLI (neumesh_tpu_torch.cli.extract_mesh.main;
    the C++ marching by default)
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
 8. editing on phase 7's gate-trained sphere scene (the ~60k-vertex
    extracted scaffold), through the editing CLIs
    (neumesh_tpu_torch.cli.editing), each counted alone (its kernel modes
    asserted) with every kernel call recorded (EDIT_CASES): texture
    swapping of the +x cap by the -x cap of the same model (T_r_m from
    EDIT_CORR pairs by Umeyama + ICP) on 2 views of 128x128 in the
    shipped volume mode (f32, per-ray contexts, up-sampling on
    field_fused), in the surface mode with use_pallas (128-ray tiles,
    distance scan, fused secant) and with use_fused_locate, each beside
    the same mode unedited, then with --use_arap; texture filling (uv
    charts of two bands, step 2) and geometry editing (the wave-deformed
    scaffold, its MeshGrid rebuilt on the card), one view each; painting
    (paint rays cast through the host BVH, PAINT_ITERS steps at 512 rays,
    the first step's calls recorded); the editing gate on the swap,
    printed beside the JAX package's GATES_r05/editing_gate_sphere.json
    (qualities, not held). Checks: every recorded call against its plain
    version (the surface swaps' edited shade is field_fused_edit, asserted
    launched); a 64x64 crop of each edited render through the plain
    versions >= 55 dB; the surface swaps' depth and hit mask equal to the
    unedited render's, their rgb within the f32 tolerance on the rays
    whose tile candidates hold no edited vertex; after painting every
    parameter but the painted rows of color_features bit-identical, those
    rows moved, every loss finite; the swap_surface scan's f32 k = 8
    distance call timed. Reports ms per view edited and unedited, the
    edit's host steps (load, ICP, kNN, ARAP, MeshGrid rebuild), the ray
    cast, paint ms/it and the phase's peak memory.
 9. multi-GPU (neumesh_tpu_torch.parallel) on the one card: (a) right
    after phase 4, the serving_bf16, surface_fast and surface_locate
    frames (256x256) through their frame entries with replicas over
    [cuda:0] with force_shard_map, over [cuda:0, cuda:0] (a replica on
    the same card: the split, the padding and the gather at n = 2) and
    at a rayschunk whose last chunk is edge-padded to a multiple of
    2 x 128; rgb and depth held against the frame on the model alone
    within the bf16 tolerance (max |diff| printed; equal bits expected),
    hit masks equal, every kernel mode of the structure counted; ms a
    frame direct and sharded. (b) after phase 8, two CLI cases again
    with --volume_devices 0 --surface_devices 0 (every local card): the
    frames equal phase 5's. (c) data-parallel training through the train
    loop in worker processes (PAR_*/DP_* settings), one update of 512
    rays a view on phase 6's scene, teacher and NeuMesh config: one rank
    in an nccl group against no group (first step's loss and grad norm);
    two gloo ranks on the card at batch 2 x data 1 and at batch 1 x data
    2 (LOCAL_WORLD_SIZE 2) against one process on the concatenated batch
    (parameters and Adam moments, rtol 2e-5, atol 2e-6); each worker's
    field_fused launches > 0. (d) with a second card also [cuda:0,
    cuda:1] serving and the 2 x 1 update over nccl across two cards;
    otherwise one line says they were not exercised.
10. the host-geometry library (neumesh_tpu_torch/cpp, the JAX package's
    default path): the phase-2 icosphere's candidate grid built by the
    C++ KD-tree and by scipy (ms each, cell_row equal, rows equal
    counted); serving_bf16 and surface_fast at
    256x256 from each grid, the native-built frames counted (their kernel
    modes asserted) and every kernel call recorded and replayed against
    its plain version, the pixels the scipy grid's ties move counted;
    phase 7's 256^3 teacher field through the C++ and the numpy marching
    tetrahedra and cubes (the same vertex set, ms each); phase 8's ARAP
    warp native vs numpy (s each, max |diff| and ARAP energies reported,
    the constraints pinned by both); phase 8's
    paint rays through the BVH and the card's float64 caster (the same
    hits and t, primitives differing only at ties, ms each).
Prints the card line, one {"cli": {...}} line, one {"training": {...}}
line, one {"pipeline": {...}} line, one {"editing": {...}} line, one
{"parallel": {...}} line, one {"host_geometry": {...}} line, one
{"kernels": [...]} line (each row with its design, "ws_wgmma" (the
warp-specialised persistent tile kernels: field_fused's MLP modes,
field_fused_edit and secant_refine), "wgmma", "simt" or "thread_scan" (the distance row, with its instruction floor floor_ms and
timed_shapes: the serving scan at k = 1 and 8, the swap's scan, the
per-ray shapes), bound_ms at the tensor-core rates beside
bound_cuda_core_ms, the bound
with every f32 flop at the CUDA-core rate, the launches of the gate modes in launches_by_structure, of the editing
cases in launches_by_editing_case, of phase 9's sharded renders in
launches_by_parallel_case, of phase 10's renders in
launches_host_geometry), and last {"ok": true, "device": {...}}.
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
# an f32 hidden layer on the tensor cores: six bf16 products (the split of
# field_common.cuh), so a sixth of the bf16 rate
H100_F32_SPLIT_FLOPS = H100_BF16_FLOPS / 6
H100_BYTES = 3.35e12            # HBM3
# separately issued f32 instructions a second: 128 lanes an SM x 132 SMs x
# 1.98 GHz (boost); the exact-f32 candidate chain cannot contract into FMAs
H100_F32_ISSUE = 128 * 132 * 1.98e9
# instructions a candidate and sample of the distance scan: xv (3 mul, 2
# add), xx + pp, 2 xv, the subtraction, max 0, the tie-break, the minimum
DIST_INSTR = 11

TOL = {"f32": dict(atol=2e-5, rtol=1e-4, frac=0.99),
       "f32_nabla": dict(atol=1e-4, rtol=1e-4, frac=0.99),
       "bf16": dict(atol=2e-3, rtol=0.0, frac=0.97)}
# surface_locate: share of rays whose mask bits agree with the plain version
LOCATE_MASK_AGREE = {"bf16": 0.999, "f32": 1.0}

KERNELS = ("field_fused", "field_fused_edit", "secant_refine",
           "surface_locate", "candidate_field_v3", "candidate_field",
           "candidate_bounds")
FE = ("field_fused_edit", "full")
CB = ("candidate_bounds", "tiled")
# a row's design: its kernel runs the tensor-core tile stage, every hidden
# MLP layer on wgmma (f32 ones as the bf16 split; "wgmma"), or it has no
# MLP and everything runs on the CUDA cores ("simt")
WGMMA_ROWS = {("field_fused", m) for m in ("density", "density_nabla",
                                            "full")} | \
    {("secant_refine", m) for m in ("plain", "rebracket", "frozen",
                                    "frozen_rebracket")} | \
    {("surface_locate", m) for m in ("bf16", "f32")} | {FE}
FD = ("field_fused", "distance")
# a row's design beside WGMMA_ROWS: the distance mode's own kernel, a thread
# a sample scanning shared-memory candidates (csrc/field_distance.cu); the
# warp-specialised persistent tile kernels (a producer warpgroup feeding
# the weight ring, field_common.cuh), field_fused's MLP modes and the
# secant
ROW_DESIGN = {FD: "thread_scan", CB: "simt",
              **{km: "ws_wgmma" for km in WGMMA_ROWS
                 if km[0] != "surface_locate"},
              # their f32 builds keep the serial wgmma block (csrc
              # secant_ws)
              **{km: "ws_wgmma (f32: wgmma)" for km in (
                  ("secant_refine", "plain"),
                  ("secant_refine", "rebracket"))}}
# the stage split's rows: (kernel, mode, kernel_variants' variant)
SPLIT_ROWS = (("field_fused", "density", "serving_bf16:bf16"),
              ("field_fused", "density_nabla", "serving_bf16:bf16"),
              ("field_fused", "full", "serving_bf16:bf16"),
              ("secant_refine", "rebracket", "serving_bf16:bf16"),
              ("field_fused", "density", "serving_bf16:f32"))
SOURCES = {
    "field_fused": ("neumesh_tpu_torch/csrc/field_fused.cu",
                    "neumesh_tpu/ops/pallas_kernels.py:645"),
    # no TPU kernel: the JAX package's edited shade is plain jnp
    "field_fused_edit": ("neumesh_tpu_torch/csrc/field_fused_edit.cu",
                         "neumesh_tpu/editing/texture_model.py:200"),
    "secant_refine": ("neumesh_tpu_torch/csrc/secant_refine.cu",
                      "neumesh_tpu/ops/pallas_kernels.py:1128"),
    "surface_locate": ("neumesh_tpu_torch/csrc/surface_locate.cu",
                       "neumesh_tpu/ops/pallas_kernels.py:952"),
    "candidate_field_v3": ("neumesh_tpu_torch/csrc/candidate_field.cu",
                           "neumesh_tpu/ops/pallas_kernels.py:203"),
    "candidate_field": ("neumesh_tpu_torch/csrc/candidate_field.cu",
                        "neumesh_tpu/ops/pallas_kernels.py:60"),
    # no TPU kernel: the JAX package's tile bounds are plain jnp
    "candidate_bounds": ("neumesh_tpu_torch/csrc/candidate_bounds.cu",
                         "neumesh_tpu/models/neumesh/model.py:1180"),
}
# rows whose kernel has a source of its own: (kernel, mode) -> source
ROW_SOURCES = {FD: "neumesh_tpu_torch/csrc/field_distance.cu"}
# the kernel symbols torch.profiler attributes device time to, beside
# KERNELS': field_fused's distance mode
PROFILE_KEYS = (*KERNELS, "field_distance")

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
# every structure binds its rays to 128-ray tile contexts with use_pallas,
# so each launches candidate_bounds once a frame
_SURF_MODES = {(FF, "distance"), (SR, "rebracket"), (FF, "full"), CB}
# structure: (model, renderer, frame side, render kwargs, kernel modes it
# must launch, timing reps)
STRUCTURES = {
    "serving_bf16": ("vol_bf16", "volume", 256, VOL_RENDER,
                     {(FF, "distance"), (FF, "density"), (FF, "full"),
                      (SR, "rebracket"), CB}, 5),
    "reference_f32": ("vol_f32", "volume", 128, REF_RENDER,
                      {(FF, "density"), (FF, "full"), CB}, 3),
    "surface_fast": ("surf_bf16", "surface", 256, SURF_RENDER, _SURF_MODES,
                     5),
    "surface_f32": ("surf_f32", "surface", 128, SURF_RENDER, _SURF_MODES, 5),
    "surface_locate": ("surf_locate", "surface", 256, SURF_RENDER,
                       {("surface_locate", "bf16"), (FF, "full"), CB}, 5),
    "surface_shade": ("surf_bf16", "surface", 256, dict(SURF_RENDER, **SHADE),
                      {(FF, "density"), (FF, "full"), (FF, "density_nabla"),
                       CB}, 5),
    "nonablas_surface": ("nonablas_surf", "surface", 256, SURF_RENDER,
                         {("candidate_field_v3", "ds_feat"),
                          (FF, "density_nabla"), CB}, 5),
    "nonablas_volume": ("nonablas_vol", "volume", 256, VOL_RENDER,
                        {("candidate_field_v3", "ds_feat"), CB}, 5),
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
# rows of a kernel's block: of one or (the tile kernels below 64 rows a
# context) several contexts
BLOCK_ROWS = {"field_fused": 64, "field_fused_edit": 64, "secant_refine": 64,
              "surface_locate": 64, "candidate_field_v3": 32,
              "candidate_field": 32, "candidate_bounds": 128}
# crops through the plain versions: least PSNR of rgb (and of the surface
# normals, peak-to-peak 2) kernel vs plain, by the structure's model dtype
CROP_PSNR = {"bf16": 30.0, "f32": 55.0}
# field_fused_edit's row at the swap cell's shapes: one 60,032-ray chunk of
# 128-ray tiles (469 contexts), the plain version on every 15th context;
# the share by which the kernel's painted count may differ from the plain
# version's (a kNN near-tie may move a pick onto or off an edited vertex)
EDIT_CELL_B, EDIT_CELL_EVERY, PAINTED_TOL = 469, 15, 1e-4
# candidate_bounds' row at the surface cell's shapes: the 800 x 600 frame's
# 480,000 rays in 128-ray tiles
BOUNDS_CELL_TILES = 3750
# the structure whose per-frame count a kernel's `launches` reports: the
# volume serving structure for the kernels of the first slice (as that
# slice printed it), the structure that brought each later kernel onto a
# path; candidate_field (v2) is on none, field_fused_edit on the edited
# renders alone (phase 8's cases); candidate_bounds is on every structure,
# and counted on the surface serving one, whose cell it was written for
LAUNCHES_OF = {"field_fused": "serving_bf16", "field_fused_edit": None,
               "secant_refine": "serving_bf16",
               "surface_locate": "surface_locate",
               "candidate_field_v3": "nonablas_surface",
               "candidate_field": None, "candidate_bounds": "surface_fast"}


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


def graph_ms(fn, reps=20):
    """Device ms of one call of fn: reps calls captured in a CUDA graph,
    the median of three replays (no host launch cost between them)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    ms = []
    for _ in range(3):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        g.replay()
        e1.record()
        e1.synchronize()
        ms.append(e0.elapsed_time(e1) / reps)
    del g
    return sorted(ms)[1]


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
    if name == "field_fused_edit":
        return "full"
    if name == "candidate_bounds":
        return "tiled"
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
    """(bf16 flops, f32 flops on the tensor cores, f32 flops on the CUDA
    cores) of the weight matrices in ws: an f32 hidden layer runs as the
    bf16 split, an f32 head (N <= 3) on the CUDA cores."""
    import torch
    bf, tc, cc = 0.0, 0.0, 0.0
    for w in ws:
        if w.dim() == 2 and w.shape[0] > 1:
            f = 2.0 * w.shape[0] * w.shape[1]
            if w.dtype == torch.bfloat16:
                bf += f
            elif w.shape[1] > 3:
                tc += f
            else:
                cc += f
    return bf, tc, cc


def _nbytes(ts):
    return float(sum(t.numel() * t.element_size() for t in ts
                     if t is not None and hasattr(t, "numel")))


def field_work(args, kw):
    xyz, geo, feat = args[0], args[1], args[2]
    dens_ws = args[4] if len(args) > 4 else kw.get("dens_ws", ())
    col_ws = args[5] if len(args) > 5 else kw.get("col_ws")
    dirs = args[6] if len(args) > 6 else kw.get("dirs")
    want, k = kw.get("want", "density"), kw.get("k", 8)
    B, S, _ = xyz.shape
    C, F = geo.shape[2], feat.shape[-1]
    n = float(B * S)
    cc = n * C * (10 + (k if k > 1 else 1))           # d2 + selection
    bf = tc = 0.0
    n_out = {"distance": 1, "density": 1, "density_nabla": 4, "full": 7}
    ins = [xyz, geo]
    if want != "distance":
        cc += n * (30 * k + 2 * k * F)                 # interp + blend
        w = list(_mlp_flops(dens_ws))
        if want != "density":
            # the tangent dD/dh: w0d, the hidden layers and the head; fg and
            # its embedding (the w0f rows) do not depend on h
            w = [x + y for x, y in
                 zip(w, _mlp_flops((dens_ws[0], *dens_ws[3:])))]
        bf, tc, cc = bf + n * w[0], tc + n * w[1], cc + n * w[2]
        ins += [feat, *dens_ws]
    if want == "full":
        b2, t2, c2 = _mlp_flops(col_ws)
        bf, tc, cc = bf + n * b2, tc + n * t2, cc + n * c2
        ins += [dirs, *col_ws]
    nbytes = _nbytes(ins) + n * 4 * n_out[want]
    return bf, tc, cc, nbytes


def edit_work(args, kw):
    """field_work's `full` (its seven output planes four) and, a reference,
    its colour MLP, the blend of its cd + 1 edit columns over the k picks
    and its rows and weights read."""
    bf, tc, cc, nbytes = field_work(args, dict(kw, want="full"))
    xyz, refs = args[0], args[7]
    n = float(xyz.shape[0] * xyz.shape[1])
    k = kw.get("k", 8)
    for r in refs:
        b2, t2, c2 = _mlp_flops(r.col_ws)
        bf, tc = bf + n * b2, tc + n * t2
        cc += n * (c2 + 2 * k * r.rows.shape[-1])
        nbytes += _nbytes([r.rows, *r.col_ws])
    return bf, tc, cc, nbytes - n * 4 * 3


def secant_work(args, kw):
    rays_o, geo, feat, dens_ws = args[0], args[6], args[7], args[9]
    R = rays_o.shape[0]
    C, F = geo.shape[2], feat.shape[-1]
    k = kw.get("k", 8)
    evals = kw.get("n_iters", 6) + (2 if kw.get("d_low_w") is not None
                                    else 0)
    b1, t1, c1 = _mlp_flops(dens_ws)
    per_eval = (30 * k + 2 * k * F) + c1
    if kw.get("frozen_knn"):
        cc = R * (C * (20 + k) + evals * per_eval)
    else:
        cc = R * evals * (C * (10 + k) + per_eval)
    nbytes = _nbytes([geo, feat, *dens_ws]) + R * 4 * (6 + 6 + 1)
    return R * evals * b1, R * evals * t1, cc, nbytes


def locate_work(args, kw):
    """n_steps distance evaluations and 2 + n_secant density evaluations
    per ray."""
    rays_o, geo, feat, dens_ws = args[0], args[4], args[5], args[7]
    R = rays_o.shape[0]
    C, F = geo.shape[2], feat.shape[-1]
    k = kw.get("k", 8)
    interp = C * (10 + k) + 30 * k
    n_dens = 2 + kw.get("n_secant", 6)
    b1, t1, c1 = _mlp_flops(dens_ws)
    cc = R * (kw.get("n_steps", 24) * interp
              + n_dens * (interp + 2 * k * F + c1))
    # rays_o, rays_d, near, far in; four planes out
    nbytes = _nbytes([geo, feat, *dens_ws]) + R * 4 * (3 + 3 + 2 + 4)
    return R * n_dens * b1, R * n_dens * t1, cc, nbytes


def candidate_work(name, args, kw):
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
    cc = n * (C * (10 + k) + 30 * k + 2 * k * F)
    if want_feat:
        ins.append(feat)
    nbytes = _nbytes(ins) + n * 4 * ((4 if want_dh else 1) + F)
    return 0.0, 0.0, cc, nbytes


def bounds_work(args):
    """candidate_bounds: 17 f32 operations a (ray, candidate) pair (ov, t_c
    and |ov|^2, d_perp^2, s^2 and its test; the covered pairs' square root
    and running bounds left out); the rays, near and far read, near and
    far written, the candidates read."""
    rays_o, pts = args[0], args[4]
    R = rays_o.shape[0]
    return (0.0, 0.0, 17.0 * R * pts.shape[1],
            _nbytes(args[:5]) + R * 4 * 2)


def kernel_bound(name, args, kw, f32_tc_rate=H100_F32_SPLIT_FLOPS):
    """(ms, "operations" | "bytes"): the larger of the call's operations
    over the card's peak rates (bf16 and the f32 hidden layers on the
    tensor cores, the f32 hidden layers at f32_tc_rate; the rest of the f32
    work on the CUDA cores) and its bytes over the memory rate.
    f32_tc_rate=H100_F32_FLOPS gives the CUDA-core bound of the f32
    layers, the yardstick before they moved to the tensor cores."""
    if name == "field_fused":
        bf, tc, cc, nbytes = field_work(args, kw)
    elif name == "field_fused_edit":
        bf, tc, cc, nbytes = edit_work(args, kw)
    elif name == "secant_refine":
        bf, tc, cc, nbytes = secant_work(args, kw)
    elif name == "surface_locate":
        bf, tc, cc, nbytes = locate_work(args, kw)
    elif name == "candidate_bounds":
        bf, tc, cc, nbytes = bounds_work(args)
    else:
        bf, tc, cc, nbytes = candidate_work(name, args, kw)
    t_ops = (bf / H100_BF16_FLOPS + tc / f32_tc_rate
             + cc / H100_F32_FLOPS) * 1e3
    t_bytes = nbytes / H100_BYTES * 1e3
    return (max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def cuda_core_bound(name, args, kw):
    """kernel_bound with every f32 flop at the CUDA-core rate (ms)."""
    return kernel_bound(name, args, kw, H100_F32_FLOPS)[0]


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
    """Build every library, the host-geometry library (g++) beside the
    kernels' (nvcc, all at once); per kernel library the [build] line
    gives ptxas's registers and spills of each kernel function and the
    HGMMA (wgmma) instructions in each function's SASS. Returns (seconds
    of the whole build, seconds of the host library's)."""
    from concurrent.futures import ThreadPoolExecutor

    from neumesh_tpu_torch.ops import _build

    def host():
        t = time.perf_counter()
        path = _build.build_host()
        return path, time.perf_counter() - t
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as ex:
        host_job = ex.submit(host)
        _build.build_all()
        host_path, host_s = host_job.result()
    secs = time.perf_counter() - t0
    log(f"[build] host library (g++): {host_s:.1f} s, "
        f"{os.path.basename(host_path)}")
    for name, info in _build.BUILD_LOG.items():
        lines = [ln.replace("ptxas info    : ", "").strip()
                 for ln in info["ptxas"].splitlines()
                 if ("registers" in ln or "spill" in ln
                     or "Compiling entry" in ln) and "(C75" not in ln]
        counts = hgmma_counts(_build._lib_path(name))
        hg = ("no cuobjdump in the toolkit" if counts is None else
              "HGMMA " + ", ".join(f"{fn}: {n}" for fn, n in counts.items()))
        roles = ""
        if name in _build.WS_KERNELS:
            roles = ("; setmaxnreg: producer warpgroup "
                     f"{_build.WS_REGS['producer']}, consumers "
                     f"{_build.WS_REGS['consumer']} registers a thread "
                     "(ptxas counts the launch's 96)")
        log(f"[build] {name}: {info['seconds']:.1f} s; " + " | ".join(lines)
            + f"; {hg}{roles}")
    return secs, host_s


@contextlib.contextmanager
def shared_memory_probe(smem):
    """For the block, every kernel launch also asks its library's `_smem`
    entry for the dynamic shared memory of a block at the launch's
    arguments, and keeps the largest per kernel in smem."""
    import ctypes
    from neumesh_tpu_torch.ops import _build
    launch = _build.launch

    def probed(name, args, operand):
        launch(name, args, operand)
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
    a, kw = rec["surface_fast"][CB]
    a = bounds_cell_call(a)
    out.append((*CB, "surface_cell", a, kw, "f32"))
    timed[CB] = ("surface_cell", a, kw)
    return out, timed


def bounds_cell_call(a):
    """candidate_bounds' arguments at the surface cell's shapes from a
    recorded call: its tiles (rays, near, far and candidates) repeated to
    BOUNDS_CELL_TILES."""
    import torch
    rays_o, rays_d, near, far, pts, tile = a[:6]
    Rt = pts.shape[0]
    rep = torch.arange(BOUNDS_CELL_TILES, device=pts.device) % Rt

    def tiles(t):
        return t.reshape(Rt, tile, -1)[rep].reshape(-1, t.shape[-1])
    return (*(tiles(t).contiguous() for t in (rays_o, rays_d, near, far)),
            pts[rep].contiguous(), *a[5:])


def check_outputs(name, mode, key, got, want):
    """(max |err|, share within tol, passed, extra fields) of one kernel
    call against its plain version, at TOL[key]: each output array is held
    to the share alone; in f32 the gradient outputs (nabla, dh) at
    TOL["f32_nabla"]."""
    tol = TOL[key]
    if name == "candidate_bounds":
        # near and far bit for bit
        import torch
        err, share = compare(got, want, tol)
        equal = all(torch.equal(g, w) for g, w in zip(got, want))
        return err, share, equal, {"bit_equal": equal}
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
        row["bound_cuda_core_ms"] = cuda_core_bound(name, a, kw)
        row["shapes"] = _shape_note(name, a)
        row["timed_variant"] = var
        row["max_abs_err"] = next(c["max_abs_err"] for c in row["checks"]
                                  if c["variant"] == var)


def edit_cell_call(rec, models):
    """field_fused_edit's (args, kw) at the swap cell's shapes, from the
    reference f32 structure's `full` call (S = 16,256, C = 128): its
    contexts repeated to EDIT_CELL_B, one reference with the same model's
    f32 colour weights, edit rows [codes m, m] of each context's own colour
    codes under m = its candidates at x > 0, and the swap cell's rotation,
    the 180-degree turn about x."""
    import torch
    from neumesh_tpu_torch.ops import kernels
    a, kw = rec["reference_f32"][(FF, "full")]
    rep = torch.arange(EDIT_CELL_B, device=DEV) % a[0].shape[0]
    xyz, geo, feat, dirs = (t[rep].contiguous()
                            for t in (a[0], a[1], a[2], a[6]))
    kw = {k: v for k, v in kw.items() if k != "want"}
    mask = (geo[:, 0] > 0).float()[..., None]
    rows = torch.cat([feat[..., kw["geometry_dim"]:] * mask, mask], -1)
    rot = torch.diag(torch.tensor([1.0, -1.0, -1.0], device=DEV))
    ref = kernels.EditRef(rows.contiguous(),
                          fold_weights(models["vol_f32"], None)[1], rot,
                          None, kw["multires_ft"], kw["multires_view"])
    return (xyz, geo, feat, a[3], a[4], a[5], dirs, [ref]), kw


def edit_cell_row(rec, models):
    """field_fused_edit's row at the swap cell's shapes (edit_cell_call):
    the kernel on all EDIT_CELL_B contexts, its outputs on every
    EDIT_CELL_EVERY-th context held against the plain version of those
    contexts at the f32 tolerance, and their painted counts (kernel and
    plain version on those contexts) compared; kernel ms, the plain
    version's ms on those contexts scaled to all of them, the bound."""
    import torch
    from neumesh_tpu_torch.ops import kernels
    a, kw = edit_cell_call(rec, models)
    sub = torch.arange(0, EDIT_CELL_B, EDIT_CELL_EVERY, device=DEV)
    a_sub = (*(t[sub].contiguous() for t in a[:3]), *a[3:6],
             a[6][sub].contiguous(),
             [r._replace(rows=r.rows[sub].contiguous()) for r in a[7]])
    got = [g[sub] for g in kernels.field_fused_edit(*a, **kw)]
    want = kernels.field_fused_edit_plain(*a_sub, **kw)
    painted = [torch.zeros(1, dtype=torch.int64, device=DEV)
               for _ in range(2)]
    kernels.field_fused_edit(*a_sub, painted=painted[0], **kw)
    kernels.field_fused_edit_plain(*a_sub, painted=painted[1], **kw)
    torch.cuda.synchronize()
    err, share, ok, _ = check_outputs(*FE, "f32", got, want)
    n_k, n_p = int(painted[0]), int(painted[1])
    held = got[0].numel()
    log(f"[check] field_fused_edit/full swap_cell (f32, {len(sub)} of "
        f"{EDIT_CELL_B} contexts held): max|err| {err:.3e}, within tol "
        f"{share:.5f}, painted {n_k} kernel / {n_p} plain of {held} "
        f"({'ok' if ok else 'FAIL'})")
    if not ok:
        raise AssertionError(f"field_fused_edit at the swap cell's shapes "
                             f"disagrees with its plain version: {share:.4f}"
                             " within tol")
    if not 0 < n_p < held or abs(n_k - n_p) > PAINTED_TOL * n_p:
        raise AssertionError(f"field_fused_edit painted {n_k}, plain {n_p} "
                             f"of {held} samples")
    tol = TOL["f32"]
    n_plain = len(sub)
    del got, want
    torch.cuda.empty_cache()
    bound, by = kernel_bound(FE[0], a, kw)
    return {"checks": [{"variant": "swap_cell", "max_abs_err": err,
                        "frac_within_tol": share, "atol": tol["atol"],
                        "rtol": tol["rtol"], "min_frac": tol["frac"],
                        "contexts_held": n_plain,
                        "painted_kernel": n_k, "painted_plain": n_p,
                        "samples_held": held}],
            "ms": cuda_ms(lambda: kernels.field_fused_edit(*a, **kw),
                          reps=3),
            "plain_ms": cuda_ms(lambda: kernels.field_fused_edit_plain(
                *a_sub, **kw), reps=1) * EDIT_CELL_B / n_plain,
            "plain_ms_from": f"{n_plain} of {EDIT_CELL_B} contexts, scaled",
            "bound_ms": bound, "bound_by": by,
            "bound_cuda_core_ms": cuda_core_bound(FE[0], a, kw),
            "shapes": _shape_note(FE[0], a), "timed_variant": "swap_cell",
            "max_abs_err": err}


def run_stage_split(variants):
    """{"kernel/mode variant": kernels.stage_split(...)} of SPLIT_ROWS on
    their recorded inputs; each row's shares finite and summing to 1."""
    from neumesh_tpu_torch.ops import kernels
    out = {}
    for name, mode, var, args, kw, *_ in variants:
        tag = f"{name}/{mode} {var}"
        if (name, mode, var) not in SPLIT_ROWS or tag in out:
            continue
        sp = kernels.stage_split(name, *args, **kw)
        sp["smem"] = kernels.tile_smem_plan(name, *args, **kw)
        total = sum(sp["share"].values())
        if not (all(math.isfinite(v) for v in sp["share"].values())
                and abs(total - 1.0) < 1e-6 and sp["us_per_tile"] > 0):
            raise AssertionError(f"stage split of {tag}: {sp}")
        out[tag] = sp
        log(f"[split] {tag}: {sp['us_per_tile']:.2f} us a tile, "
            f"{sp['tiles']} tiles on {sp['blocks']} blocks; "
            + ", ".join(f"{k} {v:.3f}" for k, v in sp["share"].items()))
        log(f"[build] {tag}: {sp['smem']['bytes']} B of shared memory a "
            f"block, a ring of {sp['smem']['ring']} slots, "
            f"{sp['smem']['staged']} staged contexts (the timing "
            "instantiation adds its stage sums)")
    if len(out) != len(SPLIT_ROWS):
        raise AssertionError(f"stage split: rows {sorted(out)}")
    return out


def distance_floor_ms(args):
    """The distance scan's instruction floor: DIST_INSTR separately issued
    f32 instructions a candidate and sample at H100_F32_ISSUE (ms); the
    roofline bound counts the same chain as flops at 67 TFLOP/s."""
    B, S, _ = args[0].shape
    return B * S * args[1].shape[2] * DIST_INSTR / H100_F32_ISSUE * 1e3


def time_distance_call(a, kw):
    """One field_fused(want="distance") call held against its plain
    version on the card (f32 tolerance) and timed: ms (CUDA events around
    launches, as every row), device_ms (graph_ms: the small calls' events
    time the host's launch), plain ms, bound, instruction floor, live
    share of its blocks."""
    import torch
    from neumesh_tpu_torch.ops import kernels
    with torch.no_grad():
        got = kernels.field_fused(*a, **kw)
        want = kernels.field_fused_plain(*a, **kw)
        err, share = compare(got, want, TOL["f32"])
        tag = f"distance k={kw.get('k', 8)} {_shape_note(FD[0], a)}"
        if share < TOL["f32"]["frac"]:
            raise AssertionError(f"{tag} disagrees with its plain version: "
                                 f"{share:.4f} within tol")
        ms = cuda_ms(lambda: kernels.field_fused(*a, **kw), reps=10)
        device_ms = graph_ms(lambda: kernels.field_fused(*a, **kw))
        plain_ms = cuda_ms(lambda: kernels.field_fused_plain(*a, **kw),
                           reps=2)
    bound, by = kernel_bound(FD[0], a, kw)
    row = {"k": kw.get("k", 8), "shapes": _shape_note(FD[0], a), "ms": ms,
           "device_ms": device_ms, "plain_ms": plain_ms, "bound_ms": bound,
           "bound_by": by, "floor_ms": distance_floor_ms(a),
           "max_abs_err": err, "frac_within_tol": share,
           "live_share": live_share(FD[0], a, kw)}
    log(f"[distance] {tag}: {ms:.4f} ms, device {device_ms:.4f} (plain "
        f"{plain_ms:.3f}, bound {bound:.4f} {by}, floor "
        f"{row['floor_ms']:.4f}), max|err| {err:.3e}")
    return row


def distance_shapes(a, kw):
    """The distance kernel at (a) the serving scan's recorded call (k = 1),
    (b) the same at k = 8, (d) the render CLI's per-ray shapes made from
    it: 8 contexts a tile (4,096 at 512 tiles), each with the tile's first
    96 candidates and 256 of its samples, cut to S = 1, 16, 128 (k as
    recorded). (c), the editing swap's scan, is timed in phase 8."""
    import torch
    out = {"a_serving": time_distance_call(a, kw),
           "b_serving_k8": time_distance_call(a, dict(kw, k=8))}
    xyz, geo = a[0], a[1]
    B, S0, _ = xyz.shape
    g = geo[:, :, :96].repeat_interleave(8, 0).contiguous()
    x = xyz.reshape(B * 8, S0 // 8, 3)
    f = torch.zeros((g.shape[0], 96, 1), device=g.device)
    for S in (1, 16, 128):
        out[f"d_per_ray_S{S}"] = time_distance_call(
            (x[:, :S].contiguous(), g, f, *a[3:]), kw)
    return out


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
    by = {k: 0.0 for k in (*PROFILE_KEYS, "other")}
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
        # is not in "candidate_field_v3_kernel", "field_fused_kernel" not in
        # "field_distance_kernel" nor "field_fused_edit_kernel")
        key = next((k for k in PROFILE_KEYS if k + "_kernel" in ev.key),
                   "other")
        by[key] += us / 1e3
    busy = sum(by.values())
    return {"traced_wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": (1.0 - busy / wall_ms) if busy > 0 else None,
            "device_ms_by_kernel": {k: v for k, v in by.items() if v}}


def _shape_note(name, a):
    if name == "candidate_bounds":
        return {"R": a[0].shape[0], "tiles": a[4].shape[0], "T": a[5],
                "C": a[4].shape[1]}
    if name in ("field_fused", "field_fused_edit", "candidate_field_v3"):
        B, S, _ = a[0].shape
        return {"B": B, "S": S, "C": a[1].shape[2], "F": a[2].shape[-1],
                **({"refs": len(a[7])} if name == "field_fused_edit"
                   else {})}
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
    """For the block, every view the CLI renders (one frame entry call)
    appends its peak device memory above what was allocated before it
    (the model, its tables and the earlier views' results are not
    counted)."""
    import torch
    saved = (cli.render_image, cli.render_surface_image)

    def measured(entry):
        def fn(*a, **kw):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = entry(*a, **kw)
            torch.cuda.synchronize()
            peaks.append(torch.cuda.max_memory_allocated() - base)
            return out
        return fn
    cli.render_image, cli.render_surface_image = map(measured, saved)
    try:
        yield
    finally:
        cli.render_image, cli.render_surface_image = saved


def rows_per_context(name, args):
    """(contexts, samples or rays of each) of one kernel call."""
    if name in ("secant_refine", "surface_locate", "candidate_bounds"):
        B = args[6].shape[0] if name == "secant_refine" else args[4].shape[0]
        return B, args[0].shape[0] // B
    return args[0].shape[0], args[0].shape[1]


def live_share(name, args, kw=None):
    """Live rows over all rows of the call's blocks: the tile kernels'
    block plan (kernels.block_plan: below 64 rows a context a block spans
    several), field_fused's distance mode's (kernels.distance_block_plan),
    the candidate kernels' 32-sample blocks of one context."""
    from neumesh_tpu_torch.ops import kernels
    B, n = rows_per_context(name, args)
    if name == "field_fused" and (kw or {}).get("want") == "distance":
        return float(kernels.distance_block_plan(
            B, n, args[1].shape[2], kw.get("k", 8))[2].float().mean())
    if BLOCK_ROWS[name] == 64:
        return float(kernels.block_plan(B, n)[2].float().mean())
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
    case): timed call}, {case: [(rgb, normals) of each view]})."""
    import torch
    from neumesh_tpu_torch.cli import render as cli
    from neumesh_tpu_torch.ops import kernels
    cfg = write_cli_inputs(tmp)
    stats, counts, variants, timed, frames = {}, {}, [], {}, {}
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
            frames[tag] = list(zip(out["rgb"], out["normals"]))
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
                                      "live_share": live_share(name, a, kw)})
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
    return stats, counts, variants, timed, frames


def time_cli_calls(timed, stats):
    """Kernel ms, plain ms and bound of the first call of each (kernel,
    mode, rows a context) of each case, into the case's
    per_frame_calls."""
    from neumesh_tpu_torch.ops import kernels
    for (name, mode, n, tag), (a, kw) in timed.items():
        fn = getattr(kernels, name)
        plain = getattr(kernels, name + "_plain")
        ms = cuda_ms(lambda: fn(*a, **kw))
        plain_ms = cuda_ms(lambda: plain(*a, **kw), reps=2)
        bound, by = kernel_bound(name, a, kw)
        bound_cc = cuda_core_bound(name, a, kw)
        for row in stats[tag]["per_frame_calls"]:
            if (row["kernel"], row["mode"], row["rows_per_context"]) == \
                    (name, mode, n):
                row.update(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                           bound_by=by, bound_cuda_core_ms=bound_cc,
                           shapes=_shape_note(name, a))
        log(f"[cli] {tag}: {name}/{mode} at {n} rows a context: {ms:.3f} ms "
            f"(plain {plain_ms:.3f}, bound {bound:.4f}, {by}; CUDA-core "
            f"bound {bound_cc:.4f})")


# ---------------------------------------------------------------------------
# inputs that phases 7-8 hand to phase 10 (host geometry)
# ---------------------------------------------------------------------------

# "march": the teacher's 256^3 extraction, "arap": the ARAP swap's warp,
# "cast": the paint rays; each a list of (args, kwargs) of the calls
HOST_INPUTS = {}


@contextlib.contextmanager
def keep_args(module, name, key):
    """For the block, every call of module.<name> also keeps its arguments
    in HOST_INPUTS[key], for phase 10's replays."""
    fn = getattr(module, name)

    def kept(*a, **kw):
        HOST_INPUTS.setdefault(key, []).append((a, kw))
        return fn(*a, **kw)
    setattr(module, name, kept)
    try:
        yield
    finally:
        setattr(module, name, fn)


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
                     "bound_cuda_core_ms": cuda_core_bound(name, a, kw),
                     "live_share": live_share(name, a, kw)})
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
                             (SR, "rebracket"), CB},
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
            with keep_args(cli, "extract_isosurface", "march"):
                mesh = cli.main(["--config", cfg_path, "--ckpt_path", ckpt,
                                 "--N_grid", str(n), "--chunk", "65536",
                                 "--output_dir",
                                 os.path.join(tmp, "mesh_neus"),
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
    (edited: field_fused_edit) call and discard the missed rays' values, which they evaluate at the
    placeholder point (1, 1, 1), outside the unit bounding sphere. On
    trained weights that point sits far from every candidate, where the f32
    nabla is ill-conditioned: kernel, plain version on the card and plain
    version on the CPU disagree there by up to ~5e-4 alike. Those rows are
    reported beside the check; the hit rows are held to the tolerance."""
    if not tag.startswith("surface") or name not in (FF, FE[0]):
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
    return result, counts, p


# ---------------------------------------------------------------------------
# phase 8: editing
# ---------------------------------------------------------------------------

# the swap's views (the editing gate's), the crop side held against the
# plain versions, the masks' cap fraction (the gate's), the correspondence
# pairs of the swap's estimate, the wave of the geometry edit, the uv
# bands of the fill, the painting iterations (the example paint config)
EDIT_VIEWS, EDIT_CROP, EDIT_XFRAC, EDIT_CORR = "1,11", 64, 0.5, 5
WAVE = dict(amp=0.08, freq=6.0)
FILL_BANDS = ((0.15, 0.45), (-0.45, -0.15))
PAINT_ITERS = 40
SURF_FLAGS = ["--render_mode", "surface", "--surface_ray_tile", "128",
              "--surface_scan", "distance"]
# case: (CLI, flags, knobs set on the loaded models, views, the kernel
# modes it must launch, rendered unedited too)
EDIT_CASES = {
    "swap_volume": ("swap", [], {}, EDIT_VIEWS, {(FF, "density")}, True),
    "swap_surface": ("swap", SURF_FLAGS, dict(use_pallas=True), EDIT_VIEWS,
                     {(FF, "distance"), (SR, "rebracket"),
                      (FF, "density_nabla"), FE, CB}, True),
    "swap_locate": ("swap", SURF_FLAGS,
                    dict(use_pallas=True, use_fused_locate=True), EDIT_VIEWS,
                    {("surface_locate", "f32"), (FF, "density_nabla"), FE,
                     CB}, True),
    "swap_arap": ("swap", ["--use_arap"], {}, "1", {(FF, "density")}, False),
    "fill": ("fill", [], {}, "1", {(FF, "density")}, False),
    "geometry": ("geometry", [], {}, "1", {(FF, "density")}, False),
}
PAINT_MUST = {(FF, "density")}


def write_edit_inputs(tmp, p):
    """Phase 7's gate scene made editable: the swap's cap masks (main +x,
    reference -x of the same model) and EDIT_CORR pairs (the main cap's
    pole and points around it, each with the reference-cap vertex
    nearest its image under the 180-degree turn about y), the fill's uv charts of two
    bands, the wave-deformed scaffold, a painted copy of the scene; the
    editing JSONs pointing at them. Returns {case kind: JSON path}."""
    from neumesh_tpu_torch.editing.align import umeyama
    from neumesh_tpu_torch.mesh.triangle_mesh import load_mesh, save_ply
    from neumesh_tpu_torch.tools import make_example_scene as mes
    d = os.path.join(tmp, "edit")
    os.makedirs(d, exist_ok=True)
    mesh = load_mesh(p["mesh_path"])
    v = mesh.vertices
    main_cap = v[:, 0] > EDIT_XFRAC * v[:, 0].max()
    ref_cap = v[:, 0] < EDIT_XFRAC * v[:, 0].min()
    for name, m in (("mask_main", main_cap), ("mask_ref", ref_cap)):
        colors = np.where(m[:, None], [1.0, 0.0, 0.0], [0.0, 0.0, 0.0])
        save_ply(type(mesh)(v.copy(), mesh.triangles.copy(),
                            vertex_colors=colors),
                 os.path.join(d, name + ".ply"))
    # the cap's pole and EDIT_CORR - 1 points 35 degrees around it
    cap = np.where(main_cap)[0]
    a = np.deg2rad(35.0)
    phi = 2 * np.pi * np.arange(EDIT_CORR - 1) / (EDIT_CORR - 1)
    dirs = np.concatenate([[[1.0, 0.0, 0.0]], np.stack(
        [np.full_like(phi, np.cos(a)), np.sin(a) * np.cos(phi),
         np.sin(a) * np.sin(phi)], -1)])
    r = np.linalg.norm(v[cap], axis=-1).mean()
    main_ids = cap[np.argmin(((r * dirs[:, None] - v[cap][None]) ** 2)
                             .sum(-1), 1)]
    ref_ids = np.where(ref_cap)[0]
    tgt = v[main_ids] * [-1.0, 1.0, -1.0]
    d2 = ((tgt[:, None] - v[ref_ids][None]) ** 2).sum(-1)
    corr = np.stack([main_ids, ref_ids[np.argmin(d2, 1)]], 1)
    T0 = umeyama(v[corr[:, 0]], v[corr[:, 1]])
    T0 = T0[:3, :3] / np.cbrt(np.linalg.det(T0[:3, :3]))
    _, top = mes.band_mask_mesh(mesh, *FILL_BANDS[0], (1.0, 0.0, 0.0))
    _, bot = mes.band_mask_mesh(mesh, *FILL_BANDS[1], (1.0, 0.0, 0.0))
    save_ply(mes.uv_chart_mesh(mesh, top), os.path.join(d, "uv_main.ply"))
    save_ply(mes.uv_chart_mesh(mesh, bot), os.path.join(d, "uv_ref.ply"))
    save_ply(mes.deformed_mesh(mesh, **WAVE), os.path.join(d, "wave.ply"))
    mes.paint_dataset(p["scene"], os.path.join(tmp, "paint_scene"))
    cfg = os.path.join(p["nm_dir"], "config.yaml")
    ckpt = os.path.join(p["nm_dir"], "ckpts", "latest.ckpt")
    jsons = {
        "swap": {"main_config": cfg, "main_ckpt": ckpt,
                 "main_mask_mesh": [os.path.join(d, "mask_main.ply")],
                 "ref_config": [cfg], "ref_ckpt": [ckpt],
                 "ref_mask_mesh": [os.path.join(d, "mask_ref.ply")],
                 "corr": [corr.tolist()]},
        "fill": {"main_config": cfg, "main_ckpt": ckpt,
                 "main_mask_mesh": [os.path.join(d, "uv_main.ply")],
                 "ref_config": [cfg], "ref_ckpt": [ckpt],
                 "ref_mask_mesh": [os.path.join(d, "uv_ref.ply")],
                 "step": [2]},
        "geometry": {"main_config": cfg, "load_pt": ckpt,
                     "deformed_mesh": os.path.join(d, "wave.ply")},
        "paint": {"main_config": cfg, "paint_name": "chip",
                  "paint_dir": os.path.join(tmp, "paint_scene"),
                  "ckpt_path": ckpt, "num_iters": PAINT_ITERS, "i_val": -1,
                  "lr": 0.01},
    }
    paths = {}
    for k, j in jsons.items():
        paths[k] = os.path.join(d, k + ".json")
        with open(paths[k], "w") as f:
            json.dump(j, f)
    return paths, {"n_vertices": mesh.n_vertices,
                   "n_triangles": mesh.n_triangles,
                   "main_cap": int(main_cap.sum()),
                   "ref_cap": int(ref_cap.sum()),
                   "corr_umeyama_vs_y180": float(np.abs(
                       T0 - np.diag([-1.0, 1.0, -1.0])).max())}


@contextlib.contextmanager
def edit_hooks(knobs, store, tile_flags):
    """For the block: the knobs set on every model the editing CLIs load;
    every render_function call kept in `store` (args, model, kwargs, the
    frame entry it called with its keywords, and each view's raw (rgb,
    depth, extras)); per tiled binding of an editable, each ray's "its
    tile candidates hold an edited vertex" flag appended to tile_flags."""
    from neumesh_tpu_torch.cli import render as cli
    from neumesh_tpu_torch.cli.editing import render_geometry_editing as geo
    from neumesh_tpu_torch.editing import renderer_base as rb
    from neumesh_tpu_torch.editing.texture_model import \
        TextureEditableNeuMesh as TE
    saved = (rb.load_neumesh_from_config, geo.load_neumesh_from_config,
             cli.render_function, TE.bind_rays_tiled)

    def load(*a, **kw):
        out = saved[0](*a, **kw)
        for k, v in knobs.items():
            setattr(out[0], k, v)
        return out

    def render_function(args, model, kwargs):
        entry = {"args": args, "model": model, "kwargs": kwargs,
                 "views": [], "call": None}

        def recorded(fn):
            def call(*a, **kw):
                out = fn(*a, **kw)
                entry["views"].append(out)
                entry["call"] = (fn, kw)
                return out
            return call
        # around the entries as they are now: a hook of an enclosing
        # block wraps these wrappers in turn, and both record
        current = (cli.render_image, cli.render_surface_image)
        cli.render_image, cli.render_surface_image = map(recorded, current)
        try:
            entry["out"] = saved[2](args, model, kwargs)
        finally:
            cli.render_image, cli.render_surface_image = current
        store.append(entry)
        return entry["out"]

    def bind_tiled(self, *a, **kw):
        out = saved[3](self, *a, **kw)
        if out is not None:
            tile_flags.append(out[0]._masks[0].any(-1).repeat_interleave(
                kw["tile"]))
        return out

    rb.load_neumesh_from_config = geo.load_neumesh_from_config = load
    cli.render_function = render_function
    TE.bind_rays_tiled = bind_tiled
    try:
        yield
    finally:
        (rb.load_neumesh_from_config, geo.load_neumesh_from_config,
         cli.render_function, TE.bind_rays_tiled) = saved


def crop_psnr(entry):
    """PSNR of the central EDIT_CROP^2 crop of the case's first view
    rendered by its frame entry through the kernels and through the plain
    versions on the card."""
    from neumesh_tpu_torch.dataio import get_data
    args, (fn, kw) = entry["args"], entry["call"]
    ds = get_data(args, downscale=1)
    vi = int(str(args.camera_inds).split(",")[0])
    K = np.array(ds.intrinsics_all[vi], np.float32)
    K[0, 2] -= (ds.W - EDIT_CROP) / 2
    K[1, 2] -= (ds.H - EDIT_CROP) / 2
    if "block" in kw:
        kw = dict(kw, block=(1, EDIT_CROP))     # the volume CLI's raster
    cam = (entry["model"], ds.c2w_all[vi], K, EDIT_CROP, EDIT_CROP)
    a = fn(*cam, **kw)[0]
    with plain_on_card():
        b = fn(*cam, **kw)[0]
    mse = float(((a - b) ** 2).mean())
    return 10 * math.log10(1.0 / max(mse, 1e-20))


def surface_checks(tag, edited, plain, flags, n_views):
    """The surface swap against the same mode unedited: depth and hit mask
    equal; on the rays whose tile candidates hold no edited vertex the rgb
    within the f32 tolerance on >= 99% of them (the unedited render shades
    with one `full` launch, the editable with use_pallas and nablas input
    with one field_fused_edit launch, else on the context math: a kNN
    near-tie may resolve differently on the two routes, so the largest
    difference is reported, not held); the edit engaged on the others."""
    import torch
    from neumesh_tpu_torch.ops.rays import raster_order
    H, W = edited["out"]["H"], edited["out"]["W"]
    per = len(flags) // n_views
    tol = TOL["f32"]
    out = {"untouched_rays": 0, "touched_rays": 0,
           "untouched_max_abs_diff": 0.0, "untouched_within_tol": 1.0,
           "untouched_outside_tol": 0, "touched_max_abs_diff": 0.0}
    for v in range(n_views):
        (rgb_e, dep_e, ex_e), (rgb_p, dep_p, ex_p) = (
            edited["views"][v], plain["views"][v])
        if not (torch.equal(dep_e, dep_p)
                and torch.equal(ex_e["mask_surface"], ex_p["mask_surface"])):
            raise AssertionError(f"{tag}: depth or hit mask moved by the "
                                 "texture edit")
        touched = raster_order(torch.cat(flags[v * per:(v + 1) * per])
                               [:H * W], H, W, 8, 16)
        diff = (rgb_e - rgb_p).abs().amax(-1)
        ok = diff <= tol["atol"] + tol["rtol"] * rgb_p.abs().amax(-1)
        un = ~touched
        out["untouched_rays"] += int(un.sum())
        out["touched_rays"] += int(touched.sum())
        if bool(un.any()):
            out["untouched_max_abs_diff"] = max(
                out["untouched_max_abs_diff"], float(diff[un].max()))
            out["untouched_within_tol"] = min(
                out["untouched_within_tol"], float(ok[un].float().mean()))
            out["untouched_outside_tol"] += int((~ok[un]).sum())
        if bool(touched.any()):
            out["touched_max_abs_diff"] = max(out["touched_max_abs_diff"],
                                              float(diff[touched].max()))
    if out["untouched_rays"] == 0 or out["touched_rays"] == 0:
        raise AssertionError(f"{tag}: no untouched or no touched rays {out}")
    if out["untouched_within_tol"] < tol["frac"]:
        raise AssertionError(f"{tag}: rgb moved outside the edit {out}")
    if out["touched_max_abs_diff"] <= 1e-2:
        raise AssertionError(f"{tag}: the edit never engaged {out}")
    return out


def run_editing(tmp, card, p):
    """Phase 8. Returns (the {"editing"} dict, {case: launch counts})."""
    import torch
    from neumesh_tpu_torch.cli import render as cli
    from neumesh_tpu_torch.cli.editing import paint as paint_cli
    from neumesh_tpu_torch.cli.editing import render_geometry_editing as geo
    from neumesh_tpu_torch.cli.editing import render_texture_filling as fill
    from neumesh_tpu_torch.cli.editing import render_texture_swapping as swap
    from neumesh_tpu_torch.editing import paint_train
    from neumesh_tpu_torch.editing import swap as edit_swap
    from neumesh_tpu_torch.editing.renderer_base import \
        load_neumesh_from_config
    from neumesh_tpu_torch.mesh import raycast
    from neumesh_tpu_torch.ops import kernels
    from neumesh_tpu_torch.tools import editing_gate
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    jsons, scene = write_edit_inputs(tmp, p)
    mains = {"swap": swap.main, "fill": fill.main, "geometry": geo.main}
    result = {"card": card, "scene": scene, "cases": {}}
    counts, variants = {}, []

    for tag, (kind, flags, knobs, views, must, unedited) in \
            EDIT_CASES.items():
        argv = ["--config", jsons[kind], "--camera_inds", views,
                "--outbase", tag, "--device", DEV] + flags
        store, tile_flags, calls = [], [], []
        keep = (keep_args(edit_swap, "arap", "arap") if tag == "swap_arap"
                else contextlib.nullcontext())
        with contextlib.chdir(tmp), edit_hooks(knobs, store, tile_flags):
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            with record_calls(calls), keep:
                res = mains[kind](argv)
            torch.cuda.synchronize()
            cnt = {k: dict(v) for k, v in kernels.LAUNCHES.items()}
            missed = [f"{k}/{md}" for k, md in sorted(must)
                      if cnt[k][md] <= 0]
            if missed:
                raise AssertionError(f"edit {tag}: never launched {missed}")
            counts[tag] = cnt
            out = res["render"]
            for rgb in out["rgb"]:
                if rgb.shape != (out["H"], out["W"], 3) \
                        or not np.isfinite(rgb).all():
                    raise AssertionError(f"edit {tag}: frame {rgb.shape}")
            row = {"flags": flags, "knobs": knobs, "views": views,
                   "ms_per_view": [1e3 * s for s in out["view_s"]],
                   "stats_ms": {k[:-2] + "_ms": 1e3 * v
                                for k, v in res["stats"].items()},
                   "launches": {k: {m: c for m, c in md.items() if c}
                                for k, md in cnt.items()},
                   "replays": len(calls)}
            if res.get("T_r_m") is not None:
                T = np.asarray(res["T_r_m"][0])
                scale = np.cbrt(np.linalg.det(T[:3, :3]))
                row["T_r_m"] = T.tolist()
                row["T_r_m_vs_y180"] = float(np.abs(
                    T[:3, :3] / scale - np.diag([-1.0, 1.0, -1.0])).max())
                row["T_r_m_scale"] = float(scale)
            e = store[-1]
            if unedited:
                # the same mode unedited: the CLI's render_function on the
                # loaded main model, its views raw
                model = e["model"].main_model
                args = e["args"].copy()
                args.outbase = tag + "_unedited"
                torch.cuda.synchronize()
                store_u = []
                with edit_hooks({}, store_u, []):
                    out_u = cli.render_function(args, model, e["kwargs"])
                row["unedited_ms_per_view"] = [1e3 * s
                                               for s in out_u["view_s"]]
                if "--render_mode" in flags:
                    row["surface"] = surface_checks(
                        tag, e, store_u[-1], tile_flags,
                        len(views.split(",")))
            row["crop_psnr_db"] = crop_psnr(e)
            if row["crop_psnr_db"] < CROP_PSNR["f32"]:
                raise AssertionError(f"edit {tag}: crop kernel vs plain "
                                     f"{row['crop_psnr_db']:.2f} dB")
        del store, res, out, e
        live = ("surface" if "--render_mode" in flags else tag)
        variants += [(name, mode, f"edit_{tag}", a, kw, tol_key(name, kw))
                     + live_rows(live, name, a) for name, mode, a, kw in calls]
        del calls
        result["cases"][tag] = row
        log(f"[edit] {tag}: ms/view {[round(x, 1) for x in row['ms_per_view']]}"
            + (f" (unedited {[round(x, 1) for x in row['unedited_ms_per_view']]})"
               if unedited else "")
            + f", crop {row['crop_psnr_db']:.1f} dB, steps "
            + ", ".join(f"{k} {v:.1f}" for k, v in row["stats_ms"].items())
            + f"; launches {row['launches']}"
            + (f"; surface {row['surface']}" if "surface" in row else "")
            + (f"; T_r_m vs the 180-degree turn {row['T_r_m_vs_y180']:.2e}"
               if "T_r_m_vs_y180" in row else ""))
        torch.cuda.empty_cache()

    # (d) painting: PAINT_ITERS steps at the default batch; the first
    # step's kernel calls recorded
    first, build = [], paint_train.build_train_step

    def build_recording(*a, **kw):
        step = build(*a, **kw)

        def first_recorded(*sa, **skw):
            if first:
                return step(*sa, **skw)
            calls = []
            with record_calls(calls):
                r = step(*sa, **skw)
            first.append(calls)
            return r
        return first_recorded
    paint_train.build_train_step = build_recording
    try:
        with contextlib.chdir(tmp), keep_args(raycast, "cast_rays", "cast"):
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            res = paint_cli.main(["--config", jsons["paint"], "--device",
                                  DEV])
            torch.cuda.synchronize()
            paint_s = time.perf_counter() - t0
            cnt = {k: dict(v) for k, v in kernels.LAUNCHES.items()}
    finally:
        paint_train.build_train_step = build
    missed = [f"{k}/{md}" for k, md in sorted(PAINT_MUST) if cnt[k][md] <= 0]
    if missed:
        raise AssertionError(f"paint: never launched {missed}")
    counts["paint"] = cnt
    if res["it"] != PAINT_ITERS or not all(
            np.isfinite(list(s.values())).all() for s in res["losses"]):
        raise AssertionError("paint: a loss is not finite")
    with open(jsons["paint"]) as f:
        pj = json.load(f)
    before, _, _ = load_neumesh_from_config(pj["main_config"],
                                            pj["ckpt_path"], DEV)
    idx = torch.as_tensor(res["optimized_indices"], device=DEV)
    after = dict(res["model"].named_parameters())
    for name, p0 in before.named_parameters():
        p1 = after[name].detach()
        if name == "color_features":
            rest = torch.ones(p1.shape[0], dtype=torch.bool, device=DEV)
            rest[idx] = False
            if not torch.equal(p1[rest], p0[rest]) \
                    or not bool((p1[idx] != p0[idx]).any(-1).all()):
                raise AssertionError("paint: color_features rows moved "
                                     "outside the painted vertices, or a "
                                     "painted row did not move")
        elif not torch.equal(p1, p0):
            raise AssertionError(f"paint: {name} changed")
    del before
    variants += [(name, mode, "edit_paint_step", a, kw, tol_key(name, kw))
                 for name, mode, a, kw in first[0]]
    steps = res["step_s"]
    result["paint"] = {
        "iters": res["it"], "wall_s": paint_s,
        "painted_vertices": int(len(res["optimized_indices"])),
        "raycast_ms": 1e3 * res["raycast_s"],
        "ms_per_it": [1e3 * s for s in steps],
        "ms_per_it_median": 1e3 * float(np.median(steps[1:])),
        "losses_first": res["losses"][0], "losses_last": res["losses"][-1],
        "launches": {k: {m: c for m, c in md.items() if c}
                     for k, md in cnt.items()}}
    log(f"[edit] paint: {len(res['optimized_indices'])} painted vertices, "
        f"ray cast {1e3 * res['raycast_s']:.1f} ms, "
        f"{result['paint']['ms_per_it_median']:.1f} ms/it, losses "
        f"{res['losses'][0]['total']:.4f} -> {res['losses'][-1]['total']:.4f}")
    del res, first
    torch.cuda.empty_cache()

    # (e) the editing gate on the swap, beside the JAX package's record
    t0 = time.perf_counter()
    with contextlib.chdir(tmp):
        gate = editing_gate.main([
            "--config", os.path.join(p["nm_dir"], "config.yaml"),
            "--out", os.path.join(tmp, "editing_gate.json"),
            "--device", DEV])
    ref_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "GATES_r05", "editing_gate_sphere.json")
    with open(ref_path) as f:
        jax_gate = json.load(f)
    result["gate"] = {"port": gate, "wall_s": time.perf_counter() - t0,
                      "jax_package_record": jax_gate}
    log(f"[edit] gate (port, {PIPE_ITERS} iterations): {json.dumps(gate)}")
    log(f"[edit] gate (JAX package, GATES_r05): {json.dumps(jax_gate)}")

    # every recorded call against its plain version; the swap's f32 k = 8
    # tile scan by distance timed
    with torch.no_grad():
        rows = check_kernels(variants)
    result["checks"] = {f"{k}/{m}": len(r["checks"])
                        for (k, m), r in rows.items()}
    scan = next(((a, kw) for name, mode, var, a, kw, *_ in variants
                 if (name, mode) == FD and var == "edit_swap_surface"), None)
    if scan is None:
        raise AssertionError("edit swap_surface: no distance call recorded")
    result["distance_call"] = time_distance_call(*scan)
    result["replays"] = len(variants)
    del variants, rows
    torch.cuda.synchronize()
    result["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    result["peak_above_start_bytes"] = result["peak_mem_bytes"] - base_mem
    result["phase_s"] = time.perf_counter() - t_phase
    log(f"[edit] phase 8: {result['phase_s']:.1f} s, {result['replays']} "
        f"replays, peak {result['peak_mem_bytes'] / 2**20:.0f} MB")
    return result, counts


# ---------------------------------------------------------------------------
# phase 9: multi-GPU (ray-sharded serving, the render CLI's device flags,
# data-parallel training)
# ---------------------------------------------------------------------------

# the serving structures rendered through sharded_*_render, at 256x256
PAR_STRUCTURES = ("serving_bf16", "surface_fast", "surface_locate")
# the ragged case: a frame's rays less this many, edge-padded to a
# multiple of (devices x tile)
PAR_RAGGED_CUT = 1000
# CLI cases rendered again with --volume_devices 0 --surface_devices 0
PAR_CLI_CASES = ("cli_defaults", "cli_surface")
# the DP runs: one update of N_rays 512 a view at the shipped widths and
# schedule (the warm-up's first update has learning rate 0, as in the
# JAX package's DP test: the parameters stay, Adam's moments carry the
# averaged gradient), exact f32 matmuls, so the comparison is not of TF32
# roundings; the JAX test's limits. With no warm-up, Adam's first step
# u = g / (|g| + 1e-8) turns the summation noise of a near-zero gradient
# into up to 2 lr of a parameter (one value of 34 M off by 3.3e-6 while
# its gradient matched, in a run of this phase on the H100)
DP_OVERRIDES = dict(matmul_precision="highest", i_val=-1, i_backup=-1,
                    i_log=1, i_save=100000, monitoring="none")
DP_RTOL, DP_ATOL, DP_TIMEOUT_S = 2e-5, 2e-6, 300
# after its checked update each worker times this many warm steps (two
# more before them), one job on the card at a time
DP_TIME_STEPS = 5

_DP_WORKER = r"""
import json, os, sys, time
sys.path.insert(0, os.environ["NM_REPO"])
import torch
from neumesh_tpu_torch.config import load_yaml
from neumesh_tpu_torch.ops import kernels
from neumesh_tpu_torch.parallel import dist
from neumesh_tpu_torch.train.loop import main_function
from neumesh_tpu_torch.utils.print_fn import init_log

init_log()
cfg = load_yaml(os.environ["NM_CFG"])
cfg.expname = os.environ["NM_EXP"]
cfg.device = os.environ["NM_DEVICE"]
cfg.data.batch_size = int(os.environ["NM_BATCH"])
cfg.training.update(num_iters=int(os.environ["NM_ITERS"]),
                    log_root_dir=os.environ["NM_LOGS"],
                    **json.loads(os.environ["NM_OVERRIDES"]))
rank = int(os.environ.get("RANK", 0))
if os.environ.get("NM_BACKEND"):
    dist.init_env(cfg, backend=os.environ["NM_BACKEND"])
kernels.reset_launch_counts()
t0 = time.perf_counter()
out = main_function(cfg)
sync = torch.cuda.synchronize if torch.cuda.is_available() else (
    lambda: None)
sync()
wall = time.perf_counter() - t0
line = {"rank": rank, "wall_s": wall, "it": out["it"],
        "device": str(out["model"].device),
        "field_fused": dict(kernels.LAUNCHES["field_fused"])}
if rank == 0:
    import pickle
    with open(os.path.join(out["exp_dir"], "stats.p_0"), "rb") as f:
        stats = pickle.load(f)
    line["total"] = stats["losses"]["total"][0][1]
    line["grad_norm"] = stats["extras"]["grad_norm"][0][1]
    opt = out["optimizer"]
    torch.save({"count": opt.count,
                "p": {n: p.detach().cpu()
                      for n, p in out["model"].named_parameters()},
                "mu": {n: v.cpu() for n, v in opt.mu.items()},
                "nu": {n: v.cpu() for n, v in opt.nu.items()}},
               os.environ["NM_OUT"])
steps = int(os.environ.get("NM_TIME_STEPS", 0))
if steps:
    # warm steps of the same train step (the group of a gloo job is still
    # up), one job on the card at a time: rank 0 holds a file lock
    import fcntl
    from neumesh_tpu_torch.dataio import get_data
    from neumesh_tpu_torch.parallel import (ShardedGenerator,
                                            get_global_mesh,
                                            make_global_batch)
    from neumesh_tpu_torch.train.loop import build_train_step, to_device
    grid = get_global_mesh()
    ds = get_data(cfg)
    dev = out["model"].device
    _, mi, gt = ds.batch(list(range(cfg.data.batch_size * grid.batch)))
    mi = to_device(make_global_batch(grid, mi), dev)
    gt = to_device(make_global_batch(grid, gt), dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    if dist.is_initialized():
        gen = ShardedGenerator(gen, grid, cfg.data.batch_size)
    step = build_train_step(out["trainer"], out["optimizer"],
                            out["render_kwargs_train"], cfg.data.N_rays,
                            ds.H, ds.W, matmul_precision="highest")
    with open(os.environ["NM_LOCK"], "a") as lock:
        if rank == 0:
            fcntl.flock(lock, fcntl.LOCK_EX)
        for i in range(2 + steps):
            if i == 2:
                sync()
                t1 = time.perf_counter()
            step(mi, gt, gen)
        sync()
        line["step_ms"] = (time.perf_counter() - t1) * 1e3 / steps
dist.shutdown()
print("DP_RESULT " + json.dumps(line), flush=True)
"""


def sharded_frame(model, kind, H, kw, replicas=None, **more):
    """A HxH frame (phase 2's camera) through the structure's frame entry
    over `replicas` (None: the model alone) -> (rgb, depth, surface hit
    mask or None); `more` overrides kw (rayschunk, force_shard_map)."""
    rgb, depth, ex = render(model, kind, H, replicas=replicas,
                            **dict(kw, **more))
    return rgb, depth, ex.get("mask_surface")


def hold_shards(tag, got, want):
    """rgb and depth within the bf16 tolerance (§2 of PERF.md), the hit
    masks equal; returns the max |diff| of rgb and depth."""
    import torch
    tol = TOL["bf16"]
    out = {}
    for what, g, w in (("rgb", got[0], want[0]), ("depth", got[1],
                                                    want[1])):
        if tuple(g.shape) != tuple(w.shape):
            raise AssertionError(f"{tag} {what}: {tuple(g.shape)} vs "
                                 f"{tuple(w.shape)}")
        err, share = compare([g], [w], tol)
        out[what] = err
        if share < tol["frac"]:
            raise AssertionError(f"{tag} {what}: {share:.4f} within "
                                 f"{tol['atol']} (max |diff| {err})")
    if got[2] is not None and not torch.equal(got[2], want[2]):
        raise AssertionError(f"{tag}: hit masks differ")
    return out


def run_sharded_serving(models):
    """Phase 9 (a): each PAR_STRUCTURES structure's 256x256 frame through
    its frame entry with replicas over [cuda:0] (force_shard_map),
    [cuda:0, cuda:0] (two replicas on one card) and a ragged last chunk,
    held against the frame on the model alone, its kernel modes counted;
    with a second card also over [cuda:0, cuda:1]. Returns ({structure:
    stats}, {structure: counts})."""
    import torch
    from neumesh_tpu_torch.ops import kernels
    from neumesh_tpu_torch.parallel import replicate
    t_phase = time.perf_counter()
    c0 = torch.device("cuda:0" if DEV == "cuda" else DEV)
    layouts = {"one_forced": [c0], "two_on_one_card": [c0, c0]}
    if torch.cuda.device_count() >= 2:
        layouts["two_cards"] = [c0, torch.device("cuda", 1)]
    else:
        log("[parallel] one CUDA device: the cross-device runs "
            "([cuda:0, cuda:1] serving, nccl training across two cards) "
            "were not exercised")
    stats, counts = {}, {}
    for st in PAR_STRUCTURES:
        mkey, kind, H, kw, must, _ = STRUCTURES[st]
        model = models[mkey]
        want = sharded_frame(model, kind, H, kw)
        row = {"rays": H * H, "max_abs_diff": {}, "ms": {}}
        counts[st] = {}
        for name, devs in layouts.items():
            reps = [model] + [replicate(model, d) for d in devs[1:]]

            def sharded(**more):
                return sharded_frame(model, kind, H, kw, reps,
                                     force_shard_map=True, **more)
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            got = sharded()
            torch.cuda.synchronize()
            cnt = {k: dict(v) for k, v in kernels.LAUNCHES.items()}
            missed = [f"{k}/{md}" for k, md in sorted(must)
                      if cnt[k][md] <= 0]
            if missed:
                raise AssertionError(f"{st} over {name}: never launched "
                                     f"{missed}")
            counts[st][name] = cnt
            row["max_abs_diff"][name] = hold_shards(f"{st} {name}", got,
                                                    want)
            row["ms"][name] = cuda_ms(sharded, reps=3)
            if name == "two_on_one_card":
                # ragged: chunks of a frame less PAR_RAGGED_CUT rays, the
                # last edge-padded to the chunk (a multiple of devices x
                # tile), against the same chunks on one device
                n = H * H - PAR_RAGGED_CUT
                q = len(devs) * kw["ray_tile"]
                chunk = -(-n // q) * q
                g = sharded(rayschunk=n)
                w = sharded_frame(model, kind, H, kw, rayschunk=n)
                row["max_abs_diff"]["ragged"] = hold_shards(
                    f"{st} ragged", g, w)
                row["ragged"] = {"rayschunk": int(n), "chunk": int(chunk),
                                 "last_padded_by": int(-(H * H) % chunk)}
            del reps
        row["ms"]["direct"] = cuda_ms(
            lambda: sharded_frame(model, kind, H, kw), reps=3)
        stats[st] = row
        log(f"[parallel] {st}: direct {row['ms']['direct']:.2f} ms/frame; "
            + ", ".join(f"{k} {v:.2f} ms" for k, v in row["ms"].items()
                        if k != "direct")
            + "; max |diff| " + ", ".join(
                f"{k} rgb {v['rgb']:.3g} depth {v['depth']:.3g}"
                for k, v in row["max_abs_diff"].items()))
    return {"structures": stats, "layouts": list(layouts),
            "seconds": time.perf_counter() - t_phase}, counts


def run_cli_devices(tmp, cli_frames):
    """Phase 9 (b): PAR_CLI_CASES again with --volume_devices 0
    --surface_devices 0 (every local card), counted as phase 5 counts
    them: the frames equal phase 5's."""
    import torch
    from neumesh_tpu_torch.cli import render as cli
    from neumesh_tpu_torch.ops import kernels
    t0 = time.perf_counter()
    cfg = os.path.join(tmp, "cli.yaml")
    out = {}
    for tag in PAR_CLI_CASES:
        flags, nablas, must = CLI_CASES[tag]
        with contextlib.chdir(tmp):
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            res = cli.main(["--config", cfg, "--load_pt",
                            os.path.join(tmp, f"neumesh_{int(nablas)}.pt"),
                            "--outbase", tag + "_devices0",
                            "--num_views", str(CLI_VIEWS),
                            "--volume_devices", "0",
                            "--surface_devices", "0"] + flags)
            torch.cuda.synchronize()
        missed = [f"{k}/{md}" for k, md in sorted(must)
                  if kernels.LAUNCHES[k][md] <= 0]
        if missed:
            raise AssertionError(f"{tag} with devices 0: never launched "
                                 f"{missed}")
        for i, (rgb, nrm) in enumerate(zip(res["rgb"], res["normals"])):
            want_rgb, want_nrm = cli_frames[tag][i]
            if not (np.array_equal(rgb, want_rgb)
                    and np.array_equal(nrm, want_nrm)):
                raise AssertionError(f"{tag} with devices 0: view {i} "
                                     "differs from phase 5's")
        out[tag] = {"views": len(res["rgb"]), "equal": True,
                    "view_s": res["view_s"]}
        log(f"[parallel] CLI {tag} --*_devices 0: {len(res['rgb'])} views "
            "equal to phase 5's")
    out["seconds"] = time.perf_counter() - t0
    return out


def _dp_env(run, rank=None, world=1, local=1, port=None):
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                        "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                        "SLURM_PROCID", "SLURM_NODELIST")}
    env.update(run)
    if rank is not None:
        env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank % local),
                   LOCAL_WORLD_SIZE=str(local))
    return env


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dp_load(path):
    import torch
    return torch.load(path, weights_only=True)


def _dp_match(tag, got, want):
    """Parameters and Adam moments after one update: rtol 2e-5, atol 2e-6
    (the JAX DP test's limits). Returns (max |diff|, elements, parameters
    whose update moved them)."""
    import torch
    if got["count"] != 1 or want["count"] != 1:
        raise AssertionError(f"{tag}: {got['count']} / {want['count']} "
                             "updates, not one")
    err, n, moved = 0.0, 0, 0
    for part in ("p", "mu", "nu"):
        for name, w in want[part].items():
            g = got[part][name]
            d = (g - w).abs()
            bad = d > DP_ATOL + DP_RTOL * w.abs()
            if bool(bad.any()):
                raise AssertionError(
                    f"{tag}: {part}:{name} off at {int(bad.sum())} of "
                    f"{w.numel()} (max |diff| {float(d.max()):.3g})")
            err = max(err, float(d.max()))
            n += w.numel()
            if part == "mu":
                moved += int(bool((w != 0).any()))
    if moved < 10:
        raise AssertionError(f"{tag}: the update moved {moved} parameters")
    return err, n, moved


def run_dp_training(tmp):
    """Phase 9 (c): workers (subprocesses, DP_TIMEOUT_S each) through the
    port's main_function on phase 6's scene, teacher and NeuMesh config,
    one update of 512 rays a view each: (i) one rank in an nccl group
    against no group (first step's total loss and grad norm); (ii) two
    gloo ranks on the one card, batch 2 x data 1, against one process on
    the concatenated batch of 2; (iii) two gloo ranks, batch 1 x data 2
    (LOCAL_WORLD_SIZE 2: one image's rays split), against one process at
    batch 1. (d) with a second card, (ii) again with nccl across cuda:0
    and cuda:1. All runs start together."""
    import re
    import subprocess
    import torch
    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    base = {"NM_REPO": root, "NM_CFG": os.path.join(tmp,
                                                    "train_neumesh.yaml"),
            "NM_LOGS": os.path.join(tmp, "logs_dp"),
            "NM_OVERRIDES": json.dumps(DP_OVERRIDES), "OMP_NUM_THREADS": "2",
            "NM_LOCK": os.path.join(tmp, "dp_timing.lock")}

    def run(name, batch, iters, device=None, backend=None, timed=True):
        device = device or ("cuda:0" if DEV == "cuda" else DEV)
        return dict(base, NM_EXP=f"dp_{name}", NM_BATCH=str(batch),
                    NM_ITERS=str(iters), NM_DEVICE=device,
                    NM_OUT=os.path.join(tmp, f"dp_{name}.pt"),
                    NM_TIME_STEPS=str(DP_TIME_STEPS if timed else 0),
                    **({"NM_BACKEND": backend} if backend else {}))

    jobs = {"single_b1": [_dp_env(run("single_b1", 1, 1))],
            "single_b2": [_dp_env(run("single_b2", 2, 1))]}
    port = _free_port()
    # its group ends with its main_function: not timed
    jobs["nccl_one_rank"] = [_dp_env(run("nccl_one_rank", 1, 1,
                                         timed=False), 0, 1, 1, port)]
    for name, local in (("gloo_2x1", 1), ("gloo_1x2", 2)):
        port = _free_port()
        hosts = 2 // local
        jobs[name] = [_dp_env(run(name, 1, hosts, backend="gloo"), r, 2,
                              local, port) for r in range(2)]
    if torch.cuda.device_count() >= 2:
        port = _free_port()
        jobs["nccl_2x1_two_cards"] = [
            _dp_env(run("nccl_2x1_two_cards", 1, 2, device=f"cuda:{r}"), r,
                    2, 1, port) for r in range(2)]
    procs = {name: [subprocess.Popen(
        [sys.executable, "-c", _DP_WORKER], env=env, cwd=tmp,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for env in envs]
        for name, envs in jobs.items()}
    lines, failed = {}, []
    deadline = time.time() + DP_TIMEOUT_S
    try:
        for name, ps in procs.items():
            for r, p in enumerate(ps):
                try:
                    out, _ = p.communicate(
                        timeout=max(deadline - time.time(), 1))
                except subprocess.TimeoutExpired:
                    failed.append(f"{name} rank {r}: timed out")
                    continue
                res = [json.loads(x.split(" ", 1)[1])
                       for x in out.splitlines()
                       if x.startswith("DP_RESULT ")]
                if p.returncode != 0 or not res:
                    failed.append(f"{name} rank {r}: exit {p.returncode}\n"
                                  + out[-3000:])
                    continue
                # init_env logs the group it joins
                res[0]["group"] = "process group: rank" in out
                lines.setdefault(name, []).append(res[0])
                # the loop's log line of its one update: the first step
                # of a fresh process, one-time costs included
                logged = re.findall(r"\(([\d.]+) ms/it", out)
                if logged:
                    res[0]["first_update_ms_logged"] = float(logged[0])
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    if failed:
        raise AssertionError("DP workers failed:\n" + "\n".join(failed))
    for name, ls in lines.items():
        for ln in ls:
            if ln["field_fused"]["density"] <= 0:
                raise AssertionError(f"{name} rank {ln['rank']}: "
                                     "field_fused/density never launched")
    result = {"runs": lines}
    a, b = lines["single_b1"][0], lines["nccl_one_rank"][0]
    if not b["group"] or a["group"]:
        raise AssertionError("(i): group membership wrong")
    rel = max(abs(a["total"] - b["total"]) / abs(a["total"]),
              abs(a["grad_norm"] - b["grad_norm"]) / a["grad_norm"])
    result["one_rank_vs_no_group"] = {
        "total": [a["total"], b["total"]],
        "grad_norm": [a["grad_norm"], b["grad_norm"]], "max_rel": rel}
    log(f"[parallel] (i) nccl one rank vs no group: total {b['total']:.7f} "
        f"/ {a['total']:.7f}, grad norm {b['grad_norm']:.7f} / "
        f"{a['grad_norm']:.7f}, rel {rel:.2e}")
    if rel > TRAIN_REL:
        raise AssertionError(f"(i) differs by {rel:.2e}")
    pairs = {"gloo_2x1": "single_b2", "gloo_1x2": "single_b1"}
    if "nccl_2x1_two_cards" in lines:
        pairs["nccl_2x1_two_cards"] = "single_b2"
    for name, ref in pairs.items():
        err, n, moved = _dp_match(
            name, _dp_load(os.path.join(tmp, f"dp_{name}.pt")),
            _dp_load(os.path.join(tmp, f"dp_{ref}.pt")))
        result[name] = {"against": ref, "max_abs_diff": err,
                        "elements": n, "parameters_moved": moved}
        log(f"[parallel] {name} vs {ref}: {n} values within rtol {DP_RTOL}"
            f" atol {DP_ATOL}, max |diff| {err:.3g}, {moved} parameters "
            "moved")
    log("[parallel] warm step ms (rank 0, one job at a time): " + ", ".join(
        f"{name} {ls[0]['step_ms']:.1f}" for name, ls in lines.items()
        if "step_ms" in ls[0]))
    result["seconds"] = time.perf_counter() - t0
    return result


# ---------------------------------------------------------------------------
# phase 10: the host-geometry library (neumesh_tpu_torch/cpp)
# ---------------------------------------------------------------------------

# the structures rendered from the native-built and the scipy-built grid
HOST_STRUCTURES = ("serving_bf16", "surface_fast")
# ARAP native vs numpy on phase 8's warp: both pin the constraints
# exactly; their results differ where a vertex's one-ring covariance is
# (nearly) rank-deficient, which the marching meshes have: the native
# rotation fit (eigenvectors of S^T S, a coordinate axis for a vanishing
# singular value) is not numpy's SVD there. Reported beside the ARAP
# energy of each, not held to each other.


def _sorted_rows(v):
    return v[np.lexsort(v.T[::-1])]


def host_grid_renders(tmp):
    """(a) the candidate grid of the phase-2 icosphere built by the C++
    KD-tree and by scipy's (ms each, cell_row equal, rows equal counted);
    (b) HOST_STRUCTURES
    rendered from each grid, the native-built render counted and its
    kernel calls recorded. Returns (row, {structure: counts},
    [variants])."""
    import torch
    from neumesh_tpu_torch.dataio.synthetic import icosphere_mesh
    from neumesh_tpu_torch.mesh.grid import MeshGrid
    from neumesh_tpu_torch.models.neumesh.model import NeuMesh
    from neumesh_tpu_torch.ops.knn import build_candidate_grid
    from neumesh_tpu_torch.utils.state import load_reference_pt
    mesh = icosphere_mesh(0.5, subdivisions=7)
    grids, row = {}, {"n_vertices": mesh.n_vertices}
    for backend in ("native", "scipy"):
        t0 = time.perf_counter()
        grids[backend] = build_candidate_grid(mesh.vertices, use_cache=False,
                                              backend=backend)
        row[f"grid_{backend}_ms"] = 1e3 * (time.perf_counter() - t0)
    gn, gs = grids["native"], grids["scipy"]
    if gn.dims != gs.dims or not torch.equal(gn.cell_row, gs.cell_row):
        raise AssertionError("host grid: native and scipy cell_row differ")
    # the two differ in the ties only: rows equal, or the same candidates
    # in another order, or another of equidistant vertices at the row's end
    a, b = gn.cand_idx.numpy(), gs.cand_idx.numpy()
    row.update(dims=list(gn.dims), Kp=gn.Kp, rows=int(a.shape[0]),
               rows_equal=int((a == b).all(1).sum()),
               rows_same_set=int((np.sort(a, 1) == np.sort(b, 1)).all(1)
                                 .sum()))
    log(f"[host] candidate grid of {mesh.n_vertices} vertices: native "
        f"{row['grid_native_ms']:.0f} ms, scipy {row['grid_scipy_ms']:.0f} "
        f"ms; rows equal {row['rows_equal']} / {row['rows']} (same set "
        f"{row['rows_same_set']})")
    counts, variants, frames = {}, [], {}
    for backend, g in grids.items():
        mg = MeshGrid(mesh, device=DEV, grid=g)
        for st in HOST_STRUCTURES:
            mkey, kind, H, kw, must, _ = STRUCTURES[st]
            serving, bf16, extra = MODELS[mkey]
            m = NeuMesh(mg, device=DEV,
                        compute_dtype=torch.bfloat16 if bf16 else None,
                        **dict(FLAGSHIP, use_pallas=True, **serving,
                               **extra))
            load_reference_pt(os.path.join(tmp, "neumesh_1.pt"), m)
            if backend == "native":
                render(m, kind, H, **kw)            # warm-up
                rgb, depth, _, cnt = counted(m, kind, H, **kw)
                check_image(f"host {st}", rgb, depth, H, H)
                missed = [f"{k}/{md}" for k, md in sorted(must)
                          if cnt[k][md] <= 0]
                if missed:
                    raise AssertionError(f"host {st}: never launched "
                                         f"{missed}")
                counts[st] = cnt
                calls = []
                with record_calls(calls):
                    render(m, kind, H, **kw)
                firsts = {}
                for name, mode, ca, ckw in calls:
                    firsts.setdefault((name, mode), (ca, ckw))
                variants += [(name, mode, f"host_{st}", ca, ckw,
                              tol_key(name, ckw))
                             for (name, mode), (ca, ckw) in firsts.items()]
                del calls
            else:
                rgb, depth, _ = render(m, kind, H, **kw)
            frames[(backend, st)] = rgb
            del m
        del mg
        torch.cuda.empty_cache()
    for st in HOST_STRUCTURES:
        diff = (frames[("native", st)] - frames[("scipy", st)]).abs()
        row[f"{st}_pixels_differing"] = int((diff.amax(-1) > 1 / 255).sum())
        row[f"{st}_max_abs_diff"] = float(diff.max())
        row[f"{st}_launches"] = {k: {md: c for md, c in v.items() if c}
                                 for k, v in counts[st].items()
                                 if any(v.values())}
        log(f"[host] {st} from the native grid: launches "
            f"{row[f'{st}_launches']}; pixels off by > 1/255 from the "
            f"scipy grid's frame {row[f'{st}_pixels_differing']}")
    return row, counts, variants


def host_marching():
    """Marching tetrahedra and cubes of phase 7's 256^3 teacher field,
    the C++ library against the numpy code: the same vertex set (equal
    after a lexicographic sort) and triangle count, ms each."""
    from neumesh_tpu_torch.cpp import native
    from neumesh_tpu_torch.mesh import marching_cubes as mc
    (field, iso, *_), _ = HOST_INPUTS["march"][0]
    f32, f64 = np.ascontiguousarray(field, np.float32), np.asarray(
        field, np.float64)
    out = {"N": list(field.shape), "iso": float(iso)}
    for method in ("marching_tetrahedra", "marching_cubes"):
        t0 = time.perf_counter()
        vn, tn = getattr(native, method)(f32, float(iso))
        t1 = time.perf_counter()
        vp, tp = getattr(mc, method)(f64, iso)
        t2 = time.perf_counter()
        if len(tn) != len(tp) or vn.shape != vp.shape \
                or not np.array_equal(_sorted_rows(vn), _sorted_rows(vp)):
            raise AssertionError(f"host {method}: native and numpy vertex "
                                 "sets differ")
        out[method] = {"native_ms": 1e3 * (t1 - t0),
                       "numpy_ms": 1e3 * (t2 - t1),
                       "n_vertices": int(len(vn)),
                       "n_triangles": int(len(tn))}
        log(f"[host] {method} {field.shape[0]}^3: native "
            f"{1e3 * (t1 - t0):.0f} ms, numpy {1e3 * (t2 - t1):.0f} ms, "
            f"{len(vn)} vertices (sets equal)")
    return out


def arap_energy(V, T, P):
    """sum_ij w_ij |(P_i - P_j) - R_i (V_i - V_j)|^2 over directed edges,
    each R_i the SVD-optimal rotation of P's one-ring."""
    from neumesh_tpu_torch.mesh.arap import cotangent_edges, fit_rotations
    a, b, w = cotangent_edges(V, T)
    I, J, W = (np.concatenate([a, b]), np.concatenate([b, a]),
               np.concatenate([w, w]))
    e, ep = V[J] - V[I], P[J] - P[I]
    S = np.zeros((len(V), 3, 3))
    np.add.at(S, I, W[:, None, None] * ep[:, :, None] * e[:, None, :])
    R = fit_rotations(S)
    r = ep - np.einsum("eab,eb->ea", R[I], e)
    return float(np.sum(W * np.sum(r * r, -1)))


def host_arap():
    """Phase 8's ARAP warp (the swap's reference cap) by the C++ library
    and by the numpy backend: seconds of each, max |diff|, the ARAP
    energy of each and of the start; each pins its constraints
    exactly."""
    from neumesh_tpu_torch.mesh.arap import arap
    (V, T, cids, cpos), kw = HOST_INPUTS["arap"][0]
    V = np.asarray(V, np.float64)
    t0 = time.perf_counter()
    got = arap(V, T, cids, cpos, **kw, backend="native")
    t1 = time.perf_counter()
    want = arap(V, T, cids, cpos, **kw, backend="numpy")
    t2 = time.perf_counter()
    start = V.copy()
    start[cids] = cpos
    out = {"n_vertices": int(len(V)), "n_constraints": int(len(cids)),
           "max_iter": kw.get("max_iter", 20), "native_s": t1 - t0,
           "numpy_s": t2 - t1,
           "max_abs_diff": float(np.abs(got - want).max()),
           "energy": {"start": arap_energy(V, T, start),
                      "native": arap_energy(V, T, got),
                      "numpy": arap_energy(V, T, want)},
           "moved": float(np.abs(got - V).max())}
    log(f"[host] ARAP of {out['n_vertices']} vertices "
        f"({out['n_constraints']} pinned): native {out['native_s']:.2f} s, "
        f"numpy {out['numpy_s']:.2f} s, max|diff| "
        f"{out['max_abs_diff']:.2e}; energy {out['energy']}")
    for tag, P in (("native", got), ("numpy", want)):
        if not (np.isfinite(P).all() and np.array_equal(P[cids], start[cids])):
            raise AssertionError(f"host ARAP {tag}: constraints not pinned "
                                 "or non-finite vertices")
    return out


def host_cast():
    """Phase 8's paint rays cast through the BVH (host) and through the
    float64 caster on the card: the same hits; the same primitive where
    the nearest hit is unique (a ray through a shared edge or vertex hits
    its triangles at the same t, and either may be named); ms each."""
    import torch
    from neumesh_tpu_torch.mesh.raycast import cast_rays
    calls = HOST_INPUTS["cast"]
    mesh = calls[0][0][0]
    o = np.concatenate([np.asarray(c[0][1]) for c in calls])
    d = np.concatenate([np.asarray(c[0][2]) for c in calls])
    t0 = time.perf_counter()
    tn, pn = cast_rays(mesh, o, d)
    t1 = time.perf_counter()
    td, pd = cast_rays(mesh, o, d, backend="device", device=DEV)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    hit = np.isfinite(tn)
    if not np.array_equal(hit, np.isfinite(td)):
        raise AssertionError("host cast: BVH and card hits differ")
    t_err = float(np.abs(tn[hit] - td[hit]).max()) if hit.any() else 0.0
    other = hit & (pn != pd)
    out = {"rays": int(len(o)), "n_triangles": int(mesh.n_triangles),
           "hits": int(hit.sum()), "bvh_ms": 1e3 * (t1 - t0),
           "device_ms": 1e3 * (t2 - t1), "max_t_diff": t_err,
           "prims_differing": int(other.sum())}
    log(f"[host] paint cast of {len(o)} rays on {mesh.n_triangles} "
        f"triangles: BVH {out['bvh_ms']:.1f} ms, card "
        f"{out['device_ms']:.1f} ms; {out['hits']} hits, primitive ids "
        f"differing on {out['prims_differing']} (ties), max t diff "
        f"{t_err:.2e}")
    if t_err > 1e-9:
        raise AssertionError(f"host cast: t differs by {t_err:.2e}")
    if other.any():
        # a tie: the card's primitive is hit at the BVH's t as well
        from neumesh_tpu_torch.ops.geo import barycentric_coordinates
        v = np.asarray(mesh.vertices, np.float64)
        tri = np.asarray(mesh.triangles)[pd[other]]
        bary = barycentric_coordinates(*(torch.from_numpy(x) for x in (
            o[other] + tn[other, None] * d[other], v[tri[:, 0]],
            v[tri[:, 1]], v[tri[:, 2]])))
        if not bool((bary >= -1e-6).all()):
            raise AssertionError("host cast: a primitive differs off a tie")
    return out


def run_host_geometry(tmp, card, host_build_s):
    """Phase 10. Returns (the {"host_geometry"} dict, {structure: launch
    counts})."""
    import torch
    t_phase = time.perf_counter()
    grid, counts, variants = host_grid_renders(tmp)
    with torch.no_grad():
        rows = check_kernels(variants)
    result = {"card": card, "build_s": host_build_s, "grid": grid,
              "checks": {f"{k}/{m}": len(r["checks"])
                         for (k, m), r in rows.items()},
              "march": host_marching(), "arap": host_arap(),
              "cast": host_cast()}
    result["phase_s"] = time.perf_counter() - t_phase
    log(f"[host] phase 10: {result['phase_s']:.1f} s")
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
    build_s, host_build_s = build_kernels()
    log(f"[build] all kernels and the host library {build_s:.1f} s")

    with tempfile.TemporaryDirectory() as tmp:
        return run_all(tmp, name, card, build_s, host_build_s, t_start)


def run_all(tmp, name, card, build_s, host_build_s, t_start) -> int:
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
    with torch.no_grad():
        rows[FE] = edit_cell_row(rec, models)
    split = run_stage_split(variants)
    rows[FD]["floor_ms"] = distance_floor_ms(rec["serving_bf16"][FD][0])
    rows[FD]["timed_shapes"] = distance_shapes(*rec["serving_bf16"][FD])
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
                      "stage_split": split, "build_s": build_s,
                      "total_s": time.perf_counter() - t_start,
                      "card": card}))

    # ---- phase 9 (a): ray-sharded serving on the phase-2 models
    par_serve, par_counts = run_sharded_serving(models)

    # ---- the render CLI: the counted cases, then every recorded call
    # against its plain version, and the per-call times
    del models
    torch.cuda.empty_cache()
    cli_stats, cli_counts, cli_variants, cli_timed, cli_frames = run_cli(tmp)
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
    pipe, gate_counts, gate_paths = run_pipeline(tmp, card)
    pipe["total_s"] = time.perf_counter() - t_start
    print(json.dumps({"pipeline": pipe}))

    # ---- editing on the gate's trained scene
    edit, edit_counts = run_editing(tmp, card, gate_paths)
    edit["total_s"] = time.perf_counter() - t_start
    print(json.dumps({"editing": edit}))

    # ---- phase 9 (b), (c): the CLI's device flags, data-parallel training
    torch.cuda.empty_cache()
    par = {"serving": par_serve, "cli": run_cli_devices(tmp, cli_frames),
           "training": run_dp_training(tmp), "card": card,
           "device_count": torch.cuda.device_count()}
    par["phase_s"] = sum(par[k]["seconds"] for k in ("serving", "cli",
                                                     "training"))
    par["total_s"] = time.perf_counter() - t_start
    log(f"[parallel] phase 9: {par['phase_s']:.1f} s (serving "
        f"{par_serve['seconds']:.1f}, CLI {par['cli']['seconds']:.1f}, "
        f"training {par['training']['seconds']:.1f})")
    print(json.dumps({"parallel": par}))

    # ---- phase 10: the host-geometry library
    host, host_counts = run_host_geometry(tmp, card, host_build_s)
    host["total_s"] = time.perf_counter() - t_start
    print(json.dumps({"host_geometry": host}))

    on_path = {km for st in STRUCTURES.values() for km in st[4]}
    kernels_out = []
    for (kname, mode), row in sorted(rows.items()):
        src, rep = SOURCES[kname]
        src = ROW_SOURCES.get((kname, mode), src)
        extra = {}
        if (kname, mode) == FD:
            extra = {"floor_ms": row["floor_ms"], "timed_shapes": dict(
                row["timed_shapes"],
                c_swap_surface=edit["distance_call"])}
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
            "launches_by_editing_case": {c: cnt[kname][mode]
                                         for c, cnt in edit_counts.items()},
            "launches_by_parallel_case": {
                f"{st}/{lay}": c[kname][mode]
                for st, by in par_counts.items() for lay, c in by.items()},
            "launches_host_geometry": {st: c[kname][mode]
                                       for st, c in host_counts.items()},
            "on_path": (kname, mode) in on_path,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            **({"plain_ms_from": row["plain_ms_from"]}
               if "plain_ms_from" in row else {}),
            "bound_by": row["bound_by"],
            "bound_cuda_core_ms": row["bound_cuda_core_ms"],
            "library_ms": None,
            "design": ROW_DESIGN.get((kname, mode),
                                     "wgmma" if (kname, mode) in WGMMA_ROWS
                                     else "simt"),
            "card": card, "shapes": row["shapes"],
            "timed_variant": row["timed_variant"], "checks": row["checks"],
            **extra})
    print(json.dumps({"kernels": kernels_out}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
