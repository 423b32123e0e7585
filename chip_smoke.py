#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (neumesh_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase below, one card

Phases (any failure exits non-zero; nothing falls back to the CPU):
 1. device: CUDA required; card name and power limit; build every kernel
    from neumesh_tpu_torch/csrc (nvcc, all sources in parallel), timed.
 2. the slice at full width: the 163,842-vertex icosphere NeuMesh (W=256,
    D_density=3, D_color=4, dims 32/32, multires 8/2/2/4, nablas input)
    with parameters from a numpy seed, written as a reference-format .pt
    and .ply and loaded back; the root-anchored bf16 serving structure on
    65,536 rays and the reference f32 structure on 16,384 rays; launch
    counters read around each render.
 3. every kernel mode against its plain PyTorch version on the card, on
    the inputs the serving render gave it (f32 and bf16 variants), and
    field_fused density and full on the reference structure's f32 inputs;
    kernel and plain times at the serving shapes, the roofline bound.
 4. a 64x64 crop rendered through the kernels and through the plain
    versions; PSNR between them. Render throughput and peak memory.
Prints the card line, one {"kernels": [...]} line, and last
{"ok": true, "device": {...}}.
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

SOURCES = {
    "field_fused": ("neumesh_tpu_torch/csrc/field_fused.cu",
                    "neumesh_tpu/ops/pallas_kernels.py:645"),
    "secant_refine": ("neumesh_tpu_torch/csrc/secant_refine.cu",
                      "neumesh_tpu/ops/pallas_kernels.py:1128"),
}
ON_PATH = {("field_fused", "distance"), ("field_fused", "density"),
           ("field_fused", "full"), ("secant_refine", "rebracket")}

# root-anchored serving structure (the JAX bench's VOL settings)
VOL_MODEL = dict(tile_kp_per_probe=12, tile_cell_budget=64, scan_knn_k=1)
VOL_RENDER = dict(root_anchored=True, root_n_fine=8, root_steps=16,
                  root_secant=3, root_win_frac=0.25, color_topk=4,
                  ray_tile=128, tile_max_candidates=128, N_samples=64,
                  N_importance=64, N_upsample_iters=4,
                  reuse_upsample_sdf=True)
# reference structure: 64 coarse + 4x16 up-sampling, colour at midpoints
REF_RENDER = dict(ray_tile=128, tile_max_candidates=128, N_samples=64,
                  N_importance=64, N_upsample_iters=4,
                  reuse_upsample_sdf=True)
FLAGSHIP = dict(D_density=3, D_color=4, W=256, geometry_dim=32,
                color_dim=32, multires_view=4, multires_d=8, multires_fg=2,
                multires_ft=2, enable_nablas_input=True,
                learn_indicator_weight=True, speed_factor=10.0)


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


@contextlib.contextmanager
def plain_on_card():
    """Route the model's kernel calls to the plain versions (the crop
    reference); the main path never does this."""
    from neumesh_tpu_torch.ops import kernels
    saved = kernels.field_fused, kernels.secant_refine
    kernels.field_fused = kernels.field_fused_plain
    kernels.secant_refine = kernels.secant_refine_plain
    try:
        yield
    finally:
        kernels.field_fused, kernels.secant_refine = saved


@contextlib.contextmanager
def record_inputs(store):
    """Keep the first call's arguments of every kernel mode."""
    from neumesh_tpu_torch.ops import kernels
    saved = kernels.field_fused, kernels.secant_refine

    def ff(*a, **kw):
        store.setdefault(("field_fused", kw.get("want", "density")),
                         (a, dict(kw)))
        return saved[0](*a, **kw)

    def sr(*a, **kw):
        mode = kernels.secant_mode(kw.get("d_low_w") is not None,
                                   kw.get("frozen_knn", False))
        store.setdefault(("secant_refine", mode), (a, dict(kw)))
        return saved[1](*a, **kw)

    kernels.field_fused, kernels.secant_refine = ff, sr
    try:
        yield
    finally:
        kernels.field_fused, kernels.secant_refine = saved


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


def _bound(bf, f32, nbytes):
    t_ops = (bf / H100_BF16_FLOPS + f32 / H100_F32_FLOPS) * 1e3
    t_bytes = nbytes / H100_BYTES * 1e3
    return (max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def build_kernels():
    from neumesh_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.build_all()
    secs = time.perf_counter() - t0
    for name, info in _build.BUILD_LOG.items():
        lines = [ln for ln in info["ptxas"].splitlines()
                 if "registers" in ln or "spill" in ln]
        log(f"[build] {name}: {info['seconds']:.1f} s; " + " | ".join(lines))
    return secs


def fold_weights(model, dtype, f32_layers=()):
    """(dens_ws, col_ws) folded as the bound model would for `dtype`."""
    from neumesh_tpu_torch.models.neumesh.model import TileBoundNeuMesh
    saved = model.compute_dtype, model.f32_layers
    model.compute_dtype, model.f32_layers = dtype, tuple(f32_layers)
    try:
        return TileBoundNeuMesh(model, {}, 1)._field_weights()
    finally:
        model.compute_dtype, model.f32_layers = saved


def kernel_variants(rec, model, rec_ref):
    """[(kernel, mode, variant, call_args, call_kw, tol)] built from the
    recorded serving inputs (each mode in f32 and bf16, and bf16 with
    selective-f32 layers once) and from the reference structure's recorded
    f32 inputs (variant ref_f32)."""
    import torch
    from neumesh_tpu_torch.ops import kernels
    out = []
    f32w = fold_weights(model, None)
    bfw = fold_weights(model, torch.bfloat16)
    sel = fold_weights(model, torch.bfloat16, ("d0", "dh", "c0", "ch"))
    a, kw = rec[("field_fused", "distance")]
    for k in (1, 8):
        out.append(("field_fused", "distance", f"k{k}", a,
                    dict(kw, k=k), TOL["f32"]))
    a_d, kw_d = rec[("field_fused", "density")]
    a_f, kw_f = rec[("field_fused", "full")]
    for mode, (a0, kw0) in (("density", (a_d, kw_d)),
                            ("density_nabla", (a_d, kw_d)),
                            ("full", (a_f, kw_f))):
        xyz, geo, feat = a0[0], a0[1], a0[2]
        dirs = a0[6] if len(a0) > 6 else None
        for var, (dws, cws), dt in (("f32", f32w, None),
                                    ("bf16", bfw, torch.bfloat16),
                                    ("bf16_sel_f32", sel, torch.bfloat16)):
            if var == "bf16_sel_f32" and mode == "density_nabla":
                continue
            args = (xyz, geo, feat, a0[3], dws,
                    cws if mode == "full" else None, dirs)
            tol = (TOL["bf16"] if dt is not None else TOL["f32"])
            out.append(("field_fused", mode, var, args,
                        dict(kw0, want=mode, dtype=dt), tol))
    a_s, kw_s = rec[("secant_refine", "rebracket")]
    for rb in (True, False):
        for fr in (False, True):
            for var, (dws, _), dt in (("bf16", bfw, torch.bfloat16),
                                      ("f32", f32w, None)):
                kw = dict(kw_s, frozen_knn=fr, dtype=dt)
                if not rb:
                    kw.update(d_low_w=None, d_high_w=None)
                mode = kernels.secant_mode(rb, fr)
                args = a_s[:9] + (dws,)
                out.append(("secant_refine", mode, var, args, kw,
                            TOL["bf16"] if dt is not None else TOL["f32"]))
    for mode in ("density", "full"):
        a, kw = rec_ref[("field_fused", mode)]
        out.append(("field_fused", mode, "ref_f32", a, kw, TOL["f32"]))
    return out


def check_kernels(variants):
    """Kernel vs plain on the card; returns {(kernel, mode): row}."""
    import torch
    from neumesh_tpu_torch.ops import kernels
    rows = {}
    for name, mode, var, args, kw, tol in variants:
        fn = getattr(kernels, name)
        plain = getattr(kernels, name + "_plain")
        got = fn(*args, **kw)
        want = plain(*args, **kw)
        torch.cuda.synchronize()
        got = got if isinstance(got, list) else [got]
        want = want if isinstance(want, list) else [want]
        if name == "field_fused" and mode in ("density_nabla", "full") \
                and var in ("f32", "ref_f32"):
            # sdf and rgb at the f32 tolerance, nabla at its own
            idx = [0] + ([4, 5, 6] if mode == "full" else [])
            e1, s1 = compare([got[i] for i in idx], [want[i] for i in idx],
                             tol)
            e2, s2 = compare(got[1:4], want[1:4], TOL["f32_nabla"])
            err, share = max(e1, e2), min(s1, s2)
        else:
            err, share = compare(got, want, tol)
        ok = share >= tol["frac"]
        log(f"[check] {name}/{mode} {var}: max|err| {err:.3e}, "
            f"within tol {share:.5f} ({'ok' if ok else 'FAIL'})")
        if not ok:
            raise AssertionError(f"{name}/{mode} {var} disagrees with its "
                                 f"plain version: {share:.4f} within tol")
        row = rows.setdefault((name, mode), {"checks": []})
        row["checks"].append({"variant": var, "max_abs_err": err,
                              "frac_within_tol": share,
                              "atol": tol["atol"], "rtol": tol["rtol"],
                              "min_frac": tol["frac"]})
    return rows


def time_kernels(rec, rows):
    from neumesh_tpu_torch.ops import kernels
    for (name, mode), row in rows.items():
        key = (name, mode)
        if key in rec:
            a, kw = rec[key]
        elif name == "field_fused" and mode == "density_nabla":
            a, kw = rec[("field_fused", "density")]
            kw = dict(kw, want="density_nabla")
        else:
            a, kw = rec[("secant_refine", "rebracket")]
            kw = dict(kw, frozen_knn=mode.startswith("frozen"))
            if not mode.endswith("rebracket"):
                kw.update(d_low_w=None, d_high_w=None)
        fn = getattr(kernels, name)
        plain = getattr(kernels, name + "_plain")
        row["ms"] = cuda_ms(lambda: fn(*a, **kw))
        row["plain_ms"] = cuda_ms(lambda: plain(*a, **kw), reps=2)
        row["bound_ms"], row["bound_by"] = (
            field_bound(a, kw) if name == "field_fused"
            else secant_bound(a, kw))
        row["shapes"] = _shape_note(name, a)
        # the variant the serving path runs (recorded dtype) is the headline
        main = [c for c in row["checks"]
                if c["variant"] == ("bf16" if kw.get("dtype") is not None
                                    else "f32")]
        row["max_abs_err"] = max(c["max_abs_err"] for c in main or
                                 row["checks"])


def profile_frame(fn):
    """Device time by kernel over one traced call of fn (torch.profiler):
    the port's two kernels, every other device op, busy time against the
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
    by = {"field_fused": 0.0, "secant_refine": 0.0, "other": 0.0}
    for ev in prof.key_averages():
        # only the device's own events: an aten op on the host carries the
        # time of the kernels it launched, which are listed besides
        if (ev.device_type != DeviceType.CUDA
                or getattr(ev, "is_user_annotation", False)):
            continue
        us = float(ev.self_device_time_total or 0.0)
        if us <= 0:
            continue
        key = next((k for k in ("field_fused", "secant_refine")
                    if k + "_kernel" in ev.key), "other")
        by[key] += us / 1e3
    busy = sum(by.values())
    return {"traced_wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": (1.0 - busy / wall_ms) if busy > 0 else None,
            "device_ms_by_kernel": by}


def _shape_note(name, a):
    if name == "field_fused":
        B, S, _ = a[0].shape
        return {"B": B, "S": S, "C": a[1].shape[2], "F": a[2].shape[-1]}
    return {"R": a[0].shape[0], "B": a[6].shape[0], "C": a[6].shape[2],
            "F": a[7].shape[-1]}


def build_scene(tmp, device):
    """Flagship NeuMesh on the 163,842-vertex icosphere, parameters from a
    numpy seed, round-tripped through a reference-format .pt and a .ply."""
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
    src = NeuMesh(mg, device=device, **FLAGSHIP).init(seed=0)
    pt = save_reference_pt(os.path.join(tmp, "neumesh.pt"), src)
    save_ply(mesh, os.path.join(tmp, "mesh.ply"))
    mesh2 = load_ply(os.path.join(tmp, "mesh.ply"))
    mg2 = MeshGrid(mesh2, device=device)
    models = {}
    for tag, dt in (("bf16", torch.bfloat16), ("f32", None)):
        m = NeuMesh(mg2, device=device, compute_dtype=dt, **VOL_MODEL,
                    **FLAGSHIP)
        load_reference_pt(pt, m)
        models[tag] = m
    same = all(torch.equal(a, b) for a, b in
               zip(src.parameters(), models["f32"].parameters()))
    if not same:
        raise AssertionError("weights changed through the .pt round trip")
    log(f"[scene] {mg2.get_number_of_vertices()} vertices, grid dims "
        f"{mg2.grid.dims} Kp {mg2.grid.Kp}, "
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


def render(model, H, W, crop=None, **kw):
    from neumesh_tpu_torch.render.volume import render_image
    c2w, K, h, w = camera(H, W, crop=crop)
    return render_image(model, c2w, K, h, w, device="cuda", **kw)


def counted(model, H, W, **kw):
    """One render with the launch counters set to 0 just before and read
    just after."""
    import torch
    from neumesh_tpu_torch.ops import kernels
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    rgb, depth, ret = render(model, H, W, **kw)
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


def main() -> int:
    import torch
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; this script runs only on a GPU")
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import neumesh_tpu_torch
    from neumesh_tpu_torch.ops import kernels

    neumesh_tpu_torch.set_fp32_precision()
    name = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"[device] {name} | {card}")
    build_s = build_kernels()
    log(f"[build] all kernels {build_s:.1f} s")

    with tempfile.TemporaryDirectory() as tmp:
        models = build_scene(tmp, "cuda")
    mb, mf = models["bf16"], models["f32"]

    # ---- the main path: counters around each structure's render, after a
    # warm-up render; the peak memory holds nothing kept by the checks
    render(mb, 256, 256, **VOL_RENDER)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rgb_b, dep_b, _, cnt_b = counted(mb, 256, 256, **VOL_RENDER)
    peak_b = torch.cuda.max_memory_allocated()
    check_image("serving bf16", rgb_b, dep_b, 256, 256)
    render(mf, 128, 128, **REF_RENDER)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rgb_a, dep_a, _, cnt_a = counted(mf, 128, 128, **REF_RENDER)
    peak_a = torch.cuda.max_memory_allocated()
    check_image("reference f32", rgb_a, dep_a, 128, 128)
    log(f"[render] serving launches {cnt_b}; reference launches {cnt_a}")
    for kname, mode in ON_PATH:
        if cnt_b[kname][mode] <= 0:
            raise AssertionError(f"{kname}/{mode} never launched on the "
                                 "serving path")
    if cnt_a["field_fused"]["density"] <= 0 or \
            cnt_a["field_fused"]["full"] <= 0:
        raise AssertionError("reference structure missed a kernel")

    # ---- kernels against their plain versions, on the inputs each
    # structure's render gives them
    rec, rec_a = {}, {}
    with record_inputs(rec):
        render(mb, 256, 256, **VOL_RENDER)
    with record_inputs(rec_a):
        render(mf, 128, 128, **REF_RENDER)
    rows = check_kernels(kernel_variants(rec, mb, rec_a))
    time_kernels(rec, rows)

    # ---- crop through the plain versions on the card
    crop_k, _, _ = render(mb, 256, 256, crop=(64, 64), **VOL_RENDER)
    with plain_on_card():
        crop_p, _, _ = render(mb, 256, 256, crop=(64, 64), **VOL_RENDER)
    mse = float(((crop_k - crop_p) ** 2).mean())
    psnr = 10 * math.log10(1.0 / max(mse, 1e-20))
    crop_a_k, _, _ = render(mf, 256, 256, crop=(64, 64), **REF_RENDER)
    with plain_on_card():
        crop_a_p, _, _ = render(mf, 256, 256, crop=(64, 64), **REF_RENDER)
    mse_a = float(((crop_a_k - crop_a_p) ** 2).mean())
    psnr_a = 10 * math.log10(1.0 / max(mse_a, 1e-20))
    log(f"[crop] kernel vs plain PSNR: serving bf16 {psnr:.2f} dB, "
        f"reference f32 {psnr_a:.2f} dB")
    if psnr < 30.0 or psnr_a < 55.0:
        raise AssertionError("crop render disagrees with the plain path")

    # ---- throughput
    ms_b = cuda_ms(lambda: render(mb, 256, 256, **VOL_RENDER), reps=5)
    ms_a = cuda_ms(lambda: render(mf, 128, 128, **REF_RENDER), reps=3)
    prof_b = profile_frame(lambda: render(mb, 256, 256, **VOL_RENDER))
    prof_a = profile_frame(lambda: render(mf, 128, 128, **REF_RENDER))
    frame = {
        "serving_bf16": {"rays": 65536, "ms": ms_b,
                         "mrays_s": 65536 / ms_b / 1e3,
                         "peak_mem_bytes": peak_b, "launches": cnt_b,
                         "profile": prof_b},
        "reference_f32": {"rays": 16384, "ms": ms_a,
                          "mrays_s": 16384 / ms_a / 1e3,
                          "peak_mem_bytes": peak_a, "launches": cnt_a,
                          "profile": prof_a},
        "crop_psnr_db": {"serving_bf16": psnr, "reference_f32": psnr_a},
        "build_s": build_s, "total_s": time.perf_counter() - t_start,
    }
    print(json.dumps({"frame": frame, "card": card}))

    kernels_out = []
    for (kname, mode), row in sorted(rows.items()):
        src, rep = SOURCES[kname]
        kernels_out.append({
            "name": f"{kname}/{mode}", "route": "cuda", "source": src,
            "replaces": rep, "launches": cnt_b[kname][mode],
            "launches_reference_structure": cnt_a[kname][mode],
            "on_path": (kname, mode) in ON_PATH,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None,
            "card": card, "shapes": row["shapes"],
            "checks": row["checks"]})
    print(json.dumps({"kernels": kernels_out}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
