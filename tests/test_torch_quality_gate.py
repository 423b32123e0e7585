"""The port's quality gate (neumesh_tpu_torch.tools.quality_gate):
gate_results against the JAX gate's own arithmetic (the statements of
tools/quality_gate.py that build its JSON, executed here on the same
fixed scores), and the whole gate on the CPU at a tiny size (a 4-view
32x32 scene, narrow models, 3 iterations each): every mode scored, the
JSON written, a --modes re-run carrying the other modes, the training's
TF32 turned off before scoring, and no run without a card unless
--device cpu."""
import argparse
import json
import os
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neumesh_tpu_torch.tools import quality_gate as qg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_block(start, end, include_end=False):
    """The statements of tools/quality_gate.py from the line holding
    `start` up to the one holding `end`, dedented."""
    lines = open(os.path.join(REPO, "tools", "quality_gate.py")).read() \
        .splitlines()
    i = next(k for k, ln in enumerate(lines) if start in ln)
    j = next(k for k in range(i + 1, len(lines)) if end in lines[k])
    if include_end:
        # through the end of that statement (its closing parenthesis)
        while lines[j].count("(") > lines[j].count(")") or \
                not lines[j].rstrip().endswith(")"):
            j += 1
        j += 1
    return textwrap.dedent("\n".join(lines[i:j]))


def jax_gate(scores, args, prev):
    """The JAX gate's JSON on the same scores: its per-mode statements
    (eval_renders), carry, image_vs_image and the block from
    results["surface_steps"] to gate_volume, executed as written."""
    from neumesh_tpu.ops.metrics import psnr as psnr_fn
    ns = {"np": np, "jnp": jnp, "psnr_fn": psnr_fn, "args": args,
          "prev": prev, "prev_path": "quality_gate.json", "results": {},
          "renders": {t: s["renders"] for t, s in scores.items()},
          "serving_f32_layers": tuple(
              t for t in (args.f32_layers or "").split(",") if t)}
    exec(jax_block("def image_vs_image", "from neumesh_tpu.render"), ns)
    exec(jax_block("def carry(tag)", 'if "volume_f32" in modes'), ns)
    per_mode = jax_block("results[tag] = round(", 'print(f"{tag}: mean')
    for tag in qg.MODES:
        if tag in scores:
            s = scores[tag]
            exec(per_mode, dict(ns, tag=tag, psnrs=s["psnr"],
                                ssims=s["ssim"], lpipss=s.get("lpips", [])))
        else:
            ns["carry"](tag)
    exec(jax_block('results["surface_steps"] = args.surface_steps',
                   'results["gate_volume"] = bool(', include_end=True), ns)
    return ns["results"]


def fixed_scores(seed, tags=qg.MODES, lpips=False):
    rng = np.random.default_rng(seed)
    base = rng.uniform(20, 35)
    gt = rng.uniform(size=(64, 3)).astype(np.float32)
    out = {}
    for k, tag in enumerate(tags):
        s = {"psnr": list(base + rng.normal(size=4) * 0.5 + 0.03 * k),
             "ssim": list(rng.uniform(0.8, 0.95, 4)),
             "renders": [np.clip(gt + rng.normal(size=gt.shape) * 0.03 * (
                 k + 1), 0, 1).astype(np.float32) for _ in range(4)]}
        if lpips:
            s["lpips"] = list(rng.uniform(0.05, 0.2, 4))
        out[tag] = s
    return out


VARIANTS = {
    "defaults": ([], {}),
    "lpips": ([], {"lpips": True}),
    "knobs": (["--surface-shade-composite", "8", "--surface-shade-topk", "4",
               "--scan-candidates", "64", "--eval-candidates", "32",
               "--no-secant-rebracket", "--secant-frozen-knn",
               "--surface-tile", "64", "--volume-root-anchored", "0",
               "--f32-layers", "", "--scan-knn-k", "0",
               "--tile-cell-budget", "0", "--scene", "torus"], {}),
    "carried": (["--modes", "volume_bf16,surface_fast"], {"carry": True}),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_gate_results_reproduce_the_jax_gate(variant):
    flags, opt = VARIANTS[variant]
    args = qg.create_parser().parse_args(flags)
    tags = [t for t in qg.MODES if t in args.modes.split(",")]
    scores = fixed_scores(len(flags), tags, lpips=opt.get("lpips", False))
    prev = {}
    if opt.get("carry"):
        prev = dict(qg.gate_results(fixed_scores(9, lpips=True), args),
                    volume_serving_vs_f32_img=31.5)
    got = qg.gate_results(scores, args, prev)
    # the JAX gate's flags: the port's plus the TPU program blocking
    jargs = argparse.Namespace(**vars(args), secant_tiles_per_program=4)
    want = jax_gate(scores, jargs, prev)
    assert want.pop("secant_tiles_per_program") == 4
    assert list(got) == list(want)
    for k, w in want.items():
        if k.endswith("_img") and w is not None and k not in prev:
            # image-vs-image PSNRs: the JAX and the torch psnr of the same
            # arrays, rounded to 3 decimals
            assert abs(got[k] - w) <= 1e-3 + 1e-9, (k, got[k], w)
        else:
            assert got[k] == w, (k, got[k], w)
    if opt.get("carry"):
        assert got["volume_f32"] == prev["volume_f32"]
        assert got["volume_serving_vs_f32_img"] == 31.5
        with pytest.raises(ValueError, match="no score"):
            qg.gate_results(scores, args, {})


def test_gate_results_gates_at_their_thresholds():
    args = qg.create_parser().parse_args([])

    def gates(vf32, vbf16, sf32, sfast):
        scores = {}
        for tag, p in zip(qg.MODES, (vf32, vbf16, sf32, sfast)):
            scores[tag] = {"psnr": [p], "ssim": [0.9],
                           "renders": [np.zeros((4, 3), np.float32)]}
        r = qg.gate_results(scores, args)
        return r["gate_bf16"], r["gate_surface"], r["gate_volume"]
    assert gates(30.0, 29.95, 31.0, 30.95) == (True, True, True)
    assert gates(30.0, 29.85, 31.0, 30.85) == (False, True, False)
    assert gates(30.0, 31.0, 29.9, 29.95) == (True, False, True)


@pytest.fixture
def tiny_gate(monkeypatch):
    """The gate at a CPU size: 4 views of 32x32, one scored view, narrow
    models and coarse sampling; the TF32 flags restored afterwards."""
    monkeypatch.setattr(qg, "SCENE", dict(n_views=4, H=32, W=32,
                                          focal=40.0))
    monkeypatch.setattr(qg, "EVAL_VIEWS", (1,))
    neus, neumesh = qg.neus_config, qg.neumesh_config

    def small_neus(*a, **k):
        c = neus(*a, **k)
        c.data.update(N_rays=64, val_rayschunk=256)
        c.model.surface.update(D=2, W=32, embed_multires=2)
        c.model.radiance.update(D=1, W=32, embed_multires_view=1)
        c.model.update(W_geometry_feature=16, N_samples=16,
                       N_importance=16, N_upsample_iters=2)
        return c

    def small_neumesh(*a, **k):
        c = neumesh(*a, **k)
        c.data.update(N_rays=64, val_rayschunk=256)
        c.model.update(D_density=2, D_color=2, W=32, geometry_dim=8,
                       color_dim=8, multires_d=4, multires_fg=1,
                       multires_ft=1, multires_view=2, N_samples=16,
                       N_importance=16, N_upsample_iters=2)
        return c
    monkeypatch.setattr(qg, "neus_config", small_neus)
    monkeypatch.setattr(qg, "neumesh_config", small_neumesh)
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = flags


def test_gate_pipeline_on_the_cpu(tiny_gate, tmp_path, monkeypatch):
    """Teacher -> mesh -> student -> four modes -> JSON. The train loop
    is made to turn TF32 on as it does on the card: after the gate's
    training it is off. Then --skip-train with --modes re-renders one
    mode from the same checkpoints and carries the others."""
    from neumesh_tpu_torch.train import loop

    def card_like(precision, device):
        torch.backends.cuda.matmul.allow_tf32 = precision != "highest"
        torch.backends.cudnn.allow_tf32 = precision != "highest"
    monkeypatch.setattr(loop, "_set_matmul_precision", card_like)
    wd = str(tmp_path / "qg")
    entered = []

    def mode_context(tag):
        entered.append(tag)
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
        return torch.no_grad()
    base = ["--iters", "3", "--workdir", wd, "--n-grid", "24",
            "--device", "cpu"]
    out = qg.run(qg.create_parser().parse_args(base), mode_context)
    assert entered == list(qg.MODES)
    assert not torch.backends.cuda.matmul.allow_tf32
    for d in ("qgate_neus", "qgate_neumesh"):
        assert os.path.exists(os.path.join(wd, "logs", d, "ckpts",
                                           "latest.ckpt"))
    assert out["train"]["extract"]["n_triangles"] > 100
    assert set(out["train"]) == {"neus_s", "neumesh_s", "extract"}
    saved = json.load(open(os.path.join(wd, "quality_gate.json")))
    assert saved == {k: v for k, v in out.items()
                     if k not in ("train", "scores", "paths")}
    for tag in qg.MODES:
        s = out["scores"][tag]
        assert np.isfinite(saved[tag]) and np.isfinite(saved[tag + "_ssim"])
        assert s["renders"][0].shape == (32 * 32, 3)
        assert np.isfinite(s["renders"][0]).all()
    for k in ("gate_bf16", "gate_surface", "gate_volume"):
        assert isinstance(saved[k], bool)

    again = qg.run(qg.create_parser().parse_args(
        base + ["--skip-train", "--modes", "surface_fast"]))
    assert again["train"] == {}
    for tag in ("volume_f32", "volume_bf16", "surface_f32"):
        assert again[tag] == saved[tag]
    assert again["surface_fast"] == saved["surface_fast"]
    assert again["surface_vs_volume_img"] == saved["surface_vs_volume_img"]


def test_gate_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        qg.main(["--workdir", str(tmp_path / "qg"), "--iters", "1"])
    assert not os.path.exists(tmp_path / "qg")
