"""Time the field kernels of several checkouts of the port on one card, in
turns (A B B A ...), at the flagship widths.

    python3 neumesh_tpu_torch/ab_field_kernels.py ROOT_A ROOT_B [--rounds 2]
        [--only SUBSTRING]

Each ROOT is the root of a checkout holding neumesh_tpu_torch/. Every
measurement runs in a process of its own that imports that root's package
and builds its kernels; the inputs, weight dtypes and timer come from this
script's own checkout, so they are the same for every root:
tests/test_torch_cuda.py::random_context at W = 256, geometry/colour dims
32/32, multires 8/2/2/4, B = 512 tiles of C = 128 candidates, k = 8;
S = 1024 samples a tile for density / density_nabla, 512 for full, and
secant_refine in its four options (plain, re-bracket, frozen, frozen with
the re-bracket) on 65,536 rays (3 iterations); weights in f32 and in bf16
(test_torch_cuda.low_precision_mask), field_fused also in bf16 with the
selective-f32 layers d0, dh, c0, ch ("bf16_sel", the surface
structures' weights). field_fused distance at S = 2048
samples a tile: k = 1 (the serving scan) and k = 8 on 512 tiles, k = 8 on
32 contexts of 16,384 samples (the shape of the editing swap's surface
scan; the same samples regrouped), and the
per-ray shapes, k = 1 on 4,096 contexts of C = 96 at S = 1, 16, 128.
surface_locate on
65,536 rays in 512 tiles of 128 (test_torch_cuda.locate_rays into a
context of outward normals; 16 scan steps, 3 secant steps), f32 and bf16.
candidate_field_v3 in its four modes at S = 512 samples a tile, F = 64,
and candidate_field (v2) in its four modes on 4,096 rays of S = 64 samples
and C = 96 candidates each (test_torch_cuda.ray_contexts). The render
CLI's per-ray f32 calls ("per_ray/..."), one call of a 128x128 view's four
chunks: 4,096 contexts of C = 96 candidates at the flagship widths,
field_fused density at S = 16 and 64, density_nabla at S = 128, full at
S = 1 and 127, and the plain secant (8 iterations) at one ray a context,
f32 weights. Prints one JSON
line per measurement: the root, the card (name and power limit), and each
call's ms: the median of three windows of 10 launches each after a warm-up
(chip_smoke.cuda_ms, CUDA events; the mean of a window), under "min"
the fastest window, for the distance rows under "device" the device
time alone (chip_smoke.graph_ms: 20 calls in a CUDA graph; around a call
shorter than its host launch, the events time the launch), and for the
tile-shaped field_fused rows under "bound" [ms, what bounds it]
(chip_smoke.kernel_bound; the distance rows add the instruction floor,
chip_smoke.distance_floor_ms), the secant rows' too, and under
"bound_cuda_core" each of those rows' bound with every f32 flop at the
CUDA-core rate (chip_smoke.cuda_core_bound). --only keeps the rows whose name holds
SUBSTRING (or one of several, comma-separated).

    python3 neumesh_tpu_torch/ab_field_kernels.py --split ROOT [ROOT ...]

times where a tile block's time goes instead (ops/kernels.py::stage_split,
the kernels' timing instantiation) in the rows of SPLIT_ROWS: one JSON line
a root with each row's stage shares, cycles and microseconds a tile; a
root whose package has no stage_split prints its rows as null.

A measurement script, not part of the package: no module of the port
imports it. It sits in the port's tree so that the same-card A/B numbers
of PERF.md come from a committed script.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDE = dict(W=256, gd=32, cd=32, md=8, mfg=2, mft=2, mv=4)
# the rows whose block time --split breaks down
SPLIT_ROWS = ("field_fused/density/bf16", "field_fused/density_nabla/bf16",
              "field_fused/full/bf16", "secant_refine/rebracket/bf16",
              "field_fused/density/f32", "field_fused/density_nabla/f32",
              "field_fused/full/f32", "field_fused/full/bf16_sel",
              "secant_refine/rebracket/f32", "secant_refine/plain/f32")


def measure(root: str, only: str = "", split: bool = False) -> dict:
    # the measured package from root; the test helpers and the timer from
    # this checkout (behind root, which may hold a chip_smoke of its own)
    sys.path[:0] = [root, os.path.join(HERE, "tests"), HERE]
    import torch
    import test_torch_cuda as tc
    from chip_smoke import (card_line, cuda_core_bound, cuda_ms,
                            distance_floor_ms, graph_ms, kernel_bound)
    from neumesh_tpu_torch.ops import kernels

    inp = tc.random_context(seed=1, B=512, S=1024, C=128, **WIDE)
    br = tc.brackets(10, 512 * 128)

    def t(a):
        return torch.from_numpy(a).cuda()

    def weights(lst, n_first, dtype, keep=()):
        low = tc.low_precision_mask(lst, dtype, keep, n_first)
        return [t(w).to(torch.bfloat16) if lo else t(w)
                for w, lo in zip(lst, low)]

    xyz, geo, feat, dirs = (t(inp[n]) for n in ("xyz", "geo", "feat",
                                                "dirs"))
    rays = [t(br[n]) for n in ("rays_o", "rays_d", "d_low", "d_high",
                               "f_low", "f_high")]
    loc = tc.random_context(seed=2, B=512, S=1, C=128, outward=True, **WIDE)
    lr = tc.locate_rays(3, 512, 128, 16)
    lrays = [t(lr[n]) for n in ("rays_o", "rays_d", "near", "far")]
    lgeo, lfeat = t(loc["geo"]), t(loc["feat"][..., :32])
    rc = tc.ray_contexts(seed=4, R=4096, S=64, C=96, F=64)
    v2 = [t(rc[n]) for n in ("xyz", "pts", "pp", "ind", "vn", "feat")]
    out, fastest, device, bound, stages = {}, {}, {}, {}, {}
    bound_cc = {}

    def timed(name, fn, field=None, call=None):
        """field: (args, kw) of a field_fused call, for its bound; call:
        (kernel, args, kw) for --split."""
        if split:
            if name in SPLIT_ROWS:
                kname, a, kw = call or ("field_fused", *field)
                stages[name] = (kernels.stage_split(kname, *a, **kw)
                                if hasattr(kernels, "stage_split") else None)
            return
        if not any(o in name for o in only.split(",")):
            return
        ms = sorted(cuda_ms(fn, reps=10) for _ in range(3))
        out[name], fastest[name] = ms[1], ms[0]
        kb = ("field_fused", *field) if field is not None else call
        if kb is not None:
            bound[name] = kernel_bound(*kb)
            bound_cc[name] = cuda_core_bound(*kb)
        if "distance" in name:
            device[name] = graph_ms(fn)
            bound[name] += (distance_floor_ms(field[0]),)

    def field_call(*a, **kw):
        return (lambda: kernels.field_fused(*a, **kw)), (a, kw)

    sel = tc.SEL_F32
    for dtype, tag in ((None, "f32"), (torch.bfloat16, "bf16"),
                       (torch.bfloat16, "bf16_sel")):
        low = None if dtype is None else "bf16"
        keep = tag == "bf16_sel"
        dws = weights(inp["dws"], 2, low, tc.kept_f32(
            sel, (0, 1), len(inp["dws"]) - 2) if keep else ())
        cws = weights(inp["cws"], 1, low, tc.kept_f32(
            sel, (0,), len(inp["cws"]) - 2) if keep else ())
        for want, S in (("density", 1024), ("density_nabla", 1024),
                        ("full", 512)):
            F = 64 if want == "full" else 32
            x, d = xyz[:, :S].contiguous(), dirs[:, :S].contiguous()
            fe = feat[..., :F].contiguous()
            timed(f"field_fused/{want}/{tag}", *field_call(
                x, geo, fe, inp["w1"], dws, cws if want == "full" else None,
                d, want=want, dtype=dtype, **inp["kw"]))
        if keep:
            continue
        gfeat = feat[..., :32].contiguous()
        for rb in (True, False):
            for fr in (False, True):
                wk = (dict(d_low_w=t(br["d_low_w"]),
                           d_high_w=t(br["d_high_w"])) if rb else {})
                sa = (*rays, geo, gfeat, inp["w1"], dws)
                skw = dict(n_iters=3, multires_d=8, multires_fg=2,
                           geometry_dim=32, dtype=dtype, frozen_knn=fr, **wk)
                timed(f"secant_refine/{kernels.secant_mode(rb, fr)}/{tag}",
                      lambda: kernels.secant_refine(*sa, **skw),
                      call=("secant_refine", sa, skw))
        lws = weights(loc["dws"], 2, low)
        timed(f"surface_locate/{tag}",
            lambda: kernels.surface_locate(
                *lrays, lgeo, lfeat, loc["w1"], lws, n_steps=16, n_secant=3,
                multires_d=8, multires_fg=2, geometry_dim=32, dtype=dtype))
    far = tc.random_context(seed=3, B=512, S=2048, C=128, **WIDE)
    dxyz, dgeo, dfeat = (t(far[n]) for n in ("xyz", "geo", "feat"))
    for k in (1, 8):
        timed(f"field_fused/distance/k{k}", *field_call(
            dxyz, dgeo, dfeat, far["w1"], k=k, want="distance"))
    # the editing swap's surface scan: 32 contexts of 16,384 samples
    timed("field_fused/distance/k8/B32_S16384", *field_call(
        dxyz.reshape(64, 16384, 3)[:32], dgeo[:32], dfeat[:32], far["w1"],
        k=8, want="distance"))
    # the render CLI's per-ray f32 calls (one 4,096-ray chunk of a view)
    pr = tc.random_context(seed=5, B=4096, S=128, C=96, **WIDE)
    pxyz, pgeo, pfeat, pdirs = (t(pr[n]) for n in ("xyz", "geo", "feat",
                                                   "dirs"))
    pdws, pcws = weights(pr["dws"], 2, None), weights(pr["cws"], 1, None)
    for S in (1, 16, 128):
        timed(f"per_ray/field_fused/distance/S{S}/k1", *field_call(
            pxyz[:, :S].contiguous(), pgeo, pfeat, pr["w1"], k=1,
            want="distance"))
    for want, S in (("density", 16), ("density", 64),
                    ("density_nabla", 128), ("full", 1), ("full", 127)):
        F = 64 if want == "full" else 32
        x, d = pxyz[:, :S].contiguous(), pdirs[:, :S].contiguous()
        fe = pfeat[..., :F].contiguous()
        timed(f"per_ray/field_fused/{want}/S{S}/f32",
              lambda: kernels.field_fused(
                  x, pgeo, fe, pr["w1"], pdws,
                  pcws if want == "full" else None, d, want=want,
                  **pr["kw"]))
    pbr = tc.brackets(12, 4096)
    prays = [t(pbr[n]) for n in ("rays_o", "rays_d", "d_low", "d_high",
                                 "f_low", "f_high")]
    pg = pfeat[..., :32].contiguous()
    timed("per_ray/secant_refine/plain/T1/f32",
          lambda: kernels.secant_refine(
              *prays, pgeo, pg, pr["w1"], pdws, n_iters=8, multires_d=8,
              multires_fg=2, geometry_dim=32))
    x5 = xyz[:, :512].contiguous()
    for dh in (False, True):
        for ft in (True, False):
            mode = kernels.candidate_mode(dh, ft)
            timed(f"candidate_field_v3/{mode}",
                lambda: kernels.candidate_field_v3(
                    x5, geo, feat, inp["w1"], k=8, want_dh=dh, want_feat=ft))
            timed(f"candidate_field/{mode}",
                lambda: kernels.candidate_field(
                    *v2, inp["w1"], k=8, want_dh=dh, want_feat=ft))
    if split:
        return {"root": root, "card": card_line(), "split": stages}
    return {"root": root, "card": card_line(), "ms": out, "min": fastest,
            "device": device, "bound": bound, "bound_cuda_core": bound_cc}


def main() -> int:
    if len(sys.argv) in (3, 4) and sys.argv[1] == "--measure":
        print(json.dumps(measure(os.path.abspath(sys.argv[2]),
                                 *sys.argv[3:])), flush=True)
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--measure-split":
        print(json.dumps(measure(os.path.abspath(sys.argv[2]), split=True)),
              flush=True)
        return 0
    args = sys.argv[1:]
    if args[:1] == ["--split"]:
        for root in args[1:]:
            rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                                 "--measure-split", root]).returncode
            if rc:
                return rc
        return 0
    only = []
    if "--only" in args:
        i = args.index("--only")
        only = [args[i + 1]]
        del args[i:i + 2]
    rounds = 2
    if "--rounds" in args:
        i = args.index("--rounds")
        rounds = int(args[i + 1])
        del args[i:i + 2]
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    for r in range(rounds):
        for root in (args if r % 2 == 0 else args[::-1]):
            rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                                 "--measure", root, *only]).returncode
            if rc:
                return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
