"""Time field_fused and secant_refine of several checkouts of the port on
one card, in turns (A B B A ...), at the flagship widths.

    python3 neumesh_tpu_torch/ab_field_kernels.py ROOT_A ROOT_B [--rounds 2]

Each ROOT is the root of a checkout holding neumesh_tpu_torch/. Every
measurement runs in a process of its own that imports that root's package
and builds its kernels; the inputs, weight dtypes and timer come from this
script's own checkout, so they are the same for every root:
tests/test_torch_cuda.py::random_context at W = 256, geometry/colour dims
32/32, multires 8/2/2/4, B = 512 tiles of C = 128 candidates, k = 8;
S = 1024 samples a tile for density / density_nabla, 512 for full, and
secant_refine with the re-bracket on 65,536 rays (3 iterations); weights
in f32 and in bf16 (test_torch_cuda.low_precision_mask). Prints one JSON
line per measurement: the root, the card, and each call's mean ms over 10
launches after a warm-up (chip_smoke.cuda_ms, CUDA events).

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


def measure(root: str) -> dict:
    # the measured package from root; the test helpers and the timer from
    # this checkout (behind root, which may hold a chip_smoke of its own)
    sys.path[:0] = [root, os.path.join(HERE, "tests"), HERE]
    import torch
    import test_torch_cuda as tc
    from chip_smoke import cuda_ms
    from neumesh_tpu_torch.ops import kernels

    inp = tc.random_context(seed=1, B=512, S=1024, C=128, **WIDE)
    br = tc.brackets(10, 512 * 128)

    def t(a):
        return torch.from_numpy(a).cuda()

    def weights(lst, n_first, dtype):
        low = tc.low_precision_mask(lst, dtype, (), n_first)
        return [t(w).to(torch.bfloat16) if lo else t(w)
                for w, lo in zip(lst, low)]

    xyz, geo, feat, dirs = (t(inp[n]) for n in ("xyz", "geo", "feat",
                                                "dirs"))
    rays = [t(br[n]) for n in ("rays_o", "rays_d", "d_low", "d_high",
                               "f_low", "f_high")]
    out = {}
    for dtype, tag in ((None, "f32"), (torch.bfloat16, "bf16")):
        low = None if dtype is None else "bf16"
        dws, cws = weights(inp["dws"], 2, low), weights(inp["cws"], 1, low)
        for want, S in (("density", 1024), ("density_nabla", 1024),
                        ("full", 512)):
            F = 64 if want == "full" else 32
            x, d = xyz[:, :S].contiguous(), dirs[:, :S].contiguous()
            fe = feat[..., :F].contiguous()
            out[f"field_fused/{want}/{tag}"] = cuda_ms(
                lambda: kernels.field_fused(
                    x, geo, fe, inp["w1"], dws,
                    cws if want == "full" else None, d, want=want,
                    dtype=dtype, **inp["kw"]), reps=10)
        gfeat = feat[..., :32].contiguous()
        out[f"secant_refine/rebracket/{tag}"] = cuda_ms(
            lambda: kernels.secant_refine(
                *rays, geo, gfeat, inp["w1"], dws, n_iters=3, multires_d=8,
                multires_fg=2, geometry_dim=32, dtype=dtype,
                d_low_w=t(br["d_low_w"]), d_high_w=t(br["d_high_w"])),
            reps=10)
    return {"root": root, "card": torch.cuda.get_device_name(0), "ms": out}


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--measure":
        print(json.dumps(measure(os.path.abspath(sys.argv[2]))), flush=True)
        return 0
    args = sys.argv[1:]
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
                                 "--measure", root]).returncode
            if rc:
                return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
