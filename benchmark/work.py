"""The yardstick: the card's peaks, each kernel call's least time, and the
model FLOPs of a frame or a training step.

A kernel call's bound is the larger of its operations over the peaks and
its bytes over the memory rate. Every dense-layer product counts at the
bf16 dense rate whatever precision an implementation runs it in, and the
other arithmetic at the CUDA cores' f32 rate, so no implementation of the
same work can read above 100%. Bytes: each input read once, each output
written once.
"""
from __future__ import annotations

# NVIDIA H100 SXM, dense, at the 700 W power limit
PEAK_DENSE_FLOPS = 989e12       # bf16 tensor cores
PEAK_F32_FLOPS = 67e12          # CUDA cores
PEAK_BYTES = 3.35e12            # HBM3

_N_OUT = {"distance": 1, "density": 1, "density_nabla": 4, "full": 7}


def _mlp_flops(ws):
    """2 in out of every weight matrix (in > 1) in ws."""
    return sum(2.0 * w.shape[0] * w.shape[1] for w in ws
               if hasattr(w, "dim") and w.dim() == 2 and w.shape[0] > 1)


def _nbytes(ts):
    return float(sum(t.numel() * t.element_size() for t in ts
                     if t is not None and hasattr(t, "numel")))


def field_work(args, kw):
    """(dense flops, other flops, bytes) of one field_fused call, from its
    arguments as the program passes them."""
    xyz, geo, feat = args[0], args[1], args[2]
    dens_ws = args[4] if len(args) > 4 else kw.get("dens_ws", ())
    col_ws = args[5] if len(args) > 5 else kw.get("col_ws")
    dirs = args[6] if len(args) > 6 else kw.get("dirs")
    want, k = kw.get("want", "density"), kw.get("k", 8)
    B, S, _ = xyz.shape
    C, F = geo.shape[2], feat.shape[-1]
    n = float(B * S)
    other = n * C * (10 + (k if k > 1 else 1))        # d2 + selection
    dense = 0.0
    ins = [xyz, geo]
    if want != "distance":
        other += n * (30 * k + 2 * k * F)              # interp + blend
        dense += n * _mlp_flops(dens_ws)
        if want != "density":
            # the tangent dD/dh: w0d, the hidden layers and the head; fg's
            # rows (w0f) do not depend on h
            dense += n * _mlp_flops((dens_ws[0], *dens_ws[3:]))
        ins += [feat, *dens_ws]
    if want == "full":
        dense += n * _mlp_flops(col_ws)
        ins += [dirs, *col_ws]
    return dense, other, _nbytes(ins) + n * 4 * _N_OUT[want]


def secant_work(args, kw):
    """(dense flops, other flops, bytes) of one secant_refine call."""
    rays_o, geo, feat, dens_ws = args[0], args[6], args[7], args[9]
    R = rays_o.shape[0]
    C, F = geo.shape[2], feat.shape[-1]
    k = kw.get("k", 8)
    evals = kw.get("n_iters", 6) + (2 if kw.get("d_low_w") is not None
                                    else 0)
    per_eval = 30 * k + 2 * k * F
    if kw.get("frozen_knn"):
        other = R * (C * (20 + k) + evals * per_eval)
    else:
        other = R * evals * (C * (10 + k) + per_eval)
    nbytes = _nbytes([geo, feat, *dens_ws]) + R * 4 * (6 + 6 + 1)
    return R * evals * _mlp_flops(dens_ws), other, nbytes


WORK = {"field_fused": field_work, "secant_refine": secant_work}


def bound_s(name, args, kw) -> float:
    """The least time of one call of kernel `name` on the card."""
    dense, other, nbytes = WORK[name](args, kw)
    return max(dense / PEAK_DENSE_FLOPS + other / PEAK_F32_FLOPS,
               nbytes / PEAK_BYTES)


# --- model FLOPs -----------------------------------------------------------

def _enc(dim, multires):
    return dim if multires < 0 else dim * (1 + 2 * multires)


def _chain(dims):
    return sum(2.0 * a * b for a, b in zip(dims[:-1], dims[1:]))


def neumesh_mlp_flops(m: dict):
    """(density, colour) FLOPs of one NeuMesh sample."""
    W = m["W"]
    d_emb = _enc(1, m["multires_d"])
    dens_in = d_emb + _enc(m["geometry_dim"], m["multires_fg"])
    dens = _chain([dens_in, *[W] * m["D_density"], 1])
    col_in = (3 * m["enable_nablas_input"] + d_emb
              + _enc(3, m["multires_view"])
              + _enc(m["color_dim"], m["multires_ft"]))
    col = _chain([col_in, *[W] * m["D_color"], 3])
    return dens, col


def volume_ray_flops(m: dict, r: dict) -> float:
    """Model FLOPs of one ray of the reference volume structure: the
    density at every sorted depth (coarse and up-sampled), then at every
    midpoint the density, its gradient (a product through every layer
    back to the input, as FlopCounterMode counts it over the plain
    reference) and the colour."""
    dens, col = neumesh_mlp_flops(m)
    n = r["N_samples"] + r["N_importance"]
    return n * dens + (n - 1) * (2 * dens + col)


def neus_mlp_flops(a: dict):
    """(sdf net, radiance net) FLOPs of one NeuS sample."""
    s, rd = a["model"]["surface"], a["model"]["radiance"]
    W = s["W"]
    e = _enc(3, s["embed_multires"])
    dims = []
    for l in range(s["D"] + 1):
        if l == s["D"]:
            out = 1 + a["model"].get("W_geometry_feature", 256)
        elif (l + 1) in s["skips"]:
            out = W - e
        else:
            out = W
        dims.append((e if l == 0 else W, out))
    sdf = sum(2.0 * i * o for i, o in dims)
    r_in = (_enc(3, rd["embed_multires"]) + _enc(3, rd["embed_multires_view"])
            + 3 + a["model"].get("W_geometry_feature", 256))
    rad = _chain([r_in, *[rd["W"]] * rd["D"], 3])
    return sdf, rad


# FLOPs of one NeuS training step per sample, as multiples of one forward
# of the sdf net and of the radiance net, read once from
# torch.utils.flop_counter.FlopCounterMode over the plain reference step
# at the configuration's widths (benchmark/tests/test_nmb_work.py holds
# the closed form to it). At every sorted depth: the up-sampling's
# no-grad sdf (1 x), then the sdf and its normal with the graph kept and
# their backward, the eikonal's double backward included (STEP_SAMPLE);
# at every midpoint the same for the sdf net (STEP_MID_SDF) and the
# radiance net's forward and backward (STEP_MID_RAD).
STEP_SAMPLE = 6142976 / 1049088
STEP_MID_SDF = 6290944 / 1049088
STEP_MID_RAD = 1480192 / 542720


def neus_step_flops(a: dict, r: dict, rays: int) -> float:
    """Model FLOPs of one NeuS training step over `rays` rays that meet
    the bounding sphere; r holds the step's N_samples and N_importance."""
    sdf, rad = neus_mlp_flops(a)
    n = r["N_samples"] + r["N_importance"]
    return rays * (n * sdf + n * STEP_SAMPLE * sdf
                   + (n - 1) * (STEP_MID_SDF * sdf + STEP_MID_RAD * rad))


# FLOPs of one NeuMesh distillation step per sample, read once from
# FlopCounterMode over the plain reference step (the same test holds it):
# at every sorted depth the up-sampling's density (1 x) and the density
# and its gradient with the graph kept and their backward
# (STUDENT_SAMPLE x the density MLP); at every midpoint the same, the
# colour MLP's forward and backward (3 x) and the teacher's sdf, its
# normal (2 x the sdf net) and radiance, without gradient.
STUDENT_SAMPLE = 2119168 / 353280


def distill_step_flops(m: dict, teacher: dict, r: dict, rays: int) -> float:
    """Model FLOPs of one NeuMesh distillation step over `rays` rays that
    meet the bounding sphere; teacher is the NeuS program configuration."""
    dens, col = neumesh_mlp_flops(m)
    sdf, rad = neus_mlp_flops(teacher)
    n = r["N_samples"] + r["N_importance"]
    return rays * (n * (1 + STUDENT_SAMPLE) * dens
                   + (n - 1) * (STUDENT_SAMPLE * dens + 3 * col + 2 * sdf
                                + rad))


def surface_ray_flops(m: dict, r: dict) -> float:
    """Model FLOPs of one ray of the surface structure: the density at the
    two widened bracket ends and at every secant step, then the density,
    its gradient and the colour at the hit."""
    dens, col = neumesh_mlp_flops(m)
    return (2 + r["N_secant_steps"]) * dens + 2 * dens + col
