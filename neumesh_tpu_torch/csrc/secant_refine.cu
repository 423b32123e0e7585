// secant_refine: every secant iteration of the root refinement in one
// launch.
//
// Replaces neumesh_tpu/ops/pallas_kernels.py::_secant_kernel (wrapper
// secant_refine, pl.pallas_call at :1405). Each density evaluation runs the
// same interpolation + feature blend + density-MLP chain as field_fused
// (field_common.cuh). Options: `rebracket` evaluates the density at the
// half-step-widened proxy endpoints (d_high_w first, then d_low_w) and
// keeps them where they straddle the root, else the proxy bracket;
// `frozen` selects the k neighbours once at the bracket midpoint and
// evaluates |x_mid + de r - p|^2 = A + 2 de B + de^2 on the k selected
// columns only. The TPU kernel's tile grouping knob is dropped: rays are
// independent, so a block simply takes 32 rays of one tile.
//
// What bounds it on the H100: the density MLP of each of the
// n_iters (+2 with the re-bracket) sequential evaluations, i.e.
// operations; the inputs are a few floats per ray. The design keeps the
// whole iteration chain of a ray inside one block (bracket state in
// registers of the ray's owner thread, the tile context in shared
// memory), so no intermediate leaves the chip between iterations.
#include "field_common.cuh"

namespace nm {

__global__ void __launch_bounds__(NT) secant_refine_kernel(const SecantArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * SB;
  const int C = a.C, T = a.T, tid = threadIdx.x, k = a.k, ldx = a.ldx;
  float* sgeo = smem;                  // 8 * C
  float* so = sgeo + 8 * C;            // SB * 4
  float* sr = so + SB * 4;             // SB * 4
  float* sxyz = sr + SB * 4;           // SB * 4
  float* sds = sxyz + SB * 4;          // SB
  float* sdens = sds + SB;             // SB
  float* sdev = sdens + SB;            // SB
  float* sdm = sdev + SB;              // SB
  float* sFB = sdm + SB;               // SB * F
  float* sW = sFB + SB * a.F;          // SB * C
  float* sX = sW + SB * C;             // SB * ldx
  float* sA = sX + SB * ldx;           // SB * KSEL (frozen picks)
  float* sBq = sA + SB * KSEL;
  float* sE = sBq + SB * KSEL;
  float* sF = sE + SB * KSEL;
  float* sW8 = sF + SB * KSEL;
  unsigned char* srank = reinterpret_cast<unsigned char*>(sW8 + SB * KSEL);

  for (int i = tid; i < 8 * C; i += NT) sgeo[i] = a.geo[(size_t)b * 8 * C + i];
  // owner thread s < SB holds ray r0 + s's bracket state
  const bool owner = tid < SB;
  const bool valid = owner && r0 + tid < T;
  float dl = 0.f, dh = 0.f, fl = 0.f, fh = 0.f, dlw = 0.f, dhw = 0.f;
  if (owner) {
    const size_t ray = (size_t)b * T + min(r0 + tid, T - 1);
    for (int i = 0; i < 3; ++i) {
      so[tid * 4 + i] = a.rays_o[ray * 3 + i];
      sr[tid * 4 + i] = a.rays_d[ray * 3 + i];
    }
    dl = a.d_low[ray];
    dh = a.d_high[ray];
    fl = a.f_low[ray];
    fh = a.f_high[ray];
    if (a.rebracket) {
      dlw = a.d_low_w[ray];
      dhw = a.d_high_w[ray];
    }
    sdm[tid] = a.rebracket ? fmul(0.5f, fadd(dlw, dhw))
                           : fmul(0.5f, fadd(dl, dh));
  }
  __syncthreads();

  const int s = tid / LPS, lane = tid % LPS;
  const float *px = sgeo, *py = sgeo + C, *pz = sgeo + 2 * C,
              *ix = sgeo + 3 * C, *iy = sgeo + 4 * C, *iz = sgeo + 5 * C,
              *pp = sgeo + 6 * C, *vn = sgeo + 7 * C;

  if (a.frozen) {
    // one-time selection at the bracket midpoint x_mid = o + d_mid r
    const float o0 = so[s * 4], o1 = so[s * 4 + 1], o2 = so[s * 4 + 2];
    const float q0 = sr[s * 4], q1 = sr[s * 4 + 1], q2 = sr[s * 4 + 2];
    const float dm = sdm[s];
    const float xm0 = fadd(o0, fmul(dm, q0)), xm1 = fadd(o1, fmul(dm, q1)),
                xm2 = fadd(o2, fmul(dm, q2));
    auto quad = [&](int c, float& A, float& Bq, float& E, float& F) {
      const float dx = fsub(xm0, px[c]), dy = fsub(xm1, py[c]),
                  dz = fsub(xm2, pz[c]);
      A = fadd(fadd(fmul(dx, dx), fmul(dy, dy)), fmul(dz, dz));
      Bq = fadd(fadd(fmul(dx, q0), fmul(dy, q1)), fmul(dz, q2));
      E = fsub(fadd(fadd(fmul(xm0, ix[c]), fmul(xm1, iy[c])), fmul(xm2, iz[c])),
               vn[c]);
      F = fadd(fadd(fmul(q0, ix[c]), fmul(q1, iy[c])), fmul(q2, iz[c]));
    };
    auto cur_at = [&](int c) {
      float A, Bq, E, F;
      quad(c, A, Bq, E, F);
      // pad columns (pp >= 1e11) keep their sentinel distance
      const float d2m = fadd(A, pp[c] >= 1e11f ? pp[c] : 0.f);
      return fmul(d2m, fadd(1.f, fmul((float)c, 2e-7f)));
    };
    float thr[KSEL];
    float prev = -INFINITY;
#pragma unroll
    for (int it = 0; it < KSEL; ++it) {
      thr[it] = INFINITY;
      if (it < k) {
        float m = INFINITY;
        for (int c = lane; c < C; c += LPS) {
          const float t = cur_at(c);
          if (t > prev) m = fminf(m, t);
        }
        prev = gmin(m);
        thr[it] = prev;
      }
    }
    float pa[KSEL], pb[KSEL], pe[KSEL], pf[KSEL];
#pragma unroll
    for (int it = 0; it < KSEL; ++it) pa[it] = pb[it] = pe[it] = pf[it] = 0.f;
    for (int c = lane; c < C; c += LPS) {
      const float t = cur_at(c);
      int rank = 255;
#pragma unroll
      for (int it = KSEL - 1; it >= 0; --it)
        if (it < k && t <= thr[it]) rank = it;
      srank[s * C + c] = (unsigned char)rank;
      if (rank < k) {
        float A, Bq, E, F;
        quad(c, A, Bq, E, F);
#pragma unroll
        for (int it = 0; it < KSEL; ++it)
          if (it == rank) {
            pa[it] = fadd(pa[it], A);
            pb[it] = fadd(pb[it], Bq);
            pe[it] = fadd(pe[it], E);
            pf[it] = fadd(pf[it], F);
          }
      }
    }
#pragma unroll
    for (int it = 0; it < KSEL; ++it) {
      if (it < k) {
        const float va = gsum(pa[it]), vb = gsum(pb[it]), ve = gsum(pe[it]),
                    vf = gsum(pf[it]);
        if (lane == 0) {
          sA[s * KSEL + it] = va;
          sBq[s * KSEL + it] = vb;
          sE[s * KSEL + it] = ve;
          sF[s * KSEL + it] = vf;
        }
      }
    }
  }
  __syncthreads();

  // density (minus tau) at depth dv of each owner's ray; all threads call
  auto field = [&](float dv) -> float {
    if (owner) {
      sdev[tid] = dv;
      for (int i = 0; i < 3; ++i)
        sxyz[tid * 4 + i] = fadd(so[tid * 4 + i], fmul(dv, sr[tid * 4 + i]));
    }
    __syncthreads();
    float* Wrow = sW + s * C;
    if (!a.frozen) {
      Interp r;
      interp_sample(sgeo, C, sxyz[s * 4], sxyz[s * 4 + 1], sxyz[s * 4 + 2],
                    a.w1, k, false, lane, Wrow, r);
      if (lane == 0) sds[s] = r.ds;
    } else {
      const float de = fsub(sdev[s], sdm[s]);
      float d_[2], d2_[2], wr_[2];
      float sw = 0.f;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int rr = lane + u * LPS;
        d_[u] = d2_[u] = wr_[u] = 0.f;
        if (rr < k) {
          const float A = sA[s * KSEL + rr], Bq = sBq[s * KSEL + rr];
          d2_[u] = fmaxf(fadd(fadd(A, fmul(fmul(2.f, de), Bq)), fmul(de, de)),
                         1e-20f);
          d_[u] = sqrtf(d2_[u]);
          wr_[u] = fdiv(1.f, fadd(d_[u], 1e-7f));
          sw = fadd(sw, wr_[u]);
        }
      }
      sw = gsum(sw);
      float ds = 0.f;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int rr = lane + u * LPS;
        if (rr < k) {
          const float W8 = fdiv(wr_[u], sw);
          const float term =
              fadd(fmul(a.w1, fadd(sE[s * KSEL + rr],
                                   fmul(de, sF[s * KSEL + rr]))),
                   fmul(d_[u], d2_[u]));
          ds = fadd(ds, fdiv(fmul(W8, term), fadd(a.w1, d_[u])));
          sW8[s * KSEL + rr] = W8;
        }
      }
      ds = gsum(ds);
      __syncwarp();
      for (int c = lane; c < C; c += LPS) {
        const int rk = srank[s * C + c];
        Wrow[c] = rk < k ? sW8[s * KSEL + rk] : 0.f;
      }
      if (lane == 0) sds[s] = ds;
    }
    __syncthreads();
    blend_stage(a.feat, (size_t)b * C * a.F, a.feat_bf16, a.F, a.gd, sW, C,
                sFB);
    __syncthreads();
    density_stage(a.dens, sX, nullptr, ldx, sds, sFB, a.F, a.md, a.mfg,
                  a.gd, a.lowp, false, sdens, nullptr);
    return owner ? fsub(sdens[tid], a.tau) : 0.f;
  };
  auto pred = [&]() {
    float denom = fsub(fh, fl);
    if (fabsf(denom) < 1e-12f) denom = 1e-12f;
    return fadd(fdiv(fmul(-fl, fsub(dh, dl)), denom), dl);
  };

  if (a.rebracket) {
    const float fhr = field(dhw);
    const float flr = field(dlw);
    if (fhr > 0.f && flr < 0.f) {
      fh = fhr;
      fl = flr;
      dh = dhw;
      dl = dlw;
    }
  }
  float dp = pred();
  for (int it = 0; it < a.n_iters; ++it) {
    const float fm = field(dp);
    if (fm < 0.f) {
      dl = dp;
      fl = fm;
    } else {
      dh = dp;
      fh = fm;
    }
    dp = pred();
  }
  if (valid) a.out[(size_t)b * T + r0 + tid] = dp;
}

}  // namespace nm

extern "C" {

size_t nm_secant_refine_smem(const nm::SecantArgs* a) {
  const size_t SB = nm::SB;
  return sizeof(float) * (8 * (size_t)a->C + SB * (3 * 4 + 4) +
                          SB * a->F + SB * a->C + SB * a->ldx +
                          5 * SB * nm::KSEL) +
         SB * a->C;
}

int nm_secant_refine(const nm::SecantArgs* a, void* stream) {
  if (a->R <= 0) return 0;
  if (a->B <= 0 || a->B > 65535 || a->T * a->B != a->R || a->k < 1 ||
      a->k > nm::KSEL || (a->ldx & 3) || a->ldx < 4)
    return (int)cudaErrorInvalidValue;
  const size_t smem = nm_secant_refine_smem(a);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      nm::secant_refine_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a->T + nm::SB - 1) / nm::SB, a->B);
  nm::secant_refine_kernel<<<grid, nm::NT, smem, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

const char* nm_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
