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
// independent, so a block simply takes 64 rays of one tile.
//
// What bounds it on the H100: the density MLP of each of the n_iters (+2
// with the re-bracket) sequential evaluations, i.e. operations (the bound
// is the bf16 products on the tensor cores); the inputs are a few floats
// per ray. The design keeps the whole iteration chain of a ray inside one
// block (bracket state in registers of the ray's owner thread, the tile
// context in shared memory), so no intermediate leaves the chip between
// iterations, and runs the density MLP's bf16 layers on the tensor cores
// (field_common.cuh, tile stage): a block takes 64 rays of one tile, one
// wgmma M tile, and the weight-slice ring runs on from one evaluation to
// the next, so the next evaluation's first slices load under the current
// one's candidate passes. What holds it above the bound now is the
// exact-f32 work of every evaluation on the CUDA cores: the kNN passes,
// the softplus epilogues, the blend, the embeddings and the head (and
// the frozen selection, once). The frozen option is its own
// instantiation, so its selection registers do not weigh on the rest.
#include "field_common.cuh"

namespace nm {

// FROZEN: one instantiation per option, so that the frozen selection's
// registers do not weigh on the rest.
template <bool FROZEN>
__global__ void __launch_bounds__(TNT, 1)
    secant_refine_kernel(const __grid_constant__ SecantArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const RayField& f = a.f;
  // one 1-D grid over (context, ray block): any number of contexts
  const int nblk = (f.T + TS - 1) / TS;
  const int b = blockIdx.x / nblk, r0 = (blockIdx.x % nblk) * TS;
  const int tid = threadIdx.x;
  const int C = f.C, k = f.k;
  TileMem m = tile_carve(smem, tile_plan(&f.dens, nullptr, f.ldx, C, false),
                         &f.dens, nullptr, 1, f.ldx);
  tile_start(m);
  const RayTile t = ray_tile_load(f, m, b, r0);
  float* sdev = t.end;                 // TS
  float* sdm = sdev + TS;              // TS
  float* sA = sdm + TS;                // TS * KSEL (frozen picks)
  float* sBq = sA + TS * KSEL;
  float* sE = sBq + TS * KSEL;
  float* sF = sE + TS * KSEL;
  float* sW8 = sF + TS * KSEL;
  unsigned char* srank = reinterpret_cast<unsigned char*>(sW8 + TS * KSEL);

  const bool owner = tid < TS;
  Bracket br{0.f, 0.f, 0.f, 0.f};
  float dlw = 0.f, dhw = 0.f;
  if (owner) {
    const size_t ray = (size_t)b * f.T + min(r0 + tid, f.T - 1);
    br = Bracket{a.d_low[ray], a.f_low[ray], a.d_high[ray], a.f_high[ray]};
    if (a.rebracket) {
      dlw = a.d_low_w[ray];
      dhw = a.d_high_w[ray];
    }
    sdm[tid] = a.rebracket ? fmul(0.5f, fadd(dlw, dhw))
                           : fmul(0.5f, fadd(br.dl, br.dh));
  }
  __syncthreads();

  const int lane = tid % LPS;
  const float *px = t.geo, *py = t.geo + C, *pz = t.geo + 2 * C,
              *ix = t.geo + 3 * C, *iy = t.geo + 4 * C, *iz = t.geo + 5 * C,
              *pp = t.geo + 6 * C, *vn = t.geo + 7 * C;

  const int s = tid / LPS;             // TNT / LPS == TS
  if constexpr (FROZEN) {
    // one-time selection at the bracket midpoint x_mid = o + d_mid r
    const float o0 = t.o[s * 4], o1 = t.o[s * 4 + 1], o2 = t.o[s * 4 + 2];
    const float q0 = t.r[s * 4], q1 = t.r[s * 4 + 1], q2 = t.r[s * 4 + 2];
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
        float mn = INFINITY;
        for (int c = lane; c < C; c += LPS) {
          const float v = cur_at(c);
          if (v > prev) mn = fminf(mn, v);
        }
        prev = gmin(mn);
        thr[it] = prev;
      }
    }
    float pa[KSEL], pb[KSEL], pe[KSEL], pf[KSEL];
#pragma unroll
    for (int it = 0; it < KSEL; ++it) pa[it] = pb[it] = pe[it] = pf[it] = 0.f;
    for (int c = lane; c < C; c += LPS) {
      const float v = cur_at(c);
      int rank = 255;
#pragma unroll
      for (int it = KSEL - 1; it >= 0; --it)
        if (it < k && v <= thr[it]) rank = it;
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
    if constexpr (!FROZEN) {
      ray_interp_at<true>(f, t, dv);
      return ray_density(f, t, m, b);
    }
    if (owner) sdev[tid] = dv;
    __syncthreads();
    {
      // |x_mid + de r - p|^2 = A + 2 de B + de^2 on the k frozen picks
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
              fadd(fmul(f.w1, fadd(sE[s * KSEL + rr],
                                   fmul(de, sF[s * KSEL + rr]))),
                   fmul(d_[u], d2_[u]));
          ds = fadd(ds, fdiv(fmul(W8, term), fadd(f.w1, d_[u])));
          sW8[s * KSEL + rr] = W8;
        }
      }
      ds = gsum(ds);
      __syncwarp();
      float* Wrow = t.W + s * C;
      for (int c = lane; c < C; c += LPS) {
        const int rk = srank[s * C + c];
        Wrow[c] = rk < k ? sW8[s * KSEL + rk] : 0.f;
      }
      if (lane == 0) t.ds[s] = ds;
    }
    __syncthreads();
    return ray_density(f, t, m, b);
  };

  // the re-bracket's evaluations (d_high_w, then d_low_w) and the n_iters
  // secant steps, through one call site of `field` (so that it inlines)
  const int n_pre = a.rebracket ? 2 : 0;
  float fhr = 0.f, dp = br.pred();
  for (int e = 0; e < n_pre + a.n_iters; ++e) {
    const int it = e - n_pre;
    const float fv = field(it == -2 ? dhw : it == -1 ? dlw : dp);
    if (it == -2) {
      fhr = fv;
      continue;
    }
    if (it == -1) {
      if (fhr > 0.f && fv < 0.f) br = Bracket{dlw, fv, dhw, fhr};
    } else {
      br.step(dp, fv);
    }
    dp = br.pred();
  }
  if (owner && r0 + tid < f.T) f.out[(size_t)b * f.T + r0 + tid] = dp;
  tile_drain(m);
}

}  // namespace nm

extern "C" {

size_t nm_secant_refine_smem(const nm::SecantArgs* a) {
  const size_t TS = nm::TS;
  return nm::tile_plan_bytes(nm::tile_plan(&a->f.dens, nullptr, a->f.ldx,
                                           a->f.C, false)) +
         sizeof(float) * (nm::ray_tile_floats(a->f) + 2 * TS +
                          5 * TS * nm::KSEL) +
         TS * a->f.C;
}

int nm_secant_refine(const nm::SecantArgs* a, void* stream) {
  const nm::RayField& f = a->f;
  if (f.R <= 0) return 0;
  const long long nblk = (f.T + nm::TS - 1) / nm::TS;
  if (f.B <= 0 || f.T <= 0 || nblk * f.B > INT_MAX || f.T * f.B != f.R ||
      f.k < 1 ||
      f.k > nm::KSEL || (f.ldx & 3) || !nm::tile_mlp_ok(f.dens, f.ldx))
    return (int)cudaErrorInvalidValue;
  const size_t smem = nm_secant_refine_smem(a);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  auto kernel = a->frozen ? nm::secant_refine_kernel<true>
                          : nm::secant_refine_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)(nblk * f.B));
  kernel<<<grid, nm::TNT, smem, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

const char* nm_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
