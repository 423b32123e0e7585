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
// independent, so a block simply takes 64 rays: of one tile, or, below 64
// rays a context (the render CLI's per-ray surface: T = 1), 64
// consecutive rays of as many contexts (field_common.cuh, TileRows).
//
// What bounds it on the H100: the density MLP of each of the n_iters (+2
// with the re-bracket) sequential evaluations, i.e. operations (the bound
// is the products on the tensor cores, an f32 layer at a sixth of the bf16
// rate); the inputs are a few floats per ray. The design keeps the whole
// iteration chain of a ray inside one block (bracket state in registers of
// the ray's owner thread, the contexts in shared memory where they fit,
// else in L2), so no intermediate leaves the chip between iterations, and
// runs the density MLP's hidden layers on the tensor cores
// (field_common.cuh, tile stage; f32 layers as the six-product bf16
// split): a block takes 64 rays, one wgmma M tile, every row live but the
// last block's ragged ones, and the weight-slice ring runs on from one
// evaluation to the next, so the next evaluation's first slices load under
// the current one's candidate passes. What holds it above the bound now is
// the exact-f32 work of every evaluation on the CUDA cores: the kNN
// passes, the softplus epilogues, the blend, the embeddings and the head
// (and the frozen selection, once). The frozen option is its own
// instantiation, so its selection registers do not weigh on the rest.
#include "field_common.cuh"

namespace nm {

// Shared memory of a block staging nst contexts.
__host__ __device__ inline size_t secant_smem(const SecantArgs& a, int nst) {
  const size_t TS_ = TS;
  return tile_plan_bytes(tile_plan(a.f.dens, nullptr, a.f.ldx, a.f.C,
                                   false)) +
         sizeof(float) * (ray_tile_floats(a.f, nst) + 2 * TS_ +
                          5 * TS_ * KSEL) +
         TS_ * a.f.C;
}
// Contexts a block stages: every one it may span, where they fit (the C
// entry sets RayField::nst).
__host__ __device__ inline int secant_staged(const SecantArgs& a) {
  const int n = block_contexts_max(a.f.B, a.f.T);
  return secant_smem(a, n) <= SMEM_MAX ? n : 0;
}

// FROZEN: one instantiation per option, so that the frozen selection's
// registers do not weigh on the rest; F32: f32 hidden layers present;
// L2: the contexts read from global memory (none staged).
template <bool FROZEN, bool F32, bool L2>
__global__ void __launch_bounds__(TNT, 1)
    secant_refine_kernel(const __grid_constant__ SecantArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const RayField& f = a.f;
  // one 1-D grid over the ray blocks (TileRows): any number of contexts
  const TileRows rows{f.B, f.T, (int)blockIdx.x};
  const int tid = threadIdx.x;
  const int C = f.C, k = f.k;
  TileMem m = tile_carve(smem, tile_plan(f.dens, nullptr, f.ldx, C, false),
                         f.dens, nullptr, 1, f.ldx);
  tile_start(m);
  const RayTile t = ray_tile_load<L2>(f, m, rows);
  float* sdev = t.end;                 // TS
  float* sdm = sdev + TS;              // TS
  float* sA = sdm + TS;                // TS * KSEL (frozen picks)
  float* sBq = sA + TS * KSEL;
  float* sE = sBq + TS * KSEL;
  float* sF = sE + TS * KSEL;
  float* sW8 = sF + TS * KSEL;
  unsigned char* srank = reinterpret_cast<unsigned char*>(sW8 + TS * KSEL);

  const bool owner = tid < TS;
  const BlockRow own = rows.at(owner ? tid : 0);
  Bracket br{0.f, 0.f, 0.f, 0.f};
  float dlw = 0.f, dhw = 0.f;
  if (owner) {
    // a ragged ray keeps the zero bracket (finite throughout)
    if (own.live) {
      const size_t ray = own.flat;
      br = Bracket{a.d_low[ray], a.f_low[ray], a.d_high[ray], a.f_high[ray]};
      if (a.rebracket) {
        dlw = a.d_low_w[ray];
        dhw = a.d_high_w[ray];
      }
    }
    sdm[tid] = a.rebracket ? fmul(0.5f, fadd(dlw, dhw))
                           : fmul(0.5f, fadd(br.dl, br.dh));
  }
  __syncthreads();

  const int lane = tid % LPS;
  const int s = tid / LPS;             // TNT / LPS == TS
  const float* g = t.geo.of<L2>(s);    // this lane's ray's context
  const float *px = g, *py = g + C, *pz = g + 2 * C, *ix = g + 3 * C,
              *iy = g + 4 * C, *iz = g + 5 * C, *pp = g + 6 * C,
              *vn = g + 7 * C;

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
      ray_interp_at<true, L2>(f, t, dv);
      return ray_density<F32>(f, t, m);
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
    return ray_density<F32>(f, t, m);
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
  if (owner && own.live) f.out[own.flat] = dp;
  tile_drain(m);
}

// The instantiation for a call: frozen, f32 layers, contexts in L2.
template <bool FROZEN, bool F32>
inline void (*pick_l2(bool l2))(SecantArgs) {
  return l2 ? secant_refine_kernel<FROZEN, F32, true>
            : secant_refine_kernel<FROZEN, F32, false>;
}
inline void (*pick_secant_kernel(bool frozen, bool f32, bool l2))(SecantArgs) {
  if (frozen)
    return f32 ? pick_l2<true, true>(l2) : pick_l2<true, false>(l2);
  return f32 ? pick_l2<false, true>(l2) : pick_l2<false, false>(l2);
}

}  // namespace nm

extern "C" {

size_t nm_secant_refine_smem(const nm::SecantArgs* a) {
  return nm::secant_smem(*a, nm::secant_staged(*a));
}

int nm_secant_refine(const nm::SecantArgs* a_in, void* stream) {
  if (a_in->f.R <= 0) return 0;
  nm::SecantArgs k = *a_in;
  const nm::SecantArgs* a = &k;
  const nm::RayField& f = k.f;
  if (!nm::rows_ok(f.B, f.T) || (long long)f.T * f.B != f.R || f.k < 1 ||
      f.k > nm::KSEL || (f.ldx & 3) || !nm::tile_mlp_ok(f.dens, f.ldx))
    return (int)cudaErrorInvalidValue;
  k.f.nst = nm::secant_staged(k);
  const long long nblk = nm::tile_blocks(f.B, f.T);
  const size_t smem = nm::secant_smem(k, f.nst);
  if (smem > nm::SMEM_MAX) return (int)cudaErrorInvalidValue;
  auto kernel = nm::pick_secant_kernel(a->frozen, nm::has_f32(f.dens),
                                       f.nst == 0);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)nblk);
  kernel<<<grid, nm::TNT, smem, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

const char* nm_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
