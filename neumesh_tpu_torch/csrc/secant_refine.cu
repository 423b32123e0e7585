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
// rate); the inputs are a few floats per ray. The whole iteration chain of
// a ray stays inside one block (bracket state in registers of the ray's
// owner thread, the contexts in shared memory where they fit, else in
// L2), so no intermediate leaves the chip between iterations, and the
// density MLP's hidden layers run on the tensor cores (field_common.cuh,
// tile stage; f32 layers as the six-product bf16 split): a tile takes 64
// rays, one wgmma M tile, every row live but the last tile's ragged ones.
// The block is persistent and warp-specialised as field_fused's
// (secant_ws: every instantiation but the f32 layers without the frozen
// selection): one block an SM walking its tiles; a producer warpgroup
// streams the density MLP's slices for every evaluation of every tile
// through a ring of 2..8 slots released by the consumer warps'
// empty-barrier arrivals, so the next evaluation's (and the next tile's)
// first slices load under the current one's candidate passes and no
// block-wide barrier paces the slices; the epilogue and the head as
// field_fused's. The secant iterations of a ray stay in order, and a
// tile's evaluations run one after the other. What holds it above the
// bound is the exact-f32 work of every evaluation on the CUDA cores: the
// kNN passes, the epilogues, the blend, the embeddings and the head (and
// the frozen selection, once: its thresholds in shared memory, its sums
// four ranks a pass, so that it fits the consumers' registers). The frozen
// option is its own instantiation, so its selection registers do not
// weigh on the rest.
//
// Registers and shared memory: as field_fused's (640 threads, setmaxnreg
// 24 / 112; the f32 instantiations without the frozen selection keep the
// serial block of TNT threads at 128, which measured faster for them). At
// the serving shape (C = 128, W = 256, one context staged;
// ops/kernels.py::tile_smem_plan): bf16 217,728 B with 5 slots, frozen
// 213,632 B / 4; selective-f32 and f32 frozen 213,632 B / 3 and / 4 (24 KB
// slots); serial selective-f32 and f32 152,080 B, 2 slots. The frozen
// picks (5 x 64 x 16 f32 and 64 x C ranks) are carved in the frozen
// instantiations alone.
#include "field_common.cuh"

namespace nm {

// The kernel's own shared memory after the tile stage's for a block
// staging nst contexts: the ray tile, the evaluation depths and bracket
// midpoints, the frozen picks (the frozen option alone), the stage sums of
// the timing instantiation.
__host__ __device__ inline size_t secant_rest(const SecantArgs& a, int nst) {
  const size_t TS_ = TS;
  const size_t frozen = a.frozen ? sizeof(float) * 5 * TS_ * KSEL +
                                       ((TS_ * a.f.C + 7) & ~(size_t)7)
                                 : 0;
  return sizeof(float) * (ray_tile_floats(a.f, nst) + 2 * TS_) + frozen +
         (a.prof ? PROF_SMEM : 0);
}
// Whether an instantiation is warp-specialised: every one but the f32
// layers without the frozen selection, which measured slower on the
// consumers' 112 registers than on 128 without a producer (PERF.md §6)
// and keep one tile a block of TNT threads, every thread waiting for each
// slice and the block's barrier after it.
__host__ __device__ constexpr bool secant_ws(bool frozen, bool f32) {
  return frozen || !f32;
}
__host__ __device__ inline TilePlan secant_plan(const SecantArgs& a,
                                                int nst) {
  return tile_plan(a.f.dens, nullptr, a.f.ldx, a.f.C, false,
                   secant_ws(a.frozen, has_f32(a.f.dens)),
                   secant_rest(a, nst));
}
// Shared memory of a block staging nst contexts.
__host__ __device__ inline size_t secant_smem(const SecantArgs& a, int nst) {
  return tile_plan_bytes(secant_plan(a, nst)) + secant_rest(a, nst);
}
// Contexts a block stages: every one it may span, where they fit (the C
// entry sets RayField::nst).
__host__ __device__ inline int secant_staged(const SecantArgs& a) {
  const int n = block_contexts_max(a.f.B, a.f.T);
  return secant_smem(a, n) <= SMEM_MAX ? n : 0;
}

// The tiles of a block (every consumer thread): blocks blockIdx.x, +
// gridDim.x, ... of the ray blocks (TileRows); a block's tiles, and the
// evaluations of a tile, run in order.
template <bool FROZEN, bool F32, bool L2, bool PROF, bool ONE>
__device__ __forceinline__ void secant_tiles(const SecantArgs& a, TileMem& m,
                                             int nblk, int tiles,
                                             long long c0, long long ns0) {
  const RayField& f = a.f;
  const int tid = threadIdx.x;
  const int C = f.C, k = f.k;
  const int n_pre = a.rebracket ? 2 : 0;
  for (int blk = blockIdx.x; blk < nblk; blk += gridDim.x) {
    // one 1-D order of the ray blocks (TileRows): any number of contexts
    const TileRows rows{f.B, f.T, blk};
    const RayTile t = ray_tile_load<L2>(f, m, rows);
    float* sdev = t.end;                 // TS
    float* sdm = sdev + TS;              // TS
    float* sA = sdm + TS;                // TS * KSEL (frozen picks)
    float* sBq = sA + TS * KSEL;
    float* sE = sBq + TS * KSEL;
    float* sF = sE + TS * KSEL;
    float* sW8 = sF + TS * KSEL;
    unsigned char* srank = reinterpret_cast<unsigned char*>(sW8 + TS * KSEL);
    if constexpr (PROF) {
      if (blk == (int)blockIdx.x) {
        m.prof = FROZEN ? reinterpret_cast<long long*>(
                              srank + ((TS * C + 7) & ~7))
                        : reinterpret_cast<long long*>(sA);
        prof_begin(m);
      }
    }

    const bool owner = tid < TS;
    const BlockRow own = rows.at(owner ? tid : 0);
    Bracket br{0.f, 0.f, 0.f, 0.f};
    float dlw = 0.f, dhw = 0.f;
    if (owner) {
      // a ragged ray keeps the zero bracket (finite throughout)
      if (own.live) {
        const size_t ray = own.flat;
        br = Bracket{a.d_low[ray], a.f_low[ray], a.d_high[ray],
                     a.f_high[ray]};
        if (a.rebracket) {
          dlw = a.d_low_w[ray];
          dhw = a.d_high_w[ray];
        }
      }
      sdm[tid] = a.rebracket ? fmul(0.5f, fadd(dlw, dhw))
                             : fmul(0.5f, fadd(br.dl, br.dh));
    }
    tile_sync();
    stamp(m, ST_CTX);

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
        E = fsub(fadd(fadd(fmul(xm0, ix[c]), fmul(xm1, iy[c])),
                      fmul(xm2, iz[c])),
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
      // the k thresholds by masked-min passes, kept in shared memory (sW8
      // holds the picks' weights only from the first evaluation on)
      float* thr = sW8 + s * KSEL;
      float prev = -INFINITY;
      for (int it = 0; it < k; ++it) {
        float mn = INFINITY;
        for (int c = lane; c < C; c += LPS) {
          const float v = cur_at(c);
          if (v > prev) mn = fminf(mn, v);
        }
        prev = gmin(mn);
        if (lane == 0) thr[it] = prev;
      }
      __syncwarp();
      // each candidate's rank: the first threshold it is within
      for (int c = lane; c < C; c += LPS) {
        const float v = cur_at(c);
        int rank = 255;
        for (int it = k - 1; it >= 0; --it)
          if (v <= thr[it]) rank = it;
        srank[s * C + c] = (unsigned char)rank;
      }
      __syncwarp();
      // the picks' sums, four ranks a pass (each lane in its candidates'
      // order, then over the sample's lanes)
      for (int r0 = 0; r0 < k; r0 += 4) {
        float pa[4] = {0.f, 0.f, 0.f, 0.f}, pb[4] = {0.f, 0.f, 0.f, 0.f},
              pe[4] = {0.f, 0.f, 0.f, 0.f}, pf[4] = {0.f, 0.f, 0.f, 0.f};
        for (int c = lane; c < C; c += LPS) {
          const int rank = srank[s * C + c] - r0;
          if (rank < 0 || rank >= 4) continue;
          float A, Bq, E, F;
          quad(c, A, Bq, E, F);
  #pragma unroll
          for (int j = 0; j < 4; ++j)
            if (j == rank) {
              pa[j] = fadd(pa[j], A);
              pb[j] = fadd(pb[j], Bq);
              pe[j] = fadd(pe[j], E);
              pf[j] = fadd(pf[j], F);
            }
        }
  #pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (r0 + j < k) {
            const float va = gsum(pa[j]), vb = gsum(pb[j]),
                        ve = gsum(pe[j]), vf = gsum(pf[j]);
            if (lane == 0) {
              sA[s * KSEL + r0 + j] = va;
              sBq[s * KSEL + r0 + j] = vb;
              sE[s * KSEL + r0 + j] = ve;
              sF[s * KSEL + r0 + j] = vf;
            }
          }
        }
      }
    }
    tile_sync();
    stamp(m, ST_CAND);

    // density (minus tau) at depth dv of each owner's ray; all threads call
    auto field = [&](float dv) -> float {
      if constexpr (!FROZEN) {
        ray_interp_at<true, L2>(f, t, dv);
        stamp(m, ST_CAND);
        return ray_density<F32>(f, t, m);
      }
      if (owner) sdev[tid] = dv;
      tile_sync();
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
            d2_[u] = fmaxf(
                fadd(fadd(A, fmul(fmul(2.f, de), Bq)), fmul(de, de)),
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
      tile_sync();
      stamp(m, ST_CAND);
      return ray_density<F32>(f, t, m);
    };

    // the re-bracket's evaluations (d_high_w, then d_low_w) and the n_iters
    // secant steps, through one call site of `field` (so that it inlines)
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
      stamp(m, ST_OTHER);
    }
    if (owner && own.live) f.out[own.flat] = dp;
    // the next tile's loads overwrite what this one read last
    tile_sync();
    stamp(m, ST_OTHER);
    if constexpr (ONE) break;          // a serial block takes one tile
  }
  prof_end(m, a.prof, c0, ns0, tiles);
}

// FROZEN: one instantiation per option, so that the frozen selection's
// registers do not weigh on the rest; F32: f32 hidden layers present;
// L2: the contexts read from global memory (none staged); PROF: the timing
// instantiation (stage stamps into a.prof).
// Warp-specialised (secant_ws) a block is persistent as field_fused's: the
// grid walks the ray blocks (tiles), the producer warpgroup streams the
// density MLP's slices for every evaluation of every tile of the block.
// Otherwise a block takes one tile with TNT threads and a ring of two
// slots that every thread waits for.
template <bool FROZEN, bool F32, bool L2, bool PROF = false>
__global__ void __launch_bounds__(secant_ws(FROZEN, F32) ? WS_THREADS : TNT,
                                  1)
    secant_refine_kernel(const __grid_constant__ SecantArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const long long c0 = PROF ? clock64() : 0, ns0 = PROF ? global_ns() : 0;
  const RayField& f = a.f;
  const int nblk = (int)tile_blocks(f.B, f.T);
  const int tiles = nblk > (int)blockIdx.x
                        ? (nblk - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                        : 0;
  TileMem m = tile_carve(smem, secant_plan(a, f.nst), f.dens, nullptr, 1,
                         f.ldx);
  // the block kind as constants, so that each instantiation compiles its
  // own ring protocol alone
  constexpr bool WS = secant_ws(FROZEN, F32);
  m.ws = WS;
  if constexpr (!WS) m.nring = RING;
  m.approx_epi = true;
  if constexpr (WS) {
    const int evals = (a.rebracket ? 2 : 0) + a.n_iters;
    ws_start(m, (uint32_t)tiles * (uint32_t)evals * (uint32_t)m.total);
    // one if / else for the two roles, never reconverging (setmaxnreg)
    if (threadIdx.x >= TNT) {          // the producer warpgroup
      producer_regs();
      if (threadIdx.x == TNT) produce(m, m.stream);
    } else {                           // the consumers
      consumer_regs();
      secant_tiles<FROZEN, F32, L2, PROF, false>(a, m, nblk, tiles, c0, ns0);
    }
  } else {
    tile_start(m);
    secant_tiles<FROZEN, F32, L2, PROF, true>(a, m, nblk, tiles, c0, ns0);
    tile_drain(m);
  }
}

// The instantiation for a call: frozen, f32 layers, contexts in L2, the
// timing instantiation (staged contexts only).
template <bool FROZEN, bool F32>
inline void (*pick_l2(bool l2, bool prof))(SecantArgs) {
  if (prof)
    return l2 ? nullptr : secant_refine_kernel<FROZEN, F32, false, true>;
  return l2 ? secant_refine_kernel<FROZEN, F32, true>
            : secant_refine_kernel<FROZEN, F32, false>;
}
inline void (*pick_secant_kernel(bool frozen, bool f32, bool l2,
                                 bool prof))(SecantArgs) {
  if (frozen)
    return f32 ? pick_l2<true, true>(l2, prof) : pick_l2<true, false>(l2, prof);
  return f32 ? pick_l2<false, true>(l2, prof)
             : pick_l2<false, false>(l2, prof);
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
                                       f.nst == 0, a->prof);
  if (!kernel) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const bool ws = nm::secant_ws(a->frozen, nm::has_f32(f.dens));
  dim3 grid((unsigned)(ws ? nm::persistent_grid(nblk) : nblk));
  const unsigned threads = ws ? nm::WS_THREADS : nm::TNT;
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

const char* nm_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
