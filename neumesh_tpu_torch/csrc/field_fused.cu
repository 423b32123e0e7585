// field_fused: the fused NeuMesh field evaluation of the volume path.
//
// Replaces neumesh_tpu/ops/pallas_kernels.py::_field_kernel (wrapper
// field_fused, pl.pallas_call at :916). Per sample, against one tile's
// candidate context: d2 to the C candidates, kNN selection by k masked-min
// passes with the d2*(1 + c*2e-7) tie-break, inverse-distance weights,
// interpolated distance h and its closed-form gradient, the kNN feature
// blend, positional embeddings, the density MLP (softplus, beta 100) with
// the forward tangent dD/dh (nabla = dD/dh * grad h), and the colour MLP
// (ReLU, sigmoid). Modes: density, density_nabla, full; the distance
// mode (no features, no MLP) is field_distance.cu.
//
// What bounds it on the H100: at the serving shapes (W = 256, 3 density +
// 4 colour layers, C = 128, k = 8) a sample costs ~1.2 MFLOP of MLP work
// in `full` (with the tangent) against ~2 kFLOP of exact-f32 candidate
// math and ~28 bytes of sample I/O: operations, and the roofline bound is
// the tensor cores' (an f32 layer at a sixth of the bf16 rate: six bf16
// products). The design puts every hidden layer on them (field_common.cuh,
// tile stage): a block takes 64 rows, one wgmma M tile, four warpgroups on
// the four 64-column quarters of every 256-wide layer, the weights
// streamed through a two-slice shared-memory ring; an f32 layer as the
// six-product bf16 split of the TPU's precision="highest" dot. At the
// per-ray shapes (S < 64 samples a context: the render CLI's S = 1 shade
// and S = 16 up-sampling) a block's 64 rows span several contexts, so
// every row of the MLP tile is live but the last block's ragged ones. What
// holds it above the bound: the exact-f32 work left on the CUDA cores --
// the epilogue's softplus / softplus' (the largest part), the candidate
// passes (8 lanes a sample), the feature blend, the heads and the
// embeddings.
//
// Shared memory of a 64-row block (C = 128, F = 64, W = 256):
//   weight ring        2 x 64 x 256 bf16            64 KB
//   X, T               64 x 256 bf16 each           32 + 32 KB
//                      (64 x 256 f32 each, 64 + 64 KB, where an f32 layer
//                      reads them)
//   kNN weight rows    64 x C f32 = 32 KB, aliased on X/T (dead until the
//                      first-layer inputs are built)
//   FB                 64 x F f32                   16 KB
//   per-row            64 x 21 f32 + 64 x 32 u16    10 KB
//   geo                8 x C f32 a staged context   4 KB each
// i.e. 157 KB for bf16 `full`, 225 KB in f32 with the tangent: one block
// per SM, and the 512 threads at 128 registers fill the register file. The
// contexts of a block stay in L2 where staging them would not fit (f32
// `full` beyond one context, or 64 contexts at S = 1).
#include "field_common.cuh"

namespace nm {

// Shared memory of a block staging nst contexts.
__host__ __device__ inline size_t field_smem(const FieldArgs& a, int nst) {
  const bool full = a.mode == FULL;
  const TilePlan p = tile_plan(a.dens, full ? &a.col : nullptr, a.ldx, a.C,
                               a.mode == DENSITY_NABLA || full);
  return tile_plan_bytes(p) +
         sizeof(float) * (TS * (4 * 4 + 4) + (size_t)TS * a.F +
                          TS * (KL / 2 + 1) + TS + 8 * (size_t)a.C * nst);
}
// Contexts a block stages: every one it may span, where they fit (the C
// entry sets FieldArgs::nst).
__host__ __device__ inline int field_staged(const FieldArgs& a) {
  const int n = block_contexts_max(a.B, a.S);
  return field_smem(a, n) <= SMEM_MAX ? n : 0;
}

// One instantiation per register budget: KIND = DENSITY (no tangent),
// DENSITY_NABLA (the tangent; full too); F32: f32 hidden layers present;
// L2: the contexts read from global memory (none staged).
template <int KIND, bool F32, bool L2>
__global__ void __launch_bounds__(TNT, 1)
    field_fused_kernel(const __grid_constant__ FieldArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  // one 1-D grid over the row blocks (TileRows): any number of contexts
  const TileRows rows{a.B, a.S, (int)blockIdx.x};
  const int C = a.C, tid = threadIdx.x;
  constexpr bool tang = KIND == DENSITY_NABLA;
  const bool full = tang && a.mode == FULL;
  const TilePlan plan = tile_plan(a.dens, full ? &a.col : nullptr, a.ldx, C,
                                  tang);
  TileMem m = tile_carve(smem, plan, a.dens, full ? &a.col : nullptr, 0,
                         a.ldx);
  tile_start(m);                       // weights load under the candidates
  float* sxyz = m.rest;                // TS * 4
  float* sdir = sxyz + TS * 4;         // TS * 4
  float* sdh = sdir + TS * 4;          // TS * 4
  float* srgb = sdh + TS * 4;          // TS * 4
  float* sds = srgb + TS * 4;          // TS
  float* sdens = sds + TS;             // TS
  float* sdD = sdens + TS;             // TS
  float* spad = sdD + TS;              // TS (keeps 16-byte alignment)
  float* sFB = spad + TS;              // TS * F
  unsigned short* sidx =               // TS * KL listed kNN picks
      reinterpret_cast<unsigned short*>(sFB + TS * a.F);
  int* scnt = reinterpret_cast<int*>(sFB + TS * a.F + TS * KL / 2);
  int* sctx = scnt + TS;               // TS: each row's context
  float* sgeo = reinterpret_cast<float*>(sctx + TS);   // 8 * C * nst
  float* sW = static_cast<float*>(m.X);   // TS * C, aliased on X/T

  const Contexts geo = load_contexts(rows, a.geo, C,
                                     L2 ? nullptr : sgeo, sctx);
  if (tid < TS) {
    const BlockRow r = rows.at(tid);   // a ragged row computes on zeros
    for (int i = 0; i < 3; ++i) {
      const size_t o = (size_t)r.flat * 3 + i;
      sxyz[tid * 4 + i] = r.live ? a.xyz[o] : 0.f;
      if (full) sdir[tid * 4 + i] = r.live ? a.dirs[o] : 0.f;
    }
  }
  __syncthreads();

  {
    // the kNN weight rows, which the blend reads
    const int s = tid / LPS, lane = tid % LPS;   // TNT / LPS == TS
    const float x0 = sxyz[s * 4], x1 = sxyz[s * 4 + 1], x2 = sxyz[s * 4 + 2];
    const Picks po{sW + s * C, nullptr, nullptr, nullptr};
    Interp r;
    interp_any<PICK_ROWS>(geo.of<L2>(s), C, x0, x1, x2, a.w1, a.k, tang,
                          lane, po, r);
    if (lane == 0) {
      sds[s] = r.ds;
      sdh[s * 4] = r.dh0;
      sdh[s * 4 + 1] = r.dh1;
      sdh[s * 4 + 2] = r.dh2;
    }
  }
  __syncthreads();

  const size_t plane = (size_t)a.B * a.S;
  const BlockRow own = rows.at(tid < TS ? tid : 0);
  const bool wr = tid < TS && own.live;
  const size_t o = own.flat;

  blend_tile(a.feat, sctx, a.feat_bf16, a.F, full ? a.F : a.gd, sW, C, sidx,
             scnt, sFB);
  __syncthreads();
  density_tile<F32>(a.dens, m, sds, sFB, a.F, a.md, a.mfg, a.gd, a.lowp, tang,
                    sdens, sdD);
  if (wr) a.out[o] = sdens[tid];
  if constexpr (!tang) return;
  if (wr)
    for (int i = 0; i < 3; ++i)
      a.out[(1 + i) * plane + o] = fmul(sdD[tid], sdh[tid * 4 + i]);
  if (!full) return;
  color_tile<F32>(a.col, m, sds, sdh, sdD, sdir, sFB, a.F, a.gd, a.F - a.gd,
                  a.md, a.mft, a.mv, a.lowp, srgb);
  if (wr)
    for (int i = 0; i < 3; ++i)
      a.out[(4 + i) * plane + o] = srgb[tid * 3 + i];
}

// The instantiation for a call: its kind, f32 layers, contexts in L2.
template <int KIND, bool F32>
inline void (*pick_l2(bool l2))(FieldArgs) {
  return l2 ? field_fused_kernel<KIND, F32, true>
            : field_fused_kernel<KIND, F32, false>;
}
inline void (*pick_field_kernel(int kind, bool f32, bool l2))(FieldArgs) {
  if (kind == DENSITY)
    return f32 ? pick_l2<DENSITY, true>(l2) : pick_l2<DENSITY, false>(l2);
  return f32 ? pick_l2<DENSITY_NABLA, true>(l2)
             : pick_l2<DENSITY_NABLA, false>(l2);
}

}  // namespace nm

extern "C" {

size_t nm_field_fused_smem(const nm::FieldArgs* a) {
  return nm::field_smem(*a, nm::field_staged(*a));
}

int nm_field_fused(const nm::FieldArgs* a_in, void* stream) {
  if (a_in->B <= 0 || a_in->S <= 0) return 0;
  nm::FieldArgs k = *a_in;
  const nm::FieldArgs* a = &k;
  k.nst = nm::field_staged(k);
  const long long nblk = nm::tile_blocks(a->B, a->S);
  if (!nm::rows_ok(a->B, a->S) || a->k < 1 || a->mode < nm::DENSITY ||
      a->mode > nm::FULL || !nm::tile_mlp_ok(a->dens, a->ldx) ||
      (a->mode == nm::FULL && !nm::tile_mlp_ok(a->col, a->ldx)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = nm::field_smem(k, k.nst);
  if (smem > nm::SMEM_MAX) return (int)cudaErrorInvalidValue;
  const bool f32 = nm::has_f32(a->dens) ||
                   (a->mode == nm::FULL && nm::has_f32(a->col));
  const int kind = a->mode == nm::FULL ? nm::DENSITY_NABLA : a->mode;
  auto kernel = nm::pick_field_kernel(kind, f32, k.nst == 0);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)nblk);
  kernel<<<grid, nm::TNT, smem, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

const char* nm_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
