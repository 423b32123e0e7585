// field_fused: the fused NeuMesh field evaluation of the volume path.
//
// Replaces neumesh_tpu/ops/pallas_kernels.py::_field_kernel (wrapper
// field_fused, pl.pallas_call at :916). Per sample, against one tile's
// candidate context: d2 to the C candidates, kNN selection by k masked-min
// passes with the d2*(1 + c*2e-7) tie-break, inverse-distance weights,
// interpolated distance h and its closed-form gradient, the kNN feature
// blend, positional embeddings, the density MLP (softplus, beta 100) with
// the forward tangent dD/dh (nabla = dD/dh * grad h), and the colour MLP
// (ReLU, sigmoid). Modes: distance (k = 1 one-hot fast path available),
// density, density_nabla, full.
//
// What bounds it on the H100: at the serving shapes (W = 256, 3 density +
// 4 colour layers, C = 128, k = 8) a sample costs ~1.2 MFLOP of bf16 MLP
// work in `full` (with the tangent) against ~2 kFLOP of exact-f32
// candidate math and ~28 bytes of sample I/O: operations, and the roofline
// bound is the tensor cores'. The design puts the bf16 MLP layers on them
// (field_common.cuh, tile stage): a block takes 64 samples of one tile,
// one wgmma M tile, four warpgroups on the four 64-column quarters of
// every 256-wide layer, the weights streamed through a two-slice
// shared-memory ring. What holds it above the bound now is the exact-f32
// work left on the CUDA cores: the epilogue's softplus / softplus' (the
// largest part), the candidate passes (8 lanes a sample) and the feature
// blend, then
// the heads, the embeddings and every f32 layer (selective-f32 d0/c0, the
// f32 models: thread-per-column as before, in the 64-sample block).
//
// Shared memory of a 64-sample block (C = 128, F = 64, W = 256):
//   weight ring        2 x 64 x 256 bf16            64 KB  (bf16 layers)
//   X, T               64 x 256 bf16 each           32 + 32 KB
//                      (64 x 256 f32 each, 64 + 64 KB, where an f32 layer
//                      reads them)
//   kNN weight rows    64 x C f32 = 32 KB, aliased on X/T (dead until the
//                      first-layer inputs are built)
//   FB                 64 x F f32                   16 KB
//   geo, per-sample    8 x C f32 + 64 x 20 f32      4 + 5 KB
//   listed kNN picks   64 x 32 u16 + 64 counts      4 KB
// i.e. 157 KB for bf16 `full`, 221 KB with selective-f32 layers and the
// tangent: one block per SM, so 128-sample blocks (two M tiles) do not
// fit, and the 512 threads at 128 registers fill the register file.
#include "field_common.cuh"

namespace nm {

// One instantiation per register budget: KIND = DISTANCE (no MLP),
// DENSITY (no tangent), DENSITY_NABLA (the tangent; full too).
template <int KIND>
__global__ void __launch_bounds__(TNT, 1)
    field_fused_kernel(const __grid_constant__ FieldArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  // one 1-D grid over (context, sample block): any number of contexts
  const int nblk = (a.S + TS - 1) / TS;
  const int b = blockIdx.x / nblk;
  const int s0 = (blockIdx.x % nblk) * TS;
  const int C = a.C, S = a.S, tid = threadIdx.x;
  constexpr bool mlp = KIND != DISTANCE, tang = KIND == DENSITY_NABLA;
  const bool full = tang && a.mode == FULL;
  const TilePlan plan = tile_plan(mlp ? &a.dens : nullptr,
                                  full ? &a.col : nullptr, a.ldx, C, tang);
  TileMem m = tile_carve(smem, plan, mlp ? &a.dens : nullptr,
                         full ? &a.col : nullptr, 0, a.ldx);
  tile_start(m);                       // weights load under the candidates
  float* sgeo = m.rest;                // 8 * C
  float* sxyz = sgeo + 8 * C;          // TS * 4
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
  float* sW = static_cast<float*>(m.X);   // TS * C, aliased on X/T

  for (int i = tid; i < 8 * C; i += TNT) sgeo[i] = a.geo[(size_t)b * 8 * C + i];
  if (tid < TS) {
    const int sg = min(s0 + tid, S - 1);   // ragged edge: repeat the last
    const size_t o = ((size_t)b * S + sg) * 3;
    for (int i = 0; i < 3; ++i) {
      sxyz[tid * 4 + i] = a.xyz[o + i];
      if (full) sdir[tid * 4 + i] = a.dirs[o + i];
    }
  }
  __syncthreads();

  {
    // the kNN weight rows only where a blend reads them
    constexpr int OUT = mlp ? PICK_ROWS : PICK_NONE;
    const int s = tid / LPS, lane = tid % LPS;   // TNT / LPS == TS
    const float x0 = sxyz[s * 4], x1 = sxyz[s * 4 + 1], x2 = sxyz[s * 4 + 2];
    const Picks po{sW + s * C, nullptr, nullptr, nullptr};
    Interp r;
    if (C <= KC * LPS)
      interp_sample<KC, OUT>(sgeo, C, x0, x1, x2, a.w1, a.k, tang, lane, po,
                             r);
    else
      interp_sample<0, OUT>(sgeo, C, x0, x1, x2, a.w1, a.k, tang, lane, po,
                            r);
    if (lane == 0) {
      sds[s] = r.ds;
      sdh[s * 4] = r.dh0;
      sdh[s * 4 + 1] = r.dh1;
      sdh[s * 4 + 2] = r.dh2;
    }
  }
  __syncthreads();

  const size_t plane = (size_t)a.B * S;
  const size_t obase = (size_t)b * S + s0;
  const bool wr = tid < TS && s0 + tid < S;
  if constexpr (!mlp) {
    if (wr) a.out[obase + tid] = sds[tid];
    return;
  }

  blend_tile(a.feat, (size_t)b * C * a.F, a.feat_bf16, a.F,
             full ? a.F : a.gd, sW, C, sidx, scnt, sFB);
  __syncthreads();
  density_tile(a.dens, m, sds, sFB, a.F, a.md, a.mfg, a.gd, a.lowp, tang,
               sdens, sdD);
  if (wr) a.out[obase + tid] = sdens[tid];
  if constexpr (!tang) return;
  if (wr)
    for (int i = 0; i < 3; ++i)
      a.out[(1 + i) * plane + obase + tid] = fmul(sdD[tid], sdh[tid * 4 + i]);
  if (!full) return;
  color_tile(a.col, m, sds, sdh, sdD, sdir, sFB, a.F, a.gd, a.F - a.gd, a.md,
             a.mft, a.mv, a.lowp, srgb);
  if (wr)
    for (int i = 0; i < 3; ++i)
      a.out[(4 + i) * plane + obase + tid] = srgb[tid * 3 + i];
}

}  // namespace nm

extern "C" {

size_t nm_field_fused_smem(const nm::FieldArgs* a) {
  const bool full = a->mode == nm::FULL, mlp = a->mode != nm::DISTANCE;
  const nm::TilePlan p = nm::tile_plan(
      mlp ? &a->dens : nullptr, full ? &a->col : nullptr, a->ldx, a->C,
      a->mode == nm::DENSITY_NABLA || full);
  return nm::tile_plan_bytes(p) +
         sizeof(float) * ((size_t)8 * a->C + nm::TS * (4 * 4 + 4) +
                          (size_t)nm::TS * a->F + nm::TS * (nm::KL / 2 + 1));
}

int nm_field_fused(const nm::FieldArgs* a, void* stream) {
  if (a->B <= 0 || a->S <= 0) return 0;
  const long long nblk = (a->S + nm::TS - 1) / nm::TS;
  if (nblk * a->B > INT_MAX || a->k < 1 || (a->ldx & 3) || a->ldx < 4)
    return (int)cudaErrorInvalidValue;
  if (a->mode != nm::DISTANCE &&
      (!nm::tile_mlp_ok(a->dens, a->ldx) ||
       (a->mode == nm::FULL && !nm::tile_mlp_ok(a->col, a->ldx))))
    return (int)cudaErrorInvalidValue;
  const size_t smem = nm_field_fused_smem(a);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  auto kernel = a->mode == nm::DISTANCE ? nm::field_fused_kernel<nm::DISTANCE>
                : a->mode == nm::DENSITY ? nm::field_fused_kernel<nm::DENSITY>
                : nm::field_fused_kernel<nm::DENSITY_NABLA>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)(nblk * a->B));
  kernel<<<grid, nm::TNT, smem, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

const char* nm_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
