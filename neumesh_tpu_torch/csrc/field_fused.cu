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
// products). Every hidden layer runs on them (field_common.cuh, tile
// stage): a tile takes 64 rows, one wgmma M tile, four consumer warpgroups
// on the four 64-column quarters of every 256-wide layer; an f32 layer as
// the six-product bf16 split of the TPU's precision="highest" dot. At the
// per-ray shapes (S < 64 samples a context: the render CLI's S = 1 shade
// and S = 16 up-sampling) a tile's 64 rows span several contexts.
//
// The block is persistent and warp-specialised: the grid has one
// block an SM (at most one a tile) and each block walks its tiles
// blockIdx.x, + gridDim.x, ...; a producer warpgroup (one thread of it
// issuing) streams every weight slice of every tile through a ring of
// 2..8 slots, each slot handed back by the 16 consumer warps' arrivals on
// its empty mbarrier, so no block-wide barrier paces the slices and the
// ring runs on from one tile into the next (the next tile's first slices
// land under this tile's heads and the next candidate stage). bf16
// slices' products stay in flight while the next slice's are issued. The
// epilogue takes softplus and its derivative from one exponential, with
// the hardware's approximate exp / log / reciprocal where the output is
// rounded to bf16, and the heads read 8 columns a load. What holds it
// above the bound: the exact-f32 CUDA-core stages -- candidate passes (8
// lanes a sample), the feature blend, the embeddings, the epilogues, the
// heads -- which still run one after the other, and after the tile's
// products (the stage split: ops/kernels.py::stage_split, PERF.md). The
// next tile's CUDA-core stages do not run beside this tile's products: the
// four consumer warpgroups hold the register file (below), so no second
// set of warps could.
//
// Registers: a block is launched at 640 threads (96 a thread);
// setmaxnreg then gives the producer warpgroup 24 and each consumer 112
// (setmaxnreg.inc draws only on what the block's own warps gave back: 128
// x 72 >= 512 x 16). ptxas reports the launch's 96 (the [build] lines of
// chip_smoke.py give the spills: the f32 instantiations with the tangent
// spill most, and run within a few percent of a serial block at 128,
// faster in `full`: PERF.md).
//
// Shared memory of a block (C = 128, W = 256, one context staged; a
// warp-specialised ring takes what the rest leaves of the 227 KB, 32 KB a
// slot, 24 KB where every hidden layer is f32):
//   weight ring        2..8 slots                   48-160 KB
//   X, T               64 x 256 bf16 each           32 + 32 KB
//                      (64 x 256 f32 each, 64 + 64 KB, where an f32 layer
//                      reads them)
//   kNN weight rows    64 x C f32 = 32 KB, aliased on X/T (dead until the
//                      first-layer inputs are built)
//   barriers           2 x 8 mbarriers              128 B
//   FB                 64 x F f32                   8-16 KB
//   per-row            64 x 21 f32 + 64 x 32 u16    10 KB
//   geo                8 x C f32 a staged context   4 KB each
// by instantiation (ops/kernels.py::tile_smem_plan): bf16 density 218,752
// B with 5 slots, density_nabla 218,752 B / 4, full 226,944 B / 4;
// selective-f32 (f32 d0 / c0) density 218,752 B / 4, density_nabla
// 218,752 B / 2, full 226,944 B / 2; f32 (24 KB slots) density 210,560 B /
// 5, density_nabla 226,944 B / 3, full 210,560 B / 2. One block an SM. The contexts of a block stay in L2
// where staging them would not fit beside two slots (f32 `full` beyond one
// context, or 64 contexts at S = 1).
#include "field_common.cuh"

namespace nm {

// The kernel's own shared memory after the tile stage's (TileMem::rest) for
// a block staging nst contexts: per-row vectors, FB, the listed picks, the
// row contexts, the staged contexts, the stage sums of the timing
// instantiation.
__host__ __device__ inline size_t field_rest(const FieldArgs& a, int nst) {
  return sizeof(float) * (TS * (4 * 4 + 4) + (size_t)TS * a.F +
                          TS * (KL / 2 + 1) + TS + 8 * (size_t)a.C * nst) +
         (a.prof ? PROF_SMEM : 0);
}
__host__ __device__ inline TilePlan field_plan(const FieldArgs& a, int nst) {
  const bool full = a.mode == FULL;
  return tile_plan(a.dens, full ? &a.col : nullptr, a.ldx, a.C,
                   a.mode == DENSITY_NABLA || full, true, field_rest(a, nst));
}
// Shared memory of a block staging nst contexts.
__host__ __device__ inline size_t field_smem(const FieldArgs& a, int nst) {
  return tile_plan_bytes(field_plan(a, nst)) + field_rest(a, nst);
}
// Contexts a block stages: every one it may span, where they fit beside a
// ring of two slots (the C entry sets FieldArgs::nst).
__host__ __device__ inline int field_staged(const FieldArgs& a) {
  const int n = block_contexts_max(a.B, a.S);
  return field_smem(a, n) <= SMEM_MAX ? n : 0;
}

// The tiles of a block (every consumer thread): blocks blockIdx.x, +
// gridDim.x, ... of the row blocks (TileRows).
template <int KIND, bool F32, bool L2, bool PROF>
__device__ __forceinline__ void field_tiles(const FieldArgs& a, TileMem& m,
                                            int nblk, int tiles,
                                            long long c0, long long ns0) {
  const int C = a.C, tid = threadIdx.x;
  constexpr bool tang = KIND == DENSITY_NABLA;
  const bool full = tang && a.mode == FULL;
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
  if constexpr (PROF)
    m.prof = reinterpret_cast<long long*>(sgeo + 8 * (size_t)C * a.nst);
  prof_begin(m);
  const size_t plane = (size_t)a.B * a.S;

  for (int blk = blockIdx.x; blk < nblk; blk += gridDim.x) {
    // one 1-D order of the row blocks (TileRows): any number of contexts
    const TileRows rows{a.B, a.S, blk};
    const Contexts geo = load_contexts(rows, a.geo, C,
                                       L2 ? nullptr : sgeo, sctx);
    if (tid < TS) {
      const BlockRow r = rows.at(tid); // a ragged row computes on zeros
      for (int i = 0; i < 3; ++i) {
        const size_t o = (size_t)r.flat * 3 + i;
        sxyz[tid * 4 + i] = r.live ? a.xyz[o] : 0.f;
        if (full) sdir[tid * 4 + i] = r.live ? a.dirs[o] : 0.f;
      }
    }
    tile_sync();
    stamp(m, ST_CTX);

    {
      // the kNN weight rows, which the blend reads
      const int s = tid / LPS, lane = tid % LPS;   // TNT / LPS == TS
      const float x0 = sxyz[s * 4], x1 = sxyz[s * 4 + 1],
                  x2 = sxyz[s * 4 + 2];
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
    tile_sync();
    stamp(m, ST_CAND);

    const BlockRow own = rows.at(tid < TS ? tid : 0);
    const bool wr = tid < TS && own.live;
    const size_t o = own.flat;

    blend_tile(a.feat, sctx, a.feat_bf16, a.F, full ? a.F : a.gd, sW, C,
               sidx, scnt, sFB);
    tile_sync();
    stamp(m, ST_BLEND);
    density_tile<F32>(a.dens, m, sds, sFB, a.F, a.md, a.mfg, a.gd, a.lowp,
                      tang, sdens, sdD);
    if (wr) a.out[o] = sdens[tid];
    if (tang && wr)
      for (int i = 0; i < 3; ++i)
        a.out[(1 + i) * plane + o] = fmul(sdD[tid], sdh[tid * 4 + i]);
    stamp(m, ST_OTHER);
    if (full) {
      color_tile<F32>(a.col, m, sds, sdh, sdD, sdir, sFB, a.F, a.gd,
                      a.F - a.gd, a.md, a.mft, a.mv, a.lowp, srgb);
      if (wr)
        for (int i = 0; i < 3; ++i)
          a.out[(4 + i) * plane + o] = srgb[tid * 3 + i];
    }
    // the next tile's staging overwrites what this one's stores read
    tile_sync();
    stamp(m, ST_OTHER);
  }
  prof_end(m, a.prof, c0, ns0, tiles);
}

// One instantiation per register budget: KIND = DENSITY (no tangent),
// DENSITY_NABLA (the tangent; full too); F32: f32 hidden layers present;
// L2: the contexts read from global memory (none staged); PROF: the timing
// instantiation (stage stamps into a.prof).
// A block is persistent: the grid (at most one block an SM) walks the row
// blocks (tiles), threads [0, TNT) are the consumers, the producer
// warpgroup [TNT, WS_THREADS) streams every weight slice of every tile of
// the block through the ring.
template <int KIND, bool F32, bool L2, bool PROF = false>
__global__ void __launch_bounds__(WS_THREADS, 1)
    field_fused_kernel(const __grid_constant__ FieldArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const long long c0 = PROF ? clock64() : 0, ns0 = PROF ? global_ns() : 0;
  const bool full = KIND == DENSITY_NABLA && a.mode == FULL;
  const int nblk = (int)tile_blocks(a.B, a.S);
  const int tiles = nblk > (int)blockIdx.x
                        ? (nblk - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                        : 0;
  TileMem m = tile_carve(smem, field_plan(a, a.nst), a.dens,
                         full ? &a.col : nullptr, 0, a.ldx);
  m.ws = true;          // as a constant: no serial ring protocol compiled
  m.approx_epi = true;
  ws_start(m, (uint32_t)tiles * (uint32_t)m.total);
  // one if / else for the two roles, never reconverging (setmaxnreg)
  if (threadIdx.x >= TNT) {            // the producer warpgroup
    producer_regs();
    if (threadIdx.x == TNT) produce(m, m.stream);
  } else {                             // the consumers
    consumer_regs();
    field_tiles<KIND, F32, L2, PROF>(a, m, nblk, tiles, c0, ns0);
  }
}

// The instantiation for a call: its kind, f32 layers, contexts in L2, the
// timing instantiation (staged contexts only).
template <int KIND, bool F32>
inline void (*pick_l2(bool l2, bool prof))(FieldArgs) {
  if (prof) return l2 ? nullptr : field_fused_kernel<KIND, F32, false, true>;
  return l2 ? field_fused_kernel<KIND, F32, true>
            : field_fused_kernel<KIND, F32, false>;
}
inline void (*pick_field_kernel(int kind, bool f32, bool l2,
                                bool prof))(FieldArgs) {
  if (kind == DENSITY)
    return f32 ? pick_l2<DENSITY, true>(l2, prof)
               : pick_l2<DENSITY, false>(l2, prof);
  return f32 ? pick_l2<DENSITY_NABLA, true>(l2, prof)
             : pick_l2<DENSITY_NABLA, false>(l2, prof);
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
  auto kernel = nm::pick_field_kernel(kind, f32, k.nst == 0, a->prof);
  if (!kernel) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)nm::persistent_grid(nblk);
  kernel<<<grid, nm::WS_THREADS, smem, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

const char* nm_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
