// Device code shared by field_fused.cu, field_distance.cu,
// secant_refine.cu, surface_locate.cu and candidate_field.cu
// (field_distance.cu takes only the candidate chain's pieces): the NeuMesh
// field chain of neumesh_tpu/ops/pallas_kernels.py (_interp_distance,
// _feat_dot, _emb_cols, _emb_cols_rec, _density_mlp, the colour MLP of
// _field_kernel, the density evaluations of _secant_kernel and
// _locate_kernel) against one tile's candidate context.
//
// Candidate stage (every kernel but field_distance.cu, which runs a thread
// a sample; interp_sample): LPS = 8 lanes per sample
// (consecutive lanes of one warp, reduced with width-8 shuffles), lane l
// taking candidates l, l + 8, ... Exact f32 on the CUDA cores. With
// C <= 128 a lane keeps the tie-broken d2 of its 16 candidates in
// registers over the k masked-min passes; the selected candidates become a
// bit mask per lane, and the weight and interpolation passes (IEEE square
// roots and divisions) loop over the set bits only, so a warp runs their
// body as often as its busiest lane has picks instead of once per
// candidate slot. The kNN weights leave the stage as rows of C (the tile
// kernels, whose blend lists the nonzero ones), as a list of picks in
// ascending candidate order (the candidate kernels), or not at all (the
// scans by distance of secant_refine and surface_locate, candidate_field
// without features).
//
// One MLP stage, on the tensor cores (field_fused, secant_refine,
// surface_locate; "tile" below): 64 rows (samples or rays) a block, one
// wgmma M tile, four warpgroups (512 threads, so the candidate passes take
// all 64 rows at once). Rows: with R >= 64 rows a context a block takes 64
// rows of one context; with fewer (the per-ray shapes: one context a ray,
// S = 1 or 16 samples) the flattened (context, row) order is cut into
// blocks of 64 rows, each row with its own context (TileRows), so no
// block runs a 64-row MLP for one live row. A block's contexts are staged
// in shared memory where they fit beside the rest, else each row's lanes
// read its context from global memory (L2).
// Every hidden layer runs on wgmma.m64n64k16 (f32 accumulators that start
// at the bias; each warpgroup a 64 x 64 quarter of the 256-wide output;
// the tangent of density_nabla/full a second accumulator off the same
// staged slice). Its weights, packed by the wrapper as K-major 8 x 8 core
// matrices, stream through a ring of 64-row K slices (cp.async.bulk
// completing on a full mbarrier; the ring runs on across layers,
// evaluations and tiles and starts loading under the candidate stage).
// field_fused and secant_refine are warp-specialised (WS_THREADS; but
// secant_refine's f32 instantiations without the frozen selection): a
// producer warpgroup issues the copies into 2..RING_MAX slots, each slot
// released by the consumer warps' arrivals on its empty mbarrier, and the
// blocks are persistent (persistent_grid); surface_locate and those f32
// secant instantiations keep two slots that every thread waits for,
// thread 0 re-arming a slot after a block-wide barrier. A bf16 layer reads its activations as a bf16 tile
// in the core-matrix layout from shared memory. An f32 layer (every layer
// of the f32 models, selective-f32 d0/c0) is the TPU's precision="highest"
// product: the weight comes as three bf16 planes (hi, mid, lo; hi + mid +
// lo == w exactly), streamed as three slices per K slice, and each
// warpgroup splits its register fragment of the f32 activation rows the
// same way at the A operand, six products hi.hi, mid.hi, lo.hi, hi.mid,
// mid.mid, hi.lo (the terms of order 2^-24 and below dropped). Epilogue
// in registers: softplus (beta 100) and softplus' from one exponential, or
// ReLU, the tangent times softplus', rounding to the next layer's dtype
// (the warp-specialised kernels take the hardware's approximate exp / log
// / reciprocal where that dtype is bf16). The feature blend sums over each
// row's listed kNN picks. On the CUDA cores, exact f32: the candidate
// stage, the heads (N = 1, 3), the embeddings, the blend and the f32
// epilogues; one block holds an SM (128 registers a thread in a serial
// block, 112 a consumer thread in a warp-specialised one; up to ~227 KB
// of shared memory).
//
// Numerics follow the TPU kernels, not the XLA path:
//  - candidate math in exact f32 element-wise arithmetic (__fmul_rn and
//    friends, never contracted into FMAs): xv, xx, d2 = max(xx+pp-2xv, 0);
//  - the tie-break d2*(1 + c*2e-7), lowest index first; the k-th smallest
//    by k masked-min passes ("remove everything <= the pass minimum");
//  - per-layer precision follows the weight dtype: a bf16 layer rounds its
//    inputs to bf16, products are exact in f32, accumulation f32 (in
//    wgmma's own order on the tensor cores), bias f32; an f32 layer takes
//    the six-product bf16 split above (f32 to ~2^-23 relative a product);
//  - scalar embeddings (d, view dirs) take cos(z) as sin(z + pi/2) with
//    freq = 2^(blk/2); in bf16 serving the feature embeddings use the
//    double-angle recursion in bf16 from f32 base sin/cos.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace nm {

constexpr int SB = 32;           // samples per candidate-kernel block
constexpr int NT = 256;          // threads per candidate-kernel block
constexpr int LPS = NT / SB;     // lanes per sample in candidate passes
constexpr int TS = 64;           // samples (rays) per tile-stage block
constexpr int TNT = 512;         // threads per tile-stage block: four
                                 // warpgroups, TS samples at LPS lanes
constexpr int KS = 64;           // K rows per staged weight slice (bf16)
constexpr int KSF = 16;          // K rows per staged slice of an f32 layer
                                 // (its three planes: 24 KB of a 32 KB slot)
constexpr int NPAD = 256;        // packed layers' output width
constexpr int RING = 2;          // staged weight slices in flight
                                 // (surface_locate's ring)
// A warp-specialised tile block (field_fused, secant_refine): the four
// consumer warpgroups, then a producer warpgroup, one thread of which
// issues the weight copies.
constexpr int WS_THREADS = TNT + 128;
// Registers a thread of each role after setmaxnreg. The block is launched
// at 96 a thread (65,536 / 640 in steps of 8); setmaxnreg.inc takes only
// what the block's own warps gave back with setmaxnreg.dec, so the
// producer warpgroup's 128 x (96 - 24) pay for the consumers' 512 x (112 -
// 96). (A lone producer warp would not do: registers are allocated four
// warps at a time, so 17 warps cost what 20 do.)
constexpr int LAUNCH_REGS = 96, PRODUCER_REGS = 24, CONSUMER_REGS = 112;
static_assert((WS_THREADS - TNT) * (LAUNCH_REGS - PRODUCER_REGS) >=
                  TNT * (CONSUMER_REGS - LAUNCH_REGS),
              "the consumers' registers come from the producer's");
static_assert(WS_THREADS * LAUNCH_REGS <= 65536, "the launch's registers");
constexpr int RING_MAX = 8;      // its ring: as deep as the shared memory
                                 // left beside the rest allows, 2..8 slots
constexpr size_t SLOT_BYTES = (size_t)KS * NPAD * 2;  // a ring slot, 32 KB
constexpr size_t SLOT_F32_BYTES = (size_t)3 * KSF * NPAD * 2;  // 24 KB: a
                                 // ring slot where every hidden layer is
                                 // f32 (three planes of KSF rows)
constexpr int KL = 32;           // kNN picks listed per sample for the
                                 // feature blend
constexpr int MAX_LAYERS = 8;    // ops/_build.py MAX_LAYERS
constexpr int KSEL = 16;         // frozen secant: at most 16 neighbours
constexpr int KC = 16;           // candidates a lane keeps in registers
                                 // (C <= KC * LPS)
constexpr size_t SMEM_MAX = 227 * 1024;  // dynamic shared memory a block
static_assert(TNT / LPS == TS, "a tile block's candidate pass takes TS");
constexpr float HALF_PI = 1.57079637f;   // float32(pi / 2)

enum Mode { DISTANCE = 0, DENSITY = 1, DENSITY_NABLA = 2, FULL = 3 };

// Stages of a tile block, timed by the kernels' timing instantiation
// (template argument PROF; launched with FieldArgs / SecantArgs::prof set,
// by ops/kernels.py::stage_split alone). Each warpgroup's first thread
// reads clock64 at every stage boundary and adds the cycles since its
// previous reading to the stage that just ended; the record of (block,
// warpgroup) holds the NSTAGE sums, the cycles from the block's start to
// its end, the block's %globaltimer ns over the same span and the tiles it
// took (STAGE_REC longs, mirrored by ops/_build.py STAGES).
enum Stage {
  ST_CTX = 0,   // the contexts, the samples' points and directions staged
  ST_CAND,      // the candidate stage (kNN selection, weights, distance)
  ST_BLEND,     // the feature blend
  ST_EMB,       // an MLP's first-layer inputs (embeddings)
  ST_COPY,      // waits for a weight slice to land
  ST_MMA,       // wgmma issue to completion (the f32 split included)
  ST_SYNC,      // the block-wide barrier after each slice
  ST_EPI,       // the epilogues (activation, tangent, stores, the barrier)
  ST_HEAD,      // the heads (N = 1, 3)
  ST_OTHER,     // output stores, the secant's bracket steps
  NSTAGE
};
constexpr int STAGE_REC = NSTAGE + 3;

// ---- argument blocks (mirrored by ctypes structures in ops/_build.py)
struct LayerDesc {
  const void* w;      // (K, N) row-major, float32 or bfloat16 (the heads
                      // read it)
  const float* b;     // (N,)
  int K, N, bf16;
  int split;          // first layer: its second row block starts at row
                      // split; 0 for later layers
  // wp: a hidden layer packed for wgmma (kp rows, each row block
  // zero-padded to a multiple of 16, the second starting at row kp1, where
  // the tangent's input is zero; N zero-padded to NPAD), K-major 8 x 8
  // core matrices, slice by slice: KS rows of one bf16 plane for a bf16
  // layer, KSF rows of the three planes (hi, mid, lo) one after the other
  // for an f32 layer; null for the heads. kp: the input width a hidden
  // layer reads (a bf16 tile of that width, or that many columns of the
  // f32 rows of stride ldx); a bf16 head's tile width (NPAD); 0 for an f32
  // head.
  const void* wp;
  int kp1, kp;
};
struct MLPDesc {
  LayerDesc l[MAX_LAYERS];
  int n, pad;
};
struct FieldArgs {
  const float *xyz, *dirs, *geo;
  const void* feat;
  float* out;
  int feat_bf16, B, S, C, F, k, mode, md, mfg, mft, mv, gd, lowp, ldx;
  int nst;            // contexts a block stages (0: read from global); set
                      // by the C entry
  float w1;
  MLPDesc dens, col;
  long long* prof;    // the timing instantiation's stage record (StageRec
                      // a warpgroup of a block), else null
};
// The density field along R rays grouped into B tiles of T: what
// secant_refine and surface_locate share.
struct RayField {
  const float *rays_o, *rays_d, *geo;
  const void* feat;
  float* out;
  int feat_bf16, R, B, T, C, F, k, md, mfg, gd, lowp, ldx;
  int nst;            // contexts a block stages (0: read from global); set
                      // by the C entry
  float w1, tau;
  MLPDesc dens;
};
struct SecantArgs {
  RayField f;         // out: d_pred (R,)
  const float *d_low, *d_high, *f_low, *f_high, *d_low_w, *d_high_w;
  int n_iters, rebracket, frozen;
  long long* prof;    // as FieldArgs::prof
};
// candidate_field_v3 reads geo (B, 8, C); candidate_field (v2) reads the
// per-ray pts/ind (B, C, 3) and pp/vn (B, C). v3 writes ds | [ds dh] packed
// into out_d (B, S, 1 | 4); v2 writes ds (B, S) to out_d and dh (B, S, 3)
// to out_dh. feats (B, S, F) go to out_feat.
struct CandArgs {
  const float *xyz, *geo, *pts, *pp, *ind, *vn, *feat;
  float *out_d, *out_dh, *out_feat;
  int B, S, C, F, k, want_dh, want_feat;
  float w1;
};
struct LocateArgs {
  RayField f;         // out: (4, R) d_pred, mask, mask_sign_change, val0_pos
  const float *near, *far;
  int n_steps, n_secant;
};

// ---- exact f32 element-wise arithmetic (no FMA contraction)
__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fdiv(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float rbf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float rnd(float x, int bf) { return bf ? rbf(x) : x; }

__device__ __forceinline__ float gsum(float v) {     // over a sample's lanes
#pragma unroll
  for (int o = LPS / 2; o > 0; o >>= 1)
    v = fadd(v, __shfl_xor_sync(0xffffffffu, v, o, LPS));
  return v;
}
__device__ __forceinline__ float gmin(float v) {
#pragma unroll
  for (int o = LPS / 2; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o, LPS));
  return v;
}

__device__ __forceinline__ float ldw(const LayerDesc& L, int idx) {
  if (L.bf16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(L.w)[idx]);
  return __ldg(static_cast<const float*>(L.w) + idx);
}
__device__ __forceinline__ float ldfeat(const void* feat, int bf, size_t idx) {
  if (bf) return __bfloat162float(static_cast<const __nv_bfloat16*>(feat)[idx]);
  return __ldg(static_cast<const float*>(feat) + idx);
}

__device__ __forceinline__ float sigmoid(float x) {
  return fdiv(1.f, fadd(1.f, expf(-x)));
}
// softplus with beta 100 (identity above 100 x = 20, as torch's threshold)
// and its derivative from one exponential e = exp(-|100 x|): h = (max(100
// x, 0) + log1p(e)) / 100 (jax.nn.softplus's arithmetic, divided: the
// plain version's bits), g = 1 / (1 + e) for 100 x >= 0, e / (1 + e)
// below (to a few ulp of sigmoid's 1 / (1 + exp(-100 x)), and 0 where that
// exponential overflows, as sigmoid gives).
// ops/kernels.py::softplus100_pair mirrors it.
__device__ __forceinline__ void softplus100_pair(float x, float& h,
                                                 float& g) {
  const float bx = fmul(100.f, x);
  if (bx > 20.f) {
    h = x;
    g = 1.f;
    return;
  }
  const float e = expf(-fabsf(bx));
  h = fdiv(fadd(fmaxf(bx, 0.f), log1pf(e)), 100.f);
  const float r = fdiv(1.f, fadd(1.f, e));
  g = bx >= 0.f ? r : (e < 2.9387359e-39f ? 0.f : fdiv(e, fadd(1.f, e)));
}
// The same with the hardware's approximate exp2 / log2 / reciprocal, for
// outputs rounded to bf16 (8 significant bits) next: relative error below
// 2^-16 before the rounding. log1p(e) is e (1 - e (1/2 - e/3)) below e =
// 2^-7, where log2(1 + e) would lose e's low bits.
__device__ __forceinline__ void softplus100_fast(float x, float& h,
                                                 float& g) {
  const float bx = 100.f * x;
  if (bx > 20.f) {
    h = x;
    g = 1.f;
    return;
  }
  const float e = __expf(-fabsf(bx));
  const float l = e < 0.0078125f ? e * (1.f - e * (0.5f - e * (1.f / 3.f)))
                                 : __logf(1.f + e);
  h = (fmaxf(bx, 0.f) + l) * 0.01f;
  const float r = __fdividef(1.f, 1.f + e);
  g = bx >= 0.f ? r : e * r;
}

// Column `blk` (block index) of the tiled-sin embedding of one scalar:
// sin(x * 2^(blk/2) + (blk odd ? pi/2 : 0)); *dcol = its x-derivative.
__device__ __forceinline__ float emb_col(float x, int blk, float* dcol) {
  const float freq = (float)(1 << (blk >> 1));
  const float z = fadd(fmul(x, freq), (blk & 1) ? HALF_PI : 0.f);
  if (dcol) *dcol = fmul(freq, sinf(fadd(z, HALF_PI)));
  return sinf(z);
}

// ---------------------------------------------------------------------------
// interpolated distance of one sample (all LPS lanes of the sample call)
// ---------------------------------------------------------------------------
struct Interp {
  float ds, dh0, dh1, dh2;
  float thr, sw;      // the kNN threshold and the sum of the raw weights
                      // (not set by the k = 1 proxy)
};

// Where a sample's normalised kNN weights go.
enum PickOut {
  PICK_NONE = 0,      // nowhere: the caller wants the distance alone
  PICK_ROWS = 1,      // row[c] of every candidate (zeros off the kNN set)
  PICK_LIST = 2       // the picks alone, in ascending candidate order: the
                      // first KL as (idx, w), their number in *cnt
};
struct Picks {
  float* row;
  unsigned short* idx;
  float* w;
  int* cnt;
};

// Candidate c = lane + i * LPS of a sample's lanes, for each of this
// lane's: NC > 0 unrolls NC of them (C <= NC * LPS), so that per-candidate
// values can live in registers indexed by i; NC = 0 strides over C.
template <int NC, class Fn>
__device__ __forceinline__ void for_cands(int C, int lane, Fn fn) {
  if constexpr (NC > 0) {
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + i * LPS;
      if (c < C) fn(i, c);
    }
  } else {
    for (int c = lane, i = 0; c < C; c += LPS, ++i) fn(i, c);
  }
}

// The candidate chain's pieces, shared with the blend that recomputes a
// weight (candidate_field.cu): geo is (8, C) rows [px py pz ix iy iz pp vn].
__device__ __forceinline__ float sq_norm(float x0, float x1, float x2) {
  return fadd(fadd(fmul(x0, x0), fmul(x1, x1)), fmul(x2, x2));
}
// d2 of the sample (x0, x1, x2), xx = |x|^2, to the candidate at (px, py,
// pz) with pp = |p|^2
__device__ __forceinline__ float point_d2(float px, float py, float pz,
                                          float pp, float x0, float x1,
                                          float x2, float xx) {
  const float xv = fadd(fadd(fmul(x0, px), fmul(x1, py)), fmul(x2, pz));
  return fmaxf(fsub(fadd(xx, pp), fmul(2.f, xv)), 0.f);
}
__device__ __forceinline__ float cand_d2(const float* geo, int C, int c,
                                         float x0, float x1, float x2,
                                         float xx) {
  return point_d2(geo[c], geo[C + c], geo[2 * C + c], geo[6 * C + c], x0,
                  x1, x2, xx);
}
// candidate c's tie-break factor 1 + c 2e-7
__device__ __forceinline__ float tie_factor(int c) {
  return fadd(1.f, fmul((float)c, 2e-7f));
}
__device__ __forceinline__ float tie_broken(int c, float d2) {
  return fmul(d2, tie_factor(c));
}
__device__ __forceinline__ float raw_weight(float d2) {
  return fdiv(1.f, fadd(sqrtf(d2), 1e-7f));
}

// geo: (8, C) rows [px py pz ix iy iz pp vn] in shared memory. The
// normalised kNN weights go where OUT says (the one-hot argmin for the
// k = 1 distance proxy, rows only).
// k1_proxy: k = 1 without dh takes the nearest-tangent-plane proxy of the
// field kernels (the candidate_field kernels have no such path). v2_dh: the
// gradient in candidate_field (v2)'s order, A = (W w1) inv and
// dh = sum(A n) + sB x - sum(B v), instead of sum(A n - B v) + sB x.
// NC > 0 (C <= NC * LPS): each lane keeps the tie-broken d2 of its
// candidates in registers over the selection passes instead of recomputing
// it in every pass (the same values, so the same result).
// After the selection each lane holds its picks as bit masks, 32 of its
// candidates (one chunk of 32 * LPS) at a time, and the weight and
// interpolation passes visit the set bits in ascending order: the sums
// take each lane's picks in the order a loop over all its candidates
// would, without running the IEEE divisions and square roots of a pick on
// the slots that hold none.
template <int NC = 0, int OUT = PICK_ROWS>
__device__ void interp_sample(const float* geo, int C, float x0, float x1,
                              float x2, float w1, int k, bool want_dh,
                              int lane, const Picks& po, Interp& out,
                              bool k1_proxy = true, bool v2_dh = false) {
  const float *px = geo, *py = geo + C, *pz = geo + 2 * C, *ix = geo + 3 * C,
              *iy = geo + 4 * C, *iz = geo + 5 * C, *vn = geo + 7 * C;
  const float xx = sq_norm(x0, x1, x2);
  auto d2_at = [&](int c) { return cand_d2(geo, C, c, x0, x1, x2, xx); };
  auto xn_at = [&](int c) {
    return fadd(fadd(fmul(x0, ix[c]), fmul(x1, iy[c])), fmul(x2, iz[c]));
  };
  float tbc[NC > 0 ? NC : 1];
  if constexpr (NC > 0)
    for_cands<NC>(C, lane,
                  [&](int i, int c) { tbc[i] = tie_broken(c, d2_at(c)); });
  // the tie-broken d2 of this lane's i-th candidate c
  auto TB = [&](int i, int c) {
    if constexpr (NC > 0) return tbc[i]; else return tie_broken(c, d2_at(c));
  };
  // least tie-broken d2 above thr over the sample's candidates
  auto min_above = [&](float thr) {
    float m = INFINITY;
    for_cands<NC>(C, lane, [&](int i, int c) {
      const float t = TB(i, c);
      if (t > thr) m = fminf(m, t);
    });
    return gmin(m);
  };
  out.dh0 = out.dh1 = out.dh2 = 0.f;

  if (k1_proxy && k == 1 && !want_dh) {
    // nearest-tangent-plane proxy: sums over the one-hot argmin set
    const float m = min_above(-INFINITY);
    float d2s = 0.f, nvs = 0.f;
    for_cands<NC>(C, lane, [&](int i, int c) {
      const bool sel = TB(i, c) <= m;
      if (sel) {
        d2s = fadd(d2s, d2_at(c));
        nvs = fadd(nvs, fsub(xn_at(c), vn[c]));
      }
      if constexpr (OUT == PICK_ROWS) po.row[c] = sel ? 1.f : 0.f;
    });
    d2s = gsum(d2s);
    nvs = gsum(nvs);
    const float dsel = sqrtf(fmaxf(d2s, 1e-20f));
    out.ds = fdiv(fadd(fmul(w1, nvs), fmul(dsel, d2s)), fadd(w1, dsel));
    return;
  }

  // k-th smallest tie-broken distance: pass i takes the minimum of what
  // passes 0..i-1 left (everything <= their minimum is removed)
  float thr = -INFINITY;
  for (int it = 0; it < k; ++it) thr = min_above(thr);

  // this lane's picks among its candidates c0 + lane + i LPS, i < 32
  constexpr int CHUNK = 32 * LPS;
  auto chunk_picks = [&](int c0) {
    unsigned mk = 0;
    if constexpr (NC > 0) {
      for_cands<NC>(C, lane, [&](int i, int c) {
        if (tbc[i] <= thr) mk |= 1u << i;
      });
    } else {
      for (int i = 0, c = c0 + lane; i < 32 && c < C; ++i, c += LPS)
        if (tie_broken(c, d2_at(c)) <= thr) mk |= 1u << i;
    }
    return mk;
  };
  const unsigned mk0 = chunk_picks(0);   // the only chunk up to C = 256

  float sw = 0.f;
  for (int c0 = 0; c0 < C; c0 += CHUNK)
    for (unsigned mk = c0 ? chunk_picks(c0) : mk0; mk; mk &= mk - 1)
      sw = fadd(sw, raw_weight(d2_at(c0 + lane + (__ffs(mk) - 1) * LPS)));
  sw = gsum(sw);
  out.thr = thr;
  out.sw = sw;

  if constexpr (OUT == PICK_ROWS)
    for_cands<NC>(C, lane, [&](int, int c) { po.row[c] = 0.f; });
  float ds = 0.f, sB = 0.f, ax = 0.f, ay = 0.f, az = 0.f;
  float bx = 0.f, by = 0.f, bz = 0.f;     // v2_dh: sum(B v) apart
  int listed = 0;     // PICK_LIST: picks of the chunks before (the same on
                      // the sample's lanes)
  for (int c0 = 0; c0 < C; c0 += CHUNK) {
    unsigned mk = c0 ? chunk_picks(c0) : mk0;
    unsigned all[LPS];                    // PICK_LIST: every lane's picks
    if constexpr (OUT == PICK_LIST) {
#pragma unroll
      for (int j = 0; j < LPS; ++j)
        all[j] = __shfl_sync(0xffffffffu, mk, j, LPS);
    }
    for (; mk; mk &= mk - 1) {
      const int i = __ffs(mk) - 1, c = c0 + lane + i * LPS;
      const float d2 = d2_at(c);
      const float d0 = sqrtf(d2);
      const float W = fdiv(fdiv(1.f, fadd(d0, 1e-7f)), sw);
      const float d = fmaxf(d0, 1e-10f);
      const float inv = fdiv(1.f, fadd(w1, d));
      const float term = fadd(fmul(w1, fsub(xn_at(c), vn[c])), fmul(d, d2));
      ds = fadd(ds, fmul(fmul(W, term), inv));
      if (want_dh) {
        const float A = v2_dh ? fmul(fmul(W, w1), inv) : fmul(W, fmul(w1, inv));
        const float Bc = fdiv(
            fmul(fmul(fmul(W, fsub(fmul(fmul(3.f, d2), fadd(w1, d)), term)),
                      inv),
                 inv),
            d);
        sB = fadd(sB, Bc);
        if (v2_dh) {
          ax = fadd(ax, fmul(A, ix[c]));
          ay = fadd(ay, fmul(A, iy[c]));
          az = fadd(az, fmul(A, iz[c]));
          bx = fadd(bx, fmul(Bc, px[c]));
          by = fadd(by, fmul(Bc, py[c]));
          bz = fadd(bz, fmul(Bc, pz[c]));
        } else {
          ax = fadd(ax, fsub(fmul(A, ix[c]), fmul(Bc, px[c])));
          ay = fadd(ay, fsub(fmul(A, iy[c]), fmul(Bc, py[c])));
          az = fadd(az, fsub(fmul(A, iz[c]), fmul(Bc, pz[c])));
        }
      }
      if constexpr (OUT == PICK_ROWS) po.row[c] = W;
      if constexpr (OUT == PICK_LIST) {
        // candidates below c: slots below i on every lane, slot i on the
        // lanes below this one
        int pos = listed;
        const unsigned low = (1u << i) - 1u;
#pragma unroll
        for (int j = 0; j < LPS; ++j)
          pos += __popc(all[j] & low) + (j < lane ? (all[j] >> i) & 1u : 0u);
        if (pos < KL) {
          po.idx[pos] = (unsigned short)c;
          po.w[pos] = W;
        }
      }
    }
    if constexpr (OUT == PICK_LIST) {
#pragma unroll
      for (int j = 0; j < LPS; ++j) listed += __popc(all[j]);
    }
  }
  if constexpr (OUT == PICK_LIST)
    if (lane == 0) *po.cnt = listed;
  out.ds = gsum(ds);
  if (want_dh) {
    sB = gsum(sB);
    out.dh0 = fadd(gsum(ax), fmul(sB, x0));
    out.dh1 = fadd(gsum(ay), fmul(sB, x1));
    out.dh2 = fadd(gsum(az), fmul(sB, x2));
    if (v2_dh) {
      out.dh0 = fsub(out.dh0, gsum(bx));
      out.dh1 = fsub(out.dh1, gsum(by));
      out.dh2 = fsub(out.dh2, gsum(bz));
    }
  }
}

// interp_sample with the candidates in registers where they fit (C <= KC
// LPS), else strided.
template <int OUT>
__device__ __forceinline__ void interp_any(const float* geo, int C, float x0,
                                           float x1, float x2, float w1,
                                           int k, bool want_dh, int lane,
                                           const Picks& po, Interp& out) {
  if (C <= KC * LPS)
    interp_sample<KC, OUT>(geo, C, x0, x1, x2, w1, k, want_dh, lane, po, out);
  else
    interp_sample<0, OUT>(geo, C, x0, x1, x2, w1, k, want_dh, lane, po, out);
}
// ---------------------------------------------------------------------------
// block-level stages (every thread of the block calls them)
// ---------------------------------------------------------------------------

// Feature embedding columns of D-wide inputs src[s][0..D) into column
// x0 + j, j < 2*nf*D, of sample s, order [sin f0 (D), cos f0 (D), sin f1,
// ...]: bf16 double-angle recursion (lowp) or the exact tiled sin; put(s,
// column, value rounded for the layer) stores.
template <class Put>
__device__ void feature_emb_to(const float* src, int ld_src, int D, int nf,
                               int lowp, int x0, int r0, Put put) {
  if (nf <= 0) return;
  if (lowp) {
    for (int idx = threadIdx.x; idx < TS * D; idx += TNT) {
      const int s = idx / D, i = idx % D;
      const float x = rbf(src[s * ld_src + i]);
      float sn = rbf(sinf(x)), cs = rbf(cosf(x));
      for (int p = 0; p < nf; ++p) {
        if (p > 0) {
          const float s2 = rbf(fmul(rbf(fmul(2.f, sn)), cs));
          const float c2 = rbf(fsub(rbf(fmul(cs, cs)), rbf(fmul(sn, sn))));
          sn = s2;
          cs = c2;
        }
        put(s, x0 + (2 * p) * D + i, rnd(sn, r0));
        put(s, x0 + (2 * p + 1) * D + i, rnd(cs, r0));
      }
    }
  } else {
    const int n = 2 * nf * D;
    for (int idx = threadIdx.x; idx < TS * n; idx += TNT) {
      const int s = idx / n, j = idx % n;
      put(s, x0 + j,
          rnd(emb_col(src[s * ld_src + j % D], j / D, nullptr), r0));
    }
  }
}

enum Act { ACT_SOFTPLUS = 0, ACT_RELU = 1 };

// ---------------------------------------------------------------------------
// tensor-core tile stage (field_fused, secant_refine, surface_locate):
// TS = 64 rows a block, four warpgroups; see the note at the top of this
// file
// ---------------------------------------------------------------------------

// The rows of a tile-stage call: R rows (samples or rays) in each of B
// contexts, row r of context b at flat index b R + r. R >= TS: a block
// takes TS consecutive rows of one context (ceil(R / TS) blocks a
// context, the last ragged). R < TS: the flat order cut into blocks of TS
// rows (ceil(B R / TS) blocks, the last ragged), each row in its own
// context, up to 1 + ceil((TS - 1) / R) contexts a block. A rule of shape:
// the R >= TS shapes keep one context a block. A ragged row takes the
// context of the block's first row, row 0. 32-bit arithmetic: the C
// entries take B R <= INT_MAX - TS (rows_ok).
struct BlockRow {
  int ctx, row;
  bool live;          // a row of the call (the ragged rows are not)
  int flat;
};
__host__ __device__ inline bool rows_ok(int B, int R) {
  return B > 0 && R > 0 && (long long)B * R <= INT_MAX - TS;
}
__host__ __device__ inline long long tile_blocks(int B, int R) {
  return R >= TS ? (long long)B * ((R + TS - 1) / TS)
                 : ((long long)B * R + TS - 1) / TS;
}
__host__ __device__ inline int block_contexts_max(int B, int R) {
  const int n = R >= TS ? 1 : 1 + (TS - 1 + R - 1) / R;
  return n < B ? n : B;
}
// The persistent grid of a warp-specialised tile kernel over nblk tiles:
// one block an SM of the current device, at most one a tile.
inline int persistent_grid(long long nblk) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)(nblk < sms ? nblk : sms > 0 ? sms : 1);
}
struct TileRows {
  int R, n;           // rows a context, rows of the call (B R)
  int first, count;   // the contexts of the block's live rows
  int g0;             // R < TS: the flat index of the block's row 0; R >=
                      // TS: its row in context `first`
  // block blk's rows: the divisions once a block
  __device__ TileRows(int B, int R_, int blk) : R(R_), n(B * R_) {
    if (R >= TS) {
      const int nblk = (R + TS - 1) / TS;
      first = blk / nblk;
      g0 = (blk - first * nblk) * TS;
      count = 1;
    } else {
      g0 = blk * TS;
      first = g0 / R;
      count = (min(g0 + TS, n) - 1) / R - first + 1;
    }
  }
  // row t of the block
  __device__ BlockRow at(int t) const {
    BlockRow r;
    if (R >= TS) {
      r.ctx = first;
      r.row = g0 + t;
      r.live = r.row < R;
    } else {
      const int g = g0 + t;
      r.live = g < n;
      r.ctx = r.live ? g / R : first;
      r.row = g - r.ctx * R;
    }
    if (!r.live) r.row = 0;
    r.flat = r.ctx * R + r.row;
    return r;
  }
};

// A block's candidate contexts (8, C) each: staged in shared memory
// (n > 0 of them from context `first`) or read from global memory. Where
// they are is a template argument of the kernels (L2), so that each
// instantiation reads them through a pointer of one known state space and
// carries one copy of the candidate stage.
struct Contexts {
  const float* global;   // (B, 8, C)
  const float* staged;   // n * 8 * C, or null
  const int* ctx;        // each row's context (TS, shared memory)
  int C, first;
  bool one;              // one context a block (R >= TS)
  template <bool L2>
  __device__ const float* of(int t) const {
    const int c = one ? first : ctx[t];
    if constexpr (L2) return global + (size_t)c * 8 * C;
    else return staged + (c - first) * 8 * C;
  }
};

// Each row's context into ctx[] (threads t < TS) and, with a staging
// buffer, the block's contexts into it (every thread calls; the caller
// synchronises).
__device__ Contexts load_contexts(const TileRows& rows, const float* geo,
                                  int C, float* staged, int* ctx) {
  const int tid = threadIdx.x;
  if (tid < TS) ctx[tid] = rows.at(tid).ctx;
  const int first = rows.first;
  if (staged) {
    const float* src = geo + (size_t)first * 8 * C;
    const int n = rows.count * 8 * C;
    for (int i = tid; i < n; i += TNT) staged[i] = src[i];
  }
  return Contexts{geo, staged, ctx, C, first, rows.R >= TS};
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Element offset of (row s, column k) in a bf16 tile of width kp: 8 x 8
// core matrices of 128 contiguous bytes (row-major inside), the core
// matrices of an 8-row group consecutive along K.
__device__ __forceinline__ int tile_off(int s, int k, int kp) {
  return ((((s >> 3) * (kp >> 3)) + (k >> 3)) << 6) + ((s & 7) << 3) +
         (k & 7);
}

// Element offset of (row s, column k) in f32 rows of stride ldx (a
// multiple of 32): the 8-column groups of a row XOR-swizzled by s & 3, so
// that the 8 rows of a wgmma register fragment, and of the epilogue's
// stores, fall in distinct banks four rows at a time.
__device__ __forceinline__ int row_off(int s, int k, int ldx) {
  return s * ldx + (k ^ ((s & 3) << 3));
}

// An activation buffer in the layout of the layer that reads it: a bf16
// tile of width kp (kp > 0; storing rounds to bf16) or f32 rows of stride
// ldx (kp = 0).
struct ActBuf {
  void* p;
  int kp, ldx;
  __device__ float* f() const { return static_cast<float*>(p); }
  __device__ __nv_bfloat16* h() const {
    return static_cast<__nv_bfloat16*>(p);
  }
  __device__ void put(int s, int k, float v) const {
    if (kp)
      h()[tile_off(s, k, kp)] = __float2bfloat16_rn(v);
    else
      f()[row_off(s, k, ldx)] = v;
  }
  __device__ float get(int s, int k) const {
    return kp ? __bfloat162float(h()[tile_off(s, k, kp)])
              : f()[row_off(s, k, ldx)];
  }
  __device__ ActBuf for_layer(const LayerDesc& L) const {
    return ActBuf{p, L.bf16 ? L.kp : 0, ldx};
  }
};

// ---- wgmma, mbarrier and bulk-copy primitives
__device__ __forceinline__ uint64_t mat_desc(const void* p, uint32_t lbo,
                                             uint32_t sbo) {
  // no swizzle (layout type 0): start, leading (K) and stride (M/N) byte
  // offsets, each >> 4
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}
// keep reads of the accumulators after the wait
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_frag(uint32_t (&a)[3][4]) {
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[p][i])::"memory");
}
// generic-proxy stores to shared memory visible to wgmma's reads
__device__ __forceinline__ void fence_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (64 x 64 f32, this warpgroup's quarter of the output) += A (64 x 16)
// B (16 x 64); A and B K-major bf16 in shared memory.
__device__ __forceinline__ void wgmma64(float (&d)[32], uint64_t da,
                                        uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// The same product with A (64 x 16 bf16) from registers: this thread's
// fragment a[0..3], rows warp * 16 + lane / 4 (+ 8), columns 2 (lane % 4)
// (+ 1, + 8, + 9), as mma.m16n8k16's A; d = A B (+ d where accumulate).
__device__ __forceinline__ void wgmma64_rs(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// Two f32 values as three bf16 pairs hi, mid, lo (x == hi + mid + lo
// exactly: each rounding leaves at most 16, then 8 significant bits).
__device__ __forceinline__ uint32_t bf2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ void split3(float2 x, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x.x, x.y);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = fsub(x.x, hf.x), r1 = fsub(x.y, hf.y);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  hi = bf2_bits(h);
  mid = bf2_bits(m);
  lo = bf2_bits(__floats2bfloat162_rn(fsub(r0, mf.x), fsub(r1, mf.y)));
}

// This thread's register fragment of the 64 x 16 slice at column kg of
// f32 rows X (every warpgroup reads all 64 rows), split: a[p] is plane p.
__device__ __forceinline__ void split_fragment(const ActBuf& X, int kg,
                                               uint32_t (&a)[3][4]) {
  const int lane = threadIdx.x & 31;
  const int r0 = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  const int c0 = kg + (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + (i & 1) * 8, col = c0 + (i >> 1) * 8;
    const float2 x =
        *reinterpret_cast<const float2*>(X.f() + row_off(row, col, X.ldx));
    split3(x, a[0][i], a[1][i], a[2][i]);
  }
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// The tile stage's block-wide barrier: the TNT consumer threads (named
// barrier 1; the whole block where a block has no producer warp).
__device__ __forceinline__ void tile_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(TNT) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}
// bytes from global src to shared dst, completing on bar (one thread)
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---- the feature blend of the tile stage, FB[s][f] = sum_c W[s][c]
// feat[c][f] for f < Fb (FB row stride F, the feature row length; with bf16
// features the weights are rounded to bf16 first): summed over each
// sample's listed kNN picks instead of its whole weight row

// List the nonzero weights of each sample's row (its kNN picks) in
// ascending candidate order: up to KL in idx[s * KL ...], their number in
// cnt[s] (more than KL: the blend scans the row).
__device__ void list_picks(const float* sW, int C, unsigned short* idx,
                           int* cnt) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int s = warp; s < TS; s += TNT / 32) {
    const float* wr = sW + s * C;
    int n = 0;
    for (int c0 = 0; c0 < C; c0 += 32) {
      const int c = c0 + lane;
      const bool nz = c < C && wr[c] != 0.f;
      const unsigned m = __ballot_sync(0xffffffffu, nz);
      const int pos = n + __popc(m & ((1u << lane) - 1u));
      if (nz && pos < KL) idx[s * KL + pos] = (unsigned short)c;
      n += __popc(m);
    }
    if (lane == 0) cnt[s] = n;
  }
}

// The blend of the TS rows, each against the features (C, F) of its own
// context ctx[s] (a row scan's products in a row scan's order: the listed
// picks ascend); every thread calls, synchronises inside.
__device__ void blend_tile(const void* feat, const int* ctx, int fbf, int F,
                           int Fb, const float* sW, int C,
                           unsigned short* idx, int* cnt, float* sFB) {
  list_picks(sW, C, idx, cnt);
  tile_sync();
  for (int i = threadIdx.x; i < TS * Fb; i += TNT) {
    const int s = i / Fb, f = i % Fb;
    const float* wr = sW + s * C;
    const int n = cnt[s];
    const size_t feat_off = (size_t)ctx[s] * C * F;   // this row's context
    float acc = 0.f;
    for (int j = 0; j < (n <= KL ? n : C); ++j) {
      const int c = n <= KL ? idx[s * KL + j] : j;
      const float w = wr[c];
      if (w != 0.f)
        acc = fmaf(fbf ? rbf(w) : w,
                   ldfeat(feat, fbf, feat_off + (size_t)c * F + f), acc);
    }
    sFB[s * F + f] = acc;
  }
}

// ---- the block's tile-stage memory and its weight-slice stream
// A packed layer's slices: KS rows of a bf16 layer, or KSF rows of an
// f32 layer's three planes (hi, mid, lo).
__host__ __device__ inline int slice_rows(const LayerDesc& L) {
  return L.bf16 ? KS : KSF;
}
__host__ __device__ inline int n_slices(const LayerDesc& L) {
  return L.wp ? (L.kp + slice_rows(L) - 1) / slice_rows(L) : 0;
}
__host__ __device__ inline int mlp_slices(const MLPDesc& D) {
  int n = 0;
  for (int l = 0; l < D.n; ++l) n += n_slices(D.l[l]);
  return n;
}
// One activation buffer: the largest input any layer of D reads.
__host__ __device__ inline size_t act_bytes(const MLPDesc& D, int ldx) {
  size_t b = 0;
  for (int l = 0; l < D.n; ++l) {
    const size_t v = D.l[l].bf16 ? (size_t)TS * D.l[l].kp * 2
                                 : (size_t)TS * ldx * 4;
    b = v > b ? v : b;
  }
  return (b + 127) & ~(size_t)127;
}

// Shared memory of a tile block, from its start: the weight ring, the
// activation region (X, then T with the tangent; the kNN weight rows of
// the TS samples alias it before the MLPs), the mbarriers, then the
// kernel's own buffers (`rest`). A warp-specialised block (ws) has a full
// and an empty barrier for each of RING_MAX slots and a ring of as many
// slots, 2..RING_MAX, as fit in SMEM_MAX beside the activations, the
// barriers and `rest` bytes of the kernel's, of 24 KB where every hidden
// layer is f32 (a slice's three planes), else 32 KB; otherwise RING slots
// of 32 KB and two barriers.
struct TilePlan {
  size_t ring, xb, act, bars, slot;
  int nring;
  bool ws;
};
// Whether an MLP has a bf16 hidden layer.
__host__ __device__ inline bool has_bf16_hidden(const MLPDesc& D) {
  for (int l = 0; l < D.n - 1; ++l)
    if (D.l[l].bf16) return true;
  return false;
}
__host__ __device__ inline TilePlan tile_plan(const MLPDesc& d,
                                              const MLPDesc* c, int ldx,
                                              int C, bool tang,
                                              bool ws = false,
                                              size_t rest = 0) {
  const bool f32_slots =
      ws && !has_bf16_hidden(d) && !(c && has_bf16_hidden(*c));
  TilePlan p{0, act_bytes(d, ldx), 0,
             ws ? (size_t)2 * RING_MAX * sizeof(uint64_t) : 16,
             f32_slots ? SLOT_F32_BYTES : SLOT_BYTES, RING, ws};
  const size_t tb = tang ? p.xb : 0;
  if (c) {
    const size_t cb = act_bytes(*c, ldx);
    p.xb = cb > p.xb ? cb : p.xb;
  }
  const size_t wrows = ((size_t)TS * C * 4 + 127) & ~(size_t)127;
  p.act = p.xb + tb > wrows ? p.xb + tb : wrows;
  if (ws) {
    const size_t used = p.act + p.bars + rest;
    const size_t room = used < SMEM_MAX ? (SMEM_MAX - used) / p.slot : 0;
    p.nring = room < 2 ? 2 : room > (size_t)RING_MAX ? RING_MAX : (int)room;
  }
  p.ring = (size_t)p.nring * p.slot;
  return p;
}
__host__ __device__ inline size_t tile_plan_bytes(const TilePlan& p) {
  return p.ring + p.act + p.bars;
}

// Whether any hidden layer of D is f32 (the kernels' F32 instantiation).
__host__ __device__ inline bool has_f32(const MLPDesc& D) {
  for (int l = 0; l < D.n - 1; ++l)
    if (!D.l[l].bf16) return true;
  return false;
}

// Every hidden layer must come packed for wgmma with its input width, a
// bf16 head with its tile width; f32 rows have a stride ldx >= NPAD, a
// multiple of 32 (the swizzle), that holds every f32 layer's input.
inline bool tile_mlp_ok(const MLPDesc& D, int ldx) {
  if (D.n < 2 || D.n > MAX_LAYERS || ldx < NPAD || ldx % 32) return false;
  for (int l = 0; l < D.n; ++l) {
    const LayerDesc& L = D.l[l];
    const bool hidden = l < D.n - 1;
    if ((L.wp != nullptr) != hidden || L.kp % 16) return false;
    if (hidden && (L.kp <= 0 || L.kp1 % 16 || L.kp1 > L.kp || L.N > NPAD ||
                   (!L.bf16 && L.kp > ldx)))
      return false;
    if (!hidden && ((L.bf16 ? L.kp < L.K : L.kp != 0) || L.N > 3))
      return false;
  }
  return true;
}

// The stream of weight slices a block consumes, in order: every slice of
// the packed layers of mlp[0], then of mlp[1]; `cyclic` repeats it (the
// secant's density evaluations; a warp-specialised block's tiles). seq
// counts the slices consumed, the same on every consumer thread; slice seq
// lives in ring slot seq % nring.
struct TileMem {
  __nv_bfloat16* ring;
  void *X, *T;
  uint64_t* bar;      // full: slot i's slice landed (the bulk copy's bytes)
  uint64_t* empty;    // ws: slot i released by the TNT / 32 consumer warps
  float* rest;
  const MLPDesc* mlp[2];
  int total, cyclic, ldx, nring;
  int slot;           // a ring slot's bf16 elements
  bool ws;
  bool approx_epi;    // field_fused / secant_refine: the approximate
                      // epilogue where the output is rounded to bf16
                      // (surface_locate: the exact one everywhere)
  uint32_t seq;
  uint32_t stream;    // ws: the slices the block consumes, in all
  long long* prof;    // the timing instantiation: each warpgroup's running
                      // stage sums and last reading (shared memory), else
                      // null
};

// The stage that ends here (see Stage): a no-op unless m.prof.
__device__ __forceinline__ void stamp(const TileMem& m, int st) {
  if (m.prof && (threadIdx.x & 127) == 0) {
    long long* p = m.prof + (threadIdx.x >> 7) * (NSTAGE + 1);
    const long long now = clock64();
    p[st] += now - p[NSTAGE];
    p[NSTAGE] = now;
  }
}
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
// Shared memory of the running stage sums (4 warpgroups).
constexpr size_t PROF_SMEM = 4 * (NSTAGE + 1) * sizeof(long long);
// Start the sums (each warpgroup's first thread; before the first stamp).
__device__ __forceinline__ void prof_begin(const TileMem& m) {
  if (m.prof && (threadIdx.x & 127) == 0) {
    long long* p = m.prof + (threadIdx.x >> 7) * (NSTAGE + 1);
    for (int i = 0; i < NSTAGE; ++i) p[i] = 0;
    p[NSTAGE] = clock64();
  }
}
// Write the block's record: rec[(block * 4 + warpgroup) * STAGE_REC ...].
__device__ __forceinline__ void prof_end(const TileMem& m, long long* rec,
                                         long long c0, long long ns0,
                                         int tiles) {
  if (m.prof && (threadIdx.x & 127) == 0) {
    const long long* p = m.prof + (threadIdx.x >> 7) * (NSTAGE + 1);
    long long* r = rec + ((size_t)blockIdx.x * 4 + (threadIdx.x >> 7)) *
                             STAGE_REC;
    for (int i = 0; i < NSTAGE; ++i) r[i] = p[i];
    r[NSTAGE] = clock64() - c0;
    r[NSTAGE + 1] = global_ns() - ns0;
    r[NSTAGE + 2] = tiles;
  }
}

__device__ TileMem tile_carve(unsigned char* smem, const TilePlan& p,
                              const MLPDesc& m0, const MLPDesc* m1,
                              int cyclic, int ldx) {
  TileMem m;
  m.ring = reinterpret_cast<__nv_bfloat16*>(smem);
  m.X = smem + p.ring;
  m.T = smem + p.ring + p.xb;
  m.bar = reinterpret_cast<uint64_t*>(smem + p.ring + p.act);
  m.empty = m.bar + RING_MAX;
  m.rest = reinterpret_cast<float*>(smem + tile_plan_bytes(p));
  m.mlp[0] = &m0;
  m.mlp[1] = m1;
  m.total = mlp_slices(m0) + (m1 ? mlp_slices(*m1) : 0);
  m.cyclic = cyclic || p.ws;
  m.ldx = ldx;
  m.nring = p.nring;
  m.slot = (int)(p.slot / 2);
  m.ws = p.ws;
  m.approx_epi = false;
  m.seq = 0;
  m.stream = 0;
  m.prof = nullptr;
  return m;
}

// Start loading the slice at stream position q into its ring slot (one
// thread: block thread 0, or the producer warp's first lane).
__device__ void start_slice(const TileMem& m, uint32_t q) {
  if (!m.total || (!m.cyclic && q >= (uint32_t)m.total)) return;
  int p = (int)(q % (uint32_t)m.total);
  const uint32_t slot = q % (uint32_t)m.nring;
  for (int i = 0; i < 2; ++i) {
    if (!m.mlp[i]) continue;
    const MLPDesc& D = *m.mlp[i];
    for (int l = 0; l < D.n; ++l) {
      const LayerDesc& L = D.l[l];
      const int n = n_slices(L);
      if (p < n) {
        // slice p: ks rows of each of the layer's P planes, consecutive
        const int P = L.bf16 ? 1 : 3, k0 = p * slice_rows(L),
                  ks = min(slice_rows(L), L.kp - k0);
        bulk_load(m.ring + slot * m.slot,
                  static_cast<const __nv_bfloat16*>(L.wp) +
                      (size_t)P * k0 * NPAD,
                  (uint32_t)(P * ks) * NPAD * 2, m.bar + slot);
        return;
      }
      p -= n;
    }
  }
}

// Barriers and the first RING slices in flight (every thread calls; the
// caller synchronises before the first layer): a block without a producer
// warp.
__device__ void tile_start(const TileMem& m) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < RING; ++i) mbar_init(m.bar + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (uint32_t q = 0; q < RING; ++q) start_slice(m, q);
  }
}

// Thread 0 waits for the slices started but never consumed (a cyclic
// stream's next evaluation), so that no bulk copy into the block's shared
// memory outlives the block (a block without a producer warp).
__device__ void tile_drain(const TileMem& m) {
  if (threadIdx.x != 0 || !m.total) return;
  for (uint32_t q = m.seq; q < m.seq + RING; ++q)
    if (m.cyclic || q < (uint32_t)m.total)
      mbar_wait(m.bar + q % RING, (q / RING) & 1);
}

// A warp-specialised block's barriers: slot i full once its slice has
// landed, empty once every consumer warp is done with it; `stream`: the
// slices the block consumes. Every thread of the block calls; the block
// synchronises (all WS_THREADS) before the roles split.
__device__ void ws_start(TileMem& m, uint32_t stream) {
  m.stream = stream;
  if (threadIdx.x == 0) {
    for (int i = 0; i < m.nring; ++i) {
      mbar_init(m.bar + i);
      mbar_init(m.empty + i, TNT / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The producer warp's first lane: the n slices the consumers will take, in
// order, slice q into slot q % nring once the consumers have released the
// slice that slot held (its empty barrier's phase q / nring - 1). Nothing
// else paces the ring: no block-wide barrier, no consumer thread re-arms a
// slot.
__device__ void produce(const TileMem& m, uint32_t n) {
  const uint32_t nr = (uint32_t)m.nring;
  for (uint32_t q = 0; q < n; ++q) {
    if (q >= nr) mbar_wait(m.empty + q % nr, (q / nr - 1) & 1);
    start_slice(m, q);
  }
}

// The roles' register budgets (every thread of the warpgroup executes it).
__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
}
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
}

// A consumer warp is done with the slice in slot `slot` (lane 0 arrives).
__device__ __forceinline__ void release_slot(const TileMem& m, uint32_t slot) {
  if ((threadIdx.x & 31) == 0) mbar_arrive(m.empty + slot);
}

// One packed hidden layer on wgmma, in place: reads X (and T) in the
// layer's layout, writes the outputs into Xn (Tn) in the next layer's.
// Warpgroup g computes output columns [64 g, 64 g + 64). A bf16 layer
// takes A from its bf16 tile in shared memory, one KS-row slice's
// products committed together. An f32 layer's slice holds KSF = 16 rows
// of the weight's three planes hi, mid, lo: every warpgroup splits its
// register fragment of those 16 columns of the f32 rows into a[0..2] and
// takes the six products a[i] . plane j, i + j <= 2, then waits before
// its next split overwrites the fragment. Without the tangent (the
// registers of the tangent free) a slice's six products start a second
// accumulator, which is added to the layer's in f32 (round to nearest)
// after the slice: the tensor cores truncate each sum toward zero at the
// larger operand's precision, and over a 256-row layer that bias would
// build up in one accumulator. F32: the MLP has f32 hidden layers (without,
// the f32 path is not compiled, and the bf16 kernels keep their registers).
// A warp-specialised block (m.ws) hands each slot back to its producer warp
// through the slot's empty barrier, each consumer warp as soon as its
// products that read the slot are done: a bf16 slice's products stay in
// flight while the next slice's are issued (wait_group 1), an f32 slice's
// are waited for before the next split; the consumers meet once a layer,
// before the epilogue. Without (surface_locate) every slice ends in a
// block-wide barrier after which thread 0 re-arms the slot.
// The epilogue: softplus (beta 100) and its derivative from one
// exponential, with the approximate hardware functions where the output is
// rounded to bf16 next (m.approx_epi: field_fused and secant_refine), or
// ReLU.
template <bool TANG, bool F32>
__device__ void wgmma_layer(const LayerDesc& L, TileMem& m, ActBuf X,
                            ActBuf T, int act, ActBuf Xn, ActBuf Tn) {
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3,
            lane = tid & 31;
  float acc[32], tac[32];
  const uint32_t sbo_a = (uint32_t)L.kp * 16;   // 8-row group stride
  const int nsl = n_slices(L), rows = slice_rows(L);
  const uint32_t nr = (uint32_t)m.nring;
  const bool piped = m.ws && (!F32 || L.bf16);  // bf16 slices overlap
  // the accumulators start at the bias (f32) and the tangent's at 0, so
  // nothing but wgmma touches them until the epilogue
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    const int col = wg * 64 + (r >> 2) * 8 + (lane & 3) * 2 + (r & 1);
    acc[r] = col < L.N ? L.b[col] : 0.f;
    tac[r] = 0.f;
  }
  for (int i = 0; i < nsl; ++i) {
    const uint32_t buf = m.seq % nr;
    mbar_wait(m.bar + buf, (m.seq / nr) & 1);
    stamp(m, ST_COPY);
    const int k0 = i * rows, ks = min(rows, L.kp - k0);
    // this warpgroup's 64 output columns of a plane: 8 groups of 8, each
    // ks / 8 core matrices of 64 elements
    const __nv_bfloat16* wb = m.ring + buf * m.slot + wg * 64 * ks;
    if (!F32 || L.bf16) {
      wg_fence();
      for (int kk = 0; kk < ks; kk += 16) {
        const int kg = k0 + kk;
        const uint64_t db = mat_desc(wb + kk * 8, 128, (uint32_t)ks * 16);
        wgmma64(acc, mat_desc(X.h() + kg * 8, 128, sbo_a), db);
        // the tangent's input is zero from kp1 on
        if constexpr (TANG) {
          if (kg < L.kp1)
            wgmma64(tac, mat_desc(T.h() + kg * 8, 128, sbo_a), db);
        }
      }
      wg_commit();
      if (!piped) {
        wg_wait0();
      } else if (i > 0) {
        wg_wait1();                  // the previous slice's products done
        release_slot(m, (m.seq - 1) % nr);
      }
    } else if constexpr (F32) {
      // planes hi, mid, lo of the KSF = 16 rows, KSF * NPAD apart
      const uint64_t b0 = mat_desc(wb, 128, KSF * 16),
                     b1 = mat_desc(wb + KSF * NPAD, 128, KSF * 16),
                     b2 = mat_desc(wb + 2 * KSF * NPAD, 128, KSF * 16);
      uint32_t a[3][4], t[3][4];
      // both fragments split on every path (registers that wgmma reads
      // written only outside branches: no serialising fence in one)
      split_fragment(X, k0, a);
      if constexpr (TANG) split_fragment(T, k0, t);
      wg_fence();
      if constexpr (TANG) {
        wgmma64_rs(acc, a[0], b0);
        wgmma64_rs(acc, a[1], b0);
        wgmma64_rs(acc, a[2], b0);
        wgmma64_rs(acc, a[0], b1);
        wgmma64_rs(acc, a[1], b1);
        wgmma64_rs(acc, a[0], b2);
        wgmma64_rs(tac, t[0], b0);
        wgmma64_rs(tac, t[1], b0);
        wgmma64_rs(tac, t[2], b0);
        wgmma64_rs(tac, t[0], b1);
        wgmma64_rs(tac, t[1], b1);
        wgmma64_rs(tac, t[0], b2);
      } else {
        wgmma64_rs(tac, a[0], b0, 0);
        wgmma64_rs(tac, a[1], b0);
        wgmma64_rs(tac, a[2], b0);
        wgmma64_rs(tac, a[0], b1);
        wgmma64_rs(tac, a[1], b1);
        wgmma64_rs(tac, a[0], b2);
      }
      wg_commit();
      wg_wait0();
      // the fragments stay in their registers until the products that
      // read them are done
      fence_frag(a);
      if constexpr (TANG) {
        fence_frag(t);
      } else {
        fence_regs(tac);
#pragma unroll
        for (int r = 0; r < 32; ++r) acc[r] = fadd(acc[r], tac[r]);
      }
      if (m.ws) release_slot(m, buf);
    }
    stamp(m, ST_MMA);
    if (!m.ws) {
      __syncthreads();       // every warpgroup is done with the buffer
      if (tid == 0) start_slice(m, m.seq + RING);
    }
    ++m.seq;
    stamp(m, ST_SYNC);
  }
  if (piped && nsl > 0) {
    wg_wait0();
    release_slot(m, (m.seq - 1) % nr);
    stamp(m, ST_MMA);
  }
  // The layer runs in place: every warpgroup reads all of X (T) until its
  // last product or split, so none stores its outputs before all are done
  // (without a producer warp the last slice's barrier did that)
  if (m.ws) {
    tile_sync();
    stamp(m, ST_SYNC);
  }
  fence_regs(acc);
  if constexpr (TANG) fence_regs(tac);
  const bool approx = m.approx_epi && Xn.kp;  // output rounded to bf16
#pragma unroll
  for (int r = 0; r < 32; r += 2) {
    const int row = warp * 16 + (lane >> 2) + ((r >> 1) & 1) * 8;
    const int c0 = wg * 64 + (r >> 2) * 8 + (lane & 3) * 2;
    float h[2], t[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int col = c0 + u;
      const float pre = acc[r + u];
      t[u] = 0.f;
      if (act == ACT_SOFTPLUS) {
        float g;
        if (approx)
          softplus100_fast(pre, h[u], g);
        else
          softplus100_pair(pre, h[u], g);
        if constexpr (TANG) t[u] = fmul(tac[r + u], g);
      } else {
        h[u] = fmaxf(pre, 0.f);
      }
      if (col >= L.N) h[u] = t[u] = 0.f;
    }
    // two adjacent columns of one row, zeros past N: one store
    if (Xn.kp) {
      const int o = tile_off(row, c0, Xn.kp);
      *reinterpret_cast<__nv_bfloat162*>(Xn.h() + o) =
          __floats2bfloat162_rn(h[0], h[1]);
      if constexpr (TANG)
        *reinterpret_cast<__nv_bfloat162*>(Tn.h() + o) =
            __floats2bfloat162_rn(t[0], t[1]);
    } else {
      const int o = row_off(row, c0, Xn.ldx);
      *reinterpret_cast<float2*>(Xn.f() + o) = make_float2(h[0], h[1]);
      if constexpr (TANG)
        *reinterpret_cast<float2*>(Tn.f() + o) = make_float2(t[0], t[1]);
    }
  }
  fence_proxy();
  tile_sync();
  stamp(m, ST_EPI);
}

// Columns k0 .. k0 + 7 (k0 a multiple of 8) of row s of X as f32: one
// 16-byte load from a bf16 tile (a core-matrix row), two from f32 rows (an
// 8-column group stays contiguous under the swizzle).
__device__ __forceinline__ void load8(const ActBuf& X, int s, int k0,
                                      float (&x)[8]) {
  if (X.kp) {
    const uint4 v =
        *reinterpret_cast<const uint4*>(X.h() + tile_off(s, k0, X.kp));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  } else {
    const float* p = X.f() + row_off(s, k0, X.ldx);
    const float4 a = *reinterpret_cast<const float4*>(p),
                 b = *reinterpret_cast<const float4*>(p + 4);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  }
}

// Output layer (N <= 3 columns, tile_mlp_ok) of the TS samples, reading X
// / T in the head's layout: each of a row's LPS lanes takes 8-column groups
// lane, lane + LPS, ... of its input with one load (load8) and every
// output column (and the tangent) from them.
__device__ void head_tile(const LayerDesc& L, ActBuf X, ActBuf T, bool tang,
                          bool sigm, float* out, float* tout) {
  const int s = threadIdx.x / LPS, lane = threadIdx.x % LPS;
  const int N = L.N;
  float acc[3] = {0.f, 0.f, 0.f}, ta = 0.f;
  for (int k0 = lane * 8; k0 < L.K; k0 += LPS * 8) {
    float x[8], t[8];
    load8(X, s, k0, x);
    if (tang) load8(T, s, k0, t);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = k0 + j;
      if (k >= L.K) break;
#pragma unroll
      for (int n = 0; n < 3; ++n)
        if (n < N) acc[n] = fmaf(x[j], ldw(L, k * N + n), acc[n]);
      if (tang) ta = fmaf(t[j], ldw(L, k * N), ta);
    }
  }
#pragma unroll
  for (int n = 0; n < 3; ++n) {
    if (n >= N) break;
    const float v = fadd(gsum(acc[n]), L.b[n]);
    if (lane == 0) out[s * N + n] = sigm ? sigmoid(v) : v;
  }
  if (tang) {
    ta = gsum(ta);
    if (lane == 0) tout[s] = ta;
  }
  tile_sync();
}

// Hidden layers and head of an MLP whose first-layer inputs are in X (T),
// laid out for layer 0 (first row block at column 0, second at its kp1).
template <bool TANG, bool F32>
__device__ void mlp_tile(const MLPDesc& D, TileMem& m, int act, bool sigm,
                         float* out, float* tout) {
  const ActBuf X{m.X, 0, m.ldx}, T{m.T, 0, m.ldx};
  for (int l = 0; l < D.n - 1; ++l) {
    const LayerDesc& L = D.l[l];
    const ActBuf Xi = X.for_layer(L), Ti = T.for_layer(L);
    const ActBuf Xn = X.for_layer(D.l[l + 1]), Tn = T.for_layer(D.l[l + 1]);
    wgmma_layer<TANG, F32>(L, m, Xi, Ti, act, Xn, Tn);
  }
  const LayerDesc& H = D.l[D.n - 1];
  head_tile(H, X.for_layer(H), T.for_layer(H), TANG, sigm, out, tout);
  stamp(m, ST_HEAD);
}

// Zero the pad columns [from, L0.kp) of a first layer's input.
__device__ void zero_tail(ActBuf X, const LayerDesc& L0, int from) {
  const int n = L0.kp - from;
  for (int idx = threadIdx.x; idx < TS * n; idx += TNT)
    X.put(idx / n, from + idx % n, 0.f);
}

// Density MLP of _density_mlp on the TS samples: inputs [ds, d cols, fg |
// fg_emb], softplus (beta 100) hidden layers, linear head. sFB holds the
// blended features (fg = its first gd columns, row stride ldfb).
template <bool F32>
__device__ void density_tile(const MLPDesc& D, TileMem& m, const float* sds,
                             const float* sFB, int ldfb, int md, int mfg,
                             int gd, int lowp, bool tang, float* sdens,
                             float* sdDdh) {
  const LayerDesc& L0 = D.l[0];
  const int r0 = L0.bf16;
  const int nd = 1 + 2 * (md > 0 ? md : 0);
  const int split = L0.split;                 // nd + gd
  const int xoff2 = L0.kp1;                   // the second row block
  const ActBuf X = ActBuf{m.X, 0, m.ldx}.for_layer(L0),
               T = ActBuf{m.T, 0, m.ldx}.for_layer(L0);
  for (int idx = threadIdx.x; idx < TS * xoff2; idx += TNT) {
    const int s = idx / xoff2, j = idx % xoff2;
    float v = 0.f, dv = 0.f;
    if (j == 0) {
      v = sds[s];
      dv = 1.f;
    } else if (j < nd) {
      v = emb_col(sds[s], j - 1, &dv);
    } else if (j < split) {
      const float fg = sFB[s * ldfb + (j - nd)];
      v = lowp ? rbf(fg) : fg;
    }
    X.put(s, j, rnd(v, r0));
    if (tang) T.put(s, j, rnd(j < nd ? dv : 0.f, r0));
  }
  feature_emb_to(sFB, ldfb, gd, mfg, lowp, xoff2, r0,
                     [&](int s, int j, float v) { X.put(s, j, v); });
  zero_tail(X, L0, xoff2 + 2 * (mfg > 0 ? mfg : 0) * gd);
  // the tangent does not depend on the second row block: a bf16 layer
  // skips it, an f32 one (which splits every slice's fragment of T, so
  // that its products run on every path) reads zeros there
  if (tang && !r0) zero_tail(T, L0, xoff2);
  fence_proxy();
  tile_sync();
  stamp(m, ST_EMB);
  if (tang)
    mlp_tile<true, F32>(D, m, ACT_SOFTPLUS, false, sdens, sdDdh);
  else
    mlp_tile<false, F32>(D, m, ACT_SOFTPLUS, false, sdens, nullptr);
}

// Colour MLP of _field_kernel on the TS samples: inputs [nabla, d_emb,
// vdir, view_emb, ft | ft_emb], ReLU hidden layers, sigmoid head.
template <bool F32>
__device__ void color_tile(const MLPDesc& Cm, TileMem& m, const float* sds,
                           const float* sdh, const float* sdDdh,
                           const float* sdir, const float* sFB, int ldfb,
                           int gd, int cd, int md, int mft, int mv, int lowp,
                           float* srgb) {
  const LayerDesc& L0 = Cm.l[0];
  const int r0 = L0.bf16;
  const int nd = 1 + 2 * (md > 0 ? md : 0);
  const int nv = 6 * (mv > 0 ? mv : 0);
  const int split = L0.split;                 // 3 + nd + 3 + nv + cd
  const int xoff2 = L0.kp1;                   // the second row block
  const ActBuf X = ActBuf{m.X, 0, m.ldx}.for_layer(L0);
  for (int idx = threadIdx.x; idx < TS * xoff2; idx += TNT) {
    const int s = idx / xoff2, j = idx % xoff2;
    float v = 0.f;
    if (j < 3) {
      v = fmul(sdDdh[s], sdh[s * 4 + j]);
    } else if (j < 3 + nd) {
      v = j == 3 ? sds[s] : emb_col(sds[s], j - 4, nullptr);
    } else if (j < 6 + nd) {
      v = sdir[s * 4 + (j - 3 - nd)];
    } else if (j < 6 + nd + nv) {
      const int jj = j - 6 - nd;
      v = emb_col(sdir[s * 4 + jj % 3], jj / 3, nullptr);
    } else if (j < split) {
      const float ft = sFB[s * ldfb + gd + (j - 6 - nd - nv)];
      v = lowp ? rbf(ft) : ft;
    }
    X.put(s, j, rnd(v, r0));
  }
  feature_emb_to(sFB + gd, ldfb, cd, mft, lowp, xoff2, r0,
                     [&](int s, int j, float v) { X.put(s, j, v); });
  zero_tail(X, L0, xoff2 + 2 * (mft > 0 ? mft : 0) * cd);
  fence_proxy();
  tile_sync();
  stamp(m, ST_EMB);
  mlp_tile<false, F32>(Cm, m, ACT_RELU, true, srgb, nullptr);
}

// ---------------------------------------------------------------------------
// root search along rays (secant_refine, surface_locate): one block takes TS
// rays (TileRows: of one tile, or of consecutive contexts below TS rays a
// context); thread s < TS owns ray s of the block and keeps its bracket in
// registers, the contexts stay in shared memory (or L2), and nothing leaves
// the chip between the sequential field evaluations.
// ---------------------------------------------------------------------------

// Shared memory of a ray block after the tile stage's (TileMem::rest); the
// kNN weight rows alias the activation region, and the kernel's own
// buffers follow at `end` (a multiple of 4 floats from the start).
struct RayTile {
  float *o, *r, *xyz; // TS * 4 each: origin, direction, current point
  float *ds, *dens;   // TS each
  float *FB;          // TS * F blended features
  float *W;           // TS * C kNN weights
  unsigned short* idx;  // TS * KL listed kNN picks
  int* cnt;             // TS pick counts
  Contexts geo;         // each ray's context: TS ids, then nst staged
  float *end;
};

// Floats of a ray tile that stages nst contexts.
__host__ __device__ inline size_t ray_tile_floats(const RayField& f,
                                                  int nst) {
  return TS * (3 * 4 + 2) + TS * (size_t)f.F + TS * (KL / 2 + 1) + TS +
         8 * (size_t)f.C * nst;
}

// Carve the block's shared memory, load its rays' contexts (staged unless
// L2; then f.nst is 0) and their origins and directions (zeros on the
// ragged rows).
template <bool L2>
__device__ RayTile ray_tile_load(const RayField& f, const TileMem& m,
                                 const TileRows& rows) {
  const int nst = f.nst;
  RayTile t;
  t.o = m.rest;
  t.r = t.o + TS * 4;
  t.xyz = t.r + TS * 4;
  t.ds = t.xyz + TS * 4;
  t.dens = t.ds + TS;
  t.FB = t.dens + TS;
  t.idx = reinterpret_cast<unsigned short*>(t.FB + TS * f.F);
  t.cnt = reinterpret_cast<int*>(t.FB + TS * f.F + TS * KL / 2);
  int* ctx = t.cnt + TS;
  float* staged = reinterpret_cast<float*>(ctx + TS);
  t.end = staged + 8 * (size_t)f.C * nst;
  t.W = static_cast<float*>(m.X);
  t.geo = load_contexts(rows, f.geo, f.C, L2 ? nullptr : staged, ctx);
  const int tid = threadIdx.x;
  if (tid < TS) {
    const BlockRow r = rows.at(tid);
    for (int i = 0; i < 3; ++i) {
      t.o[tid * 4 + i] = r.live ? f.rays_o[(size_t)r.flat * 3 + i] : 0.f;
      t.r[tid * 4 + i] = r.live ? f.rays_d[(size_t)r.flat * 3 + i] : 0.f;
    }
  }
  return t;
}

// Interpolated distance at o + dv r of each owner's ray into t.ds; with
// ROWS the kNN weights into t.W (all threads call). The candidates stay in
// registers when they fit (interp_sample's NC); L2: the contexts are read
// from global memory.
template <bool ROWS, bool L2>
__device__ void ray_interp_at(const RayField& f, const RayTile& t, float dv) {
  const int tid = threadIdx.x;
  if (tid < TS)
    for (int i = 0; i < 3; ++i)
      t.xyz[tid * 4 + i] = fadd(t.o[tid * 4 + i], fmul(dv, t.r[tid * 4 + i]));
  tile_sync();
  {
    constexpr int OUT = ROWS ? PICK_ROWS : PICK_NONE;
    const int s = tid / LPS, lane = tid % LPS;   // TNT / LPS == TS
    const Picks po{t.W + s * f.C, nullptr, nullptr, nullptr};
    Interp r;
    interp_any<OUT>(t.geo.of<L2>(s), f.C, t.xyz[s * 4], t.xyz[s * 4 + 1],
                    t.xyz[s * 4 + 2], f.w1, f.k, false, lane, po, r);
    if (lane == 0) t.ds[s] = r.ds;
  }
  tile_sync();
}

// Density minus tau of each owner's ray from t.ds and the kNN weights in
// t.W (all threads call; 0 on the other threads).
template <bool F32>
__device__ float ray_density(const RayField& f, const RayTile& t,
                             TileMem& m) {
  blend_tile(f.feat, t.geo.ctx, f.feat_bf16, f.F, f.gd, t.W, f.C, t.idx,
             t.cnt, t.FB);
  tile_sync();
  stamp(m, ST_BLEND);
  density_tile<F32>(f.dens, m, t.ds, t.FB, f.F, f.md, f.mfg, f.gd, f.lowp,
                    false, t.dens, nullptr);
  return threadIdx.x < TS ? fsub(t.dens[threadIdx.x], f.tau) : 0.f;
}

// Secant bracket of one owner ray: the field is below 0 at dl, above at dh.
struct Bracket {
  float dl, fl, dh, fh;
  __device__ float pred() const {
    float denom = fsub(fh, fl);
    if (fabsf(denom) < 1e-12f) denom = 1e-12f;
    return fadd(fdiv(fmul(-fl, fsub(dh, dl)), denom), dl);
  }
  // one secant step: the field's value fm at the prediction dp
  __device__ void step(float dp, float fm) {
    if (fm < 0.f) {
      dl = dp;
      fl = fm;
    } else {
      dh = dp;
      fh = fm;
    }
  }
};

}  // namespace nm
