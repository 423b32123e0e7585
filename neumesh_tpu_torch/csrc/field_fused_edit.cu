// field_fused_edit: the texture-edited shade, field_fused's `full` mode
// with one more colour head a reference and the blend by the paint weight.
//
// Replaces no TPU kernel: the JAX package's bound edited shade
// (neumesh_tpu/editing/texture_model.py::RayBoundTextureEditable.forward)
// is plain jnp on the context math; the port's other route
// (editing/texture_model.py::RayBoundTextureEditable._shade, on the CPU and
// without use_pallas) is the same math in plain torch, whose (tiles,
// samples, candidates) temporaries and CUDA-core f32 products hold a
// texture-swapped frame at several times the unedited one. Per sample,
// against one tile's candidate context and R <= MAX_REFS references:
//   - the candidate stage, the kNN weight rows W, the interpolated distance
//     h and grad h (as `full`);
//   - the main features ft = W feat, the density MLP with its tangent
//     (sdf, dD/dh, d_emb) and the main colour head on [dD/dh grad h, d_emb,
//     view, ft] (as `full`);
//   - for each reference r: the edit rows of its candidates, [codes_r *
//     m_r, m_r] (transferred colour codes times the vertex's edit mask,
//     then the mask), blended by the same W: the numerator n_r and the
//     paint weight p_r = sum W m_r; ft_r = n_r / (p_r + 1e-8), which is
//     (W m_r / (sum W m_r + 1e-8)) @ codes_r of the plain shade in another
//     rounding order; the view direction and grad h rotated into the
//     reference's frame (nabla = dD/dh grad h is linear in grad h); the
//     reference's colour head on [dD/dh R grad h, d_emb, R view, ft_r];
//     where p_r > 0, rgb = rgb (1 - p_r) + rgb_r p_r, reference after
//     reference.
// Outputs (4, B, S) f32: sdf, r, g, b.
//
// What bounds it on the H100: the `full` mode's operations (~1.13 MFLOP of
// MLP work a sample at the flagship width) plus a colour MLP a reference
// (~0.5 MFLOP), all on the tensor cores (an f32 layer as the six-product
// bf16 split, at a sixth of the bf16 rate), against ~28 bytes of sample I/O
// and the reference's edit rows (33 floats a candidate, read from L2 like
// the features): operations. The design is field_fused.cu's persistent
// warp-specialised block and its stages (field_common.cuh), so the second
// head costs what a head costs there: the reference's colour weights stream
// through the same ring right after the main head's (a tile's stream is
// density, colour, then each reference's colour), and nothing leaves the
// chip between the heads. What it adds on the CUDA cores a reference: the
// kNN weight rows rebuilt from each row's kNN threshold and raw-weight sum
// (the candidate stage keeps them; the same arithmetic as that stage, so
// the same bits, 64 x C d2 and tie tests and the picks' weights) into the
// activation region, which the density MLP has taken over by then; the
// blend of the reference's cd + 1 edit columns over the listed picks; two
// rotations a row and the mix. Keeping the rows beside the MLPs instead
// would cost 32 KB a block (or the blend of every reference at once, 8.4
// KB a reference), which the selective-f32 plan (two slots at 226,944 B of
// the 227 KB) does not have.
//
// Shared memory: field_fused's `full` plan and 16 more words a row (the
// rotated direction and grad h, the reference's colour, its paint weight,
// the kNN threshold and raw-weight sum, the row's liveness and painted
// count), 4 KB: ops/kernels.py::tile_smem_plan("field_fused_edit", ...)
// mirrors it.
#include "field_common.cuh"

namespace nm {

constexpr int MAX_REFS = 4;      // ops/_build.py EDIT_REFS

struct EditRef {
  const float* rows;  // (B, C, cd + 1): each candidate's transferred codes
                      // times its edit mask, then the mask
  const float* rot;   // (3, 3) main -> reference rotation, row-major
  int cd, lowp, mft, mv;
  MLPDesc col;        // the reference's colour MLP
};
struct EditArgs {
  FieldArgs f;        // mode FULL; out (4, B, S): sdf, r, g, b
  EditRef ref[MAX_REFS];
  int nref, pad;
  long long* painted; // += the samples with a positive paint weight,
                      // summed over the references; or null
};

// Floats a row of the kernel's own per-row vectors: xyz, dir, grad h, rgb,
// the rotated grad h and dir, the reference's rgb (4 each); ds, density,
// dD/dh, the paint weight, the kNN threshold, the raw-weight sum, whether
// the row is live, its painted count.
constexpr int EDIT_ROW = 7 * 4 + 8;

// The kernel's shared memory after the tile stage's (TileMem::rest) for a
// block staging nst contexts: per-row vectors, the blended features, the
// listed picks, the row contexts, the staged contexts.
__host__ __device__ inline size_t edit_rest(const EditArgs& e, int nst) {
  return sizeof(float) * (TS * EDIT_ROW + (size_t)TS * e.f.F +
                          TS * (KL / 2 + 1) + TS + 8 * (size_t)e.f.C * nst);
}
__host__ __device__ inline TilePlan edit_plan(const EditArgs& e, int nst) {
  return tile_plan(e.f.dens, &e.f.col, e.f.ldx, e.f.C, true, true,
                   edit_rest(e, nst));
}
__host__ __device__ inline size_t edit_smem(const EditArgs& e, int nst) {
  return tile_plan_bytes(edit_plan(e, nst)) + edit_rest(e, nst);
}
__host__ __device__ inline int edit_staged(const EditArgs& e) {
  const int n = block_contexts_max(e.f.B, e.f.S);
  return edit_smem(e, n) <= SMEM_MAX ? n : 0;
}

// The MLP at position i of a tile's weight stream: the density, the main
// colour, then each reference's colour.
__host__ __device__ inline const MLPDesc& edit_mlp(const EditArgs& e,
                                                   int i) {
  return i == 0 ? e.f.dens : i == 1 ? e.f.col : e.ref[i - 2].col;
}
__host__ __device__ inline int edit_slices(const EditArgs& e) {
  int n = 0;
  for (int i = 0; i < 2 + e.nref; ++i) n += mlp_slices(edit_mlp(e, i));
  return n;
}

// Start loading slice p of a tile's stream into ring slot `slot` (the
// producer's first lane; start_slice over edit_mlp's MLPs).
__device__ void edit_slice(const TileMem& m, const EditArgs& e, int p,
                           uint32_t slot) {
  for (int i = 0; i < 2 + e.nref; ++i) {
    const MLPDesc& D = edit_mlp(e, i);
    for (int l = 0; l < D.n; ++l) {
      const LayerDesc& L = D.l[l];
      const int n = n_slices(L);
      if (p < n) {
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

// produce() over the edit stream: the n slices the consumers take, per_tile
// a tile.
__device__ void edit_produce(const TileMem& m, const EditArgs& e,
                             int per_tile, uint32_t n) {
  const uint32_t nr = (uint32_t)m.nring;
  for (uint32_t q = 0; q < n; ++q) {
    if (q >= nr) mbar_wait(m.empty + q % nr, (q / nr - 1) & 1);
    edit_slice(m, e, (int)(q % (uint32_t)per_tile), q % nr);
  }
}

// The kNN weight rows of block blk's TS rows again, from each row's
// threshold and raw-weight sum: interp_sample's selection (tie-broken d2 <=
// thr) and weights (1 / (sqrt(d2) + 1e-7) / sw) in its arithmetic, zeros
// elsewhere. The block's contexts are where load_contexts put them (every
// thread calls; the caller synchronises).
template <bool L2>
__device__ void edit_weight_rows(const FieldArgs& a, int blk,
                                 const float* sgeo, const int* sctx,
                                 const float* sxyz, const float* sthr,
                                 const float* ssw, float* sW) {
  const int C = a.C;
  const TileRows rows{a.B, a.S, blk};
  const Contexts geo{a.geo, sgeo, sctx, C, rows.first, rows.R >= TS};
  for (int i = threadIdx.x; i < TS * C; i += TNT) {
    const int s = i / C, c = i % C;
    const float x0 = sxyz[s * 4], x1 = sxyz[s * 4 + 1], x2 = sxyz[s * 4 + 2];
    const float d2 = cand_d2(geo.of<L2>(s), C, c, x0, x1, x2,
                             sq_norm(x0, x1, x2));
    sW[i] = tie_broken(c, d2) <= sthr[s]
                ? fdiv(fdiv(1.f, fadd(sqrtf(d2), 1e-7f)), ssw[s])
                : 0.f;
  }
}

// Reference R's blend of the TS rows over their listed picks (blend_tile's
// order): ft_r into sFT (row stride ldft), the paint weight into spw. The
// numerator's weights are rounded to bf16 where the reference's products
// are; the paint weight's never (every thread calls).
__device__ void edit_blend(const EditRef& R, const int* ctx, const float* sW,
                           int C, const unsigned short* idx, const int* cnt,
                           float* sFT, int ldft, float* spw) {
  const int cd = R.cd, n1 = cd + 1;
  for (int i = threadIdx.x; i < TS * cd; i += TNT) {
    const int s = i / cd, f = i % cd;
    const float* wr = sW + s * C;
    const int n = cnt[s];
    const float* rows = R.rows + (size_t)ctx[s] * C * n1;
    float num = 0.f, pw = 0.f;
    for (int j = 0; j < (n <= KL ? n : C); ++j) {
      const int c = n <= KL ? idx[s * KL + j] : j;
      const float w = wr[c];
      if (w != 0.f) {
        const float* rc = rows + (size_t)c * n1;
        num = fmaf(R.lowp ? rbf(w) : w, __ldg(rc + f), num);
        pw = fmaf(w, __ldg(rc + cd), pw);
      }
    }
    sFT[s * ldft + f] = fdiv(num, fadd(pw, 1e-8f));
    if (f == 0) spw[s] = pw;
  }
}

// out = rot v (rot row-major).
__device__ __forceinline__ void edit_rotate(const float* rot, const float* v,
                                            float* out) {
  for (int j = 0; j < 3; ++j)
    out[j] = fadd(fadd(fmul(__ldg(rot + 3 * j), v[0]),
                       fmul(__ldg(rot + 3 * j + 1), v[1])),
                  fmul(__ldg(rot + 3 * j + 2), v[2]));
}

// The tiles of a block (every consumer thread): field_fused's `full` tile,
// then each reference's head and the mix. Across the MLP stages only the
// tile index stays live (the contexts and the rows are derived from it
// again; the painted counts and liveness sit in shared memory). The tile's
// front (staging and the candidate stage) is a copy of field_fused_tiles':
// moved into one __forceinline__ helper of field_common.cuh that both
// called, it changed field_fused's own SASS (nvcc 12.8, sm_90a: 153,298 ->
// 154,138 lines over its 12 instantiations), and the existing kernels keep
// their code.
template <bool F32, bool L2>
__device__ __forceinline__ void edit_tiles(const EditArgs& e, TileMem& m,
                                           int nblk) {
  const FieldArgs& a = e.f;
  const int C = a.C, tid = threadIdx.x;
  float* sxyz = m.rest;                // TS * 4
  float* sdir = sxyz + TS * 4;         // TS * 4
  float* sdh = sdir + TS * 4;          // TS * 4
  float* srgb = sdh + TS * 4;          // TS * 4: the main colour, mixed
  float* sdhr = srgb + TS * 4;         // TS * 4: a reference's grad h
  float* sdirr = sdhr + TS * 4;        // TS * 4: and view direction
  float* sref = sdirr + TS * 4;        // TS * 4: and colour
  float* sds = sref + TS * 4;          // TS
  float* sdens = sds + TS;             // TS
  float* sdD = sdens + TS;             // TS
  float* spw = sdD + TS;               // TS: a reference's paint weight
  float* sthr = spw + TS;              // TS: the kNN threshold
  float* ssw = sthr + TS;              // TS: the raw-weight sum
  int* slive = reinterpret_cast<int*>(ssw + TS);   // TS: a row of the call
  int* spaint = slive + TS;            // TS: painted samples, over the tiles
  float* sFB = ssw + TS * 3;           // TS * F
  unsigned short* sidx =               // TS * KL listed kNN picks
      reinterpret_cast<unsigned short*>(sFB + TS * a.F);
  int* scnt = reinterpret_cast<int*>(sFB + TS * a.F + TS * KL / 2);
  int* sctx = scnt + TS;               // TS: each row's context
  float* sgeo = L2 ? nullptr           // 8 * C * nst
                   : reinterpret_cast<float*>(sctx + TS);
  float* sW = static_cast<float*>(m.X);   // TS * C, aliased on X/T
  const size_t plane = (size_t)a.B * a.S;
  if (tid < TS) spaint[tid] = 0;

  for (int blk = blockIdx.x; blk < nblk; blk += gridDim.x) {
    {
      const TileRows rows{a.B, a.S, blk};
      const Contexts geo = load_contexts(rows, a.geo, C, sgeo, sctx);
      if (tid < TS) {
        const BlockRow r = rows.at(tid); // a ragged row computes on zeros
        for (int i = 0; i < 3; ++i) {
          const size_t o = (size_t)r.flat * 3 + i;
          sxyz[tid * 4 + i] = r.live ? a.xyz[o] : 0.f;
          sdir[tid * 4 + i] = r.live ? a.dirs[o] : 0.f;
        }
        slive[tid] = r.live;
      }
      tile_sync();
      const int s = tid / LPS, lane = tid % LPS;   // TNT / LPS == TS
      const Picks po{sW + s * C, nullptr, nullptr, nullptr};
      Interp r;
      interp_any<PICK_ROWS>(geo.of<L2>(s), C, sxyz[s * 4], sxyz[s * 4 + 1],
                            sxyz[s * 4 + 2], a.w1, a.k, true, lane, po, r);
      if (lane == 0) {
        sds[s] = r.ds;
        sdh[s * 4] = r.dh0;
        sdh[s * 4 + 1] = r.dh1;
        sdh[s * 4 + 2] = r.dh2;
        sthr[s] = r.thr;
        ssw[s] = r.sw;
      }
    }
    tile_sync();
    blend_tile(a.feat, sctx, a.feat_bf16, a.F, a.F, sW, C, sidx, scnt, sFB);
    tile_sync();
    density_tile<F32>(a.dens, m, sds, sFB, a.F, a.md, a.mfg, a.gd, a.lowp,
                      true, sdens, sdD);
    color_tile<F32>(a.col, m, sds, sdh, sdD, sdir, sFB, a.F, a.gd,
                    a.F - a.gd, a.md, a.mft, a.mv, a.lowp, srgb);
    for (int r = 0; r < e.nref; ++r) {
      const EditRef& R = e.ref[r];
      // the heads are done with X: the weight rows go there again, and
      // ft_r over the main features
      edit_weight_rows<L2>(a, blk, sgeo, sctx, sxyz, sthr, ssw, sW);
      tile_sync();
      edit_blend(R, sctx, sW, C, sidx, scnt, sFB, a.F, spw);
      if (tid < TS) {
        edit_rotate(R.rot, sdh + tid * 4, sdhr + tid * 4);
        edit_rotate(R.rot, sdir + tid * 4, sdirr + tid * 4);
      }
      tile_sync();
      color_tile<F32>(R.col, m, sds, sdhr, sdD, sdirr, sFB, a.F, 0, R.cd,
                      a.md, R.mft, R.mv, R.lowp, sref);
      if (tid < TS && spw[tid] > 0.f) {
        const float pw = spw[tid], u = fsub(1.f, pw);
        for (int i = 0; i < 3; ++i)
          srgb[tid * 3 + i] = fadd(fmul(srgb[tid * 3 + i], u),
                                   fmul(sref[tid * 3 + i], pw));
        spaint[tid] += slive[tid];
      }
    }
    if (tid < TS && slive[tid]) {
      const size_t o = TileRows{a.B, a.S, blk}.at(tid).flat;
      a.out[o] = sdens[tid];
      for (int i = 0; i < 3; ++i)
        a.out[(1 + i) * plane + o] = srgb[tid * 3 + i];
    }
    // the next tile's staging overwrites what this one's stores read
    tile_sync();
  }
  if (e.painted && tid < TS) {
    // threads [0, TS) are two whole warps
    const unsigned n = __reduce_add_sync(0xffffffffu, (unsigned)spaint[tid]);
    if ((tid & 31) == 0 && n)
      atomicAdd(reinterpret_cast<unsigned long long*>(e.painted),
                (unsigned long long)n);
  }
}

// One instantiation per register budget: F32, f32 hidden layers in any of
// the MLPs; L2, the contexts read from global memory (none staged). The
// block is field_fused_kernel's: persistent, the consumers [0, TNT), the
// producer warpgroup streaming every slice of every tile.
template <bool F32, bool L2>
__global__ void __launch_bounds__(WS_THREADS, 1)
    field_fused_edit_kernel(const __grid_constant__ EditArgs e) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int nblk = (int)tile_blocks(e.f.B, e.f.S);
  const int tiles = nblk > (int)blockIdx.x
                        ? (nblk - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                        : 0;
  TileMem m = tile_carve(smem, edit_plan(e, e.f.nst), e.f.dens, &e.f.col, 0,
                         e.f.ldx);
  m.ws = true;
  m.approx_epi = true;
  const int per_tile = edit_slices(e);
  ws_start(m, (uint32_t)tiles * (uint32_t)per_tile);
  if (threadIdx.x >= TNT) {            // the producer warpgroup
    producer_regs();
    if (threadIdx.x == TNT) edit_produce(m, e, per_tile, m.stream);
  } else {                             // the consumers
    consumer_regs();
    edit_tiles<F32, L2>(e, m, nblk);
  }
}

inline void (*pick_edit_kernel(bool f32, bool l2))(EditArgs) {
  if (f32)
    return l2 ? field_fused_edit_kernel<true, true>
              : field_fused_edit_kernel<true, false>;
  return l2 ? field_fused_edit_kernel<false, true>
            : field_fused_edit_kernel<false, false>;
}

// What the kernel takes: field_fused's `full` arguments, at most MAX_REFS
// references, each with its edit rows, 1 <= cd <= F (ft_r goes over the
// main features), a colour MLP whose activations fit the plan's buffers and
// whose slices fit its ring slots.
inline bool edit_ok(const EditArgs& e) {
  const FieldArgs& a = e.f;
  if (!rows_ok(a.B, a.S) || a.k < 1 || a.mode != FULL ||
      !tile_mlp_ok(a.dens, a.ldx) || !tile_mlp_ok(a.col, a.ldx) ||
      e.nref < 0 || e.nref > MAX_REFS)
    return false;
  const TilePlan p = edit_plan(e, a.nst);
  for (int r = 0; r < e.nref; ++r) {
    const EditRef& R = e.ref[r];
    if (!R.rows || !R.rot || R.cd < 1 || R.cd > a.F || !tile_mlp_ok(R.col, a.ldx) ||
        act_bytes(R.col, a.ldx) > p.xb ||
        (p.slot == SLOT_F32_BYTES && has_bf16_hidden(R.col)))
      return false;
  }
  return true;
}

}  // namespace nm

extern "C" {

size_t nm_field_fused_edit_smem(const nm::EditArgs* e) {
  return nm::edit_smem(*e, nm::edit_staged(*e));
}

int nm_field_fused_edit(const nm::EditArgs* e_in, void* stream) {
  if (e_in->f.B <= 0 || e_in->f.S <= 0) return 0;
  nm::EditArgs e = *e_in;
  e.f.nst = nm::edit_staged(e);
  if (!nm::edit_ok(e)) return (int)cudaErrorInvalidValue;
  const size_t smem = nm::edit_smem(e, e.f.nst);
  if (smem > nm::SMEM_MAX) return (int)cudaErrorInvalidValue;
  bool f32 = nm::has_f32(e.f.dens) || nm::has_f32(e.f.col);
  for (int r = 0; r < e.nref; ++r) f32 = f32 || nm::has_f32(e.ref[r].col);
  auto kernel = nm::pick_edit_kernel(f32, e.f.nst == 0);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid =
      (unsigned)nm::persistent_grid(nm::tile_blocks(e.f.B, e.f.S));
  kernel<<<grid, nm::WS_THREADS, smem, (cudaStream_t)stream>>>(e);
  return (int)cudaGetLastError();
}

const char* nm_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
