// surface_locate: the whole surface root search of a ray in one launch.
//
// Replaces neumesh_tpu/ops/pallas_kernels.py::_locate_kernel (wrapper
// surface_locate, pl.pallas_call at :1092). Per ray, against its tile's
// candidate context: the n_steps sign-change scan of the interpolated
// distance at near + step j, the first crossing taken with f32 0/1 flags
// and arithmetic selects (x + flag (y - x), exactly as the TPU kernel
// carries them), the density re-bracket at the half-step-widened
// endpoints, and n_secant secant steps on the density. Every evaluation
// runs the field chain of field_common.cuh: the distance for the scan,
// distance + feature blend + density MLP for the rest. Outputs d_pred,
// mask, mask_sign_change and val0_pos as f32 planes.
//
// What bounds it on the H100: operations. A ray costs n_steps candidate
// stages (exact f32, CUDA cores) and 2 + n_secant density evaluations,
// whose bf16 layers are the roofline bound's largest term (tensor cores).
// The inputs are a few floats per ray.
//
// The design is secant_refine's ray block (field_common.cuh): 64 rays (of
// one tile, or of consecutive contexts below 64 rays a context) per block
// of four warpgroups, the owner thread of each ray
// keeping its scan and bracket state in registers, the tile context in
// shared memory, nothing leaving the chip between the n_steps + 2 +
// n_secant sequential evaluations. The scan runs the candidate stage alone
// (no kNN weight rows written, the tie-broken distances of a lane's
// candidates in registers); the first two weight slices of the density MLP
// load under it. Each density evaluation then runs the hidden layers on
// wgmma.m64n64k16 (f32 ones as the six-product bf16 split), the
// weight-slice ring running on cyclically from one
// evaluation to the next. The three flag planes are written straight after
// the scan, so that only the bracket lives through the density phase, and
// the two re-bracket evaluations and the secant steps share one loop with
// one call site of the density (it inlines once; 512 threads leave 128
// registers each). What holds it above the bound: the exact-f32 work on
// the CUDA cores -- the scan's n_steps kNN selections first, then each
// evaluation's selection, softplus epilogues, blend, embeddings and head.
#include "field_common.cuh"

namespace nm {

// Shared memory of a block staging nst contexts.
__host__ __device__ inline size_t locate_smem(const LocateArgs& a, int nst) {
  return tile_plan_bytes(tile_plan(a.f.dens, nullptr, a.f.ldx, a.f.C,
                                   false)) +
         sizeof(float) * ray_tile_floats(a.f, nst);
}
// Contexts a block stages: every one it may span, where they fit (the C
// entry sets RayField::nst).
__host__ __device__ inline int locate_staged(const LocateArgs& a) {
  const int n = block_contexts_max(a.f.B, a.f.T);
  return locate_smem(a, n) <= SMEM_MAX ? n : 0;
}

// F32: f32 hidden layers present; L2: the contexts read from global
// memory (none staged).
template <bool F32, bool L2>
__global__ void __launch_bounds__(TNT, 1)
    surface_locate_kernel(const __grid_constant__ LocateArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const RayField& f = a.f;
  // one 1-D grid over the ray blocks (TileRows): any number of contexts
  const TileRows rows{f.B, f.T, (int)blockIdx.x};
  const int tid = threadIdx.x;
  TileMem m = tile_carve(smem, tile_plan(f.dens, nullptr, f.ldx, f.C, false),
                         f.dens, nullptr, 1, f.ldx);
  tile_start(m);                       // weights load under the scan
  const RayTile t = ray_tile_load<L2>(f, m, rows);
  const bool owner = tid < TS;
  const BlockRow own = rows.at(owner ? tid : 0);
  const bool live = owner && own.live;
  const size_t ray = (size_t)own.flat;
  float near = 0.f, far = 0.f;         // a ragged ray scans [0, 0]
  if (live) {
    near = a.near[ray];
    far = a.far[ray];
  }

  // ---- scan: first sign change of the distance
  const float step = fdiv(fsub(far, near), (float)max(a.n_steps - 1, 1));
  Bracket br{far, -1.f, near, 1.f};
  {
    float f_prev = 0.f, d_prev = near, val0_pos = 0.f, found = 0.f,
          pos2neg = 0.f;
    for (int j = 0; j < a.n_steps; ++j) {
      const float dv = j ? fadd(near, fmul(step, (float)j)) : near;
      ray_interp_at<false, L2>(f, t, dv);
      const float f_cur = owner ? fsub(t.ds[tid], f.tau) : 0.f;
      if (j == 0) {
        val0_pos = f_cur > 0.f ? 1.f : 0.f;
      } else {
        // sign(f_prev) sign(f_cur) < 0
        const float crossed =
            ((f_prev > 0.f && f_cur < 0.f) || (f_prev < 0.f && f_cur > 0.f))
                ? 1.f : 0.f;
        const float cross = fmul(crossed, fsub(1.f, found));
        br.dh = fadd(br.dh, fmul(cross, fsub(d_prev, br.dh)));
        br.fh = fadd(br.fh, fmul(cross, fsub(f_prev, br.fh)));
        br.dl = fadd(br.dl, fmul(cross, fsub(dv, br.dl)));
        br.fl = fadd(br.fl, fmul(cross, fsub(f_cur, br.fl)));
        pos2neg = fadd(pos2neg, fmul(cross, f_prev > 0.f ? 1.f : 0.f));
        found = fadd(found, cross);
      }
      d_prev = dv;
      f_prev = f_cur;
    }
    if (live) {
      f.out[f.R + ray] = fmul(fmul(found, pos2neg), val0_pos);   // mask
      f.out[2 * (size_t)f.R + ray] = found;
      f.out[3 * (size_t)f.R + ray] = val0_pos;
    }
  }

  // ---- the density re-bracket at the half-step-widened endpoints (d_high_w
  // first, then d_low_w; kept with an arithmetic select as the TPU kernel
  // does) and the n_secant secant steps, through one call site of the
  // density
  const float hstep = fmul(0.5f, step);
  const float d_high_w = fmaxf(fsub(br.dh, hstep), near);
  const float d_low_w = fminf(fadd(br.dl, hstep), far);
  float f_high_r = 0.f, dp = 0.f;
  for (int e = 0; e < 2 + a.n_secant; ++e) {
    const float dv = e == 0 ? d_high_w : e == 1 ? d_low_w : dp;
    ray_interp_at<true, L2>(f, t, dv);
    const float fv = ray_density<F32>(f, t, m);
    if (e == 0) {
      f_high_r = fv;
      continue;
    }
    if (e == 1) {
      const float ok = (f_high_r > 0.f && fv < 0.f) ? 1.f : 0.f;
      br.fh = fadd(br.fh, fmul(ok, fsub(f_high_r, br.fh)));
      br.fl = fadd(br.fl, fmul(ok, fsub(fv, br.fl)));
      br.dh = fadd(br.dh, fmul(ok, fsub(d_high_w, br.dh)));
      br.dl = fadd(br.dl, fmul(ok, fsub(d_low_w, br.dl)));
    } else {
      br.step(dp, fv);
    }
    dp = br.pred();
  }
  if (live) f.out[ray] = dp;
  tile_drain(m);
}

}  // namespace nm

extern "C" {

size_t nm_surface_locate_smem(const nm::LocateArgs* a) {
  return nm::locate_smem(*a, nm::locate_staged(*a));
}

int nm_surface_locate(const nm::LocateArgs* a_in, void* stream) {
  if (a_in->f.R <= 0) return 0;
  nm::LocateArgs k = *a_in;
  const nm::LocateArgs* a = &k;
  const nm::RayField& f = k.f;
  if (!nm::rows_ok(f.B, f.T) || (long long)f.T * f.B != f.R || f.k < 1 ||
      a->n_steps < 1 || a->n_secant < 0 || (f.ldx & 3) ||
      !nm::tile_mlp_ok(f.dens, f.ldx))
    return (int)cudaErrorInvalidValue;
  k.f.nst = nm::locate_staged(k);
  const long long nblk = nm::tile_blocks(f.B, f.T);
  const size_t smem = nm::locate_smem(k, f.nst);
  if (smem > nm::SMEM_MAX) return (int)cudaErrorInvalidValue;
  const bool l2 = f.nst == 0;
  auto kernel =
      nm::has_f32(f.dens)
          ? (l2 ? nm::surface_locate_kernel<true, true>
                : nm::surface_locate_kernel<true, false>)
          : (l2 ? nm::surface_locate_kernel<false, true>
                : nm::surface_locate_kernel<false, false>);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)nblk);
  kernel<<<grid, nm::TNT, smem, (cudaStream_t)stream>>>(k);
  return (int)cudaGetLastError();
}

const char* nm_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
