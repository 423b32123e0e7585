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
// Built from secant_refine's root-search pieces (field_common.cuh: the ray
// block, ray_interp_at, ray_density_at, Bracket, secant_steps): one block
// takes 32 rays of one tile, the owner thread of each ray keeps its scan
// and bracket state in registers, and nothing leaves the chip between the
// ~n_steps + 2 + n_secant sequential evaluations.
//
// What bounds it on the H100: the 2 + n_secant density MLPs per ray
// (operations); the scan's candidate passes are a small share and the
// inputs are a few floats per ray.
#include "field_common.cuh"

namespace nm {

__global__ void __launch_bounds__(NT) surface_locate_kernel(const LocateArgs a) {
  extern __shared__ __align__(16) float smem[];
  const RayField& f = a.f;
  const int b = blockIdx.y, r0 = blockIdx.x * SB, tid = threadIdx.x;
  const RayTile t = ray_tile_load(f, smem, b, r0);
  const bool owner = tid < SB;
  float near = 0.f, far = 0.f;
  if (owner) {
    const size_t ray = (size_t)b * f.T + min(r0 + tid, f.T - 1);
    near = a.near[ray];
    far = a.far[ray];
  }
  auto dist = [&](float dv) -> float {
    ray_interp_at(f, t, dv);
    return owner ? fsub(t.ds[tid], f.tau) : 0.f;
  };

  // ---- scan: first sign change of the distance
  const float step = fdiv(fsub(far, near), (float)max(a.n_steps - 1, 1));
  float f_prev = dist(near);
  float d_prev = near;
  const float val0_pos = f_prev > 0.f ? 1.f : 0.f;
  float found = 0.f, pos2neg = 0.f;
  Bracket br{far, -1.f, near, 1.f};
  for (int j = 1; j < a.n_steps; ++j) {
    const float dv = fadd(near, fmul(step, (float)j));
    const float f_cur = dist(dv);
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
    d_prev = dv;
    f_prev = f_cur;
  }
  const float mask = fmul(fmul(found, pos2neg), val0_pos);

  // ---- density re-bracket at the half-step-widened endpoints, kept with
  // an arithmetic select as the TPU kernel does
  const float hstep = fmul(0.5f, step);
  const float d_high_w = fmaxf(fsub(br.dh, hstep), near);
  const float d_low_w = fminf(fadd(br.dl, hstep), far);
  const float f_high_r = ray_density_at(f, t, b, d_high_w);
  const float f_low_r = ray_density_at(f, t, b, d_low_w);
  const float ok = (f_high_r > 0.f && f_low_r < 0.f) ? 1.f : 0.f;
  br.fh = fadd(br.fh, fmul(ok, fsub(f_high_r, br.fh)));
  br.fl = fadd(br.fl, fmul(ok, fsub(f_low_r, br.fl)));
  br.dh = fadd(br.dh, fmul(ok, fsub(d_high_w, br.dh)));
  br.dl = fadd(br.dl, fmul(ok, fsub(d_low_w, br.dl)));

  // ---- secant on the density
  const float dp = secant_steps(
      br, a.n_secant, [&](float dv) { return ray_density_at(f, t, b, dv); });
  if (owner && r0 + tid < f.T) {
    const size_t ray = (size_t)b * f.T + r0 + tid;
    f.out[ray] = dp;
    f.out[f.R + ray] = mask;
    f.out[2 * (size_t)f.R + ray] = found;
    f.out[3 * (size_t)f.R + ray] = val0_pos;
  }
}

}  // namespace nm

extern "C" {

size_t nm_surface_locate_smem(const nm::LocateArgs* a) {
  return sizeof(float) * nm::ray_tile_floats(a->f);
}

int nm_surface_locate(const nm::LocateArgs* a, void* stream) {
  const nm::RayField& f = a->f;
  if (f.R <= 0) return 0;
  if (f.B <= 0 || f.B > 65535 || f.T * f.B != f.R || f.k < 1 ||
      a->n_steps < 1 || a->n_secant < 0 || (f.ldx & 3) || f.ldx < 4)
    return (int)cudaErrorInvalidValue;
  const size_t smem = nm_surface_locate_smem(a);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      nm::surface_locate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((f.T + nm::SB - 1) / nm::SB, f.B);
  nm::surface_locate_kernel<<<grid, nm::NT, smem, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

const char* nm_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
