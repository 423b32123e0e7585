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
// What bounds it on the H100: the MLPs. At the volume-serving shapes a
// sample costs ~0.2 MFLOP of MLP work (W = 256, 3 density + 4 colour
// layers) against ~24 bytes of sample I/O, so the bound is operations,
// not bytes. This first version runs the MLPs on the CUDA cores (f32
// FMAs on bf16-exact products), thread-per-output-column over 32 samples
// per block with the activations in shared memory, so it sits far below
// the bf16 tensor-core peak; the candidate passes (8 lanes per sample,
// d2 recomputed per pass) are a small share. Moving the layers onto
// wgmma tiles is the next step.
#include "field_common.cuh"

namespace nm {

__global__ void __launch_bounds__(NT) field_fused_kernel(const FieldArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y;
  const int s0 = blockIdx.x * SB;
  const int C = a.C, S = a.S, tid = threadIdx.x;
  const bool full = a.mode == FULL;
  const bool tang = a.mode == DENSITY_NABLA || full;
  const int ldx = a.ldx;
  float* sgeo = smem;                  // 8 * C
  float* sxyz = sgeo + 8 * C;          // SB * 4
  float* sdir = sxyz + SB * 4;         // SB * 4
  float* sdh = sdir + SB * 4;          // SB * 4
  float* srgb = sdh + SB * 4;          // SB * 4
  float* sds = srgb + SB * 4;          // SB
  float* sdens = sds + SB;             // SB
  float* sdD = sdens + SB;             // SB
  float* spad = sdD + SB;              // SB (keeps 16-byte alignment)
  float* sFB = spad + SB;              // SB * F
  float* sW = sFB + SB * a.F;          // SB * max(C, ldx): W rows, then T
  float* sX = sW + SB * (C > ldx ? C : ldx);   // SB * ldx

  for (int i = tid; i < 8 * C; i += NT) sgeo[i] = a.geo[(size_t)b * 8 * C + i];
  if (tid < SB) {
    const int sg = min(s0 + tid, S - 1);   // ragged edge: repeat the last
    const size_t o = ((size_t)b * S + sg) * 3;
    for (int i = 0; i < 3; ++i) {
      sxyz[tid * 4 + i] = a.xyz[o + i];
      if (full) sdir[tid * 4 + i] = a.dirs[o + i];
    }
  }
  __syncthreads();

  {
    const int s = tid / LPS, lane = tid % LPS;
    Interp r;
    interp_sample(sgeo, C, sxyz[s * 4], sxyz[s * 4 + 1], sxyz[s * 4 + 2],
                  a.w1, a.k, tang, lane, sW + s * C, r);
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
  const bool wr = tid < SB && s0 + tid < S;
  if (a.mode == DISTANCE) {
    if (wr) a.out[obase + tid] = sds[tid];
    return;
  }

  blend_stage(a.feat, (size_t)b * C * a.F, a.feat_bf16, a.F,
              full ? a.F : a.gd, sW, C, sFB);
  __syncthreads();
  density_stage(a.dens, sX, sW, ldx, sds, sFB, a.F, a.md, a.mfg, a.gd,
                a.lowp, tang, sdens, sdD);
  if (wr) a.out[obase + tid] = sdens[tid];
  if (!tang) return;
  if (wr)
    for (int i = 0; i < 3; ++i)
      a.out[(1 + i) * plane + obase + tid] = fmul(sdD[tid], sdh[tid * 4 + i]);
  if (!full) return;
  color_stage(a.col, sX, ldx, sds, sdh, sdD, sdir, sFB, a.F, a.gd,
              a.F - a.gd, a.md, a.mft, a.mv, a.lowp, srgb);
  if (wr)
    for (int i = 0; i < 3; ++i)
      a.out[(4 + i) * plane + obase + tid] = srgb[tid * 3 + i];
}

}  // namespace nm

extern "C" {

size_t nm_field_fused_smem(const nm::FieldArgs* a) {
  const int C = a->C, ldx = a->ldx;
  return sizeof(float) * ((size_t)8 * C + nm::SB * (4 * 4 + 4) +
                          (size_t)nm::SB * a->F +
                          (size_t)nm::SB * (C > ldx ? C : ldx) +
                          (size_t)nm::SB * ldx);
}

int nm_field_fused(const nm::FieldArgs* a, void* stream) {
  if (a->B <= 0 || a->S <= 0) return 0;
  if (a->B > 65535 || a->k < 1 || (a->ldx & 3) || a->ldx < 4)
    return (int)cudaErrorInvalidValue;
  const size_t smem = nm_field_fused_smem(a);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      nm::field_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a->S + nm::SB - 1) / nm::SB, a->B);
  nm::field_fused_kernel<<<grid, nm::NT, smem, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

const char* nm_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
