// candidate_field_v3 and candidate_field (v2): the candidate stage of the
// NeuMesh field alone, no MLP.
//
// Replaces neumesh_tpu/ops/pallas_kernels.py::_v3_kernel (wrapper
// candidate_field_v3, pl.pallas_call at :324) and ::_kernel (wrapper
// candidate_field, pl.pallas_call at :169). Per sample, against one
// context (a tile's for v3, a ray's for v2): d2 to the C candidates, kNN
// selection by k masked-min passes with the d2*(1 + c*2e-7) tie-break,
// inverse-distance weights, the interpolated distance ds, optionally its
// closed-form gradient dh, optionally the kNN feature blend in exact f32.
// Both reuse field_fused's interp_sample and blend_stage and stop there;
// they differ only in where the context comes from (v3: the packed
// (8, C) rows; v2: the per-ray pts/ind/pp/vn arrays, read directly and
// laid out as the same rows in shared memory) and in v2's order of the dh
// sums. Neither has the k = 1 distance proxy of the field kernels.
//
// What bounds it on the H100: at the serving shapes (C = 128, k = 8,
// F = 64) a sample costs ~2.3 kFLOP of f32 candidate math and blend
// against ~270 bytes of output (feats), so operations bound it on the
// CUDA cores. Block shape as in field_fused: 32 samples, 8 lanes each for
// the candidate passes, the blend thread-per-output over shared memory.
#include "field_common.cuh"

namespace nm {

template <bool V2>
__device__ __forceinline__ void candidate_body(const CandArgs& a) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y;
  const int s0 = blockIdx.x * SB;
  const int C = a.C, S = a.S, F = a.F, tid = threadIdx.x;
  float* sgeo = smem;                  // 8 * C
  float* sxyz = sgeo + 8 * C;          // SB * 4
  float* sW = sxyz + SB * 4;           // SB * C
  float* sFB = sW + SB * C;            // SB * F

  if (V2) {
    for (int c = tid; c < C; c += NT) {
      const size_t o = (size_t)b * C + c;
      for (int i = 0; i < 3; ++i) {
        sgeo[i * C + c] = a.pts[o * 3 + i];
        sgeo[(3 + i) * C + c] = a.ind[o * 3 + i];
      }
      sgeo[6 * C + c] = a.pp[o];
      sgeo[7 * C + c] = a.vn[o];
    }
  } else {
    for (int i = tid; i < 8 * C; i += NT)
      sgeo[i] = a.geo[(size_t)b * 8 * C + i];
  }
  if (tid < SB) {
    const int sg = min(s0 + tid, S - 1);   // ragged edge: repeat the last
    for (int i = 0; i < 3; ++i)
      sxyz[tid * 4 + i] = a.xyz[((size_t)b * S + sg) * 3 + i];
  }
  __syncthreads();

  const int s = tid / LPS, lane = tid % LPS;
  Interp r;
  interp_sample(sgeo, C, sxyz[s * 4], sxyz[s * 4 + 1], sxyz[s * 4 + 2],
                a.w1, a.k, a.want_dh, lane, sW + s * C, r, false, V2);
  if (lane == 0 && s0 + s < S) {
    const size_t row = (size_t)b * S + s0 + s;
    if (V2) {
      a.out_d[row] = r.ds;
      if (a.want_dh) {
        a.out_dh[row * 3] = r.dh0;
        a.out_dh[row * 3 + 1] = r.dh1;
        a.out_dh[row * 3 + 2] = r.dh2;
      }
    } else if (a.want_dh) {
      a.out_d[row * 4] = r.ds;
      a.out_d[row * 4 + 1] = r.dh0;
      a.out_d[row * 4 + 2] = r.dh1;
      a.out_d[row * 4 + 3] = r.dh2;
    } else {
      a.out_d[row] = r.ds;
    }
  }
  if (!a.want_feat) return;
  __syncthreads();
  blend_stage(a.feat, (size_t)b * C * F, 0, F, F, sW, C, sFB);
  __syncthreads();
  const int ns = min(SB, S - s0);
  float* dst = a.out_feat + ((size_t)b * S + s0) * F;
  for (int i = tid; i < ns * F; i += NT) dst[i] = sFB[i];
}

__global__ void __launch_bounds__(NT) candidate_field_v3_kernel(const CandArgs a) {
  candidate_body<false>(a);
}

__global__ void __launch_bounds__(NT) candidate_field_kernel(const CandArgs a) {
  candidate_body<true>(a);
}

}  // namespace nm

namespace {

size_t cand_smem(const nm::CandArgs* a) {
  return sizeof(float) * ((size_t)8 * a->C + nm::SB * 4 +
                          (size_t)nm::SB * a->C + (size_t)nm::SB * a->F);
}

int launch_cand(void (*kernel)(const nm::CandArgs), const nm::CandArgs* a,
                void* stream) {
  if (a->B <= 0 || a->S <= 0) return 0;
  if (a->B > 65535 || a->C < 1 || a->k < 1 || (a->want_feat && a->F < 1))
    return (int)cudaErrorInvalidValue;
  const size_t smem = cand_smem(a);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a->S + nm::SB - 1) / nm::SB, a->B);
  kernel<<<grid, nm::NT, smem, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int nm_candidate_field_v3(const nm::CandArgs* a, void* stream) {
  return launch_cand(nm::candidate_field_v3_kernel, a, stream);
}

int nm_candidate_field(const nm::CandArgs* a, void* stream) {
  return launch_cand(nm::candidate_field_kernel, a, stream);
}

const char* nm_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
