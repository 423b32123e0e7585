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
// Both run the field kernels' interp_sample (field_common.cuh) and differ
// only in where the context comes from (v3: the packed (8, C) rows; v2:
// the per-ray pts/ind/pp/vn arrays, read directly and laid out as the same
// rows in shared memory) and in v2's order of the dh sums. Neither has the
// k = 1 distance proxy of the field kernels.
//
// What bounds it on the H100: with the blend, bytes -- a sample writes F
// floats of blended features (256 B at F = 64) for ~2.3 kFLOP of f32
// candidate math at C = 128, k = 8; without it, those operations on the
// CUDA cores. What the design does: 32 samples a block, 8 lanes each; the
// tie-broken distances of a lane's 16 candidates stay in registers over
// the k selection passes (C <= 128), and the weight and interpolation
// passes run on the picks alone (interp_sample). The blend never sees a
// row of C weights: the interpolation pass lists each sample's picks
// (candidate, weight) in ascending candidate order, and each thread sums
// four feature columns of a sample over that list -- the products and the
// order of a scan over the whole row, k of them instead of C -- and stores
// them as one 16-byte word straight to device memory. A sample with more
// picks than the list holds (ties, k > 32) scans all C candidates instead,
// recomputing each weight from the sample's threshold and weight sum, so
// that no sum is ever truncated. A block needs ~11 KB of shared memory
// (context 4 KB, lists 6 KB), so several share an SM.
#include "field_common.cuh"

namespace nm {

// feats of sample s, columns [f, f + V): the listed picks, or every
// candidate again where the list overflowed.
template <int V>
__device__ __forceinline__ void blend_sample(const float* feat, int F, int f,
                                             const float* sgeo, int C,
                                             const float* x, int n,
                                             const unsigned short* idx,
                                             const float* pw, float thr,
                                             float sw, float (&acc)[V]) {
  auto add = [&](int c, float w) {
    const float* row = feat + (size_t)c * F + f;
    if constexpr (V == 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(row));
      acc[0] = fmaf(w, v.x, acc[0]);
      acc[1] = fmaf(w, v.y, acc[1]);
      acc[2] = fmaf(w, v.z, acc[2]);
      acc[3] = fmaf(w, v.w, acc[3]);
    } else {
      acc[0] = fmaf(w, __ldg(row), acc[0]);
    }
  };
  if (n <= KL) {
    for (int j = 0; j < n; ++j) add(idx[j], pw[j]);
    return;
  }
  const float xx = sq_norm(x[0], x[1], x[2]);
  for (int c = 0; c < C; ++c) {
    const float d2 = cand_d2(sgeo, C, c, x[0], x[1], x[2], xx);
    if (tie_broken(c, d2) <= thr) add(c, fdiv(raw_weight(d2), sw));
  }
}

template <bool V2, bool FEAT>
__device__ __forceinline__ void candidate_body(const CandArgs& a) {
  extern __shared__ __align__(16) float smem[];
  // one 1-D grid over (context, sample block): any number of contexts
  const int nblk = (a.S + SB - 1) / SB;
  const int b = blockIdx.x / nblk;
  const int s0 = (blockIdx.x % nblk) * SB;
  const int C = a.C, S = a.S, F = a.F, tid = threadIdx.x;
  float* sgeo = smem;                  // 8 * C
  float* sxyz = sgeo + 8 * C;          // SB * 4
  // with the blend: each sample's threshold, weight sum and listed picks
  float* sthr = sxyz + SB * 4;         // SB
  float* ssw = sthr + SB;              // SB
  float* spw = ssw + SB;               // SB * KL
  int* scnt = reinterpret_cast<int*>(spw + SB * KL);   // SB
  unsigned short* sidx = reinterpret_cast<unsigned short*>(scnt + SB);

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
  {
    constexpr int OUT = FEAT ? PICK_LIST : PICK_NONE;
    const float x0 = sxyz[s * 4], x1 = sxyz[s * 4 + 1], x2 = sxyz[s * 4 + 2];
    const Picks po{nullptr, sidx + s * KL, spw + s * KL, scnt + s};
    Interp r;
    if (C <= KC * LPS)
      interp_sample<KC, OUT>(sgeo, C, x0, x1, x2, a.w1, a.k, a.want_dh, lane,
                             po, r, false, V2);
    else
      interp_sample<0, OUT>(sgeo, C, x0, x1, x2, a.w1, a.k, a.want_dh, lane,
                            po, r, false, V2);
    if (lane == 0) {
      if (FEAT) {
        sthr[s] = r.thr;
        ssw[s] = r.sw;
      }
      if (s0 + s < S) {
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
    }
  }
  if constexpr (FEAT) {
    __syncthreads();
    const int ns = min(SB, S - s0);
    const float* feat = a.feat + (size_t)b * C * F;
    float* dst = a.out_feat + ((size_t)b * S + s0) * F;
    // four columns a thread as 16-byte loads and stores where the rows
    // allow it
    const bool vec = (F & 3) == 0 &&
                     ((reinterpret_cast<uintptr_t>(a.feat) |
                       reinterpret_cast<uintptr_t>(a.out_feat)) & 15) == 0;
    const int V = vec ? 4 : 1, FV = F / V;
    for (int it = tid; it < ns * FV; it += NT) {
      const int si = it / FV, f = (it % FV) * V;
      const unsigned short* idx = sidx + si * KL;
      const float* pw = spw + si * KL;
      if (vec) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        blend_sample<4>(feat, F, f, sgeo, C, sxyz + si * 4, scnt[si], idx, pw,
                        sthr[si], ssw[si], acc);
        *reinterpret_cast<float4*>(dst + si * F + f) =
            make_float4(acc[0], acc[1], acc[2], acc[3]);
      } else {
        float acc[1] = {0.f};
        blend_sample<1>(feat, F, f, sgeo, C, sxyz + si * 4, scnt[si], idx, pw,
                        sthr[si], ssw[si], acc);
        dst[si * F + f] = acc[0];
      }
    }
  }
}

template <bool FEAT>
__global__ void __launch_bounds__(NT)
    candidate_field_v3_kernel(const CandArgs a) {
  candidate_body<false, FEAT>(a);
}

template <bool FEAT>
__global__ void __launch_bounds__(NT) candidate_field_kernel(const CandArgs a) {
  candidate_body<true, FEAT>(a);
}

}  // namespace nm

// dynamic shared memory of a block (both kernels)
extern "C" size_t nm_candidate_field_smem(const nm::CandArgs* a) {
  const size_t SB = nm::SB, KL = nm::KL;
  return sizeof(float) * (8 * (size_t)a->C + SB * 4) +
         (a->want_feat ? sizeof(float) * (3 * SB + SB * KL) + 2 * SB * KL : 0);
}

namespace {

int launch_cand(void (*kernel)(const nm::CandArgs), const nm::CandArgs* a,
                void* stream) {
  if (a->B <= 0 || a->S <= 0) return 0;
  const long long nblk = (a->S + nm::SB - 1) / nm::SB;
  if (nblk * a->B > INT_MAX || a->C < 1 || a->C > 65535 || a->k < 1 ||
      (a->want_feat && a->F < 1))
    return (int)cudaErrorInvalidValue;
  const size_t smem = nm_candidate_field_smem(a);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)(nblk * a->B));
  kernel<<<grid, nm::NT, smem, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

size_t nm_candidate_field_v3_smem(const nm::CandArgs* a) {
  return nm_candidate_field_smem(a);
}

int nm_candidate_field_v3(const nm::CandArgs* a, void* stream) {
  return launch_cand(a->want_feat ? nm::candidate_field_v3_kernel<true>
                                  : nm::candidate_field_v3_kernel<false>,
                     a, stream);
}

int nm_candidate_field(const nm::CandArgs* a, void* stream) {
  return launch_cand(a->want_feat ? nm::candidate_field_kernel<true>
                                  : nm::candidate_field_kernel<false>,
                     a, stream);
}

const char* nm_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
