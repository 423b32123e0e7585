// candidate_bounds: each ray's near/far tightened to where it passes within
// distance_thresh of one of its tile's candidate vertices.
//
// Replaces no TPU kernel: neumesh_tpu/models/neumesh/model.py::
// candidate_bounded_near_far_tiled is plain jnp, and so is the port's plain
// version (ops/kernels.py::candidate_bounds_plain), which broadcasts every
// ray of a tile against every candidate of the tile into (tiles, T, C, 3)
// temporaries and makes ~34 launches over them. Per ray and candidate v:
// ov = v - o, t_c = <ov, d>, d_perp^2 = |ov|^2 - t_c^2, s^2 = thresh^2 -
// d_perp^2; a candidate with s^2 > 0 covers [t_c - s, t_c + s]. The ray's
// bounds are the least and the greatest covered depth (the 1e9 sentinel
// vertices of duplicate and missing ids take part as any other), clamped to
// its input [near, far]; a ray that nothing covers keeps its input bounds;
// a span under 0.1 widens by 0.05 each way.
//
// What bounds it on the H100: the CUDA cores, ~20 f32 operations a (ray,
// candidate) pair, at the 800 x 600 preview's 3,750 tiles of 128 rays and
// 128 candidates 61.4 M pairs (~0.02 ms at 67 TFLOP/s); its bytes (rays,
// near and far in and out, the candidates: ~25 MB, ~0.008 ms) do not. The
// design: a thread a ray, BR rays of one tile a block; the tile's
// candidates staged in shared memory BC at a time as float4 {x y z -},
// which every thread of the block reads at the same address (a broadcast);
// the least and greatest covered depth and whether any candidate covers
// the ray kept in registers. No temporaries, no atomics.
//
// Bit-equal to the plain version on the card: every step is the plain
// version's one rounded f32 operation (__fsub_rn, __fmul_rn, __fadd_rn,
// __fsqrt_rn: nothing contracts into an FMA), and each sum over the
// 3-vector adds in the order torch.sum(..., dim=-1) takes on the card for a
// last axis of 3, two lanes of a warp with the first holding elements 0 and
// 2: (a0 + a2) + a1. The minimum, the maximum and the clamp are exact.
#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>

namespace nm {

constexpr int BR = 128;   // rays (threads) a block
constexpr int BC = 256;   // candidates staged at a time

struct BoundsArgs {
  const float* rays_o;    // (R, 3)
  const float* rays_d;    // (R, 3)
  const float* near;      // (R,)
  const float* far;       // (R,)
  const float* pts;       // (R / T, C, 3): tile t's candidates
  float* out_near;        // (R,)
  float* out_far;         // (R,)
  int R, T, C;
  float thr2;             // distance_thresh^2, rounded once to f32
};

// torch.sum(x, dim=-1) of a contiguous (..., 3) f32 tensor on the card
__device__ __forceinline__ float sum3(float a0, float a1, float a2) {
  return __fadd_rn(__fadd_rn(a0, a2), a1);
}

__global__ void __launch_bounds__(BR) candidate_bounds_kernel(
    const BoundsArgs a) {
  __shared__ float4 sp[BC];
  // one 1-D grid over (tile, block of BR rays)
  const int bpt = (a.T + BR - 1) / BR;
  const int tile = blockIdx.x / bpt;
  const int t = (blockIdx.x % bpt) * BR + threadIdx.x;
  const bool live = t < a.T;
  const size_t r = (size_t)tile * a.T + t;
  float o0 = 0.f, o1 = 0.f, o2 = 0.f, d0 = 0.f, d1 = 0.f, d2 = 0.f;
  if (live) {
    o0 = a.rays_o[3 * r];
    o1 = a.rays_o[3 * r + 1];
    o2 = a.rays_o[3 * r + 2];
    d0 = a.rays_d[3 * r];
    d1 = a.rays_d[3 * r + 1];
    d2 = a.rays_d[3 * r + 2];
  }
  float lo = 1e10f, hi = -1e10f;
  bool hit = false;
  const float* P = a.pts + (size_t)tile * a.C * 3;
  for (int c0 = 0; c0 < a.C; c0 += BC) {
    const int n = min(BC, a.C - c0);
    __syncthreads();   // the previous slice is read
    for (int i = threadIdx.x; i < n; i += BR) {
      const float* p = P + 3 * (size_t)(c0 + i);
      sp[i] = make_float4(p[0], p[1], p[2], 0.f);
    }
    __syncthreads();
    if (!live) continue;
#pragma unroll 4
    for (int c = 0; c < n; ++c) {
      const float4 v = sp[c];
      const float v0 = __fsub_rn(v.x, o0);
      const float v1 = __fsub_rn(v.y, o1);
      const float v2 = __fsub_rn(v.z, o2);
      const float tc = sum3(__fmul_rn(v0, d0), __fmul_rn(v1, d1),
                            __fmul_rn(v2, d2));
      const float vv = sum3(__fmul_rn(v0, v0), __fmul_rn(v1, v1),
                            __fmul_rn(v2, v2));
      const float s2 = __fsub_rn(a.thr2, __fsub_rn(vv, __fmul_rn(tc, tc)));
      if (s2 > 0.f) {
        const float s = __fsqrt_rn(s2);
        lo = fminf(lo, __fsub_rn(tc, s));
        hi = fmaxf(hi, __fadd_rn(tc, s));
        hit = true;
      }
    }
  }
  if (!live) return;
  const float nr = a.near[r], fr = a.far[r];
  float nn = nr, ff = fr;
  if (hit) {
    nn = fminf(fmaxf(lo, nr), fr);
    ff = fminf(fmaxf(hi, nr), fr);
  }
  if (__fsub_rn(ff, nn) < 0.1f) {   // too close: widen
    ff = __fadd_rn(ff, 0.05f);
    nn = __fsub_rn(nn, 0.05f);
  }
  a.out_near[r] = nn;
  a.out_far[r] = ff;
}

}  // namespace nm

extern "C" {

// shared memory of a block (static)
size_t nm_candidate_bounds_smem(const nm::BoundsArgs*) {
  return sizeof(float4) * nm::BC;
}

int nm_candidate_bounds(const nm::BoundsArgs* a, void* stream) {
  if (a->R <= 0) return 0;
  if (a->T < 1 || a->R % a->T || a->C < 1) return (int)cudaErrorInvalidValue;
  const long long nblk =
      (long long)(a->R / a->T) * ((a->T + nm::BR - 1) / nm::BR);
  if (nblk > INT_MAX) return (int)cudaErrorInvalidValue;
  nm::candidate_bounds_kernel<<<dim3((unsigned)nblk), nm::BR, 0,
                                (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

const char* nm_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
