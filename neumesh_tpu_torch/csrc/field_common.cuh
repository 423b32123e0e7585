// Device code shared by field_fused.cu and secant_refine.cu: the NeuMesh
// field chain of neumesh_tpu/ops/pallas_kernels.py (_interp_distance,
// _feat_dot, _emb_cols, _emb_cols_rec, _density_mlp, the colour MLP of
// _field_kernel) for a block of SB samples against one tile's candidate
// context.
//
// Block shape: NT = 256 threads, SB = 32 samples. Candidate passes run
// LPS = 8 lanes per sample (consecutive lanes of one warp, reduced with
// width-8 shuffles); each lane strides over the C candidates and
// recomputes d2 in every pass instead of holding C values in registers.
// MLP layers run thread-per-output-column over the block's 32 samples:
// the activations live in shared memory (read as float4 broadcasts),
// the weights are read from global memory (L2-resident, coalesced along
// the output column), 32 accumulators per thread.
//
// Numerics follow the TPU kernels, not the XLA path:
//  - candidate math in exact f32 element-wise arithmetic (__fmul_rn and
//    friends, never contracted into FMAs): xv, xx, d2 = max(xx+pp-2xv, 0);
//  - the tie-break d2*(1 + c*2e-7), lowest index first; the k-th smallest
//    by k masked-min passes ("remove everything <= the pass minimum");
//  - per-layer precision follows the weight dtype: a bf16 layer rounds its
//    inputs to bf16, products are exact in f32, accumulation f32, bias f32;
//  - scalar embeddings (d, view dirs) take cos(z) as sin(z + pi/2) with
//    freq = 2^(blk/2); in bf16 serving the feature embeddings use the
//    double-angle recursion in bf16 from f32 base sin/cos.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace nm {

constexpr int SB = 32;           // samples (rays) per block
constexpr int NT = 256;          // threads per block
constexpr int LPS = NT / SB;     // lanes per sample in candidate passes
constexpr int MAX_LAYERS = 8;    // ops/_build.py MAX_LAYERS
constexpr int KSEL = 16;         // frozen secant: at most 16 neighbours
constexpr float HALF_PI = 1.57079637f;   // float32(pi / 2)

enum Mode { DISTANCE = 0, DENSITY = 1, DENSITY_NABLA = 2, FULL = 3 };

// ---- argument blocks (mirrored by ctypes structures in ops/_build.py)
struct LayerDesc {
  const void* w;      // (K, N) row-major, float32 or bfloat16
  const float* b;     // (N,)
  int K, N, bf16;
  int split;          // first layer: rows [0, split) get the bias before
                      // rows [split, K); 0 for plain layers
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
  float w1;
  MLPDesc dens, col;
};
struct SecantArgs {
  const float *rays_o, *rays_d, *d_low, *d_high, *f_low, *f_high, *d_low_w,
      *d_high_w, *geo;
  const void* feat;
  float* out;
  int feat_bf16, R, B, T, C, F, k, n_iters, md, mfg, gd, lowp, ldx,
      rebracket, frozen;
  float w1, tau;
  MLPDesc dens;
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

__device__ __forceinline__ float softplus(float x) {  // jax.nn.softplus
  return fadd(fmaxf(x, 0.f), log1pf(expf(-fabsf(x))));
}
__device__ __forceinline__ float sigmoid(float x) {
  return fdiv(1.f, fadd(1.f, expf(-x)));
}
__device__ __forceinline__ float softplus100(float x) {
  const float bx = fmul(100.f, x);
  return bx > 20.f ? x : fdiv(softplus(bx), 100.f);
}
__device__ __forceinline__ float softplus100_grad(float x) {
  const float bx = fmul(100.f, x);
  return bx > 20.f ? 1.f : sigmoid(bx);
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
};

// geo: (8, C) rows [px py pz ix iy iz pp vn] in shared memory. Writes the
// normalised kNN weights of every candidate to Wrow (zeros off the kNN
// set; the one-hot argmin for the k = 1 distance proxy).
__device__ void interp_sample(const float* geo, int C, float x0, float x1,
                              float x2, float w1, int k, bool want_dh,
                              int lane, float* Wrow, Interp& out) {
  const float *px = geo, *py = geo + C, *pz = geo + 2 * C, *ix = geo + 3 * C,
              *iy = geo + 4 * C, *iz = geo + 5 * C, *pp = geo + 6 * C,
              *vn = geo + 7 * C;
  const float xx = fadd(fadd(fmul(x0, x0), fmul(x1, x1)), fmul(x2, x2));
  auto d2_at = [&](int c) {
    const float xv =
        fadd(fadd(fmul(x0, px[c]), fmul(x1, py[c])), fmul(x2, pz[c]));
    return fmaxf(fsub(fadd(xx, pp[c]), fmul(2.f, xv)), 0.f);
  };
  auto tb = [&](int c, float d2) {
    return fmul(d2, fadd(1.f, fmul((float)c, 2e-7f)));
  };
  auto xn_at = [&](int c) {
    return fadd(fadd(fmul(x0, ix[c]), fmul(x1, iy[c])), fmul(x2, iz[c]));
  };
  out.dh0 = out.dh1 = out.dh2 = 0.f;

  if (k == 1 && !want_dh) {
    // nearest-tangent-plane proxy: sums over the one-hot argmin set
    float m = INFINITY;
    for (int c = lane; c < C; c += LPS) m = fminf(m, tb(c, d2_at(c)));
    m = gmin(m);
    float d2s = 0.f, nvs = 0.f;
    for (int c = lane; c < C; c += LPS) {
      const float d2 = d2_at(c);
      const bool sel = tb(c, d2) <= m;
      if (sel) {
        d2s = fadd(d2s, d2);
        nvs = fadd(nvs, fsub(xn_at(c), vn[c]));
      }
      Wrow[c] = sel ? 1.f : 0.f;
    }
    d2s = gsum(d2s);
    nvs = gsum(nvs);
    const float dsel = sqrtf(fmaxf(d2s, 1e-20f));
    out.ds = fdiv(fadd(fmul(w1, nvs), fmul(dsel, d2s)), fadd(w1, dsel));
    return;
  }

  // k-th smallest tie-broken distance: pass i takes the minimum of what
  // passes 0..i-1 left (everything <= their minimum is removed)
  float thr = -INFINITY;
  for (int it = 0; it < k; ++it) {
    float m = INFINITY;
    for (int c = lane; c < C; c += LPS) {
      const float t = tb(c, d2_at(c));
      if (t > thr) m = fminf(m, t);
    }
    thr = gmin(m);
  }
  float sw = 0.f;
  for (int c = lane; c < C; c += LPS) {
    const float d2 = d2_at(c);
    if (tb(c, d2) <= thr) sw = fadd(sw, fdiv(1.f, fadd(sqrtf(d2), 1e-7f)));
  }
  sw = gsum(sw);
  float ds = 0.f, sB = 0.f, ax = 0.f, ay = 0.f, az = 0.f;
  for (int c = lane; c < C; c += LPS) {
    const float d2 = d2_at(c);
    float W = 0.f;
    if (tb(c, d2) <= thr) {
      const float d0 = sqrtf(d2);
      W = fdiv(fdiv(1.f, fadd(d0, 1e-7f)), sw);
      const float d = fmaxf(d0, 1e-10f);
      const float inv = fdiv(1.f, fadd(w1, d));
      const float term = fadd(fmul(w1, fsub(xn_at(c), vn[c])), fmul(d, d2));
      ds = fadd(ds, fmul(fmul(W, term), inv));
      if (want_dh) {
        const float A = fmul(W, fmul(w1, inv));
        const float Bc = fdiv(
            fmul(fmul(fmul(W, fsub(fmul(fmul(3.f, d2), fadd(w1, d)), term)),
                      inv),
                 inv),
            d);
        sB = fadd(sB, Bc);
        ax = fadd(ax, fsub(fmul(A, ix[c]), fmul(Bc, px[c])));
        ay = fadd(ay, fsub(fmul(A, iy[c]), fmul(Bc, py[c])));
        az = fadd(az, fsub(fmul(A, iz[c]), fmul(Bc, pz[c])));
      }
    }
    Wrow[c] = W;
  }
  out.ds = gsum(ds);
  if (want_dh) {
    sB = gsum(sB);
    out.dh0 = fadd(gsum(ax), fmul(sB, x0));
    out.dh1 = fadd(gsum(ay), fmul(sB, x1));
    out.dh2 = fadd(gsum(az), fmul(sB, x2));
  }
}

// ---------------------------------------------------------------------------
// block-level stages (every thread of the block calls them)
// ---------------------------------------------------------------------------

// kNN feature blend FB[s][f] = sum_c W[s][c] feat[c][f] for f < Fb (FB row
// stride F, the feature row length); with bf16 features the weights are
// rounded to bf16 first.
__device__ void blend_stage(const void* feat, size_t feat_off, int fbf, int F,
                            int Fb, const float* sW, int C, float* sFB) {
  for (int idx = threadIdx.x; idx < SB * Fb; idx += NT) {
    const int s = idx / Fb, f = idx % Fb;
    const float* wr = sW + s * C;
    float acc = 0.f;
    for (int c = 0; c < C; ++c) {
      const float w = wr[c];
      if (w != 0.f)
        acc = fmaf(fbf ? rbf(w) : w,
                   ldfeat(feat, fbf, feat_off + (size_t)c * F + f), acc);
    }
    sFB[s * F + f] = acc;
  }
}

// Feature embedding columns of D-wide inputs src[s][0..D) into
// X[s][x0 + j], j < 2*nf*D, order [sin f0 (D), cos f0 (D), sin f1, ...]:
// bf16 double-angle recursion (lowp) or the exact tiled sin.
__device__ void feature_emb(const float* src, int ld_src, int D, int nf,
                            int lowp, float* X, int ldx, int x0, int r0) {
  if (nf <= 0) return;
  if (lowp) {
    for (int idx = threadIdx.x; idx < SB * D; idx += NT) {
      const int s = idx / D, i = idx % D;
      const float x = rbf(src[s * ld_src + i]);
      float sn = rbf(sinf(x)), cs = rbf(cosf(x));
      float* row = X + s * ldx + x0;
      for (int p = 0; p < nf; ++p) {
        if (p > 0) {
          const float s2 = rbf(fmul(rbf(fmul(2.f, sn)), cs));
          const float c2 = rbf(fsub(rbf(fmul(cs, cs)), rbf(fmul(sn, sn))));
          sn = s2;
          cs = c2;
        }
        row[(2 * p) * D + i] = rnd(sn, r0);
        row[(2 * p + 1) * D + i] = rnd(cs, r0);
      }
    }
  } else {
    const int n = 2 * nf * D;
    for (int idx = threadIdx.x; idx < SB * n; idx += NT) {
      const int s = idx / n, j = idx % n;
      X[s * ldx + x0 + j] =
          rnd(emb_col(src[s * ld_src + j % D], j / D, nullptr), r0);
    }
  }
}

template <bool TANG>
__device__ __forceinline__ void dense_accum(const LayerDesc& L,
                                            const float* X, const float* T,
                                            int ldx, int xoff2, int j,
                                            float (&acc)[SB],
                                            float (&tacc)[SB]) {
  const int N = L.N;
  const int K1 = L.split ? L.split : L.K;
#pragma unroll
  for (int s = 0; s < SB; ++s) {
    acc[s] = 0.f;
    if (TANG) tacc[s] = 0.f;
  }
  int k = 0;
  for (; k + 4 <= K1; k += 4) {
    const float w0 = ldw(L, (k + 0) * N + j), w1 = ldw(L, (k + 1) * N + j),
                w2 = ldw(L, (k + 2) * N + j), w3 = ldw(L, (k + 3) * N + j);
#pragma unroll
    for (int s = 0; s < SB; ++s) {
      const float4 x = *reinterpret_cast<const float4*>(X + s * ldx + k);
      acc[s] = fmaf(x.w, w3, fmaf(x.z, w2, fmaf(x.y, w1, fmaf(x.x, w0, acc[s]))));
      if (TANG) {
        const float4 t = *reinterpret_cast<const float4*>(T + s * ldx + k);
        tacc[s] = fmaf(t.w, w3, fmaf(t.z, w2, fmaf(t.y, w1, fmaf(t.x, w0, tacc[s]))));
      }
    }
  }
  for (; k < K1; ++k) {
    const float w = ldw(L, k * N + j);
#pragma unroll
    for (int s = 0; s < SB; ++s) {
      acc[s] = fmaf(X[s * ldx + k], w, acc[s]);
      if (TANG) tacc[s] = fmaf(T[s * ldx + k], w, tacc[s]);
    }
  }
  const float bj = L.b[j];
#pragma unroll
  for (int s = 0; s < SB; ++s) acc[s] = fadd(acc[s], bj);
  if (!L.split) return;
  // second row block (first layers): X columns from the aligned xoff2
  const int K2 = L.K - L.split;
  k = 0;
  for (; k + 4 <= K2; k += 4) {
    const int r = L.split + k;
    const float w0 = ldw(L, (r + 0) * N + j), w1 = ldw(L, (r + 1) * N + j),
                w2 = ldw(L, (r + 2) * N + j), w3 = ldw(L, (r + 3) * N + j);
#pragma unroll
    for (int s = 0; s < SB; ++s) {
      const float4 x =
          *reinterpret_cast<const float4*>(X + s * ldx + xoff2 + k);
      acc[s] = fmaf(x.w, w3, fmaf(x.z, w2, fmaf(x.y, w1, fmaf(x.x, w0, acc[s]))));
    }
  }
  for (; k < K2; ++k) {
    const float w = ldw(L, (L.split + k) * N + j);
#pragma unroll
    for (int s = 0; s < SB; ++s) acc[s] = fmaf(X[s * ldx + xoff2 + k], w, acc[s]);
  }
}

enum Act { ACT_SOFTPLUS = 0, ACT_RELU = 1 };

// One hidden layer in place on X (and the tangent T): out column j by
// thread j; inputs are rounded for the NEXT layer's dtype on write.
__device__ void dense_layer(const LayerDesc& L, float* X, float* T, int ldx,
                            int xoff2, int act, int next_bf, bool tang) {
  const int j = threadIdx.x;
  const bool active = j < L.N;
  float acc[SB], tacc[SB];
  if (active) {
    if (tang)
      dense_accum<true>(L, X, T, ldx, xoff2, j, acc, tacc);
    else
      dense_accum<false>(L, X, T, ldx, xoff2, j, acc, tacc);
  }
  __syncthreads();   // every input read before any output lands
  if (active) {
#pragma unroll
    for (int s = 0; s < SB; ++s) {
      const float pre = acc[s];
      float h;
      if (act == ACT_SOFTPLUS) {
        h = softplus100(pre);
        if (tang)
          T[s * ldx + j] = rnd(fmul(tacc[s], softplus100_grad(pre)), next_bf);
      } else {
        h = fmaxf(pre, 0.f);
      }
      X[s * ldx + j] = rnd(h, next_bf);
    }
  }
  __syncthreads();
}

// Output layer with N <= a few columns: LPS lanes per sample split K.
__device__ void head_layer(const LayerDesc& L, const float* X, const float* T,
                           int ldx, bool tang, bool sigm, float* out,
                           float* tout) {
  const int s = threadIdx.x / LPS, lane = threadIdx.x % LPS;
  for (int n = 0; n < L.N; ++n) {
    float a = 0.f;
    for (int k = lane; k < L.K; k += LPS)
      a = fmaf(X[s * ldx + k], ldw(L, k * L.N + n), a);
    a = gsum(a);
    const float v = fadd(a, L.b[n]);
    if (lane == 0) out[s * L.N + n] = sigm ? sigmoid(v) : v;
  }
  if (tang) {
    float t = 0.f;
    for (int k = lane; k < L.K; k += LPS)
      t = fmaf(T[s * ldx + k], ldw(L, k * L.N), t);
    t = gsum(t);
    if (lane == 0) tout[s] = t;
  }
  __syncthreads();
}

// Density MLP of _density_mlp: inputs [ds, d cols, fg | fg_emb], softplus
// (beta 100) hidden layers, linear head; with `tang` the forward tangent
// dD/dh through [1, d col derivatives]. sFB holds the blended features
// (fg = its first gd columns, row stride ldfb).
__device__ void density_stage(const MLPDesc& D, float* sX, float* sT,
                              int ldx, const float* sds, const float* sFB,
                              int ldfb, int md, int mfg, int gd, int lowp,
                              bool tang, float* sdens, float* sdDdh) {
  const LayerDesc& L0 = D.l[0];
  const int r0 = L0.bf16;
  const int nd = 1 + 2 * (md > 0 ? md : 0);
  const int split = L0.split;                 // nd + gd
  const int xoff2 = (split + 3) & ~3;
  for (int idx = threadIdx.x; idx < SB * xoff2; idx += NT) {
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
    sX[s * ldx + j] = rnd(v, r0);
    if (tang) sT[s * ldx + j] = rnd(j < nd ? dv : 0.f, r0);
  }
  feature_emb(sFB, ldfb, gd, mfg, lowp, sX, ldx, xoff2, r0);
  __syncthreads();
  for (int l = 0; l < D.n - 1; ++l)
    dense_layer(D.l[l], sX, sT, ldx, l == 0 ? xoff2 : 0, ACT_SOFTPLUS,
                D.l[l + 1].bf16, tang);
  head_layer(D.l[D.n - 1], sX, sT, ldx, tang, false, sdens, sdDdh);
}

// Colour MLP of _field_kernel: inputs [nabla, d_emb, vdir, view_emb, ft |
// ft_emb], ReLU hidden layers, sigmoid head.
__device__ void color_stage(const MLPDesc& Cm, float* sX, int ldx,
                            const float* sds, const float* sdh,
                            const float* sdDdh, const float* sdir,
                            const float* sFB, int ldfb, int gd, int cd,
                            int md, int mft, int mv, int lowp, float* srgb) {
  const LayerDesc& L0 = Cm.l[0];
  const int r0 = L0.bf16;
  const int nd = 1 + 2 * (md > 0 ? md : 0);
  const int nv = 6 * (mv > 0 ? mv : 0);
  const int split = L0.split;                 // 3 + nd + 3 + nv + cd
  const int xoff2 = (split + 3) & ~3;
  for (int idx = threadIdx.x; idx < SB * xoff2; idx += NT) {
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
    sX[s * ldx + j] = rnd(v, r0);
  }
  feature_emb(sFB + gd, ldfb, cd, mft, lowp, sX, ldx, xoff2, r0);
  __syncthreads();
  for (int l = 0; l < Cm.n - 1; ++l)
    dense_layer(Cm.l[l], sX, nullptr, ldx, l == 0 ? xoff2 : 0, ACT_RELU,
                Cm.l[l + 1].bf16, false);
  head_layer(Cm.l[Cm.n - 1], sX, nullptr, ldx, false, true, srgb, nullptr);
}

}  // namespace nm
