// field_distance: field_fused's distance mode, the interpolated signed
// distance of each sample and nothing else (no features, no MLP).
//
// Replaces neumesh_tpu/ops/pallas_kernels.py::_field_kernel at want =
// "distance" (wrapper field_fused, pl.pallas_call at :916; the
// interpolation _interp_distance, :488, with want_dh False). Per sample,
// against its context's C candidates (geo rows [px py pz ix iy iz pp vn]):
// d2 = max((|x|^2 + pp) - 2 x.p, 0) in exact f32 (field_common.cuh
// point_d2), the tie-broken tb = d2 (1 + c 2e-7), then
//  - k = 1 (the serving scan): every candidate at the least tb counts;
//    d2s and nvs = sum(x.n - vn) over them, dsel = sqrt(max(d2s, 1e-20)),
//    ds = (w1 nvs + dsel d2s) / (w1 + dsel);
//  - k > 1: thr = the k-th distinct tb (k masked-min passes), the picks
//    tb <= thr, W = w / sum(w) with w = 1 / (sqrt(d2) + 1e-7), ds =
//    sum(W (w1 (x.n - vn) + d d2) / (w1 + d)), d = max(sqrt(d2), 1e-10).
// Sums run over the picks in ascending candidate order.
//
// What bounds it on the H100: ~11 exact-f32 operations a candidate and
// sample (no FMA contraction; 15 with the k = 1 bookkeeping) against 12
// bytes in and 4 out a sample: the CUDA cores' issue rate. The design: a
// thread a sample, DT = 128 threads a block. A block owns one context (S
// >= DT samples a context: SPT samples a thread, ceil(S / (SPT DT)) blocks
// a context) or, below that, DT consecutive flat (context, row) rows of
// several contexts. Its contexts are staged in shared memory once, padded
// to whole 32-candidate words with candidates at infinity, as float4 {px
// py pz pp} and {ix iy iz vn} beside the tie factors: the lanes of a warp
// read the same candidate (a broadcast) and one load feeds a thread's SPT
// d2 chains; after the staging, no barrier and no shuffle. Where the
// contexts do not fit (64 KB: one context a row at S = 1) they are read
// from global memory (L2): at k = 1 by K1_LANES lanes a sample that merge
// by shuffles (a thread's C serial reads would be latency-bound), at k > 1
// by a thread a sample in blocks of one warp.
//  - k = 1: one scan keeps the least tb, the second least and the argmin;
//    a tie at the minimum (second == least) takes a second scan that sums
//    every candidate at the minimum.
//  - 2 <= k <= DL, C <= LIST_C: one scan keeps the DL least tb with
//    multiplicity in registers, merging 8 candidates at a time through
//    sorting networks (no branch: the warps' samples pick apart); when its
//    first k entries differ its k-th is the k-th distinct tb. A second scan
//    marks the picks in bit masks; the weights and terms visit the set
//    bits. Equal entries (ties at the threshold) take the general path.
//  - otherwise: k masked-min scans, then a scan for the weights' sum and
//    one for the terms.
#include "field_common.cuh"

namespace nm {

constexpr int DT = 128;      // threads a distance block (ops/_build.py DT)
constexpr int DT_L2 = 32;    // ... reading its contexts from L2 at k > 1:
                             // one warp, so that small calls spread over
                             // the SMs
constexpr int DL = 8;        // the sorted list of the 2 <= k <= DL scan
constexpr int SPT_K1 = 8;    // samples a thread at most, k = 1
constexpr int SPT_LIST = 2;  // and with the list
constexpr size_t DIST_SMEM = 64 * 1024;   // staged contexts, at most

// A thread's candidates: staged in shared memory, or its context (8, C)
// in global memory.
struct StagedCands {
  const float4 *p, *n;
  const float* tf;
  __device__ float4 pos(int c) const { return p[c]; }   // px py pz pp
  __device__ float4 ind(int c) const { return n[c]; }   // ix iy iz vn
  __device__ float tie(int c) const { return tf[c]; }
  // candidates c0 .. c0 + 3 (c0 a multiple of 4; the pads beyond C)
  __device__ void pos4(int c0, float4 (&q)[4]) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) q[i] = p[c0 + i];
  }
};
// A pad candidate: pp at infinity, so d2 and tb are infinite (never a
// pick, never below a finite threshold).
__device__ __forceinline__ float4 pad_pos() {
  return make_float4(0.f, 0.f, 0.f, INFINITY);
}
struct GlobalCands {
  const float* g;
  int C;
  __device__ float4 pos(int c) const {
    if (c >= C) return pad_pos();
    return make_float4(__ldg(g + c), __ldg(g + C + c), __ldg(g + 2 * C + c),
                       __ldg(g + 6 * C + c));
  }
  __device__ float4 ind(int c) const {
    return make_float4(__ldg(g + 3 * C + c), __ldg(g + 4 * C + c),
                       __ldg(g + 5 * C + c), __ldg(g + 7 * C + c));
  }
  __device__ float tie(int c) const { return tie_factor(c); }
  __device__ void pos4(int c0, float4 (&q)[4]) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) q[i] = pos(c0 + i);
  }
};
struct Sample {
  float x0, x1, x2, xx;
  __device__ float d2(const float4& p) const {
    return point_d2(p.x, p.y, p.z, p.w, x0, x1, x2, xx);
  }
  __device__ float xn_vn(const float4& n) const {   // x.n - vn
    return fsub(fadd(fadd(fmul(x0, n.x), fmul(x1, n.y)), fmul(x2, n.z)),
                n.w);
  }
};

// A pick's term of ds, its raw weight rw = 1 / (sqrt(d2) + 1e-7) and the
// raw weights' sum sw given.
__device__ __forceinline__ float pick_term(const Sample& s, const float4& n,
                                           float d2, float rw, float sw,
                                           float w1) {
  const float W = fdiv(rw, sw);
  const float d = fmaxf(sqrtf(d2), 1e-10f);
  const float inv = fdiv(1.f, fadd(w1, d));
  const float term = fadd(fmul(w1, s.xn_vn(n)), fmul(d, d2));
  return fmul(fmul(W, term), inv);
}

// ---- the general path (k > DL, and the list's ties): per sample
// the k-th distinct tie-broken d2 by k masked-min scans
template <class Cands>
__device__ float kth_distinct(const Cands cd, int C, const Sample s, int k) {
  float thr = -INFINITY;
  for (int it = 0; it < k && thr < INFINITY; ++it) {
    float m = INFINITY;
    for (int c = 0; c < C; ++c) {
      const float t = fmul(s.d2(cd.pos(c)), cd.tie(c));
      if (t > thr) m = fminf(m, t);
    }
    thr = m;
  }
  return thr;
}
// ds over every candidate with tie-broken d2 <= thr: a scan for the sum of
// the raw weights, one for the terms
template <class Cands>
__device__ float interp_scan(const Cands cd, int C, const Sample s,
                             float thr, float w1) {
  float sw = 0.f;
  for (int c = 0; c < C; ++c) {
    const float d2 = s.d2(cd.pos(c));
    if (fmul(d2, cd.tie(c)) <= thr) sw = fadd(sw, raw_weight(d2));
  }
  float ds = 0.f;
  for (int c = 0; c < C; ++c) {
    const float d2 = s.d2(cd.pos(c));
    if (fmul(d2, cd.tie(c)) <= thr)
      ds = fadd(ds, pick_term(s, cd.ind(c), d2, raw_weight(d2), sw, w1));
  }
  return ds;
}

// ---- k = 1
// ds from the scan's least tb m, second least m2 and argmin cm: the argmin
// alone, or (m2 == m) every candidate tied at the minimum, summed in
// ascending order
template <class Cands>
__device__ float k1_result(const Cands& cd, int C, const Sample& s, float m,
                           float m2, int cm, float w1) {
  float d2s, nvs;
  if (m2 > m) {
    d2s = s.d2(cd.pos(cm));
    nvs = s.xn_vn(cd.ind(cm));
  } else {
    d2s = nvs = 0.f;
    for (int c = 0; c < C; ++c) {
      const float d2 = s.d2(cd.pos(c));
      if (fmul(d2, cd.tie(c)) <= m) {
        d2s = fadd(d2s, d2);
        nvs = fadd(nvs, s.xn_vn(cd.ind(c)));
      }
    }
  }
  const float dsel = sqrtf(fmaxf(d2s, 1e-20f));
  return fdiv(fadd(fmul(w1, nvs), fmul(dsel, d2s)), fadd(w1, dsel));
}
template <int SPT, class Cands>
__device__ __forceinline__ void scan_k1(const Cands& cd, int C,
                                        const Sample (&s)[SPT], float w1,
                                        float (&ds)[SPT]) {
  float m[SPT], m2[SPT];
  int cm[SPT];
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    m[j] = m2[j] = INFINITY;
    cm[j] = 0;
  }
  // four candidates a step, up to C rounded to 4 (the pads lie at
  // infinity: they move nothing)
  for (int c0 = 0; c0 < C; c0 += 4) {
    float4 p[4];
    cd.pos4(c0, p);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float f = cd.tie(c0 + i);
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        const float t = fmul(s[j].d2(p[i]), f);
        cm[j] = t < m[j] ? c0 + i : cm[j];
        m2[j] = fminf(m2[j], fmaxf(m[j], t));
        m[j] = fminf(m[j], t);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < SPT; ++j) ds[j] = k1_result(cd, C, s[j], m[j], m2[j],
                                                  cm[j], w1);
}

// ---- 2 <= k <= DL, C <= LIST_C
__device__ __forceinline__ float list_at(const float (&L)[DL], int i) {
  float v = L[0];
#pragma unroll
  for (int q = 1; q < DL; ++q) v = q == i ? L[q] : v;
  return v;
}
// a <= b after it
__device__ __forceinline__ void cas(float& a, float& b) {
  const float lo = fminf(a, b);
  b = fmaxf(a, b);
  a = lo;
}
// ascending: an optimal 19-comparator network
__device__ __forceinline__ void sort8(float (&v)[8]) {
  cas(v[0], v[2]); cas(v[1], v[3]); cas(v[4], v[6]); cas(v[5], v[7]);
  cas(v[0], v[4]); cas(v[1], v[5]); cas(v[2], v[6]); cas(v[3], v[7]);
  cas(v[0], v[1]); cas(v[2], v[3]); cas(v[4], v[5]); cas(v[6], v[7]);
  cas(v[2], v[4]); cas(v[3], v[5]);
  cas(v[1], v[4]); cas(v[3], v[6]);
  cas(v[1], v[2]); cas(v[3], v[4]); cas(v[5], v[6]);
}
// L (ascending) becomes the DL least of L and N (ascending), with
// multiplicity: the elementwise minimum against N reversed is bitonic,
// then a bitonic sort
__device__ __forceinline__ void merge8(float (&L)[8], const float (&N)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) L[i] = fminf(L[i], N[7 - i]);
  cas(L[0], L[4]); cas(L[1], L[5]); cas(L[2], L[6]); cas(L[3], L[7]);
  cas(L[0], L[2]); cas(L[1], L[3]); cas(L[4], L[6]); cas(L[5], L[7]);
  cas(L[0], L[1]); cas(L[2], L[3]); cas(L[4], L[5]); cas(L[6], L[7]);
}
static_assert(DL == 8, "the list's networks are for 8 entries");
constexpr int LIST_C = 128;     // candidates of the list scan, at most: its
                                // picks as LIST_C / 32 bit masks

// C rounded up to whole 32-candidate words; the staged contexts' stride
// (their pad candidates lie at infinity)
__host__ __device__ inline int padded(int C) { return (C + 31) & ~31; }

template <int SPT, class Cands>
__device__ __forceinline__ void scan_list(const Cands& cd, int C,
                                          const Sample (&s)[SPT], float w1,
                                          int k, float (&ds)[SPT]) {
  const int CP = padded(C);
  // the DL least tb with multiplicity, 8 candidates at a time; thr its
  // k-th entry, the k-th distinct tb where its first k entries differ
  float thr[SPT];
  bool general[SPT];
  {
    float L[SPT][DL];
#pragma unroll
    for (int j = 0; j < SPT; ++j)
#pragma unroll
      for (int i = 0; i < DL; ++i) L[j][i] = INFINITY;
    for (int c0 = 0; c0 < CP; c0 += 8) {
      float N[SPT][8];
#pragma unroll
      for (int h = 0; h < 8; h += 4) {
        float4 p[4];
        cd.pos4(c0 + h, p);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float f = cd.tie(c0 + h + i);
#pragma unroll
          for (int j = 0; j < SPT; ++j)
            N[j][h + i] = fmul(s[j].d2(p[i]), f);
        }
      }
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        sort8(N[j]);
        merge8(L[j], N[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      thr[j] = list_at(L[j], k - 1);
      general[j] = !(thr[j] < INFINITY);
#pragma unroll
      for (int i = 0; i + 1 < DL; ++i)
        if (i + 1 < k && !(L[j][i] < L[j][i + 1])) general[j] = true;
    }
  }
  // the picks tb <= thr as bit masks, candidate 32 w + b at bit b of word w
  unsigned mk[SPT][LIST_C / 32];
#pragma unroll
  for (int w = 0; w < LIST_C / 32; ++w) {
#pragma unroll
    for (int j = 0; j < SPT; ++j) mk[j][w] = 0u;
    if (32 * w < CP) {
#pragma unroll
      for (int b0 = 0; b0 < 32; b0 += 4) {
        float4 p[4];
        cd.pos4(32 * w + b0, p);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float f = cd.tie(32 * w + b0 + i);
#pragma unroll
          for (int j = 0; j < SPT; ++j)
            if (fmul(s[j].d2(p[i]), f) <= thr[j]) mk[j][w] |= 1u << (b0 + i);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    if (general[j]) {
      ds[j] = interp_scan(cd, C, s[j], kth_distinct(cd, C, s[j], k), w1);
      continue;
    }
    float sw = 0.f;
#pragma unroll
    for (int w = 0; w < LIST_C / 32; ++w)
      for (unsigned m = mk[j][w]; m; m &= m - 1)
        sw = fadd(sw, raw_weight(s[j].d2(cd.pos(32 * w + __ffs(m) - 1))));
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < LIST_C / 32; ++w)
      for (unsigned m = mk[j][w]; m; m &= m - 1) {
        const int c = 32 * w + __ffs(m) - 1;
        const float d2 = s[j].d2(cd.pos(c));
        acc = fadd(acc, pick_term(s[j], cd.ind(c), d2, raw_weight(d2), sw,
                                  w1));
      }
    ds[j] = acc;
  }
}

// the scan of a call
enum { SCAN_PASSES = 0, SCAN_K1 = 1, SCAN_LIST = 2 };
__host__ __device__ inline int dist_scan(int k, int C) {
  return k == 1 ? SCAN_K1 : k <= DL && C <= LIST_C ? SCAN_LIST : SCAN_PASSES;
}

// Shared memory staging nctx contexts of C candidates (padded): two float4
// a candidate and context, and the tie factors.
__host__ __device__ inline size_t dist_smem(int C, int nctx) {
  return ((size_t)nctx * 2 * sizeof(float4) + sizeof(float)) * padded(C);
}

// k = 1 from L2 with K1_LANES lanes a sample (consecutive lanes of a
// warp): lane l scans candidates l, l + K1_LANES, ...; the least, second
// least and argmin merge over the lanes by xor shuffles (the two least of
// a union: min of the minima, min of the seconds and the larger minimum),
// so that every lane ends with the sample's ds. A thread a sample would
// leave each thread C serial reads of its own context (the per-ray calls'
// S = 1: latency-bound).
constexpr int K1_LANES = 8;
__device__ float scan_k1_lanes(const GlobalCands& cd, int C, const Sample& s,
                               float w1, int lane) {
  float m = INFINITY, m2 = INFINITY;
  int cm = 0;
  for (int c = lane; c < C; c += K1_LANES) {
    const float t = fmul(s.d2(cd.pos(c)), cd.tie(c));
    cm = t < m ? c : cm;
    m2 = fminf(m2, fmaxf(m, t));
    m = fminf(m, t);
  }
#pragma unroll
  for (int o = K1_LANES / 2; o > 0; o >>= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, o, K1_LANES);
    const float m2o = __shfl_xor_sync(0xffffffffu, m2, o, K1_LANES);
    const int co = __shfl_xor_sync(0xffffffffu, cm, o, K1_LANES);
    m2 = fminf(fminf(m2, m2o), fmaxf(m, mo));
    cm = mo < m || (mo == m && co < cm) ? co : cm;
    m = fminf(m, mo);
  }
  return k1_result(cd, C, s, m, m2, cm, w1);
}

// A call's blocks (mirrored by ops/kernels.py::distance_block_plan).
struct DistPlan {
  int one;          // S >= DT: one context a block
  int nctx;         // the most contexts a block of DT rows spans
  int staged;       // the contexts in shared memory (else read from L2)
  int nt;           // threads a block
  int lanes;        // threads a sample
  int spt;          // samples a thread
  size_t smem;      // shared memory a block
  long long blocks;
};
inline DistPlan dist_plan(int B, int S, int C, int k) {
  DistPlan p;
  p.one = S >= DT;
  p.nctx = p.one ? 1 : 1 + (DT - 1 + S - 1) / S;
  if (p.nctx > B) p.nctx = B;
  p.staged = dist_smem(C, p.nctx) <= DIST_SMEM;
  const int scan = dist_scan(k, C);
  p.lanes = !p.staged && scan == SCAN_K1 ? K1_LANES : 1;
  p.nt = p.staged || p.lanes > 1 ? DT : DT_L2;
  const int most = !p.staged            ? 1
                   : scan == SCAN_K1    ? SPT_K1
                   : scan == SCAN_LIST  ? SPT_LIST
                                        : 1;
  p.spt = 1;
  while (p.spt * 2 <= most && S >= p.spt * 2 * DT) p.spt *= 2;
  const int rows = p.nt / p.lanes, rb = p.spt * rows;
  p.blocks = p.one ? (long long)B * ((S + rb - 1) / rb)
                   : ((long long)B * S + rows - 1) / rows;
  p.smem = p.staged ? dist_smem(C, p.nctx) : 0;
  return p;
}
__host__ __device__ inline bool dist_rows_ok(int B, int S) {
  return B > 0 && S > 0 && (long long)B * S <= INT_MAX - SPT_K1 * DT;
}

// ---- the kernel: SCAN, SPT samples a thread, L2: contexts read from
// global memory (k = 1: K1_LANES lanes a sample in blocks of DT threads,
// else one lane in blocks of DT_L2)
template <int SCAN, int SPT, bool L2>
__global__ void __launch_bounds__(L2 && SCAN != SCAN_K1 ? DT_L2 : DT)
    field_distance_kernel(const __grid_constant__ FieldArgs a) {
  constexpr int LN = L2 && SCAN == SCAN_K1 ? K1_LANES : 1;
  constexpr int NT = L2 && LN == 1 ? DT_L2 : DT;
  constexpr int ROWS = NT / LN;   // a block's samples (of each of SPT)
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = a.S, C = a.C, t = threadIdx.x, q = t / LN, lane = t % LN;
  // the block's contexts [first, first + count) and this thread's: its
  // context and first row (its others ROWS rows apart)
  int first, count, ctx, row;
  bool live;
  if (S >= DT) {
    const int per = (S + SPT * ROWS - 1) / (SPT * ROWS);
    first = blockIdx.x / per;
    count = 1;
    ctx = first;
    row = (blockIdx.x - first * per) * (SPT * ROWS) + q;
    live = row < S;
  } else {
    const int n = a.B * S, g0 = blockIdx.x * ROWS, g = g0 + q;
    first = g0 / S;
    count = (min(g0 + ROWS, n) - 1) / S - first + 1;
    live = g < n;
    ctx = live ? g / S : first;
    row = g - ctx * S;
  }
  // staged: CP candidates a context, those from C on the pad at infinity
  const int CP = padded(C);
  const float* geo = a.geo + (size_t)ctx * 8 * C;
  float4* sp = reinterpret_cast<float4*>(smem);
  float4* sn = sp + (size_t)count * CP;
  float* tf = reinterpret_cast<float*>(sn + (size_t)count * CP);
  if constexpr (!L2) {
    const float* src = a.geo + (size_t)first * 8 * C;
    for (int i = t; i < count * CP; i += NT) {
      const int b = i / CP, c = i - b * CP;
      const float* r = src + (size_t)b * 8 * C + c;
      sp[i] = c < C ? make_float4(r[0], r[C], r[2 * C], r[6 * C])
                    : pad_pos();
      sn[i] = c < C ? make_float4(r[3 * C], r[4 * C], r[5 * C], r[7 * C])
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int c = t; c < CP; c += NT) tf[c] = tie_factor(c);
    __syncthreads();
  }
  if (LN == 1 && !live) return;   // lanes of a sample shuffle together

  Sample s[SPT];
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    const int r = row + j * ROWS;
    const bool on = live && r < S;   // a ragged sample computes on zeros
    const size_t o = ((size_t)ctx * S + (on ? r : 0)) * 3;
    s[j].x0 = on ? a.xyz[o] : 0.f;
    s[j].x1 = on ? a.xyz[o + 1] : 0.f;
    s[j].x2 = on ? a.xyz[o + 2] : 0.f;
    s[j].xx = sq_norm(s[j].x0, s[j].x1, s[j].x2);
  }
  float ds[SPT];
  auto run = [&](const auto& cd) {
    if constexpr (SCAN == SCAN_K1) {
      if constexpr (LN > 1)
        ds[0] = scan_k1_lanes(cd, C, s[0], a.w1, lane);
      else
        scan_k1<SPT>(cd, C, s, a.w1, ds);
    } else if constexpr (SCAN == SCAN_LIST) {
      scan_list<SPT>(cd, C, s, a.w1, a.k, ds);
    } else {
#pragma unroll
      for (int j = 0; j < SPT; ++j)
        ds[j] = interp_scan(cd, C, s[j], kth_distinct(cd, C, s[j], a.k),
                            a.w1);
    }
  };
  if constexpr (L2) {
    run(GlobalCands{geo, C});
  } else {
    const int o = (ctx - first) * CP;
    run(StagedCands{sp + o, sn + o, tf});
  }
#pragma unroll
  for (int j = 0; j < SPT; ++j)
    if (live && lane == 0 && row + j * ROWS < S)
      a.out[(size_t)ctx * S + row + j * ROWS] = ds[j];
}

using DistKernel = void (*)(FieldArgs);
template <int SPT>
inline DistKernel k1_kernel(int spt) {
  if constexpr (SPT == 1) {
    return field_distance_kernel<SCAN_K1, 1, false>;
  } else {
    return spt == SPT ? field_distance_kernel<SCAN_K1, SPT, false>
                      : k1_kernel<SPT / 2>(spt);
  }
}
inline DistKernel pick_distance_kernel(const DistPlan& p, int k, int C) {
  const int scan = dist_scan(k, C);
  if (!p.staged)
    return scan == SCAN_K1     ? field_distance_kernel<SCAN_K1, 1, true>
           : scan == SCAN_LIST ? field_distance_kernel<SCAN_LIST, 1, true>
                               : field_distance_kernel<SCAN_PASSES, 1, true>;
  if (scan == SCAN_K1) return k1_kernel<SPT_K1>(p.spt);
  if (scan == SCAN_LIST)
    return p.spt == 2 ? field_distance_kernel<SCAN_LIST, 2, false>
                      : field_distance_kernel<SCAN_LIST, 1, false>;
  return field_distance_kernel<SCAN_PASSES, 1, false>;
}
static_assert((SPT_K1 & (SPT_K1 - 1)) == 0 && SPT_LIST == 2,
              "samples a thread: a power of two");
static_assert(DT % K1_LANES == 0 && 32 % K1_LANES == 0,
              "a sample's lanes in one warp");

}  // namespace nm

extern "C" {

size_t nm_field_distance_smem(const nm::FieldArgs* a) {
  if (!nm::dist_rows_ok(a->B, a->S) || a->C < 1 || a->k < 1) return 0;
  const nm::DistPlan p = nm::dist_plan(a->B, a->S, a->C, a->k);
  return p.smem;
}

int nm_field_distance(const nm::FieldArgs* a, void* stream) {
  if (a->B <= 0 || a->S <= 0) return 0;
  if (!nm::dist_rows_ok(a->B, a->S) || a->C < 1 || a->k < 1 ||
      a->mode != nm::DISTANCE)
    return (int)cudaErrorInvalidValue;
  const nm::DistPlan p = nm::dist_plan(a->B, a->S, a->C, a->k);
  const size_t smem = p.smem;
  auto kernel = nm::pick_distance_kernel(p, a->k, a->C);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3((unsigned)p.blocks), p.nt, smem, (cudaStream_t)stream>>>(
      *a);
  return (int)cudaGetLastError();
}

const char* nm_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
