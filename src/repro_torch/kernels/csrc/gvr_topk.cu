// Exact GVR Top-K of a score row, warm-started from the previous step's
// Top-K — the Hopper form of kernel B1, and the chained selection half of
// kernel B9.
//
// Replaces: src/repro/kernels/gvr_topk.py:gvr_topk_pallas (body
// gvr_on_resident_row), and the GVR half of
// src/repro/kernels/indexer_topk.py:paged_indexer_topk_mq_pallas (kernel
// _paged_fused_mq_kernel, which threads each query row's Top-K into the
// next row's warm start through VMEM). On the TPU the row sat in VMEM
// and compaction went through an MXU one-hot contraction; here one CTA of
// 1024 threads owns a row and the phases are:
//   P0  load the row (into shared memory when it fits, else it is read
//       from global memory, where an 8K-float row is L2-resident) and take
//       its min/max;
//   P1  gather the predicted values: min / mean / max seed the bracket;
//   P2  secant threshold search for K <= |x >= T| <= C — each probe is one
//       counting sweep with a block reduction; the scalar bracket logic is
//       the JAX package's core/gvr.py `_phase2_secant`, run redundantly by
//       every thread so no broadcast is needed;
//   P3  ordered compaction of {x >= T} into a shared-memory candidate
//       buffer of <= C entries (warp ballot + block scan: the buffer keeps
//       ascending index order);
//   P4  exact K-th value by an 8-bit MSD radix select over the sortable
//       uint32 image (four histogram passes in shared memory);
//   P5  emit every x > T* and the lowest-index ties, in ascending index
//       order (a second ordered ballot scan).
// If more than C (or fewer than K) entries pass the phase-2 threshold —
// massive NEG ties whenever length < K — P4 and P5 run over the whole row
// instead of the buffer; the result is exact either way.
//
// B9's chain (gvr_topk_chain_kernel): one CTA per slot walks the slot's Q
// score rows in order. Row 0 warm-starts from the caller's (B, K)
// predictions; row q > 0 from row q-1's K output indices, which P5 also
// writes into a K-entry shared-memory buffer (8 KB at K = 2048, beside the
// 32 KB row and 48 KB candidate buffer at N = 8192, C = 6144), so the
// prediction never goes back to device memory. Both kernels run one
// device function (gvr_row), so the chain equals Q sequential B1 launches
// bit for bit in values, indices and all 8 stats columns.
//
// Bound on an H100: it reads the (B, N) f32 row, the (B, M) predictions and
// writes (B, K) values and indices — ~0.2 MB at B=4, N=8192, K=2048, well
// under a microsecond at 3.35 TB/s, so the kernel is latency- and
// launch-bound. Its design answer is to keep every sweep on-chip: the row
// is read from device memory once and all later passes hit shared memory.
//
// Comparisons follow float semantics (-0.0 == +0.0): keys are taken of the
// value plus +0.0, so the radix image agrees with `x >= T` everywhere.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;   // 32: one warp scans the warp totals
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t to_key(float v) {
  uint32_t u = __float_as_uint(__fadd_rn(v, 0.0f));   // -0.0 -> +0.0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_key(uint32_t k) {
  uint32_t u = (k & 0x80000000u) ? (k & 0x7fffffffu) : ~k;
  return __uint_as_float(u);
}

struct Scratch {
  int red_i[kWarps + 1];
  float red_f[3][kWarps + 1];
  int scan[kWarps + 1];
  int hist[256];
  int pick[3];
};

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Block-wide sum of one int; every thread gets the total.
__device__ int block_sum(int v, Scratch& s) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) s.red_i[w] = v;
  __syncthreads();
  if (w == 0) {
    int t = warp_sum(s.red_i[lane]);
    if (lane == 0) s.red_i[kWarps] = t;
  }
  __syncthreads();
  int total = s.red_i[kWarps];
  __syncthreads();
  return total;
}

// Block-wide (min, max, sum) of floats; every thread gets the results.
__device__ void block_min_max_sum(float& mn, float& mx, float& sm, Scratch& s) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    mn = fminf(mn, __shfl_xor_sync(kFull, mn, o));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
    sm += __shfl_xor_sync(kFull, sm, o);
  }
  if (lane == 0) { s.red_f[0][w] = mn; s.red_f[1][w] = mx; s.red_f[2][w] = sm; }
  __syncthreads();
  if (w == 0) {
    float a = s.red_f[0][lane], b = s.red_f[1][lane], c = s.red_f[2][lane];
    for (int o = 16; o > 0; o >>= 1) {
      a = fminf(a, __shfl_xor_sync(kFull, a, o));
      b = fmaxf(b, __shfl_xor_sync(kFull, b, o));
      c += __shfl_xor_sync(kFull, c, o);
    }
    if (lane == 0) { s.red_f[0][kWarps] = a; s.red_f[1][kWarps] = b; s.red_f[2][kWarps] = c; }
  }
  __syncthreads();
  mn = s.red_f[0][kWarps]; mx = s.red_f[1][kWarps]; sm = s.red_f[2][kWarps];
  __syncthreads();
}

// Exclusive block scan of one flag per thread, in thread order.
__device__ int block_excl_scan(bool flag, int& total, Scratch& s) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  unsigned ball = __ballot_sync(kFull, flag);
  int in_warp = __popc(ball & ((1u << lane) - 1u));
  if (lane == 0) s.scan[w] = __popc(ball);
  __syncthreads();
  if (w == 0) {
    int t = s.scan[lane];
    int incl = t;
    for (int o = 1; o < 32; o <<= 1) {
      int up = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += up;
    }
    s.scan[lane] = incl - t;
    if (lane == 31) s.scan[kWarps] = incl;
  }
  __syncthreads();
  int r = s.scan[w] + in_warp;
  total = s.scan[kWarps];
  __syncthreads();
  return r;
}

__device__ int count_ge(const float* x, int n, float t, Scratch& s) {
  int c = 0;
  for (int i = threadIdx.x; i < n; i += kThreads) c += (x[i] >= t);
  return block_sum(c, s);
}

// Exact K-th largest key of v[0..len) (k <= len): 8-bit MSD radix select.
// Returns the key and the counts of keys strictly above it and equal to it.
__device__ void radix_kth(const float* v, int len, int k, Scratch& s,
                          uint32_t& key, int& n_gt, int& n_eq) {
  uint32_t prefix = 0, mask = 0;
  int k_rem = k, above_total = 0, eq = 0;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = threadIdx.x; i < 256; i += kThreads) s.hist[i] = 0;
    __syncthreads();
    // warp-aggregated: lanes sharing a bin add once (NEG-tie rows put
    // every element in one bin, which would serialize per-lane atomics)
    for (int start = 0; start < len; start += kThreads) {
      const int i = start + threadIdx.x;
      const uint32_t kk = i < len ? to_key(v[i]) : 0u;
      const bool hit = i < len && (kk & mask) == prefix;
      const unsigned voters = __ballot_sync(kFull, hit);
      if (hit) {
        const unsigned bin = (kk >> shift) & 255u;
        const unsigned peers = __match_any_sync(voters, bin);
        if ((threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(&s.hist[bin], __popc(peers));
      }
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      // lane owns bins [8*lane, 8*lane + 8); find the highest bin j whose
      // count from the top reaches k_rem
      const int lane = threadIdx.x;
      int local[8];
      int sum = 0;
#pragma unroll
      for (int q = 0; q < 8; ++q) { local[q] = s.hist[8 * lane + q]; sum += local[q]; }
      int incl = sum;                       // sum over lanes >= lane
      for (int o = 1; o < 32; o <<= 1) {
        int dn = __shfl_down_sync(kFull, incl, o);
        if (lane + o < 32) incl += dn;
      }
      int excl = incl - sum;                // bins above this lane's range
      if (excl < k_rem && k_rem <= incl) {
        int acc = excl;
#pragma unroll
        for (int q = 7; q >= 0; --q) {
          if (acc + local[q] >= k_rem) {
            s.pick[0] = 8 * lane + q; s.pick[1] = acc; s.pick[2] = local[q];
            break;
          }
          acc += local[q];
        }
      }
    }
    __syncthreads();
    const int j = s.pick[0], above = s.pick[1];
    eq = s.pick[2];
    k_rem -= above;
    above_total += above;
    prefix |= (uint32_t)j << shift;
    mask |= 255u << shift;
    __syncthreads();
  }
  key = prefix;
  n_gt = above_total;
  n_eq = eq;
}

// One row's GVR Top-K, run by the whole CTA: g the (n,) f32 score row, pr
// its (m,) predictions, dyn the dynamic shared memory (the row when
// row_in_smem, then the 2 * cmax candidate buffer); writes (k,) values and
// indices to ov / oi, the 8 stats to st, and the indices also to pred_out
// (shared memory, the chain's next prediction) when it is not null.
__device__ void gvr_row(const float* __restrict__ g, const int* pr, int n,
                        int m, int k, int cmax, int max_secant, float f_target,
                        float c_lo0, int row_in_smem, float* dyn,
                        float* __restrict__ ov, int* __restrict__ oi,
                        float* __restrict__ st, int* pred_out, Scratch& s) {
  float* cand_v = dyn + (row_in_smem ? n : 0);
  int* cand_i = reinterpret_cast<int*>(cand_v + cmax);

  // ---- P0: row into shared memory (if it fits) + row extrema ----------
  float rmin = 3.4028234663852886e38f, rmax = -3.4028234663852886e38f, unused = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    float v = g[i];
    if (row_in_smem) dyn[i] = v;
    rmin = fminf(rmin, v);
    rmax = fmaxf(rmax, v);
  }
  block_min_max_sum(rmin, rmax, unused, s);    // also orders the smem fill
  const float* x = row_in_smem ? dyn : g;

  // ---- P1: statistics of the predicted values --------------------------
  // a prediction in [-n, 0) wraps (a recycled slot holds -1), one outside
  // [-n, n) is skipped — it is never read
  float pmin = 3.4028234663852886e38f, pmax = -3.4028234663852886e38f, psum = 0.f;
  int pcnt = 0;
  for (int j = threadIdx.x; j < m; j += kThreads) {
    int i = pr[j];
    if (i < 0) i += n;
    if (i >= 0 && i < n) {
      float v = x[i];
      pmin = fminf(pmin, v); pmax = fmaxf(pmax, v); psum += v; ++pcnt;
    }
  }
  block_min_max_sum(pmin, pmax, psum, s);
  pcnt = block_sum(pcnt, s);
  float p_lo, p_hi, t0;
  if (pcnt == 0) {
    p_lo = rmin; p_hi = rmax; t0 = __fmul_rn(0.5f, __fadd_rn(rmin, rmax));
  } else {
    p_lo = pmin; p_hi = pmax; t0 = __fdiv_rn(psum, (float)pcnt);
  }
  if (m < k) { p_lo = fminf(p_lo, rmin); p_hi = fmaxf(p_hi, rmax); }

  // ---- P2: secant threshold search (all threads run the same scalars) --
  float t_lo = p_lo, c_lo = c_lo0, t_hi = fmaxf(p_hi, p_lo), c_hi = 1.f;
  float t = fminf(fmaxf(t0, p_lo), p_hi), t_probe = t;
  int cnt = 0, it = 0;
  bool hi_probed = false, prev_over = false, done = false;
  while (!done && it < max_secant) {
    const int n_ge = count_ge(x, n, t, s);
    bool done2 = (n_ge >= k) && (n_ge <= cmax);
    const bool too_many = n_ge > cmax, too_few = n_ge < k;
    if (too_many) { t_lo = t; c_lo = (float)n_ge; }
    if (too_few) { t_hi = t; c_hi = (float)n_ge; }
    const float denom = __fsub_rn(c_lo, c_hi);
    float frac = fabsf(denom) > 0.f ? __fdiv_rn(__fsub_rn(c_lo, f_target), denom) : 0.5f;
    if (it == 0) frac = fminf(frac, 0.5f);
    float t_new = __fadd_rn(t_lo, __fmul_rn(frac, __fsub_rn(t_hi, t_lo)));
    const bool inside = t_new > t_lo && t_new < t_hi && isfinite(t_new);
    if (!inside) t_new = __fmul_rn(0.5f, __fadd_rn(t_lo, t_hi));
    const bool probe_lo = frac <= 0.f && t_lo != t;
    if (probe_lo) t_new = t_lo;
    const bool probe_hi = too_many && prev_over && !hi_probed && t_hi != t;
    if (probe_hi) t_new = t_hi;
    bool collapsed = !(t_new > t_lo && t_new < t_hi) && !probe_lo && !probe_hi;
    const bool rescue_hi = collapsed && too_many && rmax > t_hi;
    if (rescue_hi) { t_hi = rmax; c_hi = 1.f; }
    const bool rescue_lo = collapsed && too_few && rmin < t_lo;
    if (rescue_lo) { t_lo = rmin; c_lo = (float)n; }
    if (rescue_hi || rescue_lo) {
      t_new = __fmul_rn(0.5f, __fadd_rn(t_lo, t_hi));
      collapsed = false;
    }
    if (collapsed) { t_new = t_lo; done2 = true; }
    t_probe = t;
    cnt = n_ge;
    if (!done2) t = t_new;
    hi_probed = rescue_hi ? false : (hi_probed || probe_hi);
    prev_over = too_many;
    done = done2;
    ++it;
  }
  const float t_exit = cnt >= k ? t_probe : t_lo;
  const int c_exit = count_ge(x, n, t_exit, s);
  const bool buffered = c_exit >= k && c_exit <= cmax;

  // ---- P3: ordered compaction of the candidates ------------------------
  if (buffered) {
    int base = 0;
    for (int start = 0; start < n; start += kThreads) {
      const int i = start + threadIdx.x;
      const float v = i < n ? x[i] : 0.f;
      const bool sel = i < n && v >= t_exit;
      int total;
      const int pos = block_excl_scan(sel, total, s);
      if (sel) { cand_v[base + pos] = v; cand_i[base + pos] = i; }
      base += total;
    }
    __syncthreads();
  }
  const float* sv = buffered ? cand_v : x;
  const int* si = buffered ? cand_i : nullptr;
  const int len = buffered ? c_exit : n;

  // ---- P4: exact K-th value --------------------------------------------
  uint32_t tkey;
  int n_gt, n_eq;
  radix_kth(sv, len, k, s, tkey, n_gt, n_eq);
  const int quota = k - n_gt;                   // ties to take, >= 1

  // ---- P5: emit in ascending index order -------------------------------
  int base = 0, ties = 0;
  for (int start = 0; start < len; start += kThreads) {
    const int j = start + threadIdx.x;
    const float v = j < len ? sv[j] : 0.f;
    const uint32_t kk = j < len ? to_key(v) : 0u;
    const bool gt = j < len && kk > tkey;
    const bool eq = j < len && kk == tkey;
    int eq_total;
    const int eq_rank = block_excl_scan(eq, eq_total, s);
    const bool sel = gt || (eq && ties + eq_rank < quota);
    int sel_total;
    const int pos = block_excl_scan(sel, sel_total, s);
    if (sel) {
      const int out_i = si ? si[j] : j;
      ov[base + pos] = v;
      oi[base + pos] = out_i;
      if (pred_out) pred_out[base + pos] = out_i;
    }
    base += sel_total;
    ties += eq_total;
  }
  if (threadIdx.x == 0) {
    st[0] = (float)it;
    st[1] = 4.f;                                // radix passes of P4
    st[2] = (float)c_exit;
    st[3] = buffered ? 0.f : 1.f;               // full-row refine taken
    st[4] = from_key(tkey);
    st[5] = (float)n_gt;
    st[6] = (float)(n_gt + n_eq);
    st[7] = (float)base;
  }
}

__global__ void __launch_bounds__(kThreads)
gvr_topk_kernel(const float* __restrict__ scores, const int* __restrict__ prev,
                int n, int m, int k, int cmax, int max_secant, float f_target,
                float c_lo0, int row_in_smem, float* __restrict__ out_vals,
                int* __restrict__ out_idx, float* __restrict__ stats) {
  __shared__ Scratch s;
  extern __shared__ float dyn[];
  const int row = blockIdx.x;
  gvr_row(scores + (size_t)row * n, prev + (size_t)row * m, n, m, k, cmax,
          max_secant, f_target, c_lo0, row_in_smem, dyn,
          out_vals + (size_t)row * k, out_idx + (size_t)row * k,
          stats + (size_t)row * 8, nullptr, s);
}

// B9's chain: blockIdx.x = slot b, scores (B, qrows, n), prev (B, m) the
// row-0 predictions, outputs (B, qrows, k) and stats (B, qrows, 8). Rows
// q > 0 warm-start from row q-1's k indices (m = k, c_lo0_k) in shared
// memory after the candidate buffer.
__global__ void __launch_bounds__(kThreads)
gvr_topk_chain_kernel(const float* __restrict__ scores,
                      const int* __restrict__ prev, int qrows, int n, int m,
                      int k, int cmax, int max_secant, float f_target,
                      float c_lo0, float c_lo0_k, int row_in_smem,
                      float* __restrict__ out_vals, int* __restrict__ out_idx,
                      float* __restrict__ stats) {
  __shared__ Scratch s;
  extern __shared__ float dyn[];
  int* pred = reinterpret_cast<int*>(dyn + (row_in_smem ? n : 0) + 2 * cmax);
  const int b = blockIdx.x;
  for (int qq = 0; qq < qrows; ++qq) {
    const size_t row = (size_t)b * qrows + qq;
    const bool first = qq == 0;
    gvr_row(scores + row * n, first ? prev + (size_t)b * m : pred, n,
            first ? m : k, k, cmax, max_secant, f_target,
            first ? c_lo0 : c_lo0_k, row_in_smem, dyn, out_vals + row * k,
            out_idx + row * k, stats + row * 8, pred, s);
    __syncthreads();             // pred and the row buffer are reused
  }
}

}  // namespace

extern "C" int gvr_topk_launch(const float* scores, const int* prev, int b,
                               int n, int m, int k, int cmax, int max_secant,
                               float f_target, float c_lo0, int row_in_smem,
                               float* out_vals, int* out_idx, float* stats,
                               void* stream) {
  const size_t smem = ((size_t)(row_in_smem ? n : 0) + 2 * (size_t)cmax) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      gvr_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  gvr_topk_kernel<<<b, kThreads, smem, (cudaStream_t)stream>>>(
      scores, prev, n, m, k, cmax, max_secant, f_target, c_lo0, row_in_smem,
      out_vals, out_idx, stats);
  return (int)cudaGetLastError();
}

// B9's chain over (b, qrows) score rows of length n: prev (b, m) predicts
// row 0 of each slot; row q > 0 takes row q-1's k indices (c_lo0_k is the
// bracket seed for m = k). Outputs (b, qrows, k) and stats (b, qrows, 8).
extern "C" int gvr_topk_chain_launch(const float* scores, const int* prev,
                                     int b, int qrows, int n, int m, int k,
                                     int cmax, int max_secant, float f_target,
                                     float c_lo0, float c_lo0_k,
                                     int row_in_smem, float* out_vals,
                                     int* out_idx, float* stats, void* stream) {
  const size_t smem =
      ((size_t)(row_in_smem ? n : 0) + 2 * (size_t)cmax + (size_t)k) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      gvr_topk_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  gvr_topk_chain_kernel<<<b, kThreads, smem, (cudaStream_t)stream>>>(
      scores, prev, qrows, n, m, k, cmax, max_secant, f_target, c_lo0,
      c_lo0_k, row_in_smem, out_vals, out_idx, stats);
  return (int)cudaGetLastError();
}
