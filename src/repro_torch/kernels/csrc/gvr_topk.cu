// Exact GVR Top-K of a score row, warm-started from the previous step's
// Top-K — the Hopper form of kernel B1, and the chained selection half of
// kernel B9.
//
// Replaces: src/repro/kernels/gvr_topk.py:gvr_topk_pallas (body
// gvr_on_resident_row), and the GVR half of
// src/repro/kernels/indexer_topk.py:paged_indexer_topk_mq_pallas (kernel
// _paged_fused_mq_kernel, which threads each query row's Top-K into the
// next row's warm start through VMEM). On the TPU the row sat in VMEM and
// compaction went through an MXU one-hot contraction.
//
// What bounds it on an H100: the bytes are nothing (it reads the (B, N)
// f32 row and the (B, M) predictions and writes (B, K) values and indices,
// ~0.2 MB at B=4, N=8192, K=2048: 0.07 us at 3.35 TB/s), and a launch of
// its shape costs under a microsecond (tools/phase_gvr_topk.py times a
// null kernel of the same grid, cluster and shared memory). What is left
// is a serial chain: every secant probe is a count over the whole row whose
// result decides the next probe, and the radix select and the ordered
// emit are counts and scans too. The single-CTA form (one 1024-thread CTA
// per row, one block scan per 1024-element stripe) crossed well over a
// hundred CTA-wide barriers in sequence on one SM for a row whose length
// is below K.
//
// Design: a thread-block cluster per row. The grid is (R, rows) with R
// CTAs per cluster (R and the threads per CTA come from
// ops.gvr_schedule, by shape and by whether the device runs a cluster of
// 16, which gvr_cluster_capacity answers). CTA rank r owns positions
// [r*span, (r+1)*span), span = ceil(n/R), held in its own shared memory
// (200K floats fit at R = 8), and each thread owns a contiguous run of
// per = ceil(span/threads) of them, stored transposed (run element j of
// thread t at j*threads + t) so a sweep is bank-conflict free. Every
// cluster-wide count is one sweep of the thread's run, a CTA sum, and an
// exchange: warp 0 sends the CTA's pair of 32-bit values to every rank
// with st.async, which completes on the receiving rank's mbarrier; each
// rank's thread 0 arrives on its own mbarrier expecting R pairs, every
// thread waits on it and adds the R pairs itself, so no broadcast is
// needed. On the H100 such an exchange costs ~0.4 us at any R, where a
// cluster barrier (barrier.cluster) costs ~0.7 us
// (tools/cluster_exchange.py). Radix
// histograms and the chain's predicted values travel by bulk copies
// (cp.async.bulk) that complete on the same mbarriers. Exchange e uses
// buffers and mbarrier of parity e & 1, so nothing is overwritten before
// it is read. The one cluster barrier orders the mbarriers' initialisation
// before the first send; its arrive is split from its wait, so it
// overlaps the row load.
//   P0  load the rank's slice into shared memory; the row's min/max (one
//       exchange, shared with P1 where the predictions come from device
//       memory);
//   P1  the predicted values' min / mean / max seed the bracket. t0 =
//       psum / pcnt must be bit-identical to the single-CTA form's, so
//       psum is computed in that form's tree whatever R and the threads
//       are: virtual thread v of 1024 adds predictions v, v + 1024, ... in
//       order from 0.f, an xor butterfly (16, 8, 4, 2, 1) over each group
//       of 32 virtual threads, lane 0's result taken, and the same
//       butterfly over the 32 group sums. Every rank computes it alone;
//   P2  secant threshold search for K <= |x >= T| <= C, one exchange per
//       probe; the scalar bracket logic is the JAX package's core/gvr.py
//       `_phase2_secant`, run redundantly by every thread;
//   P3  none: there is no candidate buffer. When the exit threshold gives
//       K <= c_exit <= C, P4 counts only x >= T (the filter that
//       compaction applied), and P5 needs no filter (everything it emits
//       is >= the K-th value >= T);
//   P4  exact K-th value. Over the whole row (no buffer) it is first
//       tested against the row's minimum: when fewer than K keys lie above
//       it (a row shorter than K, whose K-th value is its NEG plateau),
//       one exchange of two counts settles it and stats column 1 counts
//       no radix pass. Else an 8-bit MSD radix select, four passes: each
//       rank builds a histogram of its own range (warp-aggregated adds)
//       and sends it to every rank in one bulk copy; each rank sums the R
//       on arrival and every warp picks the bin itself;
//   P5  emit every x > T* and the lowest-index ties in ascending index
//       order: per-thread counts of (> T*, == T*), warp scans, the CTA's
//       totals exchanged for the exclusive prefix over ranks, and each
//       thread writes its run at its offset — ties before this rank, then
//       before this warp, then before this thread, against the quota.
//   The exit count after P2 is taken only when no probe counted the exit
//   threshold already (the last probe, or the probe that set t_lo).
// Integer counts and min/max do not depend on order and the t0 tree is
// fixed, so values, indices and all 8 stats columns are the same for
// every (R, threads) (tools/sweep_gvr_cluster.py checks it on the card).
//
// B9's chain (gvr_topk_chain_kernel): one cluster per slot walks the
// slot's Q score rows. Row 0 warm-starts from the caller's (B, K)
// predictions, read from device memory by every rank; row q > 0 from row
// q-1's K output indices. Rank r emits only positions of its own range, so
// its slice of row q-1's Top-K lies in its own shared memory: it reads
// the new row's values there and sends them, at their output slots, to
// every rank's K-float buffer (bulk copies, with P0's exchange), from
// which every rank runs the t0 tree. The predictions never go back to
// device memory, and both kernels run one device function (gvr_row), so
// the chain equals Q sequential B1 launches bit for bit.
//
// Comparisons follow float semantics (-0.0 == +0.0): keys are taken of the
// value plus +0.0, so the radix image agrees with `x >= T` everywhere.
// Launch attributes (dynamic shared memory, a non-portable cluster of 16)
// are set once per instance and device; a refused launch returns its error
// and the wrapper raises.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxRanks = 16;
constexpr int kVirtual = 1024;          // threads of t0's summation tree
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kBig = 3.4028234663852886e38f;

using u64 = unsigned long long;

__device__ __forceinline__ uint32_t to_key(float v) {
  uint32_t u = __float_as_uint(__fadd_rn(v, 0.0f));   // -0.0 -> +0.0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_key(uint32_t k) {
  uint32_t u = (k & 0x80000000u) ? (k & 0x7fffffffu) : ~k;
  return __uint_as_float(u);
}

__device__ __forceinline__ long long globaltimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ int warp_sum(int v) {
  return __reduce_add_sync(kFull, v);
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// The single-CTA form's float sum over a warp: every lane adds its xor
// partner's partial at offsets 16, 8, 4, 2, 1; lane 0's result is the one
// that form kept.
__device__ __forceinline__ float butterfly_lane0(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return __shfl_sync(kFull, v, 0);
}

template <int kThreads>
struct Shared {
  static constexpr int kWarps = kThreads / 32;
  u64 mbar[2];                        // one mbarrier per exchange parity
  alignas(8) int xr[2][kMaxRanks][2]; // each rank's pair, as it arrived
  int red[2][kWarps][2];              // this CTA's per-warp pairs
  alignas(16) int hist[2][256];       // this rank's radix histogram, by parity
  int tot[256];                       // the cluster's, summed on arrival
  float vsum[32];                     // t0's 32 group sums
  float pmin[kWarps], pmax[kWarps];
  int pcnt[kWarps];
};

// Dynamic shared memory of a rank, in this order: the radix histograms the
// ranks send it, hx[2][R][256]; for the chain the k-float value buffer pv
// (what arrives) and its staging copy pvs (what this rank sends); the
// rank's slice xs (per * threads floats, transposed); for the chain the
// k-entry index buffer pred.
struct Dyn {
  int* hx;
  float* pv;
  float* pvs;
  float* xs;
  int* pred;
  bool chain;
};

template <int kThreads>
__device__ __forceinline__ Dyn carve(void* base, int nr, int per, int k, bool chain) {
  Dyn d;
  d.hx = reinterpret_cast<int*>(base);
  d.pv = reinterpret_cast<float*>(d.hx + 2 * 256 * nr);
  const int k4 = chain ? (k + 3) & ~3 : 0;     // keeps pvs 16-byte aligned
  d.pvs = d.pv + k4;
  d.xs = d.pvs + k4;
  d.pred = reinterpret_cast<int*>(d.xs + (size_t)per * kThreads);
  d.chain = chain;
  return d;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// The same shared-memory address in the CTA of cluster rank `rank`.
__device__ __forceinline__ unsigned at_rank(const void* p, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(smem_addr(p)), "r"(rank));
  return out;
}

// Arrive on this CTA's mbarrier (its one arrival per phase) and expect
// `bytes` more to land on it.
__device__ __forceinline__ void expect_bytes(u64* mbar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(mbar)), "r"(bytes) : "memory");
}

// Store one or two 32-bit values into a rank's shared memory; the store
// completes on that rank's mbarrier.
__device__ __forceinline__ void send1(unsigned dst, unsigned mbar, int a) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
               :: "r"(dst), "r"(a), "r"(mbar) : "memory");
}

__device__ __forceinline__ void send2(unsigned dst, unsigned mbar, int a, int b) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], {%1, %2}, [%3];"
               :: "r"(dst), "r"(a), "r"(b), "r"(mbar) : "memory");
}



// Copy `bytes` (a multiple of 16, both ends 16-byte aligned) of this CTA's
// shared memory into a rank's, completing on that rank's mbarrier.
__device__ __forceinline__ void send_bulk(unsigned dst, const void* src,
                                          unsigned bytes, unsigned mbar) {
  asm volatile("cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
               :: "r"(dst), "r"(smem_addr(src)), "r"(bytes), "r"(mbar) : "memory");
}

// Generic-proxy writes to shared memory made visible to the bulk copies.
__device__ __forceinline__ void fence_to_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void wait_phase(u64* mbar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile("{ .reg .pred P; mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P, [%1], %2; selp.u32 %0, 1, 0, P; }"
                 : "=r"(done) : "r"(smem_addr(mbar)), "r"(parity) : "memory");
  } while (!done);
}

// Kernel start: the two mbarriers (one arrival a phase) and the local
// histograms, then the cluster barrier's arrive (release); gvr_row waits
// on it (acquire) before its first send, so nothing lands on a rank whose
// mbarriers are not yet initialised.
template <int kThreads>
__device__ __forceinline__ void open_exchange(Shared<kThreads>& sh) {
  if (threadIdx.x == 0) {
    for (int p = 0; p < 2; ++p)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(smem_addr(&sh.mbar[p])));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = threadIdx.x; i < 512; i += kThreads) (&sh.hist[0][0])[i] = 0;
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void wait_open() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// One row's GVR Top-K, run by the whole cluster. g the (n,) f32 score row
// in device memory; pr its (m,) predictions in device memory when not
// `chained`, else the predictions are this rank's slice of the previous
// row's output: d.pred[0..pred_cnt) local positions at output slots
// pred_off + e. Writes (k,) values and indices to ov / oi, the 8 stats to
// st (rank 0), and, for the chain, this row's emitted local positions to
// d.pred with pred_off / pred_cnt (the next row's predictions).
//
// Exchange e (`ex` counts them, carried from row to row) uses parity
// p = e & 1: each rank's pair lands in xr[p][rank] (or its histogram in
// hx[p][rank], its predicted values in pv) on mbarrier p, whose phase e
// completes when this rank's one arrival (thread 0, with the bytes it
// expects) and all those bytes are in. A rank sends exchange e + 2 only
// after every rank sent e + 1, which each does after reading e, so a
// parity's buffers are never overwritten before they are read. `open`
// waits on the cluster barrier of open_exchange before the first send.
template <int kThreads, bool kTimed>
__device__ __forceinline__ void gvr_row(
    const float* __restrict__ g, const int* __restrict__ pr, int n, int m,
    int k, int cmax, int max_secant, float f_target, float c_lo0, int span,
    int per, bool chained, bool open, const Dyn& d, int& pred_off,
    int& pred_cnt, float* __restrict__ ov, int* __restrict__ oi,
    float* __restrict__ st, long long* stamps, Shared<kThreads>& sh,
    unsigned& ex) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kVpw = 32 / kWarps;            // tree groups per warp
  cg::cluster_group cl = cg::this_cluster();
  const int nr = (int)cl.num_blocks();
  const int r = (int)cl.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int base = r * span;
  const int len = max(0, min(n - base, span));
  const int mine = max(0, min(len - tid * per, per));   // this thread's run
  float* xs = d.xs;
  const bool timer = kTimed && r == 0 && tid == 0;
  if (timer) stamps[0] = globaltimer();

  // warp 0 sends this CTA's pair to every rank and thread 0 arrives,
  // expecting every rank's pair plus `extra` bytes; then all wait
  auto send_pair = [&](int a, int b, unsigned extra) {
    const int p = ex & 1;
    if (w == 0) {
      if (lane == 0) expect_bytes(&sh.mbar[p], 8u * nr + extra);
      if (lane < nr) send2(at_rank(&sh.xr[p][r][0], lane), at_rank(&sh.mbar[p], lane), a, b);
    }
    wait_phase(&sh.mbar[p], (ex >> 1) & 1);
  };
  // cluster-wide integer sums of a pair of per-thread values
  auto cluster_sum2 = [&](int a, int b) {
    const int p = ex & 1;
    a = warp_sum(a);
    b = warp_sum(b);
    if (lane == 0) { sh.red[p][w][0] = a; sh.red[p][w][1] = b; }
    __syncthreads();
    if (w == 0) {
      a = warp_sum(lane < kWarps ? sh.red[p][lane][0] : 0);
      b = warp_sum(lane < kWarps ? sh.red[p][lane][1] : 0);
    }
    send_pair(a, b, 0);
    int2 s = make_int2(0, 0);
    for (int q = 0; q < nr; ++q) { s.x += sh.xr[p][q][0]; s.y += sh.xr[p][q][1]; }
    ++ex;
    return s;
  };
  auto count_ge = [&](float t) {
    int c = 0;
#pragma unroll 4
    for (int j = 0; j < mine; ++j) c += xs[j * kThreads + tid] >= t;
    return cluster_sum2(c, 0).x;
  };

  // ---- P1 (device-memory predictions): issue the index loads first -----
  int pidx[2][kVpw];
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int u = 0; u < kVpw; ++u) {
      const int j = (w + u * kWarps) * 32 + lane + c * kVirtual;
      pidx[c][u] = (!chained && j < m) ? pr[j] : INT_MIN;
    }

  // ---- P0: the rank's slice into shared memory + its extrema -----------
  float rmin = kBig, rmax = -kBig;
#pragma unroll 4
  for (int q = tid; q < len; q += kThreads) {
    const float v = g[base + q];
    xs[(q % per) * kThreads + q / per] = v;
    rmin = fminf(rmin, v);
    rmax = fmaxf(rmax, v);
  }
  if (timer) stamps[1] = globaltimer();

  // ---- P1: statistics of the predicted values --------------------------
  // a prediction in [-n, 0) wraps (a recycled slot holds -1), one outside
  // [-n, n) is skipped — it is never read
  float acc[kVpw];
  float pmn = kBig, pmx = -kBig;
  int pc = 0;
#pragma unroll
  for (int u = 0; u < kVpw; ++u) acc[u] = 0.f;
  auto take = [&](int u, float v) {
    acc[u] += v; pmn = fminf(pmn, v); pmx = fmaxf(pmx, v); ++pc;
  };
  auto tree_out = [&]() {            // group sums and per-warp extrema
#pragma unroll
    for (int u = 0; u < kVpw; ++u) {
      const float s = butterfly_lane0(acc[u]);
      if (lane == 0) sh.vsum[w + u * kWarps] = s;
    }
    pmn = warp_min(pmn); pmx = warp_max(pmx); pc = warp_sum(pc);
    if (lane == 0) { sh.pmin[w] = pmn; sh.pmax[w] = pmx; sh.pcnt[w] = pc; }
  };
  const int p0 = ex & 1;
  if (!chained) {
    float val[2][kVpw];
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int u = 0; u < kVpw; ++u) {
        int i = pidx[c][u];
        if (i < 0) i += n;
        pidx[c][u] = (i >= 0 && i < n) ? i : -1;
        val[c][u] = pidx[c][u] >= 0 ? g[pidx[c][u]] : 0.f;
      }
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int u = 0; u < kVpw; ++u)
        if (pidx[c][u] >= 0) take(u, val[c][u]);
    for (int c = 2; c * kVirtual < m; ++c)
#pragma unroll
      for (int u = 0; u < kVpw; ++u) {
        const int j = (w + u * kWarps) * 32 + lane + c * kVirtual;
        int i = j < m ? pr[j] : INT_MIN;
        if (i < 0) i += n;
        if (i >= 0 && i < n) take(u, g[i]);
      }
    tree_out();
  } else {
    // the previous row's output in this rank's range: its values in the
    // new row, staged at their output slots for the bulk copies
    __syncthreads();
    for (int e = tid; e < pred_cnt; e += kThreads) {
      const int i = d.pred[e];
      d.pvs[pred_off + e] = xs[(i % per) * kThreads + i / per];
    }
    fence_to_async();
  }
  rmin = warp_min(rmin);
  rmax = warp_max(rmax);
  if (lane == 0) { sh.red[p0][w][0] = __float_as_int(rmin); sh.red[p0][w][1] = __float_as_int(rmax); }
  if (open) wait_open();
  __syncthreads();
  {
    float a = kBig, b = -kBig;
    if (lane < kWarps) {
      a = __int_as_float(sh.red[p0][lane][0]);
      b = __int_as_float(sh.red[p0][lane][1]);
    }
    a = warp_min(a);
    b = warp_max(b);
    if (chained) {
      // this rank's slots [pred_off, pred_off + pred_cnt) to every rank's
      // pv: the 16-byte-aligned middle by one bulk copy a rank, the ends
      // (at most 3 + 3 values) one by one
      const int end = pred_off + pred_cnt;
      const int a16 = min((pred_off + 3) & ~3, end), b16 = max(end & ~3, a16);
      if (tid == 0 && b16 > a16)
        for (int q = 0; q < nr; ++q)
          send_bulk(at_rank(d.pv + a16, q), d.pvs + a16, 4u * (b16 - a16),
                    at_rank(&sh.mbar[p0], q));
      const int ends = (a16 - pred_off) + (end - b16);
      for (int i = tid; i < ends * nr; i += kThreads) {
        const int e = i / nr, q = i % nr;
        const int j = e < a16 - pred_off ? pred_off + e : b16 + e - (a16 - pred_off);
        send1(at_rank(d.pv + j, q), at_rank(&sh.mbar[p0], q), __float_as_int(d.pvs[j]));
      }
    }
    send_pair(__float_as_int(a), __float_as_int(b), chained ? 4u * k : 0u);
    rmin = kBig; rmax = -kBig;
    for (int q = 0; q < nr; ++q) {
      rmin = fminf(rmin, __int_as_float(sh.xr[p0][q][0]));
      rmax = fmaxf(rmax, __int_as_float(sh.xr[p0][q][1]));
    }
    ++ex;
  }
  if (chained) {
#pragma unroll
    for (int u = 0; u < kVpw; ++u)
      for (int j = (w + u * kWarps) * 32 + lane; j < m; j += kVirtual)
        take(u, d.pv[j]);
    tree_out();
  }
  __syncthreads();                               // group sums, partials
  const float psum = butterfly_lane0(sh.vsum[lane]);
  float pmin = lane < kWarps ? sh.pmin[lane] : kBig;
  float pmax = lane < kWarps ? sh.pmax[lane] : -kBig;
  const int pcnt = warp_sum(lane < kWarps ? sh.pcnt[lane] : 0);
  pmin = warp_min(pmin);
  pmax = warp_max(pmax);
  float p_lo, p_hi, t0;
  if (pcnt == 0) {
    p_lo = rmin; p_hi = rmax; t0 = __fmul_rn(0.5f, __fadd_rn(rmin, rmax));
  } else {
    p_lo = pmin; p_hi = pmax; t0 = __fdiv_rn(psum, (float)pcnt);
  }
  if (m < k) { p_lo = fminf(p_lo, rmin); p_hi = fmaxf(p_hi, rmax); }
  if (timer) stamps[2] = globaltimer();

  // ---- P2: secant threshold search (all threads run the same scalars) --
  float t_lo = p_lo, c_lo = c_lo0, t_hi = fmaxf(p_hi, p_lo), c_hi = 1.f;
  float t = fminf(fmaxf(t0, p_lo), p_hi), t_probe = t;
  int cnt = 0, it = 0;
  int n_lo = -1;                 // |x >= t_lo| where a probe gave it, else -1
  bool hi_probed = false, prev_over = false, done = false;
  while (!done && it < max_secant) {
    const int n_ge = count_ge(t);
    bool done2 = (n_ge >= k) && (n_ge <= cmax);
    const bool too_many = n_ge > cmax, too_few = n_ge < k;
    if (too_many) { t_lo = t; c_lo = (float)n_ge; n_lo = n_ge; }
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
    if (rescue_lo) { t_lo = rmin; c_lo = (float)n; n_lo = -1; }
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
  if (timer) stamps[3] = globaltimer();
  // the exit threshold is the last probe (count cnt) or t_lo; its count is
  // taken again only when no probe gave it
  const float t_exit = cnt >= k ? t_probe : t_lo;
  const int c_exit = cnt >= k ? cnt : n_lo >= 0 ? n_lo : count_ge(t_exit);
  const bool buffered = c_exit >= k && c_exit <= cmax;
  if (timer) stamps[4] = globaltimer();
  // ---- P3: none (P4 filters x >= t_exit when buffered) -----------------
  if (timer) stamps[5] = globaltimer();

  // ---- P4: exact K-th value ---------------------------------------------
  // Over the whole row, the K-th value is the row's minimum when fewer
  // than K keys lie above it (a row shorter than K: its NEG plateau); one
  // exchange of two counts settles that, and no radix pass runs.
  uint32_t prefix = 0, mask = 0;
  int k_rem = k, n_gt = 0, n_eq = 0, passes = 4;
  if (!buffered) {
    const uint32_t kmin = to_key(rmin);
    int above = 0, at_least = 0;
    for (int j = 0; j < mine; ++j) {
      const uint32_t kk = to_key(xs[j * kThreads + tid]);
      above += kk > kmin;
      at_least += kk >= kmin;
    }
    const int2 c = cluster_sum2(above, at_least);
    if (c.x < k && k <= c.y) {
      prefix = kmin;
      n_gt = c.x;
      n_eq = c.y - c.x;
      passes = 0;
    }
  }
  // Else an 8-bit MSD radix over the cluster, four passes. A pass: this
  // rank's histogram (hist[p] is zero on entry), one bulk copy of it to
  // every rank, the R histograms summed on arrival into tot; every warp
  // then picks the highest bin j whose count from the top reaches k_rem.
  for (int shift = 24; passes > 0 && shift >= 0; shift -= 8) {
    const int p = ex & 1;
    int* h = sh.hist[p];
    for (int j = 0; j < per; ++j) {
      const bool ok = j < mine;
      const float v = ok ? xs[j * kThreads + tid] : 0.f;
      const uint32_t kk = to_key(v);
      const bool hit = ok && (!buffered || v >= t_exit) && (kk & mask) == prefix;
      const unsigned voters = __ballot_sync(kFull, hit);
      if (hit) {
        const unsigned bin = (kk >> shift) & 255u;
        const unsigned peers = __match_any_sync(voters, bin);
        if (lane == __ffs(peers) - 1) atomicAdd(&h[bin], __popc(peers));
      }
    }
    fence_to_async();
    __syncthreads();
    int* hx = d.hx + p * 256 * nr;
    if (w == 0) {
      if (lane == 0) expect_bytes(&sh.mbar[p], 1024u * nr);
      if (lane < nr)
        send_bulk(at_rank(hx + r * 256, lane), h, 1024u, at_rank(&sh.mbar[p], lane));
    }
    wait_phase(&sh.mbar[p], (ex >> 1) & 1);
    for (int b = tid; b < 256; b += kThreads) {
      int s = 0;
      for (int q = 0; q < nr; ++q) s += hx[q * 256 + b];
      sh.tot[b] = s;
      // the other parity's copies (the previous pass) have all landed
      sh.hist[p ^ 1][b] = 0;
    }
    ++ex;
    __syncthreads();
    int local[8];
    int sum = 0;
#pragma unroll
    for (int q = 0; q < 8; ++q) { local[q] = sh.tot[8 * lane + q]; sum += local[q]; }
    int incl = sum;                         // sum over lanes >= lane
    for (int o = 1; o < 32; o <<= 1) {
      const int dn = __shfl_down_sync(kFull, incl, o);
      if (lane + o < 32) incl += dn;
    }
    const int excl = incl - sum;            // bins above this lane's range
    const bool here = excl < k_rem && k_rem <= incl;
    int pick_j = 0, pick_above = 0, pick_eq = 0;
    if (here) {
      int acc_above = excl;
#pragma unroll
      for (int q = 7; q >= 0; --q) {
        if (acc_above + local[q] >= k_rem) {
          pick_j = 8 * lane + q; pick_above = acc_above; pick_eq = local[q];
          break;
        }
        acc_above += local[q];
      }
    }
    const int src = __ffs(__ballot_sync(kFull, here)) - 1;
    const int j = __shfl_sync(kFull, pick_j, src);
    const int above = __shfl_sync(kFull, pick_above, src);
    n_eq = __shfl_sync(kFull, pick_eq, src);
    k_rem -= above;
    n_gt += above;
    prefix |= (uint32_t)j << shift;
    mask |= 255u << shift;
  }
  const uint32_t tkey = prefix;
  const int quota = k - n_gt;                   // ties to take, >= 1
  if (timer) stamps[6] = globaltimer();

  // ---- P5: emit in ascending index order -------------------------------
  int gt = 0, eqc = 0;
  for (int j = 0; j < mine; ++j) {
    const uint32_t kk = to_key(xs[j * kThreads + tid]);
    gt += kk > tkey;
    eqc += kk == tkey;
  }
  int gi = gt, ei = eqc;                        // inclusive over the warp
  for (int o = 1; o < 32; o <<= 1) {
    const int a = __shfl_up_sync(kFull, gi, o), b = __shfl_up_sync(kFull, ei, o);
    if (lane >= o) { gi += a; ei += b; }
  }
  const int p5 = ex & 1;
  if (lane == 31) { sh.red[p5][w][0] = gi; sh.red[p5][w][1] = ei; }
  __syncthreads();
  // this warp's offsets within the CTA, and the CTA's totals
  int wg = 0, we = 0, cg_ = 0, ce = 0;
  if (lane < kWarps) {
    cg_ = sh.red[p5][lane][0];
    ce = sh.red[p5][lane][1];
    if (lane < w) { wg = cg_; we = ce; }
  }
  wg = warp_sum(wg); we = warp_sum(we);
  send_pair(warp_sum(cg_), warp_sum(ce), 0);
  // ranks before this one, and the cluster's totals
  int rg = 0, re = 0, tg = 0, te = 0;
  for (int q = 0; q < nr; ++q) {
    const int a = sh.xr[p5][q][0], b = sh.xr[p5][q][1];
    if (q < r) { rg += a; re += b; }
    tg += a; te += b;
  }
  ++ex;
  const int emitted = tg + min(te, quota);
  int* pred = d.chain ? d.pred : nullptr;
  const int off_r = rg + min(re, quota);        // this rank's first slot
  if (pred) {
    pred_off = off_r;
    pred_cnt = rg + sh.xr[p5][r][0] + min(re + sh.xr[p5][r][1], quota) - off_r;
  }
  const int eq0 = re + we + ei - eqc;           // ties before this thread
  int pos = rg + wg + gi - gt + min(eq0, quota), ties = eq0;
  for (int j = 0; j < mine; ++j) {
    const float v = xs[j * kThreads + tid];
    const uint32_t kk = to_key(v);
    bool sel = kk > tkey;
    if (kk == tkey) { sel = ties < quota; ++ties; }
    if (sel) {
      const int loc = tid * per + j;
      ov[pos] = v;
      oi[pos] = base + loc;
      if (pred) pred[pos - off_r] = loc;
      ++pos;
    }
  }
  // the last pass's copies have landed everywhere (every rank sent P5
  // after its last pass): its histogram is free for the next row
  for (int b = tid; b < 256; b += kThreads) sh.hist[p5 ^ 1][b] = 0;
  if (timer) stamps[7] = globaltimer();
  if (r == 0 && tid == 0) {
    st[0] = (float)it;
    st[1] = (float)passes;                      // radix passes of P4
    st[2] = (float)c_exit;
    st[3] = buffered ? 0.f : 1.f;               // full-row refine taken
    st[4] = from_key(tkey);
    st[5] = (float)n_gt;
    st[6] = (float)(n_gt + n_eq);
    st[7] = (float)emitted;
  }
}

// B1: grid (R, rows), cluster (R, 1, 1); blockIdx.y = row.
template <int kThreads, bool kTimed>
__global__ void __launch_bounds__(kThreads)
gvr_topk_kernel(const float* __restrict__ scores, const int* __restrict__ prev,
                int n, int m, int k, int cmax, int max_secant, float f_target,
                float c_lo0, int span, int per, float* __restrict__ out_vals,
                int* __restrict__ out_idx, float* __restrict__ stats,
                long long* stamps) {
  __shared__ Shared<kThreads> sh;
  extern __shared__ float4 dyn4[];
  const int nr = (int)cg::this_cluster().num_blocks();
  const Dyn d = carve<kThreads>(dyn4, nr, per, k, false);
  const size_t row = blockIdx.y;
  unsigned ex = 0;
  int off = 0, cnt = 0;
  open_exchange(sh);
  gvr_row<kThreads, kTimed>(
      scores + row * n, prev + row * m, n, m, k, cmax, max_secant, f_target,
      c_lo0, span, per, false, true, d, off, cnt, out_vals + row * k,
      out_idx + row * k, stats + row * 8, kTimed ? stamps + row * 8 : nullptr,
      sh, ex);
}

// B9's chain: grid (R, B), blockIdx.y = slot b; scores (B, qrows, n),
// prev (B, m) the row-0 predictions, outputs (B, qrows, k) and stats
// (B, qrows, 8). Rows q > 0 warm-start from row q-1's k indices (m = k,
// c_lo0_k), each rank's slice kept in its shared memory.
template <int kThreads>
__global__ void __launch_bounds__(kThreads)
gvr_topk_chain_kernel(const float* __restrict__ scores,
                      const int* __restrict__ prev, int qrows, int n, int m,
                      int k, int cmax, int max_secant, float f_target,
                      float c_lo0, float c_lo0_k, int span, int per,
                      float* __restrict__ out_vals, int* __restrict__ out_idx,
                      float* __restrict__ stats) {
  __shared__ Shared<kThreads> sh;
  extern __shared__ float4 dyn4[];
  const int nr = (int)cg::this_cluster().num_blocks();
  const Dyn d = carve<kThreads>(dyn4, nr, per, k, true);
  const size_t b = blockIdx.y;
  unsigned ex = 0;
  int off = 0, cnt = 0;
  open_exchange(sh);
  for (int qq = 0; qq < qrows; ++qq) {
    const size_t row = b * qrows + qq;
    const bool first = qq == 0;
    gvr_row<kThreads, false>(
        scores + row * n, prev + b * m, n, first ? m : k, k, cmax, max_secant,
        f_target, first ? c_lo0 : c_lo0_k, span, per, !first, first, d, off,
        cnt, out_vals + row * k, out_idx + row * k, stats + row * 8, nullptr,
        sh, ex);
    __syncthreads();             // the row slice and pred are reused
  }
}

__global__ void gvr_null_kernel() {}

struct Geometry {
  int span, per;
};

// Whether the kernels take a launch shape: R a power of two up to 16,
// 256/512/1024 threads, rows within the grid's y limit.
bool legal(int rows, int ranks, int threads) {
  return ranks >= 1 && ranks <= kMaxRanks && (ranks & (ranks - 1)) == 0 &&
         (threads == 256 || threads == 512 || threads == 1024) && rows >= 1 &&
         rows <= 65535;
}

// The launch's geometry, or an error for a shape the kernels do not take
// or too little shared memory for the rank's slice (plus the chain's
// buffers).
cudaError_t geometry(int n, int k, int rows, int ranks, int threads,
                     size_t smem, bool chain, Geometry& geo) {
  if (!legal(rows, ranks, threads) || n < 1) return cudaErrorInvalidValue;
  geo.span = (n + ranks - 1) / ranks;
  geo.per = (geo.span + threads - 1) / threads;
  const size_t need = (size_t)geo.per * threads * 4 + (size_t)2048 * ranks +
                      (chain ? (size_t)8 * ((k + 3) & ~3) + (size_t)4 * k : 0);
  return smem < need ? cudaErrorInvalidValue : cudaSuccess;
}

// Launch attributes already set on one kernel instance, per device: the
// dynamic shared-memory limit (raised again only when a launch needs more
// than any before it) and a cluster of 16 allowed. Each instance owns one
// (b1_state, chain_state), which its launches and its capacity query
// share, so the attributes are set once per instance and device.
struct LaunchState {
  size_t raised[kMaxDevices];
  bool wide[kMaxDevices];
};

template <int kThreads, bool kTimed>
LaunchState& b1_state() {
  static LaunchState ls = {};
  return ls;
}

template <int kThreads>
LaunchState& chain_state() {
  static LaunchState ls = {};
  return ls;
}

template <typename Kern>
cudaError_t prepare(LaunchState& ls, Kern kern, int ranks, size_t smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > ls.raised[dev]) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) { cudaGetLastError(); return err; }
    ls.raised[dev] = smem;
  }
  if (ranks > 8 && !ls.wide[dev]) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) { cudaGetLastError(); return err; }
    ls.wide[dev] = true;
  }
  return cudaSuccess;
}

// A launch configuration of `rows` clusters of `ranks` CTAs; attr is the
// caller's storage for the cluster dimension.
cudaLaunchConfig_t cluster_config(int ranks, int rows, int threads,
                                  size_t smem, void* stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranks, rows, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename Kern, typename... Args>
int cluster_launch(LaunchState& ls, Kern kern, int ranks, int rows,
                   int threads, size_t smem, void* stream, Args... args) {
  cudaError_t err = prepare(ls, kern, ranks, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(ranks, rows, threads, smem, stream, attr);
  err = cudaLaunchKernelEx(&cfg, kern, args...);
  if (err != cudaSuccess) cudaGetLastError();     // not left for a later call
  return (int)err;
}

// How many clusters of `ranks` CTAs of `threads` threads with `smem` bytes
// each the current device can run at once (cudaOccupancyMaxActiveClusters),
// or a negative CUDA error.
template <typename Kern>
int cluster_capacity(LaunchState& ls, Kern kern, int ranks, int threads,
                     size_t smem) {
  cudaError_t err = prepare(ls, kern, ranks, smem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(ranks, 1, threads, smem, nullptr, attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, (const void*)kern, &cfg);
  if (err != cudaSuccess) { cudaGetLastError(); return -(int)err; }
  return clusters;
}

template <int kThreads, bool kTimed>
int launch_b1(const float* scores, const int* prev, int b, int n, int m, int k,
              int cmax, int max_secant, float f_target, float c_lo0, int ranks,
              const Geometry& geo, size_t smem, float* out_vals, int* out_idx,
              float* stats, long long* stamps, void* stream) {
  return cluster_launch(b1_state<kThreads, kTimed>(),
                        gvr_topk_kernel<kThreads, kTimed>, ranks, b,
                        kThreads, smem, stream, scores, prev, n, m, k, cmax, max_secant,
                        f_target, c_lo0, geo.span, geo.per, out_vals, out_idx,
                        stats, stamps);
}

template <int kThreads>
int launch_chain(const float* scores, const int* prev, int b, int qrows, int n,
                 int m, int k, int cmax, int max_secant, float f_target,
                 float c_lo0, float c_lo0_k, int ranks, const Geometry& geo,
                 size_t smem, float* out_vals, int* out_idx, float* stats,
                 void* stream) {
  return cluster_launch(chain_state<kThreads>(),
                        gvr_topk_chain_kernel<kThreads>, ranks, b,
                        kThreads, smem, stream, scores, prev, qrows, n, m, k,
                        cmax, max_secant, f_target, c_lo0, c_lo0_k, geo.span,
                        geo.per, out_vals, out_idx, stats);
}

template <bool kTimed>
int b1_by_threads(const float* scores, const int* prev, int b, int n, int m,
                  int k, int cmax, int max_secant, float f_target, float c_lo0,
                  int ranks, int threads, int smem, float* out_vals,
                  int* out_idx, float* stats, long long* stamps, void* stream) {
  Geometry geo;
  cudaError_t err = geometry(n, k, b, ranks, threads, (size_t)smem, false, geo);
  if (err != cudaSuccess) return (int)err;
  switch (threads) {
    case 256: return launch_b1<256, kTimed>(scores, prev, b, n, m, k, cmax, max_secant, f_target, c_lo0, ranks, geo, smem, out_vals, out_idx, stats, stamps, stream);
    case 512: return launch_b1<512, kTimed>(scores, prev, b, n, m, k, cmax, max_secant, f_target, c_lo0, ranks, geo, smem, out_vals, out_idx, stats, stamps, stream);
    default: return launch_b1<1024, kTimed>(scores, prev, b, n, m, k, cmax, max_secant, f_target, c_lo0, ranks, geo, smem, out_vals, out_idx, stats, stamps, stream);
  }
}

}  // namespace

// B1 over b rows of length n with (b, m) predictions, on a cluster of
// `ranks` CTAs of `threads` threads per row with `smem` bytes of dynamic
// shared memory (ops.gvr_schedule).
extern "C" int gvr_topk_launch(const float* scores, const int* prev, int b,
                               int n, int m, int k, int cmax, int max_secant,
                               float f_target, float c_lo0, int ranks,
                               int threads, int smem, float* out_vals,
                               int* out_idx, float* stats, void* stream) {
  return b1_by_threads<false>(scores, prev, b, n, m, k, cmax, max_secant,
                              f_target, c_lo0, ranks, threads, smem, out_vals,
                              out_idx, stats, nullptr, stream);
}

// The timing instance of B1 (kTimed): thread 0 of rank 0 writes
// %globaltimer at the start and after each phase into stamps (b, 8) int64.
// Only tools/phase_gvr_topk.py launches it.
extern "C" int gvr_topk_timed_launch(const float* scores, const int* prev,
                                     int b, int n, int m, int k, int cmax,
                                     int max_secant, float f_target,
                                     float c_lo0, int ranks, int threads,
                                     int smem, float* out_vals, int* out_idx,
                                     float* stats, long long* stamps,
                                     void* stream) {
  return b1_by_threads<true>(scores, prev, b, n, m, k, cmax, max_secant,
                             f_target, c_lo0, ranks, threads, smem, out_vals,
                             out_idx, stats, stamps, stream);
}

// B9's chain over (b, qrows) score rows of length n: prev (b, m) predicts
// row 0 of each slot; row q > 0 takes row q-1's k indices (c_lo0_k is the
// bracket seed for m = k). Outputs (b, qrows, k) and stats (b, qrows, 8).
extern "C" int gvr_topk_chain_launch(const float* scores, const int* prev,
                                     int b, int qrows, int n, int m, int k,
                                     int cmax, int max_secant, float f_target,
                                     float c_lo0, float c_lo0_k, int ranks,
                                     int threads, int smem, float* out_vals,
                                     int* out_idx, float* stats, void* stream) {
  Geometry geo;
  cudaError_t err = geometry(n, k, b, ranks, threads, (size_t)smem, true, geo);
  if (err != cudaSuccess) return (int)err;
  switch (threads) {
    case 256: return launch_chain<256>(scores, prev, b, qrows, n, m, k, cmax, max_secant, f_target, c_lo0, c_lo0_k, ranks, geo, smem, out_vals, out_idx, stats, stream);
    case 512: return launch_chain<512>(scores, prev, b, qrows, n, m, k, cmax, max_secant, f_target, c_lo0, c_lo0_k, ranks, geo, smem, out_vals, out_idx, stats, stream);
    default: return launch_chain<1024>(scores, prev, b, qrows, n, m, k, cmax, max_secant, f_target, c_lo0, c_lo0_k, ranks, geo, smem, out_vals, out_idx, stats, stream);
  }
}

// How many clusters of `ranks` CTAs of `threads` threads with `smem` bytes
// of dynamic shared memory each the current device can run at once, for B1
// (chain = 0) or B9's chain (chain = 1); 0 when it cannot run one, or a
// negative CUDA error. ops.gvr_hosts_wide_cluster asks it once per device
// whether a cluster of 16 fits.
extern "C" int gvr_cluster_capacity(int ranks, int threads, int smem,
                                    int chain) {
  if (!legal(1, ranks, threads) || smem < 0) return -(int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)smem;
  switch (threads) {
    case 256: return chain ? cluster_capacity(chain_state<256>(), gvr_topk_chain_kernel<256>, ranks, 256, bytes)
                           : cluster_capacity(b1_state<256, false>(), gvr_topk_kernel<256, false>, ranks, 256, bytes);
    case 512: return chain ? cluster_capacity(chain_state<512>(), gvr_topk_chain_kernel<512>, ranks, 512, bytes)
                           : cluster_capacity(b1_state<512, false>(), gvr_topk_kernel<512, false>, ranks, 512, bytes);
    default: return chain ? cluster_capacity(chain_state<1024>(), gvr_topk_chain_kernel<1024>, ranks, 1024, bytes)
                          : cluster_capacity(b1_state<1024, false>(), gvr_topk_kernel<1024, false>, ranks, 1024, bytes);
  }
}

// A null kernel on the same grid, cluster and dynamic shared memory as a
// B1 launch: the floor of a launch of that shape (tools/phase_gvr_topk.py).
extern "C" int gvr_null_launch(int rows, int ranks, int threads, int smem,
                               void* stream) {
  static LaunchState ls = {};
  if (!legal(rows, ranks, threads)) return (int)cudaErrorInvalidValue;
  return cluster_launch(ls, gvr_null_kernel, ranks, rows, threads,
                        (size_t)smem, stream);
}
