// Decode attention for one query token per slot — the Hopper forms of
// kernels B3 (sparse: the K rows the Top-K selected, through the block
// table), B4 (dense: the whole causal extent through the table, the pre-DSA
// fallback), B6 (sparse over contiguous caches: the dense layout and the
// gather oracle), B8 (B3 over the Q query rows of each slot's speculative
// verify tick, sharing the slot's table row) and B10 (B3 at page
// granularity). All five share one kernel body; only the enumeration of
// the rows differs.
//
// Replaces:
//   B3  src/repro/kernels/sparse_attn.py:paged_sparse_decode_attn_pallas
//       (kernel _paged_attn_kernel) — one grid step per selected row, the
//       row DMA'd through a scalar-prefetched index_map;
//   B4  src/repro/kernels/sparse_attn.py:paged_dense_decode_attn_pallas
//       (kernel _paged_dense_attn_kernel) — one grid step per whole page;
//   B6  src/repro/kernels/sparse_attn.py:sparse_decode_attn_pallas
//       (kernel _attn_kernel) — one grid step per selected row of the
//       slot's own (N, KVH, hd) cache;
//   B8  src/repro/kernels/sparse_attn.py:paged_sparse_decode_attn_mq_pallas
//       (kernel _paged_attn_mq_kernel) — B3's grid with a query-row axis,
//       (B, Q, K), the table shared by a slot's Q rows;
//   B10 src/repro/kernels/sparse_attn.py:paged_sparse_decode_attn_pg_pallas
//       (kernel _paged_attn_pg_kernel) — one grid step per distinct touched
//       page, loaded whole, the unselected rows masked.
// Here one CTA of 16 warps serves one (KV head, slot) pair and its G = H/KVH
// query heads (GQA: head h reads KV head h / G). The CTA translates a chunk
// of entries to rows of the flattened cache into shared memory (B10: with a
// weight per row, a template branch the other modes compile without), then
// each warp streams its share of rows — a lane holds hd/32 dimensions, a
// dot product is a warp reduction — and keeps its own online-softmax state
// in f32; the 16 partial states are merged at the end with the `isfinite`
// guards and a final l >= 1e-30 clamp.
//
// Rows per mode: B3 row = table[b, pos / ps] * ps + pos % ps; B6 row =
// b * N + pos (the wrapper passes ps = 1, mp = N); B8 is B3 over the B*Q
// folded query rows, row r reading table row r / Q straight from the
// shared (B, MP) table (no repeated table is built) and its idx, length, q
// and output from row r. B3, B6 and B8 visit entries in Top-K order with
// the same warp partition, so B6 over a contiguous cache, B3 over pages
// holding the same rows and B8 against B3 on the folded rows (table
// repeated) agree bit for bit. B10
// first builds the slot's descriptor list in shared memory: a 16-bit count
// per logical position and a flag per logical page, marked from idx, then
// one warp compacts the flagged pages in ascending order with ballots. It
// then walks every row of every touched page (page order, so it agrees with
// the Top-K-ordered plain version to rounding only), weighting a row by its
// count: unselected rows weigh 0 and are masked, a duplicate entry counts
// as often as the token-granular form counts it.
//
// Masking: an entry contributes iff its position is in [0, length) (and,
// dense, inside the optional window) and its page is mapped. The sparse
// length mask is one the Pallas kernels lack (the served XLA path has it).
// A slot with no valid entry gets 0.
//
// Bound on an H100: the bytes of the rows it must read. B3/B6 at B=4,
// K=2048, KVH=8, hd=64, bf16: 4*2048*8*64*2*2 = 16.8 MB, ~5 us at 3.35
// TB/s; B8 the distinct (slot, row) pairs its Q rows select (consecutive
// positions share most of their Top-K, so close to B3's bytes, where this
// design reads each row once per query row, Q times); B4 reads each slot's length*KVH*hd*2*2 bytes, B10 every row of the
// touched pages. The flops (4*B*H*rows*hd) are negligible. The design
// spends its parallelism on keeping many row loads in flight (16 warps, 4
// rows unrolled per warp); the grid is only B*KVH CTAs, so this first form
// leaves most SMs idle — a split over the rows with a second combine pass
// is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 1024;
constexpr int kUnroll = 4;
constexpr unsigned kFull = 0xffffffffu;

enum Mode {
  kPagedSparse = 0, kPagedDense = 1, kContigSparse = 2, kPagedPages = 3,
  kPagedSparseMq = 4
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// One instantiation per mode: each form compiles without the others'
// branches (only B10 carries per-row weights).
template <typename T, int G, int DPL, int MODE>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                   const T* __restrict__ vp, const int* __restrict__ table,
                   const int* __restrict__ idx, const int* __restrict__ lengths,
                   int kvh, int ps, int mp, int num_pages, int kcols,
                   int window, int qrows, float scale,
                   float* __restrict__ out) {
  constexpr int HD = 32 * DPL;
  constexpr bool PG = MODE == kPagedPages;
  extern __shared__ float sm[];
  __shared__ int npg_s;
  const int n = mp * ps;
  int* rows = reinterpret_cast<int*>(sm);                 // (kChunk,)
  float* wts = sm + kChunk;                               // (kChunk,) PG only
  float* m_s = wts + (PG ? kChunk : 0);                   // (kWarps, G)
  float* l_s = m_s + kWarps * G;                          // (kWarps, G)
  float* a_s = l_s + kWarps * G;                          // (kWarps, G, HD)
  // B10 only: 16-bit selection count per logical position, page flags and
  // the compacted page list
  unsigned* cnt = reinterpret_cast<unsigned*>(a_s + kWarps * G * HD);
  int* pflag = reinterpret_cast<int*>(cnt + (n + 1) / 2);  // (mp,)
  int* plist = pflag + mp;                                 // (mp,)

  const int kh = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int h = kvh * G;
  const int len = lengths[b];
  const int ext = len < n ? len : n;
  const int* ib = idx ? idx + (size_t)b * kcols : nullptr;      // not B4
  // B8: query row b belongs to slot b / qrows (not B6)
  const int tb_row = MODE == kPagedSparseMq ? b / qrows : b;
  const int* tb = table ? table + (size_t)tb_row * mp : nullptr;
  int start = 0, count;
  if constexpr (MODE == kPagedDense) {
    if (window > 0 && ext - window > 0) start = ext - window;
    count = ext > start ? ext - start : 0;
  } else if constexpr (PG) {
    for (int i = threadIdx.x; i < (n + 1) / 2; i += kThreads) cnt[i] = 0u;
    for (int i = threadIdx.x; i < mp; i += kThreads) pflag[i] = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < kcols; i += kThreads) {
      const int pos = ib[i];
      if (pos < 0 || pos >= ext) continue;
      const int phys = tb[pos / ps];
      if (phys < 0 || phys >= num_pages) continue;
      atomicAdd(&cnt[pos >> 1], 1u << ((pos & 1) * 16));
      pflag[pos / ps] = 1;
    }
    __syncthreads();
    if (w == 0) {
      int total = 0;
      for (int base = 0; base < mp; base += 32) {
        const bool f = base + lane < mp && pflag[base + lane] != 0;
        const unsigned bal = __ballot_sync(kFull, f);
        if (f) plist[total + __popc(bal & ((1u << lane) - 1u))] = base + lane;
        total += __popc(bal);
      }
      if (lane == 0) npg_s = total;
    }
    __syncthreads();
    count = npg_s * ps;
  } else {
    count = kcols;
  }

  float qr[G][DPL], acc[G][DPL], mx[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const T* qg = q + ((size_t)b * h + kh * G + g) * HD + lane * DPL;
#pragma unroll
    for (int t = 0; t < DPL; ++t) { qr[g][t] = to_f32(qg[t]); acc[g][t] = 0.f; }
    mx[g] = -INFINITY;
    l[g] = 0.f;
  }

  for (int c0 = 0; c0 < count; c0 += kChunk) {
    const int cl = count - c0 < kChunk ? count - c0 : kChunk;
    for (int i = threadIdx.x; i < cl; i += kThreads) {
      const int e = c0 + i;
      int row = -1;
      if constexpr (PG) {
        const int lp = plist[e / ps], pos = lp * ps + e % ps;
        row = tb[lp] * ps + e % ps;                 // mapped by construction
        wts[i] = (float)((cnt[pos >> 1] >> ((pos & 1) * 16)) & 0xffffu);
      } else {
        const int pos = MODE == kPagedDense ? start + e : ib[e];
        if (pos >= 0 && pos < ext) {
          if constexpr (MODE == kContigSparse) {
            row = b * n + pos;
          } else {
            const int phys = tb[pos / ps];
            if (phys >= 0 && phys < num_pages) row = phys * ps + pos % ps;
          }
        }
      }
      rows[i] = row;
    }
    __syncthreads();
    for (int i0 = w * kUnroll; i0 < cl; i0 += kWarps * kUnroll) {
      int r[kUnroll];
      float wu[kUnroll];
      float kr[kUnroll][DPL], vr[kUnroll][DPL];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        r[u] = i0 + u < cl ? rows[i0 + u] : -1;
        if constexpr (PG) wu[u] = i0 + u < cl ? wts[i0 + u] : 0.f;
        if (r[u] >= 0) {
          const size_t off = ((size_t)r[u] * kvh + kh) * HD + lane * DPL;
#pragma unroll
          for (int t = 0; t < DPL; ++t) {
            kr[u][t] = to_f32(kp[off + t]);
            vr[u][t] = to_f32(vp[off + t]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r[u] < 0) continue;                 // warp-uniform
        if constexpr (PG) {
          if (wu[u] == 0.f) continue;           // read with its page, masked
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float s = 0.f;
#pragma unroll
          for (int t = 0; t < DPL; ++t) s = fmaf(qr[g][t], kr[u][t], s);
          for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
          s *= scale;
          const float m_new = fmaxf(mx[g], s);
          const float alpha = expf(mx[g] - m_new);   // exp(-inf) = 0 at start
          float p = expf(s - m_new);
          if constexpr (PG) p *= wu[u];
          l[g] = fmaf(l[g], alpha, p);
#pragma unroll
          for (int t = 0; t < DPL; ++t) acc[g][t] = fmaf(acc[g][t], alpha, p * vr[u][t]);
          mx[g] = m_new;
        }
      }
    }
    __syncthreads();
  }

  // merge the per-warp partial softmax states
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) { m_s[w * G + g] = mx[g]; l_s[w * G + g] = l[g]; }
#pragma unroll
    for (int t = 0; t < DPL; ++t) a_s[(w * G + g) * HD + lane * DPL + t] = acc[g][t];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < G * HD; e += kThreads) {
    const int g = e / HD, dim = e - g * HD;
    float mm = -INFINITY;
    for (int ww = 0; ww < kWarps; ++ww) mm = fmaxf(mm, m_s[ww * G + g]);
    float res = 0.f;
    if (isfinite(mm)) {
      float ll = 0.f, aa = 0.f;
      for (int ww = 0; ww < kWarps; ++ww) {
        const float mw = m_s[ww * G + g];
        if (!isfinite(mw)) continue;
        const float f = expf(mw - mm);
        ll = fmaf(l_s[ww * G + g], f, ll);
        aa = fmaf(a_s[(ww * G + g) * HD + dim], f, aa);
      }
      res = aa / fmaxf(ll, 1e-30f);
    }
    out[((size_t)b * h + kh * G + g) * HD + dim] = res;
  }
}

template <typename T, int G, int DPL, int MODE>
int launch(const void* q, const void* kp, const void* vp,
           const int* table, const int* idx, const int* lengths, int b,
           int kvh, int ps, int mp, int num_pages, int kcols, int window,
           int qrows, float scale, float* out, cudaStream_t stream) {
  size_t smem = ((size_t)kChunk + 2 * kWarps * G + (size_t)kWarps * G * 32 * DPL) * 4;
  if (MODE == kPagedPages)
    smem += ((size_t)kChunk + (size_t)(mp * ps + 1) / 2 + 2 * (size_t)mp) * 4;
  auto kern = decode_attn_kernel<T, G, DPL, MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(kvh, b);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), table, idx, lengths, kvh, ps, mp, num_pages,
      kcols, window, qrows, scale, out);
  return (int)cudaGetLastError();
}

template <typename T, int G, int DPL>
int by_mode(int mode, const void* q, const void* kp, const void* vp,
            const int* table, const int* idx, const int* lengths, int b,
            int kvh, int ps, int mp, int num_pages, int kcols, int window,
            int qrows, float scale, float* out, cudaStream_t st) {
  switch (mode) {
    case kPagedSparse: return launch<T, G, DPL, kPagedSparse>(q, kp, vp, table, idx, lengths, b, kvh, ps, mp, num_pages, kcols, window, qrows, scale, out, st);
    case kPagedDense: return launch<T, G, DPL, kPagedDense>(q, kp, vp, table, idx, lengths, b, kvh, ps, mp, num_pages, kcols, window, qrows, scale, out, st);
    case kContigSparse: return launch<T, G, DPL, kContigSparse>(q, kp, vp, table, idx, lengths, b, kvh, ps, mp, num_pages, kcols, window, qrows, scale, out, st);
    case kPagedPages: return launch<T, G, DPL, kPagedPages>(q, kp, vp, table, idx, lengths, b, kvh, ps, mp, num_pages, kcols, window, qrows, scale, out, st);
    case kPagedSparseMq: return launch<T, G, DPL, kPagedSparseMq>(q, kp, vp, table, idx, lengths, b, kvh, ps, mp, num_pages, kcols, window, qrows, scale, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, int G>
int by_dpl(int dpl, int mode, const void* q, const void* kp, const void* vp,
           const int* table, const int* idx, const int* lengths, int b,
           int kvh, int ps, int mp, int num_pages, int kcols, int window,
           int qrows, float scale, float* out, cudaStream_t st) {
  switch (dpl) {
    case 1: return by_mode<T, G, 1>(mode, q, kp, vp, table, idx, lengths, b, kvh, ps, mp, num_pages, kcols, window, qrows, scale, out, st);
    case 2: return by_mode<T, G, 2>(mode, q, kp, vp, table, idx, lengths, b, kvh, ps, mp, num_pages, kcols, window, qrows, scale, out, st);
    case 4: return by_mode<T, G, 4>(mode, q, kp, vp, table, idx, lengths, b, kvh, ps, mp, num_pages, kcols, window, qrows, scale, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int by_group(int g, int dpl, int mode, const void* q, const void* kp,
             const void* vp, const int* table, const int* idx,
             const int* lengths, int b, int kvh, int ps, int mp, int num_pages,
             int kcols, int window, int qrows, float scale, float* out, cudaStream_t st) {
  switch (g) {
    case 1: return by_dpl<T, 1>(dpl, mode, q, kp, vp, table, idx, lengths, b, kvh, ps, mp, num_pages, kcols, window, qrows, scale, out, st);
    case 2: return by_dpl<T, 2>(dpl, mode, q, kp, vp, table, idx, lengths, b, kvh, ps, mp, num_pages, kcols, window, qrows, scale, out, st);
    case 4: return by_dpl<T, 4>(dpl, mode, q, kp, vp, table, idx, lengths, b, kvh, ps, mp, num_pages, kcols, window, qrows, scale, out, st);
    case 8: return by_dpl<T, 8>(dpl, mode, q, kp, vp, table, idx, lengths, b, kvh, ps, mp, num_pages, kcols, window, qrows, scale, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q and both caches share it).
// mode 0: sparse over idx (b, kcols) through table (b, mp) into pools
// (num_pages, ps, kvh, hd); 1: dense over [0, length) through the table,
// optional window (> 0); 2: sparse over idx into contiguous caches
// (b, mp, kvh, hd) with ps = 1, table unused; 3: as 0 at page granularity
// (kcols < 65536). g = H / KVH; dpl = hd / 32.
extern "C" int decode_attn_launch(int dtype, int mode, int g, int dpl,
                                  const void* q, const void* kp, const void* vp,
                                  const int* table, const int* idx,
                                  const int* lengths, int b, int kvh, int ps,
                                  int mp, int num_pages, int kcols, int window,
                                  float scale, float* out, void* stream) {
  if (mode == kPagedSparseMq) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return by_group<float>(g, dpl, mode, q, kp, vp, table, idx, lengths, b, kvh, ps, mp, num_pages, kcols, window, 1, scale, out, st);
  if (dtype == 1)
    return by_group<__nv_bfloat16>(g, dpl, mode, q, kp, vp, table, idx, lengths, b, kvh, ps, mp, num_pages, kcols, window, 1, scale, out, st);
  return (int)cudaErrorInvalidValue;
}

// B8: mode 0 over rows = B * qrows folded query rows — q (rows, H, hd), idx
// (rows, kcols), lengths (rows,), out (rows, H, hd) — with row r reading
// table row r / qrows of the shared (rows / qrows, mp) table.
extern "C" int decode_attn_mq_launch(int dtype, int g, int dpl, const void* q,
                                     const void* kp, const void* vp,
                                     const int* table, const int* idx,
                                     const int* lengths, int rows, int qrows,
                                     int kvh, int ps, int mp, int num_pages,
                                     int kcols, float scale, float* out,
                                     void* stream) {
  if (qrows < 1 || rows % qrows != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return by_group<float>(g, dpl, kPagedSparseMq, q, kp, vp, table, idx, lengths, rows, kvh, ps, mp, num_pages, kcols, 0, qrows, scale, out, st);
  if (dtype == 1)
    return by_group<__nv_bfloat16>(g, dpl, kPagedSparseMq, q, kp, vp, table, idx, lengths, rows, kvh, ps, mp, num_pages, kcols, 0, qrows, scale, out, st);
  return (int)cudaErrorInvalidValue;
}
