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
//
// The split over rows. The grid is (splits, KVH x head chunks, rows): one
// CTA of four warps serves one split of one (KV head, row) pair and one
// chunk of its grp = H/KVH query heads (GQA: head h reads KV head h / grp).
// A chunk is G <= 8 heads, the least power of two >= grp capped at 8
// (ops.attn_head_chunk), because the body keeps q, the scores and the PV
// sums of its G heads in registers (qf[G][EPL], s[G], acc[G]): at grp 48
// (granite-34b, MQA) one CTA would hold 48 x 8 + 96 floats a thread and
// spill, so grp 16 runs as 2 chunks of 8 and grp 48 as 6, each chunk
// streaming the same K/V rows (the second and later from L2). A grp that
// is no power of two (qwen2-vl's 7) runs as one chunk of 8 with the eighth
// head masked (a zero q, no output): that costs an eighth of the scoring
// FMAs, which the body has to spare (it is bound by its row gathers), and
// no template instance of its own (build time). Each head's arithmetic is
// that of the unchunked body (the heads share nothing but the rows), so a
// chunked launch changes no sum. The workspace and the tickets are per
// (row, KV head, chunk).
//
// The head dim. A row vector is C16 = HD*size/16 lanes of 16 bytes, HD a
// power of two (32, 64, 128) so that a row's lanes are a power-of-two
// group inside one warp (the butterfly sums) and the PV step's threads
// tile 128. A head dim below its lane width (h2o-danube's 120) runs on
// the 128-lane instance with the global strides at hd = 120: the lanes
// past the row are zero-filled by cp.async's predicate without a read and
// q's are zero, so they add exact zeros to each dot product's fixed
// butterfly, and PV threads past hd sum zeros and write nothing.
//
// A split is a fixed run of R
// entries of the row — R Top-K entries for B3/B6/B8, R positions (whole
// pages, R a multiple of ps) for B4 and B10 — so the split count
// ceil(count / R) depends on the row's entry count (B4, B10: the table's
// width) alone, never on B, Q, the lengths or the SM count, and a row's
// output depends on its own rows only. Inside a
// split the CTA translates its entries to rows of the flattened cache
// (idx -> table -> row; masked: idx < 0, idx >= length, unmapped page, and
// for B4 the window), then streams the rows in tiles of 32 through a
// shared-memory double buffer: 16-byte cp.async gathers, C16 = hd*size/16
// lanes per (row, KV head) vector (8 at hd=64 bf16), a masked row
// zero-filled without a read, the next tile's gathers in flight while the
// current one is scored. A tile is scored for all G heads with sub-warp
// reductions, then one max and one rescale per tile and head (a warp per
// head, a lane per row), then PV in f32 (the weights stay f32).
//
// The combine. Each CTA of a multi-split row writes its partial
// (m, l, acc[G][hd]) in f32 to a workspace the wrapper allocates; the last
// CTA of the (row, KV head, head chunk) triple to finish — an atomic
// ticket, one per triple, that it resets itself, so one launch does both
// passes — merges the partials in split
// order with the guards `isfinite(m)` and l >= 1e-30, and writes 0 for an
// all-masked row. The merge order is fixed and nothing else is atomic, so
// two calls on the same inputs agree bit for bit; B6 over a contiguous
// cache, B3 over pages holding the same rows and B8 against B3 on the
// folded rows (table repeated) take the same path and agree bit for bit.
// A row with one split writes its output directly (same arithmetic as a
// one-partial merge). The tickets are an int32 array the caller owns, zero
// when created and zero again after every launch; two launches that may
// overlap in time (two streams) must not share one.
//
// B10 splits over logical positions: a split is a fixed run of R
// positions made of whole pages (R a multiple of ps; ops.py takes the least
// multiple of ps that is >= 256 and >= MP*ps/64, so at most 64 splits), and
// the split count depends on the table width and the page size alone. A
// split that begins at or past the row's extent has nothing to add and ends
// at once; the live splits, ceil(extent / R) of them (at least one, which
// writes 0 for an empty row), are a function of the row's own length, and
// only they merge (an empty partial adds nothing to a merge, so the bits
// are those of merging all splits). A live CTA loads the row's idx in one
// unrolled batch a thread (coalesced; the other splits' CTAs find it in
// L2), counts each valid entry that falls in its positions into a 16-bit
// count per position (shared-memory atomics on integers, so the counts do
// not depend on the order), compacts the positions with a non-zero count in
// ascending order (a warp per quarter of the counts, ballots within it: one
// sweep counts, one barrier shares the warp totals, one sweep writes) and
// runs the rows through the same tile loop, with four tiles in flight (a
// split of a row whose entries crowd into few positions walks hundreds of
// rows), weighting a row by its count. What remains of its time on the
// H100 (PERF.md): the merge of up to 64 partials in the last CTA's tail,
// and on long rows the prologue, since every KV head's CTA of a split scans
// the whole idx row. Its shared memory is O(R + min(K, R)), independent of
// the table width. The partials merge as B3's do, in split order, so the
// sum runs in page order: it agrees with the Top-K-ordered plain version to
// rounding only; a duplicate entry counts as often as the token-granular
// form counts it. The sparse length mask is one the Pallas kernels lack
// (the served XLA path has it).
//
// Bound on an H100: the bytes of the rows it must read. B3/B6 at B=4,
// K=2048, KVH=8, hd=64, bf16: 4*2048*8*64*2*2 = 16.8 MB, ~5 us at 3.35
// TB/s; B8 the distinct (slot, row) pairs its Q rows select (this design
// reads each row once per query row); B4 each slot's length*KVH*hd*2*2
// bytes. The flops (4*B*H*rows*hd) are negligible. A gathered row vector
// is only 128 B, so the bound is reached only with many gathers in flight:
// the split gives B3 16*8*4 = 512 CTAs at B=4, K=2048 (B4 2048 at N=8192)
// where one CTA per (KV head, slot) gave 32, and each CTA keeps two tiles
// (16 KB at hd=64 bf16) in flight. B10 is held to B3's bound (it computes
// B3's function over the same rows); its design reads each distinct
// selected row once, and each CTA also reads the row's K indices (8 KB at
// K=2048) from L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;          // rows per tile: one lane per row in the softmax step
constexpr int kStages = 2;         // tiles in flight (double buffer)
constexpr int kPgStages = 4;       // B10: tiles in flight on its longer runs of rows
constexpr int kPgScan = 16;        // B10: idx entries a thread loads before using them
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

enum Mode {
  kPagedSparse = 0, kPagedDense = 1, kContigSparse = 2, kPagedPages = 3,
  kPagedSparseMq = 4
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// 16 bytes of the cache dtype as floats (bf16 -> f32 is exact: the bits
// shifted into the high half)
__device__ __forceinline__ void unpack16(const uint4 u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack16(const uint4 u, float (&f)[8]) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// 16-byte asynchronous copy global -> shared; valid == false zero-fills
// the destination without reading the source
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(n) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

struct Args {
  const void* q; const void* kp; const void* vp;
  const int* table; const int* idx; const int* lengths;
  int rows, qrows, kvh, grp, chunks, hd, ps, mp, num_pages, kcols, window,
      rps, splits;
  float scale;
  float* ws; unsigned* tickets; float* out;
  cudaStream_t stream;
};

// G: the heads of one CTA (a chunk of the KV head's grp query heads, the
// last chunk's heads past grp masked); HD: the lane width of a row vector,
// hd (the head dim, runtime) padded up to it. The compiler is held to 6
// CTAs an SM at G <= 4 (at most 85 registers a thread) and to 4 elsewhere
// (128): left free it gave the G 4 instances ~125 registers where they
// had needed 72, and the launches of many CTAs (B4, B8) lost a third of
// their occupancy. B10 keeps its 16 idx loads a thread in flight in
// registers (~122), as before.
template <typename T, int G, int HD, int MODE>
__global__ void __launch_bounds__(kThreads,
                                  (G <= 4 && MODE != kPagedPages ? 6 : 4))
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                   const T* __restrict__ vp, const int* __restrict__ table,
                   const int* __restrict__ idx, const int* __restrict__ lengths,
                   int kvh, int grp, int hd_arg, int ps, int mp, int num_pages,
                   int kcols, int window, int qrows, int rps, float scale,
                   float* __restrict__ ws, unsigned* __restrict__ tickets,
                   float* __restrict__ out) {
  constexpr bool PG = MODE == kPagedPages;
  constexpr int STG = PG ? kPgStages : kStages;
  constexpr int EPL = 16 / (int)sizeof(T);   // elements per 16-byte chunk
  constexpr int C16 = HD / EPL;              // chunks (lanes) per row vector
  constexpr int RPP = kThreads / C16;        // rows scored per pass
  constexpr int NRG = kThreads / HD;         // row groups of the PV step
  static_assert(C16 >= 1 && C16 <= 32 && kTile % RPP == 0, "tile shape");
  static_assert(NRG >= 1 && kThreads % HD == 0, "PV shape");
  // the head dim: the lane width itself below 128 lanes (a constant), the
  // runtime value (120 or 128) at 128
  const int hd = HD == 128 ? hd_arg : HD;
  const int creal = hd / EPL;                // chunks that hold the row

  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last_s, warp_n[kWarps];
  // entries translated at a time; B10: its split's selected rows, at most
  // one per entry and one per position
  const int chunk = PG ? min(kcols, rps) : rps;
  const int n = mp * ps;
  T* kbuf = reinterpret_cast<T*>(smem);                        // (STG, kTile, HD)
  T* vbuf = kbuf + STG * kTile * HD;                           // (STG, kTile, HD)
  float* red = reinterpret_cast<float*>(smem);                 // (NRG, G, HD), after the loop
  int* rows_s = reinterpret_cast<int*>(vbuf + STG * kTile * HD);       // (chunk,)
  float* w_s = reinterpret_cast<float*>(rows_s + chunk);       // (chunk,) B10 only
  float* p_s = w_s + (PG ? chunk : 0);                         // (G, kTile) scores, then weights
  float* alpha_s = p_s + G * kTile;                            // (G,)
  float* m_s = alpha_s + G;                                    // (G,)
  float* l_s = m_s + G;                                        // (G,)
  // B10 only: a 16-bit selection count per position of the split
  unsigned* cnt = reinterpret_cast<unsigned*>(l_s + G);        // ((rps+1)/2,)

  const int split = blockIdx.x, b = blockIdx.z;
  const int nch = (int)gridDim.y / kvh;      // head chunks per KV head
  const int kh = blockIdx.y / nch, hc = (blockIdx.y - kh * nch) * G;
  const int gv = min(G, grp - hc);           // live heads of this chunk
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int h = kvh * grp;
  const int len = lengths[b];
  const int ext = len < n ? len : n;
  const int* ib = idx ? idx + (size_t)b * kcols : nullptr;        // not B4
  // B8: query row b belongs to slot b / qrows (not B6)
  const int tb_row = MODE == kPagedSparseMq ? b / qrows : b;
  const int* tb = table ? table + (size_t)tb_row * mp : nullptr;
  // B10: the splits that merge are those that begin inside the row's
  // extent (at least one, which writes 0 for an empty row); a split past it
  // has nothing to add and ends here. The other modes merge all splits.
  int live_pg = 0;
  if constexpr (PG) {
    live_pg = max(1, min((int)gridDim.x, (ext + rps - 1) / rps));
    if (split >= live_pg) return;
  }

  if (t < G) { m_s[t] = -INFINITY; l_s[t] = 0.f; }
  // this CTA's entries [e0, e1): B4 positions clipped to the window and the
  // extent, the sparse modes a run of rps Top-K entries, B10 the selected
  // rows of its positions, compacted into rows_s / w_s before the loop
  int e0 = 0, e1 = 0;
  if constexpr (MODE == kPagedDense) {
    const int start = window > 0 && ext - window > 0 ? ext - window : 0;
    e0 = max(split * rps, start);
    e1 = min((split + 1) * rps, ext);
  } else if constexpr (PG) {
    // positions [p0, p0 + span) of the extent (span <= 0: an empty row)
    const int p0 = split * rps;
    const int span = min(rps, ext - p0);
    if (span > 0) {
      const int nw = (span + 1) / 2;                   // two counts a word
      for (int i = t; i < nw; i += kThreads) cnt[i] = 0u;
      __syncthreads();
      for (int base = t; base < kcols; base += kPgScan * kThreads) {
        int pos[kPgScan];                              // loads in flight together
#pragma unroll
        for (int j = 0; j < kPgScan; ++j) {
          const int i = base + j * kThreads;
          pos[j] = i < kcols ? ib[i] : -1;
        }
#pragma unroll
        for (int j = 0; j < kPgScan; ++j) {
          const int l = pos[j] - p0;
          if (l < 0 || l >= span) continue;            // -1 too: p0 >= 0
          const int phys = tb[pos[j] / ps];
          if (phys < 0 || phys >= num_pages) continue;
          atomicAdd(&cnt[l >> 1], 1u << ((l & 1) * 16));
        }
      }
      __syncthreads();
      // compaction in ascending position: warp w owns the words [w0, w1),
      // lane j of a 32-word group positions 2j and 2j + 1; a first pass
      // counts the warp's selected positions, a second writes them
      const int per = (nw + kWarps * 32 - 1) / (kWarps * 32) * 32;
      const int w0 = min(w * per, nw), w1 = min(w0 + per, nw);
      const unsigned below = (1u << lane) - 1u;
      int mine = 0;
      for (int base = w0; base < w1; base += 32) {
        const unsigned c = base + lane < w1 ? cnt[base + lane] : 0u;
        mine += __popc(__ballot_sync(kFull, (c & 0xffffu) != 0u))
                + __popc(__ballot_sync(kFull, (c >> 16) != 0u));
      }
      if (lane == 0) warp_n[w] = mine;
      __syncthreads();
      int k = 0;
#pragma unroll
      for (int ww = 0; ww < kWarps; ++ww) {
        if (ww < w) k += warp_n[ww];
        e1 += warp_n[ww];
      }
      for (int base = w0; base < w1; base += 32) {
        const int i = base + lane;
        const unsigned c = i < w1 ? cnt[i] : 0u;
        const unsigned lo = c & 0xffffu, hi = c >> 16;
        const unsigned blo = __ballot_sync(kFull, lo != 0u);
        const unsigned bhi = __ballot_sync(kFull, hi != 0u);
        int o = k + __popc(blo & below) + __popc(bhi & below);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const unsigned cc = half ? hi : lo;
          if (cc == 0u) continue;
          const int pos = p0 + 2 * i + half;
          rows_s[o] = tb[pos / ps] * ps + pos % ps;   // mapped: it was counted
          w_s[o] = (float)cc;
          ++o;
        }
        k += __popc(blo) + __popc(bhi);
      }
    }
  } else {
    e0 = split * rps;
    e1 = min(e0 + rps, kcols);
  }

  // scoring: lane lc of each row group holds q's chunk lc for all G heads
  // (zero past the row and for a masked head)
  const int lc = t % C16, rr = t / C16;
  float qf[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const bool live = g < gv && lc < creal;
    const T* qg = q + ((size_t)b * h + kh * grp + hc + g) * hd + lc * EPL;
#pragma unroll
    for (int i = 0; i < EPL; ++i) qf[g][i] = live ? to_f32(qg[i]) : 0.f;
  }
  // PV: thread (d, rg) accumulates dimension d over rows r = rg mod NRG
  const int d = t % HD, rg = t / HD;
  float acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.f;

  for (int c0 = e0; c0 < e1; c0 += chunk) {
    const int cl = min(chunk, e1 - c0);
    if constexpr (!PG) {
      for (int i = t; i < cl; i += kThreads) {
        const int e = c0 + i;
        int row = -1;
        if constexpr (MODE == kPagedDense) {
          const int phys = tb[e / ps];                   // e in [start, ext)
          if (phys >= 0 && phys < num_pages) row = phys * ps + e % ps;
        } else {
          const int pos = ib[e];
          if (pos >= 0 && pos < ext) {
            if constexpr (MODE == kContigSparse) {
              row = b * n + pos;
            } else {
              const int phys = tb[pos / ps];
              if (phys >= 0 && phys < num_pages) row = phys * ps + pos % ps;
            }
          }
        }
        rows_s[i] = row;
      }
    }
    __syncthreads();

    const int ntile = (cl + kTile - 1) / kTile;
    auto issue = [&](int tile) {
      T* kb = kbuf + (tile % STG) * kTile * HD;
      T* vb = vbuf + (tile % STG) * kTile * HD;
      for (int i = t; i < 2 * kTile * C16; i += kThreads) {
        const int which = i / (kTile * C16);           // 0: K, 1: V
        const int rem = i - which * kTile * C16;
        const int r = rem / C16, c = rem - r * C16;
        const int e = tile * kTile + r;
        const int row = e < cl ? rows_s[e] : -1;
        const T* src = which ? vp : kp;
        // lanes past the row (hd < HD) are zero-filled without a read
        const bool ld = row >= 0 && c < creal;
        const T* gp = ld ? src + ((size_t)row * kvh + kh) * hd + c * EPL : src;
        cp_async16((which ? vb : kb) + r * HD + c * EPL, gp, ld);
      }
    };
    issue(0);
    cp_async_commit();
#pragma unroll
    for (int st = 1; st < STG; ++st) {
      if (st < ntile) issue(st);
      cp_async_commit();
    }

    for (int tl = 0; tl < ntile; ++tl) {
      cp_async_wait<STG - 1>();                        // tile tl has landed
      __syncthreads();
      const T* kb = kbuf + (tl % STG) * kTile * HD;
      const T* vb = vbuf + (tl % STG) * kTile * HD;
      // scores of the tile's rows for all G heads
#pragma unroll
      for (int r0 = 0; r0 < kTile; r0 += RPP) {
        const int r = r0 + rr;
        float kf[EPL];
        unpack16(*reinterpret_cast<const uint4*>(kb + r * HD + lc * EPL), kf);
        float s[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          s[g] = 0.f;
#pragma unroll
          for (int i = 0; i < EPL; ++i) s[g] = fmaf(qf[g][i], kf[i], s[g]);
        }
#pragma unroll
        for (int o = C16 / 2; o > 0; o >>= 1) {
#pragma unroll
          for (int g = 0; g < G; ++g) s[g] += __shfl_xor_sync(kFull, s[g], o);
        }
        if (lc == 0) {
          const int e = tl * kTile + r;
          const bool ok = e < cl && rows_s[e] >= 0;
#pragma unroll
          for (int g = 0; g < G; ++g) p_s[g * kTile + r] = ok ? s[g] * scale : -INFINITY;
        }
      }
      __syncthreads();
      // one max and one rescale per tile and head: warp w owns heads
      // w, w + kWarps, ...; lane j holds row j
      for (int g = w; g < G; g += kWarps) {
        const float s = p_s[g * kTile + lane];
        float mx = s;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
        const float m_old = m_s[g];
        const float m_new = fmaxf(m_old, mx);
        float p = 0.f, alpha = 1.f;
        if (m_new != -INFINITY) {
          alpha = expf(m_old - m_new);                   // 0 on the first live tile
          p = expf(s - m_new);                           // masked rows: 0
          if constexpr (PG) {
            const int e = tl * kTile + lane;
            p *= e < cl ? w_s[e] : 0.f;
          }
        }
        float sum = p;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
        p_s[g * kTile + lane] = p;
        __syncwarp();
        if (lane == 0) {
          m_s[g] = m_new;
          l_s[g] = fmaf(l_s[g], alpha, sum);
          alpha_s[g] = alpha;
        }
      }
      __syncthreads();
      // PV in f32
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g] *= alpha_s[g];
#pragma unroll 4
      for (int r = rg; r < kTile; r += NRG) {
        const float v = to_f32(vb[r * HD + d]);
#pragma unroll
        for (int g = 0; g < G; ++g) acc[g] = fmaf(p_s[g * kTile + r], v, acc[g]);
      }
      __syncthreads();                                   // buffer tl % STG is free
      if (tl + STG < ntile) issue(tl + STG);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // sum the row groups' partial PV (the buffers are free now)
  if constexpr (NRG > 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) red[(rg * G + g) * HD + d] = acc[g];
    __syncthreads();
    if (rg == 0) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float a = red[g * HD + d];
        for (int k = 1; k < NRG; ++k) a += red[(k * G + g) * HD + d];
        acc[g] = a;
      }
    }
  }

  // the chunk's live heads, dimensions [0, hd) (threads past hd idle)
  float* ob = out + ((size_t)b * h + kh * grp + hc) * hd;
  const int ns = PG ? live_pg : (int)gridDim.x;         // partials to merge
  if (ns == 1) {
    if (t < hd) {
#pragma unroll
      for (int g = 0; g < G; ++g)
        if (g < gv)
          ob[g * hd + d] = isfinite(m_s[g]) ? acc[g] / fmaxf(l_s[g], 1e-30f) : 0.f;
    }
    return;
  }

  // the combine: write this split's partial, draw a ticket; the last of the
  // live CTAs of the (row, KV head, head chunk) triple merges their
  // partials in split order
  const int kPart = G * (hd + 2);                      // m[G], l[G], acc[G][hd]
  const size_t pair = (size_t)b * gridDim.y + blockIdx.y;
  float* part = ws + (pair * gridDim.x + split) * kPart;
  if (t < hd) {
#pragma unroll
    for (int g = 0; g < G; ++g) part[2 * G + g * hd + d] = acc[g];
  }
  if (t < G) { part[t] = m_s[t]; part[G + t] = l_s[t]; }
  __threadfence();
  __syncthreads();
  if (t == 0) {
    const unsigned tk = atomicAdd(&tickets[pair], 1u);
    const bool last = tk == (unsigned)ns - 1u;
    if (last) tickets[pair] = 0u;
    last_s = last;
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  const float* pb = ws + pair * gridDim.x * kPart;
  // a fixed trip count over the lane width (unrolled, shifts), the masked
  // heads and the lanes past hd skipped
  for (int e = t; e < G * HD; e += kThreads) {
    const int g = e / HD, dd = e % HD;
    if (g >= gv || dd >= hd) continue;
    float mm = -INFINITY;
    for (int s = 0; s < ns; ++s) mm = fmaxf(mm, __ldcg(pb + (size_t)s * kPart + g));
    float res = 0.f;
    if (isfinite(mm)) {
      float ll = 0.f, aa = 0.f;
      for (int s = 0; s < ns; ++s) {
        const float* ps_ = pb + (size_t)s * kPart;
        const float ms = __ldcg(ps_ + g);
        if (!isfinite(ms)) continue;
        const float f = expf(ms - mm);
        ll = fmaf(__ldcg(ps_ + G + g), f, ll);
        aa = fmaf(__ldcg(ps_ + 2 * G + g * hd + dd), f, aa);
      }
      res = aa / fmaxf(ll, 1e-30f);
    }
    ob[g * hd + dd] = res;
  }
}

template <typename T, int G, int HD, int MODE>
size_t smem_bytes(const Args& a) {
  const int chunk = MODE == kPagedPages ? (a.kcols < a.rps ? a.kcols : a.rps) : a.rps;
  const int stg = MODE == kPagedPages ? kPgStages : kStages;
  size_t s = (size_t)2 * stg * kTile * HD * sizeof(T) + (size_t)chunk * 4
             + (size_t)G * kTile * 4 + (size_t)3 * G * 4;
  if (MODE == kPagedPages) s += (size_t)chunk * 4 + ((size_t)a.rps + 1) / 2 * 4;
  return s;
}

template <typename T, int G, int HD, int MODE>
int launch(const Args& a) {
  auto kern = decode_attn_kernel<T, G, HD, MODE>;
  const size_t smem = smem_bytes<T, G, HD, MODE>(a);
  // the dynamic shared-memory limit is raised once per instance and device
  // (B10's size follows its split length and K, so it is raised again only
  // when a launch needs more than any before it)
  static size_t raised[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && smem > raised[dev]) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();          // a refused size must not fail the next launch
      return (int)err;
    }
    raised[dev] = smem;
  }
  dim3 grid(a.splits, a.kvh * a.chunks, a.rows);
  kern<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.kp),
      static_cast<const T*>(a.vp), a.table, a.idx, a.lengths, a.kvh, a.grp,
      a.hd, a.ps, a.mp, a.num_pages, a.kcols, a.window, a.qrows, a.rps,
      a.scale, a.ws, a.tickets, a.out);
  return (int)cudaGetLastError();
}

template <typename T, int G, int HD>
int by_mode(int mode, const Args& a) {
  switch (mode) {
    case kPagedSparse: return launch<T, G, HD, kPagedSparse>(a);
    case kPagedDense: return launch<T, G, HD, kPagedDense>(a);
    case kContigSparse: return launch<T, G, HD, kContigSparse>(a);
    case kPagedPages: return launch<T, G, HD, kPagedPages>(a);
    case kPagedSparseMq: return launch<T, G, HD, kPagedSparseMq>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

// the lane width a head dim runs at: 32, 64, or 128 (hd 120 padded)
template <typename T, int G>
int by_hd(int hd, int mode, const Args& a) {
  switch (hd) {
    case 32: return by_mode<T, G, 32>(mode, a);
    case 64: return by_mode<T, G, 64>(mode, a);
    case 120: case 128: return by_mode<T, G, 128>(mode, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int by_group(int g, int hd, int mode, const Args& a) {
  switch (g) {
    case 1: return by_hd<T, 1>(hd, mode, a);
    case 2: return by_hd<T, 2>(hd, mode, a);
    case 4: return by_hd<T, 4>(hd, mode, a);
    case 8: return by_hd<T, 8>(hd, mode, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q and both caches share it); grp =
// H/KVH query heads per KV head, laid over ceil(grp / gc) head chunks of gc
// in {1, 2, 4, 8} heads (the last chunk's heads past grp masked); hd in
// {32, 64, 120, 128} (120 runs on 128 lanes, the last 8 zero). Modes over
// `rows` query rows of q (rows, H, hd), lengths (rows,), out (rows, H, hd)
// f32:
//   0 sparse over idx (rows, kcols) through table (rows, mp) into pools
//     (num_pages, ps, kvh, hd);
//   1 dense over [0, length) through the table, optional window (> 0);
//   2 sparse over idx into contiguous caches (rows, mp, kvh, hd), ps = 1,
//     table unused;
//   3 as 0 at page granularity (kcols < 65536; rps positions a split, a
//     multiple of ps);
//   4 (B8) as 0 with row r on table row r / qrows of a (rows / qrows, mp)
//     table.
// A split covers rps entries (modes 1 and 3: rps positions, a multiple of
// ps); the grid is (splits, kvh * chunks, rows), splits * rps >= kcols
// (modes 1 and 3: >= mp * ps).
// With splits > 1, ws holds rows * kvh * chunks * splits * gc * (hd + 2)
// floats and tickets rows * kvh * chunks zeroed int32 counters, left zero
// by the launch; a launch that may overlap this one in time needs tickets
// of its own. The schedule's limits (grid, int32 rows, 16-bit counts,
// shared memory) are checked here alone: a launch beyond them returns an
// error code.
extern "C" int decode_attn_launch(int dtype, int mode, int grp, int gc, int hd,
                                  const void* q, const void* kp, const void* vp,
                                  const int* table, const int* idx,
                                  const int* lengths, int rows, int qrows,
                                  int kvh, int ps, int mp, int num_pages,
                                  int kcols, int window, int rps, int splits,
                                  float scale, float* ws, unsigned* tickets,
                                  float* out, void* stream) {
  if (grp < 1 || gc < 1) return (int)cudaErrorInvalidValue;
  const int chunks = (grp + gc - 1) / gc;
  if (rows < 1 || rows > 65535 || kvh < 1 || (long long)kvh * chunks > 65535
      || splits < 1)
    return (int)cudaErrorInvalidValue;
  if (qrows < 1 || rows % qrows != 0 || (mode != kPagedSparseMq && qrows != 1))
    return (int)cudaErrorInvalidValue;
  // rows of the flattened cache are int32
  const long long cache_rows = (long long)num_pages * (mode == kContigSparse ? mp : ps);
  if (cache_rows >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  // modes 1 and 3 split whole pages of positions, the others Top-K entries
  const bool by_pos = mode == kPagedDense || mode == kPagedPages;
  const long long count = by_pos ? (long long)mp * ps : kcols;
  if (rps < 1 || (long long)splits * rps < count) return (int)cudaErrorInvalidValue;
  if (by_pos && rps % ps != 0) return (int)cudaErrorInvalidValue;
  if (mode == kPagedPages && kcols >= 65536)          // 16-bit selection counts
    return (int)cudaErrorInvalidValue;
  if (splits > 1 && (ws == nullptr || tickets == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a{q, kp, vp, table, idx, lengths, rows, qrows, kvh, grp, chunks, hd,
         ps, mp, num_pages, kcols, window, rps, splits, scale, ws, tickets,
         out, (cudaStream_t)stream};
  if (dtype == 0) return by_group<float>(gc, hd, mode, a);
  if (dtype == 1) return by_group<__nv_bfloat16>(gc, hd, mode, a);
  return (int)cudaErrorInvalidValue;
}
