// DSA indexer scoring (paper Eq. 1) — the first launch of the Hopper forms
// of kernels B2 (keys in a page pool, addressed through the block table),
// B5 (keys in a contiguous (B, N, d_i) cache) and B9 (B2 over the Q query
// rows of each slot's speculative verify tick); the second launch is the
// GVR Top-K kernel (B1, or for B9 its chained form) on the score rows this
// one writes.
//
// Replaces:
//   B2 src/repro/kernels/indexer_topk.py:paged_indexer_topk_pallas
//      (kernel _paged_fused_kernel), whose grid walked (slot, logical page)
//      and kept the score row in VMEM;
//   B5 src/repro/kernels/indexer_topk.py:indexer_topk_pallas (kernel
//      _fused_kernel), the same over a contiguous cache in kv_chunk tiles;
//   B9 src/repro/kernels/indexer_topk.py:paged_indexer_topk_mq_pallas
//      (kernel _paged_fused_mq_kernel), B2's grid with a query-row axis,
//      (B, Q, MP), each row masked at its own length L0 + q + 1.
// Every form writes
//     score[r, n] = sum_h w_h * ReLU(q_h . k_n)
// to a (rows, N) f32 row (0.13 MB at B=4, N=8192: it stays in L2 for the
// selection launch). Row r is a slot (B2, B5) or, for B9, one of the B*Q
// folded query rows: it reads table row r / Q of the shared table and its
// own q and length, so each of its score rows equals B2's for the same
// slot and length bit for bit. Positions >= length and positions on
// unmapped (-1) or out-of-range pages score the NEG sentinel and are never
// read (a -1 is never clipped to page 0). Under a sliding window (window >
// 0, h2o-danube's 4096) a row scores only [lo, length), lo = max(0,
// length - window) — the reference's `pos > length - 1 - window` mask
// (src/repro/sparse/dsa.py:dsa_select) — and positions below lo score NEG
// too: a tile wholly below lo is neither translated nor loaded, a tile
// across it zero-fills its rows below lo without a read. At 8192
// positions and a window of 4096 that halves the key bytes. B9's row r
// takes its own lo from its own length L0 + q + 1. The masks touch no sum
// of a kept position, so B5 == B2 and B9's rows == B2's hold under a
// window as without.
//
// Bound on an H100: the key bytes, each slot's keys up to its length read
// once (4.4 MB at the kernel phase's lengths 8192, 5000, 1000, 3001 with
// d_i = 128 in bf16, ~1.3 us at 3.35 TB/s; B9: each slot's keys up to its
// longest row, where this design reads them once per query row). The
// 2*sum(length)*H*d_i flops (0.28 GFLOP) are far below the bf16
// tensor-core roof: Eq. 1 is a small GEMM per tile, (H x d) . (d x tile).
//
// Two bodies, picked by the cache dtype alone (ops.score_route): a bf16
// call always runs the tensor-core body, a float32 call the CUDA-core
// body. There is no fallback from one to the other: TF32 would lose digits
// a float32 cache keeps, and a bf16 call that cannot launch raises.
//
// The bf16 body (indexer_scores_mma_kernel). The first form of it ran the
// dot products on the CUDA cores, one shared-memory load per FMA, from f32
// tiles staged with 2-byte loads into a transposed layout whose stores hit
// one bank 32 ways, re-staged the whole query for every 64-position tile
// and held ~65 KB of shared memory per CTA: ~40x its bound. Now the grid
// is (ctas_per_row, rows); a CTA of H_p / 16 warps (H padded to a multiple
// of 16 with zero query rows and zero weights) stages its row's query once
// in bf16 and scores tiles of 64 positions j = blockIdx.x, + gridDim.x,
// ... (two per CTA at the kernel phase's shapes, ops.score_ctas_per_row)
// through a ring of `stages` buffers that keeps all its tiles' copies in
// flight at once. A tile's row sources are resolved first, one position
// per thread (one table read each, not waiting for the length), then
// copied with 16-byte cp.async (d/8 per key row) into bf16 rows padded by
// 16 bytes, so the ldmatrix reads of 8 rows fall in 8 disjoint groups of
// 4 banks; a masked row is zero-filled without a read, and a tile wholly
// at or past the length is not loaded at all. Warp w computes its 16
// heads' (16 x d) . (d x 64) product with
// mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 (q rows are the A operand,
// a key row, d contiguous, is already the column-major B operand); the
// products of bf16 values are exact in f32 and the tensor core adds them
// in f32.
//
// The order of every sum depends on (H_p, d) alone, never on the tile,
// the page size, the layout, the schedule or the slot: each (head,
// position) dot product is the chain of d/16 MMAs in k order; a lane then
// holds heads g and g+8 of its warp's 16 for two positions and forms
// w_g ReLU(.) then fma(w_{g+8}, ReLU(.), that) (rounding pinned with
// __fmul_rn / __fmaf_rn), a fixed xor-shuffle tree over the 8 head pairs
// follows, and the warps' partials are added in warp order through shared
// memory. So B5 == B2 over the same keys, B9's rows == B2's, the paged
// and dense layouts select the same Top-K on the card, and a slot's row
// does not depend on the other slots or on the grid.
//
// The float32 body (indexer_scores_fma_kernel) is the first form, kept for
// float32 caches: one CTA per (tile, row), the key tile transposed in
// shared memory, one thread per position and HG heads; its order depends
// on (H, d) through HG (ops._heads_per_thread).
//
// Both raise the dynamic shared-memory limit once per template instance
// and device (only when a launch needs more than any before it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -3.4028234663852886e38f;
constexpr int kMaxDevices = 64;
constexpr int kMaxSmem = 227 * 1024;
constexpr int kTile = 64;       // positions per tile of the bf16 body
constexpr int kPad = 8;         // bf16 padding per shared row (16 bytes)
constexpr int kMaxWarps = 16;   // padded heads <= 256
constexpr int kMaxStages = 4;   // tile buffers of the bf16 body

// Raise `kern`'s dynamic shared-memory limit to `smem` on the current
// device if no launch of this instance asked for as much before.
template <typename K>
cudaError_t raise_smem(K kern, size_t smem, size_t (&raised)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && smem > raised[dev]) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    raised[dev] = smem;
  }
  return cudaSuccess;
}

// ------------------------------------------------------- float32 body ----

// grid (tiles, rows); block T * groups threads; group g owns heads
// [g*HG, (g+1)*HG). CONTIG: keys (B, n_out, d), tile j = positions
// [j*T, j*T + T) (the last tile may be short); else keys (P, T, d) pages
// and tile j = logical page j, physical page table[r / qrows, j].
template <int HG, bool CONTIG>
__global__ void indexer_scores_fma_kernel(
    const float* __restrict__ q, const float* __restrict__ keys,
    const float* __restrict__ w, int w_stride, const int* __restrict__ table,
    const int* __restrict__ lengths, int h, int d, int tile, int mp,
    int num_pages, int n_out, int qrows, int window,
    float* __restrict__ scores) {
  extern __shared__ float sm[];
  const int j = blockIdx.x, b = blockIdx.y;
  const int len = lengths[b];
  const int lo = window > 0 ? max(0, len - window) : 0;   // the window's start
  const int base = j * tile;
  const int rows = CONTIG ? min(tile, n_out - base) : tile;
  float* out = scores + (size_t)b * n_out + base;
  const float* kb;
  bool skip = base >= len || base + rows <= lo;
  if constexpr (CONTIG) {
    kb = keys + ((size_t)b * n_out + base) * d;
  } else {
    const int phys = table[(size_t)(b / qrows) * mp + j];
    skip = skip || phys < 0 || phys >= num_pages;
    kb = keys + (size_t)(phys < 0 ? 0 : phys) * tile * d;
  }
  if (skip) {
    for (int p = threadIdx.x; p < rows; p += blockDim.x) out[p] = kNeg;
    return;
  }
  float* qs = sm;                       // (h, d)
  float* kt = qs + h * d;               // (d, tile) — transposed tile
  float* part = kt + d * tile;          // (groups, tile)
  const float* qb = q + (size_t)b * h * d;
  const float* wb = w + (size_t)b * w_stride;
  for (int i = threadIdx.x; i < h * d; i += blockDim.x) qs[i] = qb[i];
  for (int i = threadIdx.x; i < rows * d; i += blockDim.x) {
    const int p = i / d, e = i - p * d;
    kt[e * tile + p] = kb[i];
  }
  __syncthreads();

  const int p = threadIdx.x % tile, g = threadIdx.x / tile;
  const int h0 = g * HG;
  float acc[HG];
#pragma unroll
  for (int u = 0; u < HG; ++u) acc[u] = 0.f;
  for (int e = 0; e < d; ++e) {
    const float kv = kt[e * tile + p];
#pragma unroll
    for (int u = 0; u < HG; ++u) acc[u] = fmaf(qs[(h0 + u) * d + e], kv, acc[u]);
  }
  float s = 0.f;
#pragma unroll
  for (int u = 0; u < HG; ++u) s = fmaf(wb[h0 + u], fmaxf(acc[u], 0.f), s);
  part[g * tile + p] = s;
  __syncthreads();
  if (g == 0 && p < rows) {
    const int groups = blockDim.x / tile;
    float tot = 0.f;
    for (int gg = 0; gg < groups; ++gg) tot += part[gg * tile + p];
    out[p] = base + p < len && base + p >= lo ? tot : kNeg;
  }
}

template <int HG, bool CONTIG>
int launch_fma(const float* q, const float* keys, const float* w,
               int w_stride, const int* table, const int* lengths, int rows,
               int h, int d, int tile, int mp, int num_pages, int n_out,
               int qrows, int window, float* scores, cudaStream_t stream) {
  const int groups = h / HG;
  if (tile < 1 || tile * groups > 1024) return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)h * d + (size_t)d * tile + (size_t)groups * tile) * 4;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kern = indexer_scores_fma_kernel<HG, CONTIG>;
  static size_t raised[kMaxDevices] = {};
  cudaError_t err = raise_smem(kern, smem, raised);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n_out + tile - 1) / tile, rows);
  kern<<<grid, tile * groups, smem, stream>>>(
      q, keys, w, w_stride, table, lengths, h, d, tile, mp, num_pages, n_out,
      qrows, window, scores);
  return (int)cudaGetLastError();
}

template <bool CONTIG>
int fma_by_heads(int hg, const float* q, const float* keys, const float* w,
                 int w_stride, const int* table, const int* lengths, int rows,
                 int h, int d, int tile, int mp, int num_pages, int n_out,
                 int qrows, int window, float* scores, cudaStream_t st) {
  switch (hg) {
    case 1: return launch_fma<1, CONTIG>(q, keys, w, w_stride, table, lengths, rows, h, d, tile, mp, num_pages, n_out, qrows, window, scores, st);
    case 2: return launch_fma<2, CONTIG>(q, keys, w, w_stride, table, lengths, rows, h, d, tile, mp, num_pages, n_out, qrows, window, scores, st);
    case 4: return launch_fma<4, CONTIG>(q, keys, w, w_stride, table, lengths, rows, h, d, tile, mp, num_pages, n_out, qrows, window, scores, st);
    case 8: return launch_fma<8, CONTIG>(q, keys, w, w_stride, table, lengths, rows, h, d, tile, mp, num_pages, n_out, qrows, window, scores, st);
    case 16: return launch_fma<16, CONTIG>(q, keys, w, w_stride, table, lengths, rows, h, d, tile, mp, num_pages, n_out, qrows, window, scores, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------- bf16 body ----

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
// wait until at most n (0..3) of this thread's copy groups are pending
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// four 8x8 b16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

// c += a . b for one m16n8k16 tile, bf16 inputs, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Row sources of tile j of row r: src[i] = the key row (of the flattened
// (rows * n_out) cache or (num_pages * ps) pool) of position j*64 + i, or
// -1 where that position is not scored (outside [lo, lim); for pages,
// unmapped or outside the pool). One table read per position, all in
// parallel; the CTA's copies then need no dependent load.
template <bool CONTIG>
__device__ __forceinline__ void tile_sources(
    int* src, const int* trow, int r, int j, int lo, int lim, int ps,
    int num_pages, int n_out) {
  for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
    const int pos = j * kTile + i;
    const bool in = pos >= lo && pos < lim;
    int row = -1;
    if constexpr (CONTIG) {
      if (in) row = r * n_out + pos;
    } else if (pos < n_out) {
      // the table read does not wait for the length
      const int phys = trow[pos / ps];
      if (in && phys >= 0 && phys < num_pages) row = phys * ps + pos % ps;
    }
    src[i] = row;
  }
}

// Queue the 16-byte copies of one tile's 64 key rows from their sources;
// a row with no source is zero-filled without a read.
__device__ __forceinline__ void copy_tile(
    __nv_bfloat16* ks, const int* src, const __nv_bfloat16* keys, int d,
    int ld) {
  const int chunks = d / 8;
  for (int c = threadIdx.x; c < kTile * chunks; c += blockDim.x) {
    const int row = c / chunks, e = (c - row * chunks) * 8;
    const int sr = src[row];
    cp_async16(ks + row * ld + e, sr >= 0 ? keys + (size_t)sr * d + e : keys,
               sr >= 0);
  }
}

// grid (ctas_per_row, rows); block 32 * H_p / 16 threads; `stages` tile
// buffers. CONTIG: keys (rows, n_out, d); else keys (num_pages, ps, d)
// through table row r / qrows of a (rows / qrows, mp) table, n_out = mp *
// ps. CTA c of row r scores tiles c, c + gridDim.x, ...; the copies of
// the next stages - 1 of them are in flight while one is scored.
template <bool CONTIG>
__global__ void __launch_bounds__(kMaxWarps * 32) indexer_scores_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ keys,
    const float* __restrict__ w, int w_stride, const int* __restrict__ table,
    const int* __restrict__ lengths, int h, int d, int ps, int mp,
    int num_pages, int n_out, int qrows, int window, int stages,
    float* __restrict__ scores) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nw = blockDim.x / 32, hp = nw * 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = blockIdx.y;
  const int ld = d + kPad;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);   // (hp, ld)
  __nv_bfloat16* ks = qs + hp * ld;                        // (stages, 64, ld)
  float* part = reinterpret_cast<float*>(ks + stages * kTile * ld);  // (nw, 64)
  int* src = reinterpret_cast<int*>(part + nw * kTile);    // (stages, 64)
  const int tiles = (n_out + kTile - 1) / kTile;
  const int* trow = CONTIG ? nullptr : table + (size_t)(r / qrows) * mp;
  float* out = scores + (size_t)r * n_out;

  // the row's query, once per CTA (padded heads zero), in the first group
  const __nv_bfloat16* qb = q + (size_t)r * h * d;
  const int chunks = d / 8;
  for (int c = threadIdx.x; c < hp * chunks; c += blockDim.x) {
    const int hh = c / chunks, e = (c - hh * chunks) * 8;
    cp_async16(qs + hh * ld + e, hh < h ? qb + (size_t)hh * d + e : qb, hh < h);
  }
  const int len = lengths[r];
  const int lim = min(len, n_out);
  const int lo = window > 0 ? max(0, len - window) : 0;   // the window's start
  // this CTA's i-th tile is blockIdx.x + i * gridDim.x; tile i goes to
  // buffer i % stages, in copy group i (the query joins group 0); a tile
  // with no position in [lo, lim) is neither translated nor loaded
  auto tile_of = [&](int i) { return (int)blockIdx.x + i * (int)gridDim.x; };
  auto live_tile = [&](int jj) {
    return jj < tiles && jj * kTile < lim && (jj + 1) * kTile > lo;
  };
  for (int i = 0; i < stages - 1; ++i) {
    const int jj = tile_of(i);
    if (live_tile(jj))
      tile_sources<CONTIG>(src + i * kTile, trow, r, jj, lo, lim, ps, num_pages, n_out);
  }
  __syncthreads();
  for (int i = 0; i < stages - 1; ++i) {
    if (live_tile(tile_of(i)))
      copy_tile(ks + i * kTile * ld, src + i * kTile, keys, d, ld);
    cp_async_commit();
  }

  // this lane's heads (g, g + 8 of the warp's 16) and their weights
  const int g = lane >> 2, t = lane & 3;
  const int h0 = warp * 16 + g, h1 = h0 + 8;
  const float* wr = w + (size_t)r * w_stride;
  const float w0 = h0 < h ? wr[h0] : 0.f, w1 = h1 < h ? wr[h1] : 0.f;
  // ldmatrix rows: A (q) matrices (rows 0-7 | 8-15) x (k 0-7 | 8-15);
  // B (keys) matrices (k 0-7 | 8-15) x (positions 0-7 | 8-15)
  const int ar = (lane & 7) + ((lane >> 3) & 1) * 8, ac = (lane >> 4) * 8;
  const int br = (lane & 7) + (lane >> 4) * 8, bc = ((lane >> 3) & 1) * 8;
  const __nv_bfloat16* qw = qs + (warp * 16 + ar) * ld + ac;

  for (int i = 0; tile_of(i) < tiles; ++i) {
    const int j = tile_of(i), s = i % stages;
    const int jn = tile_of(i + stages - 1), sn = (i + stages - 1) % stages;
    const bool next = live_tile(jn);                   // uniform over the CTA
    if (next) {
      tile_sources<CONTIG>(src + sn * kTile, trow, r, jn, lo, lim, ps, num_pages, n_out);
      __syncthreads();
      copy_tile(ks + sn * kTile * ld, src + sn * kTile, keys, d, ld);
    }
    cp_async_commit();
    cp_async_wait(stages - 1);      // the query and tile i have landed
    __syncthreads();
    const int base = j * kTile;
    const bool live = live_tile(j);   // uniform over the CTA
    if (live) {
      float acc[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[nt][u] = 0.f;
      const __nv_bfloat16* kt = ks + s * kTile * ld + br * ld + bc;
      for (int k0 = 0; k0 < d; k0 += 16) {
        unsigned a[4];
        ldsm_x4(a, qw + k0);
#pragma unroll
        for (int nt = 0; nt < 8; nt += 2) {
          unsigned bb[4];
          ldsm_x4(bb, kt + nt * 8 * ld + k0);
          mma_bf16(acc[nt], a, bb[0], bb[1]);
          mma_bf16(acc[nt + 1], a, bb[2], bb[3]);
        }
      }
      // acc[nt] = heads (g, g, g+8, g+8) x positions (2t, 2t+1, 2t, 2t+1)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        float s0 = __fmaf_rn(w1, fmaxf(acc[nt][2], 0.f), __fmul_rn(w0, fmaxf(acc[nt][0], 0.f)));
        float s1 = __fmaf_rn(w1, fmaxf(acc[nt][3], 0.f), __fmul_rn(w0, fmaxf(acc[nt][1], 0.f)));
#pragma unroll
        for (int m = 4; m < 32; m <<= 1) {
          s0 = __fadd_rn(s0, __shfl_xor_sync(0xffffffffu, s0, m));
          s1 = __fadd_rn(s1, __shfl_xor_sync(0xffffffffu, s1, m));
        }
        if (g == 0) {
          part[warp * kTile + nt * 8 + 2 * t] = s0;
          part[warp * kTile + nt * 8 + 2 * t + 1] = s1;
        }
      }
    }
    __syncthreads();
    for (int p = threadIdx.x; p < kTile && base + p < n_out; p += blockDim.x) {
      float tot = kNeg;
      if (live && src[s * kTile + p] >= 0) {
        tot = part[p];
        for (int u = 1; u < nw; ++u) tot = __fadd_rn(tot, part[u * kTile + p]);
      }
      out[base + p] = tot;
    }
    __syncthreads();              // buffer s, its sources and part free again
  }
}

template <bool CONTIG>
int launch_mma(const void* q, const void* keys, const float* w, int w_stride,
               const int* table, const int* lengths, int rows, int h, int d,
               int ps, int mp, int num_pages, int n_out, int qrows, int window,
               int ctas_per_row, int stages, float* scores,
               cudaStream_t stream) {
  const int nw = (h + 15) / 16;
  if (h < 1 || nw > kMaxWarps || d < 16 || d % 16 != 0 || ctas_per_row < 1
      || ctas_per_row > 65535 || stages < 1 || stages > kMaxStages
      || (!CONTIG && ps < 1)
      || (CONTIG ? (size_t)rows * n_out : (size_t)num_pages * ps) >= (1u << 31))
    return (int)cudaErrorInvalidValue;                  // int32 key rows
  const size_t ld = (size_t)d + kPad;
  const size_t smem = (size_t)nw * 16 * ld * 2 + (size_t)stages * kTile * ld * 2
                      + (size_t)nw * kTile * 4 + (size_t)stages * kTile * 4;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kern = indexer_scores_mma_kernel<CONTIG>;
  static size_t raised[kMaxDevices] = {};
  cudaError_t err = raise_smem(kern, smem, raised);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(ctas_per_row, rows);
  kern<<<grid, 32 * nw, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(keys),
      w, w_stride, table, lengths, h, d, ps, mp, num_pages, n_out, qrows,
      window, stages, scores);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared by both entries: contig = 0: keys are (num_pages, ps, d) pages
// through table (rows / qrows, mp), n_out = mp * ps (B2; B9 with qrows = Q
// > 1 folded query rows, row r on table row r / Q); contig = 1: keys are
// (rows, n_out, d), table unused, qrows 1 (B5). w is (h,) with w_stride 0
// or (rows, h) with w_stride h; lengths (rows,); window > 0 keeps only
// [length - window, length) of a row, 0 the whole [0, length). A launch
// the body cannot take returns cudaErrorInvalidValue.

// float32 q and keys: the CUDA-core body, `tile` positions per CTA (the
// page size when paged), hg heads per thread.
extern "C" int indexer_scores_fma_launch(
    int contig, int hg, const void* q, const void* keys, const float* w,
    int w_stride, const int* table, const int* lengths, int rows, int h,
    int d, int tile, int mp, int num_pages, int n_out, int qrows, int window,
    float* scores, void* stream) {
  if (qrows < 1 || rows % qrows != 0 || (contig && qrows != 1) || rows > 65535
      || window < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(keys);
  if (contig)
    return fma_by_heads<true>(hg, qf, kf, w, w_stride, table, lengths, rows, h, d, tile, mp, num_pages, n_out, qrows, window, scores, st);
  return fma_by_heads<false>(hg, qf, kf, w, w_stride, table, lengths, rows, h, d, tile, mp, num_pages, n_out, qrows, window, scores, st);
}

// bf16 q and keys (16-byte aligned, d a multiple of 16): the tensor-core
// body, ctas_per_row CTAs per row and `stages` tile buffers
// (ops.score_schedule), ps the page size when paged.
extern "C" int indexer_scores_mma_launch(
    int contig, const void* q, const void* keys, const float* w, int w_stride,
    const int* table, const int* lengths, int rows, int h, int d, int ps,
    int mp, int num_pages, int n_out, int qrows, int window, int ctas_per_row,
    int stages, float* scores, void* stream) {
  if (qrows < 1 || rows % qrows != 0 || (contig && qrows != 1) || rows > 65535
      || window < 0 || ((uintptr_t)q | (uintptr_t)keys) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (contig)
    return launch_mma<true>(q, keys, w, w_stride, table, lengths, rows, h, d, ps, mp, num_pages, n_out, qrows, window, ctas_per_row, stages, scores, st);
  return launch_mma<false>(q, keys, w, w_stride, table, lengths, rows, h, d, ps, mp, num_pages, n_out, qrows, window, ctas_per_row, stages, scores, st);
}
