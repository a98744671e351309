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
// Here one CTA scores one (tile, slot) pair: a tile is a logical page (B2,
// the CTA reads the slot's block-table entry) or T consecutive positions of
// the slot's own cache (B5). It stages the tile's indexer keys and the
// slot's indexer query in shared memory and writes
//     score[b, j*T + p] = sum_h w_h * ReLU(q_h . k_p)
// (B9: b runs over the B*Q folded query rows, row r reading table row
// r / Q of the shared table and its own q and length, so each of its score
// rows equals B2's for the same slot and length bit for bit)
// to a (B, N) f32 row (0.13 MB at B=4, N=8192: it stays in L2 for the
// selection launch). Positions >= length and unmapped (-1) pages score the
// NEG sentinel; an unmapped or fully-masked tile is never read.
//
// Numerics follow the served path (src/repro/sparse/dsa.py:indexer_scores):
// q arrives already cast to the cache dtype; products and sums are f32.
// The order of every score's sum depends only on (H, d): a thread sums the
// d products of each of its HG heads in order, then its HG weighted heads,
// then thread group 0 adds the H/HG group partials in order, and HG is
// chosen from H alone (ops._heads_per_thread). So B2 over pages and B5 over
// a contiguous cache holding the same keys write bit-identical score rows,
// and the paged and dense layouts select the same Top-K on the card.
//
// Bound on an H100: the key reads, B*N*d_i*2 bytes (8.4 MB at B=4,
// N=8192, d_i=128 in bf16), ~2.5 us at 3.35 TB/s (B9: each slot's keys up
// to its longest row, where this design reads them once per row); the 2*B*N*H*d_i flops
// (0.54 GFLOP) are far below the bf16 tensor-core roof. This first form
// runs the dot products on the CUDA cores from shared memory (the key tile
// is stored transposed so a warp reads 32 consecutive positions without
// bank conflicts); each thread owns one position and HG heads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -3.4028234663852886e38f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// grid (tiles, B); block T * groups threads; group g owns heads
// [g*HG, (g+1)*HG). CONTIG: keys (B, n_out, d), tile j = positions
// [j*T, j*T + T) (the last tile may be short); else keys (P, T, d) pages
// and tile j = logical page j, physical page table[b / qrows, j].
template <typename T, int HG, bool CONTIG>
__global__ void indexer_scores_kernel(
    const T* __restrict__ q, const T* __restrict__ keys,
    const float* __restrict__ w, int w_stride, const int* __restrict__ table,
    const int* __restrict__ lengths, int h, int d, int tile, int mp,
    int num_pages, int n_out, int qrows, float* __restrict__ scores) {
  extern __shared__ float sm[];
  const int j = blockIdx.x, b = blockIdx.y;
  const int len = lengths[b];
  const int base = j * tile;
  const int rows = CONTIG ? min(tile, n_out - base) : tile;
  float* out = scores + (size_t)b * n_out + base;
  const T* kb;
  bool skip = base >= len;
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
  const T* qb = q + (size_t)b * h * d;
  const float* wb = w + (size_t)b * w_stride;
  for (int i = threadIdx.x; i < h * d; i += blockDim.x) qs[i] = to_f32(qb[i]);
  for (int i = threadIdx.x; i < rows * d; i += blockDim.x) {
    const int p = i / d, e = i - p * d;
    kt[e * tile + p] = to_f32(kb[i]);
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
    out[p] = base + p < len ? tot : kNeg;
  }
}

template <typename T, int HG, bool CONTIG>
int launch(const void* q, const void* keys, const float* w, int w_stride,
           const int* table, const int* lengths, int b, int h, int d,
           int tile, int mp, int num_pages, int n_out, int qrows,
           float* scores, cudaStream_t stream) {
  const int groups = h / HG;
  const size_t smem = ((size_t)h * d + (size_t)d * tile + (size_t)groups * tile) * 4;
  auto kern = indexer_scores_kernel<T, HG, CONTIG>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n_out + tile - 1) / tile, b);
  kern<<<grid, tile * groups, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(keys), w, w_stride,
      table, lengths, h, d, tile, mp, num_pages, n_out, qrows, scores);
  return (int)cudaGetLastError();
}

template <typename T, bool CONTIG>
int by_heads(int hg, const void* q, const void* keys, const float* w,
             int w_stride, const int* table, const int* lengths, int b, int h,
             int d, int tile, int mp, int num_pages, int n_out, int qrows,
             float* scores, cudaStream_t st) {
  switch (hg) {
    case 1: return launch<T, 1, CONTIG>(q, keys, w, w_stride, table, lengths, b, h, d, tile, mp, num_pages, n_out, qrows, scores, st);
    case 2: return launch<T, 2, CONTIG>(q, keys, w, w_stride, table, lengths, b, h, d, tile, mp, num_pages, n_out, qrows, scores, st);
    case 4: return launch<T, 4, CONTIG>(q, keys, w, w_stride, table, lengths, b, h, d, tile, mp, num_pages, n_out, qrows, scores, st);
    case 8: return launch<T, 8, CONTIG>(q, keys, w, w_stride, table, lengths, b, h, d, tile, mp, num_pages, n_out, qrows, scores, st);
    case 16: return launch<T, 16, CONTIG>(q, keys, w, w_stride, table, lengths, b, h, d, tile, mp, num_pages, n_out, qrows, scores, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int by_layout(int contig, int hg, const void* q, const void* keys,
              const float* w, int w_stride, const int* table,
              const int* lengths, int b, int h, int d, int tile, int mp,
              int num_pages, int n_out, int qrows, float* scores,
              cudaStream_t st) {
  if (contig)
    return by_heads<T, true>(hg, q, keys, w, w_stride, table, lengths, b, h, d, tile, mp, num_pages, n_out, qrows, scores, st);
  return by_heads<T, false>(hg, q, keys, w, w_stride, table, lengths, b, h, d, tile, mp, num_pages, n_out, qrows, scores, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q and keys share it). hg = heads per
// thread; h / hg thread groups of `tile` threads each. contig = 0: keys
// are (num_pages, tile, d) pages through table (b, mp), n_out = mp * tile
// (B2); contig = 1: keys are (b, n_out, d), table unused (B5). w is
// (h,) with w_stride 0 or (b, h) with w_stride h. qrows = Q > 1 (B9,
// paged only): b = B * Q folded query rows over a (B, mp) table, row r on
// table row r / Q; B2 and B5 pass 1.
extern "C" int indexer_scores_launch(
    int dtype, int contig, int hg, const void* q, const void* keys,
    const float* w, int w_stride, const int* table, const int* lengths, int b,
    int h, int d, int tile, int mp, int num_pages, int n_out, int qrows,
    float* scores, void* stream) {
  if (qrows < 1 || b % qrows != 0 || (contig && qrows != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return by_layout<float>(contig, hg, q, keys, w, w_stride, table, lengths, b, h, d, tile, mp, num_pages, n_out, qrows, scores, st);
  if (dtype == 1)
    return by_layout<__nv_bfloat16>(contig, hg, q, keys, w, w_stride, table, lengths, b, h, d, tile, mp, num_pages, n_out, qrows, scores, st);
  return (int)cudaErrorInvalidValue;
}
