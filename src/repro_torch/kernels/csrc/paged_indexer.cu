// Paged DSA indexer scoring (paper Eq. 1) — the first launch of the Hopper
// form of kernel B2; the second launch is the GVR Top-K kernel (B1) on the
// score row this one writes.
//
// Replaces: src/repro/kernels/indexer_topk.py:paged_indexer_topk_pallas
// (kernel _paged_fused_kernel), whose grid walked (slot, logical page) and
// kept the score row in VMEM. Here one CTA scores one (logical page, slot)
// pair: it reads the slot's block-table entry, stages the page's indexer
// keys and the slot's indexer query in shared memory, and writes
//     score[b, j*ps + p] = sum_h w_h * ReLU(q_h . k_p)
// to a (B, MP*ps) f32 row (0.13 MB at B=4, N=8192: it stays in L2 for the
// selection launch). Positions >= length and unmapped (-1) pages score the
// NEG sentinel; an unmapped or fully-masked page is never read.
//
// Numerics follow the served path (src/repro/sparse/dsa.py:indexer_scores):
// q arrives already cast to the cache dtype; products and sums are f32.
//
// Bound on an H100: the page reads, B*N*d_i*2 bytes (8.4 MB at B=4,
// N=8192, d_i=128 in bf16), ~2.5 us at 3.35 TB/s; the 2*B*N*H*d_i flops
// (0.54 GFLOP) are far below the bf16 tensor-core roof. This first form
// runs the dot products on the CUDA cores from shared memory (the key page
// is stored transposed so a warp reads 32 consecutive positions without
// bank conflicts); each thread owns one position and HG heads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -3.4028234663852886e38f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// grid (MP, B); block ps * groups threads; group g owns heads
// [g*HG, (g+1)*HG).
template <typename T, int HG>
__global__ void paged_indexer_scores_kernel(
    const T* __restrict__ q, const T* __restrict__ pages,
    const float* __restrict__ w, const int* __restrict__ table,
    const int* __restrict__ lengths, int h, int d, int ps, int mp,
    int num_pages, float* __restrict__ scores) {
  extern __shared__ float sm[];
  const int j = blockIdx.x, b = blockIdx.y;
  const int len = lengths[b];
  const int phys = table[(size_t)b * mp + j];
  const int base = j * ps;
  float* out = scores + (size_t)b * mp * ps + base;
  if (phys < 0 || phys >= num_pages || base >= len) {
    for (int p = threadIdx.x; p < ps; p += blockDim.x) out[p] = kNeg;
    return;
  }
  float* qs = sm;                       // (h, d)
  float* kt = qs + h * d;               // (d, ps) — transposed page
  float* part = kt + d * ps;            // (groups, ps)
  const T* qb = q + (size_t)b * h * d;
  const T* pg = pages + (size_t)phys * ps * d;
  for (int i = threadIdx.x; i < h * d; i += blockDim.x) qs[i] = to_f32(qb[i]);
  for (int i = threadIdx.x; i < ps * d; i += blockDim.x) {
    const int p = i / d, e = i - p * d;
    kt[e * ps + p] = to_f32(pg[i]);
  }
  __syncthreads();

  const int p = threadIdx.x % ps, g = threadIdx.x / ps;
  const int h0 = g * HG;
  float acc[HG];
#pragma unroll
  for (int u = 0; u < HG; ++u) acc[u] = 0.f;
  for (int e = 0; e < d; ++e) {
    const float kv = kt[e * ps + p];
#pragma unroll
    for (int u = 0; u < HG; ++u) acc[u] = fmaf(qs[(h0 + u) * d + e], kv, acc[u]);
  }
  float s = 0.f;
#pragma unroll
  for (int u = 0; u < HG; ++u) s = fmaf(w[h0 + u], fmaxf(acc[u], 0.f), s);
  part[g * ps + p] = s;
  __syncthreads();
  if (g == 0) {
    const int groups = blockDim.x / ps;
    float tot = 0.f;
    for (int gg = 0; gg < groups; ++gg) tot += part[gg * ps + p];
    out[p] = base + p < len ? tot : kNeg;
  }
}

template <typename T, int HG>
int launch(const void* q, const void* pages, const float* w, const int* table,
           const int* lengths, int b, int h, int d, int ps, int mp,
           int num_pages, float* scores, cudaStream_t stream) {
  const int groups = h / HG;
  const size_t smem = ((size_t)h * d + (size_t)d * ps + (size_t)groups * ps) * 4;
  auto kern = paged_indexer_scores_kernel<T, HG>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(mp, b);
  kern<<<grid, ps * groups, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pages), w, table,
      lengths, h, d, ps, mp, num_pages, scores);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int hg, const void* q, const void* pages, const float* w,
             const int* table, const int* lengths, int b, int h, int d, int ps,
             int mp, int num_pages, float* scores, cudaStream_t stream) {
  switch (hg) {
    case 1: return launch<T, 1>(q, pages, w, table, lengths, b, h, d, ps, mp, num_pages, scores, stream);
    case 2: return launch<T, 2>(q, pages, w, table, lengths, b, h, d, ps, mp, num_pages, scores, stream);
    case 4: return launch<T, 4>(q, pages, w, table, lengths, b, h, d, ps, mp, num_pages, scores, stream);
    case 8: return launch<T, 8>(q, pages, w, table, lengths, b, h, d, ps, mp, num_pages, scores, stream);
    case 16: return launch<T, 16>(q, pages, w, table, lengths, b, h, d, ps, mp, num_pages, scores, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q and pages share it). hg = heads per
// thread; h / hg threads groups of ps threads each.
extern "C" int paged_indexer_scores_launch(
    int dtype, int hg, const void* q, const void* pages, const float* w,
    const int* table, const int* lengths, int b, int h, int d, int ps, int mp,
    int num_pages, float* scores, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch<float>(hg, q, pages, w, table, lengths, b, h, d, ps, mp, num_pages, scores, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(hg, q, pages, w, table, lengths, b, h, d, ps, mp, num_pages, scores, st);
  return (int)cudaErrorInvalidValue;
}
