// Paged gather — the Hopper form of kernel B7: the contiguous logical view
// (B, MP*ps, F) of a page pool (P, ps, F) through the block table (B, MP),
// zeros where a page is unmapped. The `paged_attn="gather"` oracle builds
// its K, V and indexer-K views with it.
//
// Replaces: src/repro/kernels/paged_gather.py:paged_gather_pallas (kernel
// _gather_kernel), whose grid walked (slot, logical page) and DMA'd one
// (ps, F) page per step through a scalar-prefetched index_map.
//
// Here one CTA copies one (logical page, slot) pair: it reads the slot's
// table entry and copies the page's ps*F elements — the bytes do not care
// about the dtype — with 16-byte vector loads and stores (neighbouring
// threads on neighbouring addresses), or byte by byte when the page size in
// bytes is not a multiple of 16. An unmapped page (table < 0 or >= P) is
// written as zeros and never read. The Pallas contract is zeros; the JAX
// served path clips to page 0 instead — both are masked downstream.
//
// Bound on an H100: bytes, the mapped pages read once plus the whole view
// written once (at B=4, N=8192, KVH=8, hd=64 in bf16: up to 33.5 MB each
// way for one layer's K view, ~20 us at 3.35 TB/s). No arithmetic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
paged_gather_kernel(const unsigned char* __restrict__ pages,
                    const int* __restrict__ table, int mp, int num_pages,
                    long long page_bytes, int vec,
                    unsigned char* __restrict__ out) {
  const int j = blockIdx.x, b = blockIdx.y;
  const int phys = table[(size_t)b * mp + j];
  const bool mapped = phys >= 0 && phys < num_pages;
  unsigned char* dst = out + ((size_t)b * mp + j) * page_bytes;
  const unsigned char* src = pages + (size_t)(mapped ? phys : 0) * page_bytes;
  if (vec) {
    const long long n4 = page_bytes / 16;
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (long long i = threadIdx.x; i < n4; i += kThreads)
      d4[i] = mapped ? __ldg(s4 + i) : zero;
  } else {
    for (long long i = threadIdx.x; i < page_bytes; i += kThreads)
      dst[i] = mapped ? src[i] : (unsigned char)0;
  }
}

}  // namespace

// pages: (num_pages, page_bytes) bytes; table: (b, mp) int32; out:
// (b, mp, page_bytes) bytes. vec = 1 when page_bytes % 16 == 0 and both
// base pointers are 16-byte aligned.
extern "C" int paged_gather_launch(const void* pages, const int* table, int b,
                                   int mp, int num_pages, long long page_bytes,
                                   int vec, void* out, void* stream) {
  dim3 grid(mp, b);
  paged_gather_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const unsigned char*>(pages), table, mp, num_pages,
      page_bytes, vec, static_cast<unsigned char*>(out));
  return (int)cudaGetLastError();
}
