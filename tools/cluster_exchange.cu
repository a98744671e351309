// What one cluster-wide exchange costs on the card, by the two mechanisms
// csrc/gvr_topk.cu chose between: R CTAs of 256 threads (one cluster) run
// 2000 rounds in which every CTA learns a value from every other; thread 0
// of rank 0 reads %globaltimer around the rounds, and the best of five
// launches is printed per round.
//
//   mode 0  barrier.cluster (arrive.release / wait.acquire) alone
//   mode 1  a CTA sum first, then st.async into every rank, completing on
//           the receiver's mbarrier (the design of csrc/gvr_topk.cu)
//
// Build and run through tools/cluster_exchange.py.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdio.h>
#include <stdint.h>
namespace cg = cooperative_groups;
typedef unsigned long long u64;
constexpr int T = 256, W = T / 32, ROUNDS = 2000;

__device__ __forceinline__ long long gtime() { long long t; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)); return t; }
__device__ __forceinline__ long long clk() { return clock64(); }
__device__ __forceinline__ int wsum(int v) { for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(~0u, v, o); return v; }
__device__ __forceinline__ unsigned sa(const void* p) { return (unsigned)__cvta_generic_to_shared(p); }
__device__ __forceinline__ unsigned mapa(unsigned a, int r) { unsigned o; asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(o) : "r"(a), "r"(r)); return o; }

template <int MODE>
__global__ void __launch_bounds__(T) bench(long long* out, int* sink) {
  __shared__ int red[W];
  __shared__ alignas(8) u64 mbar[2];
  __shared__ unsigned s32[2][16];
  cg::cluster_group cl = cg::this_cluster();
  const int nr = cl.num_blocks(), r = cl.block_rank(), tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  if (tid < 32) (&s32[0][0])[tid] = 0;
  if (tid == 0) {
    for (int p = 0; p < 2; ++p) asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(sa(&mbar[p])));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cl.sync();
  int acc = 0;
  long long t0 = gtime(), c0 = clk();
  for (int e = 0; e < ROUNDS; ++e) {
    const int p = e & 1;
    int v = wsum(e + r + w);
    if (MODE == 0) {            // barrier.cluster only
      cl.sync();
      acc += v;
    } else {                    // CTA reduce, st.async + mbarrier complete_tx
      if (lane == 0) red[w] = v;
      __syncthreads();
      const unsigned mb = sa(&mbar[p]);
      if (tid == 0) asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" :: "r"(mb), "r"(4 * nr) : "memory");
      if (w == 0) { int c = lane < W ? red[lane] : 0; c = wsum(c);
        if (lane < nr) { unsigned da = mapa(sa(&s32[p][r]), lane), dm = mapa(mb, lane);
          asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.u32 [%0], %1, [%2];" :: "r"(da), "r"(c), "r"(dm) : "memory"); } }
      const unsigned ph = (e >> 1) & 1;
      unsigned done = 0;
      do { asm volatile("{ .reg .pred P; mbarrier.try_wait.parity.shared::cta.b64 P, [%1], %2; selp.u32 %0, 1, 0, P; }" : "=r"(done) : "r"(mb), "r"(ph) : "memory"); } while (!done);
      int s = lane < nr ? (int)s32[p][lane] : 0;
      acc += wsum(s);
    }
  }
  long long t1 = gtime(), c1 = clk();
  if (r == 0 && tid == 0) { out[0] = t1 - t0; out[1] = c1 - c0; }
  if (acc == 12345) sink[0] = acc;
  cl.sync();
}

template <int MODE>
void run(int R, long long* d_out, int* sink) {
  cudaLaunchConfig_t cfg = {}; cfg.gridDim = dim3(R, 1, 1); cfg.blockDim = dim3(T, 1, 1);
  cudaLaunchAttribute at[1]; at[0].id = cudaLaunchAttributeClusterDimension; at[0].val.clusterDim.x = R; at[0].val.clusterDim.y = 1; at[0].val.clusterDim.z = 1;
  cfg.attrs = at; cfg.numAttrs = 1;
  long long h[2]; double best = 1e30, bestc = 0;
  for (int it = 0; it < 5; ++it) {
    cudaError_t e = cudaLaunchKernelEx(&cfg, bench<MODE>, d_out, sink);
    if (e != cudaSuccess) { printf("mode %d R %d launch error %s\n", MODE, R, cudaGetErrorString(e)); return; }
    e = cudaDeviceSynchronize();
    if (e != cudaSuccess) { printf("mode %d R %d run error %s\n", MODE, R, cudaGetErrorString(e)); return; }
    cudaMemcpy(h, d_out, 16, cudaMemcpyDeviceToHost);
    if (h[0] < best) { best = h[0]; bestc = h[1]; }
  }
  printf("XBENCH mode %d R %d: %.1f ns per round (%.0f cycles)\n", MODE, R, best / ROUNDS, bestc / ROUNDS);
}

int main() {
  long long* d_out; int* sink; cudaMalloc(&d_out, 16); cudaMalloc(&sink, 4);
  printf("mode 0 = barrier.cluster\nmode 1 = cta-reduce + st.async/mbarrier\n");
  for (int R : {1, 2, 4, 8}) { run<0>(R, d_out, sink); run<1>(R, d_out, sink); }
  return 0;
}
