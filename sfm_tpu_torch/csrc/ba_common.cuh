// What the BA kernels K2 (linearize.cu) and K3 (schur.cu) share: the
// two-phase layout, tile staging, and a fixed-order block reduction.
//
// Both kernels run in two phases.  Phase A is landmark-major: a block of
// kThreads threads holds lpb = kThreads / G whole landmarks, G lanes each
// (G = the next power of two >= kmax, at most 32; lane j of a landmark
// takes its slots k = j, j + G, ...), and a landmark's sums are a shuffle
// butterfly across its G lanes.  Phase B is camera-major: one block per
// camera walks that camera's live slots through a CSR built once per solve
// (ba/large.py::camera_slots), lane-strided, and block_sum adds the lanes
// in a fixed order.  No per-camera array lives in shared memory and no
// atomics are used, so any camera count works and every output is the
// same from run to run.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sfm {

constexpr int kThreads = 128;
constexpr unsigned kFullMask = 0xffffffffu;
// the per-slot coupling block W = A^T B [6, 3]
constexpr int kW = 18;
constexpr int kMaxKmax = 256;

// lanes per landmark in phase A
__host__ __device__ inline int group_size(int kmax) {
  int g = 1;
  while (g < kmax && g < 32) g <<= 1;
  return g;
}

// dynamic shared memory of a phase-A block: its landmarks' W tile
inline size_t tile_bytes(int kmax) {
  return (size_t)(kThreads / group_size(kmax)) * kmax * kW * sizeof(float);
}

// opt in to more than the default 48 KB of shared memory, which the
// dynamic tile shares with the static arrays (K2's V / g_lm tiles and
// block_sum's, under 7 KB); only kmax > ~110 needs it
template <typename F>
inline cudaError_t allow_smem(F* kernel, size_t bytes) {
  if (bytes <= 32 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// an L2 policy that evicts first: for the W stream, read or written once
// per launch, so that it does not push out of L2 what the camera phase
// gathers next
__device__ __forceinline__ unsigned long long evict_first_policy() {
  unsigned long long p;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));
  return p;
}

// copy n floats of a contiguous global range into shared memory: 16-byte
// cp.async (L2 only, evict-first, no register staging) when the source is
// aligned, which it is for every tile of a freshly allocated W (a tile
// starts at a multiple of 4 landmarks, 4 * 72 B); then a block barrier
__device__ __forceinline__ void stage_tile(float* dst,
                                           const float* __restrict__ src,
                                           int n) {
  if (aligned16(src)) {
    const int n4 = n >> 2;
    const unsigned long long pol = evict_first_policy();
    for (int i = threadIdx.x; i < n4; i += blockDim.x) {
      const unsigned s =
          static_cast<unsigned>(__cvta_generic_to_shared(dst + 4 * i));
      asm volatile(
          "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n" ::
              "r"(s), "l"(src + 4 * i), "l"(pol));
    }
    for (int i = 4 * n4 + threadIdx.x; i < n; i += blockDim.x)
      dst[i] = __ldg(src + i);
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                     : "memory");
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = __ldg(src + i);
  }
  __syncthreads();
}

// the reverse: n floats of shared memory to a contiguous global range, in
// 16-byte streaming (evict-first) stores.  The destination is a tile of an
// output the wrapper allocates (W, V or g_lm, tiles of 4k landmarks), so it
// is 16-byte aligned.  Call after a barrier.
__device__ __forceinline__ void store_tile(float* __restrict__ dst,
                                           const float* src, int n) {
  const int n4 = n >> 2;
  for (int i = threadIdx.x; i < n4; i += blockDim.x)
    __stcs(reinterpret_cast<float4*>(dst) + i,
           reinterpret_cast<const float4*>(src)[i]);
  for (int i = 4 * n4 + threadIdx.x; i < n; i += blockDim.x)
    __stcs(dst + i, src[i]);
}

// sum v over the G lanes of a landmark (G a power of two <= 32, groups
// aligned within the warp): every lane ends with the same bits.  The whole
// warp must call it.
template <int N>
__device__ __forceinline__ void group_sum(float (&v)[N], int G) {
  for (int m = G >> 1; m >= 1; m >>= 1)
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(kFullMask, v[i], m);
}

// out[0..N) = the sum of v over the block's T threads: a butterfly within
// each warp, then the warps' sums in warp order.  The whole block must
// call it.
template <int N, int T = kThreads>
__device__ __forceinline__ void block_sum(float (&v)[N],
                                          float* __restrict__ out) {
  __shared__ float red[T / 32][N];
  group_sum<N>(v, 32);
  if ((threadIdx.x & 31) == 0)
#pragma unroll
    for (int i = 0; i < N; ++i) red[threadIdx.x >> 5][i] = v[i];
  __syncthreads();
  if (threadIdx.x < N) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < T / 32; ++w) s += red[w][threadIdx.x];
    out[threadIdx.x] = s;
  }
}

}  // namespace sfm
