// The cross-block half of the per-camera reductions of K2 and K3.
//
// On the TPU the grid ran in order and carried the per-camera sums in VMEM
// from one tile to the next.  Blocks on Hopper run in parallel, in no
// order, so each block of K2 / K3 writes its camera partial to its own row
// of a [nblocks, n] scratch buffer, and this kernel sums the rows in block
// order (so the cross-block part of the sum is the same from run to run).
#pragma once

#include <cuda_runtime.h>

namespace sfm {

__global__ void sum_partials(const float* __restrict__ partial, int nblocks,
                             int n, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int b = 0; b < nblocks; ++b) s += partial[(size_t)b * n + i];
  out[i] = s;
}

inline void launch_sum_partials(const float* partial, int nblocks, int n,
                                float* out, cudaStream_t stream) {
  constexpr int kThreads = 256;
  sum_partials<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      partial, nblocks, n, out);
}

}  // namespace sfm
