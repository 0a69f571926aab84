// Keyframe culling for Hopper (sm_90a): the greedy oldest-first cull of
// sfm_tpu_torch/mapstore.py::cull_keyframes (sfm_tpu/mapstore.py's
// lax.scan over slots) in one launch of one block.
//
// The plain version walks the K ranks of the frame-order sort in Python,
// and on the card each rank reads device values on the host (the slot
// index, its validity, the stores).  Here the whole walk runs on the card:
// the host launches once and reads nothing, so a mapping pass does not
// wait for it.
//
// Per rank i (slot k = order[i]), as the plain loop: a keypoint observes
// when its link is >= 0 and it is valid; it is redundant when the link's
// view count, this keyframe included, exceeds min_others + 1.  The rank
// culls when it is not among the first keep_first, its slot is valid, it
// observes something, and n_red / max(n_obs, 1) >= redundancy, the
// fraction one IEEE float32 division (__fdiv_rn) compared in float32.  A
// cull takes one view off the count of each observation's landmark, a
// link that appears twice in the keyframe twice (index_add's semantics),
// before the next rank reads the counts.  The decisions equal the plain
// loop's bit for bit: everything else is integer.
//
// Invalid slots sort last (their sort key is 2**30, above every frame
// number) and can neither cull nor move a count, so the walk stops at the
// first one; the ranks it does not reach stay not culled.
//
// Layout: one block of round_up(ceil(N / ITEMS), 32) <= 1024 threads, each
// holding ITEMS keypoints of the current row in registers, and loading the
// next rank's row while the current decision settles.  n_obs and n_red
// are warp sums (__reduce_add_sync) and one barrier over a shared array
// of the warps' sums, double-buffered by rank parity.  The counts (L ints,
// 256 KB at 65536 landmarks) are copied once into the output and live
// there, in L2: gathers read with __ldcg (the L2, where the atomics land),
// a cull decrements with atomicSub, and a barrier follows before the next
// rank gathers.  What bounds it: the serial chain of the ranks, about one
// L2 round trip and one barrier each (two on a cull).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;

// the links of row k that the calling thread holds: keypoint
// threadIdx.x + c * blockDim.x, or -1 where it does not observe
template <int ITEMS>
__device__ __forceinline__ void load_row(const int* __restrict__ links,
                                         const unsigned char* __restrict__
                                             kp_valid,
                                         int k, int N, int (&v)[ITEMS]) {
  const size_t base = (size_t)k * (size_t)N;
#pragma unroll
  for (int c = 0; c < ITEMS; ++c) {
    const int j = threadIdx.x + c * blockDim.x;
    int lk = -1;
    if (j < N) {
      lk = __ldg(links + base + j);
      if (lk < 0 || __ldg(kp_valid + base + j) == 0) lk = -1;
    }
    v[c] = lk;
  }
}

template <int ITEMS>
__global__ void __launch_bounds__(kMaxThreads)
cull_keyframes_kernel(const long long* __restrict__ order,
                      const int* __restrict__ links,
                      const unsigned char* __restrict__ kp_valid,
                      const unsigned char* __restrict__ valid_in,
                      const int* __restrict__ counts_in, int K, int N, int L,
                      int keep_first, int min_others, float redundancy,
                      unsigned char* __restrict__ valid_out,
                      unsigned char* __restrict__ culled,
                      int* __restrict__ counts) {
  __shared__ int part[2][2][kMaxWarps];  // [parity][n_obs, n_red][warp]
  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const int warp = t >> 5;
  const int n_warps = nt >> 5;
  for (int l = t; l < L; l += nt) counts[l] = counts_in[l];
  for (int k = t; k < K; k += nt) {
    valid_out[k] = valid_in[k];
    culled[k] = 0;
  }
  __syncthreads();
  if (K == 0) return;

  int cur[ITEMS], nxt[ITEMS];
  int k = (int)order[0];
  bool live = valid_in[k] != 0;
  load_row<ITEMS>(links, kp_valid, k, N, cur);
  for (int i = 0; live; ++i) {
    // the next rank's slot and row, loaded while this decision settles
    const bool more = i + 1 < K;
    const int kn = more ? (int)order[i + 1] : k;
    int n_obs = 0, n_red = 0;
#pragma unroll
    for (int c = 0; c < ITEMS; ++c) {
      const int lk = cur[c];
      n_obs += lk >= 0;
      n_red += lk >= 0 && lk < L && __ldcg(counts + lk) - 1 > min_others;
    }
    load_row<ITEMS>(links, kp_valid, kn, N, nxt);
    const bool next_live = more && valid_in[kn] != 0;

    n_obs = __reduce_add_sync(0xffffffffu, n_obs);
    n_red = __reduce_add_sync(0xffffffffu, n_red);
    const int p = i & 1;
    if ((t & 31) == 0) {
      part[p][0][warp] = n_obs;
      part[p][1][warp] = n_red;
    }
    __syncthreads();
    n_obs = 0;
    n_red = 0;
    for (int w = 0; w < n_warps; ++w) {
      n_obs += part[p][0][w];
      n_red += part[p][1][w];
    }
    const float frac = __fdiv_rn((float)n_red, (float)max(n_obs, 1));
    if (i >= keep_first && n_obs > 0 && frac >= redundancy) {
#pragma unroll
      for (int c = 0; c < ITEMS; ++c) {
        const int lk = cur[c];
        if (lk >= 0 && lk < L) atomicSub(counts + lk, 1);
      }
      if (t == 0) {
        valid_out[k] = 0;
        culled[i] = 1;
      }
      __syncthreads();  // the next rank gathers the decremented counts
    }
#pragma unroll
    for (int c = 0; c < ITEMS; ++c) cur[c] = nxt[c];
    k = kn;
    live = next_live;
  }
}

template <int ITEMS>
void launch(const void* order, const void* links, const void* kp_valid,
            const void* valid, const void* counts_in, int K, int N, int L,
            int keep_first, int min_others, float redundancy,
            void* valid_out, void* culled, void* counts, cudaStream_t s) {
  const int per = (N + ITEMS - 1) / ITEMS;
  const int threads = per < 32 ? 32 : (per + 31) / 32 * 32;
  cull_keyframes_kernel<ITEMS><<<1, threads, 0, s>>>(
      static_cast<const long long*>(order), static_cast<const int*>(links),
      static_cast<const unsigned char*>(kp_valid),
      static_cast<const unsigned char*>(valid),
      static_cast<const int*>(counts_in), K, N, L, keep_first, min_others,
      redundancy, static_cast<unsigned char*>(valid_out),
      static_cast<unsigned char*>(culled), static_cast<int*>(counts));
}

}  // namespace

// order [K] int64 (a permutation of the slots, valid ones first by frame
// number), links [K, N] int32, kp_valid [K, N] bool, valid [K] bool,
// counts_in [L] int32 (each landmark's valid views) -> valid_out [K],
// culled [K] by rank, counts [L] after the culls.  N <= 16 * 1024.
extern "C" int sfm_cull_keyframes(const void* order, const void* links,
                                  const void* kp_valid, const void* valid,
                                  const void* counts_in, int K, int N, int L,
                                  int keep_first, int min_others,
                                  float redundancy, void* valid_out,
                                  void* culled, void* counts, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int items = (N + kMaxThreads - 1) / kMaxThreads;
  if (items <= 1) {
    launch<1>(order, links, kp_valid, valid, counts_in, K, N, L, keep_first,
              min_others, redundancy, valid_out, culled, counts, s);
  } else if (items <= 2) {
    launch<2>(order, links, kp_valid, valid, counts_in, K, N, L, keep_first,
              min_others, redundancy, valid_out, culled, counts, s);
  } else if (items <= 4) {
    launch<4>(order, links, kp_valid, valid, counts_in, K, N, L, keep_first,
              min_others, redundancy, valid_out, culled, counts, s);
  } else if (items <= 8) {
    launch<8>(order, links, kp_valid, valid, counts_in, K, N, L, keep_first,
              min_others, redundancy, valid_out, culled, counts, s);
  } else if (items <= 16) {
    launch<16>(order, links, kp_valid, valid, counts_in, K, N, L, keep_first,
               min_others, redundancy, valid_out, culled, counts, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
