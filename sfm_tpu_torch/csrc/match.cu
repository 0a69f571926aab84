// K1: fused Hamming matcher for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel sfm_tpu/features/match_pallas.py
// (_matcher_kernel, launched by hamming_match_tiles).  For every 512-bit
// source descriptor: the Hamming distance to every target, the motion
// window / validity mask, the best index (lowest target on ties), the best
// distance, the second-best distance (the argmin column excluded, so two
// equal best distances give second == best), and the per-target winner key
// for keep-best-per-target dedup.
//
// What bounds it: integer ALU.  A 2048 x 512 call reads 128 KB of source
// and 32 KB of target descriptors but does 16 XOR + 16 popc per pair
// (~17 M pairs per mapping batch).  The TPU computed the distance as a
// bitplane matmul (|a| + |b| - 2 a.b) because its vector unit has no
// popcount; here XOR + __popc over the 16 packed words gives the same
// integer directly.  Design:
//   - one block holds ALL targets of its batch element in shared memory
//     (512 x 64 B = 32 KB), word-major ([word][target]) so that lanes
//     reading neighbouring targets hit neighbouring banks;
//   - one warp per source row: each lane scans targets lane, lane+32, ...
//     keeping (best, idx, second), then a butterfly merge over the warp;
//   - grid.y is the batch axis (mapping's per-keyframe calls in one launch);
//   - the per-target key is a 64-bit atomicMin on (dist << 32) | row, the
//     lexicographic (dist, row) minimum; exact for any row count (the
//     TPU's f32 key dist * 16384 + row was exact only below 16384 rows).
// The window test rounds dx*dx and dy*dy separately (no FMA contraction),
// as the reference's f32 arithmetic does.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kWords = 16;          // 512-bit descriptors
constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr float kMasked = 1e9f;     // distance of an infeasible pair
constexpr unsigned kFull = 0xffffffffu;

__global__ void init_keys(long long* keys, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) keys[i] = LLONG_MAX;
}

__global__ void __launch_bounds__(kWarps * 32)
match_kernel(const unsigned* __restrict__ desc_s,
             const float* __restrict__ ctr_s,
             const unsigned char* __restrict__ valid_s,
             const unsigned* __restrict__ desc_t,
             const float* __restrict__ xy_t,
             const unsigned char* __restrict__ valid_t,
             int Ns, int Nt, float min_r2, float max_r2, float max_d,
             float ratio, int* __restrict__ idx_out,
             float* __restrict__ best_out, float* __restrict__ second_out,
             long long* __restrict__ keys) {
  extern __shared__ unsigned char smem[];
  unsigned* tdesc = reinterpret_cast<unsigned*>(smem);       // [kWords][Nt]
  float* tx = reinterpret_cast<float*>(tdesc + kWords * Nt);  // [Nt]
  float* ty = tx + Nt;                                        // [Nt]
  unsigned char* tvalid = reinterpret_cast<unsigned char*>(ty + Nt);

  const int b = blockIdx.y;
  const unsigned* dt = desc_t + (size_t)b * Nt * kWords;
  for (int i = threadIdx.x; i < Nt * kWords; i += blockDim.x) {
    tdesc[(i % kWords) * Nt + i / kWords] = dt[i];
  }
  for (int t = threadIdx.x; t < Nt; t += blockDim.x) {
    size_t g = (size_t)b * Nt + t;
    tx[t] = xy_t[2 * g];
    ty[t] = xy_t[2 * g + 1];
    tvalid[t] = valid_t[g];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int k = 0; k < kRowsPerWarp; ++k) {
    const int row = blockIdx.x * kRowsPerBlock + k * kWarps + warp;
    if (row >= Ns) break;  // warp-uniform
    const size_t srow = (size_t)b * Ns + row;
    unsigned s[kWords];
#pragma unroll
    for (int w = 0; w < kWords; ++w) s[w] = __ldg(desc_s + srow * kWords + w);
    const float cx = ctr_s[2 * srow];
    const float cy = ctr_s[2 * srow + 1];
    const bool vs = valid_s[srow] != 0;

    float best = INFINITY, second = INFINITY;
    int bidx = INT_MAX;
    for (int t = lane; t < Nt; t += 32) {
      const float dx = __fsub_rn(cx, tx[t]);
      const float dy = __fsub_rn(cy, ty[t]);
      const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
      float v = kMasked;
      if (vs && tvalid[t] && d2 >= min_r2 && d2 <= max_r2) {
        int d = 0;
#pragma unroll
        for (int w = 0; w < kWords; ++w) d += __popc(s[w] ^ tdesc[w * Nt + t]);
        v = (float)d;
      }
      // targets arrive in ascending order per lane: a tie keeps the
      // earlier (lower) target and moves the new one into second
      if (v < best) {
        second = best;
        best = v;
        bidx = t;
      } else if (v < second) {
        second = v;
      }
    }
    // butterfly merge of (best, idx, second); the loser's best becomes a
    // second-best candidate
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(kFull, best, off);
      const int oi = __shfl_xor_sync(kFull, bidx, off);
      const float os = __shfl_xor_sync(kFull, second, off);
      if (ob < best || (ob == best && oi < bidx)) {
        second = fminf(os, best);
        best = ob;
        bidx = oi;
      } else {
        second = fminf(second, ob);
      }
    }
    if (lane == 0) {
      second = fminf(second, kMasked);  // a single target: second is masked
      idx_out[srow] = bidx;
      best_out[srow] = best;
      second_out[srow] = second;
      const bool ok = vs && best <= max_d && best < __fmul_rn(ratio, second);
      if (ok) {
        const long long key = ((long long)(int)best << 32) | (long long)row;
        atomicMin(keys + (size_t)b * Nt + bidx, key);
      }
    }
  }
}

}  // namespace

extern "C" int sfm_hamming_match(const void* desc_s, const void* ctr_s,
                                 const void* valid_s, const void* desc_t,
                                 const void* xy_t, const void* valid_t, int B,
                                 int Ns, int Nt, float min_r2, float max_r2,
                                 float max_d, float ratio, void* idx,
                                 void* best, void* second, void* keys,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_keys = B * Nt;
  init_keys<<<(n_keys + 255) / 256, 256, 0, st>>>(
      static_cast<long long*>(keys), n_keys);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)Nt * (kWords * 4 + 8 + 1);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(match_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((Ns + kRowsPerBlock - 1) / kRowsPerBlock, B);
  match_kernel<<<grid, kWarps * 32, smem, st>>>(
      static_cast<const unsigned*>(desc_s), static_cast<const float*>(ctr_s),
      static_cast<const unsigned char*>(valid_s),
      static_cast<const unsigned*>(desc_t), static_cast<const float*>(xy_t),
      static_cast<const unsigned char*>(valid_t), Ns, Nt, min_r2, max_r2,
      max_d, ratio, static_cast<int*>(idx), static_cast<float*>(best),
      static_cast<float*>(second), static_cast<long long*>(keys));
  return (int)cudaGetLastError();
}
