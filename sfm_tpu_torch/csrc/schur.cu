// K3: the implicit-Schur coupling apply for Hopper (sm_90a), with the two
// halves K4a / K4b as modes of the same kernels.
//
// Replaces the Pallas TPU kernels in sfm_tpu/ba/schur_pallas.py:
//   mode 0 "full"    _fused_kernel   (schur_apply_fused):
//                    t = g_l + sum_k W[l,k]^T x[cam(l,k)], z_l = Vinv_l t,
//                    y[cam(l,k)] += W[l,k] z_l;
//   mode 1 "gather"  _gather_kernel  (schur_gather): z_l only;
//   mode 2 "scatter" _scatter_kernel (schur_scatter): y = sum W z for a
//                    given z.
// One apply serves the three uses in the large solver (signs chosen by the
// caller): the CG matvec S x = damp(U) x - y(x, g = 0), the rhs
// g_cam - y(0, g_lm), and back-substitution z(-d_cam, g_lm) (gather).
//
// Layouts: lm_cam [L, kmax] int32, W [L, kmax, 6, 3] row-major (as K2
// writes it), Vinv [L, 3, 3], g and z [L, 3], x and y [C, 6], all f32.
// Empty slots carry zero W blocks; the camera index is clamped into range.
// g == NULL or x == NULL read as 0.  The camera-major CSR of the live slots
// (ba/large.py::camera_slots): offsets [C + 1] and slots [L * kmax] int32,
// camera c owning slots[offsets[c] .. offsets[c + 1]) in ascending
// s = l * kmax + k.
//
// Bound.  Memory: one apply must read W once (72 B per slot: 43 MB at
// benchmarks/bench_ba.py's L = 100k, kmax = 6), lm_cam, Vinv and g, and
// write z and y: 51.6 MB there, 15.4 us at 3.35 TB/s; 1.4 MB and 0.4 us at
// the flagship's mapping BA (L = 2048, kmax = 8), where two launches of a
// few microseconds are the floor.  72 flops per slot are nothing beside
// that, and the 3x6 f32 blocks do not suit the tensor cores without TF32,
// which the port keeps off.
//
// Design (two launches, both in sfm_schur_apply; ba_common.cuh):
//   phase A, landmark-major: a block stages its landmarks' contiguous W
//     range in shared memory with 16-byte cp.async (evict-first in L2),
//     gathers x[cam] through the read-only path (C * 24 B: it stays in
//     L1 / L2), sums t over the landmark's lanes with a shuffle butterfly
//     and writes z = Vinv t.  In modes full and scatter each slot then
//     writes q = W z (24 B) to its row of a [L * kmax, 6] buffer, in slot
//     order (coalesced), so W is read once per apply.
//   phase B, camera-major: one block of 256 threads per camera gathers q
//     over the camera's CSR slots, lane-strided with four rows in flight,
//     block_sum adds the lanes in a fixed order, and y[c] is written once.
// The q round trip (14.4 MB written, then gathered at 24 B a slot) is the
// price of a fixed-order camera sum without atomics: on the H100 at
// bench_ba phase B takes ~10 us beside phase A's ~24 us (chip_smoke.py, by
// kernel).  Re-reading W in phase B instead (72 B a slot, no q) was
// slower; writing q in camera order (through the inverse of the CSR) made
// the writes scattered and phase A slower; 32-byte q rows gained nothing.
// What the earlier design did and this one does not: a [C, 6] accumulator per
// block in shared memory with shared atomics (capping C at ~4800, and
// serialising on the few cameras of the flagship), a [nblocks, C, 6]
// scratch and a second summing launch, a grid capped at 2 blocks per SM of
// at most 128 threads, 18 strided scalar loads of W per slot, and a serial
// per-landmark sum by one thread behind three barriers.  Every phase-A
// block here does one tile and returns, so the grid fills the card and the
// idle rows of the flagship's compacted table cost one short block each.
// Both phases sum in a fixed order, so two applies on the same inputs give
// the same bits.

#include <cuda_runtime.h>

#include "ba_common.cuh"

namespace {

using sfm::kThreads;
using sfm::kW;
constexpr int kFull = 0, kGather = 1, kScatter = 2;
// phase B: 256 threads per camera, so that bench_ba's 1000 cameras run in
// one wave with two or three slots per thread
constexpr int kCamThreads = 256;

template <int kMode>
__global__ void __launch_bounds__(kThreads)
landmark_phase(const int* __restrict__ lm_cam, const float* __restrict__ W,
               const float* __restrict__ vinv, const float* __restrict__ g,
               const float* __restrict__ x, const float* __restrict__ z_in,
               int L, int kmax, int C, float* __restrict__ z_out,
               float* __restrict__ q) {
  constexpr bool kComputesZ = kMode != kScatter;
  constexpr bool kWritesQ = kMode != kGather;
  extern __shared__ float4 smem4[];
  float* tile = reinterpret_cast<float*>(smem4);  // [lpb, kmax, 6, 3]
  const int G = sfm::group_size(kmax);
  const int lpb = kThreads / G;
  const int l0 = blockIdx.x * lpb;
  const int nl = min(lpb, L - l0);
  const bool use_x = kComputesZ && x != nullptr;
  if (use_x || kWritesQ)
    sfm::stage_tile(tile, W + (size_t)l0 * kmax * kW, nl * kmax * kW);
  const int j = threadIdx.x % G;   // lane within the landmark
  const int lt = threadIdx.x / G;  // landmark within the tile
  const int l = l0 + lt;
  const bool live = lt < nl;

  float z[3] = {0.0f, 0.0f, 0.0f};
  if (kComputesZ) {
    float t[3] = {0.0f, 0.0f, 0.0f};
    if (live && use_x) {
      for (int k = j; k < kmax; k += G) {
        const float* w = tile + (lt * kmax + k) * kW;
        const int c = min(max(__ldg(lm_cam + (size_t)l * kmax + k), 0), C - 1);
        const float* xc = x + (size_t)c * 6;
#pragma unroll
        for (int a = 0; a < 6; ++a) {
          const float xa = __ldg(xc + a);
          t[0] += w[a * 3 + 0] * xa;
          t[1] += w[a * 3 + 1] * xa;
          t[2] += w[a * 3 + 2] * xa;
        }
      }
    }
    sfm::group_sum<3>(t, G);
    if (live) {
      if (g != nullptr) {
        t[0] = __ldg(g + 3 * (size_t)l) + t[0];
        t[1] = __ldg(g + 3 * (size_t)l + 1) + t[1];
        t[2] = __ldg(g + 3 * (size_t)l + 2) + t[2];
      }
      const float* vi = vinv + 9 * (size_t)l;
#pragma unroll
      for (int b = 0; b < 3; ++b)
        z[b] = __ldg(vi + 3 * b) * t[0] + __ldg(vi + 3 * b + 1) * t[1] +
               __ldg(vi + 3 * b + 2) * t[2];
#pragma unroll
      for (int b = 0; b < 3; ++b)
        if (b % G == j) z_out[3 * (size_t)l + b] = z[b];
    }
  } else if (live) {
#pragma unroll
    for (int b = 0; b < 3; ++b) z[b] = __ldg(z_in + 3 * (size_t)l + b);
  }

  if (kWritesQ && live) {
    for (int k = j; k < kmax; k += G) {
      const float* w = tile + (lt * kmax + k) * kW;
      float2* qp = reinterpret_cast<float2*>(q + ((size_t)l * kmax + k) * 6);
#pragma unroll
      for (int a = 0; a < 6; a += 2)
        qp[a / 2] = make_float2(
            w[a * 3] * z[0] + w[a * 3 + 1] * z[1] + w[a * 3 + 2] * z[2],
            w[a * 3 + 3] * z[0] + w[a * 3 + 4] * z[1] + w[a * 3 + 5] * z[2]);
    }
  }
}

// y[c] = the sum of q over camera c's slots, in a fixed order: thread t
// takes the camera's slots t, t + kCamThreads, ... (four rows in flight; a
// slot past the end adds +0), then block_sum
__global__ void __launch_bounds__(kCamThreads)
camera_phase(const float* __restrict__ q, const int* __restrict__ slots,
             const int* __restrict__ offsets, float* __restrict__ y) {
  constexpr int kUnroll = 4;
  const int c = blockIdx.x;
  const int end = __ldg(offsets + c + 1);
  float acc[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int i = __ldg(offsets + c) + threadIdx.x; i < end;
       i += kUnroll * kCamThreads) {
    float2 v[kUnroll][3];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int iu = i + u * kCamThreads;
      const float2* qs = reinterpret_cast<const float2*>(
          q + (size_t)(iu < end ? __ldg(slots + iu) : 0) * 6);
#pragma unroll
      for (int a = 0; a < 3; ++a)
        v[u][a] = iu < end ? __ldg(qs + a) : make_float2(0.0f, 0.0f);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        acc[2 * a] += v[u][a].x;
        acc[2 * a + 1] += v[u][a].y;
      }
  }
  sfm::block_sum<6, kCamThreads>(acc, y + (size_t)c * 6);
}

template <int kMode>
cudaError_t launch(const void* lm_cam, const void* W, const void* vinv,
                   const void* g, const void* x, const void* z_in,
                   const void* offsets, const void* slots, int L, int kmax,
                   int C, void* z_out, void* q, void* y, cudaStream_t st) {
  if (L > 0) {
    const size_t smem = sfm::tile_bytes(kmax);
    cudaError_t err = sfm::allow_smem(landmark_phase<kMode>, smem);
    if (err != cudaSuccess) return err;
    const int lpb = kThreads / sfm::group_size(kmax);
    landmark_phase<kMode><<<(L + lpb - 1) / lpb, kThreads, smem, st>>>(
        static_cast<const int*>(lm_cam), static_cast<const float*>(W),
        static_cast<const float*>(vinv), static_cast<const float*>(g),
        static_cast<const float*>(x), static_cast<const float*>(z_in), L,
        kmax, C, static_cast<float*>(z_out), static_cast<float*>(q));
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (kMode == kGather) return cudaSuccess;
  camera_phase<<<C, kCamThreads, 0, st>>>(static_cast<const float*>(q),
                                       static_cast<const int*>(slots),
                                       static_cast<const int*>(offsets),
                                       static_cast<float*>(y));
  return cudaGetLastError();
}

}  // namespace

// mode 0 full (writes z_out and y), 1 gather (z_out), 2 scatter (reads
// z_in, writes y).  q is [L * kmax, 6] scratch in the modes that write y;
// gather reads neither offsets nor slots.
extern "C" int sfm_schur_apply(int mode, const void* lm_cam, const void* W,
                               const void* vinv, const void* g,
                               const void* x, const void* z_in,
                               const void* offsets, const void* slots, int L,
                               int kmax, int C, void* z_out, void* q, void* y,
                               void* stream) {
  if (C < 1 || L < 0 || kmax < 1 || kmax > sfm::kMaxKmax)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kFull:
      return (int)launch<kFull>(lm_cam, W, vinv, g, x, z_in, offsets, slots, L,
                                kmax, C, z_out, q, y, st);
    case kGather:
      return (int)launch<kGather>(lm_cam, W, vinv, g, x, z_in, offsets, slots,
                                  L, kmax, C, z_out, q, y, st);
    case kScatter:
      return (int)launch<kScatter>(lm_cam, W, vinv, g, x, z_in, offsets, slots,
                                   L, kmax, C, z_out, q, y, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
