// K2: the bundle-adjustment linearizer for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel sfm_tpu/ba/linearize_pallas.py
// (_linearize_kernel, launched by linearize_fused).  One linearisation of
// the landmark-major observation table [L, kmax] (w == 0 marks an empty
// slot) computes everything one LM iteration of the implicit-Schur solver
// needs:
//   per slot (l, k):  the residual r [2] and the Jacobians A [2, 6] (pose)
//                     and B [2, 3] (point), with z_safe and the skew term
//                     as linearize_pallas.py writes them; the Huber IRLS
//                     weight w = w_obs * min(1, delta / |r|); A scaled by
//                     w * cam_free, B by w * lm_free; W[l, k] = A^T B,
//                     written as [L, kmax, 6, 3] row-major (what K3 reads),
//                     zero for an empty slot;
//   per landmark:     V = sum_k B^T B [3, 3], g_lm = -sum_k B^T r w [3];
//   per camera:       the 21 upper entries of U = A^T A, g_cam = -A^T r w
//                     and the cost sum w |r|^2, as one [C, 28] row.
// The cost is sum (w_obs * huber_w) * |r|^2 over the kept slots: NOT the
// dense solver's rho-cost (ba/residuals.py::robust_cost).  LM accepts or
// rejects steps on it, so using the other definition changes the solve.
//
// Bound.  Memory: W is the largest stream (72 B written per slot: 43 MB at
// benchmarks/bench_ba.py's L = 100k, kmax = 6), beside 16 B of table read
// per slot and the landmark and camera rows: 59.2 MB there, 17.7 us at
// 3.35 TB/s; 1.6 MB and 0.5 us at the flagship's L = 2048, kmax = 8.
// About 300 flops per slot are far below the f32 rate.
//
// Design (two launches, both in sfm_ba_linearize; ba_common.cuh):
//   phase A, landmark-major: G lanes per landmark; each lane linearises
//     its slots and writes W into the block's shared-memory tile; V and
//     g_lm are a shuffle butterfly over the landmark's lanes.  The tile and
//     the V / g_lm rows go to device memory in 16-byte streaming stores
//     (evict-first, so W does not push the table out of L2 before phase B
//     reads it).
//   phase B, camera-major: one block per camera, R, t and cam_free in
//     registers, walks the camera's live slots through the CSR (two slots'
//     loads in flight per thread) and recomputes r, the Huber weight and A
//     from xyz, uv and w (24 B gathered per slot, where storing A would
//     cost 48 B written and read); block_sum adds U, g_cam and the cost in
//     a fixed order, and the block writes U [6, 6], g_cam and its share of
//     the cost once.
//   Both phases call linearize_slot and pose_jacobian below, so r, the
//   Huber weight and A are the same bits in both.  On the H100 at
//   bench_ba, phase A takes ~26 us and phase B ~22 us (chip_smoke.py, by
//   kernel): phase B's gathers, not its math, set its time.  Packing x, uv
//   and w into one 32-byte record per slot in phase A shortened phase B
//   but lengthened phase A by more.
// What the earlier design did and this one does not: a [C, 28] accumulator
// per block in shared memory with 28 shared atomics per slot (112 KB at
// C = 1000, capping C at ~2000), a [nblocks, C, 28] scratch (30 MB at
// bench_ba, written and read again) and a second summing launch, a grid
// capped at 2 blocks per SM, 18 strided scalar stores of W per slot, a
// serial per-landmark sum by one thread behind two barriers, and a packed
// camera table and a U gather built around the kernel.  Every sum here runs
// in a fixed order, so two launches give the same bits.

#include <cuda_runtime.h>

#include "ba_common.cuh"

namespace {

using sfm::kThreads;
using sfm::kW;
constexpr int kAcc = 28;  // U upper triangle (21) | g_cam (6) | cost (1)
constexpr int kLm = 9;    // V upper triangle (6) | g_lm (3)

struct Intrinsics {
  float fx, skew, cx, fy, cy;
};

__device__ __forceinline__ Intrinsics load_intrinsics(const float* Kmat) {
  return {__ldg(Kmat + 0), __ldg(Kmat + 1), __ldg(Kmat + 2), __ldg(Kmat + 4),
          __ldg(Kmat + 5)};
}

// one observation's projection: R X, the residual, the projection
// Jacobian d(uv)/dp (J00 J01 J02 / 0 J11 J12) and the weight w_obs * Huber
struct Slot {
  float RX[3], r0, r1, J00, J01, J02, J11, J12, w;
};

__device__ __forceinline__ Slot linearize_slot(const Intrinsics& in,
                                               const float (&R)[9],
                                               const float (&t)[3], float x0,
                                               float x1, float x2, float u_o,
                                               float v_o, float w_o,
                                               float huber) {
  Slot s;
  s.RX[0] = R[0] * x0 + R[1] * x1 + R[2] * x2;
  s.RX[1] = R[3] * x0 + R[4] * x1 + R[5] * x2;
  s.RX[2] = R[6] * x0 + R[7] * x1 + R[8] * x2;
  const float p0 = s.RX[0] + t[0], p1 = s.RX[1] + t[1], z = s.RX[2] + t[2];
  const float z_safe = fabsf(z) < 1e-6f ? (z < 0.0f ? -1e-6f : 1e-6f) : z;
  const float iz = 1.0f / z_safe;
  s.r0 = in.fx * p0 * iz + in.skew * p1 * iz + in.cx - u_o;
  s.r1 = in.fy * p1 * iz + in.cy - v_o;
  s.J00 = in.fx * iz;
  s.J01 = in.skew * iz;
  s.J02 = -(in.fx * p0 + in.skew * p1) * iz * iz;
  s.J11 = in.fy * iz;
  s.J12 = -in.fy * p1 * iz * iz;
  s.w = w_o;
  if (huber > 0.0f) {
    const float nrm = sqrtf(s.r0 * s.r0 + s.r1 * s.r1);
    s.w *= nrm <= huber ? 1.0f : huber / fmaxf(nrm, 1e-12f);
  }
  return s;
}

// A = wA [duv_dp @ -hat(RX) | duv_dp], rows A0 and A1
__device__ __forceinline__ void pose_jacobian(const Slot& s, float wA,
                                              float (&A0)[6], float (&A1)[6]) {
  const float* RX = s.RX;
  A0[0] = wA * (s.J01 * (-RX[2]) + s.J02 * RX[1]);
  A0[1] = wA * (s.J00 * RX[2] + s.J02 * (-RX[0]));
  A0[2] = wA * (s.J00 * (-RX[1]) + s.J01 * RX[0]);
  A0[3] = wA * s.J00;
  A0[4] = wA * s.J01;
  A0[5] = wA * s.J02;
  A1[0] = wA * (s.J11 * (-RX[2]) + s.J12 * RX[1]);
  A1[1] = wA * (s.J12 * (-RX[0]));
  A1[2] = wA * (s.J11 * RX[0]);
  A1[3] = 0.0f;
  A1[4] = wA * s.J11;
  A1[5] = wA * s.J12;
}

// camera c's R, t and cam_free (small arrays: they stay in L1 / L2)
__device__ __forceinline__ void load_camera(const float* __restrict__ Rs,
                                            const float* __restrict__ ts,
                                            const float* __restrict__ frees,
                                            int c, float (&R)[9],
                                            float (&t)[3], float& cfree) {
#pragma unroll
  for (int i = 0; i < 9; ++i) R[i] = __ldg(Rs + 9 * (size_t)c + i);
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = __ldg(ts + 3 * (size_t)c + i);
  cfree = __ldg(frees + c);
}

__global__ void __launch_bounds__(kThreads)
landmark_phase(const float* __restrict__ Kmat, const float* __restrict__ Rs,
               const float* __restrict__ ts, const float* __restrict__ frees,
               const float* __restrict__ xyz, const float* __restrict__ lm_free,
               const int* __restrict__ lm_cam,
               const float* __restrict__ lm_uv,
               const float* __restrict__ lm_w, int L, int kmax, int C,
               float huber, float* __restrict__ W, float* __restrict__ V,
               float* __restrict__ g_lm) {
  extern __shared__ float4 smem4[];
  const int G = sfm::group_size(kmax);
  const int lpb = kThreads / G;
  float* wtile = reinterpret_cast<float*>(smem4);  // [lpb, kmax, 6, 3]
  __shared__ __align__(16) float vtile[kThreads * 9];  // [lpb, 3, 3]
  __shared__ __align__(16) float gtile[kThreads * 3];  // [lpb, 3]
  const Intrinsics in = load_intrinsics(Kmat);
  const int l0 = blockIdx.x * lpb;
  const int nl = min(lpb, L - l0);
  const int j = threadIdx.x % G;   // lane within the landmark
  const int lt = threadIdx.x / G;  // landmark within the tile
  const int l = l0 + lt;
  const bool live = lt < nl;

  float v[kLm] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (live) {
    const float x0 = __ldg(xyz + 3 * (size_t)l);
    const float x1 = __ldg(xyz + 3 * (size_t)l + 1);
    const float x2 = __ldg(xyz + 3 * (size_t)l + 2);
    const float lfree = __ldg(lm_free + l);
    for (int k = j; k < kmax; k += G) {
      const size_t s = (size_t)l * kmax + k;
      float* ws = wtile + (lt * kmax + k) * kW;
      const float w_o = __ldg(lm_w + s);
      if (w_o == 0.0f) {  // empty slot: zero W block
#pragma unroll
        for (int i = 0; i < kW; ++i) ws[i] = 0.0f;
        continue;
      }
      // keep the camera index in range whatever the table holds
      const int c = min(max(__ldg(lm_cam + s), 0), C - 1);
      float R[9], t[3], cfree;
      load_camera(Rs, ts, frees, c, R, t, cfree);
      const float2 uv = __ldg(reinterpret_cast<const float2*>(lm_uv) + s);
      const Slot sl = linearize_slot(in, R, t, x0, x1, x2, uv.x, uv.y, w_o,
                                     huber);
      float A0[6], A1[6];
      pose_jacobian(sl, sl.w * cfree, A0, A1);
      const float wB = sl.w * lfree;
      // B = wB duv_dp @ R
      const float B0[3] = {
          wB * (sl.J00 * R[0] + sl.J01 * R[3] + sl.J02 * R[6]),
          wB * (sl.J00 * R[1] + sl.J01 * R[4] + sl.J02 * R[7]),
          wB * (sl.J00 * R[2] + sl.J01 * R[5] + sl.J02 * R[8])};
      const float B1[3] = {wB * (sl.J11 * R[3] + sl.J12 * R[6]),
                           wB * (sl.J11 * R[4] + sl.J12 * R[7]),
                           wB * (sl.J11 * R[5] + sl.J12 * R[8])};
      const float rw0 = sl.r0 * sl.w, rw1 = sl.r1 * sl.w;
#pragma unroll
      for (int a = 0; a < 6; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b)
          ws[a * 3 + b] = A0[a] * B0[b] + A1[a] * B1[b];
      v[0] += B0[0] * B0[0] + B1[0] * B1[0];
      v[1] += B0[0] * B0[1] + B1[0] * B1[1];
      v[2] += B0[0] * B0[2] + B1[0] * B1[2];
      v[3] += B0[1] * B0[1] + B1[1] * B1[1];
      v[4] += B0[1] * B0[2] + B1[1] * B1[2];
      v[5] += B0[2] * B0[2] + B1[2] * B1[2];
      v[6] += -(B0[0] * rw0 + B1[0] * rw1);
      v[7] += -(B0[1] * rw0 + B1[1] * rw1);
      v[8] += -(B0[2] * rw0 + B1[2] * rw1);
    }
  }
  sfm::group_sum<kLm>(v, G);
  if (live && j == 0) {
    float* Vl = vtile + 9 * lt;
    Vl[0] = v[0]; Vl[1] = v[1]; Vl[2] = v[2];
    Vl[3] = v[1]; Vl[4] = v[3]; Vl[5] = v[4];
    Vl[6] = v[2]; Vl[7] = v[4]; Vl[8] = v[5];
    gtile[3 * lt] = v[6];
    gtile[3 * lt + 1] = v[7];
    gtile[3 * lt + 2] = v[8];
  }
  __syncthreads();
  sfm::store_tile(W + (size_t)l0 * kmax * kW, wtile, nl * kmax * kW);
  sfm::store_tile(V + 9 * (size_t)l0, vtile, 9 * nl);
  sfm::store_tile(g_lm + 3 * (size_t)l0, gtile, 3 * nl);
}

// at most 64 registers, so that 8 blocks fit an SM and bench_ba's 1000
// cameras run in one wave
__global__ void __launch_bounds__(kThreads, 8)
camera_phase(const float* __restrict__ Kmat, const float* __restrict__ Rs,
             const float* __restrict__ ts, const float* __restrict__ frees,
             const float* __restrict__ xyz, const float* __restrict__ lm_uv,
             const float* __restrict__ lm_w, const int* __restrict__ slots,
             const int* __restrict__ offsets, int kmax, float huber,
             float* __restrict__ U, float* __restrict__ g_cam,
             float* __restrict__ cost) {
  const int c = blockIdx.x;
  const Intrinsics in = load_intrinsics(Kmat);
  float R[9], t[3], cfree;
  load_camera(Rs, ts, frees, c, R, t, cfree);
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;
  // thread t takes the camera's slots t, t + kThreads, ..., with the
  // loads of kUnroll of them in flight before their math
  constexpr int kUnroll = 2;
  const int end = __ldg(offsets + c + 1);
  for (int i = __ldg(offsets + c) + threadIdx.x; i < end;
       i += kUnroll * kThreads) {
    float w_o[kUnroll], X[kUnroll][3];
    float2 uv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int iu = i + u * kThreads;
      const int s = iu < end ? __ldg(slots + iu) : 0;
      w_o[u] = iu < end ? __ldg(lm_w + s) : 0.0f;
      uv[u] = __ldg(reinterpret_cast<const float2*>(lm_uv) + s);
      const float* Xs = xyz + 3 * (size_t)(s / kmax);
#pragma unroll
      for (int a = 0; a < 3; ++a) X[u][a] = __ldg(Xs + a);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (w_o[u] == 0.0f) continue;  // an empty slot, or past the end
      const Slot sl = linearize_slot(in, R, t, X[u][0], X[u][1], X[u][2],
                                     uv[u].x, uv[u].y, w_o[u], huber);
      float A0[6], A1[6];
      pose_jacobian(sl, sl.w * cfree, A0, A1);
      const float rw0 = sl.r0 * sl.w, rw1 = sl.r1 * sl.w;
      int e = 0;
#pragma unroll
      for (int a = 0; a < 6; ++a)
#pragma unroll
        for (int b = a; b < 6; ++b) acc[e++] += A0[a] * A0[b] + A1[a] * A1[b];
#pragma unroll
      for (int a = 0; a < 6; ++a) acc[21 + a] += -(A0[a] * rw0 + A1[a] * rw1);
      acc[27] += sl.w * (sl.r0 * sl.r0 + sl.r1 * sl.r1);
    }
  }
  __shared__ float sums[kAcc];
  sfm::block_sum<kAcc>(acc, sums);
  __syncthreads();
  if (threadIdx.x < 36) {  // U [6, 6] from its upper triangle
    const int p = threadIdx.x / 6, q = threadIdx.x % 6;
    const int a = min(p, q), b = max(p, q);
    U[36 * (size_t)c + threadIdx.x] = sums[a * (11 - a) / 2 + b];
  }
  if (threadIdx.x < 6) g_cam[6 * (size_t)c + threadIdx.x] = sums[21 + threadIdx.x];
  if (threadIdx.x == 0) cost[c] = sums[27];
}

}  // namespace

// K: [3, 3] intrinsics; R [C, 3, 3], tvec [C, 3], cam_free [C]; xyz:
// [L, 3]; lm_free: [L]; lm_cam: [L, kmax] int32; lm_uv: [L, kmax, 2];
// lm_w: [L, kmax]; offsets [C + 1] and slots [L * kmax] int32, the
// camera-major CSR of the live slots (all f32 unless noted).  Writes W
// [L, kmax, 6, 3], V [L, 3, 3], g_lm [L, 3], U [C, 6, 6], g_cam [C, 6] and
// each camera's share of the cost, cost [C].
extern "C" int sfm_ba_linearize(const void* K, const void* R,
                                const void* tvec, const void* cam_free,
                                const void* xyz, const void* lm_free,
                                const void* lm_cam, const void* lm_uv,
                                const void* lm_w, const void* offsets,
                                const void* slots, int L, int kmax, int C,
                                float huber, void* W, void* V, void* g_lm,
                                void* U, void* g_cam, void* cost,
                                void* stream) {
  if (C < 1 || L < 0 || kmax < 1 || kmax > sfm::kMaxKmax)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* Kf = static_cast<const float*>(K);
  const float* Rf = static_cast<const float*>(R);
  const float* tf = static_cast<const float*>(tvec);
  const float* ff = static_cast<const float*>(cam_free);
  const float* xyzf = static_cast<const float*>(xyz);
  const float* uvf = static_cast<const float*>(lm_uv);
  const float* wf = static_cast<const float*>(lm_w);
  if (L > 0) {
    const size_t smem = sfm::tile_bytes(kmax);
    cudaError_t err = sfm::allow_smem(landmark_phase, smem);
    if (err != cudaSuccess) return (int)err;
    const int lpb = kThreads / sfm::group_size(kmax);
    landmark_phase<<<(L + lpb - 1) / lpb, kThreads, smem, st>>>(
        Kf, Rf, tf, ff, xyzf, static_cast<const float*>(lm_free),
        static_cast<const int*>(lm_cam), uvf, wf, L, kmax, C, huber,
        static_cast<float*>(W), static_cast<float*>(V),
        static_cast<float*>(g_lm));
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  camera_phase<<<C, kThreads, 0, st>>>(
      Kf, Rf, tf, ff, xyzf, uvf, wf, static_cast<const int*>(slots),
      static_cast<const int*>(offsets), kmax, huber, static_cast<float*>(U),
      static_cast<float*>(g_cam), static_cast<float*>(cost));
  return (int)cudaGetLastError();
}
