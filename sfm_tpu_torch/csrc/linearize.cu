// K2: the bundle-adjustment linearizer for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel sfm_tpu/ba/linearize_pallas.py
// (_linearize_kernel, launched by linearize_fused).  One pass over the
// landmark-major observation table [L, kmax] (w == 0 marks an empty slot)
// computes everything one LM iteration of the implicit-Schur solver needs:
//   per slot (l, k):  the residual r [2] and the Jacobians A [2, 6] (pose)
//                     and B [2, 3] (point), with z_safe and the skew term
//                     as linearize_pallas.py writes them; the Huber IRLS
//                     weight w = w_obs * min(1, delta / |r|); A scaled by
//                     w * cam_free, B by w * lm_free; W[l, k] = A^T B,
//                     written as [L, kmax, 6, 3] row-major (what K3 reads);
//   per landmark:     V = sum_k B^T B [3, 3], g_lm = -sum_k B^T r w [3];
//   per camera:       the 21 upper entries of U = A^T A, g_cam = -A^T r w
//                     and the cost sum w |r|^2, as one [C, 28] row.
// The cost is sum (w_obs * huber_w) * |r|^2 over the kept slots: NOT the
// dense solver's rho-cost (ba/residuals.py::robust_cost).  LM accepts or
// rejects steps on it, so using the other definition changes the solve.
//
// Design.  One thread per slot (l, k): a block holds whole landmarks,
// lpb = max(1, 128 / kmax) of them (lpb * kmax threads), and walks the
// landmark axis grid-stride.  Any kmax up to 256 works (the TPU kernel once
// clamped slots >= 8 to row 7; here k indexes global memory directly).
// The camera is gathered from a packed [C, 13] table (R row-major | t |
// cam_free) through the read-only cache; the TPU needed a one-hot matmul
// for that gather.  V and g_lm: each thread stages its slot's 9 values in
// shared memory and the landmark's k = 0 thread sums them in slot order,
// so they need no atomics and do not vary from run to run.  The
// per-camera sums are a reduction across blocks: each block accumulates a
// [C, 28] partial in shared memory with shared-memory atomicAdd (C * 112
// bytes: 112 KB at C = 1000; the wrapper raises above ~2000 cameras),
// writes it to its row of a [nblocks, C, 28] scratch buffer, and
// sum_partials adds the rows in block order.  The order of the atomics
// within a block is not fixed, so U, g_cam and the cost vary in the last
// bits from run to run (as index_add_ does in the plain version).  Zero
// contributions (frozen cameras, empty slots) are not added, and the
// slots of one landmark come from distinct cameras, so a warp's atomics
// conflict only across its 32 / kmax landmarks.
//
// What bounds it.  About 300 flops and 100 bytes of table per slot, so it
// is latency- and shared-atomic bound, not bandwidth bound (W is the
// largest stream: 43 MB written at the bench_ba shape, L = 100k, kmax =
// 6).  The grid has at most 2 blocks per SM (the wrapper sizes it), so the
// scratch stays at 2 * 132 * C * 112 B.  At the flagship's mapping BA
// (L = 2048, kmax = 8) that is 128 blocks of 128 threads, but only the
// live landmarks work, and compaction puts them in the first blocks: a map
// of ~350 live landmarks keeps ~22 SMs busy.

#include <cuda_runtime.h>

#include "partials.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kAcc = 28;  // U upper triangle (21) | g_cam (6) | cost (1)
constexpr int kCam = 13;  // R row-major (9) | t (3) | cam_free (1)
constexpr int kLm = 9;    // V upper triangle (6) | g_lm (3), per slot

__global__ void __launch_bounds__(kMaxThreads)
linearize_kernel(const float* __restrict__ Kmat, const float* __restrict__ cam,
                 const float* __restrict__ xyz,
                 const float* __restrict__ lm_free,
                 const int* __restrict__ lm_cam,
                 const float* __restrict__ lm_uv,
                 const float* __restrict__ lm_w, int L, int kmax, int C,
                 float huber, float* __restrict__ W, float* __restrict__ V,
                 float* __restrict__ g_lm, float* __restrict__ partial) {
  extern __shared__ float smem[];
  float* acc = smem;                        // [C, kAcc]
  float* red = smem + C * kAcc;             // [blockDim.x, kLm]
  const int n_acc = C * kAcc;
  for (int i = threadIdx.x; i < n_acc; i += blockDim.x) acc[i] = 0.0f;
  __syncthreads();

  const float fx = __ldg(Kmat + 0), skew = __ldg(Kmat + 1);
  const float cx = __ldg(Kmat + 2), fy = __ldg(Kmat + 4);
  const float cy = __ldg(Kmat + 5);
  const int lpb = blockDim.x / kmax;        // landmarks per block step
  const int k = threadIdx.x % kmax;
  float* mine = red + threadIdx.x * kLm;

  for (int base = blockIdx.x * lpb; base < L; base += gridDim.x * lpb) {
    const int l = base + threadIdx.x / kmax;
    float q[kLm] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    const size_t s = (size_t)l * kmax + k;
    const float w_o = l < L ? lm_w[s] : 0.0f;
    if (l < L && w_o == 0.0f) {  // empty slot: zero W block
      float* Ws = W + s * 18;
      for (int i = 0; i < 18; ++i) Ws[i] = 0.0f;
    } else if (l < L) {
      const float x0 = xyz[3 * l], x1 = xyz[3 * l + 1], x2 = xyz[3 * l + 2];
      const float lfree = lm_free[l];
      // keep the camera index in range whatever the table holds
      const int c = min(max(lm_cam[s], 0), C - 1);
      const float* cp = cam + (size_t)c * kCam;
      float R[9];
#pragma unroll
      for (int i = 0; i < 9; ++i) R[i] = __ldg(cp + i);
      const float t0 = __ldg(cp + 9), t1 = __ldg(cp + 10);
      const float t2 = __ldg(cp + 11), cfree = __ldg(cp + 12);
      const float u_o = lm_uv[2 * s], v_o = lm_uv[2 * s + 1];

      const float RX0 = R[0] * x0 + R[1] * x1 + R[2] * x2;
      const float RX1 = R[3] * x0 + R[4] * x1 + R[5] * x2;
      const float RX2 = R[6] * x0 + R[7] * x1 + R[8] * x2;
      const float p0 = RX0 + t0, p1 = RX1 + t1, z = RX2 + t2;
      const float z_safe =
          fabsf(z) < 1e-6f ? (z < 0.0f ? -1e-6f : 1e-6f) : z;
      const float iz = 1.0f / z_safe;
      const float r0 = fx * p0 * iz + skew * p1 * iz + cx - u_o;
      const float r1 = fy * p1 * iz + cy - v_o;

      const float J00 = fx * iz, J01 = skew * iz;
      const float J02 = -(fx * p0 + skew * p1) * iz * iz;
      const float J11 = fy * iz, J12 = -fy * p1 * iz * iz;

      float w = w_o;
      if (huber > 0.0f) {
        const float nrm = sqrtf(r0 * r0 + r1 * r1);
        w *= nrm <= huber ? 1.0f : huber / fmaxf(nrm, 1e-12f);
      }
      const float wA = w * cfree, wB = w * lfree;

      // A = [duv_dp @ -hat(RX) | duv_dp], B = duv_dp @ R
      const float A0[6] = {wA * (J01 * (-RX2) + J02 * RX1),
                           wA * (J00 * RX2 + J02 * (-RX0)),
                           wA * (J00 * (-RX1) + J01 * RX0),
                           wA * J00, wA * J01, wA * J02};
      const float A1[6] = {wA * (J11 * (-RX2) + J12 * RX1),
                           wA * (J12 * (-RX0)), wA * (J11 * RX0),
                           0.0f, wA * J11, wA * J12};
      const float B0[3] = {wB * (J00 * R[0] + J01 * R[3] + J02 * R[6]),
                           wB * (J00 * R[1] + J01 * R[4] + J02 * R[7]),
                           wB * (J00 * R[2] + J01 * R[5] + J02 * R[8])};
      const float B1[3] = {wB * (J11 * R[3] + J12 * R[6]),
                           wB * (J11 * R[4] + J12 * R[7]),
                           wB * (J11 * R[5] + J12 * R[8])};
      const float rw0 = r0 * w, rw1 = r1 * w;

      float* Ws = W + s * 18;
#pragma unroll
      for (int a = 0; a < 6; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b)
          Ws[a * 3 + b] = A0[a] * B0[b] + A1[a] * B1[b];

      q[0] = B0[0] * B0[0] + B1[0] * B1[0];
      q[1] = B0[0] * B0[1] + B1[0] * B1[1];
      q[2] = B0[0] * B0[2] + B1[0] * B1[2];
      q[3] = B0[1] * B0[1] + B1[1] * B1[1];
      q[4] = B0[1] * B0[2] + B1[1] * B1[2];
      q[5] = B0[2] * B0[2] + B1[2] * B1[2];
      q[6] = -(B0[0] * rw0 + B1[0] * rw1);
      q[7] = -(B0[1] * rw0 + B1[1] * rw1);
      q[8] = -(B0[2] * rw0 + B1[2] * rw1);

      float* ac = acc + c * kAcc;
      float e[kAcc];
      int i = 0;
#pragma unroll
      for (int a = 0; a < 6; ++a)
#pragma unroll
        for (int b = a; b < 6; ++b) e[i++] = A0[a] * A0[b] + A1[a] * A1[b];
#pragma unroll
      for (int a = 0; a < 6; ++a) e[21 + a] = -(A0[a] * rw0 + A1[a] * rw1);
      e[27] = w * (r0 * r0 + r1 * r1);
#pragma unroll
      for (int j = 0; j < kAcc; ++j)
        if (e[j] != 0.0f) atomicAdd(ac + j, e[j]);
    }
#pragma unroll
    for (int j = 0; j < kLm; ++j) mine[j] = q[j];
    __syncthreads();
    if (k == 0 && l < L) {  // the landmark's sums, in slot order
      float v[kLm] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int kk = 0; kk < kmax; ++kk)
#pragma unroll
        for (int j = 0; j < kLm; ++j) v[j] += mine[kk * kLm + j];
      float* Vl = V + 9 * (size_t)l;
      Vl[0] = v[0]; Vl[1] = v[1]; Vl[2] = v[2];
      Vl[3] = v[1]; Vl[4] = v[3]; Vl[5] = v[4];
      Vl[6] = v[2]; Vl[7] = v[4]; Vl[8] = v[5];
      g_lm[3 * (size_t)l] = v[6];
      g_lm[3 * (size_t)l + 1] = v[7];
      g_lm[3 * (size_t)l + 2] = v[8];
    }
    __syncthreads();
  }

  float* dst = partial + (size_t)blockIdx.x * n_acc;
  for (int i = threadIdx.x; i < n_acc; i += blockDim.x) dst[i] = acc[i];
}

}  // namespace

// K: [3, 3] intrinsics; cam: [C, 13]; xyz: [L, 3]; lm_free: [L];
// lm_cam: [L, kmax] int32; lm_uv: [L, kmax, 2]; lm_w: [L, kmax] (all f32
// unless noted).  Writes W [L, kmax, 6, 3], V [L, 3, 3], g_lm [L, 3] and
// camacc [C, 28]; partial is [nblocks, C, 28] scratch.
extern "C" int sfm_ba_linearize(const void* K, const void* cam,
                                const void* xyz, const void* lm_free,
                                const void* lm_cam, const void* lm_uv,
                                const void* lm_w, int L, int kmax, int C,
                                float huber, int nblocks, void* W, void* V,
                                void* g_lm, void* partial, void* camacc,
                                void* stream) {
  if (C < 1 || L < 0 || kmax < 1 || kmax > kMaxThreads || nblocks < 1)
    return (int)cudaErrorInvalidValue;
  const int threads = (kMaxThreads / 2 >= kmax ? kMaxThreads / 2 / kmax : 1)
                      * kmax;
  const size_t smem = ((size_t)C * kAcc + (size_t)threads * kLm) *
                      sizeof(float);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      linearize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  linearize_kernel<<<nblocks, threads, smem, st>>>(
      static_cast<const float*>(K), static_cast<const float*>(cam),
      static_cast<const float*>(xyz), static_cast<const float*>(lm_free),
      static_cast<const int*>(lm_cam), static_cast<const float*>(lm_uv),
      static_cast<const float*>(lm_w), L, kmax, C, huber,
      static_cast<float*>(W), static_cast<float*>(V),
      static_cast<float*>(g_lm), static_cast<float*>(partial));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sfm::launch_sum_partials(static_cast<const float*>(partial), nblocks,
                           C * kAcc, static_cast<float*>(camacc), st);
  return (int)cudaGetLastError();
}
