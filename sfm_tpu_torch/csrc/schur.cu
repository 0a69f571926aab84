// K3: the implicit-Schur coupling apply for Hopper (sm_90a), with the two
// halves K4a / K4b as modes of the same kernel.
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
// Empty slots carry zero W blocks, so no mask is needed; the camera index
// is clamped into range all the same.  g == NULL or x == NULL read as 0.
//
// Design.  The TPU kernel had no cheap gather, so it built one-hot
// [C, tile] operands in VMEM for the MXU, and carried y across its
// sequential grid.  Here x (C * 24 bytes: 24 KB at C = 1000) is staged in
// shared memory and gathered per slot.  One thread per slot (l, k); a block
// holds lpb = max(1, 128 / kmax) whole landmarks and walks the landmark
// axis grid-stride.  Each thread stages its slot's W^T x [3] in shared
// memory, the landmark's k = 0 thread adds them to g in slot order and
// writes z = Vinv t (so z does not vary from run to run), and every thread
// then scatters its slot's W z [6] into the block's [C, 6] y partial with
// shared-memory atomicAdd.  Zero contributions (empty slots, dead
// landmarks: all carry camera 0) are not added.  Each block writes its
// partial to a row of a [nblocks, C, 6] scratch buffer, and sum_partials
// adds the rows in block order.  Within a block the atomics' order is not
// fixed, so y varies in the last bits from run to run.
//
// What bounds it.  Each apply streams W once (72 bytes and 72 flops per
// slot, re-read from L1 for the scatter), so at the bench_ba shape
// (L = 100k, kmax = 6, 43 MB of W) it is bound by memory bandwidth and
// latency; the TPU kernel kept the tile in VMEM between the two halves.
// At the flagship's mapping BA (L = 2048, kmax = 8) the grid has 128
// blocks of 128 threads, but compaction puts the live landmarks in the
// first blocks, so most of them only read zeros.

#include <cuda_runtime.h>

#include "partials.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kFull = 0, kGather = 1, kScatter = 2;

template <int kMode>
__global__ void __launch_bounds__(kMaxThreads)
schur_kernel(const int* __restrict__ lm_cam, const float* __restrict__ W,
             const float* __restrict__ vinv, const float* __restrict__ g,
             const float* __restrict__ x, const float* __restrict__ z_in,
             int L, int kmax, int C, float* __restrict__ z_out,
             float* __restrict__ partial) {
  constexpr bool kComputesZ = kMode != kScatter;
  constexpr bool kScattersY = kMode != kGather;
  extern __shared__ float smem[];
  const bool use_x = kComputesZ && x != nullptr;
  const int lpb = blockDim.x / kmax;           // landmarks per block step
  float* xs = smem;                            // [C, 6] when use_x
  float* ys = xs + (use_x ? C * 6 : 0);        // [C, 6] when kScattersY
  float* red = ys + (kScattersY ? C * 6 : 0);  // [blockDim.x, 3]
  float* zs = red + 3 * blockDim.x;            // [lpb, 3]
  if (use_x)
    for (int i = threadIdx.x; i < C * 6; i += blockDim.x) xs[i] = x[i];
  if (kScattersY)
    for (int i = threadIdx.x; i < C * 6; i += blockDim.x) ys[i] = 0.0f;
  __syncthreads();

  const int k = threadIdx.x % kmax;
  const int j = threadIdx.x / kmax;            // landmark within the step
  for (int base = blockIdx.x * lpb; base < L; base += gridDim.x * lpb) {
    const int l = base + j;
    const bool live = l < L;
    const size_t s = (size_t)l * kmax + k;
    const float* w = W + s * 18;
    const int c = live ? min(max(lm_cam[s], 0), C - 1) : 0;
    float z0 = 0.0f, z1 = 0.0f, z2 = 0.0f;
    if (kComputesZ) {
      float t0 = 0.0f, t1 = 0.0f, t2 = 0.0f;
      if (live && use_x) {
        const float* xc = xs + c * 6;
#pragma unroll
        for (int a = 0; a < 6; ++a) {
          const float xa = xc[a];
          t0 += w[a * 3 + 0] * xa;
          t1 += w[a * 3 + 1] * xa;
          t2 += w[a * 3 + 2] * xa;
        }
      }
      red[3 * threadIdx.x] = t0;
      red[3 * threadIdx.x + 1] = t1;
      red[3 * threadIdx.x + 2] = t2;
      __syncthreads();
      if (live && k == 0) {  // t = g + sum_k W^T x, in slot order
        float u0 = 0.0f, u1 = 0.0f, u2 = 0.0f;
        if (g != nullptr) {
          u0 = g[3 * (size_t)l];
          u1 = g[3 * (size_t)l + 1];
          u2 = g[3 * (size_t)l + 2];
        }
        for (int kk = 0; kk < kmax; ++kk) {
          const float* r = red + 3 * (threadIdx.x + kk);
          u0 += r[0];
          u1 += r[1];
          u2 += r[2];
        }
        const float* vi = vinv + 9 * (size_t)l;
        const float a0 = vi[0] * u0 + vi[1] * u1 + vi[2] * u2;
        const float a1 = vi[3] * u0 + vi[4] * u1 + vi[5] * u2;
        const float a2 = vi[6] * u0 + vi[7] * u1 + vi[8] * u2;
        z_out[3 * (size_t)l] = a0;
        z_out[3 * (size_t)l + 1] = a1;
        z_out[3 * (size_t)l + 2] = a2;
        zs[3 * j] = a0;
        zs[3 * j + 1] = a1;
        zs[3 * j + 2] = a2;
      }
      __syncthreads();
      if (kScattersY && live) {
        z0 = zs[3 * j];
        z1 = zs[3 * j + 1];
        z2 = zs[3 * j + 2];
      }
    } else if (live) {
      z0 = z_in[3 * (size_t)l];
      z1 = z_in[3 * (size_t)l + 1];
      z2 = z_in[3 * (size_t)l + 2];
    }
    if (kScattersY && live) {
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        const float q = w[a * 3] * z0 + w[a * 3 + 1] * z1 + w[a * 3 + 2] * z2;
        if (q != 0.0f) atomicAdd(ys + c * 6 + a, q);
      }
    }
    if (kComputesZ) __syncthreads();  // red and zs are reused next step
  }

  if (kScattersY) {
    __syncthreads();
    float* dst = partial + (size_t)blockIdx.x * C * 6;
    for (int i = threadIdx.x; i < C * 6; i += blockDim.x) dst[i] = ys[i];
  }
}

template <int kMode>
int launch(const void* lm_cam, const void* W, const void* vinv, const void* g,
           const void* x, const void* z_in, int L, int kmax, int C,
           int nblocks, void* z_out, void* partial, void* y,
           cudaStream_t st) {
  const int threads = (kMaxThreads / 2 >= kmax ? kMaxThreads / 2 / kmax : 1)
                      * kmax;
  const bool use_x = kMode != kScatter && x != nullptr;
  const size_t smem =
      (((use_x ? 1 : 0) + (kMode != kGather ? 1 : 0)) * (size_t)C * 6 +
       3 * (size_t)threads + 3 * (size_t)(threads / kmax)) * sizeof(float);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      schur_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  schur_kernel<kMode><<<nblocks, threads, smem, st>>>(
      static_cast<const int*>(lm_cam), static_cast<const float*>(W),
      static_cast<const float*>(vinv), static_cast<const float*>(g),
      static_cast<const float*>(x), static_cast<const float*>(z_in), L, kmax,
      C, static_cast<float*>(z_out), static_cast<float*>(partial));
  err = cudaGetLastError();
  if (err != cudaSuccess || kMode == kGather) return (int)err;
  sfm::launch_sum_partials(static_cast<const float*>(partial), nblocks,
                           C * 6, static_cast<float*>(y), st);
  return (int)cudaGetLastError();
}

}  // namespace

// mode 0 full (writes z_out and y), 1 gather (z_out), 2 scatter (reads
// z_in, writes y); partial is [nblocks, C, 6] scratch (unused by gather).
extern "C" int sfm_schur_apply(int mode, const void* lm_cam, const void* W,
                               const void* vinv, const void* g,
                               const void* x, const void* z_in, int L,
                               int kmax, int C, int nblocks, void* z_out,
                               void* partial, void* y, void* stream) {
  if (C < 1 || L < 0 || kmax < 1 || kmax > kMaxThreads || nblocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kFull:
      return launch<kFull>(lm_cam, W, vinv, g, x, z_in, L, kmax, C, nblocks,
                           z_out, partial, y, st);
    case kGather:
      return launch<kGather>(lm_cam, W, vinv, g, x, z_in, L, kmax, C,
                             nblocks, z_out, partial, y, st);
    case kScatter:
      return launch<kScatter>(lm_cam, W, vinv, g, x, z_in, L, kmax, C,
                              nblocks, z_out, partial, y, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
