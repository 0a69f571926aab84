// K5: subpixel patch sampler for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel sfm_tpu/features/patches_pallas.py
// (_extract_kernel, launched by extract_patches_pallas) and, on the main
// path, the selection-matmul sampler it stood in for
// (sfm_tpu/features/descriptor.py::_patches_matmul).  Per keypoint: the
// 33 x 33 patch centred at (cx, cy) of the smoothed pyramid canvas, each
// value a 4-tap bilinear lerp (x first, then y: descriptor.py's
// extract_patches order).  Taps outside the canvas read 0, as the
// selection matmul's one-hot rows do; nothing is clamped.
//
// What bounds it: memory latency.  512 keypoints read 512 x 34 x 34 x 4 B
// = 2.4 MB (the canvas itself is 2.3 MB and sits in L2) and write 2.2 MB.
// The TPU could not gather, so it spent N * 33 * Hc * Wc multiply-adds on
// selection matmuls; here each block gathers its 34 x 34 window into shared
// memory once and every thread lerps from there.  Products and sums are
// rounded separately (no FMA contraction) so the values equal the plain
// version's bit for bit.
//
// A batch of B canvases [B, Hc, Wc] with N keypoints each is one launch of
// B * N blocks: block n samples canvas n / N, and its taps outside that
// canvas read 0 (never the next canvas's rows, as a batch stacked into one
// tall canvas would).  A single canvas is the case B = 1.

#include <cuda_runtime.h>

namespace {

constexpr int kRadius = 16;
constexpr int kPatch = 2 * kRadius + 1;  // 33
constexpr int kWin = kPatch + 1;         // 34
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
patch_kernel(const float* __restrict__ canvases, int Hc, int Wc, int N,
             const float* __restrict__ cx, const float* __restrict__ cy,
             float* __restrict__ out) {
  __shared__ float win[kWin * kWin];
  const int n = blockIdx.x;
  const float* __restrict__ canvas =
      canvases + (size_t)(n / N) * (size_t)Hc * (size_t)Wc;
  const float fcx = floorf(cx[n]);
  const float fcy = floorf(cy[n]);
  const int x0 = (int)fcx - kRadius;
  const int y0 = (int)fcy - kRadius;
  const float fx = __fsub_rn(cx[n], fcx);
  const float fy = __fsub_rn(cy[n], fcy);
  const float gx = __fsub_rn(1.0f, fx);
  const float gy = __fsub_rn(1.0f, fy);

  for (int i = threadIdx.x; i < kWin * kWin; i += kThreads) {
    const int y = y0 + i / kWin;
    const int x = x0 + i % kWin;
    win[i] = (y >= 0 && y < Hc && x >= 0 && x < Wc)
                 ? __ldg(canvas + (size_t)y * Wc + x)
                 : 0.0f;
  }
  __syncthreads();

  float* dst = out + (size_t)n * kPatch * kPatch;
  for (int i = threadIdx.x; i < kPatch * kPatch; i += kThreads) {
    const int r = i / kPatch;
    const int c = i % kPatch;
    const float* w0 = win + r * kWin + c;
    const float* w1 = w0 + kWin;
    const float top = __fadd_rn(__fmul_rn(gx, w0[0]), __fmul_rn(fx, w0[1]));
    const float bot = __fadd_rn(__fmul_rn(gx, w1[0]), __fmul_rn(fx, w1[1]));
    dst[i] = __fadd_rn(__fmul_rn(gy, top), __fmul_rn(fy, bot));
  }
}

}  // namespace

extern "C" int sfm_extract_patches(const void* canvas, int B, int Hc,
                                   int Wc, const void* cx, const void* cy,
                                   int N, void* out, void* stream) {
  if (B > 0 && N > 0) {
    patch_kernel<<<B * N, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(canvas), Hc, Wc, N,
        static_cast<const float*>(cx), static_cast<const float*>(cy),
        static_cast<float*>(out));
  }
  return (int)cudaGetLastError();
}
