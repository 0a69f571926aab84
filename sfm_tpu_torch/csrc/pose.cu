// Pose refinement for Hopper (sm_90a): the pose-only damped Gauss-Newton
// of sfm_tpu_torch/geometry/pnp.py::refine_pose, and the gated rounds of
// sfm_tpu_torch/ransac.py::refined, in one launch of one block per pose.
//
// No kernel of the JAX package corresponds to it: there jit fuses the
// refinement into the tracking step's XLA program.  Eagerly, the plain
// version is a chain of ~366 small torch ops per Gauss-Newton iteration,
// each dispatched by the host for about a microsecond of device work
// (~6,100 a tracked frame: PnP's two gated rounds of 6 iterations and the
// widened-track refinement's 4).  This kernel replaces that chain; the
// host launches once and reads nothing.
//
// Per pose, step for step as the plain version: the cost through
// camera.project (depth guard 1e-9, a division); the masked residuals
// and 2x6 Jacobian blocks of pnp._pose_residual_jac (depth guard 1e-6,
// the inverse depth); H = sum A^T A and g = sum A^T r;
// H + damping diag(H) + 1e-9 I solved by LU with partial pivoting;
// rv_new = log_so3(exp_so3(-dw) exp_so3(rv)) with geometry/rotations.py's
// series and near-pi branches, tv_new = tv - dt; the step kept only where
// the cost falls (a NaN cost never does).  The gated mode (ransac.refined)
// takes each round's weights as (reprojection error < threshold) & valid
// at the round's start pose, as reprojection_errors does, and ends with
// the inlier mask and count at the final pose.
//
// Layout: one block per pose (the flattened leading dimensions), thread t
// taking points t, t + blockDim, ..., so any N works.  One pass over the
// points per iteration: the candidate pose's cost and, at the same
// projection, its H and g, which are the next iteration's if the step is
// kept (else the current ones stay).  The 28 sums are warp shuffle trees
// and one pass over the warps' partials in a fixed order, with no
// atomics, so a launch repeats bit for bit.  Thread 0 solves and updates
// the pose between passes, in shared memory.  The gated weights live in
// the inlier output, each thread reading back only the points it wrote.
//
// What bounds it: latency.  A pass is a block reduction and one thread's
// 6x6 solve and SO(3) maps; a round takes iters + 1 passes.  The bytes
// (20-25 a point, read from L2 after the first pass) and the operations
// (199 a point a pass: R X + t 18, the projection and its residual 10,
// the cost 6, the inverse depth, residual and Jacobian blocks 57, H's 21
// entries and g's 6 108) are nanoseconds at the main path's N = 512.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kSums = 28;  // H's upper triangle (21), g (6), the cost
constexpr float kEps = 1e-8f;
constexpr int kRounds = 2;  // ransac.refined's gated rounds

struct Intrinsics {
  float fx, fy, skew, cx, cy;
};

// rotations.py::exp_so3: Rodrigues with series coefficients near zero
__device__ void exp_so3(const float r[3], float R[9]) {
  const float theta2 = r[0] * r[0] + r[1] * r[1] + r[2] * r[2];
  const float theta = sqrtf(theta2 + kEps);
  const bool small = theta2 < 1e-8f;
  const float a = small ? 1.0f - theta2 / 6.0f : sinf(theta) / theta;
  const float b = small ? 0.5f - theta2 / 24.0f
                        : (1.0f - cosf(theta)) / theta2;
  const float K[9] = {0.0f, -r[2], r[1], r[2], 0.0f, -r[0],
                      -r[1], r[0], 0.0f};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float kk = K[i * 3] * K[j] + K[i * 3 + 1] * K[3 + j] +
                       K[i * 3 + 2] * K[6 + j];
      R[i * 3 + j] = ((i == j ? 1.0f : 0.0f) + a * K[i * 3 + j]) + b * kk;
    }
  }
}

// rotations.py::log_so3: within 0.035 rad of pi the angle from atan2 of
// the skew and trace parts, the axis from the symmetric part's column of
// its largest diagonal entry, signed by the skew part
__device__ void log_so3(const float R[9], float out[3]) {
  const float trace = R[0] + R[4] + R[8];
  const float half = (trace - 1.0f) * 0.5f;
  const float cos_t = fminf(fmaxf(half, -1.0f), 1.0f);
  const float theta = acosf(cos_t);
  const float w[3] = {R[7] - R[5], R[2] - R[6], R[3] - R[1]};
  if (theta > 3.1066f) {
    const float d[3] = {R[0] - cos_t, R[4] - cos_t, R[8] - cos_t};
    int m = 0;
    if (d[1] > d[m]) m = 1;
    if (d[2] > d[m]) m = 2;
    float col[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      col[i] = (R[i * 3 + m] + R[m * 3 + i]) * 0.5f -
               (i == m ? cos_t : 0.0f);
    const float nrm = sqrtf(col[0] * col[0] + col[1] * col[1] +
                            col[2] * col[2]) + kEps;
    float axis[3] = {col[0] / nrm, col[1] / nrm, col[2] / nrm};
    if (axis[0] * w[0] + axis[1] * w[1] + axis[2] * w[2] < 0.0f) {
      axis[0] = -axis[0];
      axis[1] = -axis[1];
      axis[2] = -axis[2];
    }
    const float theta_pi = atan2f(
        0.5f * sqrtf(w[0] * w[0] + w[1] * w[1] + w[2] * w[2]), half);
#pragma unroll
    for (int i = 0; i < 3; ++i) out[i] = axis[i] * theta_pi;
  } else if (theta < 1e-4f) {
#pragma unroll
    for (int i = 0; i < 3; ++i) out[i] = w[i] * 0.5f;
  } else {
    const float f = theta / (2.0f * sinf(theta) + kEps);
#pragma unroll
    for (int i = 0; i < 3; ++i) out[i] = w[i] * f;
  }
}

// x with A[:, :6] x = A[:, 6], by LU with partial pivoting (the first
// largest pivot), as torch.linalg.solve_ex; every index is known at
// compile time, so A stays in registers
__device__ void solve6(float (&A)[6][7], float (&x)[6]) {
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    int p = k;
    float best = fabsf(A[k][k]);
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      if (fabsf(A[i][k]) > best) {
        best = fabsf(A[i][k]);
        p = i;
      }
    }
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      if (i == p) {
#pragma unroll
        for (int j = k; j < 7; ++j) {
          const float s = A[i][j];
          A[i][j] = A[k][j];
          A[k][j] = s;
        }
      }
    }
    const float inv = 1.0f / A[k][k];
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const float l = A[i][k] * inv;
#pragma unroll
      for (int j = k + 1; j < 7; ++j) A[i][j] -= l * A[k][j];
    }
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = A[i][6];
#pragma unroll
    for (int j = i + 1; j < 6; ++j) s -= A[i][j] * x[j];
    x[i] = s / A[i][i];
  }
}

// One pose: rv (3), tv (3), R = exp_so3(rv) (9)
struct Pose {
  float rv[3], tv[3], R[9];
};

// thread 0: the damped step from hg at ``cur``, and the candidate pose
__device__ void gn_step(const float* hg, float damping, const Pose& cur,
                        Pose& cand) {
  float A[6][7];
  int c = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
#pragma unroll
    for (int b = a; b < 6; ++b) {
      A[a][b] = hg[c];
      A[b][a] = hg[c];
      ++c;
    }
  }
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    A[a][a] = (A[a][a] + damping * A[a][a]) + 1e-9f;
    A[a][6] = hg[21 + a];
  }
  float x[6];
  solve6(A, x);
  const float dw[3] = {-x[0], -x[1], -x[2]};
  float E[9], M[9];
  exp_so3(dw, E);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      M[i * 3 + j] = E[i * 3] * cur.R[j] + E[i * 3 + 1] * cur.R[3 + j] +
                     E[i * 3 + 2] * cur.R[6 + j];
  }
  log_so3(M, cand.rv);
#pragma unroll
  for (int i = 0; i < 3; ++i) cand.tv[i] = cur.tv[i] - x[3 + i];
  exp_so3(cand.rv, cand.R);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// the block's sums of s into tot, in a fixed order
__device__ void block_sums(float (&s)[kSums], float (*part)[kSums],
                           float* tot) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < kSums; ++c) {
    const float v = warp_sum(s[c]);
    if (lane == 0) part[warp][c] = v;
  }
  __syncthreads();
  if (threadIdx.x < kSums) {
    float v = 0.0f;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w)
      v += part[w][threadIdx.x];
    tot[threadIdx.x] = v;
  }
  __syncthreads();
}

// where a pass takes its weights
enum Weights { kGiven, kGate, kGated };

// one pass over the points at pose (R, t): the cost of camera.project's
// residuals and H, g of _pose_residual_jac's, with weights ``w_in``
// (kGiven), gated here and kept in ``gate`` (kGate), or read back from
// ``gate`` (kGated)
template <Weights MODE>
__device__ void pass(const float* __restrict__ xyz,
                     const float* __restrict__ uv,
                     const float* __restrict__ w_in,
                     const unsigned char* __restrict__ valid,
                     unsigned char* gate, int N, float threshold,
                     const Intrinsics k, const float* pose,
                     float (&s)[kSums]) {
  float R[9], t[3];
#pragma unroll
  for (int i = 0; i < 9; ++i) R[i] = pose[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = pose[9 + i];
#pragma unroll
  for (int c = 0; c < kSums; ++c) s[c] = 0.0f;
  for (int j = threadIdx.x; j < N; j += blockDim.x) {
    const float X0 = __ldg(xyz + 3 * j), X1 = __ldg(xyz + 3 * j + 1),
                X2 = __ldg(xyz + 3 * j + 2);
    const float U = __ldg(uv + 2 * j), V = __ldg(uv + 2 * j + 1);
    // RX = R X, p = RX + t
    const float x = R[0] * X0 + R[1] * X1 + R[2] * X2;
    const float y = R[3] * X0 + R[4] * X1 + R[5] * X2;
    const float z = R[6] * X0 + R[7] * X1 + R[8] * X2;
    const float p0 = x + t[0], p1 = y + t[1], p2 = z + t[2];
    // camera.project's pixel
    const float z9 = fabsf(p2) < 1e-9f ? (p2 < 0.0f ? -1e-9f : 1e-9f) : p2;
    const float xn = p0 / z9, yn = p1 / z9;
    const float du = ((k.fx * xn + k.skew * yn) + k.cx) - U;
    const float dv = (k.fy * yn + k.cy) - V;
    float w;
    if (MODE == kGiven) {
      w = __ldg(w_in + j);
    } else if (MODE == kGate) {
      const bool in = sqrtf(du * du + dv * dv) < threshold &&
                      __ldg(valid + j) != 0;
      gate[j] = in;
      w = in ? 1.0f : 0.0f;
    } else {
      w = gate[j] ? 1.0f : 0.0f;
    }
    const float rc0 = du * w, rc1 = dv * w;
    s[27] += rc0 * rc0 + rc1 * rc1;
    // _pose_residual_jac's residual and blocks
    const float zs = fabsf(p2) < 1e-6f ? (p2 < 0.0f ? -1e-6f : 1e-6f) : p2;
    const float iz = 1.0f / zs;
    const float r0 = (((k.fx * p0) * iz + (k.skew * p1) * iz) + k.cx - U) * w;
    const float r1 = ((k.fy * p1) * iz + k.cy - V) * w;
    const float d00 = k.fx * iz, d01 = k.skew * iz;
    const float d02 = -(k.fx * p0 + k.skew * p1) * iz * iz;
    const float d11 = k.fy * iz, d12 = -k.fy * p1 * iz * iz;
    // [duv_dp @ -hat(RX), duv_dp] * w
    const float a[6] = {(d01 * -z + d02 * y) * w, (d00 * z + d02 * -x) * w,
                        (d00 * -y + d01 * x) * w, d00 * w, d01 * w, d02 * w};
    const float b[6] = {(d11 * -z + d12 * y) * w, (d12 * -x) * w,
                        (d11 * x) * w, 0.0f, d11 * w, d12 * w};
    int c = 0;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int m = i; m < 6; ++m) {
        s[c] += a[i] * a[m] + b[i] * b[m];
        ++c;
      }
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) s[21 + i] += a[i] * r0 + b[i] * r1;
  }
}

__device__ __forceinline__ void put_pose(float* pose, const Pose& p) {
#pragma unroll
  for (int i = 0; i < 9; ++i) pose[i] = p.R[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) pose[9 + i] = p.tv[i];
}

template <bool GATED>
__global__ void __launch_bounds__(kMaxThreads)
pose_refine_kernel(const float* __restrict__ Kmat,
                   const float* __restrict__ rv_in, long long rv_bs,
                   const float* __restrict__ tv_in, long long tv_bs,
                   const float* __restrict__ xyz, long long xyz_bs,
                   const float* __restrict__ uv, long long uv_bs,
                   const float* __restrict__ w_in, long long w_bs,
                   const unsigned char* __restrict__ valid,
                   long long valid_bs, int N, int iters, float damping,
                   float threshold,
                   float* __restrict__ rv_out, float* __restrict__ tv_out,
                   unsigned char* inl, long long* __restrict__ n_out) {
  __shared__ float part[kMaxWarps][kSums];
  __shared__ float tot[kSums];
  __shared__ float pose[12];  // R, t of the pose the next pass reads
  __shared__ float hg[kSums - 1];
  __shared__ Pose cur, cand;
  __shared__ float cost;
  __shared__ int ipart[kMaxWarps];
  const long long b = blockIdx.x;
  const int t = threadIdx.x;
  xyz += b * xyz_bs;
  uv += b * uv_bs;
  if (GATED) {
    valid += b * valid_bs;
    inl += b * (long long)N;
  } else {
    w_in += b * w_bs;
  }
  const Intrinsics k{__ldg(Kmat), __ldg(Kmat + 4), __ldg(Kmat + 1),
                     __ldg(Kmat + 2), __ldg(Kmat + 5)};
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      cur.rv[i] = rv_in[b * rv_bs + i];
      cur.tv[i] = tv_in[b * tv_bs + i];
    }
    exp_so3(cur.rv, cur.R);
    put_pose(pose, cur);
  }
  __syncthreads();
  float s[kSums];
  for (int round = 0; round < (GATED ? kRounds : 1); ++round) {
    // the start: its cost, H and g (and, gated, the round's weights)
    if (GATED)
      pass<kGate>(xyz, uv, w_in, valid, inl, N, threshold, k, pose, s);
    else
      pass<kGiven>(xyz, uv, w_in, valid, inl, N, threshold, k, pose, s);
    block_sums(s, part, tot);
    if (t == 0) {
      cost = tot[27];
      for (int c = 0; c < kSums - 1; ++c) hg[c] = tot[c];
      if (iters > 0) {
        gn_step(hg, damping, cur, cand);
        put_pose(pose, cand);
      }
    }
    __syncthreads();
    for (int it = 0; it < iters; ++it) {
      // the candidate's cost, and its H and g for the next step
      if (GATED)
        pass<kGated>(xyz, uv, w_in, valid, inl, N, threshold, k, pose, s);
      else
        pass<kGiven>(xyz, uv, w_in, valid, inl, N, threshold, k, pose, s);
      block_sums(s, part, tot);
      if (t == 0) {
        if (tot[27] < cost) {
          cur = cand;
          cost = tot[27];
          for (int c = 0; c < kSums - 1; ++c) hg[c] = tot[c];
        }
        if (it + 1 < iters)
          gn_step(hg, damping, cur, cand);
        put_pose(pose, it + 1 < iters ? cand : cur);
      }
      __syncthreads();
    }
  }
  if (GATED) {
    // the inliers at the final pose, and their count
    float R[9], tt[3];
#pragma unroll
    for (int i = 0; i < 9; ++i) R[i] = pose[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) tt[i] = pose[9 + i];
    int n = 0;
    for (int j = t; j < N; j += blockDim.x) {
      const float X0 = __ldg(xyz + 3 * j), X1 = __ldg(xyz + 3 * j + 1),
                  X2 = __ldg(xyz + 3 * j + 2);
      const float p0 = (R[0] * X0 + R[1] * X1 + R[2] * X2) + tt[0];
      const float p1 = (R[3] * X0 + R[4] * X1 + R[5] * X2) + tt[1];
      const float p2 = (R[6] * X0 + R[7] * X1 + R[8] * X2) + tt[2];
      const float z9 = fabsf(p2) < 1e-9f ? (p2 < 0.0f ? -1e-9f : 1e-9f) : p2;
      const float xn = p0 / z9, yn = p1 / z9;
      const float du = ((k.fx * xn + k.skew * yn) + k.cx) - __ldg(uv + 2 * j);
      const float dv = (k.fy * yn + k.cy) - __ldg(uv + 2 * j + 1);
      const bool in = sqrtf(du * du + dv * dv) < threshold &&
                      __ldg(valid + j) != 0;
      inl[j] = in;
      n += in;
    }
    n = __reduce_add_sync(0xffffffffu, n);
    if ((t & 31) == 0) ipart[t >> 5] = n;
    __syncthreads();
    if (t == 0) {
      long long total = 0;
      for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += ipart[w];
      n_out[b] = total;
    }
  }
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      rv_out[b * 3 + i] = cur.rv[i];
      tv_out[b * 3 + i] = cur.tv[i];
    }
  }
}

}  // namespace

// K [3, 3]; per pose b of P (a batch stride of 0 shares one array among
// the poses): rv, tv [3], xyz [N, 3], uv [N, 2], and either the weights
// w [N] float32 (valid null: refine_pose, one round) or the mask valid
// [N] bool (w null: refined, kRounds gated rounds, then the inliers
// [P, N] bool and their count n [P] int64).  -> rv_out, tv_out [P, 3].
extern "C" int sfm_pose_refine(const void* K, const void* rv,
                               long long rv_bs, const void* tv,
                               long long tv_bs, const void* xyz,
                               long long xyz_bs, const void* uv,
                               long long uv_bs, const void* w,
                               long long w_bs, const void* valid,
                               long long valid_bs, int P, int N, int iters,
                               float damping, float threshold,
                               void* rv_out, void* tv_out, void* inl,
                               void* n, void* stream) {
  if (P <= 0 || N < 0 || iters < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // about two points a thread at N = 512, at most 512 threads
  int threads = ((N + 1) / 2 + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > kMaxThreads ? kMaxThreads
                                                       : threads);
  const float* Kf = static_cast<const float*>(K);
  if (valid != nullptr) {
    pose_refine_kernel<true><<<P, threads, 0, s>>>(
        Kf, static_cast<const float*>(rv), rv_bs,
        static_cast<const float*>(tv), tv_bs,
        static_cast<const float*>(xyz), xyz_bs,
        static_cast<const float*>(uv), uv_bs, nullptr, 0,
        static_cast<const unsigned char*>(valid), valid_bs, N, iters,
        damping, threshold, static_cast<float*>(rv_out),
        static_cast<float*>(tv_out), static_cast<unsigned char*>(inl),
        static_cast<long long*>(n));
  } else {
    pose_refine_kernel<false><<<P, threads, 0, s>>>(
        Kf, static_cast<const float*>(rv), rv_bs,
        static_cast<const float*>(tv), tv_bs,
        static_cast<const float*>(xyz), xyz_bs,
        static_cast<const float*>(uv), uv_bs,
        static_cast<const float*>(w), w_bs, nullptr, 0, N, iters, damping,
        threshold, static_cast<float*>(rv_out),
        static_cast<float*>(tv_out), nullptr, nullptr);
  }
  return (int)cudaGetLastError();
}
