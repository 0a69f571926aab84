// K1: fused Hamming matcher for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel sfm_tpu/features/match_pallas.py
// (_matcher_kernel, launched by hamming_match_tiles).  For every 512-bit
// source descriptor: the Hamming distance to every target, the motion
// window / validity mask, the best index (lowest target on ties), the best
// distance, the second-best distance (the argmin column excluded, so two
// equal best distances give second == best), the per-target winner key
// (dist << 32) | row for keep-best-per-target dedup, and the MatchResult.
//
// What bounds it: on the main path, latency, not the ALU.  A windowed call
// (tracking, widen_tracks, re-observation) admits ~1% of its pairs, and a
// relocalization call has 80% invalid sources: the work left is a few
// hundred thousand window tests and popcounts, a few memory round trips.
// So the design skips what cannot match, spreads each source over lanes,
// and keeps a call to three short launches:
//
//   1. init_keys: the key table [B, Nt] set to all ones.
//   2. The match pass, one of two routes chosen by the wrapper:
//      - cells (re-observation: a narrow window over many pairs): each
//        block bins its batch element's targets into a 32 x 32 torus of
//        square cells (cell side = the window radius plus a margin, a
//        counting sort in shared memory), and each source visits only the
//        <= 3 x 3 cells its window touches.  The window test and the
//        distance are exact; the cells only choose which targets are
//        tested, and every pair that passes the f32 test lies in a visited
//        cell (the margin covers the f32 rounding of d2; the rule is
//        mirrored in match_pallas.window_cells and held there by a test).
//      - dense_int (tracking, widen_tracks, triangulation,
//        relocalization): a warp per source; the block stages the target
//        positions in shared memory, each lane marks which of its targets
//        pass the window, and the feasible pairs are dealt out over the
//        lanes, so that a window that admits few targets still keeps all
//        32 lanes' popcounts busy (XOR + __popc, 16-byte descriptor loads
//        through L1, four in flight a lane).
//      An invalid source writes (idx 0, 1e9, 1e9) without scanning.  Any
//      batch operand may have batch stride 0 (an expanded tensor).
//      (best, idx, second) is merged by (value, index), so the order in
//      which lanes and cells meet targets does not change the result.  A
//      row that passes the distance cap and the ratio test takes its
//      target's minimum key (dist << 32) | row by a 64-bit atomicMin.
//   3. The epilogue, a thread a row: key == keys[idx] decides the match,
//      written as idx / dist / mask; in raw mode a thread a key, turning an
//      untouched key into LLONG_MAX as the plain version has it.
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kWords = 16;           // 512-bit descriptors
constexpr int kThreads = 128;
constexpr float kMasked = 1e9f;      // distance of an infeasible pair
constexpr unsigned kFull = 0xffffffffu;
constexpr int kGrid = 32;            // the cell torus is kGrid x kGrid
constexpr int kBuckets = kGrid * kGrid;
constexpr double kCellClamp = 1099511627776.0;  // 2^40 cells
constexpr double kCentreMargin = 9.094947017729282e-13;  // 2^-40
constexpr int kEpilogueThreads = 256;
constexpr unsigned long long kNoKey = ~0ull;

static_assert(kBuckets == kThreads * 8, "the bucket scan takes 8 a thread");

struct Operands {
  const unsigned* desc_s;
  long long bs_desc_s;
  const float* ctr_s;
  long long bs_ctr_s;
  const unsigned char* valid_s;
  long long bs_valid_s;
  const unsigned* desc_t;
  long long bs_desc_t;
  const float* xy_t;
  long long bs_xy_t;
  const unsigned char* valid_t;
  long long bs_valid_t;
  int Ns, Nt;
  float min_r2, max_r2;
  float max_d, ratio;
  unsigned long long* keys;   // [B, Nt], all ones at launch
};

struct Best {
  float best;
  int idx;
  float second;
};

// every target starts masked at 1e9: (1e9, column 0, 1e9) stands for them
__device__ __forceinline__ Best masked() { return Best{kMasked, 0, kMasked}; }

__device__ __forceinline__ void take(Best& s, float v, int t) {
  if (v < s.best || (v == s.best && t < s.idx)) {
    s.second = s.best;
    s.best = v;
    s.idx = t;
  } else {
    s.second = fminf(s.second, v);
  }
}

// merge with the state held by the lane ``off`` away (all 32 lanes call)
__device__ __forceinline__ void merge_xor(Best& s, int off) {
  const float ob = __shfl_xor_sync(kFull, s.best, off);
  const int oi = __shfl_xor_sync(kFull, s.idx, off);
  const float os = __shfl_xor_sync(kFull, s.second, off);
  if (ob < s.best || (ob == s.best && oi < s.idx)) {
    s.second = fminf(os, s.best);
    s.best = ob;
    s.idx = oi;
  } else {
    s.second = fminf(s.second, ob);
  }
}

__device__ __forceinline__ bool in_window(float cx, float cy, float2 t,
                                          float min_r2, float max_r2) {
  const float dx = __fsub_rn(cx, t.x);
  const float dy = __fsub_rn(cy, t.y);
  const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
  return d2 >= min_r2 && d2 <= max_r2;
}

__device__ __forceinline__ bool passes(float best, float second,
                                       bool valid, float max_d,
                                       float ratio) {
  return valid && best <= max_d && best < __fmul_rn(ratio, second);
}

__device__ __forceinline__ unsigned long long key_of(float best, int row) {
  return ((unsigned long long)(long long)best << 32)
         | (unsigned long long)(unsigned)row;
}

// a source row's (idx, best, second), and its key in its target's slot
// of the key table when it passes the distance cap and the ratio test
__device__ __forceinline__ void write_row(const Operands& op, int b, int row,
                                          const Best& s, bool valid,
                                          int* idx_out, float* best_out,
                                          float* second_out) {
  const size_t at = (size_t)b * op.Ns + row;
  idx_out[at] = s.idx;
  best_out[at] = s.best;
  second_out[at] = s.second;
  if (passes(s.best, s.second, valid, op.max_d, op.ratio)) {
    atomicMin(op.keys + (size_t)b * op.Nt + s.idx, key_of(s.best, row));
  }
}

// the cell of a coordinate: floor(x / side), clamped; monotone in x
__device__ __forceinline__ long long cell_of(double x, double inv_cell) {
  const double c = fmin(fmax(__dmul_rn(x, inv_cell), -kCellClamp),
                        kCellClamp);
  return (long long)floor(c);
}

__device__ __forceinline__ int bucket_of(long long ix, long long iy) {
  return (int)(ix & (kGrid - 1)) + kGrid * (int)(iy & (kGrid - 1));
}

// a source row of the scan routes: its window centre and descriptor
struct Source {
  bool live;
  float2 c;
  uint4 s[4];
};

__device__ __forceinline__ Source load_source(const Operands& op, int b,
                                              int row) {
  // the flag and the centre, not waiting on each other; the descriptor
  // comes with load_desc, once the block has staged its targets
  Source src;
  const int r = min(row, op.Ns - 1);
  src.live = row < op.Ns && __ldg(op.valid_s + b * op.bs_valid_s + r) != 0;
  src.c = __ldg(reinterpret_cast<const float2*>(op.ctr_s + b * op.bs_ctr_s)
                + r);
  return src;
}

__device__ __forceinline__ void load_desc(Source& src, const Operands& op,
                                          int b, int row) {
  if (!src.live) return;
  const uint4* sv = reinterpret_cast<const uint4*>(
      op.desc_s + b * op.bs_desc_s + (size_t)row * kWords);
#pragma unroll
  for (int k = 0; k < 4; ++k) src.s[k] = __ldg(sv + k);
}

// a target's staged position: NaN for an invalid target, which never
// passes the window test
__device__ __forceinline__ float2 staged(float2 p, bool valid) {
  const float nan = __int_as_float(0x7fc00000);
  return valid ? p : make_float2(nan, nan);
}

// up to kN candidates (staged index ti[j], -1 for none; target base +
// ti[j]): the window tests first, then the feasible ones' descriptor loads
// together, then the distances, so that one load latency covers them all
template <int kN>
__device__ __forceinline__ void take_n(Best& st, const Source& src,
                                       const int (&ti)[kN], int base,
                                       const float2* txy, const unsigned* dt,
                                       float min_r2, float max_r2) {
  bool f[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    f[j] = ti[j] >= 0
           && in_window(src.c.x, src.c.y, txy[ti[j]], min_r2, max_r2);
  }
  uint4 w[kN][4];
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    if (f[j]) {
      const uint4* tv = reinterpret_cast<const uint4*>(
          dt + (size_t)(base + ti[j]) * kWords);
#pragma unroll
      for (int k = 0; k < 4; ++k) w[j][k] = __ldg(tv + k);
    }
  }
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    if (f[j]) {
      int d = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        d += __popc(src.s[k].x ^ w[j][k].x) + __popc(src.s[k].y ^ w[j][k].y)
             + __popc(src.s[k].z ^ w[j][k].z) + __popc(src.s[k].w ^ w[j][k].w);
      }
      take(st, (float)d, base + ti[j]);
    }
  }
}

__device__ __forceinline__ void finish_row(Best& st, int lanes, int lane,
                                           const Operands& op, int b,
                                           int row, bool live, int* idx_out,
                                           float* best_out,
                                           float* second_out) {
  for (int off = lanes >> 1; off > 0; off >>= 1) merge_xor(st, off);
  if (lane == 0 && row < op.Ns) {
    write_row(op, b, row, st, live, idx_out, best_out, second_out);
  }
}

// the position of the r-th (from 0) set bit of m
__device__ __forceinline__ int nth_bit(unsigned long long m, int r) {
  for (int i = 0; i < r; ++i) m &= m - 1;
  return __ffsll((long long)m) - 1;
}

// the dense integer route: a warp per source row, four rows a block; the
// block stages kChunk target positions at a time in shared memory.  A row
// first tests its window against every target (lane l takes targets l,
// l + 32, ...; a bit mask a lane).  When at most half pass, it deals the
// feasible pairs out over the 32 lanes, four a lane a step, so that the
// popcounts of a window that admits few targets keep every lane busy;
// else each lane takes its own.  A windowless call (``sparse`` false)
// skips the tests and the masks.  The descriptors come through L1.
constexpr int kChunk = 2048;
constexpr int kDenseWarps = kThreads / 32;
constexpr int kStage = 4;   // targets a thread bins per memory round trip

__global__ void __launch_bounds__(kThreads)
dense_kernel(Operands op, bool sparse, int* __restrict__ idx_out,
             float* __restrict__ best_out, float* __restrict__ second_out) {
  __shared__ float2 txy[kChunk];
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kDenseWarps + (threadIdx.x >> 5);
  const unsigned* dt = op.desc_t + b * op.bs_desc_t;
  const float2* xyt = reinterpret_cast<const float2*>(op.xy_t + b * op.bs_xy_t);
  const unsigned char* vt = op.valid_t + b * op.bs_valid_t;
  Source src = load_source(op, b, row);
  Best st = masked();
  for (int t0 = 0; t0 < op.Nt; t0 += kChunk) {
    const int n = min(kChunk, op.Nt - t0);
    __syncthreads();   // the previous chunk is consumed
    for (int t = threadIdx.x; t < n; t += kThreads) {
      txy[t] = staged(__ldg(xyt + t0 + t), vt[t0 + t] != 0);
    }
    if (t0 == 0) load_desc(src, op, b, row);
    __syncthreads();
    if (!src.live) continue;   // warp-uniform
    if (!sparse) {
      // a window wider than any image: every valid pair is feasible
      for (int k = lane; k < n; k += 4 * 32) {
        int ti[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) ti[q] = k + 32 * q < n ? k + 32 * q : -1;
        take_n<4>(st, src, ti, t0, txy, dt, op.min_r2, op.max_r2);
      }
      continue;
    }
    unsigned long long mask = 0;
    for (int i = 0; lane + 32 * i < n; ++i) {
      if (in_window(src.c.x, src.c.y, txy[lane + 32 * i], op.min_r2,
                    op.max_r2)) {
        mask |= 1ull << i;
      }
    }
    const int cnt = __popcll(mask);
    int first = cnt;                       // inclusive scan over the lanes
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(kFull, first, off);
      if (lane >= off) first += v;
    }
    const int total = __shfl_sync(kFull, first, 31);
    first -= cnt;                          // this lane's first pair
    if (2 * total > n) {
      // most pairs feasible: each lane takes its own
      for (int i0 = 0; lane + 32 * i0 < n; i0 += 4) {
        int ti[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          ti[q] = (mask >> (i0 + q)) & 1 ? lane + 32 * (i0 + q) : -1;
        }
        take_n<4>(st, src, ti, t0, txy, dt, op.min_r2, op.max_r2);
      }
      continue;
    }
    for (int j0 = 0; j0 < total; j0 += 4 * 32) {
      int ti[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = min(j0 + q * 32 + lane, total - 1);
        // the lane that holds pair j: the last whose first pair <= j
        int owner = 0;
#pragma unroll
        for (int step = 16; step > 0; step >>= 1) {
          if (__shfl_sync(kFull, first, owner + step) <= j) owner += step;
        }
        const unsigned long long m = __shfl_sync(kFull, mask, owner);
        const int pos = nth_bit(m, j - __shfl_sync(kFull, first, owner));
        ti[q] = j0 + q * 32 + lane < total ? owner + 32 * pos : -1;
      }
      take_n<4>(st, src, ti, t0, txy, dt, op.min_r2, op.max_r2);
    }
  }
  finish_row(st, 32, lane, op, b, row, src.live, idx_out, best_out,
             second_out);
}

// the position of candidate k in the list made of the <= 9 cells
// (first[j], count[j])
__device__ __forceinline__ int locate(int k, const int (&first)[9],
                                      const int (&count)[9]) {
  int at = -1;
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    if (at < 0) {
      if (k < count[j]) at = first[j] + k;
      else k -= count[j];
    }
  }
  return at;
}

// the cells route: the block bins its batch element's targets (Nt <= the
// wrapper's MAX_SMEM_TARGETS), then each source tests the targets of the
// cells its window touches, ``lanes`` threads per source
__global__ void __launch_bounds__(kThreads)
cells_kernel(Operands op, double reach, double inv_cell, int lanes_log2,
             int* __restrict__ idx_out, float* __restrict__ best_out,
             float* __restrict__ second_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_sum[kThreads / 32];
  const int b = blockIdx.y;
  const int lanes = 1 << lanes_log2;
  const int lane = threadIdx.x & (lanes - 1);
  const int row = blockIdx.x * (kThreads >> lanes_log2)
                  + (threadIdx.x >> lanes_log2);
  const unsigned* dt = op.desc_t + b * op.bs_desc_t;
  const float2* xyt = reinterpret_cast<const float2*>(op.xy_t + b * op.bs_xy_t);
  const unsigned char* vt = op.valid_t + b * op.bs_valid_t;
  const int Nt = op.Nt;
  float2* txy = reinterpret_cast<float2*>(smem);            // [Nt]
  int* start = reinterpret_cast<int*>(txy + Nt);            // [kBuckets+1]
  int* fill = start + kBuckets + 1;                         // [kBuckets]
  int* order = fill + kBuckets;                             // [Nt]
  int* tcell = order + Nt;                                  // [Nt]

  // the source row's flag and centre, loaded before the binning so the
  // two overlap
  Source src = load_source(op, b, row);

  for (int i = threadIdx.x; i < kBuckets; i += kThreads) fill[i] = 0;
  __syncthreads();
  // kStage targets a thread at a time: all their loads first, so that one
  // memory round trip covers them
  for (int t0 = threadIdx.x; t0 < Nt; t0 += kStage * kThreads) {
    float2 p[kStage];
    unsigned char v[kStage];
#pragma unroll
    for (int j = 0; j < kStage; ++j) {
      const int t = min(t0 + j * kThreads, Nt - 1);
      p[j] = __ldg(xyt + t);
      v[j] = __ldg(vt + t);
    }
#pragma unroll
    for (int j = 0; j < kStage; ++j) {
      const int t = t0 + j * kThreads;
      if (t >= Nt) break;
      txy[t] = staged(p[j], v[j] != 0);
      int cell = -1;
      // a non-finite target never passes a finite window
      if (v[j] && isfinite(p[j].x) && isfinite(p[j].y)) {
        cell = bucket_of(cell_of(p[j].x, inv_cell),
                         cell_of(p[j].y, inv_cell));
        atomicAdd(fill + cell, 1);
      }
      tcell[t] = cell;
    }
  }
  load_desc(src, op, b, row);
  __syncthreads();
  // exclusive scan of the bucket counts: 8 a thread, then the warps
  const int base = threadIdx.x * 8;
  int v[8], sum = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    v[k] = fill[base + k];
    sum += v[k];
  }
  int inc = sum;
  const int wl = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int n = __shfl_up_sync(kFull, inc, off);
    if (wl >= off) inc += n;
  }
  if (wl == 31) warp_sum[threadIdx.x >> 5] = inc;
  __syncthreads();
  int ex = inc - sum;
  for (int w = 0; w < (int)(threadIdx.x >> 5); ++w) ex += warp_sum[w];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    start[base + k] = ex;
    fill[base + k] = ex;
    ex += v[k];
  }
  if (threadIdx.x == kThreads - 1) start[kBuckets] = ex;
  __syncthreads();
  for (int t = threadIdx.x; t < Nt; t += kThreads) {
    if (tcell[t] >= 0) order[atomicAdd(fill + tcell[t], 1)] = t;
  }
  __syncthreads();   // bucket k now holds order[start[k] .. fill[k])

  Best st = masked();
  const float2 c = src.c;
  if (src.live && isfinite(c.x) && isfinite(c.y)) {
    const double mx = __dadd_rn(reach, __dmul_rn(fabs((double)c.x),
                                                  kCentreMargin));
    const double my = __dadd_rn(reach, __dmul_rn(fabs((double)c.y),
                                                  kCentreMargin));
    const long long x0 = cell_of(__dsub_rn(c.x, mx), inv_cell);
    const long long x1 = cell_of(__dadd_rn(c.x, mx), inv_cell);
    const long long y0 = cell_of(__dsub_rn(c.y, my), inv_cell);
    const long long y1 = cell_of(__dadd_rn(c.y, my), inv_cell);
    if (x1 - x0 <= 2 && y1 - y0 <= 2) {
      // the <= 3 x 3 cells of the window (distinct buckets on the torus)
      // as one candidate list, dealt out over the lanes
      int first[9], count[9], total = 0;
#pragma unroll
      for (int j = 0; j < 9; ++j) {
        const long long ix = x0 + j % 3, iy = y0 + j / 3;
        first[j] = 0;
        count[j] = 0;
        if (ix <= x1 && iy <= y1) {
          const int bk = bucket_of(ix, iy);
          first[j] = start[bk];
          count[j] = fill[bk] - first[j];
          total += count[j];
        }
      }
      // (one candidate a step: a lane meets few, and batching them was
      // slower on the H100)
      for (int k = lane; k < total; k += lanes) {
        const int ti[1] = {order[locate(k, first, count)]};
        take_n<1>(st, src, ti, 0, txy, dt, op.min_r2, op.max_r2);
      }
    } else {
      // a centre so far out that the margin widens its window past 3
      // cells: every target
      for (int k = lane; k < Nt; k += lanes) {
        const int ti[1] = {k};
        take_n<1>(st, src, ti, 0, txy, dt, op.min_r2, op.max_r2);
      }
    }
  }
  finish_row(st, lanes, lane, op, b, row, src.live, idx_out, best_out,
             second_out);
}

__global__ void init_keys(unsigned long long* keys, size_t n) {
  const size_t i = (size_t)blockIdx.x * kEpilogueThreads + threadIdx.x;
  if (i < n) keys[i] = kNoKey;
}

// The epilogue, one thread per source row (result mode: idx / dist /
// mask, a row matching when it passes the tests and holds its target's
// key) or per key (raw mode: the key table as the plain version returns
// it, LLONG_MAX where no row holds the target).
__global__ void __launch_bounds__(kEpilogueThreads)
epilogue_kernel(Operands op, int B, const int* __restrict__ idx,
                const float* __restrict__ best,
                const float* __restrict__ second, int* __restrict__ res_idx,
                float* __restrict__ res_dist, bool* __restrict__ res_mask) {
  const size_t i = (size_t)blockIdx.x * kEpilogueThreads + threadIdx.x;
  if (res_idx == nullptr) {
    if (i < (size_t)B * op.Nt && op.keys[i] == kNoKey) {
      op.keys[i] = (unsigned long long)LLONG_MAX;
    }
    return;
  }
  if (i >= (size_t)B * op.Ns) return;
  const int b = (int)(i / op.Ns), s = (int)(i - (size_t)b * op.Ns);
  const int t = idx[i];
  const float bs = best[i];
  const bool ok = passes(bs, second[i], op.valid_s[b * op.bs_valid_s + s] != 0,
                         op.max_d, op.ratio)
                  && op.keys[(size_t)b * op.Nt + t] == key_of(bs, s);
  res_idx[i] = ok ? t : -1;
  res_dist[i] = ok ? bs : kMasked;
  res_mask[i] = ok;
}

}  // namespace

// Returns a cudaError_t (0 on success).  Three launches: the key table
// set to all ones, the match pass (the cells route when ``cells`` is
// nonzero, else the dense integer route), whose rows that pass the tests
// take the minimum key of their target, then the epilogue.  ``mode``: the
// cells route's lanes per source row (log2); the dense route's ``sparse``
// (0 when the window is wider than any image); ``reach`` / ``inv_cell``:
// the cells route's window reach and 1 / cell side
// (match_pallas.window_geometry).  res_* null: raw mode (idx / best /
// second / keys as the plain version returns them).
extern "C" int sfm_hamming_match(
    const void* desc_s, long long bs_desc_s, const void* ctr_s,
    long long bs_ctr_s, const void* valid_s, long long bs_valid_s,
    const void* desc_t, long long bs_desc_t, const void* xy_t,
    long long bs_xy_t, const void* valid_t, long long bs_valid_t, int B,
    int Ns, int Nt, float min_r2, float max_r2, float max_d, float ratio,
    int cells, int mode, double reach, double inv_cell, void* idx,
    void* best, void* second, void* keys, void* res_idx, void* res_dist,
    void* res_mask, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Operands op{static_cast<const unsigned*>(desc_s), bs_desc_s,
                    static_cast<const float*>(ctr_s), bs_ctr_s,
                    static_cast<const unsigned char*>(valid_s), bs_valid_s,
                    static_cast<const unsigned*>(desc_t), bs_desc_t,
                    static_cast<const float*>(xy_t), bs_xy_t,
                    static_cast<const unsigned char*>(valid_t), bs_valid_t,
                    Ns, Nt, min_r2, max_r2, max_d, ratio,
                    static_cast<unsigned long long*>(keys)};
  int* io = static_cast<int*>(idx);
  float* bo = static_cast<float*>(best);
  float* so = static_cast<float*>(second);
  const size_t n_keys = (size_t)B * Nt;
  init_keys<<<(unsigned)((n_keys + kEpilogueThreads - 1) / kEpilogueThreads),
              kEpilogueThreads, 0, st>>>(op.keys, n_keys);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (cells) {
    if (mode < 0 || mode > 5) return (int)cudaErrorInvalidValue;
    const int per_block = kThreads >> mode;
    dim3 grid((Ns + per_block - 1) / per_block, B);
    const size_t smem = (size_t)Nt * 16 + (2 * kBuckets + 1) * 4;
    cells_kernel<<<grid, kThreads, smem, st>>>(op, reach, inv_cell, mode, io,
                                               bo, so);
  } else {
    dim3 grid((Ns + kDenseWarps - 1) / kDenseWarps, B);
    dense_kernel<<<grid, kThreads, 0, st>>>(op, mode != 0, io, bo, so);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)B * (res_idx == nullptr ? Nt : Ns);
  epilogue_kernel<<<(unsigned)((n + kEpilogueThreads - 1) / kEpilogueThreads),
                    kEpilogueThreads, 0, st>>>(
      op, B, io, bo, so, static_cast<int*>(res_idx),
      static_cast<float*>(res_dist), static_cast<bool*>(res_mask));
  return (int)cudaGetLastError();
}
