// The card homography for Hopper (sm_90a): llcv_calc_persp_transform's
// 8x8 Eigen 3.2 f32 HouseholderQR solve, a group of 16 lanes per stream.
//
// Replaces the Pallas TPU kernel cardio_dmz_tpu/ops/pallas/persp_qr.py
// (eigen_persp_transform_batched / _qr_kernel / _qr_solve_lanes). It builds
// each stream's system from the four source corners and the four
// destination corners (cv/warp.cpp:46-67), factors it with
// householder_qr_inplace_unblocked, applies Q^T with the Householder
// vectors in ascending order and back-substitutes column by column, in the
// f32 operation order of the numpy twin cardio_dmz_tpu/ops/persp_host.py:
// dot products sum as Eigen's SSE2 packet redux, (p0+p2)+(p1+p3) then a
// serial tail, and a length below 4 sums serially.
//
// Every multiply, add, divide and square root is rounded on its own:
// __fmul_rn/__fadd_rn/__fsub_rn are never contracted into an FMA (the
// library is also built with --fmad=false), and __fdiv_rn/__fsqrt_rn are
// IEEE. Degenerate corner sets (all zero, from frames where no card was
// found) give the same inf/NaN bits as the plain version, because every
// branch tests the same values in the same way.
//
// What bounds it: the solve's chain of dependent operations, not bytes
// (32 B in and 36 B out a stream). Each Householder step waits for the
// column's squared norm, a square root, a division and the update of the
// next column; the back-substitution is eight divisions in a row
// (chip_smoke.persp_qr_ops counts the chain: 120 operations). Then the
// instructions a warp issues: one warp issues an f32 instruction about
// every second cycle. The design keeps only the chain serial:
// - Lane j < 8 of a stream's group holds column j of [A | b], lane 8 the
//   right-hand side b, so step k's rank-1 update runs on the 7 - k
//   trailing columns and on b at once. Each lane sums its own dot product
//   ess . a[k+1:, j] in Eigen's order: no sum crosses lanes, so no
//   shuffle order has to copy Eigen's.
// - At step k every lane of the group takes column k by shuffles and
//   computes its norm and beta itself, the same ops on the same bits.
//   Then each lane makes one of the step's IEEE quotients (lane k tau,
//   lane k + 1 + i ess[i]) and shuffles share them: the divisions run
//   side by side. Each __fdiv_rn is a branch around its slow path, so
//   one lane's divisions would run one after another.
// - b as a ninth column is Q^T b: step k's update of b is, op for op,
//   H_k applied to b, and H_7 scales it by 1 - tau as Eigen does.
// - Every lane applies the update, without a branch; lane k then keeps
//   beta. The rows that no later step reads (lane k's ess: b takes them
//   as they are made) are left as they fall.
// - R's column k is final after step k and is gathered then, by
//   shuffles; lane 8 back-substitutes in its registers.
// - The corners are loaded before any use, so that their loads overlap.
// - Two streams a warp, four warps a block: 256 streams spread over 32
//   SMs, one warp a scheduler. Lanes 9-15, and groups past the last
//   stream (which read it again), compute and store nothing; every lane
//   takes part in every shuffle.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kN = 8;
constexpr int kGroup = 16;      // lanes a stream
constexpr int kRhs = kN;        // the lane that holds b
constexpr int kThreads = 128;   // four warps, eight streams
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// Eigen Redux.h LinearVectorizedTraversal over n products (1 <= n <= 7).
__device__ __forceinline__ float redux(const float* p, int n) {
  if (n < 4) {
    float r = p[0];
    for (int i = 1; i < n; ++i) r = add(r, p[i]);
    return r;
  }
  float r = add(add(p[0], p[2]), add(p[1], p[3]));
  for (int i = 4; i < n; ++i) r = add(r, p[i]);
  return r;
}

// Column `col` of one row of [A | b] for corner (x, y) and destination
// coordinate d: (x, y, 1) from column `first`, -x d and -y d at 6 and 7,
// d at 8, and 0 elsewhere, lanes past 8 included. Selects, no branch, so
// that every corner's loads are in flight before the first use.
__device__ __forceinline__ float system_entry(int col, int first, float x,
                                              float y, float d) {
  const float px = mul(-x, d), py = mul(-y, d);
  const int c = col - first;
  const float v = c == 0 ? x : c == 1 ? y : c == 2 ? 1.0f : 0.0f;
  return col == 6 ? px : col == 7 ? py : col == kRhs ? d : v;
}

__global__ void __launch_bounds__(kThreads)
persp_qr_kernel(const float* __restrict__ src, const float* __restrict__ dst,
                float* __restrict__ out, int n_streams, int dst_stride) {
  const long long thread = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long sid = thread / kGroup;
  const int col = threadIdx.x % kGroup;
  const long long s = sid < n_streams ? sid : n_streams - 1;

  float corner[16];   // x, y of the four source corners, then the dest's
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    corner[i] = src[s * 8 + i];
    corner[8 + i] = dst[s * dst_stride + i];
  }
  float a[kN];   // column `col` of [A | b]
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float x = corner[2 * i], y = corner[2 * i + 1];
    a[i] = system_entry(col, 0, x, y, corner[8 + 2 * i]);
    a[i + 4] = system_entry(col, 3, x, y, corner[9 + 2 * i]);
  }

  // householder_qr_inplace_unblocked: makeHouseholder on column k, then
  // applyHouseholderOnTheLeft on the columns to its right and on b
  float p[kN];
  float ess[kN];
  float r[kN][kN];   // R(i, j), i <= j: row i of lane j's column
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    const int nt = kN - 1 - k;
    float v[kN];   // column k, rows k.., from lane k
#pragma unroll
    for (int i = k; i < kN; ++i) v[i] = __shfl_sync(kAll, a[i], k, kGroup);
    const float c0 = v[k];
    // makeHouseholder: a step whose tail norm tsq is 0 (and the last)
    // keeps tau 0, beta c0 and ess = tail * 0. One quotient a lane, lane
    // k tau and lane k + 1 + i ess[i], shared by shuffles.
    float beta = c0, tau = 0.0f;
    if (nt > 0) {
#pragma unroll
      for (int i = 0; i < nt; ++i) p[i] = mul(v[k + 1 + i], v[k + 1 + i]);
      const float tsq = redux(p, nt);
      // this lane's ess numerator, picked while the square root runs
      float own = v[kN - 1];
#pragma unroll
      for (int i = 0; i < nt - 1; ++i) {
        if (col == k + 1 + i) own = v[k + 1 + i];
      }
      float beta_n = __fsqrt_rn(add(mul(c0, c0), tsq));
      if (c0 >= 0.0f) beta_n = -beta_n;
      const bool flat = tsq == 0.0f;
      const bool tau_lane = col <= k || col >= kN;
      float q = __fdiv_rn(tau_lane ? sub(beta_n, c0) : own,
                          tau_lane ? beta_n : sub(c0, beta_n));
      if (flat) q = tau_lane ? 0.0f : mul(own, 0.0f);
      if (!flat) beta = beta_n;
      tau = __shfl_sync(kAll, q, k, kGroup);
#pragma unroll
      for (int i = 0; i < nt; ++i)
        ess[i] = __shfl_sync(kAll, q, k + 1 + i, kGroup);

      // applyHouseholderOnTheLeft, in every lane (lanes at or left of k
      // change only rows that no later step reads)
#pragma unroll
      for (int i = 0; i < nt; ++i) p[i] = mul(ess[i], a[k + 1 + i]);
      const float t = add(redux(p, nt), a[k]);
      a[k] = sub(a[k], mul(tau, t));
#pragma unroll
      for (int i = 0; i < nt; ++i)
        a[k + 1 + i] = sub(a[k + 1 + i], mul(mul(tau, ess[i]), t));
    } else {
      // H_7 on b: Eigen scales it by 1 - tau (tau is 0). The multiply
      // stays: it turns an input NaN into the card's canonical NaN, as the
      // plain version's does.
      a[k] = mul(a[k], sub(1.0f, tau));
    }
    if (col == k) a[k] = beta;
#pragma unroll
    for (int i = 0; i <= k; ++i) r[i][k] = __shfl_sync(kAll, a[i], k, kGroup);
  }
  if (col != kRhs || sid >= n_streams) return;

  // col-major triangular_solve_vector on Q^T b: x[j] = c[j] / R(j,j), then
  // c[:j] -= x[j] * R[:j, j]
#pragma unroll
  for (int j = kN - 1; j >= 0; --j) {
    a[j] = __fdiv_rn(a[j], r[j][j]);
#pragma unroll
    for (int i = 0; i < j; ++i) a[i] = sub(a[i], mul(a[j], r[i][j]));
  }
  float* m = out + sid * 9;
#pragma unroll
  for (int i = 0; i < kN; ++i) m[i] = a[i];
  m[8] = 1.0f;
}

}  // namespace

// src (S, 4, 2) f32 source corners; dst the destination corners, (4, 2)
// shared by every stream (dst_stride 0) or (S, 4, 2) (dst_stride 8); out
// (S, 3, 3) f32 row-major homographies with m22 = 1; all contiguous on the
// device, S >= 1. Launches on `stream` and returns the launch's
// cudaGetLastError() (0 on success).
extern "C" int persp_qr_launch(const void* src, const void* dst, void* out,
                               int n_streams, int dst_stride, void* stream) {
  const long long threads = (long long)n_streams * kGroup;
  const int blocks = (int)((threads + kThreads - 1) / kThreads);
  persp_qr_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)src, (const float*)dst, (float*)out, n_streams,
      dst_stride);
  return (int)cudaGetLastError();
}
