// The card homography for Hopper (sm_90a): llcv_calc_persp_transform's
// 8x8 Eigen 3.2 f32 HouseholderQR solve, one stream per thread.
//
// Replaces the Pallas TPU kernel cardio_dmz_tpu/ops/pallas/persp_qr.py
// (eigen_persp_transform_batched / _qr_kernel / _qr_solve_lanes). Each
// thread builds its stream's system from the four source corners and the
// four destination corners (cv/warp.cpp:46-67), factors it with
// householder_qr_inplace_unblocked, applies Q^T with the Householder
// vectors in ascending order and back-substitutes column by column, in the
// f32 operation order of the numpy twin cardio_dmz_tpu/ops/persp_host.py:
// dot products sum as Eigen's SSE2 packet redux, (p0+p2)+(p1+p3) then a
// serial tail, and a length below 4 sums serially.
//
// Every multiply, add, divide and square root is rounded on its own:
// __fmul_rn/__fadd_rn/__fsub_rn are never contracted into an FMA (the
// library is also built with --fmad=false), and __fdiv_rn/__fsqrt_rn are
// IEEE. The TPU kernel needed a Markstein correction to get correctly
// rounded division and square root; CUDA has them natively. Degenerate
// corner sets (all zero, from frames where no card was found) give the
// same inf/NaN bits as the plain version, because every branch tests the
// same values in the same way.
//
// What bounds it: serial latency. About a thousand dependent f32 ops per
// thread, 256 streams in two blocks; the card is otherwise idle for the
// few microseconds it takes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kN = 8;
constexpr int kThreads = 128;

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

__global__ void __launch_bounds__(kThreads)
persp_qr_kernel(const float* __restrict__ src, const float* __restrict__ dst,
                float* __restrict__ out, int n_streams) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n_streams) return;

  float a[kN][kN];
  float c[kN];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float sx = src[s * 8 + 2 * i], sy = src[s * 8 + 2 * i + 1];
    const float dx = dst[2 * i], dy = dst[2 * i + 1];
    const float top[kN] = {sx, sy, 1.0f, 0.0f, 0.0f, 0.0f,
                           mul(-sx, dx), mul(-sy, dx)};
    const float bot[kN] = {0.0f, 0.0f, 0.0f, sx, sy, 1.0f,
                           mul(-sx, dy), mul(-sy, dy)};
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      a[i][j] = top[j];
      a[i + 4][j] = bot[j];
    }
    c[i] = dx;
    c[i + 4] = dy;
  }

  // householder_qr_inplace_unblocked: makeHouseholder on column k, then
  // applyHouseholderOnTheLeft on the columns to its right
  float tau[kN];
  float p[kN];
  float ess[kN];
  float tmp[kN];
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    const int nt = kN - 1 - k;
    const float c0 = a[k][k];
    float tsq = 0.0f;
    if (nt > 0) {
#pragma unroll
      for (int i = 0; i < nt; ++i) p[i] = mul(a[k + 1 + i][k], a[k + 1 + i][k]);
      tsq = redux(p, nt);
    }
    float beta, t;
    if (tsq == 0.0f) {
      t = 0.0f;
      beta = c0;
#pragma unroll
      for (int i = 0; i < nt; ++i) ess[i] = mul(a[k + 1 + i][k], 0.0f);
    } else {
      beta = __fsqrt_rn(add(mul(c0, c0), tsq));
      if (c0 >= 0.0f) beta = -beta;
      const float d = sub(c0, beta);
#pragma unroll
      for (int i = 0; i < nt; ++i) ess[i] = __fdiv_rn(a[k + 1 + i][k], d);
      t = __fdiv_rn(sub(beta, c0), beta);
    }
    tau[k] = t;
    a[k][k] = beta;
#pragma unroll
    for (int i = 0; i < nt; ++i) a[k + 1 + i][k] = ess[i];
    if (nt > 0) {
#pragma unroll
      for (int jj = 0; jj < nt; ++jj) {
        const int j = k + 1 + jj;
#pragma unroll
        for (int i = 0; i < nt; ++i) p[i] = mul(ess[i], a[k + 1 + i][j]);
        tmp[jj] = add(redux(p, nt), a[k][j]);
      }
#pragma unroll
      for (int jj = 0; jj < nt; ++jj)
        a[k][k + 1 + jj] = sub(a[k][k + 1 + jj], mul(t, tmp[jj]));
#pragma unroll
      for (int i = 0; i < nt; ++i) {
        const float scaled = mul(t, ess[i]);
#pragma unroll
        for (int jj = 0; jj < nt; ++jj)
          a[k + 1 + i][k + 1 + jj] =
              sub(a[k + 1 + i][k + 1 + jj], mul(scaled, tmp[jj]));
      }
    }
  }

  // c = Q^T b, Householder vectors applied in ascending order
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    const int nt = kN - 1 - k;
    if (nt == 0) {
      c[k] = mul(c[k], sub(1.0f, tau[k]));
    } else {
#pragma unroll
      for (int i = 0; i < nt; ++i) p[i] = mul(a[k + 1 + i][k], c[k + 1 + i]);
      const float t = add(redux(p, nt), c[k]);
      c[k] = sub(c[k], mul(tau[k], t));
#pragma unroll
      for (int i = 0; i < nt; ++i)
        c[k + 1 + i] = sub(c[k + 1 + i], mul(mul(tau[k], a[k + 1 + i][k]), t));
    }
  }

  // col-major triangular_solve_vector: x[j] = c[j] / R(j,j), then
  // c[:j] -= x[j] * R[:j, j]
#pragma unroll
  for (int j = kN - 1; j >= 0; --j) {
    c[j] = __fdiv_rn(c[j], a[j][j]);
#pragma unroll
    for (int i = 0; i < j; ++i) c[i] = sub(c[i], mul(c[j], a[i][j]));
  }

  float* m = out + s * 9;
#pragma unroll
  for (int i = 0; i < kN; ++i) m[i] = c[i];
  m[8] = 1.0f;
}

}  // namespace

// src (S, 4, 2) f32 source corners, dst (4, 2) f32 destination corners
// shared by every stream, out (S, 3, 3) f32 row-major homographies with
// m22 = 1, all contiguous on the device; launches on `stream` and returns
// the launch's cudaGetLastError() (0 on success).
extern "C" int persp_qr_launch(const void* src, const void* dst, void* out,
                               int n_streams, void* stream) {
  const int blocks = (n_streams + kThreads - 1) / kThreads;
  persp_qr_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)src, (const float*)dst, (float*)out, n_streams);
  return (int)cudaGetLastError();
}
