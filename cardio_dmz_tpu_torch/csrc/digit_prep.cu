// PAN digit-cell preparation for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel cardio_dmz_tpu/ops/pallas/digit_prep.py
// (prepare_digit_cells_pallas / _digit_prep_kernel). For every stream and
// each of its 16 hseg offsets: crop the 27x19 cell from the stream's 27x428
// PAN strip, take the cross morph gradient with borders clamped at the
// CELL edge, histogram-equalize it with lut[v] = sat(round(cdf[v]*255/513)),
// lut[0] = 0, and write lut[g] / 255 as f32.
//
// One block per (cell, stream): grid (16, S), 64 threads. The cell, its
// gradient, the 256-bin histogram and its prefix sum live in shared memory;
// nothing but the cell's 513 input bytes and 513 output floats touches
// device memory. Each block reads its own offset (a TPU kernel gets it by
// scalar prefetch).
//
// Numerics equal the plain PyTorch version bit for bit: counts are exact
// integers, rintf rounds half to even like torch.round, the scale is the
// f32 value of the double 255/513 as in the JAX and PyTorch versions, and
// the final division stays IEEE (build without --use_fast_math).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCells = 16;
constexpr int kH = 27;
constexpr int kW = 19;
constexpr int kPixels = kH * kW;          // 513
constexpr int kStripW = 428;
constexpr int kMaxOffset = kStripW - kW;  // 409
constexpr int kThreads = 64;
constexpr int kBins = 256;
constexpr int kBinsPerThread = kBins / kThreads;

__global__ void __launch_bounds__(kThreads)
digit_prep_kernel(const uint8_t* __restrict__ strips,
                  const int32_t* __restrict__ offsets,
                  float* __restrict__ out) {
  __shared__ uint8_t cell[kPixels];
  __shared__ uint8_t grad[kPixels];
  __shared__ int hist[kBins];
  __shared__ int warp_total[kThreads / 32];

  const int k = blockIdx.x;
  const int s = blockIdx.y;
  const int tid = threadIdx.x;

  int off = offsets[s * kCells + k];
  off = min(max(off, 0), kMaxOffset);

  const uint8_t* strip = strips + (size_t)s * kH * kStripW + off;
  for (int p = tid; p < kPixels; p += kThreads) {
    const int r = p / kW, c = p - r * kW;
    cell[p] = strip[r * kStripW + c];
  }
  for (int b = tid; b < kBins; b += kThreads) hist[b] = 0;
  __syncthreads();

  // cross morph gradient, max5 - min5, clamped at the cell border
  for (int p = tid; p < kPixels; p += kThreads) {
    const int r = p / kW, c = p - r * kW;
    const int v = cell[p];
    const int n = cell[max(r - 1, 0) * kW + c];
    const int so = cell[min(r + 1, kH - 1) * kW + c];
    const int w = cell[r * kW + max(c - 1, 0)];
    const int e = cell[r * kW + min(c + 1, kW - 1)];
    const int mx = max(max(max(n, so), max(w, e)), v);
    const int mn = min(min(min(n, so), min(w, e)), v);
    grad[p] = (uint8_t)(mx - mn);
    atomicAdd(&hist[mx - mn], 1);
  }
  __syncthreads();

  // inclusive prefix sum of the histogram: each thread owns 4 bins; a warp
  // shuffle scan over the per-thread totals, then the two warps join
  const int base = tid * kBinsPerThread;
  int local[kBinsPerThread];
  int total = 0;
#pragma unroll
  for (int i = 0; i < kBinsPerThread; ++i) {
    total += hist[base + i];
    local[i] = total;
  }
  const int lane = tid & 31, warp = tid >> 5;
  int scan = total;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, scan, d);
    if (lane >= d) scan += y;
  }
  if (lane == 31) warp_total[warp] = scan;
  __syncthreads();
  int before = scan - total;
  for (int i = 0; i < warp; ++i) before += warp_total[i];
#pragma unroll
  for (int i = 0; i < kBinsPerThread; ++i) hist[base + i] = before + local[i];
  __syncthreads();

  // equalize and scale; gradient 0 maps to lut[0] = 0
  const float scale = (float)(255.0 / 513.0);
  float* dst = out + ((size_t)s * kCells + k) * kPixels;
  for (int p = tid; p < kPixels; p += kThreads) {
    const int g = grad[p];
    float v = 0.0f;
    if (g > 0) v = fminf(fmaxf(rintf((float)hist[g] * scale), 0.0f), 255.0f);
    dst[p] = v / 255.0f;
  }
}

}  // namespace

// strips (S, 27, 428) u8, offsets (S, 16) i32, out (S, 16, 27, 19) f32, all
// contiguous on the device; launches on `stream` and returns the launch's
// cudaGetLastError() (0 on success).
extern "C" int digit_prep_launch(const void* strips, const void* offsets,
                                 void* out, int n_streams, void* stream) {
  const dim3 grid(kCells, n_streams);
  digit_prep_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)strips, (const int32_t*)offsets, (float*)out);
  return (int)cudaGetLastError();
}
