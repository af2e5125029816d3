// PAN digit-cell preparation for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel cardio_dmz_tpu/ops/pallas/digit_prep.py
// (prepare_digit_cells_pallas / _digit_prep_kernel). For every stream and
// each of its 16 hseg offsets: crop the 27x19 cell from the stream's 27x428
// PAN strip, take the cross morph gradient with borders clamped at the
// CELL edge, histogram-equalize it with lut[v] = sat(round(cdf[v]*255/513)),
// lut[0] = 0, and write lut[g] / 255 as f32.
//
// One block per stream, one warp per cell: grid (S), 16 warps. The block
// stages its stream's whole strip (11,556 B) into shared memory with 4-byte
// loads, behind the block's only barrier. Then each warp works alone on its
// cell: 17 gradients a lane, kept in registers; a histogram of its own in
// shared memory, filled with shared atomics (equal gradients of a warp
// collide only within it, and the 16 histograms never share a bin); a
// 256-bin inclusive scan in the warp (8 bins a lane, then a shuffle scan
// over the lanes' totals); and the cell's 513 f32 outputs, stored by
// consecutive lanes. (Aggregating equal gradients with __match_any_sync
// first was slower: its cost grows with the number of distinct values.)
//
// What bounds it: bytes, ideally. At 256 streams it must read ~2.1 MB of
// the strips (the columns its cells cover) and write 8.4 MB of f32 cells,
// ~3.1 us at 3.35 TB/s. In practice the shared-memory instructions bind it:
// 5 byte loads and an atomic a pixel, 32 warps an SM.
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
constexpr int kPixels = kH * kW;             // 513
constexpr int kStripW = 428;
constexpr int kStrip = kH * kStripW;         // 11,556 = 4 * 2,889
constexpr int kMaxOffset = kStripW - kW;     // 409
constexpr int kThreads = kCells * 32;
constexpr int kBins = 256;
constexpr int kBinsPerLane = kBins / 32;     // 8
constexpr int kPerLane = (kPixels + 31) / 32;  // 17

__global__ void __launch_bounds__(kThreads)
digit_prep_kernel(const uint8_t* __restrict__ strips,
                  const int32_t* __restrict__ offsets,
                  float* __restrict__ out) {
  __shared__ __align__(16) uint8_t strip[kStrip];
  __shared__ __align__(16) int hist[kCells][kBins];

  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  const uint8_t* src = strips + (size_t)s * kStrip;
  if ((reinterpret_cast<uintptr_t>(src) & 3) == 0) {
    const uint32_t* src4 = reinterpret_cast<const uint32_t*>(src);
    uint32_t* dst4 = reinterpret_cast<uint32_t*>(strip);
    for (int i = tid; i < kStrip / 4; i += kThreads) dst4[i] = __ldg(src4 + i);
  } else {
    for (int i = tid; i < kStrip; i += kThreads) strip[i] = __ldg(src + i);
  }
  int* h = hist[warp];
  for (int b = lane; b < kBins; b += 32) h[b] = 0;
  const int off = min(max(__ldg(offsets + s * kCells + warp), 0), kMaxOffset);
  __syncthreads();

  // cross morph gradient, max5 - min5, clamped at the cell border; pixel
  // p = lane + 32 i of the cell
  const uint8_t* cell = strip + off;
  int grad[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int p = lane + 32 * i;
    grad[i] = 0;
    if (p < kPixels) {
      const int r = p / kW, c = p - r * kW;
      const int v = cell[r * kStripW + c];
      const int n = cell[max(r - 1, 0) * kStripW + c];
      const int so = cell[min(r + 1, kH - 1) * kStripW + c];
      const int w = cell[r * kStripW + max(c - 1, 0)];
      const int e = cell[r * kStripW + min(c + 1, kW - 1)];
      const int mx = max(max(max(n, so), max(w, e)), v);
      const int mn = min(min(min(n, so), min(w, e)), v);
      grad[i] = mx - mn;
      atomicAdd(&h[mx - mn], 1);
    }
  }
  __syncwarp();

  // inclusive prefix sum of the warp's histogram: 8 bins a lane, a shuffle
  // scan over the lanes' totals
  int local[kBinsPerLane];
  int total = 0;
#pragma unroll
  for (int j = 0; j < kBinsPerLane; ++j) {
    total += h[lane * kBinsPerLane + j];
    local[j] = total;
  }
  int scan = total;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, scan, d);
    if (lane >= d) scan += y;
  }
  const int before = scan - total;
#pragma unroll
  for (int j = 0; j < kBinsPerLane; ++j)
    h[lane * kBinsPerLane + j] = before + local[j];
  __syncwarp();

  // equalize and scale; gradient 0 maps to lut[0] = 0
  const float scale = (float)(255.0 / 513.0);
  float* dst = out + ((size_t)s * kCells + warp) * kPixels;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int p = lane + 32 * i;
    if (p < kPixels) {
      const int g = grad[i];
      float v = 0.0f;
      if (g > 0) v = fminf(fmaxf(rintf((float)h[g] * scale), 0.0f), 255.0f);
      dst[p] = v / 255.0f;
    }
  }
}

}  // namespace

// strips (S, 27, 428) u8, offsets (S, 16) i32, out (S, 16, 27, 19) f32, all
// contiguous on the device; launches on `stream` and returns the launch's
// cudaGetLastError() (0 on success).
extern "C" int digit_prep_launch(const void* strips, const void* offsets,
                                 void* out, int n_streams, void* stream) {
  digit_prep_kernel<<<n_streams, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)strips, (const int32_t*)offsets, (float*)out);
  return (int)cudaGetLastError();
}
