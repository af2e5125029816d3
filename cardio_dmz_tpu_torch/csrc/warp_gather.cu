// The exact card warp's gather for Hopper (sm_90a): cvWarpPerspective
// INTER_LINEAR + FILL_OUTLIERS from precomputed 1/32-px source maps.
//
// Replaces the Pallas TPU kernel cardio_dmz_tpu/ops/pallas/warp_gather.py
// (warp_gather_exact / _warp_gather_kernel with _chunk_qsets). For each
// output pixel, with X, Y its quantized source position in 1/32 px:
// x0 = X >> 5, ax = X & 31, y0 = Y >> 5, ay = Y & 31; the taps (x0, y0),
// (x0+1, y0), (x0, y0+1), (x0+1, y0+1) weigh (32-ax)(32-ay)*32,
// ax(32-ay)*32, (32-ax)ay*32 and ax*ay*32 (OpenCV's BilinearTab for
// INTER_BITS = 5), a tap outside the image reads 0, and the result is
// (acc + 2^14) >> 15 saturated to u8.
//
// One thread per output pixel, grid (pixel blocks, streams). Each thread
// reads its own X and Y and loads its four taps straight from its
// stream's frame. The TPU kernel's machinery (128-row source windows with
// scalar-prefetched starts, per-column band bases, 128-lane q-slices)
// works around Mosaic's gather limits and has no counterpart here: a GPU
// thread can read any byte. For every quad the detector can reach, the
// JAX package's windows cover every tap (tests/test_warp_envelope.py), so
// this direct gather equals its windowed forms; outside that envelope the
// JAX forms read 0 for taps beyond their windows, and this kernel reads
// the frame.
//
// X and Y may hold anything (a frame where no card was found can give a
// NaN homography); a tap is read only when it lies inside the frame.
//
// What bounds it: bytes and launch. Per stream it reads ~4 taps per output
// pixel from a 307 KB frame that sits in L2, 924 KB of maps and writes
// 115 KB. Fusing the coordinate math into this kernel is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
warp_gather_kernel(const uint8_t* __restrict__ image,
                   const int32_t* __restrict__ xq,
                   const int32_t* __restrict__ yq,
                   uint8_t* __restrict__ out,
                   int in_h, int in_w, int n_pixels) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_pixels) return;
  const size_t s = blockIdx.y;
  const size_t q = s * n_pixels + p;
  const uint8_t* img = image + s * (size_t)in_h * in_w;

  const int X = xq[q], Y = yq[q];
  const int x0 = X >> 5, ax = X & 31;
  const int y0 = Y >> 5, ay = Y & 31;
  // x0 + 1 and y0 + 1 cannot overflow: X >> 5 lies within +-2^26 for any
  // int32 X
  const bool vx0 = x0 >= 0 && x0 < in_w, vx1 = x0 + 1 >= 0 && x0 + 1 < in_w;
  const bool vy0 = y0 >= 0 && y0 < in_h, vy1 = y0 + 1 >= 0 && y0 + 1 < in_h;
  const int i00 = (vx0 && vy0) ? img[(size_t)y0 * in_w + x0] : 0;
  const int i01 = (vx1 && vy0) ? img[(size_t)y0 * in_w + x0 + 1] : 0;
  const int i10 = (vx0 && vy1) ? img[(size_t)(y0 + 1) * in_w + x0] : 0;
  const int i11 = (vx1 && vy1) ? img[(size_t)(y0 + 1) * in_w + x0 + 1] : 0;

  const int acc = i00 * ((32 - ax) * (32 - ay) * 32)
                + i01 * (ax * (32 - ay) * 32)
                + i10 * ((32 - ax) * ay * 32)
                + i11 * (ax * ay * 32);
  const int v = (acc + (1 << 14)) >> 15;
  out[q] = (uint8_t)min(max(v, 0), 255);
}

}  // namespace

// image (S, in_h, in_w) u8, xq/yq (S, out_h, out_w) i32, out (S, out_h,
// out_w) u8, all contiguous on the device, with n_pixels = out_h * out_w
// and 0 < S <= 65535; launches on `stream` and returns the launch's
// cudaGetLastError() (0 on success).
extern "C" int warp_gather_launch(const void* image, const void* xq,
                                  const void* yq, void* out, int n_streams,
                                  int in_h, int in_w, int n_pixels,
                                  void* stream) {
  const dim3 grid((n_pixels + kThreads - 1) / kThreads, n_streams);
  warp_gather_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)image, (const int32_t*)xq, (const int32_t*)yq,
      (uint8_t*)out, in_h, in_w, n_pixels);
  return (int)cudaGetLastError();
}
