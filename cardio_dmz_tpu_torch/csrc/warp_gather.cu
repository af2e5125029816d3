// The exact card warp for Hopper (sm_90a): cvWarpPerspective INTER_LINEAR +
// FILL_OUTLIERS from the frame and the f32 homography, with the quantized
// coordinate maps computed in the kernel.
//
// Replaces the Pallas TPU kernel cardio_dmz_tpu/ops/pallas/warp_gather.py
// (warp_gather_exact / _warp_gather_kernel with _chunk_qsets) together with
// the coordinate maps that feed it (ops/persp.py warp_coord_maps). For each
// stream, M = inv(double(m)) by cofactors, in _inverse3x3's operation order.
// For each output pixel (x, y), in float64:
//   den = (M20 x + M21 y) + M22, num_x and num_y likewise from rows 0, 1;
//   W = 32 / den, or 0 where den == 0;
//   X = rint(clip(num_x W, +-(2^31 - 256))), or INT32_MIN where num_x W is
//   NaN (a NaN homography: every tap outside, a zero card), Y likewise;
// then x0 = X >> 5, ax = X & 31, y0 = Y >> 5, ay = Y & 31; the taps (x0, y0),
// (x0+1, y0), (x0, y0+1), (x0+1, y0+1) weigh (32-ax)(32-ay)*32,
// ax(32-ay)*32, (32-ax)ay*32 and ax*ay*32 (OpenCV's BilinearTab for
// INTER_BITS = 5), a tap outside the frame reads 0, and the result is
// (acc + 2^14) >> 15, which lies in [0, 255] because the weights sum to 2^15.
//
// Bit for bit the plain route (warp_coord_maps, then the gather): every f64
// multiply, add and divide is rounded on its own (__dmul_rn, __dadd_rn,
// __ddiv_rn; the library is also built with --fmad=false, so nothing is
// contracted into an FMA), and each pixel's linear forms are computed from
// its own x and y, as the plain route's broadcasts do; only the products
// M_r1 * y, the same for a whole row, are shared by a thread's pixels.
//
// transpose = 1 (portrait) resamples the transposed frame with the roles of
// X and Y swapped, as the JAX package does, by reading the untransposed
// frame with swapped strides: no transposed copy is made.
//
// Design: one block per stream (grid (1, S)), whose warp 0 first inverts the
// stream's homography into shared memory, one cofactor a lane; the block's
// threads then walk the card 4 consecutive pixels of a row at a time, each
// group stored as one 32-bit word when the row width is a multiple of 4;
// neighbouring threads take neighbouring groups of a row, or of a column in
// the transposed (portrait) warp. The 4 taps of a pixel share one address
// and are read through the read-only path; a stream's card region (~116 KB
// of its 307 KB frame) stays in its SM's L1 and in L2. No map touches
// device memory. A block a stream fills the card's 132 SMs two blocks deep
// at the serving shape, 256 streams.
//
// What bounds it: instruction issue. The bytes (the tapped frame region and
// the card, ~60 MB at 256 streams) take ~0.018 ms at 3.35 TB/s, the ~25 f64
// instructions a pixel (the correctly rounded division about 10 of them)
// ~0.05 ms at 64 a cycle per SM; the integer work of the quantization and
// the taps outnumbers them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
// the saturating f64 -> int32 conversion is monotonic, so clamping its
// result to +-kMapLimit equals clipping the f64 value to +-(2^31 - 256)
constexpr int kMapLimit = 2147483647 - 255;

__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ double sub(double a, double b) {
  return __dsub_rn(a, b);
}

// The quantized map value of one linear form: f = num * W, clipped to
// +-(2^31 - 256), rounded half to even; NaN -> INT32_MIN, as cvRound gives it
// on x86 (every tap then lies outside the frame).
__device__ __forceinline__ int quantize(double num, double w) {
  const double f = mul(num, w);
  if (f != f) return INT32_MIN;
  return min(max(__double2int_rn(f), -kMapLimit), kMapLimit);
}

template <bool kTranspose>
__global__ void __launch_bounds__(kThreads)
warp_exact_kernel(const uint8_t* __restrict__ image,
                  const float* __restrict__ homography,
                  uint8_t* __restrict__ out, int in_h, int in_w, int out_h,
                  int out_w) {
  __shared__ double minv_s[9];
  const size_t s = blockIdx.y;
  const int tid = threadIdx.x;

  if (tid < 32) {
    // _inverse3x3: lane i < 9 computes the cofactor of inverse entry i,
    // e[r1][c1] e[r2][c2] - e[r1][c2] e[r2][c1], with (r1, r2, c1, c2) 2 bits
    // each in byte i of kCof (entry 8 in kCof8); det = (e00 c00 + e01 c01) +
    // e02 c02 with c00, c01, c02 the entries 0, 3, 6; entry = cof * (1 / det)
    constexpr unsigned long long kCof = 0x1849248829946899ull;
    constexpr unsigned kCof8 = 0x44;
    const float* m = homography + s * 9;
    const int i = tid < 9 ? tid : 0;
    const unsigned code = i < 8 ? (unsigned)(kCof >> (8 * i)) & 0xffu : kCof8;
    const int r1 = code & 3, r2 = (code >> 2) & 3;
    const int c1 = (code >> 4) & 3, c2 = (code >> 6) & 3;
    const double cof = sub(
        mul((double)m[r1 * 3 + c1], (double)m[r2 * 3 + c2]),
        mul((double)m[r1 * 3 + c2], (double)m[r2 * 3 + c1]));
    const double c00 = __shfl_sync(0xffffffffu, cof, 0);
    const double c01 = __shfl_sync(0xffffffffu, cof, 3);
    const double c02 = __shfl_sync(0xffffffffu, cof, 6);
    const double det = add(add(mul((double)m[0], c00), mul((double)m[1], c01)),
                           mul((double)m[2], c02));
    const double d = __ddiv_rn(1.0, det);
    if (tid < 9) minv_s[tid] = mul(cof, d);
  }
  __syncthreads();
  double minv[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) minv[i] = minv_s[i];

  // the frame being resampled: the image, or its transpose read with
  // swapped strides; th x tw is its shape, (sy, sx) its strides
  const int th = kTranspose ? in_w : in_h, tw = kTranspose ? in_h : in_w;
  const unsigned sy = kTranspose ? 1 : in_w, sx = kTranspose ? in_w : 1;
  const uint8_t* img = image + s * (size_t)in_h * in_w;
  uint8_t* card = out + s * (size_t)out_h * out_w;

  // group q = tid + k * kThreads is 4 pixels (4 qx .. 4 qx + 3, y), walked
  // row by row, or column by column for the transposed (portrait) warp: a
  // portrait card's rows run down the frame, so neighbouring threads then
  // read neighbouring frame columns. No division a step.
  const int quads_per_row = (out_w + 3) >> 2;
  const int n_quads = out_h * quads_per_row;
  const int n_inner = kTranspose ? out_h : quads_per_row;
  const int step_outer = kThreads / n_inner;
  const int step_inner = kThreads - step_outer * n_inner;
  int outer = tid / n_inner, inner = tid - outer * n_inner;
  for (int q = tid; q < n_quads; q += kThreads) {
    const int y = kTranspose ? inner : outer;
    const int x_first = (kTranspose ? outer : inner) * 4;
    const double fy = (double)y;
    const double by0 = mul(minv[1], fy), by1 = mul(minv[4], fy);
    const double by2 = mul(minv[7], fy);
    const double fx0 = (double)x_first;
    uint8_t* dst = card + (size_t)y * out_w;
    uint32_t packed = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int x = x_first + k;
      if (x < out_w) {
        const double fx = add(fx0, (double)k);     // exact: small integers
        const double den = add(add(mul(minv[6], fx), by2), minv[8]);
        const double num_x = add(add(mul(minv[0], fx), by0), minv[2]);
        const double num_y = add(add(mul(minv[3], fx), by1), minv[5]);
        const double q32 = __ddiv_rn(32.0, den);
        const double w = den != 0.0 ? q32 : 0.0;
        const int X = quantize(num_x, w), Y = quantize(num_y, w);
        const int tx = kTranspose ? Y : X, ty = kTranspose ? X : Y;
        const int x0 = tx >> 5, ax = tx & 31;
        const int y0 = ty >> 5, ay = ty & 31;
        // unsigned compares: a negative coordinate is outside too
        const bool vx0 = (unsigned)x0 < (unsigned)tw;
        const bool vx1 = (unsigned)(x0 + 1) < (unsigned)tw;
        const bool vy0 = (unsigned)y0 < (unsigned)th;
        const bool vy1 = (unsigned)(y0 + 1) < (unsigned)th;
        // one 32-bit offset for the four taps (it wraps only for taps
        // outside, which are not read)
        const uint8_t* p = img + ((unsigned)y0 * sy + (unsigned)x0 * sx);
        const int i00 = (vy0 && vx0) ? __ldg(p) : 0;
        const int i01 = (vy0 && vx1) ? __ldg(p + sx) : 0;
        const int i10 = (vy1 && vx0) ? __ldg(p + sy) : 0;
        const int i11 = (vy1 && vx1) ? __ldg(p + sy + sx) : 0;
        const int acc = ((i00 * (32 - ax) + i01 * ax) * (32 - ay)
                         + (i10 * (32 - ax) + i11 * ax) * ay) * 32;
        const int v = (acc + (1 << 14)) >> 15;
        packed |= (uint32_t)v << (8 * k);
        if ((out_w & 3) != 0) dst[x] = (uint8_t)v;
      }
    }
    if ((out_w & 3) == 0)
      *reinterpret_cast<uint32_t*>(dst + x_first) = packed;
    inner += step_inner;
    outer += step_outer;
    if (inner >= n_inner) {
      inner -= n_inner;
      ++outer;
    }
  }
}

}  // namespace

// image (S, in_h, in_w) u8, homography (S, 3, 3) f32 src -> dst, out (S,
// out_h, out_w) u8, all contiguous on the device, 0 < S <= 65535 and
// in_h * in_w < 2^31; transpose != 0 resamples the transposed frame with X
// and Y swapped. Launches on `stream` and returns the launch's
// cudaGetLastError() (0 on success).
extern "C" int warp_exact_launch(const void* image, const void* homography,
                                 void* out, int n_streams, int in_h,
                                 int in_w, int out_h, int out_w,
                                 int transpose, void* stream) {
  const dim3 grid(1, n_streams);
  const cudaStream_t st = (cudaStream_t)stream;
  if (transpose)
    warp_exact_kernel<true><<<grid, kThreads, 0, st>>>(
        (const uint8_t*)image, (const float*)homography, (uint8_t*)out,
        in_h, in_w, out_h, out_w);
  else
    warp_exact_kernel<false><<<grid, kThreads, 0, st>>>(
        (const uint8_t*)image, (const float*)homography, (uint8_t*)out,
        in_h, in_w, out_h, out_w);
  return (int)cudaGetLastError();
}
