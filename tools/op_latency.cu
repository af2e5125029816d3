// Cycles of one dependent operation of each kind that the persp-QR
// solve's chain is made of, on the card: IEEE add, multiply, division and
// square root (the __f*_rn intrinsics of csrc/persp_qr.cu), and a warp
// shuffle. One warp runs, for each kind, a chain of kReps operations, each
// waiting for the one before, between two clock64() reads. Last, the
// issue rate of one warp: kReps adds on eight independent chains, cycles
// an add.
//
// chip_smoke.py builds it (nvcc -gencode arch=compute_90a,code=sm_90a
// --fmad=false, as the kernels) and multiplies the solve's chain by these
// latencies (chip_smoke.persp_qr_ops) to get its floor in cycles.

#include <cuda_runtime.h>

namespace {

constexpr int kReps = 512;
constexpr int kKinds = 6;   // add, mul, div, sqrt, shfl, add issue

// keeps the compiler from moving the chain across the clock reads
__device__ __forceinline__ void pin(float& x) { asm volatile("" : "+f"(x)); }

__global__ void op_latency_kernel(const float* __restrict__ in,
                                  float* __restrict__ sink,
                                  long long* __restrict__ cycles) {
  float x = in[0];
  const float y = in[1];   // 1 + 2^-10: the chains stay normal
  const int next = (threadIdx.x + 1) % 32;
  long long t[kKinds + 2];
  t[0] = clock64();
  pin(x);
#pragma unroll 16
  for (int i = 0; i < kReps; ++i) x = __fadd_rn(x, y);
  pin(x);
  t[1] = clock64();
#pragma unroll 16
  for (int i = 0; i < kReps; ++i) x = __fmul_rn(x, y);
  pin(x);
  t[2] = clock64();
#pragma unroll 16
  for (int i = 0; i < kReps; ++i) x = __fdiv_rn(x, y);
  pin(x);
  t[3] = clock64();
#pragma unroll 16
  for (int i = 0; i < kReps; ++i) x = __fsqrt_rn(x);
  pin(x);
  t[4] = clock64();
#pragma unroll 16
  for (int i = 0; i < kReps; ++i) x = __shfl_sync(0xffffffffu, x, next);
  pin(x);
  t[5] = clock64();
  float w[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) w[j] = x + j;
#pragma unroll
  for (int j = 0; j < 8; ++j) pin(w[j]);
  t[6] = clock64();
#pragma unroll
  for (int i = 0; i < kReps / 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) w[j] = __fadd_rn(w[j], y);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) pin(w[j]);
  t[7] = clock64();
#pragma unroll
  for (int j = 0; j < 8; ++j) x = __fadd_rn(x, w[j]);
  sink[threadIdx.x] = x;
  if (threadIdx.x == 0) {
    for (int k = 0; k < 5; ++k) cycles[k] = t[k + 1] - t[k];
    cycles[5] = t[7] - t[6];
  }
}

}  // namespace

// in: 2 f32 on the device (the start value and y); sink: 32 f32; cycles:
// 6 int64, each kind's kReps operations in cycles. Returns the launch's
// cudaGetLastError().
extern "C" int op_latency_launch(const void* in, void* sink, void* cycles,
                                 void* stream) {
  op_latency_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      (const float*)in, (float*)sink, (long long*)cycles);
  return (int)cudaGetLastError();
}
