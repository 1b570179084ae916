// Streaming weight average for NVIDIA Hopper (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernel
//   repro/kernels/swa_avg/kernel.py::_avg_kernel
// and computes what it computes, element by element of a 1-D buffer of any
// length:  out = avg + (w - avg) / (n + 1)  in f32, rounded to avg's dtype.
// avg and out are f32 or bf16, w is f32 or bf16, out may alias avg.
//
// Bitwise contract: the result equals the plain version
// (swa_avg/ref.py::running_average_ref) bit for bit. So the divide is the
// correctly rounded __fdiv_rn (never a multiply by a reciprocal), the sum
// and difference are __fadd_rn / __fsub_rn (which the compiler cannot fuse
// into an FMA), n + 1 is one f32 add, and the cast is
// __float2bfloat16_rn. The library is built without --use_fast_math.
//
// What bounds it on an H100: it reads avg and w once and writes out once,
// 12 bytes an element in f32 (1,889,009,664 elements for the full-width
// internlm2-1.8b tree: 22.7 GB, 6.8 ms at 3.35 TB/s), and does 3 flops an
// element, so it is memory-bound. Design: a grid-stride loop of 256-thread
// blocks, each thread handling four elements a stride apart per pass, so
// every warp's loads and stores are coalesced and four are in flight per
// thread. The ragged tail is masked in place: no padding copies.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename A, typename W>
__global__ void __launch_bounds__(kThreads)
avg_kernel(const A* avg, const W* __restrict__ w, A* out, int64_t size,
           float n) {
  const float denom = __fadd_rn(n, 1.f);
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t base = (int64_t)blockIdx.x * kThreads + threadIdx.x;
       base < size; base += stride * kUnroll) {
    float a[kUnroll], x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + u * stride;
      if (i < size) {
        a[u] = to_f32(avg[i]);
        x[u] = to_f32(w[i]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + u * stride;
      if (i < size)
        from_f32(out + i, __fadd_rn(a[u], __fdiv_rn(__fsub_rn(x[u], a[u]),
                                                     denom)));
    }
  }
}

template <typename A, typename W>
cudaError_t launch(const void* avg, const void* w, void* out, int64_t size,
                   float n, int max_blocks, cudaStream_t stream) {
  int64_t blocks = (size + (int64_t)kThreads * kUnroll - 1) /
                   ((int64_t)kThreads * kUnroll);
  if (blocks > max_blocks) blocks = max_blocks;
  avg_kernel<A, W><<<(int)blocks, kThreads, 0, stream>>>(
      static_cast<const A*>(avg), static_cast<const W*>(w),
      static_cast<A*>(out), size, n);
  return cudaGetLastError();
}

}  // namespace

// avg_dtype, w_dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t.
extern "C" int swa_avg(const void* avg, const void* w, void* out,
                       int64_t size, float n, int avg_dtype, int w_dtype,
                       int max_blocks, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (size <= 0) return 0;
  if (avg_dtype == 0 && w_dtype == 0)
    return launch<float, float>(avg, w, out, size, n, max_blocks, st);
  if (avg_dtype == 0 && w_dtype == 1)
    return launch<float, __nv_bfloat16>(avg, w, out, size, n, max_blocks, st);
  if (avg_dtype == 1 && w_dtype == 0)
    return launch<__nv_bfloat16, float>(avg, w, out, size, n, max_blocks, st);
  if (avg_dtype == 1 && w_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(avg, w, out, size, n,
                                                 max_blocks, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* swa_avg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
