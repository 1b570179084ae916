// Mamba-2 SSD intra-chunk forward for NVIDIA Hopper (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernel
//   repro/kernels/ssd/kernel.py:29  _ssd_chunk_kernel
// and computes what it computes, for one (batch, head, chunk of L steps):
//   cum_i   = sum_{k<=i} dt_k * a                      (sequential, as jnp.cumsum)
//   y_i     = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//   state   = sum_j x_j (x) (B_j * exp(cum_{L-1} - cum_j) dt_j)     (P x N)
// and writes y_intra (B,S,H,P), states (B,nc,H,P,N) and cum (B,S,H), all f32.
// x, B and C may be f32 or bf16 (an input format only: everything is f32
// inside, as in the TPU body); dt and A are f32.
//
// Layouts. x is read as (B,S,H,P) and B/C as (B,S,G,N) through the strides
// the wrapper passes (the unit stride is the last dim), so the model's views
// of its conv output are read in place, with no transpose or repeat copy:
// head h reads group h / (H / G) of B and C directly.
//
// What bounds it on an H100. For each of the L(L+1)/2 pairs j <= i the
// function needs 2N flops of C.B^T once per (batch, group, chunk), since
// the scores depend on the group only, and 2P per head; the state is 2PNL
// per head. At the serving prefill of mamba2-2.7b (B 8, S 512, H 80, P 64,
// G 1, N 128, L 256, bf16 inputs) that is 10.9 GFLOP against ~172 MB moved,
// so it is bound by the f32 rate of the CUDA cores (0.16 ms at 67 TFLOP/s),
// not by HBM (0.05 ms). This kernel forms the scores in every head's CTA,
// H / G = 80 times over at G 1, and so does 21.5 GFLOP: sharing them across
// the heads of a group is part of its redesign.
//
// Design. One CTA of 256 threads per (chunk, head, batch): 1280 CTAs at the
// serving shape, 20480 at the training shape (B 256, S 64). The TPU body
// holds the whole L x L decay matrix, C.B^T and the (L, N) B and C in VMEM;
// at L = 256 the scores alone are 256 KB, more than a block's 227 KB of
// shared memory. So the chunk is tiled 64 x 64 over rows i and keys j, tiles
// above the diagonal are skipped, and seg = exp(cum_i - cum_j) is recomputed
// per tile from the L floats of cum kept in shared memory; masked entries
// (j > i, or past L) are set to 0, never computed as exp(-inf). Each thread
// owns a 4 x 4 block of the score tile (C.B^T over N), and a 4 x 4 block of
// the (64, P) output rows, kept in registers across the key tiles. B and C
// tiles are stored transposed with a row pitch of 65 floats so that both the
// transposing stores and the reads are free of bank conflicts. The state
// takes a second loop over key tiles, each thread owning a 4 x 8 block of
// the (P, N) state. L may be any length from 1 to 256; ragged tiles are
// zero-filled. f32 FMA on the CUDA cores; built without fast math, so exp
// is the accurate expf.
//
// Routes. This file holds the C entry ssd_fwd of the library, which is
// built from it and ssd_fwd_sm90.cu: bf16 x, B, C with P = 64 and N in
// {64, 128} take the wgmma/TMA kernel there (kernel.sm90_route is the same
// rule); f32 inputs and other widths take the kernel here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kT = 64;          // row and key tile
constexpr int kPad = kT + 1;    // pitch of transposed tiles
constexpr int kMaxL = 256;
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kSmemFloats = 2 * kMaxL + 2 * kMaxN * kPad + kT * kMaxP +
                            kT * kPad;
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_fwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bm,
               const T* __restrict__ Cm, float* __restrict__ y,
               float* __restrict__ states, float* __restrict__ cum_out,
               int S, int H, int P, int G, int N, int L,
               long long xsb, long long xss, long long xsh,
               long long bsb, long long bss, long long bsg,
               long long csb, long long css, long long csg) {
  extern __shared__ float smem[];
  float* cum = smem;                    // [kMaxL]
  float* dts = cum + kMaxL;             // [kMaxL]
  float* cT = dts + kMaxL;              // C tile, [n][i], pitch kPad
  float* bT = cT + kMaxN * kPad;        // B tile, [n][j], pitch kPad
  float* xs = bT + kMaxN * kPad;        // x tile, [j][p], pitch kMaxP
  float* gs = xs + kT * kMaxP;          // G tile, [i][j], pitch kPad

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x;
  const int g = h / (H / G);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long s0 = (long long)c * L;
  const T* xb = x + b * xsb + s0 * xss + h * xsh;
  const T* bb = Bm + b * bsb + s0 * bss + g * bsg;
  const T* cb = Cm + b * csb + s0 * css + g * csg;
  const float a = A[h];

  for (int i = tid; i < L; i += kThreads)
    dts[i] = dt[((long long)b * S + s0 + i) * H + h];
  __syncthreads();
  if (tid == 0) {
    float run = 0.f;
    for (int i = 0; i < L; ++i) {
      run = __fadd_rn(run, __fmul_rn(dts[i], a));
      cum[i] = run;
    }
  }
  __syncthreads();
  for (int i = tid; i < L; i += kThreads)
    cum_out[((long long)b * S + s0 + i) * H + h] = cum[i];

  const int ntiles = (L + kT - 1) / kT;

  // ---- y_intra: row tiles, each against the key tiles at or below it ----
  for (int it = 0; it < ntiles; ++it) {
    const int i0 = it * kT;
    __syncthreads();
    for (int e = tid; e < kT * N; e += kThreads) {
      const int i = e / N, n = e - i * N;
      cT[n * kPad + i] = i0 + i < L ? ld(cb + (i0 + i) * css + n) : 0.f;
    }
    float acc[4][4] = {};
    for (int jt = 0; jt <= it; ++jt) {
      const int j0 = jt * kT;
      const int jn = min(kT, L - j0);
      __syncthreads();
      for (int e = tid; e < kT * N; e += kThreads) {
        const int j = e / N, n = e - j * N;
        bT[n * kPad + j] = j0 + j < L ? ld(bb + (j0 + j) * bss + n) : 0.f;
      }
      for (int e = tid; e < kT * P; e += kThreads) {
        const int j = e / P, p = e - j * P;
        xs[j * kMaxP + p] =
            j0 + j < L ? dts[j0 + j] * ld(xb + (j0 + j) * xss + p) : 0.f;
      }
      __syncthreads();
      float sc[4][4] = {};
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = cT[n * kPad + ty + 16 * r];
#pragma unroll
        for (int q = 0; q < 4; ++q) bv[q] = bT[n * kPad + tx + 16 * q];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) sc[r][q] = fmaf(cv[r], bv[q], sc[r][q]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = i0 + ty + 16 * r, j = j0 + tx + 16 * q;
          const bool on = i < L && j <= i;
          gs[(ty + 16 * r) * kPad + tx + 16 * q] =
              on ? sc[r][q] * expf(cum[i] - cum[j]) : 0.f;
        }
      __syncthreads();
      for (int j = 0; j < jn; ++j) {
        float gv[4], xv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) gv[r] = gs[(ty + 16 * r) * kPad + j];
#pragma unroll
        for (int q = 0; q < 4; ++q) xv[q] = xs[j * kMaxP + tx + 16 * q];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(gv[r], xv[q], acc[r][q]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty + 16 * r;
      if (i >= L) continue;
      float* yr = y + (((long long)b * S + s0 + i) * H + h) * P;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = tx + 16 * q;
        if (p < P) yr[p] = acc[r][q];
      }
    }
  }

  // ---- chunk-local state: sum_j x_j (x) (B_j w_j) ----
  const float cum_last = cum[L - 1];
  float st[4][8] = {};
  for (int jt = 0; jt < ntiles; ++jt) {
    const int j0 = jt * kT;
    const int jn = min(kT, L - j0);
    __syncthreads();
    for (int e = tid; e < kT * N; e += kThreads) {
      const int j = e / N, n = e - j * N;
      float v = 0.f;
      if (j0 + j < L) {
        const float w = expf(cum_last - cum[j0 + j]) * dts[j0 + j];
        v = ld(bb + (j0 + j) * bss + n) * w;
      }
      bT[n * kPad + j] = v;
    }
    for (int e = tid; e < kT * P; e += kThreads) {
      const int j = e / P, p = e - j * P;
      xs[j * kMaxP + p] = j0 + j < L ? ld(xb + (j0 + j) * xss + p) : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < jn; ++j) {
      float xv[4], bv[8];
#pragma unroll
      for (int r = 0; r < 4; ++r) xv[r] = xs[j * kMaxP + ty + 16 * r];
#pragma unroll
      for (int q = 0; q < 8; ++q) bv[q] = bT[(tx + 16 * q) * kPad + j];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 8; ++q) st[r][q] = fmaf(xv[r], bv[q], st[r][q]);
    }
  }
  float* sb = states + (((long long)b * nc + c) * H + h) * P * N;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int p = ty + 16 * r;
    if (p >= P) continue;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int n = tx + 16 * q;
      if (n < N) sb[p * N + n] = st[r][q];
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const void* Bm, const void* Cm, float* y, float* states,
                   float* cum, int batch, int S, int H, int P, int G, int N,
                   int L, const long long* st, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(S / L, H, batch);
  ssd_fwd_kernel<T><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), y, states, cum, S, H, P, G, N, L, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8]);
  return cudaGetLastError();
}

}  // namespace

cudaError_t ssd_fwd_sm90(const void* x, const float* dt, const float* A,
                         const void* Bm, const void* Cm, float* y,
                         float* states, float* cum, int batch, int S, int H,
                         int P, int G, int N, int L, int hb,
                         const long long* st, cudaStream_t stream);

// dtype: 0 = float32, 1 = bfloat16 (x, Bm and Cm). head_block: heads of a
// group a CTA of the bf16 route takes (ignored by the f32 route). fma: 1
// runs the f32 FMA kernel whatever the inputs (the card check times the
// kernel the bf16 route replaces), 0 the route of the rule. strides:
// the nine (batch, step, head-or-group) element strides of x, Bm and Cm, in
// that order. Returns a cudaError_t.
extern "C" int ssd_fwd(const void* x, const float* dt, const float* A,
                       const void* Bm, const void* Cm, float* y,
                       float* states, float* cum, int batch, int S, int H,
                       int P, int G, int N, int L, int dtype, int head_block,
                       int fma, const long long* strides, void* stream) {
  if (L < 1 || L > kMaxL || S % L || P < 1 || P > kMaxP || N < 1 ||
      N > kMaxN || G < 1 || H % G || batch > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || S == 0 || H == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!fma && dtype == 1 && P == 64 && (N == 64 || N == 128))
    return (int)ssd_fwd_sm90(x, dt, A, Bm, Cm, y, states, cum, batch, S, H, P,
                             G, N, L, head_block, strides, st);
  if (dtype == 0)
    return launch<float>(x, dt, A, Bm, Cm, y, states, cum, batch, S, H, P, G,
                         N, L, strides, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, states, cum, batch, S,
                                 H, P, G, N, L, strides, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
