// Mamba-2 SSD intra-chunk backward for NVIDIA Hopper (sm_90a), written by
// hand.
//
// Replaces the Pallas TPU kernel
//   repro/kernels/ssd/kernel.py:61  _ssd_chunk_bwd_kernel
// and computes what it computes, for one (batch, head, chunk of L steps),
// from the cotangents dy of y_intra, dS of the chunk-local state and dcum of
// cum (all f32):
//   G = (C.B^T) o seg,  seg_ij = exp(cum_i - cum_j) for j <= i, else 0
//   dG = dy (dt x)^T,   d_dx = G^T dy,   dC = (dG o seg) B,  dB = (dG o seg)^T C
//   E = dG o G,         dcum += rowsum(E) - colsum(E)
//   state terms: dS_b = B dS^T, dw = rowsum(x o dS_b), w = exp(cum_L - cum) dt,
//     dx = w dS_b + dt d_dx,  dB += w (x dS),  dcum -= dw w,
//     dcum_{L-1} += sum(dw w),  ddt = dw exp(cum_L - cum) + rowsum(d_dx o x)
//   rev = reverse cumsum of dcum;  ddt += a rev;  da = sum(dt rev)
// cum is recomputed here from dt and a, as the TPU body does. It writes dx
// and ddt, dB and dC per head (the wrapper sums them over the heads of each
// group) and da per (batch, head, chunk) (the wrapper sums it over batch and
// chunk), all f32. x, B and C may be f32 or bf16 and are read in place
// through strides, as in ssd_fwd.cu.
//
// What bounds it on an H100. For each of the L(L+1)/2 pairs j <= i the
// function needs 4P flops per head (dG, d_dx) and 6N once per (batch,
// group, chunk): C.B^T depends on the group only, and since dB and dC are
// summed over the group's heads, their products can be taken once on
// dG o seg summed over those heads. The state terms are 4PNL per head. At
// phase 1 of mamba2-2.7b training (B 256, S 64 = L, H 80, P 64, G 1,
// N 128) that is 54.3 GFLOP against ~1.55 GB that the function must move
// (the f32 cotangents and dx dominate), so it is bound by the f32 rate of
// the CUDA cores (0.81 ms at 67 TFLOP/s) before HBM (0.46 ms). This kernel
// takes all three products per head, 86.6 GFLOP: sharing them across the
// heads of a group is part of its redesign.
//
// Design. One launch, one CTA of 256 threads per (chunk, head, batch), and
// no atomics, so the result is the same from run to run. The TPU body holds
// the whole L x L block and sums it over rows and over columns; here blocks
// run in parallel and in no order, so everything that one chunk sums stays
// in the one CTA that owns it. The CTA walks the 64-key tiles j (outer) and,
// for each, the 64-row tiles i >= j (inner):
//   * the score tile (C.B^T over N) and dG tile (dy.x over P, times dt_j)
//     are formed in registers, 4 x 4 a thread, then G, dG o seg and E go to
//     shared memory;
//   * d_dx (4 x 4 a thread) and dB (4 x 8) of the key tile sum over the row
//     tiles in registers;
//   * dC of a row tile sums over the key tiles in the CTA's own rows of the
//     dC output: the first key tile stores, the later ones add (each element
//     always by the same thread, so no race);
//   * rowsum(E) and colsum(E) sum into L-float arrays in shared memory.
// When a key tile's row tiles are done, its state terms (B dS^T and x dS
// from dS held transposed in shared memory) finish dx, dB and the key
// tile's share of ddt and dcum. At the end one thread runs the reverse
// cumsum over L (at most 256 steps) into ddt and da. Tiles above the
// diagonal are skipped; masked entries are set to 0, never exp(-inf); L may
// be any length from 1 to 256. Transposed tiles have a pitch of 65 floats,
// so stores and reads are free of bank conflicts. f32 FMA on the CUDA cores;
// 184 KB of shared memory a CTA.
//
// Routes. This file holds the C entry ssd_bwd of the library, which is
// built from it and ssd_bwd_sm90.cu: bf16 x, B, C with P = 64 and N in
// {64, 128} take the wgmma/TMA kernel there, which writes dB and dC once
// per head block (kernel.sm90_route is the same rule); f32 inputs and other
// widths take the kernel here, which writes them per head.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kT = 64;
constexpr int kPad = kT + 1;
constexpr int kMaxL = 256;
constexpr int kMaxP = 64;
constexpr int kPadP = kMaxP + 1;
constexpr int kMaxN = 128;
constexpr int kSmemFloats = 6 * kMaxL          // cum dt rowE colE ddt dww
                            + 2 * kMaxN * kPad // cT bT
                            + kMaxP * kPad     // xT
                            + kT * kPadP       // dys
                            + 3 * kT * kPad    // gs dgs es
                            + kMaxN * kPadP;   // dsT
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// sum over the 16 lanes of a half warp (threads of one ty)
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int m = 8; m >= 1; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bm,
               const T* __restrict__ Cm, const float* __restrict__ dy,
               const float* __restrict__ dstates,
               const float* __restrict__ dcum, float* __restrict__ dx,
               float* __restrict__ ddt, float* __restrict__ db,
               float* __restrict__ dc, float* __restrict__ da,
               int S, int H, int P, int G, int N, int L,
               long long xsb, long long xss, long long xsh,
               long long bsb, long long bss, long long bsg,
               long long csb, long long css, long long csg) {
  extern __shared__ float smem[];
  float* cum = smem;                    // [kMaxL]
  float* dts = cum + kMaxL;             // [kMaxL]
  float* rowE = dts + kMaxL;            // [kMaxL] sum_j E[i][j]
  float* colE = rowE + kMaxL;           // [kMaxL] sum_i E[i][j]
  float* ddts = colE + kMaxL;           // [kMaxL] ddt before the cumsum term
  float* dww = ddts + kMaxL;            // [kMaxL] dw_j * w_j
  float* cT = dww + kMaxL;              // C row tile, [n][i], pitch kPad
  float* bT = cT + kMaxN * kPad;        // B key tile, [n][j], pitch kPad
  float* xT = bT + kMaxN * kPad;        // x key tile, [p][j], pitch kPad
  float* dys = xT + kMaxP * kPad;       // dy row tile, [i][p], pitch kPadP
  float* gs = dys + kT * kPadP;         // G, [i][j], pitch kPad
  float* dgs = gs + kT * kPad;          // dG o seg
  float* es = dgs + kT * kPad;          // E = dG o G
  float* dsT = es + kT * kPad;          // dS, [n][p], pitch kPadP

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x;
  const int g = h / (H / G);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long s0 = (long long)c * L;
  const long long row0 = (long long)b * S + s0;   // (b, s0) in (B, S)
  const T* xb = x + b * xsb + s0 * xss + h * xsh;
  const T* bb = Bm + b * bsb + s0 * bss + g * bsg;
  const T* cb = Cm + b * csb + s0 * css + g * csg;
  const float a = A[h];

  for (int i = tid; i < L; i += kThreads) {
    dts[i] = dt[(row0 + i) * H + h];
    rowE[i] = 0.f;
    colE[i] = 0.f;
  }
  const float* dsb = dstates + (((long long)b * nc + c) * H + h) * P * N;
  for (int e = tid; e < P * N; e += kThreads) {
    const int p = e / N, n = e - p * N;
    dsT[n * kPadP + p] = dsb[e];
  }
  __syncthreads();
  if (tid == 0) {
    float run = 0.f;
    for (int i = 0; i < L; ++i) {
      run = __fadd_rn(run, __fmul_rn(dts[i], a));
      cum[i] = run;
    }
  }
  __syncthreads();
  const float cum_last = cum[L - 1];
  const int ntiles = (L + kT - 1) / kT;

  for (int jt = 0; jt < ntiles; ++jt) {
    const int j0 = jt * kT;
    const int jn = min(kT, L - j0);
    __syncthreads();
    for (int e = tid; e < kT * N; e += kThreads) {
      const int j = e / N, n = e - j * N;
      bT[n * kPad + j] = j0 + j < L ? ld(bb + (j0 + j) * bss + n) : 0.f;
    }
    for (int e = tid; e < kT * P; e += kThreads) {
      const int j = e / P, p = e - j * P;
      xT[p * kPad + j] = j0 + j < L ? ld(xb + (j0 + j) * xss + p) : 0.f;
    }
    float d_dx[4][4] = {};   // [j = ty + 16 r][p = tx + 16 q]
    float dbr[4][8] = {};    // [j = ty + 16 r][n = tx + 16 q]

    for (int it = jt; it < ntiles; ++it) {
      const int i0 = it * kT;
      const int in = min(kT, L - i0);
      __syncthreads();
      for (int e = tid; e < kT * N; e += kThreads) {
        const int i = e / N, n = e - i * N;
        cT[n * kPad + i] = i0 + i < L ? ld(cb + (i0 + i) * css + n) : 0.f;
      }
      for (int e = tid; e < kT * P; e += kThreads) {
        const int i = e / P, p = e - i * P;
        dys[i * kPadP + p] = i0 + i < L ? dy[((row0 + i0 + i) * H + h) * P + p]
                                        : 0.f;
      }
      __syncthreads();
      // score and dG tiles: [i = ty + 16 r][j = tx + 16 q]
      float sc[4][4] = {}, dg[4][4] = {};
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
      for (int p = 0; p < P; ++p) {
        float yv[4], xv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) yv[r] = dys[(ty + 16 * r) * kPadP + p];
#pragma unroll
        for (int q = 0; q < 4; ++q) xv[q] = xT[p * kPad + tx + 16 * q];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) dg[r][q] = fmaf(yv[r], xv[q], dg[r][q]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int li = ty + 16 * r, lj = tx + 16 * q;
          const int i = i0 + li, j = j0 + lj;
          const bool on = i < L && j <= i;
          const float seg = on ? expf(cum[i] - cum[j]) : 0.f;
          const float gv = sc[r][q] * seg;
          const float dgv = on ? dg[r][q] * dts[j] : 0.f;
          gs[li * kPad + lj] = gv;
          dgs[li * kPad + lj] = dgv * seg;
          es[li * kPad + lj] = dgv * gv;
        }
      __syncthreads();
      if (tid < kT) {
        if (tid < in) {
          float s = 0.f;
          for (int lj = 0; lj < jn; ++lj) s += es[tid * kPad + lj];
          rowE[i0 + tid] += s;
        }
      } else if (tid < 2 * kT) {
        const int lj = tid - kT;
        if (lj < jn) {
          float s = 0.f;
          for (int li = 0; li < in; ++li) s += es[li * kPad + lj];
          colE[j0 + lj] += s;
        }
      }
      // d_dx[j][p] += sum_i G[i][j] dy[i][p];  dB[j][n] += sum_i dGs[i][j] C[i][n]
      for (int li = 0; li < in; ++li) {
        float gv[4], dgv[4], yv[4], cv[8];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          gv[r] = gs[li * kPad + ty + 16 * r];
          dgv[r] = dgs[li * kPad + ty + 16 * r];
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) yv[q] = dys[li * kPadP + tx + 16 * q];
#pragma unroll
        for (int q = 0; q < 8; ++q) cv[q] = cT[(tx + 16 * q) * kPad + li];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            d_dx[r][q] = fmaf(gv[r], yv[q], d_dx[r][q]);
#pragma unroll
          for (int q = 0; q < 8; ++q)
            dbr[r][q] = fmaf(dgv[r], cv[q], dbr[r][q]);
        }
      }
      // dC[i][n] += sum_j dGs[i][j] B[j][n], into the CTA's own rows of dc
      float dcp[4][8] = {};
      for (int lj = 0; lj < jn; ++lj) {
        float dgv[4], bv[8];
#pragma unroll
        for (int r = 0; r < 4; ++r) dgv[r] = dgs[(ty + 16 * r) * kPad + lj];
#pragma unroll
        for (int q = 0; q < 8; ++q) bv[q] = bT[(tx + 16 * q) * kPad + lj];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 8; ++q)
            dcp[r][q] = fmaf(dgv[r], bv[q], dcp[r][q]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty + 16 * r;
        if (i >= L) continue;
        float* dcr = dc + ((row0 + i) * H + h) * N;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int n = tx + 16 * q;
          if (n < N) dcr[n] = jt == 0 ? dcp[r][q] : dcr[n] + dcp[r][q];
        }
      }
    }

    // ---- state terms of the key tile ----
    // dS_b[j][p] = sum_n B[j][n] dS[p][n];  xdS[j][n] = sum_p x[j][p] dS[p][n]
    float dsbv[4][4] = {}, xds[4][8] = {};
    for (int n = 0; n < N; ++n) {
      float bv[4], sv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) bv[r] = bT[n * kPad + ty + 16 * r];
#pragma unroll
      for (int q = 0; q < 4; ++q) sv[q] = dsT[n * kPadP + tx + 16 * q];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) dsbv[r][q] = fmaf(bv[r], sv[q], dsbv[r][q]);
    }
    for (int p = 0; p < P; ++p) {
      float xv[4], sv[8];
#pragma unroll
      for (int r = 0; r < 4; ++r) xv[r] = xT[p * kPad + ty + 16 * r];
#pragma unroll
      for (int q = 0; q < 8; ++q) sv[q] = dsT[(tx + 16 * q) * kPadP + p];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 8; ++q) xds[r][q] = fmaf(xv[r], sv[q], xds[r][q]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int lj = ty + 16 * r, j = j0 + lj;
      const bool live = lj < jn;
      float pw = 0.f, px = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = tx + 16 * q;
        if (p < P) {
          const float xv = xT[p * kPad + lj];
          pw = fmaf(xv, dsbv[r][q], pw);
          px = fmaf(d_dx[r][q], xv, px);
        }
      }
      const float dw = half_warp_sum(pw);
      const float dxx = half_warp_sum(px);
      if (!live) continue;
      const float wexp = expf(cum_last - cum[j]);
      const float w = wexp * dts[j];
      float* dxr = dx + ((row0 + j) * H + h) * P;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = tx + 16 * q;
        if (p < P) dxr[p] = w * dsbv[r][q] + dts[j] * d_dx[r][q];
      }
      float* dbw = db + ((row0 + j) * H + h) * N;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int n = tx + 16 * q;
        if (n < N) dbw[n] = dbr[r][q] + w * xds[r][q];
      }
      if (tx == 0) {
        ddts[j] = dw * wexp + dxx;
        dww[j] = dw * w;
      }
    }
  }

  // ---- reverse cumsum of dcum into ddt and da ----
  __syncthreads();
  if (tid == 0) {
    float total = 0.f;
    for (int k = 0; k < L; ++k) total += dww[k];
    float rev = 0.f, dacc = 0.f;
    for (int k = L - 1; k >= 0; --k) {
      float d = dcum[(row0 + k) * H + h] + rowE[k] - colE[k] - dww[k];
      if (k == L - 1) d += total;
      rev += d;
      ddt[(row0 + k) * H + h] = ddts[k] + a * rev;
      dacc = fmaf(dts[k], rev, dacc);
    }
    da[((long long)b * H + h) * nc + c] = dacc;
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const void* Bm, const void* Cm, const float* dy,
                   const float* dstates, const float* dcum, float* dx,
                   float* ddt, float* db, float* dc, float* da, int batch,
                   int S, int H, int P, int G, int N, int L,
                   const long long* st, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(S / L, H, batch);
  ssd_bwd_kernel<T><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), dy, dstates, dcum, dx, ddt, db, dc, da, S,
      H, P, G, N, L, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8]);
  return cudaGetLastError();
}

}  // namespace

cudaError_t ssd_bwd_sm90(const void* x, const float* dt, const float* A,
                         const void* Bm, const void* Cm, const float* dy,
                         const float* dstates, const float* dcum, float* dx,
                         float* ddt, float* db, float* dc, float* da,
                         float* scratch, int batch, int S, int H, int P, int G,
                         int N, int L, int hb, const long long* st,
                         cudaStream_t stream);

// dtype: 0 = float32, 1 = bfloat16 (x, Bm and Cm). head_block: heads of a
// group a CTA of the bf16 route takes. fma: 1 runs the f32 FMA kernel
// whatever the inputs, 0 the route of the rule. strides: the nine (batch,
// step, head-or-group) element strides of x, Bm and Cm. dy, dx: (B,S,H,P);
// dstates: (B,nc,H,P,N); dcum, ddt: (B,S,H); da: (B,H,nc); db, dc:
// (B,S,H,N) per head on the f32 route, (parts,B,S,G,N) per head block on
// the bf16 route; scratch: the bf16 route's caches for L > 64; all f32 and
// contiguous. Returns a cudaError_t.
extern "C" int ssd_bwd(const void* x, const float* dt, const float* A,
                       const void* Bm, const void* Cm, const float* dy,
                       const float* dstates, const float* dcum, float* dx,
                       float* ddt, float* db, float* dc, float* da,
                       float* scratch, int batch, int S, int H, int P, int G,
                       int N, int L, int dtype, int head_block, int fma,
                       const long long* strides, void* stream) {
  if (L < 1 || L > kMaxL || S % L || P < 1 || P > kMaxP || N < 1 ||
      N > kMaxN || G < 1 || H % G || batch > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || S == 0 || H == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!fma && dtype == 1 && P == 64 && (N == 64 || N == 128))
    return (int)ssd_bwd_sm90(x, dt, A, Bm, Cm, dy, dstates, dcum, dx, ddt, db,
                             dc, da, scratch, batch, S, H, P, G, N, L,
                             head_block, strides, st);
  if (dtype == 0)
    return launch<float>(x, dt, A, Bm, Cm, dy, dstates, dcum, dx, ddt, db,
                         dc, da, batch, S, H, P, G, N, L, strides, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, dy, dstates, dcum, dx,
                                 ddt, db, dc, da, batch, S, H, P, G, N, L,
                                 strides, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
