// Flash-attention forward for NVIDIA Hopper (sm_90a), written by hand: the
// f32 route, and the C entry fa_fwd of both routes.
//
// Replaces the Pallas TPU kernel
//   repro/kernels/flash_attention/kernel.py::_fa_kernel
// and computes what it computes, for q (B,Sq,H,D) and k, v (B,Skv,KVH,D),
// D in {64, 96, 112, 128, 192, 256}:
//   * GQA: query head h reads KV head h / (H / KVH), straight from the
//     strided (B,S,KVH,D) tensor (no repeated heads, no D padding);
//   * online softmax in f32 (running max, running sum, f32 accumulator);
//   * masks: padding (kpos < Skv), causal (kpos <= qpos) and sliding window
//     (kpos > qpos - window), with qpos = row + q_offset;
//   * the NEG_INF contract (NEG_INF = -1e30): p = 0 where m_new <= NEG_INF/2,
//     alpha = 0 where m_prev <= NEG_INF/2, and a row that sees no key gets
//     out = 0 and lse = 0;
//   * outputs: out (B,Sq,H,D) in the input dtype, lse (B,Sq,H) in f32.
// fa_fwd sends bf16 inputs to fa_fwd_sm90 (flash_fwd_sm90.cu: wgmma tensor
// cores fed by TMA) and f32 inputs to fa_fwd_kernel below, on the CUDA
// cores in f32 FMA: the tensor cores would take f32 as TF32 (about three
// decimal digits), and the f32 route is what the port's f32 checks hold to
// the reference. It is the TPU kernel's arithmetic exactly (the plain
// version's rounding points, q * scale and p in the input dtype, are no-ops
// in f32).
//
// What bounds it on an H100: ~8.6 GFLOP of the internlm2-1.8b prefill shape
// (B 8, S 512, H 16, KVH 8, D 128, causal) at the 67 TFLOP/s of f32 FMA is
// ~130 us at best, against ~101 MB of f32 traffic (30 us): it is bound by
// FMA throughput and shared-memory loads.
//
// Design: one CTA of 4 warps per (batch, head, 32-row query tile) loops over
// 64-key KV tiles, the loop taking the place of the TPU's sequential KV grid
// axis; tiles that the causal or window bound excludes entirely are skipped.
// Each KV tile is read from device memory once per CTA with 16-byte loads
// and staged in shared memory (K rows padded by 4 floats, so that the
// per-lane float4 reads of K are free of bank conflicts). Each warp owns
// 8 query rows; a lane owns 2 keys of the tile for Q.K^T and D/32 output
// columns for P.V. Q, K and P are read from shared memory as float4 (Q and
// P as broadcasts), so each shared load feeds 8-16 FMAs. Shared memory is
// 91.1 KB per CTA at D = 128 (two CTAs per SM), 49.9 KB at D = 64, and
// 132.1 KB at D = 192 and 173.1 KB at D = 256 (one CTA per SM). A lane
// holds kRows x D/32 accumulators: 48 registers at D 192, 64 at D 256.
// At D 112 (zamba2-7b) a lane owns ceil(112 / 32) = 4 output columns and
// lanes 16-31 have no fourth one (their reads of V give 0, their sums are
// not stored); shared memory is 79.0 KB. At D 96 (minicpm3-4b's MLA, qk 64
// + 32, v padded to 96) a lane owns exactly 3 columns (96 = 3 x 32), so no
// lane lacks one; shared memory is 69.0 KB.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;        // NEG_INF of the TPU kernel
constexpr int kBlockQ = 32;              // query rows per CTA
constexpr int kBlockK = 64;              // keys per KV tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kBlockQ / kWarps;  // query rows per warp

// 16 bytes of T from device memory, as f32
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int n = 4;
  static __device__ __forceinline__ void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};

// x rounded to T and back (identity for f32)
__device__ __forceinline__ float round_to(float x, const float*) { return x; }

__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }

// whether output column lane + 32 cc lies inside D (always, where 32 divides
// D)
template <int D>
__device__ __forceinline__ bool has_col(int lane, int cc) {
  return D % 32 == 0 || lane + 32 * cc < D;
}

template <int D>
constexpr int smem_floats() {
  return kBlockQ * D + kBlockK * (D + 4) + kBlockK * D + kBlockQ * kBlockK;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o,
              float* __restrict__ lse, int Sq, int Skv, int H, int KVH,
              float scale, int causal, int window, int q_offset) {
  constexpr int kCols = (D + 31) / 32;   // output columns per lane
  constexpr int kVec = Vec16<T>::n;      // elements per 16-byte load
  constexpr int kChunks = D / kVec;      // 16-byte loads per row
  constexpr int kKStride = D + 4;        // padded row of the K tile
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                      // [kBlockQ][D], q * scale
  float* sK = sQ + kBlockQ * D;          // [kBlockK][kKStride]
  float* sV = sK + kBlockK * kKStride;   // [kBlockK][D]
  float* sP = sV + kBlockK * D;          // [kBlockQ][kBlockK], per-warp rows

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = warp * kRows;      // this warp's first row in the tile

  const int64_t q_stride = (int64_t)H * D;    // between positions
  const int64_t kv_stride = (int64_t)KVH * D;
  const T* qb = q + ((int64_t)b * Sq * H + h) * D;
  const T* kb = k + ((int64_t)b * Skv * KVH + kvh) * D;
  const T* vb = v + ((int64_t)b * Skv * KVH + kvh) * D;

  // q * scale in T, as the plain version takes it
  const float sc = round_to(scale, q);
  for (int i = tid; i < kBlockQ * kChunks; i += kThreads) {
    const int r = i / kChunks, d = (i % kChunks) * kVec;
    float x[kVec];
    if (q0 + r < Sq) {
      Vec16<T>::load(qb + (q0 + r) * q_stride + d, x);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) x[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) sQ[r * D + d + j] = round_to(x[j] * sc, q);
  }

  // KV tiles that some row of this query tile can see
  const int q_last = min(q0 + kBlockQ, Sq) - 1;
  int kv_end = Skv;
  if (causal) kv_end = min(kv_end, q_last + q_offset + 1);
  int kv_begin = 0;
  if (window > 0) kv_begin = max(0, q0 + q_offset - window + 1);
  const int t_begin = kv_begin / kBlockK;
  const int t_end =
      kv_end > kv_begin ? (kv_end + kBlockK - 1) / kBlockK : t_begin;

  float m[kRows], l[kRows], acc[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // sQ is written; no warp still reads the last tile
    for (int i = tid; i < kBlockK * kChunks; i += kThreads) {
      const int c = i / kChunks, d = (i % kChunks) * kVec;
      float kx[kVec], vx[kVec];
      if (k0 + c < Skv) {
        const int64_t off = (k0 + c) * kv_stride + d;
        Vec16<T>::load(kb + off, kx);
        Vec16<T>::load(vb + off, vx);
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) kx[j] = vx[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < kVec; j += 4) {
        *reinterpret_cast<float4*>(sK + c * kKStride + d + j) =
            make_float4(kx[j], kx[j + 1], kx[j + 2], kx[j + 3]);
        *reinterpret_cast<float4*>(sV + c * D + d + j) =
            make_float4(vx[j], vx[j + 1], vx[j + 2], vx[j + 3]);
      }
    }
    __syncthreads();

    // S = (q * scale) . k for keys lane and lane + 32 of the tile
    float s[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r][0] = s[r][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 ka =
          *reinterpret_cast<const float4*>(sK + lane * kKStride + d);
      const float4 kc =
          *reinterpret_cast<const float4*>(sK + (lane + 32) * kKStride + d);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(sQ + (row0 + r) * D + d);
        s[r][0] = fmaf(qv.x, ka.x, s[r][0]);
        s[r][0] = fmaf(qv.y, ka.y, s[r][0]);
        s[r][0] = fmaf(qv.z, ka.z, s[r][0]);
        s[r][0] = fmaf(qv.w, ka.w, s[r][0]);
        s[r][1] = fmaf(qv.x, kc.x, s[r][1]);
        s[r][1] = fmaf(qv.y, kc.y, s[r][1]);
        s[r][1] = fmaf(qv.z, kc.z, s[r][1]);
        s[r][1] = fmaf(qv.w, kc.w, s[r][1]);
      }
    }

    // masks and the online-softmax update, one row at a time
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = q0 + row0 + r + q_offset;
      float sv[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kpos = k0 + lane + 32 * j;
        bool ok = kpos < Skv;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        sv[j] = ok ? s[r][j] : kNegInf;
      }
      float mx = fmaxf(sv[0], sv[1]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m[r];
      const float m_new = fmaxf(m_prev, mx);
      const bool live = m_new > kNegInf / 2;
      const float p0 = live ? expf(sv[0] - m_new) : 0.f;
      const float p1 = live ? expf(sv[1] - m_new) : 0.f;
      const float alpha = m_prev > kNegInf / 2 ? expf(m_prev - m_new) : 0.f;
      float ps = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[r] = l[r] * alpha + ps;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= alpha;
      // P.V takes p rounded to T, as the plain version does
      sP[(row0 + r) * kBlockK + lane] = round_to(p0, q);
      sP[(row0 + r) * kBlockK + lane + 32] = round_to(p1, q);
    }
    __syncwarp();

    // acc += P . V for this lane's output columns
#pragma unroll 2
    for (int c = 0; c < kBlockK; c += 4) {
      float vv[4][kCols];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc)
          vv[j][cc] = has_col<D>(lane, cc)
                          ? sV[(c + j) * D + lane + 32 * cc] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 pv =
            *reinterpret_cast<const float4*>(sP + (row0 + r) * kBlockK + c);
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc) {
          acc[r][cc] = fmaf(pv.x, vv[0][cc], acc[r][cc]);
          acc[r][cc] = fmaf(pv.y, vv[1][cc], acc[r][cc]);
          acc[r][cc] = fmaf(pv.z, vv[2][cc], acc[r][cc]);
          acc[r][cc] = fmaf(pv.w, vv[3][cc], acc[r][cc]);
        }
      }
    }
    __syncwarp();  // sP is rewritten by the next tile
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + row0 + r;
    if (row < Sq) {
      const bool empty = l[r] == 0.f;  // the row saw no key
      const float denom = empty ? 1.f : l[r];
      T* orow = o + (((int64_t)b * Sq + row) * H + h) * D;
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc)
        if (has_col<D>(lane, cc))
          store_f32(orow + lane + 32 * cc, acc[r][cc] / denom);
      if (lane == 0)
        lse[((int64_t)b * Sq + row) * H + h] =
            empty ? 0.f : m[r] + logf(denom);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int Sq, int Skv, int H, int KVH,
                   float scale, int causal, int window, int q_offset,
                   cudaStream_t stream) {
  const int smem = smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, H, B);
  fa_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), Sq, Skv, H, KVH, scale, causal, window,
      q_offset);
  return cudaGetLastError();
}

}  // namespace

// the bf16 route (flash_fwd_sm90.cu)
cudaError_t fa_fwd_sm90(const void* q, const void* k, const void* v, void* o,
                        void* lse, int B, int Sq, int Skv, int H, int KVH,
                        int D, float scale, int causal, int window,
                        int q_offset, cudaStream_t stream);

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int fa_fwd(const void* q, const void* k, const void* v, void* o,
                      void* lse, int B, int Sq, int Skv, int H, int KVH,
                      int D, int dtype, float scale, int causal, int window,
                      int q_offset, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, o, lse, B, Sq, Skv, H, KVH, scale,
                             causal, window, q_offset, st);
  if (dtype == 0 && D == 96)
    return launch<float, 96>(q, k, v, o, lse, B, Sq, Skv, H, KVH, scale,
                             causal, window, q_offset, st);
  if (dtype == 0 && D == 112)
    return launch<float, 112>(q, k, v, o, lse, B, Sq, Skv, H, KVH, scale,
                              causal, window, q_offset, st);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, o, lse, B, Sq, Skv, H, KVH, scale,
                              causal, window, q_offset, st);
  if (dtype == 0 && D == 192)
    return launch<float, 192>(q, k, v, o, lse, B, Sq, Skv, H, KVH, scale,
                              causal, window, q_offset, st);
  if (dtype == 0 && D == 256)
    return launch<float, 256>(q, k, v, o, lse, B, Sq, Skv, H, KVH, scale,
                              causal, window, q_offset, st);
  if (dtype == 1)
    return fa_fwd_sm90(q, k, v, o, lse, B, Sq, Skv, H, KVH, D, scale, causal,
                       window, q_offset, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* fa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
