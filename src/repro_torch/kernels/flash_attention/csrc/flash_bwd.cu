// Flash-attention backward for NVIDIA Hopper (sm_90a), written by hand: the
// f32 route, the C entries fa_bwd_dq and fa_bwd_dkv of both routes, and
// fa_bwd_delta, the delta = rowsum(dO * O) both routes read (below).
//
// Replaces the Pallas TPU kernels
//   repro/kernels/flash_attention/kernel.py::_fa_bwd_dq_kernel   (dQ)
//   repro/kernels/flash_attention/kernel.py::_fa_bwd_dkv_kernel  (dK, dV)
// and computes what they compute, for q, dO (B,Sq,H,D) and k, v
// (B,Skv,KVH,D), D in {64, 96, 112, 128, 192, 256}, given the forward's lse
// (B,Sq,H) f32 and delta = rowsum(dO * O) (B,Sq,H) f32 (taken before them
// by fa_bwd_delta, where the JAX package takes it in plain jnp):
//   S  = (q * scale) . k^T, with q * scale formed in f32, masked to
//        NEG_INF = -1e30 (padding, causal, window, as kernel.py::_mask),
//        P = exp(S - lse) (0 where masked);
//   dP = dO . v^T,  dS = P * (dP - delta);
//   dQ = scale * sum_k dS . k;   dV = sum_q P^T . dO;
//   dK = sum_q dS^T . (q * scale),
// with dK and dV summed over the G = H / KVH query heads of each KV head
// inside the kernel (no atomics), as the TPU grid (B*KVH, nk, G*nq) does.
// Every product is an f32 FMA. The entries send bf16 inputs to
// flash_bwd_sm90.cu (wgmma tensor cores fed by TMA, S from q * scale in
// bf16 as the bf16 forward takes it) and f32 inputs to the kernels below: the
// tensor cores would take f32 as TF32, and this route is what the port's
// f32 checks hold to the reference.
// A row that sees no key has lse = 0 (the forward's contract): all its P
// are 0, so its dq is 0 and it adds nothing to dk or dv.
//
// What bounds it on an H100: at the SWAP phase-1 shape of internlm2-1.8b
// in f32 (B 256, S 64, H 16, KVH 8, D 128, causal; 8.52 M visible pairs of
// query and key rows over the heads) each kernel reads q, dO, k, v, lse and
// delta and writes dq (dQ kernel) or dk and dv (dK/dV kernel): 538.9 MB
// each, 160.9 us at 3.35 TB/s. Their products, 6 D per visible pair for
// dQ (6.5 GFLOP) and 8 D for dK/dV (8.7 GFLOP), take 98 and 130 us at the
// 67 TFLOP/s of f32 FMA, and in practice more: bound by FMA issue and
// shared-memory reads.
//
// Design. dQ: one CTA of 4 warps per (query tile of 32 rows, head, batch)
// loops over the 64-key tiles that the causal or window bound leaves
// visible (the loop takes the place of the TPU's sequential KV grid axis).
// Each warp owns 8 query rows; a lane owns keys lane and lane + 32 of the
// tile for S and dP, and D/32 output columns for dS . K. dK/dV: one CTA of
// 4 warps per (32-key tile, KV head, batch) loops over the G query heads
// and, for each, over the visible 64-row query tiles. Each warp owns 8
// keys; a lane owns query rows lane and lane + 32 for S^T and dP^T, and
// D/32 output columns of dK and dV. At D 256 a CTA takes 16 keys (4 a
// warp), so that its two accumulators stay at 64 registers a thread; shared
// memory is then 174.6 KB for dK/dV and 206.8 KB for dQ (one CTA an SM).
// At D 192 (MLA) a dK/dV CTA takes 32 keys: ptxas fits its accumulators
// (96 registers a thread) in 209 registers with no spills (152 at 16 keys,
// which would re-read every Q and dO tile twice as often), and its shared
// memory is 166.4 KB; dQ's is 157.7 KB. One CTA an SM.
// At D 112 (zamba2-7b) a lane owns ceil(112 / 32) = 4 output columns, the
// fourth only in lanes 0-15 (the others read 0 for it and store nothing);
// dK/dV takes 32 keys a CTA, 102.5 KB, and dQ 94.0 KB. At D 96
// (minicpm3-4b's MLA) a lane owns exactly 3 columns (96 = 3 x 32); dK/dV
// takes 90.5 KB and dQ 82.0 KB.
// Tiles are staged in shared memory as f32; operands a lane reads alone (K and V in dQ, Q and dO in dK/dV) are
// padded by 4 floats a row so that its float4 reads are free of bank
// conflicts, the others are read as broadcasts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

// dQ kernel tiles
constexpr int kQRows = 32;                 // query rows per CTA
constexpr int kQKeys = 64;                 // keys per KV tile
constexpr int kQRowsPerWarp = kQRows / kWarps;
// dK/dV kernel tiles
template <int D>
__host__ __device__ constexpr int kv_keys() {  // keys per CTA
  return D == 256 ? 16 : 32;
}
constexpr int kKVRows = 64;                // query rows per Q tile

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

__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// whether output column lane + 32 cc lies inside D (always, where 32 divides
// D)
template <int D>
__device__ __forceinline__ bool has_col(int lane, int cc) {
  return D % 32 == 0 || lane + 32 * cc < D;
}

__device__ __forceinline__ bool visible(int kpos, int qpos, int Skv,
                                        int causal, int window) {
  bool ok = kpos < Skv;
  if (causal) ok = ok && kpos <= qpos;
  if (window > 0) ok = ok && kpos > qpos - window;
  return ok;
}

// rows [r0, r0 + n) of a (S, heads, D) tensor's head `head` -> f32 smem rows
// of `stride` floats, times `mul`; rows past S are zero
template <typename T, int D>
__device__ __forceinline__ void stage_rows(const T* base, int64_t pos_stride,
                                           int r0, int n, int S, float mul,
                                           float* dst, int stride) {
  constexpr int kVec = Vec16<T>::n;
  constexpr int kChunks = D / kVec;
  for (int i = threadIdx.x; i < n * kChunks; i += kThreads) {
    const int r = i / kChunks, d = (i % kChunks) * kVec;
    float x[kVec];
    if (r0 + r < S) {
      Vec16<T>::load(base + (int64_t)(r0 + r) * pos_stride + d, x);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) x[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < kVec; j += 4)
      *reinterpret_cast<float4*>(dst + r * stride + d + j) =
          make_float4(x[j] * mul, x[j + 1] * mul, x[j + 2] * mul,
                      x[j + 3] * mul);
  }
}

template <int D>
constexpr int dq_smem_floats() {
  return 2 * kQRows * D + 2 * kQKeys * (D + 4) + kQRows * kQKeys;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dq,
                 int Sq, int Skv, int H, int KVH, float scale, int causal,
                 int window, int q_offset) {
  constexpr int kCols = (D + 31) / 32;
  constexpr int kStride = D + 4;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                      // [kQRows][D], q * scale
  float* sdO = sQ + kQRows * D;          // [kQRows][D]
  float* sK = sdO + kQRows * D;          // [kQKeys][kStride]
  float* sV = sK + kQKeys * kStride;     // [kQKeys][kStride]
  float* sdS = sV + kQKeys * kStride;    // [kQRows][kQKeys]

  const int q0 = blockIdx.x * kQRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int lane = threadIdx.x & 31;
  const int row0 = (threadIdx.x >> 5) * kQRowsPerWarp;
  const int64_t q_stride = (int64_t)H * D;
  const int64_t kv_stride = (int64_t)KVH * D;
  const T* kb = k + ((int64_t)b * Skv * KVH + kvh) * D;
  const T* vb = v + ((int64_t)b * Skv * KVH + kvh) * D;

  stage_rows<T, D>(q + ((int64_t)b * Sq * H + h) * D, q_stride, q0, kQRows,
                   Sq, scale, sQ, D);
  stage_rows<T, D>(dout + ((int64_t)b * Sq * H + h) * D, q_stride, q0,
                   kQRows, Sq, 1.f, sdO, D);

  float lse_r[kQRowsPerWarp], dl_r[kQRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kQRowsPerWarp; ++r) {
    const int row = q0 + row0 + r;
    const int64_t i = ((int64_t)b * Sq + row) * H + h;
    lse_r[r] = row < Sq ? lse[i] : 0.f;
    dl_r[r] = row < Sq ? delta[i] : 0.f;
  }

  // the KV tiles some row of this query tile can see (as the forward)
  const int q_last = min(q0 + kQRows, Sq) - 1;
  int kv_end = Skv;
  if (causal) kv_end = min(kv_end, q_last + q_offset + 1);
  int kv_begin = 0;
  if (window > 0) kv_begin = max(0, q0 + q_offset - window + 1);
  const int t_begin = kv_begin / kQKeys;
  const int t_end =
      kv_end > kv_begin ? (kv_end + kQKeys - 1) / kQKeys : t_begin;

  float acc[kQRowsPerWarp][kCols];
#pragma unroll
  for (int r = 0; r < kQRowsPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kQKeys;
    __syncthreads();  // sQ/sdO written; no warp still reads the last tile
    stage_rows<T, D>(kb, kv_stride, k0, kQKeys, Skv, 1.f, sK, kStride);
    stage_rows<T, D>(vb, kv_stride, k0, kQKeys, Skv, 1.f, sV, kStride);
    __syncthreads();

    // S and dP for keys lane and lane + 32 of the tile
    float s[kQRowsPerWarp][2], dp[kQRowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kQRowsPerWarp; ++r)
      s[r][0] = s[r][1] = dp[r][0] = dp[r][1] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      const float4 ka = *reinterpret_cast<const float4*>(sK + lane * kStride + d);
      const float4 kc =
          *reinterpret_cast<const float4*>(sK + (lane + 32) * kStride + d);
      const float4 va = *reinterpret_cast<const float4*>(sV + lane * kStride + d);
      const float4 vc =
          *reinterpret_cast<const float4*>(sV + (lane + 32) * kStride + d);
#pragma unroll
      for (int r = 0; r < kQRowsPerWarp; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(sQ + (row0 + r) * D + d);
        const float4 ov = *reinterpret_cast<const float4*>(sdO + (row0 + r) * D + d);
        s[r][0] = dot4(qv, ka, s[r][0]);
        s[r][1] = dot4(qv, kc, s[r][1]);
        dp[r][0] = dot4(ov, va, dp[r][0]);
        dp[r][1] = dot4(ov, vc, dp[r][1]);
      }
    }

    // P = exp(S - lse) where visible, dS = P * (dP - delta)
#pragma unroll
    for (int r = 0; r < kQRowsPerWarp; ++r) {
      const int row = q0 + row0 + r;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kpos = k0 + lane + 32 * j;
        const bool ok =
            row < Sq && visible(kpos, row + q_offset, Skv, causal, window);
        const float p = ok ? expf(s[r][j] - lse_r[r]) : 0.f;
        sdS[(row0 + r) * kQKeys + lane + 32 * j] = p * (dp[r][j] - dl_r[r]);
      }
    }
    __syncwarp();

    // acc += dS . K for this lane's output columns
#pragma unroll 2
    for (int c = 0; c < kQKeys; c += 4) {
      float kk[4][kCols];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc)
          kk[j][cc] = has_col<D>(lane, cc)
                          ? sK[(c + j) * kStride + lane + 32 * cc] : 0.f;
#pragma unroll
      for (int r = 0; r < kQRowsPerWarp; ++r) {
        const float4 ds =
            *reinterpret_cast<const float4*>(sdS + (row0 + r) * kQKeys + c);
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc) {
          acc[r][cc] = fmaf(ds.x, kk[0][cc], acc[r][cc]);
          acc[r][cc] = fmaf(ds.y, kk[1][cc], acc[r][cc]);
          acc[r][cc] = fmaf(ds.z, kk[2][cc], acc[r][cc]);
          acc[r][cc] = fmaf(ds.w, kk[3][cc], acc[r][cc]);
        }
      }
    }
    __syncwarp();  // sdS is rewritten by the next tile
  }

#pragma unroll
  for (int r = 0; r < kQRowsPerWarp; ++r) {
    const int row = q0 + row0 + r;
    if (row < Sq) {
      T* out = dq + (((int64_t)b * Sq + row) * H + h) * D;
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc)
        if (has_col<D>(lane, cc))
          store_f32(out + lane + 32 * cc, acc[r][cc] * scale);
    }
  }
}

template <int D>
constexpr int dkv_smem_floats() {
  return 2 * kv_keys<D>() * D + 2 * kKVRows * (D + 4) +
         2 * kv_keys<D>() * kKVRows + 2 * kKVRows;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dk,
                  T* __restrict__ dv, int Sq, int Skv, int H, int KVH,
                  float scale, int causal, int window, int q_offset) {
  constexpr int kCols = (D + 31) / 32;
  constexpr int kStride = D + 4;
  constexpr int kKVKeys = kv_keys<D>();
  constexpr int kKVKeysPerWarp = kKVKeys / kWarps;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;                        // [kKVKeys][D]
  float* sV = sK + kKVKeys * D;            // [kKVKeys][D]
  float* sQ = sV + kKVKeys * D;            // [kKVRows][kStride], q * scale
  float* sdO = sQ + kKVRows * kStride;     // [kKVRows][kStride]
  float* sP = sdO + kKVRows * kStride;     // [kKVKeys][kKVRows]
  float* sdS = sP + kKVKeys * kKVRows;     // [kKVKeys][kKVRows]
  float* sL = sdS + kKVKeys * kKVRows;     // [kKVRows] lse
  float* sDl = sL + kKVRows;               // [kKVRows] delta

  const int k0 = blockIdx.x * kKVKeys;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KVH;
  const int lane = threadIdx.x & 31;
  const int key0 = (threadIdx.x >> 5) * kKVKeysPerWarp;
  const int64_t q_stride = (int64_t)H * D;
  const int64_t kv_stride = (int64_t)KVH * D;

  stage_rows<T, D>(k + ((int64_t)b * Skv * KVH + kvh) * D, kv_stride, k0,
                   kKVKeys, Skv, 1.f, sK, D);
  stage_rows<T, D>(v + ((int64_t)b * Skv * KVH + kvh) * D, kv_stride, k0,
                   kKVKeys, Skv, 1.f, sV, D);

  // the query rows that can see some key of this tile
  const int k_last = min(k0 + kKVKeys, Skv) - 1;
  int r_begin = 0, r_end = Sq;
  if (causal) r_begin = max(0, k0 - q_offset);
  if (window > 0) r_end = min(r_end, max(0, k_last + window - q_offset));
  const int t_begin = r_begin / kKVRows;
  const int t_end = r_end > r_begin ? (r_end + kKVRows - 1) / kKVRows : t_begin;

  float acc_k[kKVKeysPerWarp][kCols], acc_v[kKVKeysPerWarp][kCols];
#pragma unroll
  for (int r = 0; r < kKVKeysPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc_k[r][c] = acc_v[r][c] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const T* qb = q + ((int64_t)b * Sq * H + h) * D;
    const T* ob = dout + ((int64_t)b * Sq * H + h) * D;
    for (int t = t_begin; t < t_end; ++t) {
      const int r0 = t * kKVRows;
      __syncthreads();  // no warp still reads the last Q tile
      stage_rows<T, D>(qb, q_stride, r0, kKVRows, Sq, scale, sQ, kStride);
      stage_rows<T, D>(ob, q_stride, r0, kKVRows, Sq, 1.f, sdO, kStride);
      for (int i = threadIdx.x; i < kKVRows; i += kThreads) {
        const int row = r0 + i;
        const int64_t at = ((int64_t)b * Sq + row) * H + h;
        sL[i] = row < Sq ? lse[at] : 0.f;
        sDl[i] = row < Sq ? delta[at] : 0.f;
      }
      __syncthreads();

      // S^T and dP^T for query rows lane and lane + 32 of the tile
      float s[kKVKeysPerWarp][2], dp[kKVKeysPerWarp][2];
#pragma unroll
      for (int r = 0; r < kKVKeysPerWarp; ++r)
        s[r][0] = s[r][1] = dp[r][0] = dp[r][1] = 0.f;
#pragma unroll 2
      for (int d = 0; d < D; d += 4) {
        const float4 qa = *reinterpret_cast<const float4*>(sQ + lane * kStride + d);
        const float4 qc =
            *reinterpret_cast<const float4*>(sQ + (lane + 32) * kStride + d);
        const float4 oa =
            *reinterpret_cast<const float4*>(sdO + lane * kStride + d);
        const float4 oc =
            *reinterpret_cast<const float4*>(sdO + (lane + 32) * kStride + d);
#pragma unroll
        for (int r = 0; r < kKVKeysPerWarp; ++r) {
          const float4 kv = *reinterpret_cast<const float4*>(sK + (key0 + r) * D + d);
          const float4 vv = *reinterpret_cast<const float4*>(sV + (key0 + r) * D + d);
          s[r][0] = dot4(qa, kv, s[r][0]);
          s[r][1] = dot4(qc, kv, s[r][1]);
          dp[r][0] = dot4(oa, vv, dp[r][0]);
          dp[r][1] = dot4(oc, vv, dp[r][1]);
        }
      }
#pragma unroll
      for (int r = 0; r < kKVKeysPerWarp; ++r) {
        const int kpos = k0 + key0 + r;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int i = lane + 32 * j;
          const int row = r0 + i;
          const bool ok =
              row < Sq && visible(kpos, row + q_offset, Skv, causal, window);
          const float p = ok ? expf(s[r][j] - sL[i]) : 0.f;
          sP[(key0 + r) * kKVRows + i] = p;
          sdS[(key0 + r) * kKVRows + i] = p * (dp[r][j] - sDl[i]);
        }
      }
      __syncwarp();

      // dV += P^T . dO and dK += dS^T . (q * scale), this lane's columns
#pragma unroll 2
      for (int c = 0; c < kKVRows; c += 4) {
        float oo[4][kCols], qq[4][kCols];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int cc = 0; cc < kCols; ++cc) {
            const bool in = has_col<D>(lane, cc);
            oo[j][cc] = in ? sdO[(c + j) * kStride + lane + 32 * cc] : 0.f;
            qq[j][cc] = in ? sQ[(c + j) * kStride + lane + 32 * cc] : 0.f;
          }
#pragma unroll
        for (int r = 0; r < kKVKeysPerWarp; ++r) {
          const float4 p =
              *reinterpret_cast<const float4*>(sP + (key0 + r) * kKVRows + c);
          const float4 ds =
              *reinterpret_cast<const float4*>(sdS + (key0 + r) * kKVRows + c);
#pragma unroll
          for (int cc = 0; cc < kCols; ++cc) {
            acc_v[r][cc] = fmaf(p.x, oo[0][cc], acc_v[r][cc]);
            acc_v[r][cc] = fmaf(p.y, oo[1][cc], acc_v[r][cc]);
            acc_v[r][cc] = fmaf(p.z, oo[2][cc], acc_v[r][cc]);
            acc_v[r][cc] = fmaf(p.w, oo[3][cc], acc_v[r][cc]);
            acc_k[r][cc] = fmaf(ds.x, qq[0][cc], acc_k[r][cc]);
            acc_k[r][cc] = fmaf(ds.y, qq[1][cc], acc_k[r][cc]);
            acc_k[r][cc] = fmaf(ds.z, qq[2][cc], acc_k[r][cc]);
            acc_k[r][cc] = fmaf(ds.w, qq[3][cc], acc_k[r][cc]);
          }
        }
      }
      __syncwarp();  // sP/sdS are rewritten by the next tile
    }
  }

#pragma unroll
  for (int r = 0; r < kKVKeysPerWarp; ++r) {
    const int kpos = k0 + key0 + r;
    if (kpos < Skv) {
      const int64_t at = (((int64_t)b * Skv + kpos) * KVH + kvh) * D;
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) {
        if (!has_col<D>(lane, cc)) continue;
        store_f32(dk + at + lane + 32 * cc, acc_k[r][cc]);
        store_f32(dv + at + lane + 32 * cc, acc_v[r][cc]);
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int B, int Sq, int Skv, int H, int KVH,
                      float scale, int causal, int window, int q_offset,
                      cudaStream_t stream) {
  const int smem = dq_smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kQRows - 1) / kQRows, H, B);
  fa_bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), Sq, Skv, H, KVH, scale, causal, window, q_offset);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int B, int Sq, int Skv, int H,
                       int KVH, float scale, int causal, int window,
                       int q_offset, cudaStream_t stream) {
  const int smem = dkv_smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Skv + kv_keys<D>() - 1) / kv_keys<D>(), KVH, B);
  fa_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), Sq, Skv, H, KVH, scale,
      causal, window, q_offset);
  return cudaGetLastError();
}

// delta = rowsum(dO * O): one f32 per row of D values of dO and O, for
// the B * Sq * H rows of two contiguous (B, Sq, H, D) tensors.
//
// Replaces no Pallas kernel: the JAX package forms delta in plain jnp
// outside its kernels, at repro/kernels/flash_attention/kernel.py:287-288
// inside flash_attention_pallas_bwd, the function kernel.flash_bwd ports.
// Formed in plain PyTorch ((dO.float() * O).sum(-1)) it wrote an f32
// product tensor and read it back, about half of the whole backward's
// time at the SWAP phase-1 shapes. What bounds it on an H100: the bytes of
// dO and O, read once, and of delta, written once (internlm2-1.8b's phase
// 1 in bf16, B 256, S 64, H 16, D 128: 134.2 MB, 40.1 us at 3.35 TB/s);
// its 2 D flops a row are nothing beside them. Design: kDeltaLanes lanes
// own a row; each issues all of its 16-byte loads of dO and O (in the
// input dtype) before it sums, so a warp keeps 8 to 32 loads a lane in
// flight, takes the products in f32 (exact for bf16 inputs) and sums them
// in its own order; three shuffles join the lanes' sums. No atomics and a
// fixed order: a launch repeats bitwise.
constexpr int kDeltaLanes = 8;           // lanes a row
constexpr int kDeltaThreads = 256;       // 32 rows a CTA

__device__ __forceinline__ float dot_chunk(uint4 a, uint4 b, const float*) {
  const float4 x = *reinterpret_cast<const float4*>(&a);
  const float4 y = *reinterpret_cast<const float4*>(&b);
  return dot4(x, y, 0.f);
}

__device__ __forceinline__ float dot_chunk(uint4 a, uint4 b,
                                           const __nv_bfloat16*) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 fx = __bfloat1622float2(x[j]);
    const float2 fy = __bfloat1622float2(y[j]);
    acc = fmaf(fx.x, fy.x, acc);
    acc = fmaf(fx.y, fy.y, acc);
  }
  return acc;
}

template <typename T, int D>
__global__ void __launch_bounds__(kDeltaThreads)
fa_bwd_delta_kernel(const T* __restrict__ dout, const T* __restrict__ out,
                    float* __restrict__ delta, int64_t rows) {
  constexpr int kChunks = D * (int)sizeof(T) / 16;   // 16-byte chunks a row
  constexpr int kPer = (kChunks + kDeltaLanes - 1) / kDeltaLanes;
  static_assert(D * sizeof(T) % 16 == 0, "whole 16-byte chunks a row");
  const int64_t row = (int64_t)blockIdx.x * (kDeltaThreads / kDeltaLanes) +
                      threadIdx.x / kDeltaLanes;
  const int part = threadIdx.x % kDeltaLanes;
  float sum = 0.f;
  if (row < rows) {
    const uint4* a = reinterpret_cast<const uint4*>(dout + row * D);
    const uint4* b = reinterpret_cast<const uint4*>(out + row * D);
    uint4 va[kPer], vb[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int c = part + j * kDeltaLanes;
      if (c < kChunks) {
        va[j] = __ldg(a + c);
        vb[j] = __ldg(b + c);
      }
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      if (part + j * kDeltaLanes < kChunks)
        sum += dot_chunk(va[j], vb[j], dout);
  }
#pragma unroll
  for (int off = kDeltaLanes / 2; off > 0; off /= 2)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (part == 0 && row < rows) delta[row] = sum;
}

template <typename T, int D>
cudaError_t launch_delta(const void* dout, const void* out, void* delta,
                         int64_t rows, cudaStream_t stream) {
  constexpr int kRowsPerCta = kDeltaThreads / kDeltaLanes;
  const int64_t grid = (rows + kRowsPerCta - 1) / kRowsPerCta;
  fa_bwd_delta_kernel<T, D><<<(unsigned)grid, kDeltaThreads, 0, stream>>>(
      static_cast<const T*>(dout), static_cast<const T*>(out),
      static_cast<float*>(delta), rows);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_delta_d(const void* dout, const void* out, void* delta,
                           int64_t rows, int D, cudaStream_t stream) {
  switch (D) {
    case 64: return launch_delta<T, 64>(dout, out, delta, rows, stream);
    case 96: return launch_delta<T, 96>(dout, out, delta, rows, stream);
    case 112: return launch_delta<T, 112>(dout, out, delta, rows, stream);
    case 128: return launch_delta<T, 128>(dout, out, delta, rows, stream);
    case 192: return launch_delta<T, 192>(dout, out, delta, rows, stream);
    case 256: return launch_delta<T, 256>(dout, out, delta, rows, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// the bf16 routes (flash_bwd_sm90.cu)
cudaError_t fa_bwd_dq_sm90(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dq, int B, int Sq,
                           int Skv, int H, int KVH, int D, float scale,
                           int causal, int window, int q_offset,
                           cudaStream_t stream);
cudaError_t fa_bwd_dkv_sm90(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv, int B,
                            int Sq, int Skv, int H, int KVH, int D,
                            float scale, int causal, int window, int q_offset,
                            cudaStream_t stream);

// dtype: 0 = float32, 1 = bfloat16. Each returns a cudaError_t (0 = launched).
extern "C" int fa_bwd_dq(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* dq, int B, int Sq, int Skv, int H, int KVH,
                         int D, int dtype, float scale, int causal, int window,
                         int q_offset, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch_dq<float, 64>(q, k, v, dout, lse, delta, dq, B, Sq, Skv, H,
                                KVH, scale, causal, window, q_offset, st);
  if (dtype == 0 && D == 96)
    return launch_dq<float, 96>(q, k, v, dout, lse, delta, dq, B, Sq, Skv, H,
                                KVH, scale, causal, window, q_offset, st);
  if (dtype == 0 && D == 112)
    return launch_dq<float, 112>(q, k, v, dout, lse, delta, dq, B, Sq, Skv, H,
                                 KVH, scale, causal, window, q_offset, st);
  if (dtype == 0 && D == 128)
    return launch_dq<float, 128>(q, k, v, dout, lse, delta, dq, B, Sq, Skv, H,
                                 KVH, scale, causal, window, q_offset, st);
  if (dtype == 0 && D == 192)
    return launch_dq<float, 192>(q, k, v, dout, lse, delta, dq, B, Sq, Skv, H,
                                 KVH, scale, causal, window, q_offset, st);
  if (dtype == 0 && D == 256)
    return launch_dq<float, 256>(q, k, v, dout, lse, delta, dq, B, Sq, Skv, H,
                                 KVH, scale, causal, window, q_offset, st);
  if (dtype == 1)
    return fa_bwd_dq_sm90(q, k, v, dout, lse, delta, dq, B, Sq, Skv, H, KVH,
                          D, scale, causal, window, q_offset, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int fa_bwd_dkv(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, void* dk, void* dv, int B,
                          int Sq, int Skv, int H, int KVH, int D, int dtype,
                          float scale, int causal, int window, int q_offset,
                          void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch_dkv<float, 64>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Skv,
                                 H, KVH, scale, causal, window, q_offset, st);
  if (dtype == 0 && D == 96)
    return launch_dkv<float, 96>(q, k, v, dout, lse, delta, dk, dv, B, Sq,
                                 Skv, H, KVH, scale, causal, window, q_offset,
                                 st);
  if (dtype == 0 && D == 112)
    return launch_dkv<float, 112>(q, k, v, dout, lse, delta, dk, dv, B, Sq,
                                  Skv, H, KVH, scale, causal, window, q_offset,
                                  st);
  if (dtype == 0 && D == 128)
    return launch_dkv<float, 128>(q, k, v, dout, lse, delta, dk, dv, B, Sq,
                                  Skv, H, KVH, scale, causal, window, q_offset,
                                  st);
  if (dtype == 0 && D == 192)
    return launch_dkv<float, 192>(q, k, v, dout, lse, delta, dk, dv, B, Sq,
                                  Skv, H, KVH, scale, causal, window, q_offset,
                                  st);
  if (dtype == 0 && D == 256)
    return launch_dkv<float, 256>(q, k, v, dout, lse, delta, dk, dv, B, Sq,
                                  Skv, H, KVH, scale, causal, window, q_offset,
                                  st);
  if (dtype == 1)
    return fa_bwd_dkv_sm90(q, k, v, dout, lse, delta, dk, dv, B, Sq, Skv, H,
                           KVH, D, scale, causal, window, q_offset, st);
  return (int)cudaErrorInvalidValue;
}

// delta = rowsum(dO * O) (rows f32) from dO and O (rows x D, contiguous,
// dtype 0 = float32, 1 = bfloat16). Returns a cudaError_t (0 = launched).
extern "C" int fa_bwd_delta(const void* dout, const void* out, void* delta,
                            int64_t rows, int D, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_delta_d<float>(dout, out, delta, rows, D, st);
  if (dtype == 1)
    return launch_delta_d<__nv_bfloat16>(dout, out, delta, rows, D, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* fa_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
