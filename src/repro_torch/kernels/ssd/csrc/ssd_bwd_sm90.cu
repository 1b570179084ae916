// Mamba-2 SSD intra-chunk backward for bf16 on NVIDIA Hopper (sm_90a),
// written by hand: every L x L and state product on wgmma tensor cores, x,
// B, C (and the f32 cotangents dy, dS) fed by TMA, and what depends on the
// group alone (B.C^T, dB, dC) formed once per block of heads.
//
// Replaces, for bf16 x, B, C with P = 64 and N in {64, 128}, the Pallas
// TPU kernel
//   repro/kernels/ssd/kernel.py:61  _ssd_chunk_bwd_kernel
// (f32 inputs and other widths stay on the f32 FMA kernel of ssd_bwd.cu,
// which holds the C entry of both routes). It computes what ssd_bwd.cu
// computes (the formulas in its header) from the cotangents dy (B,S,H,P),
// dS (B,nc,H,P,N) and dcum (B,S,H), all f32, with x, B, C read in place
// through their strides by TMA, and L any length from 1 to 256. dx, ddt and
// da (B,H,nc) are written per head; dB and dC once per (batch, chunk,
// group, head block) into (parts, B, S, G, N), which the wrapper sums over
// the parts (H / G / Hb of them; none to sum when one block covers the
// group). No atomics: the result is the same from run to run.
//
// dB and dC are sums over the group's heads, so they are taken on the
// head block's sums: with M = sum_h (dG_h o seg_h) and the state term
// SX = sum_h (w_h o x_h) dS_h,
//   dC = M B,   dB = M^T C + SX,
// two products a block instead of two a head.
//
// Rounding points (ops._intra_chunk_bwd(..., rounded=True) is the plain
// version at these points): bf16 x, B, C are exact in the tensor cores;
// every f32 operand enters its product as a hi + lo pair of bf16 values
// (split_pair, ~16 significant bits): two products where the partner is
// exact, three (hi.hi + hi.lo + lo.hi) where both are f32:
//   dG^T = (x dy_hi^T + x dy_lo^T) o dt_j      dy split;
//   d_dx = G^T dy                              G = (C.B^T) o seg and dy
//                                              split: three products;
//   dS_b = B dS_hi^T + B dS_lo^T               dS split;
//   SX  += (w o x) dS                          both split: three products;
//   dB   = M_hi^T C + M_lo^T C + SX,  dC = M_hi B + M_lo B
//                                              M summed in f32 over the
//                                              block's heads, then split;
// everything else (seg = expf(cum_i - cum_j), E = dG o G, the row and
// column sums, dx, ddt, the reverse cumsum, da) in f32 as ssd_bwd.cu. cum
// is recomputed from dt and a as the sequential f32 sum of ssd_fwd.cu.
// Emulated on the CPU over the card grid's bf16 cases (ssd_rounding.py):
// the contract moves no output by more than 4.0e-5 of its largest value
// from the f32 math (SSD_TOL is 1e-4).
//
// What bounds it on an H100. At mamba2-2.7b's SWAP phase 1 (B 256, S 64 =
// L, H 80, P 64, G 1, N 128) the function must move 1550.8 MB (0.4629 ms
// at 3.35 TB/s): dS (671 MB), dy and dx (168 MB each) dominate. It needs
// 54.3 GFLOP; three products per f32 product on the tensor cores are 0.16
// ms at 989 TFLOP/s, so bytes bind. The design reads each cotangent once
// and writes dB and dC once per head block (the FMA kernel wrote them per
// head, 2 x 671 MB, and the wrapper read them back to sum them).
//
// Design (built for the training path's single 64 x 64 tile a chunk;
// longer chunks are right, not fast):
//  * A CTA is one (batch, chunk, block of Hb heads of one group:
//    head_block() in kernel.py, 16 / ceil(L/64)), one warpgroup. The
//    products are taken transposed, rows j (keys) and columns i (rows of
//    y), as the flash dK/dV kernel (flash_bwd_sm90.cu) takes them, so that
//    each register-A product takes an accumulator fragment as it lies.
//  * For each key tile jt (one at L <= 64): B_jt arrives by TMA; for each
//    row tile it >= jt, s^T = B_jt C_it^T (wgmma, K-major, N/16 k-steps)
//    is formed once for the block, each thread's fragment kept in its own
//    slots of a cache (shared memory at L <= 64, else a global scratch the
//    wrapper allocates), and the M tile zeroed beside it.
//  * Then per head, per row tile it >= jt (a ring of two stages holds x_jt
//    as bf16 and dy_it as a plain f32 box, both by TMA): dy is split into
//    hi and lo bf16 tiles in shared memory; dG^T (SS); on the fragment,
//    G^T = s^T o seg, dG^T o dt_j, both 0 where masked (j > i or i >= L,
//    never exp(-inf)), E = dG o G (its column sums reduce over the four
//    lanes of a row, its row sums over lanes and then the four warps in
//    shared memory, in a fixed order), M += dG o seg (the thread's own
//    slots); d_dx += G^T dy (RS, m64n64, dy hi/lo the MN-major B).
//  * The state terms of (jt, head): dS arrives by TMA (one f32 buffer, the
//    next head's copy issued as soon as this one is split) and is split
//    into hi and lo tiles [p][n]; dS_b (SS, dS K-major) and SX (RS,
//    m64nN, A = (w o x) read from the x tile and scaled, dS MN-major); then
//    dw, rowsum(d_dx o x), dx = w dS_b + dt d_dx (stored from the
//    fragment), and each head's dcum and ddt terms into shared arrays.
//  * After the heads: dB_jt = SX + M^T C (RS, M split from the cache), and
//    dC_it += M B_jt (SS with both operands MN-major: M^T staged as hi and
//    lo tiles); dC rows of tile it are stored at jt = 0 and added to after.
//  * At the end one thread a head runs the reverse cumsum over L into ddt
//    and da, in the order of ssd_bwd.cu.
//  * Shared memory at L <= 64, N 128, Hb 16: B, C 16 KB each, the ring
//    2 x (8 + 16) KB, dS 32 KB, the hi/lo tiles 16 + 32 KB, the two caches
//    32 KB, the per-head arrays 24 KB: 218 KB, one CTA an SM; the dS copy of
//    the next head and the next stage are in flight while a head computes.
// Not here: a producer warp, two consumer warpgroups, persistent CTAs.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ssd_sm90.cuh"

namespace {

constexpr int kStages = 2;                       // x / dy ring depth
constexpr int kXTile = kBoxBytes;                // 64 x 64 bf16
constexpr int kDyTile = kTileF32;                // 64 x 64 f32
constexpr int kCacheFloats = kTileF32 / 4;       // one 64 x 64 f32 tile
constexpr int kArrays = 6;                       // per-head [Hb][ld] arrays

size_t bwd_smem(int N, int T, int hb) {
  const size_t b_tile = (size_t)N / kBox * kBoxBytes;
  return 1024 + 2 * b_tile + kStages * (kXTile + kDyTile) +
         (size_t)N * kTileRows * 4 + 2 * kXTile + 2 * b_tile +
         (T == 1 ? 2 * (size_t)kTileF32 : 0) +
         (size_t)kArrays * hb * T * kTileRows * 4 + 4 * kTileRows * 4 +
         8 * (3 + kStages);
}

template <int N>
__global__ void __launch_bounds__(128, 1)
ssd_bwd_sm90_kernel(__grid_constant__ const CUtensorMap tx,
                    __grid_constant__ const CUtensorMap tb,
                    __grid_constant__ const CUtensorMap tc,
                    __grid_constant__ const CUtensorMap tdy,
                    __grid_constant__ const CUtensorMap tds,
                    const float* __restrict__ dt, const float* __restrict__ A,
                    const float* __restrict__ dcum, float* __restrict__ dx,
                    float* __restrict__ ddt, float* __restrict__ db,
                    float* __restrict__ dc, float* __restrict__ da,
                    float* __restrict__ scratch, int batch, int S, int H,
                    int G, int L, int hb_size) {
  constexpr int kBTile = N / kBox * kBoxBytes;   // a 64-row tile of B or C
  constexpr int kDsBytes = N * kTileRows * 4;    // dS f32, [p][n]
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int T = (L + kTileRows - 1) / kTileRows;
  const int ld = T * kTileRows;                  // pitch of the [Hb] arrays
  const int rep = H / G;
  const int n_hb = (rep + hb_size - 1) / hb_size;
  const int nc = S / L;
  const int hbi = blockIdx.x % (G * n_hb);
  const int bc = blockIdx.x / (G * n_hb);
  const int b = bc / nc, c = bc % nc;
  const int g = hbi / n_hb;
  const int part = hbi % n_hb;                   // dB / dC partial
  const int h0 = g * rep + part * hb_size;
  const int nh = min(hb_size, (g + 1) * rep - h0);

  uint8_t* sB = smem;                            // B_jt, K- and MN-major
  uint8_t* sC = sB + kBTile;                     // C_it
  uint8_t* sX = sC + kBTile;                     // [kStages] x_jt
  uint8_t* sDy = sX + kStages * kXTile;          // [kStages] dy_it f32
  uint8_t* sDs = sDy + kStages * kDyTile;        // dS f32 [p][n]
  uint8_t* sDyH = sDs + kDsBytes;                // dy hi/lo [i][p]; M^T
  uint8_t* sDyL = sDyH + kXTile;                 // hi/lo [j][i] for dC
  uint8_t* sDsH = sDyL + kXTile;                 // dS hi/lo [p][n]
  uint8_t* sDsL = sDsH + kBTile;
  float* sCache = reinterpret_cast<float*>(sDsL + kBTile);  // T == 1 only
  float* sArr = sCache + (T == 1 ? 2 * kCacheFloats : 0);
  float* sDt = sArr;                             // dt [Hb][ld]
  float* sCum = sDt + hb_size * ld;              // cum
  float* sDc = sCum + hb_size * ld;              // dcum - colsum(E) - dw w
  float* sRowE = sDc + hb_size * ld;             // rowsum(E)
  float* sDdt = sRowE + hb_size * ld;            // dw wexp + rowsum(d_dx x)
  float* sDww = sDdt + hb_size * ld;             // dw w
  float* sRed = sDww + hb_size * ld;             // [4 warps][64]
  uint64_t* bars = reinterpret_cast<uint64_t*>(sRed + 4 * kTileRows);
  const uint32_t bar_b = smem_u32(bars);         // B_jt arrived
  const uint32_t bar_c = bar_b + 8;              // C_it arrived
  const uint32_t bar_ds = bar_b + 16;            // dS arrived
  const uint32_t bar_st = bar_b + 24;            // [kStages]: x, dy arrived

  // score and M caches: tile t, fragment slot e of thread tid at
  // (t * 32 + e) * 128 + tid; shared memory for one tile, else the CTA's
  // slice of the scratch
  float* cache_s = T == 1 ? sCache
                          : scratch + (int64_t)blockIdx.x * 2 * T *
                                          kCacheFloats;
  float* cache_m = cache_s + T * kCacheFloats;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int64_t row0 = (int64_t)b * S + (int64_t)c * L;  // (b, chunk start)
  const int n_iter = nh * T * (T + 1) / 2;       // (jt, head, it >= jt)
  const int n_ds = nh * T;                       // (jt, head)

  auto issue_stage = [&](int k) {   // iteration k's x_jt and dy_it
    const int s = k % kStages;
    int r = k, jt = 0;
    while (r >= nh * (T - jt)) r -= nh * (T - jt++);
    const int hh = r / (T - jt), it = jt + r % (T - jt);
    mbar_expect_tx(bar_st + 8 * s, kXTile + kDyTile);
    tma_chunk_tile<kHeadDim>(sX + s * kXTile, &tx, bar_st + 8 * s, h0 + hh,
                             jt * kTileRows, c, b);
    tma_load5(smem_u32(sDy + s * kDyTile), &tdy, bar_st + 8 * s, 0, h0 + hh,
              it * kTileRows, c, b);
  };
  auto issue_ds = [&](int q) {     // (jt, head) q's dS: head q % nh
    mbar_expect_tx(bar_ds, kDsBytes);
    tma_load5(smem_u32(sDs), &tds, bar_ds, 0, 0, h0 + q % nh, c, b);
  };
  auto issue_c = [&](int it) {
    mbar_expect_tx(bar_c, kBTile);
    tma_chunk_tile<N>(sC, &tc, bar_c, g, it * kTileRows, c, b);
  };

  if (tid == 0) {
    mbar_init(bar_b, 1);
    mbar_init(bar_c, 1);
    mbar_init(bar_ds, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(bar_st + 8 * s, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    for (int k = 0; k < min(kStages, n_iter); ++k) issue_stage(k);
    issue_ds(0);
  }

  // dt and dcum of the block's heads over the chunk; cum per head, the
  // sequential f32 sum of ssd_fwd.cu
  for (int e = tid; e < L * nh; e += 128) {
    const int r = e / nh, hh = e % nh;
    const int64_t at = (row0 + r) * H + h0 + hh;
    sDt[hh * ld + r] = dt[at];
    sDc[hh * ld + r] = dcum[at];
    sRowE[hh * ld + r] = 0.f;
  }
  __syncthreads();
  if (tid < nh) {
    const float a = A[h0 + tid];
    float run = 0.f;
    for (int r = 0; r < L; ++r) {
      run = __fadd_rn(run, __fmul_rn(sDt[tid * ld + r], a));
      sCum[tid * ld + r] = run;
    }
  }
  __syncthreads();

  const int r0 = warp * 16 + lane / 4;   // fragment rows r0, r0 + 8
  const int c0 = 2 * (lane % 4);         // and columns 8q + c0 (+1)
  const uint32_t b_addr = smem_u32(sB);
  const uint32_t c_addr = smem_u32(sC);
  const uint32_t dyh_addr = smem_u32(sDyH);
  const uint32_t dyl_addr = smem_u32(sDyL);
  const uint32_t dsh_addr = smem_u32(sDsH);
  const uint32_t dsl_addr = smem_u32(sDsL);
  const int64_t pstride = (int64_t)batch * S * G * N;   // between parts
  int n_c = 0;                           // C copies so far (barrier parity)
  int k = 0;                             // stage iteration
  int q = 0;                             // dS copy

  for (int jt = 0; jt < T; ++jt) {
    const int j0 = jt * kTileRows;
    const int n_it = T - jt;             // row tiles it >= jt
    if (tid == 0) {
      mbar_expect_tx(bar_b, kBTile);
      tma_chunk_tile<N>(sB, &tb, bar_b, g, j0, c, b);
    }
    mbar_wait(bar_b, jt & 1);

    // s^T_{jt,it} = B_jt C_it^T once for the block; M tiles zeroed
    for (int t = 0; t < n_it; ++t) {
      if (T > 1 || jt == 0) {
        if (tid == 0) issue_c(jt + t);
        mbar_wait(bar_c, n_c++ & 1);
      }
      float st[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) st[e] = 0.f;
      wgmma_fence();
      wgmma_tiles_abt<N>(st, b_addr, c_addr);
      wgmma_commit();
      wgmma_wait<0>();
      pin(st);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        cache_s[(t * 32 + e) * 128 + tid] = st[e];
        cache_m[(t * 32 + e) * 128 + tid] = 0.f;
      }
      warpgroup_sync(0);                 // every warp is done with C_it
    }

    float sx[N / 2];                     // SX, then dB_jt (m64nN)
#pragma unroll
    for (int e = 0; e < N / 2; ++e) sx[e] = 0.f;

    for (int hh = 0; hh < nh; ++hh) {
      const int h = h0 + hh;
      const float* cumh = sCum + hh * ld;
      const float* dth = sDt + hh * ld;
      float cj[2], dtj[2];               // this thread's key rows
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = j0 + r0 + 8 * r;
        cj[r] = j < L ? cumh[j] : 0.f;
        dtj[r] = j < L ? dth[j] : 0.f;
      }
      float d_dx[32];                    // G^T dy, rows j, columns p
#pragma unroll
      for (int e = 0; e < 32; ++e) d_dx[e] = 0.f;
      int s = 0;

      for (int t = 0; t < n_it; ++t, ++k) {
        const int i0 = (jt + t) * kTileRows;
        s = k % kStages;
        mbar_wait(bar_st + 8 * s, (k / kStages) & 1);
        split_tile<kHeadDim>(reinterpret_cast<const float*>(sDy + s * kDyTile),
                             sDyH, sDyL, tid, 128);
        warpgroup_sync(0);               // dy hi and lo in place
        const uint32_t x_addr = smem_u32(sX + s * kXTile);

        // dG^T = x_jt dy_it^T, dy as hi + lo
        float dg[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) dg[e] = 0.f;
        wgmma_fence();
        wgmma_tiles_abt<kHeadDim>(dg, x_addr, dyh_addr);
        wgmma_tiles_abt_acc<kHeadDim>(dg, x_addr, dyl_addr);
        wgmma_commit();
        wgmma_wait<0>();
        pin(dg);

        // the fragment: element 4q + 2r + e is key j = j0 + r0 + 8r, row
        // i = i0 + 8q + c0 + e
        float* cs = cache_s + t * 32 * 128 + tid;
        float* cm = cache_m + t * 32 * 128 + tid;
        float gv[32];
        float col_e[16];                 // E summed over this thread's keys
        float row_e[2] = {0.f, 0.f};     // E summed over this thread's rows
#pragma unroll
        for (int qq = 0; qq < 8; ++qq) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = i0 + 8 * qq + c0 + e;
            const float ci = i < L ? cumh[i] : 0.f;
            float esum = 0.f;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int idx = 4 * qq + 2 * r + e;
              const int j = j0 + r0 + 8 * r;
              const bool on = j <= i && i < L;
              const float seg = on ? expf(ci - cj[r]) : 0.f;
              const float gt = cs[idx * 128] * seg;
              const float dgv = on ? dg[idx] * dtj[r] : 0.f;
              const float ev = dgv * gt;
              cm[idx * 128] += dgv * seg;
              gv[idx] = gt;
              esum += ev;
              row_e[r] += ev;
            }
            col_e[2 * qq + e] = esum;
          }
        }
        // colsum(E)_j (over rows i): the four lanes of a key row
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          row_e[r] += __shfl_xor_sync(0xffffffffu, row_e[r], 1);
          row_e[r] += __shfl_xor_sync(0xffffffffu, row_e[r], 2);
          const int j = j0 + r0 + 8 * r;
          if (lane % 4 == 0 && j < L) sDc[hh * ld + j] -= row_e[r];
        }
        // rowsum(E)_i (over keys j): the eight lane rows, then the warps
#pragma unroll
        for (int v = 0; v < 16; ++v) {
          col_e[v] += __shfl_xor_sync(0xffffffffu, col_e[v], 4);
          col_e[v] += __shfl_xor_sync(0xffffffffu, col_e[v], 8);
          col_e[v] += __shfl_xor_sync(0xffffffffu, col_e[v], 16);
        }
        if (lane < 4) {
#pragma unroll
          for (int v = 0; v < 16; ++v)
            sRed[warp * kTileRows + 8 * (v / 2) + c0 + (v % 2)] = col_e[v];
        }

        // d_dx += G^T dy: three products
        uint32_t ghi[4][4], glo[4][4];
        to_split_frags(gv, ghi, glo);
        wgmma_fence();
        wgmma_frags_b<kHeadDim>(d_dx, ghi, dyh_addr);
        wgmma_frags_b<kHeadDim>(d_dx, ghi, dyl_addr);
        wgmma_frags_b<kHeadDim>(d_dx, glo, dyh_addr);
        wgmma_commit();
        warpgroup_sync(0);               // sRed written
        if (tid < kTileRows && i0 + tid < L)
          sRowE[hh * ld + i0 + tid] +=
              ((sRed[tid] + sRed[kTileRows + tid]) + sRed[2 * kTileRows + tid]) +
              sRed[3 * kTileRows + tid];
        wgmma_wait<0>();
        pin(d_dx);
        pin(ghi);
        pin(glo);
        if (t + 1 < n_it) {              // the last stage serves the state
          warpgroup_sync(0);             // every warp is done with stage s
          if (tid == 0 && k + kStages < n_iter) issue_stage(k + kStages);
        }
      }

      // ---- state terms of (jt, head) ----
      mbar_wait(bar_ds, q & 1);
      split_tile<N>(reinterpret_cast<const float*>(sDs), sDsH, sDsL, tid, 128);
      warpgroup_sync(0);                 // dS hi and lo in place, f32 read
      if (tid == 0 && q + 1 < n_ds) issue_ds(q + 1);
      ++q;

      // x of this thread's fragment positions (rows j, columns 8qq + c0, +1)
      // from the stage of the head's last iteration, and w, wexp of its rows
      const uint8_t* xt = sX + s * kXTile;
      const uint32_t x_addr = smem_u32(xt);
      float w[2], wexp[2];
      uint32_t xr[8][2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int jl = r0 + 8 * r, j = j0 + jl;
        wexp[r] = j < L ? expf(cumh[L - 1] - cj[r]) : 0.f;
        w[r] = wexp[r] * dtj[r];
#pragma unroll
        for (int qq = 0; qq < 8; ++qq)
          xr[qq][r] = *reinterpret_cast<const uint32_t*>(
              xt + jl * kSwizzleRow + ((qq ^ (jl & 7)) << 4) + c0 * 2);
      }
      // (w o x) as the A fragments of SX: k-step kk, a[2 half + r] holds
      // row r0 + 8r, columns 16kk + 8 half + c0 (+1)
      uint32_t whi[4][4], wlo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float2 xv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&xr[2 * kk + half][r]));
            split_pair(xv.x * w[r], xv.y * w[r], whi[kk][2 * half + r],
                       wlo[kk][2 * half + r]);
          }
        }
      }
      float dsb[32];                     // dS_b = B dS^T, rows j, columns p
#pragma unroll
      for (int e = 0; e < 32; ++e) dsb[e] = 0.f;
      wgmma_fence();
      wgmma_tiles_abt<N>(dsb, b_addr, dsh_addr);
      wgmma_tiles_abt_acc<N>(dsb, b_addr, dsl_addr);
      wgmma_frags_b<N>(sx, whi, dsh_addr);
      wgmma_frags_b<N>(sx, whi, dsl_addr);
      wgmma_frags_b<N>(sx, wlo, dsh_addr);
      wgmma_commit();
      wgmma_wait<0>();
      pin(dsb);
      pin(sx);
      pin(whi);
      pin(wlo);

      // dw_j = sum_p x dS_b, rowsum(d_dx o x); dx = w dS_b + dt d_dx
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = j0 + r0 + 8 * r;
        float pw = 0.f, px = 0.f;
#pragma unroll
        for (int qq = 0; qq < 8; ++qq) {
          const float2 xv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&xr[qq][r]));
          pw = fmaf(xv.x, dsb[4 * qq + 2 * r], pw);
          pw = fmaf(xv.y, dsb[4 * qq + 2 * r + 1], pw);
          px = fmaf(d_dx[4 * qq + 2 * r], xv.x, px);
          px = fmaf(d_dx[4 * qq + 2 * r + 1], xv.y, px);
        }
        pw += __shfl_xor_sync(0xffffffffu, pw, 1);
        pw += __shfl_xor_sync(0xffffffffu, pw, 2);
        px += __shfl_xor_sync(0xffffffffu, px, 1);
        px += __shfl_xor_sync(0xffffffffu, px, 2);
        if (j >= L) continue;
        float* dxr = dx + ((row0 + j) * H + h) * kHeadDim;
#pragma unroll
        for (int qq = 0; qq < 8; ++qq)
          *reinterpret_cast<float2*>(dxr + 8 * qq + c0) = make_float2(
              w[r] * dsb[4 * qq + 2 * r] + dtj[r] * d_dx[4 * qq + 2 * r],
              w[r] * dsb[4 * qq + 2 * r + 1] +
                  dtj[r] * d_dx[4 * qq + 2 * r + 1]);
        if (lane % 4 == 0) {
          sDdt[hh * ld + j] = pw * wexp[r] + px;
          sDc[hh * ld + j] -= pw * w[r];
          sDww[hh * ld + j] = pw * w[r];
        }
      }
      // every warp is done with the head's last stage and the dS tiles
      warpgroup_sync(0);
      if (tid == 0 && k - 1 + kStages < n_iter) issue_stage(k - 1 + kStages);
    }

    // ---- dB_jt = SX + M^T C, dC_it (+)= M B_jt, for it >= jt ----
    for (int t = 0; t < n_it; ++t) {
      const int i0 = (jt + t) * kTileRows;
      if (T > 1) {
        if (tid == 0) issue_c(jt + t);
        mbar_wait(bar_c, n_c++ & 1);
      }
      float mt[32];                      // M^T tile: rows j, columns i
#pragma unroll
      for (int e = 0; e < 32; ++e) mt[e] = cache_m[(t * 32 + e) * 128 + tid];
      uint32_t mhi[4][4], mlo[4][4];
      to_split_frags(mt, mhi, mlo);
      stage_split(sDyH, sDyL, mt, warp, lane);
      fence_proxy_async();
      warpgroup_sync(0);                 // M^T hi and lo tiles in place
      float dca[N / 2];                  // dC rows i of tile it
#pragma unroll
      for (int e = 0; e < N / 2; ++e) dca[e] = 0.f;
      wgmma_fence();
      wgmma_frags_b<N>(sx, mhi, c_addr);
      wgmma_frags_b<N>(sx, mlo, c_addr);
      wgmma_tiles_tt<N>(dca, dyh_addr, b_addr, 0);
      wgmma_tiles_tt<N>(dca, dyl_addr, b_addr, 1);
      wgmma_commit();
      wgmma_wait<0>();
      pin(sx);
      pin(dca);
      pin(mhi);
      pin(mlo);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = i0 + r0 + 8 * r;
        if (i >= L) continue;
        float* dcr = dc + part * pstride + ((row0 + i) * G + g) * N;
#pragma unroll
        for (int qq = 0; qq < N / 8; ++qq) {
          float2 v = make_float2(dca[4 * qq + 2 * r], dca[4 * qq + 2 * r + 1]);
          float2* at = reinterpret_cast<float2*>(dcr + 8 * qq + c0);
          if (jt > 0) {
            const float2 old = *at;
            v.x += old.x;
            v.y += old.y;
          }
          *at = v;
        }
      }
      warpgroup_sync(0);                 // done with C_it and the M^T tiles
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = j0 + r0 + 8 * r;
      if (j >= L) continue;
      float* dbr = db + part * pstride + ((row0 + j) * G + g) * N;
#pragma unroll
      for (int qq = 0; qq < N / 8; ++qq)
        *reinterpret_cast<float2*>(dbr + 8 * qq + c0) =
            make_float2(sx[4 * qq + 2 * r], sx[4 * qq + 2 * r + 1]);
    }
    warpgroup_sync(0);                   // every warp is done with B_jt
  }

  // ---- reverse cumsum of dcum into ddt and da, one thread a head ----
  __syncthreads();
  if (tid < nh) {
    const int h = h0 + tid;
    const float a = A[h];
    const float* dth = sDt + tid * ld;
    float total = 0.f;
    for (int r = 0; r < L; ++r) total += sDww[tid * ld + r];
    float rev = 0.f, dacc = 0.f;
    for (int r = L - 1; r >= 0; --r) {
      float d = sDc[tid * ld + r] + sRowE[tid * ld + r];
      if (r == L - 1) d += total;
      rev += d;
      ddt[(row0 + r) * H + h] = sDdt[tid * ld + r] + a * rev;
      dacc = fmaf(dth[r], rev, dacc);
    }
    da[((int64_t)b * H + h) * nc + c] = dacc;
  }
}

struct Maps {
  CUtensorMap x, b, c, dy, ds;
};

template <int N>
cudaError_t launch(const Maps& m, const float* dt, const float* A,
                   const float* dcum, float* dx, float* ddt, float* db,
                   float* dc, float* da, float* scratch, int batch, int S,
                   int H, int G, int L, int hb, cudaStream_t stream) {
  const int T = (L + kTileRows - 1) / kTileRows;
  const size_t smem = bwd_smem(N, T, hb);
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_sm90_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int n_hb = (H / G + hb - 1) / hb;
  const dim3 grid((unsigned)((int64_t)batch * (S / L) * G * n_hb));
  ssd_bwd_sm90_kernel<N><<<grid, 128, smem, stream>>>(
      m.x, m.b, m.c, m.dy, m.ds, dt, A, dcum, dx, ddt, db, dc, da, scratch,
      batch, S, H, G, L, hb);
  return cudaGetLastError();
}

}  // namespace

// The bf16 route of ssd_bwd (ssd_bwd.cu): P = 64, N in {64, 128}, hb heads
// of a group a CTA; db, dc: (parts, B, S, G, N) with parts = ceil(H/G/hb);
// scratch: for L > 64, 2 ceil(L/64) 4096 floats a CTA; st: the nine
// element strides of x, B and C. Returns a cudaError_t.
cudaError_t ssd_bwd_sm90(const void* x, const float* dt, const float* A,
                         const void* Bm, const void* Cm, const float* dy,
                         const float* dstates, const float* dcum, float* dx,
                         float* ddt, float* db, float* dc, float* da,
                         float* scratch, int batch, int S, int H, int P, int G,
                         int N, int L, int hb, const long long* st,
                         cudaStream_t stream) {
  const int nc = S / L;
  const int T = (L + kTileRows - 1) / kTileRows;
  if (P != kHeadDim || (N != 64 && N != 128) || hb < 1 ||
      (T > 1 && scratch == nullptr) ||
      (int64_t)batch * nc * G * ((H / G + hb - 1) / hb) > 0x7fffffff ||
      bwd_smem(N, T, hb) > 232448)
    return cudaErrorInvalidValue;
  Maps m;
  // dy (B,S,H,P) f32 in plain boxes of 64 x 64; dS (B,nc,H,P,N) f32 in
  // boxes of one head's P x N
  const cuuint64_t dy_dims[5] = {(cuuint64_t)P, (cuuint64_t)H, (cuuint64_t)L,
                                 (cuuint64_t)nc, (cuuint64_t)batch};
  const cuuint64_t dy_strides[4] = {
      (cuuint64_t)P * 4, (cuuint64_t)H * P * 4, (cuuint64_t)L * H * P * 4,
      (cuuint64_t)S * H * P * 4};
  const cuuint32_t dy_box[5] = {(cuuint32_t)P, 1, kTileRows, 1, 1};
  const cuuint64_t ds_dims[5] = {(cuuint64_t)N, (cuuint64_t)P, (cuuint64_t)H,
                                 (cuuint64_t)nc, (cuuint64_t)batch};
  const cuuint64_t ds_strides[4] = {
      (cuuint64_t)N * 4, (cuuint64_t)P * N * 4, (cuuint64_t)H * P * N * 4,
      (cuuint64_t)nc * H * P * N * 4};
  const cuuint32_t ds_box[5] = {(cuuint32_t)N, (cuuint32_t)P, 1, 1, 1};
  if (!encode_chunks_bf16(&m.x, x, P, H, L, nc, batch, st[0], st[1], st[2]) ||
      !encode_chunks_bf16(&m.b, Bm, N, G, L, nc, batch, st[3], st[4],
                          st[5]) ||
      !encode_chunks_bf16(&m.c, Cm, N, G, L, nc, batch, st[6], st[7],
                          st[8]) ||
      !encode_map(&m.dy, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, dy, 5, dy_dims,
                  dy_strides, dy_box, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !encode_map(&m.ds, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, dstates, 5, ds_dims,
                  ds_strides, ds_box, CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  if (N == 64)
    return launch<64>(m, dt, A, dcum, dx, ddt, db, dc, da, scratch, batch, S,
                      H, G, L, hb, stream);
  return launch<128>(m, dt, A, dcum, dx, ddt, db, dc, da, scratch, batch, S,
                     H, G, L, hb, stream);
}
