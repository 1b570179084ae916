// Mamba-2 SSD intra-chunk forward for bf16 on NVIDIA Hopper (sm_90a),
// written by hand: every L x L and state product on wgmma tensor cores, x,
// B and C tiles fed by TMA, C.B^T formed once per block of heads.
//
// Replaces, for bf16 x, B, C with P = 64 and N in {64, 128}, the Pallas
// TPU kernel
//   repro/kernels/ssd/kernel.py:29  _ssd_chunk_kernel
// (f32 inputs and other widths stay on the f32 FMA kernel of ssd_fwd.cu,
// which holds the C entry of both routes). The contract is ssd_fwd.cu's:
// x (B,S,H,P) and B, C (B,S,G,N) read in place through their strides (the
// model's views of its conv output; here by TMA, so 16-byte-aligned starts
// and strides), dt (B,S,H) and A (H,) f32; per (batch, head, chunk of L
// steps, 1 <= L <= 256)
//   cum_i = sum_{k<=i} dt_k a                 (sequential f32, as ssd_fwd.cu)
//   y_i   = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//   state = sum_j x_j (x) B_j exp(cum_{L-1} - cum_j) dt_j        (P x N)
// written as y_intra (B,S,H,P), states (B,nc,H,P,N) and cum (B,S,H), f32.
// No atomics: the result is the same from run to run.
//
// Rounding points (ops._intra_chunk(..., rounded=True) is the plain version
// at these points):
//   * s = C.B^T: bf16 times bf16 is exact in the tensor cores; only the
//     f32 summation order differs from the plain version;
//   * G_ij = (s_ij exp(cum_i - cum_j)) dt_j in f32 (dt folded into G, not
//     into x), 0 where j > i or i >= L; G enters y = G x as a hi + lo pair
//     of bf16 values (~16 significant bits: split_pair), two products
//     against the exact bf16 x. One bf16 rounding of G would miss 1e-4 over
//     256 keys (it is ~2e-3 relative);
//   * the state takes x o w, w_j = exp(cum_{L-1} - cum_j) dt_j, rounded to
//     f32 once and split hi + lo, two products against the exact bf16 B;
//   * exp is the accurate expf (cum differences reach the hundreds at
//     L 256); every sum in f32.
// Emulated on the CPU over the card grid's bf16 cases: the contract moves
// no output by more than 1.7e-5 of its largest value from the f32 math
// (SSD_TOL is 1e-4).
//
// What bounds it on an H100. At the serve prefill of mamba2-2.7b (B 8,
// S 512, H 80, P 64, G 1, N 128, L 256) the function must move 172.5 MB
// (0.0515 ms at 3.35 TB/s) and do 10.9 GFLOP; at its SWAP phase 1 (B 256,
// S 64 = L) 1193.3 MB (0.3562 ms) and 27.1 GFLOP. On the tensor cores even
// two products per f32 operand are 0.03 and 0.08 ms at 989 TFLOP/s, so
// bytes bind: the f32 outputs, y and above all the P x N state of every
// head (32 KB each), are most of them. The design reads x once per row
// tile, B and C once per head block, and writes each output once.
//
// Design:
//  * A CTA is one (batch, chunk, 64-row tile i of the chunk, block of Hb
//    heads of one group: head_block() in kernel.py, 8), with NWG consumer
//    warpgroups taking the block's heads in turn (head hh to warpgroup
//    hh % NWG) and sharing its B/C tiles and score cache. The grid's
//    slowest axis is the row tile, last first: the last tile of a chunk has
//    the most key tiles and also takes the state.
//  * NWG by chunk length, each where it measured faster (ab_ssd.py, H100):
//    L <= 64 (SWAP training, the engine's short prompts) one warpgroup, two
//    CTAs an SM, which overlap each other's prologue and epilogue (0.5530
//    ms at phase 1 against 0.6814 with two); L > 64 (the serve prefill's
//    L 256) two, as its 193 KB of shared memory leave one CTA an SM and one
//    warpgroup's chain of G, split and products would run alone (0.2599 ms
//    against 0.3841).
//  * TMA: 5-D chunk maps over (D, heads, L, S/L, B) (ssd_sm90.cuh), boxes
//    of 64 columns x 64 rows with 128-byte swizzle; rows past L come in
//    zero-filled. B tiles 0..i and C tile i arrive once; x tiles of (head,
//    key tile) stream through a ring of stages(NWG) a warpgroup, refilled
//    as each is done.
//  * cum: dt of the block's heads over the rows the CTA reads, then one
//    thread per head takes the sequential sum, as ssd_fwd.cu.
//  * s_ij = C_i . B_j^T for j <= i: wgmma m64n64k16, both K-major (N/16
//    k-steps), once for the CTA's heads, warpgroup w taking j = w, w + NWG,
//    ...; each thread keeps its fragment in shared memory, in slots that
//    thread t of every warpgroup reads back, <= 64 KB at L 256.
//  * Per head, per key tile j: G from s, cum and dt on the fragment, masked
//    explicitly (j <= i < L; never exp(-inf)); y += G_hi x + G_lo x, wgmma
//    m64n64k16 with A in registers and x the MN-major B operand (as V in
//    the flash forward's P V). In the last row tile, the state product
//    too: state += (x o w)_hi^T B_j + (x o w)_lo^T B_j, m64nNk16 with A =
//    (x o w)^T in registers (read from the x tile, transposed, and scaled)
//    and B_j the MN-major B operand (LBO 8 KB along N).
//  * y (rows < L) and the state are stored from the accumulator fragments,
//    8 bytes a thread, 32-byte sectors whole.
//  * Shared memory: B 16 KB a tile (N 128) x ceil(L/64), C 16 KB, the
//    rings 32 KB (NWG 1) or 48 KB (NWG 2), the score cache 16 KB a tile, dt
//    and cum 2 Hb L floats: 87 KB at L 64 (two CTAs an SM), 209 KB at L 256
//    (one). ptxas: 251 registers (NWG 1) and 249 (NWG 2) at N 128, no
//    spills.
// Not here: a producer warp, persistent CTAs, or the next head's G formed
// while this head's products run.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ssd_sm90.cuh"

namespace {

constexpr int kXTile = kBoxBytes;                // a 64 x 64 bf16 x tile

// x ring depth a warpgroup, for NWG consumer warpgroups a CTA
__host__ __device__ constexpr int stages(int nwg) {
  return nwg == 1 ? 4 : 3;
}

size_t fwd_smem(int N, int T, int hb, int nwg) {
  const size_t b_tile = (size_t)N / kBox * kBoxBytes;
  return 1024 + (T + 1) * b_tile + (size_t)nwg * stages(nwg) * kXTile +
         (size_t)T * kTileF32 + 2 * (size_t)hb * T * kTileRows * 4 +
         8 * (1 + nwg * stages(nwg));
}

template <int N, int NWG>
__global__ void __launch_bounds__(128 * NWG, 1)
ssd_fwd_sm90_kernel(__grid_constant__ const CUtensorMap tx,
                    __grid_constant__ const CUtensorMap tb,
                    __grid_constant__ const CUtensorMap tc,
                    const float* __restrict__ dt, const float* __restrict__ A,
                    float* __restrict__ y, float* __restrict__ states,
                    float* __restrict__ cum_out, int S, int H, int G, int L,
                    int hb_size) {
  constexpr int kBTile = N / kBox * kBoxBytes;   // a 64-row tile of B or C
  constexpr int kStages = stages(NWG);
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int T = (L + kTileRows - 1) / kTileRows;
  const int ld = T * kTileRows;                  // row pitch of dt and cum
  const int rep = H / G;
  const int n_hb = (rep + hb_size - 1) / hb_size;
  const int nc = S / L;
  const int hbi = blockIdx.x % (G * n_hb);
  const int bc = blockIdx.x / (G * n_hb);
  const int b = bc / nc, c = bc % nc;
  const int g = hbi / n_hb;
  const int h0 = g * rep + (hbi % n_hb) * hb_size;
  const int nh = min(hb_size, (g + 1) * rep - h0);
  const int it = T - 1 - blockIdx.y;             // row tile, last first
  const bool last = it == T - 1;                 // takes the state
  const int nj = it + 1;                         // key tiles 0..it
  const int rows = min(L, nj * kTileRows);       // chunk rows read
  const int i0 = it * kTileRows;

  uint8_t* sB = smem;                            // [T][kBTile]
  uint8_t* sC = sB + T * kBTile;
  uint8_t* sX = sC + kBTile;                     // [wg][kStages][kXTile]
  float* sS = reinterpret_cast<float*>(sX + NWG * kStages * kXTile);
  float* sDt = sS + T * (kTileF32 / 4);          // [hb_size][ld]
  float* sCum = sDt + hb_size * ld;              // [hb_size][ld]
  uint64_t* bars = reinterpret_cast<uint64_t*>(sCum + hb_size * ld);
  const uint32_t bar_bc = smem_u32(bars);        // B and C arrived
  const int tid = threadIdx.x;
  const int wg = tid / 128;                      // heads wg, wg + 2, ...
  const int t = tid % 128;
  const int warp = t / 32;
  const int lane = t % 32;
  const int n_mine = (nh - wg + NWG - 1) / NWG;
  const int n_iter = n_mine * nj;                // (head, key tile) pairs
  uint8_t* my_x = sX + wg * kStages * kXTile;
  // [wg][kStages]: x arrived
  const uint32_t bar_x = bar_bc + 8 + 8 * kStages * wg;

  auto load_x = [&](int k) {   // iteration k's x tile into stage k % kStages
    const int s = k % kStages;
    mbar_expect_tx(bar_x + 8 * s, kXTile);
    tma_chunk_tile<kHeadDim>(my_x + s * kXTile, &tx, bar_x + 8 * s,
                             h0 + wg + NWG * (k / nj),
                             (k % nj) * kTileRows, c, b);
  };

  if (tid == 0) {
    mbar_init(bar_bc, 1);
    for (int s = 0; s < NWG * kStages; ++s)
      mbar_init(bar_bc + 8 + 8 * s, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_bc, (nj + 1) * kBTile);
    for (int j = 0; j < nj; ++j)
      tma_chunk_tile<N>(sB + j * kBTile, &tb, bar_bc, g, j * kTileRows, c, b);
    tma_chunk_tile<N>(sC, &tc, bar_bc, g, i0, c, b);
  }
  if (t == 0)
    for (int k = 0; k < min(kStages, n_iter); ++k) load_x(k);

  // dt of the block's heads over the rows read, then cum per head: one
  // thread a head, the sequential f32 sum of ssd_fwd.cu
  const int64_t row0 = (int64_t)b * S + (int64_t)c * L;   // (b, chunk start)
  for (int e = tid; e < rows * nh; e += 128 * NWG) {
    const int r = e / nh, hh = e % nh;
    sDt[hh * ld + r] = dt[(row0 + r) * H + h0 + hh];
  }
  __syncthreads();
  if (tid < nh) {
    const float a = A[h0 + tid];
    float run = 0.f;
    for (int r = 0; r < rows; ++r) {
      run = __fadd_rn(run, __fmul_rn(sDt[tid * ld + r], a));
      sCum[tid * ld + r] = run;
    }
  }
  __syncthreads();
  const int n_rows = min(kTileRows, L - i0);     // rows of this tile
  for (int e = tid; e < n_rows * nh; e += 128 * NWG) {
    const int r = e / nh, hh = e % nh;
    cum_out[(row0 + i0 + r) * H + h0 + hh] = sCum[hh * ld + i0 + r];
  }

  // s_ij = C_i . B_j^T for the key tiles j <= i, warpgroup w taking
  // j = w, w + 2, ...; thread t of either warpgroup holds the same fragment
  // slots, so each reads back what its twin thread stored
  mbar_wait(bar_bc, 0);
  const uint32_t c_addr = smem_u32(sC);
  for (int j = wg; j < nj; j += NWG) {
    float sc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] = 0.f;
    wgmma_fence();
    wgmma_tiles_abt<N>(sc, c_addr, smem_u32(sB + j * kBTile));
    wgmma_commit();
    wgmma_wait<0>();
    pin(sc);
#pragma unroll
    for (int e = 0; e < 32; ++e) sS[(j * 32 + e) * 128 + t] = sc[e];
  }
  __syncthreads();

  const int r0 = warp * 16 + lane / 4;   // fragment rows r0, r0 + 8
  const int c0 = 2 * (lane % 4);         // and columns 8q + c0 (+1)
  int k = 0;                             // (head, key tile) iteration
  for (int hh = wg; hh < nh; hh += NWG) {
    const int h = h0 + hh;
    const float* cumh = sCum + hh * ld;
    const float* dth = sDt + hh * ld;
    const float cum_last = last ? cumh[L - 1] : 0.f;
    float ci[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i0 + r0 + 8 * r;
      ci[r] = i < L ? cumh[i] : 0.f;
    }
    float acc[32];                       // y of the row tile (m64n64)
    float st[N / 2];                     // the state (last row tile)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.f;
#pragma unroll
    for (int e = 0; e < N / 2; ++e) st[e] = 0.f;

    for (int j = 0; j < nj; ++j, ++k) {
      const int s = k % kStages;
      const int j0 = j * kTileRows;
      // G = (s o seg) o dt_j on j <= i < L, else 0; gv[4q + 2r + e] is row
      // r0 + 8r, key 8q + c0 + e
      float gv[32];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + r0 + 8 * (e >> 1);
          const int jj = j0 + 8 * q + c0 + (e & 1);
          const float sv = sS[(j * 32 + 4 * q + e) * 128 + t];
          gv[4 * q + e] =
              jj <= i && i < L
                  ? sv * expf(ci[e >> 1] - cumh[jj]) * dth[jj]
                  : 0.f;
        }
      }
      uint32_t ghi[4][4], glo[4][4];
      to_split_frags(gv, ghi, glo);

      mbar_wait(bar_x + 8 * s, (k / kStages) & 1);
      const uint8_t* xt = my_x + s * kXTile;
      const uint32_t x_addr = smem_u32(xt);
      // the state's A = (x o w)^T: rows p, k-columns the keys of tile j;
      // a[kk][2 half + r] holds p = r0 + 8r, keys 16kk + 8 half + c0 (+1)
      uint32_t whi[4][4], wlo[4][4];
      if (last) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float w[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int jj = j0 + 16 * kk + 8 * half + c0 + e;
              w[e] = jj < L ? expf(cum_last - cumh[jj]) * dth[jj] : 0.f;
            }
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int p = r0 + 8 * r;
              const int jl = 16 * kk + 8 * half + c0;
              split_pair(tile_bf16(xt, jl, p) * w[0],
                         tile_bf16(xt, jl + 1, p) * w[1],
                         whi[kk][2 * half + r], wlo[kk][2 * half + r]);
            }
          }
        }
      }

      wgmma_fence();
      wgmma_frags_b<kHeadDim>(acc, ghi, x_addr);
      wgmma_frags_b<kHeadDim>(acc, glo, x_addr);
      if (last) {
        const uint32_t b_addr = smem_u32(sB + j * kBTile);
        wgmma_frags_b<N>(st, whi, b_addr);
        wgmma_frags_b<N>(st, wlo, b_addr);
      }
      wgmma_commit();
      wgmma_wait<0>();
      pin(acc);
      pin(st);
      pin(ghi);
      pin(glo);
      pin(whi);
      pin(wlo);

      // every warp is done with stage s: refill it
      warpgroup_sync(wg);
      if (t == 0 && k + kStages < n_iter) load_x(k + kStages);
    }

    // y of the tile's rows < L, and the state, from the fragments
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i0 + r0 + 8 * r;
      if (i >= L) continue;
      float* yr = y + ((row0 + i) * H + h) * kHeadDim;
#pragma unroll
      for (int q = 0; q < 8; ++q)
        *reinterpret_cast<float2*>(yr + 8 * q + c0) =
            make_float2(acc[4 * q + 2 * r], acc[4 * q + 2 * r + 1]);
    }
    if (last) {
      float* sb = states + (((int64_t)b * nc + c) * H + h) * kHeadDim * N;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = r0 + 8 * r;
#pragma unroll
        for (int q = 0; q < N / 8; ++q)
          *reinterpret_cast<float2*>(sb + p * N + 8 * q + c0) =
              make_float2(st[4 * q + 2 * r], st[4 * q + 2 * r + 1]);
      }
    }
  }
}

template <int N, int NWG>
cudaError_t launch(const CUtensorMap& tx, const CUtensorMap& tb,
                   const CUtensorMap& tc, const float* dt, const float* A,
                   float* y, float* states, float* cum, int batch, int S,
                   int H, int G, int L, int hb, cudaStream_t stream) {
  const int T = (L + kTileRows - 1) / kTileRows;
  const size_t smem = fwd_smem(N, T, hb, NWG);
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd_sm90_kernel<N, NWG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_hb = (H / G + hb - 1) / hb;
  const dim3 grid((unsigned)((int64_t)batch * (S / L) * G * n_hb), T);
  ssd_fwd_sm90_kernel<N, NWG><<<grid, 128 * NWG, smem, stream>>>(
      tx, tb, tc, dt, A, y, states, cum, S, H, G, L, hb);
  return cudaGetLastError();
}

}  // namespace

// The bf16 route of ssd_fwd (ssd_fwd.cu): P = 64, N in {64, 128}, hb heads
// of a group a CTA; st: the nine element strides of x, B and C. Returns a
// cudaError_t.
cudaError_t ssd_fwd_sm90(const void* x, const float* dt, const float* A,
                         const void* Bm, const void* Cm, float* y,
                         float* states, float* cum, int batch, int S, int H,
                         int P, int G, int N, int L, int hb,
                         const long long* st, cudaStream_t stream) {
  const int nc = S / L;
  const int T = (L + kTileRows - 1) / kTileRows;
  const int nwg = T == 1 ? 1 : 2;        // see the header: Design
  if (P != kHeadDim || (N != 64 && N != 128) || hb < 1 ||
      (int64_t)batch * nc * G * ((H / G + hb - 1) / hb) > 0x7fffffff ||
      fwd_smem(N, T, hb, nwg) > 232448)
    return cudaErrorInvalidValue;
  CUtensorMap tx, tb, tc;
  if (!encode_chunks_bf16(&tx, x, P, H, L, nc, batch, st[0], st[1], st[2]) ||
      !encode_chunks_bf16(&tb, Bm, N, G, L, nc, batch, st[3], st[4], st[5]) ||
      !encode_chunks_bf16(&tc, Cm, N, G, L, nc, batch, st[6], st[7], st[8]))
    return cudaErrorInvalidValue;
  auto go = [&](auto kernel_launch) {
    return kernel_launch(tx, tb, tc, dt, A, y, states, cum, batch, S, H, G, L,
                         hb, stream);
  };
  if (N == 64)
    return nwg == 1 ? go(launch<64, 1>) : go(launch<64, 2>);
  return nwg == 1 ? go(launch<128, 1>) : go(launch<128, 2>);
}
