// Flash-attention forward for bf16 on NVIDIA Hopper (sm_90a), written by
// hand: both products on wgmma tensor cores, Q/K/V tiles fed by TMA.
//
// Replaces, for bf16 inputs, the Pallas TPU kernel
//   repro/kernels/flash_attention/kernel.py::_fa_kernel
// (f32 inputs stay on fa_fwd_kernel<float, D> in flash_fwd.cu: the tensor
// cores would take f32 as TF32). The contract is flash_fwd.cu's: q
// (B,Sq,H,D), k, v (B,Skv,KVH,D), D in {64, 96, 112, 128, 192, 256}, GQA with
// query head h on KV head h / (H / KVH); padding, causal, window and
// q_offset masks;
// NEG_INF = -1e30 with the same live/alpha rules; out (B,Sq,H,D) bf16 and
// lse (B,Sq,H) f32, out = 0 and lse = 0 for a row that sees no key.
//
// Rounding follows the plain version (ops._blockwise_fwd): q * scale is
// taken in bf16, once, on the Q tile in shared memory (the scale is not
// folded into S, whose f32 product would round elsewhere); S = Q.K^T and
// O = P.V sum in f32 on the tensor cores; p is rounded to bf16 straight
// from the S accumulator into the A registers of P.V, while l sums the
// unrounded p.
//
// What bounds it on an H100: the internlm2-1.8b prefill (B 8, S 512, H 16,
// KVH 8, D 128, causal) must move ~50.6 MB (15.1 us at 3.35 TB/s) and do
// ~8.6 GFLOP (8.7 us at 989 TFLOP/s); the SWAP phase-1 step (B 256, S 64)
// ~202.4 MB (60.4 us) against 4.4 GFLOP. Both are bound by bytes. At D 256
// the gemma3-1b prefill (B 8, S 2048, H 4, KVH 1, causal) moves ~84.1 MB
// (25.1 us) and does ~68.7 GFLOP (69.5 us): there the tensor cores bind,
// and a local layer of window 512 does 30.1 GFLOP (30.4 us). At D 192 the
// deepseek-v2-lite MLA prefill (B 8, S 512, H = KVH 16, v padded to 192,
// causal) moves ~100.9 MB (30.1 us) and does ~12.9 GFLOP (13.1 us): bound
// by bytes. At D 112 the zamba2-7b prefill of its shared attention block
// (B 8, S 512, H = KVH 32, causal) moves ~118.0 MB (35.2 us) and does ~15.1
// GFLOP (15.2 us): bound by bytes. At D 96 the minicpm3-4b MLA prefill (B
// 8, S 512, H = KVH 40, qk 64 + 32, v padded to 96, causal) moves ~125.8 MB
// (37.6 us) and does ~16.1 GFLOP of real products (21.5 on D 128's tiles,
// 21.7 us): bound by bytes. The design
// reads each K/V byte once per (KV head, query tile) and keeps S, P and O
// out of device memory.
//
// Design:
//  * A CTA has NWG consumer warpgroups, each owning one 64-row query tile
//    of one head, and every K/V tile in shared memory serves all of them.
//    Which tiles, by the group size G = H / KVH:
//    - G even: a CTA is one (batch, KV head, 64-row query tile), and its
//      two warpgroups own the same rows of two query heads of the group
//      (G = 4 splits the group over two CTAs);
//    - G odd (MLA's and zamba2's G = 1, granite-moe's G = 3) and Sq > 64:
//      a CTA is one (batch, query head, 128-row query block), and its two
//      warpgroups own the block's two 64-row tiles (2t, 2t + 1). The CTA
//      loads the union of the tiles' visible KV ranges; under a causal
//      mask the lower tile's range is a prefix of the upper one's, so the
//      lower warpgroup passes over the last tile, and under a window over
//      tiles at both ends. A warpgroup that passes over a tile still
//      waits for it and releases its stage, so the ring's refill count
//      stays 4 NWG warps; it writes its epilogue before it passes over the
//      trailing ones. When ceil(Sq / 64) is odd the last block's upper
//      tile lies past Sq: TMA zero-fills it, that warpgroup sees no tile,
//      and none of its rows is stored;
//    - G odd and Sq <= 64 (a decode row, whisper's cross attention over 64
//      queries): one warpgroup a CTA, as one 64-row tile has no partner.
//    The host entry chooses (fa_fwd_sm90 below). D 64 (whisper-base at G
//    1, granite-moe at G 3) keeps the one-warpgroup CTA at every Sq
//    (kRowPairMinCols): its CTA, 94 registers a thread and 41 KB, fits
//    five an SM, more warpgroups than two-tile CTAs give.
//  * TMA: 4-D tensor maps over (D, heads, S, B) with boxes of 64 columns x
//    64 rows of one head and 128-byte swizzle (a D-128 row, 256 bytes, is
//    two boxes). Rows past Sq or Skv come in zero-filled and batch edges
//    stay edges. One thread issues each copy; an mbarrier with expect_tx
//    reports each arrival. K/V tiles of 64 keys sit in a ring of two
//    stages, so the next tile's copy is in flight while this one is
//    computed; when Skv <= 64 (the SWAP training steps at S 64) every CTA
//    has one KV tile, and the ring has one stage (kShortRing), so that more
//    CTAs fit an SM. A stage is refilled by the last of the CTA's warps to be
//    done with it (a shared-memory count), so no warp waits for the other
//    warpgroup.
//  * S = Q.K^T: wgmma m64n64k16, A (Q) and B (K) from shared memory, both
//    K-major as they lie (D contiguous), D/16 k-steps; the descriptor's
//    start advances 32 bytes a k-step inside a swizzled row and 8 KB a box.
//  * Masks and the online softmax run on the accumulator fragment: thread t
//    of a warpgroup holds rows 16 (t/32) + (t%32)/4 and +8, columns
//    8j + 2 (t%4) (+1). Row max and sum reduce over the four lanes of a row
//    (shuffles 1, 2). The padding mask kpos < Skv is explicit (TMA's zero
//    fill gives s = 0, not -inf); tiles outside the causal or window
//    bounds are skipped, and tiles wholly inside them skip the mask.
//    exp(s - m) is 2^(s log2 e - m log2 e), one FFMA and one ex2.approx,
//    where __expf takes a subtract, a multiply and the ex2: the softmax's
//    FP32 and special-function work, not the tensor cores, paces a tile,
//    so a warpgroup alone on its SM (or with one neighbour) leaves the SM
//    idle while it runs; the two-tile CTA at odd G exists for that.
//  * O += P.V: wgmma m64nDk16 (at D 192 and 256 one m64n192k16 or
//    m64n256k16 a k-step, N = D spanning three or four boxes) with
//    A = p in registers (the fragment of S columns 16j..16j+15 is the A
//    fragment of k-step j) and B = V from shared memory, MN-major (D
//    contiguous; transpose-B). The next tile's
//    S is issued right behind it, so the tensor cores run it while this
//    warpgroup waits for P.V. (ptxas notes C7518, wgmma serialized in a
//    divergent path, for the S issued under `if`; taking the branch away
//    with a spare S on the last tile measured slower.)
//  * Epilogue: O / l rounded to bf16 is staged in the warpgroup's own Q
//    tile (16-byte chunks XOR-swizzled by row against bank conflicts) and
//    stored with coalesced 16-byte stores, for rows < Sq only; lse =
//    m + log(l), or 0 where l = 0 (also in a CTA with no visible tile).
//  * The query tiles with the most KV tiles launch first (the slowest grid
//    axis, reversed), so causal imbalance does not leave a short last wave.
//  * D 112 (zamba2-7b) and D 96 (minicpm3-4b) run on D 128's tiles: their
//    maps' innermost extent is the real D, so TMA zero-fills columns D-127
//    of Q, K and V. The zero columns of Q and K leave S as it is and those
//    of V give zero O columns; the epilogue stores 14 (12) of a row's 16
//    chunks, at the real D's strides. The tensor cores do 8/7 (4/3) of the
//    products, which the bytes bound leaves room for.
//  * __launch_bounds__(threads, 2): two CTAs an SM (four warpgroups) hide
//    each other's latency; at D 128 that caps the kernel at 128 registers
//    (127 used, no spills; 160 without the bound, and slower). A CTA of
//    two warpgroups on D 128's tiles takes 97 KB of shared memory (two Q
//    tiles of 16 KB, a K/V ring of 2 x 2 x 16 KB), so two fit an SM. At D
//    256 the O accumulator alone is 64 x 256 f32, 128 registers a thread,
//    and a CTA of two warpgroups takes 192 KB of shared memory (two Q
//    tiles of 32 KB, a K/V ring of 2 x 2 x 32 KB): one CTA an SM, bounded
//    at 255 registers. At D 192 the O accumulator is 96 registers a thread
//    beside S's 32, and a CTA takes 145 KB of shared memory with two
//    warpgroups (121 KB with one): one CTA an SM there too, two
//    warpgroups an SM at every G with Sq > 64.
// Not here: a producer warp with setmaxnreg, persistent CTAs, clusters,
// the ping-pong of two warpgroups, or overlap of one tile's softmax with
// the next tile's S (that needs a second S accumulator, 32 more registers
// than the 2-CTA bound leaves).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kRows = kTileRows;         // query rows per warpgroup (M)
constexpr int kBlockK = kTileRows;       // keys per KV tile
constexpr int kStages = 2;               // K/V ring depth
// the ring's stages when Skv <= 64: every CTA then has one KV tile, and
// the smaller CTA lets more of them share an SM
constexpr int kShortRing = 1;
// at odd G the two-tile CTA takes head dims whose tiles have this many
// columns or more (see the host entry); below, one warpgroup a CTA
constexpr int kRowPairMinCols = 128;

// How a CTA's warpgroups split the work: two query heads of a group (G
// even), one 64-row tile (G odd, Sq <= 64), two 64-row tiles of one head
enum Split { kHeadPair, kOneTile, kRowPair };

// consumer warpgroups (of 128 threads) a CTA of a split
__host__ __device__ constexpr int split_wgs(int split) {
  return split == kOneTile ? 1 : 2;
}

// the KV tiles [*tb, *te) that some row of the 64-row query tile from
// row q0 can see; empty (0, 0) when the tile lies past Sq or sees no key
__device__ __forceinline__ void visible_tiles(int q0, int Sq, int Skv,
                                              int causal, int window,
                                              int q_offset, int* tb,
                                              int* te) {
  *tb = *te = 0;
  if (q0 >= Sq) return;
  const int q_last = min(q0 + kRows, Sq) - 1;
  int kv_end = Skv;
  if (causal) kv_end = min(kv_end, q_last + q_offset + 1);
  int kv_begin = 0;
  if (window > 0) kv_begin = max(0, q0 + q_offset - window + 1);
  if (kv_end <= kv_begin) return;
  *tb = kv_begin / kBlockK;
  *te = (kv_end + kBlockK - 1) / kBlockK;
}

// DG: the head dim of q, k, v and o; D: the tile's columns (tile_cols)
template <int DG, int SPLIT>
__global__ void __launch_bounds__(split_wgs(SPLIT) * 128,
                                  tile_cols(DG) >= 192 ? 1 : 2)
fa_fwd_sm90_kernel(__grid_constant__ const CUtensorMap tq,
                   __grid_constant__ const CUtensorMap tk,
                   __grid_constant__ const CUtensorMap tv,
                   __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                   int Sq, int Skv, int H, int KVH, float scale, int causal,
                   int window, int q_offset) {
  constexpr int NWG = split_wgs(SPLIT);
  constexpr bool kRowTiles = SPLIT == kRowPair;
  constexpr int D = tile_cols(DG);
  constexpr int kBoxes = D / kBox;
  constexpr int kTile = kBoxes * kBoxBytes;  // one 64-row tile of Q, K or V
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // every tile on a 1024-byte boundary: the period of the 128-byte swizzle
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  // the ring's stages in shared memory (as the host entry sizes it)
  const int ring = Skv > kBlockK ? kStages : kShortRing;
  uint8_t* sQ = smem;                         // [NWG][kTile]
  uint8_t* sK = sQ + NWG * kTile;             // [ring][kTile]
  uint8_t* sV = sK + ring * kTile;            // [ring][kTile]
  uint64_t* bars = reinterpret_cast<uint64_t*>(sV + ring * kTile);
  const uint32_t bar_q = smem_u32(bars);      // Q arrived
  const uint32_t bar_full = bar_q + 8;        // [kStages]: K/V arrived
  // [kStages]: warps done with the stage; the last one refills it
  int* released = reinterpret_cast<int*>(bars + 1 + kStages);

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int G = H / KVH;
  int kvh, h0;                  // the KV head; the query head of warpgroup 0
  if (kRowTiles) {
    h0 = blockIdx.x;
    kvh = h0 / G;
  } else {
    kvh = blockIdx.x / (G / NWG);
    h0 = kvh * G + (blockIdx.x % (G / NWG)) * NWG;
  }
  const int h = kRowTiles ? h0 : h0 + wg;
  const int b = blockIdx.y;
  // the CTA's first query row (longest first), and this warpgroup's
  const int qb = (gridDim.z - 1 - blockIdx.z) * (kRowTiles ? 2 : 1) * kRows;
  const int q0 = qb + (kRowTiles ? wg * kRows : 0);

  // the KV tiles of the CTA: those that some row of its query tiles can
  // see (with two row tiles, the union of two ranges that touch), and the
  // CTA's i-th tiles that this warpgroup's rows see, [i_lo, i_hi)
  int t_begin, t_end;
  visible_tiles(qb, Sq, Skv, causal, window, q_offset, &t_begin, &t_end);
  int i_lo = 0, i_hi = t_end - t_begin;
  if (kRowTiles) {
    int tb1, te1;
    visible_tiles(qb + kRows, Sq, Skv, causal, window, q_offset, &tb1, &te1);
    const int tb0 = t_begin, te0 = t_end;
    if (te1 > tb1) {
      t_begin = te0 > tb0 ? min(tb0, tb1) : tb1;
      t_end = max(te0, te1);
    }
    const int my_tb = wg == 0 ? tb0 : tb1, my_te = wg == 0 ? te0 : te1;
    i_lo = my_te > my_tb ? my_tb - t_begin : 0;
    i_hi = my_te > my_tb ? my_te - t_begin : 0;
  }
  const int n_tiles = t_end - t_begin;

  auto load_kv = [&](int i) {  // the CTA's i-th KV tile into stage i % kStages
    const int s = i % kStages;
    const int k0 = (t_begin + i) * kBlockK;
    mbar_expect_tx(bar_full + 8 * s, 2 * kTile);
    tma_load_tile<D>(sK + s * kTile, &tk, bar_full + 8 * s, kvh, k0, b);
    tma_load_tile<D>(sV + s * kTile, &tv, bar_full + 8 * s, kvh, k0, b);
  };

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      released[s] = 0;
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    // Q tiles; a lone last row tile's partner, wholly past Sq, is not
    // loaded (its warpgroup sees no tile and stores nothing)
    const int n_q = kRowTiles && qb + kRows >= Sq ? 1 : NWG;
    mbar_expect_tx(bar_q, n_q * kTile);
    for (int w = 0; w < n_q; ++w) {
      if (kRowTiles)
        tma_load_tile<D>(sQ + w * kTile, &tq, bar_q, h0, qb + w * kRows, b);
      else
        tma_load_tile<D>(sQ + w * kTile, &tq, bar_q, h0 + w, qb, b);
    }
    for (int i = 0; i < min(kStages, n_tiles); ++i) load_kv(i);
  }
  __syncwarp();

  // release the CTA's i-th tile's stage: the last of the CTA's warps to be
  // done with it issues the copy of the tile that goes there next, so no
  // warp waits for another warpgroup
  auto release = [&](int i) {
    const int s = i % kStages;
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();   // this warp's reads of the stage are done
      if (atomicAdd(&released[s], 1) == 4 * NWG - 1) {
        released[s] = 0;
        if (i + kStages < n_tiles) load_kv(i + kStages);
      }
    }
    __syncwarp();
  };
  // a tile none of this warpgroup's rows sees: wait for it to land (so
  // that no stage is released twice before the other warpgroup is done
  // with it), then release it
  auto pass = [&](int i) {
    mbar_wait(bar_full + 8 * (i % kStages), (i / kStages) & 1);
    release(i);
  };

  // q * scale in bf16 on this warpgroup's Q tile, as the plain version
  // takes it (elementwise, so the swizzle does not matter)
  mbar_wait(bar_q, 0);
  uint8_t* my_q = sQ + wg * kTile;
  scale_tile(my_q, kTile, scale, tid % 128, 128);
  warpgroup_sync(wg);

  const int r0 = warp * 16 + lane / 4;  // this thread's rows: r0, r0 + 8
  const int c0 = 2 * (lane % 4);        // and columns 8j + c0 (+1)
  const int qpos0 = q0 + r0 + q_offset;
  const uint32_t q_addr = smem_u32(my_q);
  float acc[D / 2];                     // O, the m64nD fragment
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};              // this thread's part of the row sum

  // S = (q * scale) . K^T of the i-th tile, issued and committed
  float sc[32];
  auto issue_s = [&](int i) {
    const int s = i % kStages;
    mbar_wait(bar_full + 8 * s, (i / kStages) & 1);
    const uint32_t k_addr = smem_u32(sK + s * kTile);
#pragma unroll
    for (int j = 0; j < 32; ++j) sc[j] = 0.f;
    wgmma_fence();
    wgmma_tiles_abt<D>(sc, q_addr, k_addr);
    wgmma_commit();
  };
  if (kRowTiles)
    for (int i = 0; i < i_lo; ++i) pass(i);
  if (i_lo < i_hi) issue_s(i_lo);

  for (int i = i_lo; i < i_hi; ++i) {
    const int s = i % kStages;
    const int k0 = (t_begin + i) * kBlockK;
    const uint32_t v_addr = smem_u32(sV + s * kTile);
    wgmma_wait<0>();   // S of this tile
    pin(sc);

    // masks, only on tiles that cross a bound
    const bool edge =
        k0 + kBlockK > Skv ||
        (causal && k0 + kBlockK - 1 > q0 + q_offset) ||
        (window > 0 && k0 <= q0 + kRows - 1 + q_offset - window);
    if (edge) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + 8 * j + c0 + (e & 1);
          const int qpos = qpos0 + 8 * (e >> 1);
          bool ok = kpos < Skv;
          if (causal) ok = ok && kpos <= qpos;
          if (window > 0) ok = ok && kpos > qpos - window;
          if (!ok) sc[4 * j + e] = kNegInf;
        }
      }
    }

    // online softmax; sc[4j + 2r + e] is row r0 + 8r, column 8j + c0 + e
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m[r];
      const float m_new = fmaxf(m_prev, mx);
      m[r] = m_new;
      // exp(s - m) as 2^(s log2 e - m log2 e): one FFMA and one MUFU. A
      // row with no visible key yet (m_new <= NEG_INF / 2) takes m = +inf,
      // so that every p is 2^-inf = 0
      const float m_log2 =
          m_new > kNegInf / 2 ? m_new * kLog2e : __int_as_float(0x7f800000);
      alpha[r] = m_prev > kNegInf / 2
                     ? exp2_approx(fmaf(m_prev, kLog2e, -m_log2))
                     : 0.f;
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p =
              exp2_approx(fmaf(sc[4 * j + 2 * r + e], kLog2e, -m_log2));
          sc[4 * j + 2 * r + e] = p;
          ps += p;
        }
      }
      l[r] = l[r] * alpha[r] + ps;
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[4 * j] *= alpha[0];
      acc[4 * j + 1] *= alpha[0];
      acc[4 * j + 2] *= alpha[1];
      acc[4 * j + 3] *= alpha[1];
    }
    // p in bf16, as the A fragments of P.V's four k-steps
    uint32_t pa[4][4];
    to_frags(sc, pa);

    // O += P . V; V is the MN-major B operand
    wgmma_fence();
    wgmma_frags_b<D>(acc, pa, v_addr);
    wgmma_commit();
    // the next tile's S runs on the tensor cores behind this P.V
    if (i + 1 < i_hi) {
      issue_s(i + 1);
      wgmma_wait<1>();   // this P.V; the next S may still run
    } else {
      wgmma_wait<0>();
    }
    pin(acc);
    pin(pa);
    release(i);
  }

  // epilogue: O / l in bf16, staged in this warpgroup's Q tile as [64][D]
  // with 16-byte chunk c of row r at c ^ (r & 7), then stored 16 bytes a
  // thread for rows < Sq; lse = m + log(l), 0 for rows that saw no key
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const int64_t row_stride = (int64_t)H * DG;  // between positions in o
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    const bool empty = l[r] == 0.f;
    const float denom = empty ? 1.f : l[r];
    uint8_t* srow = my_q + row * D * 2 + (lane % 4) * 4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(srow + ((j ^ (row & 7)) * 16)) =
          pack_bf16(acc[4 * j + 2 * r] / denom, acc[4 * j + 2 * r + 1] / denom);
    if (lane % 4 == 0 && q0 + row < Sq)
      lse[((int64_t)b * Sq + q0 + row) * H + h] =
          empty ? 0.f : m[r] + logf(denom);
  }
  warpgroup_sync(wg);
  store_tile<D, DG>(my_q, o + (((int64_t)b * Sq + q0) * H + h) * DG,
                    row_stride, Sq - q0, tid % 128, 128);
  // the tiles past this warpgroup's last visible one
  if (kRowTiles)
    for (int i = i_hi; i < n_tiles; ++i) pass(i);
}

template <int DG, int SPLIT>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk,
                   const CUtensorMap& tv, void* o, void* lse, int B, int Sq,
                   int Skv, int H, int KVH, float scale, int causal,
                   int window, int q_offset, cudaStream_t stream) {
  constexpr int NWG = split_wgs(SPLIT);
  constexpr int kTile = tile_cols(DG) / kBox * kBoxBytes;
  const int ring = Skv > kBlockK ? kStages : kShortRing;
  const int smem =
      1024 + (NWG + 2 * ring) * kTile + 8 * (1 + kStages) + 4 * kStages;
  const cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_sm90_kernel<DG, SPLIT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // (query heads, or their pairs; batch; query blocks of 64 or 128 rows)
  const int block_rows = (SPLIT == kRowPair ? 2 : 1) * kRows;
  const dim3 grid(SPLIT == kHeadPair ? H / 2 : H, B,
                  (Sq + block_rows - 1) / block_rows);
  fa_fwd_sm90_kernel<DG, SPLIT><<<grid, NWG * 128, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
      Sq, Skv, H, KVH, scale, causal, window, q_offset);
  return cudaGetLastError();
}

template <int DG>
cudaError_t launch_split(Split split, const CUtensorMap& tq,
                         const CUtensorMap& tk, const CUtensorMap& tv,
                         void* o, void* lse, int B, int Sq, int Skv, int H,
                         int KVH, float scale, int causal, int window,
                         int q_offset, cudaStream_t stream) {
  if (split == kHeadPair)
    return launch<DG, kHeadPair>(tq, tk, tv, o, lse, B, Sq, Skv, H, KVH,
                                 scale, causal, window, q_offset, stream);
  if (split == kRowPair)
    return launch<DG, kRowPair>(tq, tk, tv, o, lse, B, Sq, Skv, H, KVH,
                                scale, causal, window, q_offset, stream);
  return launch<DG, kOneTile>(tq, tk, tv, o, lse, B, Sq, Skv, H, KVH, scale,
                              causal, window, q_offset, stream);
}

}  // namespace

// The bf16 route of fa_fwd (flash_fwd.cu). Returns a cudaError_t.
cudaError_t fa_fwd_sm90(const void* q, const void* k, const void* v, void* o,
                        void* lse, int B, int Sq, int Skv, int H, int KVH,
                        int D, float scale, int causal, int window,
                        int q_offset, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  // Skv = 0 leaves every tile invisible; the map only needs a valid shape
  if (!encode(&tq, q, D, H, Sq, B) || !encode(&tk, k, D, KVH, Skv, B) ||
      !encode(&tv, v, D, KVH, Skv, B))
    return cudaErrorInvalidValue;
  // two query heads a CTA when G is even; at odd G two 64-row tiles of one
  // head when Sq has two, else one warpgroup (the design note above)
  const int G = H / KVH;
  const Split split = G % 2 == 0 ? kHeadPair
                      : Sq > kRows && tile_cols(D) >= kRowPairMinCols
                          ? kRowPair
                          : kOneTile;
  switch (D) {
    case 64:
      return launch_split<64>(split, tq, tk, tv, o, lse, B, Sq, Skv, H, KVH,
                              scale, causal, window, q_offset, stream);
    case 96:
      return launch_split<96>(split, tq, tk, tv, o, lse, B, Sq, Skv, H, KVH,
                              scale, causal, window, q_offset, stream);
    case 112:
      return launch_split<112>(split, tq, tk, tv, o, lse, B, Sq, Skv, H, KVH,
                               scale, causal, window, q_offset, stream);
    case 128:
      return launch_split<128>(split, tq, tk, tv, o, lse, B, Sq, Skv, H, KVH,
                               scale, causal, window, q_offset, stream);
    case 192:
      return launch_split<192>(split, tq, tk, tv, o, lse, B, Sq, Skv, H, KVH,
                               scale, causal, window, q_offset, stream);
    case 256:
      return launch_split<256>(split, tq, tk, tv, o, lse, B, Sq, Skv, H, KVH,
                               scale, causal, window, q_offset, stream);
  }
  return cudaErrorInvalidValue;
}
