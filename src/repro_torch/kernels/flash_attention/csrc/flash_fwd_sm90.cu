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
//    (kRowPairMinCols): its CTA, at most 96 registers a thread
//    (kMinCtas64) and 41 KB, fits five an SM, more warpgroups than
//    two-tile CTAs give (1.9039 against 1.7952 ms at whisper's
//    encoder, B 128).
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
//    A non-causal launch without a window, where every query tile has the
//    same KV tiles, puts the query tiles fastest instead, so that the 24
//    tiles of a (batch, head) of whisper's encoder run together and read
//    its K/V from HBM once, not once a tile (9.4 GB a launch at B 128):
//    3.3374 -> 1.8073 ms there; at B 8 (24.6 MB of K/V, which L2
//    holds) the two orders measured the same. A causal launch keeps the
//    longest first: with the tiles fastest it lost that, and internlm2's
//    prefill went 0.0382 -> 0.0522 ms.
//  * Two loops over the KV tiles. The serial loop (every launch with one
//    KV tile, Skv <= 64; D 64 to 128 always): S of tile i + 1 is issued
//    behind P.V of tile i, one barrier a stage for K and V. The pipelined
//    loop (D 192 and 256 where Skv > 64 and the CTA has two warpgroups,
//    kPipeWideCols): S of tile i + 1
//    is issued before P.V of tile i, and tile i + 1's softmax runs while
//    that P.V is on the tensor cores; K and V have barriers and releases
//    of their own, so a K stage refills once its S has run; the last tile
//    is peeled, so no wgmma sits under a branch. Both loops do the same
//    operations on O and l in the same order, so they give the same bits.
//    At D 192 and 256 it took the prefills 6-14% faster (gemma3's global
//    layer 0.1752 -> 0.1543 ms, deepseek's 0.0817 -> 0.0766). At D 64 it
//    lost to the serial loop (whisper's B 128 1.7182 against 1.6781 ms),
//    also with Q held in registers as S's A operand (RS wgmma) or
//    with 128-key tiles (ptxas C7512: no registers for the wgmma
//    pipeline; 3.0 ms): with its softmax removed the serial loop took
//    1.2553 ms and with its wgmma removed 1.2607, each 2.1x its bound of
//    0.5964, so neither unit binds alone, and the extra registers cost a
//    CTA an SM.
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
// Not here: clusters; the pipelined loop below D 192 (at D 96 to 128 it
// measured 18-28% slower on the prefills, internlm2's 0.0455 against
// 0.0386 ms: its registers do not fit the two-CTA bound;
// `ab_flash_fwd.py --routes=pipe_all`); a persistent, warp-specialized
// kernel at D 256 and even G (tried: one CTA an SM walking a
// longest-first list of (query tile, head pair, batch) items, a producer
// warp issuing every TMA copy on 24 registers (setmaxnreg), two consumer
// warpgroups on 240 taking turns on named barriers to issue their
// products, each freeing its Q tile after its last S so the next item's
// Q loads under its last P.V and its O stores. At gemma3's global prefill
// it took 0.1516-0.1559 ms against this kernel's pipelined loop's
// 0.1509-0.1543 over five A/B calls, 0.5% faster in four and 3.3% slower
// in one; without the turns 2-3% slower still; with a window 8-11% slower.
// The pipelined loop, the simpler, stays).

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
// where Skv > 64, head dims whose tiles have at least this many columns
// run the pipelined loop (tile i + 1's S in flight while tile i's P.V
// runs under tile i + 1's softmax: one CTA an SM, so occupancy does not
// bound their registers); a launch with one KV tile (Skv <= 64, the
// training steps at S 64) and the other head dims keep the serial loop
constexpr int kPipeWideCols = 192;

// How a CTA's warpgroups split the work: two query heads of a group (G
// even), one 64-row tile (G odd, Sq <= 64), two 64-row tiles of one head
enum Split { kHeadPair, kOneTile, kRowPair };

// consumer warpgroups (of 128 threads) a CTA of a split
__host__ __device__ constexpr int split_wgs(int split) {
  return split == kOneTile ? 1 : 2;
}

// CTAs of one warpgroup an SM that D 64's launch bound asks for: five, so
// at most 96 registers (the CTA's 41 KB of shared memory let five fit; at
// 99 registers the SM took four, and the S-64 shapes ran 13% slower)
constexpr int kMinCtas64 = 5;

// whether a head dim has the pipelined loop (where Skv > 64)
__host__ __device__ constexpr bool pipe_cols(int dg) {
  return tile_cols(dg) >= kPipeWideCols;
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

// Masks (only on a tile that crosses a bound) and the online softmax of the
// 64-key tile from key k0 on the S fragment sc, in place: p in sc, the
// running row max m and this thread's part of the row sum l updated, and
// alpha[r] = exp(m_old - m_new), the factor O's row r takes. The query
// tile's first row sits at position qo (q0 + q_offset); this thread holds
// the rows at positions qpos0 (+8) and columns 8j + c0 (+1):
// sc[4j + 2r + e] is row 8r past qpos0's, column 8j + c0 + e.
__device__ __forceinline__ void online_softmax(
    float (&sc)[32], float (&m)[2], float (&l)[2], float (&alpha)[2],
    int k0, int qo, int qpos0, int c0, int Skv, int causal, int window) {
  const bool edge =
      k0 + kBlockK > Skv ||
      (causal && k0 + kBlockK - 1 > qo) ||
      (window > 0 && k0 <= qo + kRows - 1 - window);
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
}

// O's rows times alpha: the m64nN fragment's row r0 (+8) by alpha[0] ([1])
template <int N>
__device__ __forceinline__ void rescale_rows(float (&acc)[N],
                                             const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    acc[4 * j] *= alpha[0];
    acc[4 * j + 1] *= alpha[0];
    acc[4 * j + 2] *= alpha[1];
    acc[4 * j + 3] *= alpha[1];
  }
}

// DG: the head dim of q, k, v and o; D: the tile's columns (tile_cols);
// PIPE: the pipelined loop, else the serial one
template <int DG, int SPLIT, bool PIPE>
__global__ void __launch_bounds__(split_wgs(SPLIT) * 128,
                                  tile_cols(DG) >= 192 ? 1
                                  : tile_cols(DG) == 64
                                      ? kMinCtas64 / split_wgs(SPLIT)
                                      : 2)
fa_fwd_sm90_kernel(__grid_constant__ const CUtensorMap tq,
                   __grid_constant__ const CUtensorMap tk,
                   __grid_constant__ const CUtensorMap tv,
                   __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                   int Sq, int Skv, int H, int KVH, float scale, int causal,
                   int window, int q_offset, int tiles_fastest) {
  constexpr int NWG = split_wgs(SPLIT);
  constexpr bool kRowTiles = SPLIT == kRowPair;
  constexpr int D = tile_cols(DG);
  constexpr bool kPipe = PIPE;
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
  // [2][kStages]: K, then V of a stage arrived (the serial loop: both on
  // the first kStages)
  const uint32_t bar_full = bar_q + 8;
  // [2][kStages]: warps done with a stage's K (V); the last one refills it
  int* released = reinterpret_cast<int*>(bars + 1 + 2 * kStages);

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int G = H / KVH;
  // the grid is (heads or head pairs, batches, query blocks), or with
  // tiles_fastest (query blocks, heads or head pairs, batches): then the
  // query blocks of one (batch, head) launch together and share its K/V in
  // L2 (see the host entry)
  const int head_idx = tiles_fastest ? blockIdx.y : blockIdx.x;
  const int b = tiles_fastest ? blockIdx.z : blockIdx.y;
  const int blk = tiles_fastest ? blockIdx.x : blockIdx.z;
  const int n_blk = tiles_fastest ? gridDim.x : gridDim.z;
  int kvh, h0;                  // the KV head; the query head of warpgroup 0
  if (kRowTiles) {
    h0 = head_idx;
    kvh = h0 / G;
  } else {
    kvh = head_idx / (G / NWG);
    h0 = kvh * G + (head_idx % (G / NWG)) * NWG;
  }
  const int h = kRowTiles ? h0 : h0 + wg;
  // the CTA's first query row (longest first), and this warpgroup's
  const int qb = (n_blk - 1 - blk) * (kRowTiles ? 2 : 1) * kRows;
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

  // the CTA's i-th K (kv 0) or V (kv 1) tile into stage i % kStages; the
  // serial loop loads and releases both together (kv 0)
  auto load = [&](int kv, int i) {
    const int s = i % kStages;
    const uint32_t bar = bar_full + 8 * (kv * kStages + s);
    const int k0 = (t_begin + i) * kBlockK;
    mbar_expect_tx(bar, (kPipe ? 1 : 2) * kTile);
    if (kPipe || kv == 0)
      tma_load_tile<D>((kv ? sV : sK) + s * kTile, kv ? &tv : &tk, bar, kvh,
                       k0, b);
    if (!kPipe) tma_load_tile<D>(sV + s * kTile, &tv, bar, kvh, k0, b);
  };
  auto wait_full = [&](int kv, int i) {
    mbar_wait(bar_full + 8 * (kv * kStages + i % kStages),
              (i / kStages) & 1);
  };

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < (kPipe ? 2 : 1) * kStages; ++s) {
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
    for (int i = 0; i < min(kStages, n_tiles); ++i) {
      load(0, i);
      if (kPipe) load(1, i);
    }
  }
  __syncwarp();

  // release the CTA's i-th K (kv 0) or V (kv 1) tile's stage: the last of
  // the CTA's warps to be done with it issues the copy of the tile that
  // goes there next, so no warp waits for another warpgroup. K and V are
  // released apart: a K stage is free once its S has run, a P.V later
  auto release = [&](int kv, int i) {
    const int s = kv * kStages + i % kStages;
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();   // this warp's reads of the stage are done
      if (atomicAdd(&released[s], 1) == 4 * NWG - 1) {
        released[s] = 0;
        if (i + kStages < n_tiles) load(kv, i + kStages);
      }
    }
    __syncwarp();
  };
  // a tile none of this warpgroup's rows sees: wait for it to land (so
  // that no stage is released twice before the other warpgroup is done
  // with it), then release it
  auto pass = [&](int i) {
    wait_full(0, i);
    release(0, i);
    if (kPipe) {
      wait_full(1, i);
      release(1, i);
    }
  };

  // q * scale in bf16 on this warpgroup's Q tile, as the plain version
  // takes it (elementwise, so the swizzle does not matter)
  mbar_wait(bar_q, 0);
  uint8_t* my_q = sQ + wg * kTile;
  scale_tile(my_q, kTile, scale, tid % 128, 128);
  warpgroup_sync(wg);

  const int r0 = warp * 16 + lane / 4;  // this thread's rows: r0, r0 + 8
  const int c0 = 2 * (lane % 4);        // and columns 8j + c0 (+1)
  const uint32_t q_addr = smem_u32(my_q);
  float acc[D / 2];                     // O, the m64nD fragment
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};              // this thread's part of the row sum

  // S = (q * scale) . K^T of the i-th tile, issued and committed
  float sc[32];
  auto issue_s = [&](int i) {
    wait_full(0, i);
    const uint32_t k_addr = smem_u32(sK + (i % kStages) * kTile);
#pragma unroll
    for (int j = 0; j < 32; ++j) sc[j] = 0.f;
    wgmma_fence();
    wgmma_tiles_abt<D>(sc, q_addr, k_addr);
    wgmma_commit();
  };
  // O += P . V of the i-th tile (V the MN-major B operand), issued and
  // committed (the pipelined loop's: V has a barrier of its own)
  uint32_t pa[4][4];                    // p in bf16, P.V's A fragments
  auto issue_pv = [&](int i) {
    wait_full(1, i);
    wgmma_fence();
    wgmma_frags_b<D>(acc, pa, smem_u32(sV + (i % kStages) * kTile));
    wgmma_commit();
  };

  const int qpos0 = q0 + r0 + q_offset;
  auto softmax = [&](int i, float (&alpha)[2]) {
    online_softmax(sc, m, l, alpha, (t_begin + i) * kBlockK, q0 + q_offset,
                   qpos0, c0, Skv, causal, window);
  };
  auto rescale = [&](const float (&alpha)[2]) { rescale_rows(acc, alpha); };

  if (kRowTiles)
    for (int i = 0; i < i_lo; ++i) pass(i);
  if constexpr (kPipe) {
    float alpha[2];
    // Pipelined: S of tile i + 1 is issued before P.V of tile i, and tile
    // i + 1's softmax runs while that P.V is on the tensor cores. O and l
    // take the same operations in the same order as the loop below (O
    // times alpha of tile i + 1 after tile i's P.V, then tile i + 1's
    // P.V), so the two give the same bits. The last tile is peeled, so
    // that no wgmma sits under a branch inside the loop.
    if (i_lo < i_hi) {
      issue_s(i_lo);
      wgmma_wait<0>();
      pin(sc);
      release(0, i_lo);
      softmax(i_lo, alpha);    // alpha 0: O is still 0
      to_frags(sc, pa);
      int i = i_lo;
      for (; i + 1 < i_hi; ++i) {
        issue_s(i + 1);
        issue_pv(i);
        wgmma_wait<1>();       // S of tile i + 1; this P.V may still run
        pin(sc);
        release(0, i + 1);
        softmax(i + 1, alpha);
        wgmma_wait<0>();
        pin(acc);
        pin(pa);
        release(1, i);
        rescale(alpha);
        to_frags(sc, pa);
      }
      issue_pv(i);
      wgmma_wait<0>();
      pin(acc);
      pin(pa);
      release(1, i);
    }
  } else {
    if (i_lo < i_hi) issue_s(i_lo);
    for (int i = i_lo; i < i_hi; ++i) {
      float alpha[2];
      const uint32_t v_addr = smem_u32(sV + (i % kStages) * kTile);
      wgmma_wait<0>();   // S of this tile
      pin(sc);
      softmax(i, alpha);
      rescale(alpha);
      to_frags(sc, pa);
      wgmma_fence();     // O += P . V; V arrived with K
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
      release(0, i);
    }
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

template <int DG, int SPLIT, bool PIPE>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk,
                   const CUtensorMap& tv, void* o, void* lse, int B, int Sq,
                   int Skv, int H, int KVH, float scale, int causal,
                   int window, int q_offset, cudaStream_t stream) {
  constexpr int NWG = split_wgs(SPLIT);
  constexpr int kTile = tile_cols(DG) / kBox * kBoxBytes;
  const int ring = Skv > kBlockK ? kStages : kShortRing;
  const int smem = 1024 + (NWG + 2 * ring) * kTile + 8 * (1 + 2 * kStages) +
                   4 * 2 * kStages;
  const cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_sm90_kernel<DG, SPLIT, PIPE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // (query heads, or their pairs; batch; query blocks of 64 or 128 rows),
  // the blocks with the most KV tiles first; or, where every block has
  // the same KV tiles (non-causal, no window), the blocks of one (batch,
  // head) together
  const int block_rows = (SPLIT == kRowPair ? 2 : 1) * kRows;
  const int n_blk = (Sq + block_rows - 1) / block_rows;
  const int heads = SPLIT == kHeadPair ? H / 2 : H;
  const int tiles_fastest = !causal && window == 0;
  const dim3 grid = tiles_fastest ? dim3(n_blk, heads, B)
                                  : dim3(heads, B, n_blk);
  fa_fwd_sm90_kernel<DG, SPLIT, PIPE><<<grid, NWG * 128, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
      Sq, Skv, H, KVH, scale, causal, window, q_offset, tiles_fastest);
  return cudaGetLastError();
}

template <int DG, int SPLIT>
cudaError_t launch_loop(const CUtensorMap& tq, const CUtensorMap& tk,
                        const CUtensorMap& tv, void* o, void* lse, int B,
                        int Sq, int Skv, int H, int KVH, float scale,
                        int causal, int window, int q_offset,
                        cudaStream_t stream) {
  // (one 64-row tile at odd G, a decode row, keeps the serial loop)
  if constexpr (pipe_cols(DG) && SPLIT != kOneTile) {
    if (Skv > kBlockK)
      return launch<DG, SPLIT, true>(tq, tk, tv, o, lse, B, Sq, Skv, H, KVH,
                                     scale, causal, window, q_offset, stream);
  }
  return launch<DG, SPLIT, false>(tq, tk, tv, o, lse, B, Sq, Skv, H, KVH,
                                  scale, causal, window, q_offset, stream);
}

template <int DG>
cudaError_t launch_split(Split split, const CUtensorMap& tq,
                         const CUtensorMap& tk, const CUtensorMap& tv,
                         void* o, void* lse, int B, int Sq, int Skv, int H,
                         int KVH, float scale, int causal, int window,
                         int q_offset, cudaStream_t stream) {
  if (split == kHeadPair)
    return launch_loop<DG, kHeadPair>(tq, tk, tv, o, lse, B, Sq, Skv, H, KVH,
                                      scale, causal, window, q_offset,
                                      stream);
  if (split == kRowPair)
    return launch_loop<DG, kRowPair>(tq, tk, tv, o, lse, B, Sq, Skv, H, KVH,
                                     scale, causal, window, q_offset, stream);
  return launch_loop<DG, kOneTile>(tq, tk, tv, o, lse, B, Sq, Skv, H, KVH,
                                   scale, causal, window, q_offset, stream);
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
