// Flash-attention backward for bf16 on NVIDIA Hopper (sm_90a), written by
// hand: every product of a tile on wgmma tensor cores, Q/dO and K/V tiles
// fed by TMA.
//
// Replaces, for bf16 inputs, the Pallas TPU kernels
//   repro/kernels/flash_attention/kernel.py::_fa_bwd_dkv_kernel  (dK, dV)
//   repro/kernels/flash_attention/kernel.py::_fa_bwd_dq_kernel   (dQ)
// (f32 inputs stay on the FMA kernels of flash_bwd.cu, which holds the C
// entries of both routes: the tensor cores would take f32 as TF32). The
// contract is flash_bwd.cu's: q, dO (B,Sq,H,D) and k, v (B,Skv,KVH,D)
// bf16, D in {64, 96, 112, 128, 192, 256}, query head h on KV head h / (H /
// KVH); lse
// and delta = rowsum(dO * O) (B,Sq,H) f32; padding, causal, window and
// q_offset masks (NEG_INF = -1e30: a masked P is 0); a row that sees no
// key has dq = 0 and adds nothing to dk or dv; dK and dV summed over the
// G = H / KVH query heads inside the kernel, with no atomics; outputs
// rounded to bf16 once.
//
// Rounding points (ref.flash_attention_bwd_ref(..., rounded=True) is the
// plain version at these points):
//   * S is formed from q * scale taken in bf16, on each Q tile in shared
//     memory, as the bf16 forward (flash_fwd_sm90.cu) took it when it wrote
//     lse: P = exp(S - lse) is the forward's softmax, and its rows sum to 1.
//     Nothing else takes q * scale: dK = scale * sum dS^T q and
//     dQ = scale * sum dS K, with q and k as they came and scale applied in
//     f32 in the epilogue, as the JAX kernels' f32 math does;
//   * P, then dS = P (dP - delta), enter their products as hi + lo, two
//     bf16 values (~16 significant bits), so each product is two wgmma
//     sets that sum in f32. One bf16 value each (8 bits) moved dV and dK
//     past the f32 reference's 1e-2 on the test grid. At the S-64 training
//     shapes the tensor cores have time to spare (the kernels are bound by
//     bytes there); over long sequences this doubles the products that
//     bound them (below);
//   * S, dP and every sum in f32 on the tensor cores; outputs rounded to
//     bf16 once.
//
// What bounds it on an H100: at the SWAP phase-1 shape of internlm2-1.8b
// (B 256, S 64, H 16, KVH 8, D 128, causal) each kernel must read q, dO, k,
// v, lse and delta and write dq (dQ) or dk and dv (dK/dV): 270.5 MB each,
// 80.8 us at 3.35 TB/s, against 6.5 and 8.7 GFLOP (6.6 and 8.8 us at 989
// TFLOP/s). Both are bound by bytes, and so are they at gemma3-1b's
// phase-1 shape (B 256, S 64, H 4, KVH 1, D 256: 118.0 MB for dQ, 35.2 us,
// and 101.2 MB for dK/dV, 30.2 us). So each reads a K/V tile once per (KV
// head, query tile) and a Q/dO tile once per (KV head, key tile), and keeps
// S, P, dP and dS out of device memory.
//
// Over long sequences they are bound by operations. At whisper-base's
// encoder at its train batch (B 128, S 1500, H = KVH 8, D 64, non-causal)
// dQ's three products of 2 S^2 D each are 884.7 GFLOP (0.8946 ms at 989
// TFLOP/s) and dK/dV's four 1179.6 (1.1928 ms); with P and dS as hi + lo
// the tensor cores do 8 S^2 D and 12 S^2 D, floors of 1.19 and 1.79 ms.
// There each kernel streams its operand from L2, not HBM: the grid's
// fastest index is the tile, so the 24 CTAs of one (batch, head) launch
// together and walk the same Q/dO (K/V) tiles in the same order. In PR 24's
// order (heads, then batches, then tiles) the CTAs resident at once were
// one tile of ~33 batches, each reading its whole operand set: ~9.4 GB a
// launch. On an NVIDIA H100 80GB HBM3 at 700.00 W (ab_flash_bwd.py, one
// call): dQ 4.0336 -> 3.2430 ms, the serial dK/dV 6.5873 -> 6.2061. The
// same call showed the re-reads were not the main loss: at B 8, where a
// (batch, head)'s operands fit L2 in either order, 16x PR 24's times
// (3.61, 6.71 ms) were as long as B 128's. What bounds the kernels there
// is that the tensor cores and the CUDA cores take turns: the dK/dV kernel
// with its softmax and fragment work removed took 2.6938 ms, with its
// wgmma removed 1.8474, and whole 5.1955 (dQ: 0.9941, 0.7886, 3.2571; one
// call). What paid there was fewer CUDA-core instructions and more CTAs an
// SM (below), not overlap within a warpgroup.
//
// dK/dV kernel (fa_bwd_dkv_sm90_kernel):
//  * A CTA is one (batch, KV head, 64-key tile), one warpgroup. K and V
//    arrive once by TMA; the CTA then loops over the G query heads of the
//    KV head x the 64-row query tiles that the causal and window bounds
//    leave visible, with the Q and dO tiles of each iteration in a ring of
//    two stages (the copy of iteration i + 2 starts when i is done).
//  * The products are taken transposed, so that both register-A products
//    take the accumulator fragment as it lies:
//      S^T  = K (q scale)^T   m64n64k16, A = K, B = Q scaled in place,
//                             both K-major;
//      P^T  = exp2(S^T log2 e - lse log2 e), masked;
//      dV  += P^T dO          m64nDk16, A = P^T in registers (hi, lo),
//                             B = dO MN-major (as V in the forward's P V);
//      dP^T = V dO^T          A = V, B = dO, both K-major (a second
//                             descriptor of the same dO tile);
//      dS^T = P^T (dP^T - delta);
//      dK  += dS^T q          A = dS^T in registers (hi, lo), B = Q
//                             MN-major, as it came: each thread keeps the
//                             chunks it scaled in registers and puts them
//                             back once S^T is done.
//    S^T and dP^T are issued together, and so are dV's and dK's products
//    once dS^T is formed.
//  * lse and delta belong to the fragment's columns here: thread t holds
//    query rows 8j + 2 (t%4) (+1). Each iteration stages the Q tile's 64
//    values of each (-lse log2 e, delta) in shared memory, read from
//    device memory (strided by H, so not by TMA; rows past Sq read as 0)
//    one iteration ahead.
//  * Masks on tiles that cross a bound only; the padding mask on query
//    rows past Sq is explicit (TMA's zero fill gives S = 0, not -inf).
//  * D 64 with a power-of-2 scale (1/8 by default) over more than one
//    query tile (Sq > 64) runs the folded loop (FOLD). There q * scale in
//    bf16 is exact, so S^T = scale (K q^T) bitwise: the scale goes into
//    exp2's factor, and the in-place scaling, its put-back, two proxy
//    fences and two barriers an iteration go. P^T's hi and lo fragments
//    are formed with P^T (probs_t_frags: hi = bf16(p), lo = bf16(p - hi),
//    P^T = hi + lo, split_round's value), not split again from it; the
//    fragments differ from PR 24's only where that second split landed on
//    a tie. 168 registers (40 bytes of stack), three CTAs an SM, a Q/dO
//    ring of kFoldStages. On an NVIDIA H100 80GB HBM3 at 700.00 W
//    (ab_flash_bwd.py --ring --occupancy, one call), whisper's encoder at
//    B 128: rings of two, three and four 4.5357, 4.7146 and 5.7659 ms
//    (four fits two CTAs an SM); at three CTAs an SM 4.7146, at two
//    5.5062. In an earlier call, with a ring of three: 4.6037 ms
//    against 5.2195 for the pipelined loop it replaced (below), 4.8398 for
//    that loop with the fragments formed with P^T (218 registers, two CTAs
//    an SM); at granite's phase 1 (S 64, three iterations a CTA) it took
//    0.1064 against 0.0956, so S 64 keeps the loop of the other head dims
//    (0.0974 in PR 24). Not kept, on the same card, each against the loop
//    in use then: a pipelined loop, issuing the next tile's S^T and dP^T
//    and this tile's products in one iteration and waiting within it, with
//    iteration 0's front and the last products peeled (245 registers, two
//    CTAs an SM; 5.1650 ms against the in-place loop's 6.1536); the same
//    with two register sets for S^T and dP^T, unrolled by two (254
//    registers, 320 bytes of spills, ptxas C7511: 8.0491), or with them in
//    flight across the back edge (C7515: 6.4891); dV's and dK's products
//    as two groups (5.2489 against 5.2443); bf16 rounding on the bits in
//    split_round (bitwise equal; 5.4549 against 5.2410); two warpgroups a
//    CTA on adjacent key tiles, sharing each Q/dO tile and taking turns on
//    named barriers (6.4103 against 5.2141); the in-place loop at three
//    CTAs an SM (5.1041 against the pipelined loop's 5.2161, less than the
//    folded loop gained).
//  * Registers, D 128: dK and dV accumulators 64 + 64, S^T and dP^T
//    32 + 32, the kept chunks of q 32 (until S^T is done); then the hi and
//    lo fragments of P^T and dS^T, 64, in place of S^T and dP^T: ptxas
//    fits it in 255, with no spills. Shared memory: K and V 32 KB, two
//    stages of Q and dO 64 KB; __launch_bounds__(128, 2) gives two CTAs an
//    SM. At the phase-1 shape a CTA holds one key tile and runs G = 2
//    iterations, so latency is hidden by the other CTA of the SM, not by
//    the ring. Key tile 0 sees the most query tiles under causal, and
//    launches first.
//  * Epilogue: dK * scale and dV rounded to bf16, staged in the K and V
//    tiles and stored 16 bytes a thread, coalesced, for keys < Skv.
//  * D 256 (NWG = 2 warpgroups a CTA): the two 64 x 256 f32 accumulators,
//    256 registers a thread, do not fit one warpgroup, so each warpgroup
//    owns 128 columns of both dK and dV (64 + 64 registers, as at D 128).
//    Both form the whole S^T and dP^T (the D contraction is not split), so
//    nothing passes between them but the CTA's barriers; the tensor cores
//    do the S^T and dP^T products twice, which the bytes bound leaves room
//    for. q * scale goes to a tile of its own, written by both warpgroups
//    from the stage's Q (no kept chunks of q in registers): K, V and the
//    scaled Q 96 KB, two stages of Q and dO 128 KB, 225.5 KB in all, one CTA
//    an SM. At KVH 1 the grid is B x ceil(S / 64) CTAs: 128 at B 128, S 64,
//    under one wave of 132 SMs, each running its G = 4 iterations alone.
//  * D 192 (NWG = 3, MLA): two 64 x 192 accumulators are 192 registers a
//    thread, with S^T and dP^T over 255, so the columns are split again.
//    192 / 2 = 96 columns a warpgroup would start the second warpgroup's
//    MN-major B operand half way into a 128-byte swizzle atom (a TMA box),
//    so each of three warpgroups owns one whole box, 64 columns of dK and
//    dV (32 + 32 registers, as at D 64), and forms the whole S^T and dP^T:
//    the tensor cores do those products three times. q * scale in its own
//    tile as at D 256: K, V and the scaled Q 72 KB, two stages of Q and dO
//    96 KB, 169.5 KB in all, one CTA of 384 threads an SM (168 registers a
//    thread at most: ptxas spills 48 bytes). MLA runs at G 1 (H = KVH), so
//    a CTA runs one iteration per visible query tile. A variant that forms
//    P^T and dS^T in one pass after dP^T, packing each pair straight into
//    its fragments, fit in 162 registers with no spill, and took 0.2910 ms
//    at deepseek-v2-lite's phase-1 shape against this one's 0.2868
//    (ab_flash_bwd.py, one call on an NVIDIA H100 80GB HBM3, 700.00 W):
//    not kept.
//
// dQ kernel (fa_bwd_dq_sm90_kernel):
//  * A CTA is one (batch, KV head, 64-row query tile) with NWG warpgroups,
//    one a query head (kDqHeads when G divides by it, else 1); it loops over
//    the visible 64-key tiles in a K/V ring of kDqStages, refilled by the
//    last of the CTA's warps to be done with a stage, as in the forward.
//    Kept: one warpgroup a CTA, three CTAs an SM (68 KB of shared memory
//    each at D 128, so a ring of one stage). On an H100 at the phase-1
//    shape it took 0.0977 ms against 0.1009 for one warpgroup at two CTAs
//    an SM and 0.1090 for two warpgroups at one (ab_flash_bwd.py
//    --occupancy); at phase 2's batch of 32, 0.0163 against 0.0162 and
//    0.0157.
//  * Products: S = (q scale) K^T and dP = dO V^T (SS, all K-major, issued
//    together); P = exp2(S log2 e - lse log2 e), masked, and rounded to
//    hi + lo as the dK/dV kernel's dV product takes it; dS = P (dP -
//    delta); dQ += dS K (RS, A = dS in registers (hi, lo), B = K MN-major:
//    the forward's P V with K in V's place). lse and delta are per row
//    here: four registers a thread for the whole CTA.
//  * Registers: S + dP + dQ = 32 + 32 + 64 a thread at D 128, more than a
//    two-CTA bound of two warpgroups leaves (128); the CTA shape, the CTAs
//    an SM asked of ptxas and the ring depth are constants below, measured
//    against each other by ab_flash_bwd.py --occupancy. At three CTAs an
//    SM ptxas fits the kernel in 168 registers, with no spills. At D 256
//    the dQ accumulator alone is 128 registers and Q and dO take 64 KB, each
//    K/V stage 64 KB: one warpgroup a CTA, one CTA an SM, a ring of two
//    stages (kDq256Stages), dQ += dS K one m64n256k16 a k-step. At D 192
//    the accumulator is 96 registers, Q and dO 48 KB and a K/V stage 48 KB,
//    dQ += dS K one m64n192k16 a k-step: one warpgroup a CTA, two CTAs an
//    SM (224 registers, 97 KB each with a ring of one). On an NVIDIA H100
//    80GB HBM3, 700.00 W, at deepseek-v2-lite's phase-1 shape (B 256, S 64,
//    H 16, one K/V tile a CTA) that took 0.1721 ms against 0.1958 for D
//    256's shape, one CTA an SM with a ring of two (ab_flash_bwd.py, one
//    call; phase 2, B 32: 0.0320 against 0.0337).
//  * D 112 (zamba2-7b's shared attention block, G 1) and D 96 (minicpm3-4b's
//    MLA, G 1) run both kernels on D 128's tiles and CTA shapes, as the
//    forward does: TMA zero-fills columns D-127 of Q, K, V and dO. Zero
//    columns leave S and dP as they are, and give zero columns of dQ (dS K),
//    dK (dS^T q) and dV (P^T dO), which the epilogues do not store (14 or 12
//    of a row's 16 chunks, at the real D's strides).
//  * Epilogue: dQ * scale rounded to bf16, staged in the warpgroup's Q tile,
//    stored for rows < Sq; within each (batch, head group) the query tiles
//    with the most key tiles launch first.
//  * D 64: four CTAs an SM (kDq64MinBlocks; 128 registers, no spills), a
//    ring of one stage (kDq64Stages). On an NVIDIA H100 80GB HBM3 at 700.00
//    W (ab_flash_bwd.py, one call each): at whisper's encoder at B 128 four
//    CTAs took 3.0617 ms against three's 3.2613, at granite's phase 1
//    0.0751 against 0.0789; rings of one, two and three took 3.2464,
//    3.2468 and 3.2430 at B 128 and 0.0789, 0.0803 and 0.0808 at granite.
//    The dK/dV kernel's pipelined loop, here with a ring of three (168
//    registers, three CTAs an SM), took 3.2283 against 3.2727 and 0.0806
//    against 0.0789: not kept. Nor two CTAs an SM (196 registers): 3.6142.
//
// dQ/dK/dV kernel (fa_bwd_dqkv_sm90_kernel), D 256 with Sq and Skv <= 64
// (gemma3-1b's training steps: S 64, H 4, KVH 1) and a power-of-2 scale:
//  * One key tile and one query tile hold the sequence, so dQ needs no sum
//    over key tiles: dQ = scale dS K is complete once dS is formed, and the
//    dK/dV loop writes it. Over longer sequences the pair above stays (dQ's
//    sum over key tiles there would need atomics or a second pass).
//  * What bounds it: at gemma3's phase 1 (B 128) it must read q, dO, k, v,
//    lse and delta and write dq, dk and dv, 67.4 MB (20.1 us at 3.35 TB/s),
//    against 2.73 GFLOP of products (2.8 us at 989 TFLOP/s; twice that
//    with P and dS as hi + lo): bytes. The pair moved 110 MB for the same
//    work, q, dO, k and v read by both kernels.
//  * A CTA is one (batch, KV head) and two warpgroups, with K and V loaded
//    once; it loops over the KV head's G query heads with their Q and
//    dO tiles in a ring of kDqkvStages. Each iteration forms S^T and dP^T
//    (both warpgroups, over the whole D, as the D-256 dK/dV kernel), P^T
//    and dS^T as hi + lo, dV += P^T dO (issued once P^T is formed, in
//    flight while dS^T is) and dK += dS^T q on the warpgroup's 128
//    columns (as there), and dQ = dS K on the same columns:
//    an SS product, A the dS tile that the two warpgroups write to shared
//    memory (hi from one, lo from the other) with query rows and key
//    columns, laid out as a TMA box; B K, MN-major. dQ * scale goes to the
//    stage's Q tile and out by a TMA store, and the stage is refilled once
//    the store has read it. q * scale in bf16 is exact at a power-of-2
//    scale, so S^T = scale (K q^T) bitwise: the scale goes into exp2's
//    factor, as in the folded D-64 loop, and q needs no tile of its own.
//    K, V, a ring of two and the dS tile: 209.5 KB, one CTA an SM.
//  * A CTA a (batch, KV head), so its dK and dV sum the G query heads in
//    head order whatever the batch or the card: a batch's bits are those
//    of the same call on that batch alone (no atomics; the result repeats
//    bitwise).
//  * Rounding points as above; only the f32 order of the head sum differs
//    from the pair's (the pair adds each head into its accumulators), so
//    its bits are not the pair's.
//  * A first design, a cluster of G CTAs a KV head and one a query head,
//    each forming its head's partials, ran one CTA an SM (180 KB) through
//    load, products and a head sum of 128 KB a CTA in distributed shared
//    memory in turn, with nothing to overlap them: slower than the pair at
//    gemma3's phase 1. dQ written from the fragments, 4 bytes a thread,
//    lost to the staged tile; a TMA store of it lets the stage refill
//    without a barrier. Writing the dS tile under dK's product (from dS^T
//    again, its fragments being in flight) spilled more and lost; dQ in
//    two 64-column products kept the spills and lost. This kernel with a
//    cluster of C CTAs a KV head where the grid would leave SMs idle (G /
//    C heads each, the C partial sums of dK and dV added through
//    distributed shared memory; C 2 at gemma3's phase 2): on an NVIDIA
//    H100 80GB HBM3 at 700.00 W (ab_flash_bwd.py, one call, that source
//    as a variant), 0.0404 ms at gemma3's phase 1 (B 128, C 1) and 0.0213
//    at phase 2 (B 32), against this kernel's 0.0405 and 0.0285 and the
//    pair's 0.0707 and 0.0354 (dQ + dK/dV). It saved ~0.007 ms a phase-2
//    launch, but its head sum's order, and so dK's and dV's bits, followed
//    the batch size and the card's SM count: not kept. ptxas: 255
//    registers; where G > 1 the loop spills 92 bytes (none at G 1).
// Not here: a producer warp with setmaxnreg, persistent CTAs, or a fused
// delta; and at D 256 S^T and dP^T formed once a CTA (one warpgroup each,
// exchanged through shared memory): the exchange needs 32 KB more than the
// 227 KB a CTA may hold beside the ring.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "sm90.cuh"

namespace {

constexpr int kStages = 2;               // Q/dO ring depth of dK/dV
// dK/dV at D 64 with a power-of-2 scale over more than one query tile:
// the scale folded into exp2's factor, P^T's fragments formed with its
// softmax, a Q/dO ring of kFoldStages, kFoldMinBlocks CTAs an SM
constexpr bool kFolded = true;
constexpr int kFoldStages = 2;
constexpr int kFoldMinBlocks = 3;
// the dQ CTA: query heads (one warpgroup each) a CTA, the CTAs an SM asked
// of ptxas (kDq64MinBlocks at D 64), and the K/V ring depth (kDq64Stages
// at D 64)
constexpr int kDqHeads = 1;
constexpr int kDqMinBlocks = 3;
constexpr int kDqStages = 1;
constexpr int kDq64Stages = 1;
constexpr int kDq64MinBlocks = 4;
// at D 192 two CTAs an SM with the ring above; at D 256 one, with a ring of
// two
constexpr int kDq192MinBlocks = 2;
constexpr int kDq256Stages = 2;

// whether a tile of keys from k0 and query rows from q0 crosses a bound:
// masks are applied on such tiles only
__device__ __forceinline__ bool tile_edge(int k0, int q0, int Sq, int Skv,
                                          int causal, int window,
                                          int q_offset) {
  return k0 + kTileRows > Skv || q0 + kTileRows > Sq ||
         (causal && k0 + kTileRows - 1 > q0 + q_offset) ||
         (window > 0 && k0 <= q0 + kTileRows - 1 + q_offset - window);
}

// one element of P^T = exp(S^T - lse): s of S^T, mul log2 e times whatever
// scale S^T still lacks, nl = -lse log2 e; 0 where key kpos is masked from
// query row `row` (checked on an edge tile only)
__device__ __forceinline__ float prob_t(float s, float mul, float nl,
                                       bool edge, int kpos, int row, int Sq,
                                       int Skv, int causal, int window,
                                       int q_offset) {
  float p = exp2_approx(fmaf(s, mul, nl));
  if (edge) {
    const int qpos = row + q_offset;
    bool ok = kpos < Skv && row < Sq;
    if (causal) ok = ok && kpos <= qpos;
    if (window > 0) ok = ok && kpos > qpos - window;
    if (!ok) p = 0.f;
  }
  return p;
}

// P^T of one 64 x 64 tile as hi + lo, in place: st[4j + e] is key r0 + 8
// (e >> 1), query row 8j + c0 + (e & 1); nlse holds the tile's 64 values of
// -lse log2 e
__device__ __forceinline__ void probs_t(float (&st)[32], const float* nlse,
                                        float mul, int k0, int q0, int r0,
                                        int c0, int Sq, int Skv, int causal,
                                        int window, int q_offset) {
  const bool edge = tile_edge(k0, q0, Sq, Skv, causal, window, q_offset);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 nl = *reinterpret_cast<const float2*>(nlse + 8 * j + c0);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      st[4 * j + e] = split_round(
          prob_t(st[4 * j + e], mul, e & 1 ? nl.y : nl.x, edge,
                 k0 + r0 + 8 * (e >> 1), q0 + 8 * j + c0 + (e & 1), Sq, Skv,
                 causal, window, q_offset));
  }
}

// probs_t with P^T's hi and lo fragments formed as it goes: each pair's hi
// = bf16(p), lo = bf16(p - hi), st = hi + lo (split_round's value)
__device__ __forceinline__ void probs_t_frags(
    float (&st)[32], uint32_t (&hi)[4][4], uint32_t (&lo)[4][4],
    const float* nlse, float mul, int k0, int q0, int r0, int c0, int Sq,
    int Skv, int causal, int window, int q_offset) {
  const bool edge = tile_edge(k0, q0, Sq, Skv, causal, window, q_offset);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 nl = *reinterpret_cast<const float2*>(nlse + 8 * j + c0);
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      float p[2];
#pragma unroll
      for (int e1 = 0; e1 < 2; ++e1)
        p[e1] = prob_t(st[4 * j + 2 * e2 + e1], mul, e1 ? nl.y : nl.x, edge,
                       k0 + r0 + 8 * e2, q0 + 8 * j + c0 + e1, Sq, Skv,
                       causal, window, q_offset);
      const int m = 2 * j + e2;         // the pair st[2m], st[2m + 1]
      const uint32_t h2 = pack_bf16(p[0], p[1]);
      const float2 h = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&h2));
      const uint32_t l2 = pack_bf16(p[0] - h.x, p[1] - h.y);
      const float2 l = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&l2));
      hi[m >> 2][m & 3] = h2;
      lo[m >> 2][m & 3] = l2;
      st[2 * m] = h.x + l.x;
      st[2 * m + 1] = h.y + l.y;
    }
  }
}

// DG: the head dim of the tensors; D: the tile's columns (tile_cols); FOLD:
// the folded loop (D 64, one warpgroup, a power-of-2 scale)
template <int DG, int NWG, bool FOLD>
__global__ void __launch_bounds__(NWG * 128,
                                  NWG > 1 ? 1 : FOLD ? kFoldMinBlocks : 2)
fa_bwd_dkv_sm90_kernel(__grid_constant__ const CUtensorMap tq,
                       __grid_constant__ const CUtensorMap tk,
                       __grid_constant__ const CUtensorMap tv,
                       __grid_constant__ const CUtensorMap tdo,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dk,
                       __nv_bfloat16* __restrict__ dv, int Sq, int Skv, int H,
                       int KVH, float scale, int causal, int window,
                       int q_offset) {
  constexpr int D = tile_cols(DG);
  constexpr int kTile = D / kBox * kBoxBytes;  // one 64-row tile
  constexpr int kThreads = NWG * 128;
  constexpr int kCols = D / NWG;   // the dK, dV columns a warpgroup owns
  static_assert(!FOLD || (NWG == 1 && D == 64), "folded at D 64 only");
  constexpr int STAGES = FOLD ? kFoldStages : kStages;
  // q * scale in a tile of its own (NWG > 1), or in place with each
  // thread's chunks of q kept in registers and put back (NWG 1), or not at
  // all (FOLD: the scale goes into exp2's factor)
  constexpr bool kOwnTile = NWG > 1;
  constexpr int kChunksPerThread = kOwnTile ? 1 : kTile / 16 / 128;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // every tile on a 1024-byte boundary: the period of the 128-byte swizzle
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sK = smem;
  uint8_t* sV = sK + kTile;
  uint8_t* sQ = sV + kTile;                   // [STAGES][kTile]
  uint8_t* sdO = sQ + STAGES * kTile;         // [STAGES][kTile]
  uint8_t* sQs = sdO + STAGES * kTile;        // [kOwnTile][kTile], q * scale
  // this iteration's -lse log2 e [64] and delta [64]
  float* sStat = reinterpret_cast<float*>(sQs + (kOwnTile ? kTile : 0));
  uint64_t* bars = reinterpret_cast<uint64_t*>(sStat + 2 * kTileRows);
  const uint32_t bar_kv = smem_u32(bars);     // K/V arrived
  const uint32_t bar_full = bar_kv + 8;       // [STAGES]: Q/dO arrived

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int G = H / KVH;
  // the key tiles of one (batch, KV head) are adjacent in launch order: they
  // stream the same Q/dO tiles in the same order, and share them in L2
  const int k0 = blockIdx.x * kTileRows;      // key tile 0 (most work) first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  // the CTA's threads (one warpgroup's named barrier when NWG is 1)
  auto cta_sync = [&]() {
    if constexpr (NWG == 1)
      warpgroup_sync(0);
    else
      __syncthreads();
  };

  // the query tiles that some key of this tile is visible to
  const int k_last = min(k0 + kTileRows, Skv) - 1;
  int r_begin = 0, r_end = Sq;
  if (causal) r_begin = max(0, k0 - q_offset);
  if (window > 0) r_end = min(r_end, k_last + window - q_offset);
  const int t_begin = r_begin / kTileRows;
  const int n_qt =
      r_end > r_begin ? (r_end + kTileRows - 1) / kTileRows - t_begin : 0;
  // iteration i: query head kvh G + i / n_qt, query tile t_begin + i % n_qt
  const int n_iter = G * n_qt;
  auto head = [&](int i) { return kvh * G + i / n_qt; };
  auto row0 = [&](int i) { return (t_begin + i % n_qt) * kTileRows; };

  auto load_q = [&](int i) {  // iteration i's Q and dO into stage i % STAGES
    const int s = i % STAGES;
    mbar_expect_tx(bar_full + 8 * s, 2 * kTile);
    tma_load_tile<D>(sQ + s * kTile, &tq, bar_full + 8 * s, head(i), row0(i),
                     b);
    tma_load_tile<D>(sdO + s * kTile, &tdo, bar_full + 8 * s, head(i),
                     row0(i), b);
  };

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < STAGES; ++s) mbar_init(bar_full + 8 * s, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0 && n_iter > 0) {
    mbar_expect_tx(bar_kv, 2 * kTile);
    tma_load_tile<D>(sK, &tk, bar_kv, kvh, k0, b);
    tma_load_tile<D>(sV, &tv, bar_kv, kvh, k0, b);
    for (int i = 0; i < min(STAGES, n_iter); ++i) load_q(i);
  }
  __syncwarp();

  // thread t's entry of sStat for iteration i (t < 128): -lse log2 e of
  // query row t (t < 64) or delta of row t - 64, 0 past Sq
  const bool stats = tid < 2 * kTileRows;
  const float* stat_src = tid < kTileRows ? lse : delta;
  const float stat_mul = tid < kTileRows ? -kLog2e : 1.f;
  auto stat = [&](int i) {
    const int row = row0(i) + tid % kTileRows;
    return row < Sq ? stat_src[((int64_t)b * Sq + row) * H + head(i)] *
                          stat_mul
                    : 0.f;
  };

  const int r0 = warp * 16 + lane / 4;  // this thread's keys: r0, r0 + 8
  const int c0 = 2 * (lane % 4);        // and query rows 8j + c0 (+1)
  const uint32_t k_addr = smem_u32(sK);
  const uint32_t v_addr = smem_u32(sV);
  // this warpgroup's columns of an MN-major B operand
  const uint32_t col_off = wg * (kCols / kBox) * kBoxBytes;
  float acc_dk[kCols / 2], acc_dv[kCols / 2];
#pragma unroll
  for (int i = 0; i < kCols / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;
  // the first stats are read while K and V arrive
  float stat_next = n_iter > 0 && stats ? stat(0) : 0.f;
  if (n_iter > 0) mbar_wait(bar_kv, 0);
  const float sc = __bfloat162float(__float2bfloat16_rn(scale));

  // FOLD: sc is a power of 2 (the C entry's choice), so q * sc in bf16 is
  // exact and S^T = sc (K q^T) bitwise: the scale goes into exp2's factor,
  // q enters S^T as it came, and P^T's hi and lo fragments are formed with
  // P^T itself (probs_t_frags)
  const float p_mul = FOLD ? kLog2e * sc : kLog2e;
  for (int i = 0; i < n_iter; ++i) {
    const int s = i % STAGES;
    const int q0 = row0(i);
    uint4* q_tile = reinterpret_cast<uint4*>(sQ + s * kTile);
    const uint32_t q_addr = smem_u32(q_tile);
    const uint32_t do_addr = smem_u32(sdO + s * kTile);
    if (stats) {
      sStat[tid] = stat_next;           // the last iteration's reads ended
      if (i + 1 < n_iter) stat_next = stat(i + 1);  // at its closing barrier
    }
    mbar_wait(bar_full + 8 * s, (i / STAGES) & 1);
    // q * scale in bf16 for S^T: into its own tile, or in place with this
    // thread's chunks of q as they came kept, and put back for dK once S^T
    // is done (not at all with FOLD)
    uint4 raw[kChunksPerThread];
    if constexpr (kOwnTile) {
      uint4* qs = reinterpret_cast<uint4*>(sQs);
      for (int c = tid; c < kTile / 16; c += kThreads)
        qs[c] = scale_chunk(q_tile[c], sc);
    } else if constexpr (!FOLD) {
#pragma unroll
      for (int c = 0; c < kChunksPerThread; ++c) {
        raw[c] = q_tile[tid + 128 * c];
        q_tile[tid + 128 * c] = scale_chunk(raw[c], sc);
      }
    }
    if constexpr (!FOLD) fence_proxy_async();
    cta_sync();                         // scaled Q and sStat in place
    const uint32_t qs_addr = kOwnTile ? smem_u32(sQs) : q_addr;

    // S^T = K (q scale)^T and dP^T = V dO^T, two groups, over the whole D
    // in every warpgroup
    float st[32], dpt[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) st[j] = dpt[j] = 0.f;
    wgmma_fence();
    wgmma_tiles_abt<D>(st, k_addr, qs_addr);
    wgmma_commit();
    wgmma_tiles_abt<D>(dpt, v_addr, do_addr);
    wgmma_commit();
    wgmma_wait<1>();
    pin(st);
    if constexpr (!kOwnTile && !FOLD) {
      // every warp's S^T has read the scaled tile: put q back
      warpgroup_sync(0);
#pragma unroll
      for (int c = 0; c < kChunksPerThread; ++c)
        q_tile[tid + 128 * c] = raw[c];
      fence_proxy_async();
    }

    // P^T = exp(S^T - lse), masked, as hi + lo
    uint32_t pa[4][4], pb[4][4], da[4][4], db[4][4];
    if constexpr (FOLD)
      probs_t_frags(st, pa, pb, sStat, p_mul, k0, q0, r0, c0, Sq, Skv, causal,
                    window, q_offset);
    else
      probs_t(st, sStat, p_mul, k0, q0, r0, c0, Sq, Skv, causal, window,
              q_offset);

    // dS^T = P^T (dP^T - delta), from P^T as the dV product takes it
    wgmma_wait<0>();                    // dP^T
    pin(dpt);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 dl =
          *reinterpret_cast<const float2*>(sStat + kTileRows + 8 * j + c0);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dpt[4 * j + e] =
            st[4 * j + e] * (dpt[4 * j + e] - (e & 1 ? dl.y : dl.x));
    }

    // dV += P^T dO and dK += dS^T q (times scale in the epilogue) on this
    // warpgroup's columns, each A as hi + lo; dK's B is the Q tile as it
    // came (with NWG 1, every thread's chunks put back)
    if constexpr (!FOLD) to_split_frags(st, pa, pb);
    to_split_frags(dpt, da, db);
    if constexpr (!kOwnTile && !FOLD) warpgroup_sync(0);
    wgmma_fence();
    wgmma_frags_b<kCols>(acc_dv, pa, do_addr + col_off);
    wgmma_frags_b<kCols>(acc_dv, pb, do_addr + col_off);
    wgmma_frags_b<kCols>(acc_dk, da, q_addr + col_off);
    wgmma_frags_b<kCols>(acc_dk, db, q_addr + col_off);
    wgmma_commit();
    wgmma_wait<0>();
    pin(acc_dv);
    pin(acc_dk);
    pin(pa);
    pin(pb);
    pin(da);
    pin(db);

    // every warp is done with stage s, the scaled tile and sStat: refill
    // the stage
    cta_sync();
    if (tid == 0 && i + STAGES < n_iter) load_q(i + STAGES);
  }

  // dK * scale and dV in bf16, staged in the K and V tiles (each warpgroup
  // its columns), stored for keys < Skv
  stage_acc<D, kCols>(sK, acc_dk, scale, warp, lane, wg * kCols);
  stage_acc<D, kCols>(sV, acc_dv, 1.f, warp, lane, wg * kCols);
  cta_sync();
  const int64_t row_stride = (int64_t)KVH * DG;  // between positions
  const int64_t at = (((int64_t)b * Skv + k0) * KVH + kvh) * DG;
  store_tile<D, DG>(sK, dk + at, row_stride, Skv - k0, tid, kThreads);
  store_tile<D, DG>(sV, dv + at, row_stride, Skv - k0, tid, kThreads);
}

template <int DG, int NWG, int MIN_BLOCKS, int STAGES>
__global__ void __launch_bounds__(NWG * 128, MIN_BLOCKS)
fa_bwd_dq_sm90_kernel(__grid_constant__ const CUtensorMap tq,
                      __grid_constant__ const CUtensorMap tk,
                      __grid_constant__ const CUtensorMap tv,
                      __grid_constant__ const CUtensorMap tdo,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dq, int Sq, int Skv, int H,
                      int KVH, float scale, int causal, int window,
                      int q_offset) {
  constexpr int D = tile_cols(DG);
  constexpr int kTile = D / kBox * kBoxBytes;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sQ = smem;                         // [NWG][kTile], q * scale
  uint8_t* sdO = sQ + NWG * kTile;            // [NWG][kTile]
  uint8_t* sK = sdO + NWG * kTile;            // [STAGES][kTile]
  uint8_t* sV = sK + STAGES * kTile;          // [STAGES][kTile]
  uint64_t* bars = reinterpret_cast<uint64_t*>(sV + STAGES * kTile);
  const uint32_t bar_q = smem_u32(bars);      // Q and dO arrived
  const uint32_t bar_full = bar_q + 8;        // [STAGES]: K/V arrived
  // [STAGES]: warps done with the stage; the last one refills it
  int* released = reinterpret_cast<int*>(bars + 1 + STAGES);

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int G = H / KVH;
  // the query tiles of one (batch, head group) are adjacent in launch
  // order: they stream the same K/V tiles in the same order, and share them
  // in L2; the ones with the most key tiles first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTileRows;
  const int kvh = blockIdx.y / (G / NWG);
  const int h0 = kvh * G + (blockIdx.y % (G / NWG)) * NWG;
  const int h = h0 + wg;
  const int b = blockIdx.z;

  // the KV tiles that some row of this query tile can see
  const int q_last = min(q0 + kTileRows, Sq) - 1;
  int kv_end = Skv;
  if (causal) kv_end = min(kv_end, q_last + q_offset + 1);
  int kv_begin = 0;
  if (window > 0) kv_begin = max(0, q0 + q_offset - window + 1);
  const int t_begin = kv_begin / kTileRows;
  const int n_tiles =
      kv_end > kv_begin ? (kv_end + kTileRows - 1) / kTileRows - t_begin : 0;

  auto load_kv = [&](int i) {  // the CTA's i-th KV tile into stage i % STAGES
    const int s = i % STAGES;
    const int k0 = (t_begin + i) * kTileRows;
    mbar_expect_tx(bar_full + 8 * s, 2 * kTile);
    tma_load_tile<D>(sK + s * kTile, &tk, bar_full + 8 * s, kvh, k0, b);
    tma_load_tile<D>(sV + s * kTile, &tv, bar_full + 8 * s, kvh, k0, b);
  };

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      released[s] = 0;
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, 2 * NWG * kTile);
    for (int w = 0; w < NWG; ++w) {
      tma_load_tile<D>(sQ + w * kTile, &tq, bar_q, h0 + w, q0, b);
      tma_load_tile<D>(sdO + w * kTile, &tdo, bar_q, h0 + w, q0, b);
    }
    for (int i = 0; i < min(STAGES, n_tiles); ++i) load_kv(i);
  }
  __syncwarp();

  const int r0 = warp * 16 + lane / 4;  // this thread's rows: r0, r0 + 8
  const int c0 = 2 * (lane % 4);        // and keys 8j + c0 (+1)
  // -lse log2 e and delta of this thread's two rows (0 past Sq)
  float nl[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + 8 * r;
    const int64_t at = ((int64_t)b * Sq + row) * H + h;
    nl[r] = row < Sq ? -lse[at] * kLog2e : 0.f;
    dl[r] = row < Sq ? delta[at] : 0.f;
  }

  mbar_wait(bar_q, 0);
  uint8_t* my_q = sQ + wg * kTile;
  scale_tile(my_q, kTile, scale, tid % 128, 128);
  warpgroup_sync(wg);
  const uint32_t q_addr = smem_u32(my_q);
  const uint32_t do_addr = smem_u32(sdO + wg * kTile);
  const int qpos0 = q0 + r0 + q_offset;
  float acc[D / 2];                     // dQ, the m64nD fragment
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES;
    const int k0 = (t_begin + i) * kTileRows;
    const uint32_t k_addr = smem_u32(sK + s * kTile);
    const uint32_t v_addr = smem_u32(sV + s * kTile);
    mbar_wait(bar_full + 8 * s, (i / STAGES) & 1);

    // S = (q scale) K^T and dP = dO V^T, two groups
    float sc[32], dp[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) sc[j] = dp[j] = 0.f;
    wgmma_fence();
    wgmma_tiles_abt<D>(sc, q_addr, k_addr);
    wgmma_commit();
    wgmma_tiles_abt<D>(dp, do_addr, v_addr);
    wgmma_commit();
    wgmma_wait<1>();
    pin(sc);

    // P = exp(S - lse), 0 where masked, rounded to hi + lo as the dK/dV
    // kernel's dV product takes it; sc[4j + 2r + e] is row r0 + 8r, key
    // 8j + c0 + e
    const bool edge =
        k0 + kTileRows > Skv ||
        (causal && k0 + kTileRows - 1 > q0 + q_offset) ||
        (window > 0 && k0 <= q0 + kTileRows - 1 + q_offset - window);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2_approx(fmaf(sc[4 * j + e], kLog2e, nl[e >> 1]));
        if (edge) {
          const int kpos = k0 + 8 * j + c0 + (e & 1);
          const int qpos = qpos0 + 8 * (e >> 1);
          bool ok = kpos < Skv;
          if (causal) ok = ok && kpos <= qpos;
          if (window > 0) ok = ok && kpos > qpos - window;
          if (!ok) p = 0.f;
        }
        sc[4 * j + e] = split_round(p);
      }
    }
    wgmma_wait<0>();                    // dP
    pin(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[4 * j + e] = sc[4 * j + e] * (dp[4 * j + e] - dl[e >> 1]);
    }

    // dQ += dS K, dS as hi + lo; K is the MN-major B operand, as V in the
    // forward's P V
    uint32_t da[4][4], db[4][4];
    to_split_frags(dp, da, db);
    wgmma_fence();
    wgmma_frags_b<D>(acc, da, k_addr);
    wgmma_frags_b<D>(acc, db, k_addr);
    wgmma_commit();
    wgmma_wait<0>();
    pin(acc);
    pin(da);
    pin(db);

    // release the stage: the last of the CTA's warps to be done with it
    // issues the copy of the tile that goes there next
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();   // this warp's reads of the stage are done
      if (atomicAdd(&released[s], 1) == 4 * NWG - 1) {
        released[s] = 0;
        if (i + STAGES < n_tiles) load_kv(i + STAGES);
      }
    }
    __syncwarp();
  }

  // dQ * scale in bf16, staged in this warpgroup's Q tile, rows < Sq
  stage_acc<D>(my_q, acc, scale, warp, lane);
  warpgroup_sync(wg);
  const int64_t row_stride = (int64_t)H * DG;  // between positions in dq
  store_tile<D, DG>(my_q, dq + (((int64_t)b * Sq + q0) * H + h) * DG,
                    row_stride, Sq - q0, tid % 128, 128);
}

// ---- the dQ/dK/dV kernel (D 256, one key tile and one query tile) ----

constexpr int kDsTile = kTileRows * kSwizzleRow;  // a 64 x 64 bf16 tile
constexpr int kDqkvStages = 2;   // the Q/dO ring of fa_bwd_dqkv

// D += A . B for one k-step of 16, both from shared memory: A 64 x 16
// K-major, B 16 x 128 MN-major
__device__ __forceinline__ void wgmma_ss_m64n128_bt(float (&d)[64],
                                                    uint64_t da,
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16\n"
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      " %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      " %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40,"
      " %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53,"
      " %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},\n"
      " %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// The bf16 fragments of dS^T (f[j][i]: key r0 + 8 (i & 1), query rows
// 16 j + 8 (i >> 1) + c0 and + 1, low half first) into a 64 x 64 tile of
// dS, query rows and key columns, laid out as TMA lays out a box with
// 128-byte swizzle: the K-major A operand of dQ = dS K.
__device__ __forceinline__ void store_frags_t(uint8_t* tile,
                                              const uint32_t (&f)[4][4],
                                              int r0, int c0) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = r0 + 8 * (i & 1);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = 16 * j + 8 * (i >> 1) + c0 + e;
        *reinterpret_cast<uint16_t*>(
            tile + m * kSwizzleRow + (((key >> 3) ^ (m & 7)) << 4) +
            (key & 7) * 2) = static_cast<uint16_t>(f[j][i] >> (16 * e));
      }
    }
  }
}

// a 64 x N f32 accumulator times mul, rounded to bf16, into columns
// c0..c0+N-1 of a 64-row tile laid out as TMA lays out its boxes (64
// columns each, 128-byte swizzle), for a TMA store
template <int N>
__device__ __forceinline__ void stage_acc_boxes(uint8_t* tile,
                                                const float (&acc)[N / 2],
                                                float mul, int warp,
                                                int lane, int c0) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + lane / 4 + 8 * r;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int col = c0 + 8 * j;      // a multiple of 8: chunk (col % 64) / 8
      *reinterpret_cast<uint32_t*>(
          tile + (col / kBox) * kBoxBytes + row * kSwizzleRow +
          ((((col % kBox) / 8) ^ (row & 7)) << 4) + (lane % 4) * 4) =
          pack_bf16(acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
    }
  }
}

// the D/64 boxes of a staged 64-row tile to head `head` from row `row` of
// batch b of a tensor map's tensor (rows past its end are not written), as
// one bulk group
template <int D>
__device__ __forceinline__ void tma_store_tile(const uint8_t* src,
                                               const CUtensorMap* map,
                                               int head, int row, int b) {
#pragma unroll
  for (int x = 0; x < D / kBox; ++x)
    asm volatile(
        "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
        " [%0, {%2, %3, %4, %5}], [%1];\n"
        :: "l"(reinterpret_cast<uint64_t>(map)),
           "r"(smem_u32(src + x * kBoxBytes)), "r"(x * kBox), "r"(head),
           "r"(row), "r"(b)
        : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// waits until the bulk groups this thread committed have read their
// shared memory
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// a CTA a (batch, KV head), taking its G query heads in turn
template <int G>
__global__ void __launch_bounds__(256, 1)
fa_bwd_dqkv_sm90_kernel(__grid_constant__ const CUtensorMap tq,
                        __grid_constant__ const CUtensorMap tk,
                        __grid_constant__ const CUtensorMap tv,
                        __grid_constant__ const CUtensorMap tdo,
                        __grid_constant__ const CUtensorMap tdq,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq,
                        __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv, int Sq, int Skv,
                        int H, int KVH, float scale, int causal, int window,
                        int q_offset) {
  constexpr int D = 256;
  constexpr int kTile = D / kBox * kBoxBytes;  // one 64-row tile, 32 KB
  constexpr int kThreads = 256;
  constexpr int kCols = D / 2;     // the columns a warpgroup owns
  constexpr int STAGES = kDqkvStages;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sK = smem;
  uint8_t* sV = sK + kTile;
  uint8_t* sQ = sV + kTile;                   // [STAGES][kTile]
  uint8_t* sdO = sQ + STAGES * kTile;         // [STAGES][kTile]
  uint8_t* sdS = sdO + STAGES * kTile;        // [2][kDsTile]: dS's hi, lo
  float* sStat = reinterpret_cast<float*>(sdS + 2 * kDsTile);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sStat + 2 * kTileRows);
  const uint32_t bar_kv = smem_u32(bars);     // K and V arrived
  const uint32_t bar_full = bar_kv + 8;       // [STAGES]: Q and dO arrived

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int kvh = blockIdx.x;
  const int h0 = kvh * G;                   // this CTA's first query head
  const int b = blockIdx.y;

  auto load_q = [&](int i) {  // head h0 + i's Q and dO into stage i % STAGES
    const int s = i % STAGES;
    mbar_expect_tx(bar_full + 8 * s, 2 * kTile);
    tma_load_tile<D>(sQ + s * kTile, &tq, bar_full + 8 * s, h0 + i, 0, b);
    tma_load_tile<D>(sdO + s * kTile, &tdo, bar_full + 8 * s, h0 + i, 0, b);
  };
  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < STAGES; ++s) mbar_init(bar_full + 8 * s, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_kv, 2 * kTile);
    tma_load_tile<D>(sK, &tk, bar_kv, kvh, 0, b);
    tma_load_tile<D>(sV, &tv, bar_kv, kvh, 0, b);
    for (int i = 0; i < (G < STAGES ? G : STAGES); ++i) load_q(i);
  }

  // thread t's entry of sStat for head h0 + i (t < 128): -lse log2 e of
  // query row t (t < 64) or delta of row t - 64, 0 past Sq
  const bool stats = tid < 2 * kTileRows;
  auto stat = [&](int i) {
    const int row = tid % kTileRows;
    const int64_t at = ((int64_t)b * Sq + row) * H + h0 + i;
    return row >= Sq          ? 0.f
           : tid < kTileRows ? -lse[at] * kLog2e
                             : delta[at];
  };
  float stat_next = stats ? stat(0) : 0.f;

  const int r0 = warp * 16 + lane / 4;  // this thread's keys: r0, r0 + 8
  const int c0 = 2 * (lane % 4);        // and query rows 8j + c0 (+1)
  const uint32_t k_addr = smem_u32(sK);
  const uint32_t v_addr = smem_u32(sV);
  const uint32_t ds_addr = smem_u32(sdS);
  // this warpgroup's columns of an MN-major B operand
  const uint32_t col_off = wg * (kCols / kBox) * kBoxBytes;
  // the scale is a power of 2 (the C entry's condition), so q * scale in
  // bf16 is exact and S^T = scale (K q^T) bitwise: the scale goes into
  // exp2's factor, as in the folded dK/dV loop
  const float p_mul = kLog2e * __bfloat162float(__float2bfloat16_rn(scale));
  float acc_dk[kCols / 2], acc_dv[kCols / 2];
#pragma unroll
  for (int i = 0; i < kCols / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;
  mbar_wait(bar_kv, 0);

  for (int i = 0; i < G; ++i) {
    const int s = i % STAGES;
    uint8_t* q_tile = sQ + s * kTile;
    const uint32_t q_addr = smem_u32(q_tile);
    const uint32_t do_addr = smem_u32(sdO + s * kTile);
    if (stats) {
      sStat[tid] = stat_next;          // the last iteration's reads ended
      if (i + 1 < G) stat_next = stat(i + 1);   // at its last barrier
    }
    mbar_wait(bar_full + 8 * s, (i / STAGES) & 1);
    __syncthreads();                   // sStat in place

    // S^T = K q^T (times the scale in exp2's factor) and dP^T = V dO^T
    // over the whole D, in both warpgroups
    float st[32], dpt[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) st[j] = dpt[j] = 0.f;
    wgmma_fence();
    wgmma_tiles_abt<D>(st, k_addr, q_addr);
    wgmma_commit();
    wgmma_tiles_abt<D>(dpt, v_addr, do_addr);
    wgmma_commit();
    wgmma_wait<1>();
    pin(st);
    // P^T = exp(S^T - lse), masked, with its hi and lo fragments
    uint32_t pa[4][4], pb[4][4], da[4][4], db[4][4];
    probs_t_frags(st, pa, pb, sStat, p_mul, 0, 0, r0, c0, Sq, Skv, causal,
                  window, q_offset);
    // dV += P^T dO on this warpgroup's columns, A as hi + lo, in flight
    // while dS^T is formed
    wgmma_fence();
    wgmma_frags_b<kCols>(acc_dv, pa, do_addr + col_off);
    wgmma_frags_b<kCols>(acc_dv, pb, do_addr + col_off);
    wgmma_commit();
    // dS^T = P^T (dP^T - delta)
    wgmma_wait<1>();
    pin(dpt);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 dl =
          *reinterpret_cast<const float2*>(sStat + kTileRows + 8 * j + c0);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dpt[4 * j + e] =
            st[4 * j + e] * (dpt[4 * j + e] - (e & 1 ? dl.y : dl.x));
    }
    to_split_frags(dpt, da, db);
    // dS for dQ's product: its hi from warpgroup 0, its lo from warpgroup
    // 1 (both formed the same dS^T)
    if (wg == 0)
      store_frags_t(sdS, da, r0, c0);
    else
      store_frags_t(sdS + kDsTile, db, r0, c0);
    fence_proxy_async();

    // dK += dS^T q (times scale in the epilogue) on this warpgroup's
    // columns, A as hi + lo
    wgmma_fence();
    wgmma_frags_b<kCols>(acc_dk, da, q_addr + col_off);
    wgmma_frags_b<kCols>(acc_dk, db, q_addr + col_off);
    wgmma_commit();
    wgmma_wait<0>();
    pin(acc_dv);
    pin(acc_dk);
    pin(pa);
    pin(pb);
    pin(da);
    pin(db);
    __syncthreads();                   // both halves of the dS tile written

    // dQ = dS K on this warpgroup's columns, complete (one key tile): A the
    // dS tile (hi, then lo), B K's columns, MN-major
    float acc_dq[kCols / 2];
#pragma unroll
    for (int j = 0; j < kCols / 2; ++j) acc_dq[j] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < 2; ++t) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_m64n128_bt(
            acc_dq,
            sw128_desc(ds_addr + t * kDsTile + kk * 32, 16, kSwizzleAtom),
            sw128_desc(k_addr + col_off + kk * 2 * kSwizzleAtom, kBoxBytes,
                       kSwizzleAtom));
    }
    wgmma_commit();
    wgmma_wait<0>();
    pin(acc_dq);
    // dQ * scale in bf16, each warpgroup's columns staged in the stage's Q
    // tile (every warp is done with it since the last barrier) and stored
    // by TMA (rows < Sq); the stage is refilled once the store has read it
    stage_acc_boxes<kCols>(q_tile, acc_dq, scale, warp, lane, wg * kCols);
    fence_proxy_async();
    __syncthreads();
    if (tid == 0) {
      tma_store_tile<D>(q_tile, &tdq, h0 + i, 0, b);
      if (i + STAGES < G) {
        tma_store_wait_read();
        load_q(i + STAGES);
      }
    }
  }

  // the last dQ store has read its tile, and the CTA's shared memory
  // outlives it; dK * scale and dV in bf16, staged in the K and V tiles,
  // stored for keys < Skv
  if (tid == 0) tma_store_wait_read();
  __syncthreads();
  const int64_t row_stride = (int64_t)KVH * D;  // between key positions
  const int64_t at = ((int64_t)b * Skv * KVH + kvh) * D;
  stage_acc<D, kCols>(sK, acc_dk, scale, warp, lane, wg * kCols);
  stage_acc<D, kCols>(sV, acc_dv, 1.f, warp, lane, wg * kCols);
  __syncthreads();
  store_tile<D>(sK, dk + at, row_stride, Skv, tid, kThreads);
  store_tile<D>(sV, dv + at, row_stride, Skv, tid, kThreads);
}

// whether scale rounded to bf16 is a power of 2 (D 64's 1/8, D 256's 1/16)
bool pow2_bf16(float scale) {
  int e;
  const float f = __bfloat162float(__float2bfloat16_rn(scale));
  return f > 0.f && std::isnormal(f) && std::frexp(f, &e) == 0.5f;
}

struct Maps {
  CUtensorMap q, k, v, dout;
};

bool encode_all(Maps* m, const void* q, const void* k, const void* v,
                const void* dout, int B, int Sq, int Skv, int H, int KVH,
                int D) {
  return encode(&m->q, q, D, H, Sq, B) && encode(&m->k, k, D, KVH, Skv, B) &&
         encode(&m->v, v, D, KVH, Skv, B) &&
         encode(&m->dout, dout, D, H, Sq, B);
}

template <int DG, int NWG, bool FOLD = false>
cudaError_t launch_dkv(const Maps& m, const void* lse, const void* delta,
                       void* dk, void* dv, int B, int Sq, int Skv, int H,
                       int KVH, float scale, int causal, int window,
                       int q_offset, cudaStream_t stream) {
  constexpr int kTile = tile_cols(DG) / kBox * kBoxBytes;
  constexpr int kRing = FOLD ? kFoldStages : kStages;
  const int smem = 1024 + (2 + 2 * kRing + (NWG > 1)) * kTile +
                   2 * kTileRows * (int)sizeof(float) +
                   8 * (1 + kRing);
  const cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dkv_sm90_kernel<DG, NWG, FOLD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Skv + kTileRows - 1) / kTileRows, KVH, B);
  fa_bwd_dkv_sm90_kernel<DG, NWG, FOLD><<<grid, NWG * 128, smem, stream>>>(
      m.q, m.k, m.v, m.dout, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), Sq, Skv, H, KVH, scale, causal,
      window, q_offset);
  return cudaGetLastError();
}

template <int DG, int NWG>
cudaError_t launch_dq(const Maps& m, const void* lse, const void* delta,
                      void* dq, int B, int Sq, int Skv, int H, int KVH,
                      float scale, int causal, int window, int q_offset,
                      cudaStream_t stream) {
  constexpr int D = tile_cols(DG);
  constexpr int kTile = D / kBox * kBoxBytes;
  constexpr int kMinBlocks = D == 256   ? 1
                             : D == 192 ? kDq192MinBlocks
                             : D == 64  ? kDq64MinBlocks
                                        : kDqMinBlocks;
  constexpr int kRing =
      D == 256 ? kDq256Stages : D == 64 ? kDq64Stages : kDqStages;
  auto kernel = fa_bwd_dq_sm90_kernel<DG, NWG, kMinBlocks, kRing>;
  const int smem = 1024 + (2 * NWG + 2 * kRing) * kTile + 8 * (1 + kRing) +
                   4 * kRing;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kTileRows - 1) / kTileRows, H / NWG, B);
  kernel<<<grid, NWG * 128, smem, stream>>>(
      m.q, m.k, m.v, m.dout, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq), Sq,
      Skv, H, KVH, scale, causal, window, q_offset);
  return cudaGetLastError();
}

template <int G>
cudaError_t launch_dqkv(const Maps& m, const CUtensorMap& tdq,
                        const void* lse, const void* delta,
                        void* dq, void* dk, void* dv, int B, int Sq, int Skv,
                        int H, int KVH, float scale, int causal, int window,
                        int q_offset, cudaStream_t stream) {
  constexpr int kTile = 256 / kBox * kBoxBytes;
  // K, V, the ring and the dS tile, the stats and the barriers
  const int smem = 1024 + (2 + 2 * kDqkvStages) * kTile + 2 * kDsTile +
                   2 * kTileRows * (int)sizeof(float) + 8 * (1 + kDqkvStages);
  auto kernel = fa_bwd_dqkv_sm90_kernel<G>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // a CTA a (KV head, batch)
  kernel<<<dim3(KVH, B), 256, smem, stream>>>(
      m.q, m.k, m.v, m.dout, tdq, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), Sq,
      Skv, H, KVH, scale, causal, window, q_offset);
  return cudaGetLastError();
}

}  // namespace

// The bf16 routes of fa_bwd_dq and fa_bwd_dkv (flash_bwd.cu). Each returns
// a cudaError_t.
cudaError_t fa_bwd_dq_sm90(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dq, int B, int Sq,
                           int Skv, int H, int KVH, int D, float scale,
                           int causal, int window, int q_offset,
                           cudaStream_t stream) {
  Maps m;
  if (!encode_all(&m, q, k, v, dout, B, Sq, Skv, H, KVH, D))
    return cudaErrorInvalidValue;
  const bool group = (H / KVH) % kDqHeads == 0;  // kDqHeads heads a CTA
  if (D == 64)
    return group ? launch_dq<64, kDqHeads>(m, lse, delta, dq, B, Sq, Skv, H,
                                           KVH, scale, causal, window,
                                           q_offset, stream)
                 : launch_dq<64, 1>(m, lse, delta, dq, B, Sq, Skv, H, KVH,
                                    scale, causal, window, q_offset, stream);
  if (D == 96)
    return group ? launch_dq<96, kDqHeads>(m, lse, delta, dq, B, Sq, Skv, H,
                                           KVH, scale, causal, window,
                                           q_offset, stream)
                 : launch_dq<96, 1>(m, lse, delta, dq, B, Sq, Skv, H, KVH,
                                    scale, causal, window, q_offset, stream);
  if (D == 112)
    return group ? launch_dq<112, kDqHeads>(m, lse, delta, dq, B, Sq, Skv, H,
                                            KVH, scale, causal, window,
                                            q_offset, stream)
                 : launch_dq<112, 1>(m, lse, delta, dq, B, Sq, Skv, H, KVH,
                                     scale, causal, window, q_offset, stream);
  if (D == 128)
    return group ? launch_dq<128, kDqHeads>(m, lse, delta, dq, B, Sq, Skv, H,
                                            KVH, scale, causal, window,
                                            q_offset, stream)
                 : launch_dq<128, 1>(m, lse, delta, dq, B, Sq, Skv, H, KVH,
                                     scale, causal, window, q_offset, stream);
  if (D == 192)
    return launch_dq<192, 1>(m, lse, delta, dq, B, Sq, Skv, H, KVH, scale,
                             causal, window, q_offset, stream);
  if (D == 256)
    return launch_dq<256, 1>(m, lse, delta, dq, B, Sq, Skv, H, KVH, scale,
                             causal, window, q_offset, stream);
  return cudaErrorInvalidValue;
}

cudaError_t fa_bwd_dkv_sm90(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv, int B,
                            int Sq, int Skv, int H, int KVH, int D,
                            float scale, int causal, int window, int q_offset,
                            cudaStream_t stream) {
  Maps m;
  if (!encode_all(&m, q, k, v, dout, B, Sq, Skv, H, KVH, D))
    return cudaErrorInvalidValue;
  if (D == 64 && kFolded && Sq > kTileRows && pow2_bf16(scale))
    return launch_dkv<64, 1, true>(m, lse, delta, dk, dv, B, Sq, Skv, H, KVH,
                                   scale, causal, window, q_offset, stream);
  if (D == 64)
    return launch_dkv<64, 1>(m, lse, delta, dk, dv, B, Sq, Skv, H, KVH, scale,
                             causal, window, q_offset, stream);
  if (D == 96)
    return launch_dkv<96, 1>(m, lse, delta, dk, dv, B, Sq, Skv, H, KVH, scale,
                             causal, window, q_offset, stream);
  if (D == 112)
    return launch_dkv<112, 1>(m, lse, delta, dk, dv, B, Sq, Skv, H, KVH,
                              scale, causal, window, q_offset, stream);
  if (D == 128)
    return launch_dkv<128, 1>(m, lse, delta, dk, dv, B, Sq, Skv, H, KVH,
                              scale, causal, window, q_offset, stream);
  if (D == 192)
    return launch_dkv<192, 3>(m, lse, delta, dk, dv, B, Sq, Skv, H, KVH,
                              scale, causal, window, q_offset, stream);
  if (D == 256)
    return launch_dkv<256, 2>(m, lse, delta, dk, dv, B, Sq, Skv, H, KVH,
                              scale, causal, window, q_offset, stream);
  return cudaErrorInvalidValue;
}

// dQ, dK and dV of bf16 inputs in one launch of fa_bwd_dqkv_sm90_kernel, for
// D 256, 1 <= Sq, Skv <= 64 and G = H / KVH in {1, 2, 4, 8}; the arguments
// as fa_bwd_dq's and fa_bwd_dkv's (dtype 1 = bfloat16, the only one taken).
// Returns a cudaError_t (0 = launched; cudaErrorInvalidValue for what it
// does not take).
extern "C" int fa_bwd_dqkv(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dq, void* dk, void* dv,
                           int B, int Sq, int Skv, int H, int KVH, int D,
                           int dtype, float scale, int causal, int window,
                           int q_offset, void* stream) {
  if (dtype != 1 || D != 256 || Sq < 1 || Sq > kTileRows || Skv < 1 ||
      Skv > kTileRows || KVH < 1 || H % KVH != 0 || !pow2_bf16(scale))
    return (int)cudaErrorInvalidValue;
  Maps m;
  CUtensorMap tdq;                     // dQ's, stored by TMA
  if (!encode_all(&m, q, k, v, dout, B, Sq, Skv, H, KVH, D) ||
      !encode(&tdq, dq, D, H, Sq, B))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DQKV(G_)                                                           \
  case G_:                                                                 \
    return launch_dqkv<G_>(m, tdq, lse, delta, dq, dk, dv, B, Sq, Skv, H,  \
                           KVH, scale, causal, window, q_offset, st);
  switch (H / KVH) {
    DQKV(1)
    DQKV(2)
    DQKV(4)
    DQKV(8)
  }
#undef DQKV
  return (int)cudaErrorInvalidValue;
}
