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
//
// dQ/dK/dV kernel at D 192 (fa_bwd_dqkv_sm90_kernel_persistent), G 1 with
// Sq and Skv <= 64 and any scale (deepseek-v2-lite's MLA training steps: S
// 64, H = KVH 16, scale 192^-0.5, v padded to 192):
//  * What bounds it: at deepseek's phase 1 (B 256) it must read q, dO, k,
//    v, lse and delta and write dq, dk and dv, 706.7 MB (0.2110 ms at 3.35
//    TB/s), 88.3 MB at phase 2 (B 32); the products are ~16 GFLOP at phase
//    1, twice that as hi + lo (~33 us at 989 TFLOP/s): bytes. The pair
//    read q, dO, k and v twice (139 MB at phase 2).
//  * At G 1 the D-256 kernel's loop over a KV head's query heads has one
//    iteration, and a CTA of a (batch, head) would run its load, products
//    and stores in turn. So one CTA an SM (two stages of Q, K, V and dO,
//    192 KB, and the scaled Q: 218 KB in all) takes the (batch, head) items
//    blockIdx.x + n gridDim.x in turn; the item after next loads while
//    this one runs.
//  * Roles, each product once over the whole D (m64n192): warpgroup 0
//    forms S^T = K (q scale)^T and P^T, writes P^T's hi and lo to two
//    tiles (key rows) in the scaled tile, and takes dV = P^T dO with A in
//    registers; warpgroup 1 forms dP^T = V dO^T, reads P^T back (the value
//    dV takes), forms dS^T, writes dS transposed as hi and lo tiles in V,
//    and takes dK = dS^T q with A in registers; warpgroup 2 takes dQ = dS K
//    from those tiles. Each stages its product in bf16 in the tile only it
//    still reads (dV in dO's, dK * scale in Q's, dQ * scale in K's). At the
//    next item's first barrier warp 8 (warpgroup 2's first) stores the
//    three by TMA (rows past Sq, Skv not written), waits until the stores
//    have read them and refills the stage; it takes no part in the q
//    scaling, which starts each item's critical path. lse and delta arrive
//    by cp.async one item ahead (a load into registers, one item ahead too,
//    held warpgroup 0 at each item's start).
//  * A CTA takes each item whole and nothing is summed across items (no
//    atomics): dq, dk and dv of a (batch, head) do not depend on which CTA
//    took it, on B or on the card; a batch's bits are those of a launch on
//    it alone. Rounding points as above (q * scale in bf16 in its own tile:
//    192^-0.5 is not a power of 2 in bf16).
//  * Not kept (ab_flash_bwd.py, NVIDIA H100 80GB HBM3, 700.00 W; figures
//    in PERF.md, PR 29): each warpgroup owning a 64-column box of all
//    three products, from shared hi + lo tiles (SS m64n64: three products
//    a k-step read twice the shared memory of one m64n192 with A in
//    registers), with S^T, P^T, dP^T and dS^T formed by every warpgroup,
//    or once, or by each warpgroup for its own query rows (fastest: 0.2826
//    ms at phase 1 against this kernel's 0.2687); the stores from shared
//    memory by the warpgroups; each warpgroup storing its own output and
//    refilling its tile. ptxas: 168 registers, 8 bytes spilled.
// Not here: a producer warp with setmaxnreg, or a fused delta; and at D 256
// S^T and dP^T formed once a CTA (one warpgroup each, exchanged through
// shared memory): the exchange needs 32 KB more than the 227 KB a CTA may
// hold beside the ring.

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

// ---- the persistent dQ/dK/dV kernel (D 192, G 1, one key tile and one
// query tile) ----

// D (+)= A . B for one k-step of 16, both from shared memory: A 64 x 16
// K-major, B 16 x 192 MN-major
__device__ __forceinline__ void wgmma_ss_m64n192_bt(float (&d)[96],
                                                    uint64_t da, uint64_t db,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16\n"
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      " %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      " %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40,"
      " %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53,"
      " %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66,"
      " %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92,"
      " %93, %94, %95},\n"
      " %96, %97, p, 1, 1, 0, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "l"(da), "l"(db), "r"(scale_d));
}

// named barriers of the persistent kernel (0 is __syncthreads): the seven
// warps that scale q (warpgroup 0 and warps 9-11); P^T's tiles written and
// dP^T done (warpgroups 0 and 1); dS's tiles written (arrived at by
// warpgroup 1, waited on by warpgroup 2)
__device__ __forceinline__ void bar_scaled() {
  asm volatile("bar.sync 4, 224;\n" ::: "memory");
}
__device__ __forceinline__ void bar_probs() {
  asm volatile("bar.sync 5, 256;\n" ::: "memory");
}
__device__ __forceinline__ void bar_ds_arrive() {
  asm volatile("bar.arrive 6, 256;\n" ::: "memory");
}
__device__ __forceinline__ void bar_ds_sync() {
  asm volatile("bar.sync 6, 256;\n" ::: "memory");
}

// The bf16 fragments of a 64 x 64 transposed-score tile (f[j][i]: key r0 +
// 8 (i & 1), query rows 16 j + 8 (i >> 1) + c0 and + 1, low half first)
// into a tile with key rows and query columns, 128-byte swizzled: P^T's
// hi or lo for another warpgroup, which reads it back in the same layout
__device__ __forceinline__ void store_frags(uint8_t* tile,
                                            const uint32_t (&f)[4][4], int r0,
                                            int c0) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = r0 + 8 * (i & 1);
      const int m = 16 * j + 8 * (i >> 1) + c0;
      *reinterpret_cast<uint32_t*>(tile + key * kSwizzleRow +
                                   (((m >> 3) ^ (key & 7)) << 4) +
                                   (m & 7) * 2) = f[j][i];
    }
  }
}

// P^T = hi + lo read back from the two tiles that store_frags wrote, in
// the accumulator fragment's order (st[4j + e]: key r0 + 8 (e >> 1), query
// row 8j + c0 + (e & 1)): the value probs_t_frags formed
__device__ __forceinline__ void load_probs_t(float (&st)[32],
                                             const uint8_t* hi,
                                             const uint8_t* lo, int r0,
                                             int c0) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int key = r0 + 8 * e2;
      const int at = key * kSwizzleRow + ((j ^ (key & 7)) << 4) + c0 * 2;
      const float2 h = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(hi + at));
      const float2 l = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(lo + at));
      st[4 * j + 2 * e2] = h.x + l.x;
      st[4 * j + 2 * e2 + 1] = h.y + l.y;
    }
  }
}

// acc = A . B over 64 rows, A as hi + lo: two 64 x 64 K-major tiles in
// shared memory (hi, lo), B a 64 x 192 tile, MN-major; issued but not
// committed
__device__ __forceinline__ void wgmma_split_tiles_b(float (&acc)[96],
                                                    uint32_t a_hi,
                                                    uint32_t a_lo,
                                                    uint32_t b) {
#pragma unroll
  for (int t = 0; t < 2; ++t) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_m64n192_bt(
          acc, sw128_desc((t ? a_lo : a_hi) + kk * 32, 16, kSwizzleAtom),
          sw128_desc(b + kk * 2 * kSwizzleAtom, kBoxBytes, kSwizzleAtom),
          t | kk);
  }
}

// one 4-byte element from global to shared memory without the registers
// (cp.async; 0 if !valid), in this thread's current group
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// Built with DQKV_PROF defined (ab_flash_bwd.py --phases), the persistent
// kernel adds up, in each warpgroup's first thread, the SM clocks from one
// stamp to the next (DQKV_STAMP(k): the clocks since stamp k - 1 go to
// phase k; phase 0 runs from the item before), over all CTAs, in
// g_dqkv_prof[warpgroup][phase], read and reset by dqkv_prof().
#ifdef DQKV_PROF
__device__ unsigned long long g_dqkv_prof[3][8];
#define DQKV_STAMP(k)                                        \
  if (tid % 128 == 0) {                                      \
    const unsigned long long now = clock64();                \
    sprof[wg][k] += now - prof_last;                         \
    prof_last = now;                                         \
  }
#else
#define DQKV_STAMP(k)
#endif

// A persistent CTA of three warpgroups, one CTA an SM; it takes the
// (batch, head) items blockIdx.x, + gridDim.x, ... in turn, with each
// item's Q, K, V and dO tiles in a ring of kDqkvStages (the item after
// next loads while this one runs). Warpgroup 0 forms S^T and P^T, and dV;
// warpgroup 1 dP^T and dS^T, and dK; warpgroup 2 dQ; each product over the
// whole D. Warp 8 (the first of warpgroup 2) stores an item's outputs and
// refills its stage at the next item's start. Stamps (DQKV_PROF): 0 (0)
// passed, 1 the item's tiles in; warpgroup 0: 2 q scaled, 3 P^T written,
// 4 (P), 5 dV done, 6 dV staged; warpgroup 1: 2 dP^T done, 3 (P), 4 dS
// written, 5 dK done, 6 dK staged; warpgroup 2 (warp 8's first thread): 2
// (D), 3 dQ done, 4 dQ staged.
template <int DG>
__global__ void __launch_bounds__(DG / kBox * 128, 1)
fa_bwd_dqkv_sm90_kernel_persistent(
    __grid_constant__ const CUtensorMap tq,
    __grid_constant__ const CUtensorMap tk,
    __grid_constant__ const CUtensorMap tv,
    __grid_constant__ const CUtensorMap tdo,
    __grid_constant__ const CUtensorMap tdq,
    __grid_constant__ const CUtensorMap tdk,
    __grid_constant__ const CUtensorMap tdv, const float* __restrict__ lse,
    const float* __restrict__ delta, int B, int Sq, int Skv, int H,
    float scale, int causal, int window, int q_offset) {
  constexpr int D = DG;
  static_assert(D == 3 * kBox, "three warpgroups");
  constexpr int kTile = D / kBox * kBoxBytes;  // one 64-row tile, 24 KB
  constexpr int STAGES = kDqkvStages;
  static_assert(2 * kDsTile <= kTile, "dS's hi and lo fit the V tile");
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  // stage s: the Q, K, V and dO tiles (t = 0..3) at (4 s + t) kTile; then
  // q * scale in bf16, two items' -lse log2 e [64] and delta [64] (by
  // item parity), the stages' barriers
  auto tile = [&](int s, int t) { return smem + (4 * s + t) * kTile; };
  uint8_t* sQs = smem + 4 * STAGES * kTile;
  float* sStat = reinterpret_cast<float*>(sQs + kTile);   // [2][128]
  uint64_t* bars = reinterpret_cast<uint64_t*>(sStat + 4 * kTileRows);
  const uint32_t bar_full = smem_u32(bars);   // [STAGES]: the item arrived

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const bool io_warp = tid / 32 == 8;   // the storing warp
  const bool io = tid == 256;           // and its first thread
  // item i of this CTA: (batch, head) blockIdx.x + i gridDim.x, head fastest
  const int n_items = B * H;
  const int n_local = n_items > (int)blockIdx.x
                          ? (n_items - 1 - (int)blockIdx.x) / gridDim.x + 1
                          : 0;
  auto item = [&](int i) { return (int)blockIdx.x + i * (int)gridDim.x; };

  auto load = [&](int i) {  // item i's Q, K, V, dO into stage i % STAGES
    const int s = i % STAGES, b = item(i) / H, h = item(i) % H;
    const uint32_t bar = bar_full + 8 * s;
    mbar_expect_tx(bar, 4 * kTile);
    tma_load_tile<D>(tile(s, 0), &tq, bar, h, 0, b);
    tma_load_tile<D>(tile(s, 1), &tk, bar, h, 0, b);
    tma_load_tile<D>(tile(s, 2), &tv, bar, h, 0, b);
    tma_load_tile<D>(tile(s, 3), &tdo, bar, h, 0, b);
  };
  // item i's dq, dk and dv, staged in its stage's K, Q and dO tiles, out
  // (rows past Sq, Skv are not written), as one bulk group
  auto store = [&](int i) {
    const int s = i % STAGES, b = item(i) / H, h = item(i) % H;
    tma_store_tile<D>(tile(s, 1), &tdq, h, 0, b);
    tma_store_tile<D>(tile(s, 0), &tdk, h, 0, b);
    tma_store_tile<D>(tile(s, 3), &tdv, h, 0, b);
  };
  // warpgroup 0's thread t: its entry of item i's stats, copied into
  // sStat[i & 1] (lse of query row t < 64, delta of row t - 64; 0 past Sq)
  auto fetch_stat = [&](int i) {
    const int row = tid % kTileRows;
    const int64_t at =
        ((int64_t)(item(i) / H) * Sq + (row < Sq ? row : 0)) * H +
        item(i) % H;
    cp_async_4(sStat + (i & 1) * 2 * kTileRows + tid,
               (tid < kTileRows ? lse : delta) + at, row < Sq);
  };
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(bar_full + 8 * s, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (io)
    for (int i = 0; i < (n_local < STAGES ? n_local : STAGES); ++i) load(i);
  if (wg == 0 && n_local > 0) fetch_stat(0);
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  const int r0 = warp * 16 + lane / 4;  // this thread's keys: r0, r0 + 8
  const int c0 = 2 * (lane % 4);        // and query rows 8j + c0 (+1)
  const float sc = __bfloat162float(__float2bfloat16_rn(scale));
#ifdef DQKV_PROF
  __shared__ unsigned long long sprof[3][8];
  if (tid < 24) sprof[tid / 8][tid % 8] = 0;
  __syncthreads();
  unsigned long long prof_last = clock64();
#endif

  for (int i = 0; i < n_local; ++i) {
    const int s = i % STAGES;
    uint8_t* sQ = tile(s, 0);
    uint8_t* sK = tile(s, 1);
    uint8_t* sV = tile(s, 2);
    uint8_t* sdO = tile(s, 3);
    const uint32_t q_addr = smem_u32(sQ), k_addr = smem_u32(sK);
    const uint32_t v_addr = smem_u32(sV), do_addr = smem_u32(sdO);
    float* stat = sStat + (i & 1) * 2 * kTileRows;
    // the hi + lo tiles: P^T (key rows) in the scaled tile's boxes 0, 1
    // once S^T is done, for warpgroup 1; dS (query rows) in V's boxes 0, 1
    // once dP^T is done, for warpgroup 2
    uint8_t* sPt = sQs;
    uint8_t* sDs = sV;
    // (0) every thread is done with the item before, its outputs staged
    __syncthreads();
    DQKV_STAMP(0)
    if (io_warp) {
      // the item before leaves; once its stores have read their tiles,
      // the item after this goes into that stage
      if (io && i >= 1) {
        store(i - 1);
        tma_store_wait_read();
        if (i + 1 < n_local) load(i + 1);
      }
      __syncwarp();
    }
    if (wg == 0 && i + 1 < n_local) fetch_stat(i + 1);
    if (wg == 0) asm volatile("cp.async.commit_group;\n" ::: "memory");
    mbar_wait(bar_full + 8 * s, (i / STAGES) & 1);
    DQKV_STAMP(1)

    if (wg == 0) {
      // q * scale in bf16 for S^T (the scale is not a power of 2 in bf16),
      // by warpgroup 0 and warps 9-11; the tile is free: the item before
      // is done
      const uint4* qv = reinterpret_cast<const uint4*>(sQ);
      uint4* qs = reinterpret_cast<uint4*>(sQs);
      for (int c = tid; c < kTile / 16; c += 224)
        qs[c] = scale_chunk(qv[c], sc);
      // this item's stats have arrived (the next item's may not have): lse
      // to -lse log2 e, in place
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      if (tid < kTileRows) stat[tid] *= -kLog2e;
      fence_proxy_async();
      bar_scaled();
      DQKV_STAMP(2)
      // S^T = K (q scale)^T over the whole D; P^T = exp(S^T - lse),
      // masked, as hi + lo: the A fragments of dV, and into their tiles
      // for warpgroup 1 (only S^T has read those boxes)
      float st[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) st[j] = 0.f;
      wgmma_fence();
      wgmma_tiles_abt<D>(st, k_addr, smem_u32(sQs));
      wgmma_commit();
      wgmma_wait<0>();
      pin(st);
      uint32_t pa[4][4], pb[4][4];
      probs_t_frags(st, pa, pb, stat, kLog2e, 0, 0, r0, c0, Sq, Skv, causal,
                    window, q_offset);
      store_frags(sPt, pa, r0, c0);
      store_frags(sPt + kDsTile, pb, r0, c0);
      DQKV_STAMP(3)
      bar_probs();                      // (P)
      DQKV_STAMP(4)
      // dV = P^T dO over the whole D, A as hi + lo; into the dO tile in
      // bf16 (dP^T has read it: (P))
      float acc[96];
#pragma unroll
      for (int j = 0; j < 96; ++j) acc[j] = 0.f;
      wgmma_fence();
      wgmma_frags_b<D>(acc, pa, do_addr);
      wgmma_frags_b<D>(acc, pb, do_addr);
      wgmma_commit();
      wgmma_wait<0>();
      pin(acc);
      pin(pa);
      pin(pb);
      DQKV_STAMP(5)
      stage_acc_boxes<D>(sdO, acc, 1.f, warp, lane, 0);
      DQKV_STAMP(6)
    } else if (wg == 1) {
      // dP^T = V dO^T over the whole D
      float dpt[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) dpt[j] = 0.f;
      wgmma_fence();
      wgmma_tiles_abt<D>(dpt, v_addr, do_addr);
      wgmma_commit();
      wgmma_wait<0>();
      pin(dpt);
      DQKV_STAMP(2)
      bar_probs();                      // (P) P^T's tiles written
      DQKV_STAMP(3)
      // dS^T = P^T (dP^T - delta), P^T as dV takes it, as hi + lo: the A
      // fragments of dK, and transposed into dS's tiles for warpgroup 2
      // (only dP^T has read V)
      float st[32];
      load_probs_t(st, sPt, sPt + kDsTile, r0, c0);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 dl =
            *reinterpret_cast<const float2*>(stat + kTileRows + 8 * j + c0);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dpt[4 * j + e] =
              st[4 * j + e] * (dpt[4 * j + e] - (e & 1 ? dl.y : dl.x));
      }
      uint32_t da[4][4], db[4][4];
      to_split_frags(dpt, da, db);
      store_frags_t(sDs, da, r0, c0);
      store_frags_t(sDs + kDsTile, db, r0, c0);
      fence_proxy_async();
      bar_ds_arrive();                  // (D) dS's tiles written
      DQKV_STAMP(4)
      // dK = dS^T q over the whole D (times scale in the epilogue), A as
      // hi + lo, B the Q tile as it came; into the Q tile in bf16 (the
      // scaling has read it: (P) after the scaling's barrier)
      float acc[96];
#pragma unroll
      for (int j = 0; j < 96; ++j) acc[j] = 0.f;
      wgmma_fence();
      wgmma_frags_b<D>(acc, da, q_addr);
      wgmma_frags_b<D>(acc, db, q_addr);
      wgmma_commit();
      wgmma_wait<0>();
      pin(acc);
      pin(da);
      pin(db);
      DQKV_STAMP(5)
      stage_acc_boxes<D>(sQ, acc, scale, warp, lane, 0);
      DQKV_STAMP(6)
    } else {
      if (!io_warp) {                   // warps 9-11: their share of q * scale
        const uint4* qv = reinterpret_cast<const uint4*>(sQ);
        uint4* qs = reinterpret_cast<uint4*>(sQs);
        for (int c = tid - 160; c < kTile / 16; c += 224)
          qs[c] = scale_chunk(qv[c], sc);
        fence_proxy_async();
        bar_scaled();
      }
      bar_ds_sync();                    // (D)
      DQKV_STAMP(2)
      // dQ = dS K over the whole D, complete (one key tile): A dS's tiles
      // (hi, then lo), B the K tile, MN-major; into the K tile in bf16
      // (S^T has read it: (P) before (D))
      float acc[96];
#pragma unroll
      for (int j = 0; j < 96; ++j) acc[j] = 0.f;
      wgmma_fence();
      wgmma_split_tiles_b(acc, smem_u32(sDs), smem_u32(sDs + kDsTile),
                          k_addr);
      wgmma_commit();
      wgmma_wait<0>();
      pin(acc);
      DQKV_STAMP(3)
      stage_acc_boxes<D>(sK, acc, scale, warp, lane, 0);
      DQKV_STAMP(4)
    }
    fence_proxy_async();                // for warp 8's stores
  }
  // the last item leaves; the CTA's shared memory outlives the stores'
  // reads
  __syncthreads();
  if (io && n_local > 0) {
    store(n_local - 1);
    tma_store_wait_read();
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#ifdef DQKV_PROF
  __syncthreads();
  if (tid < 24)
    atomicAdd(&g_dqkv_prof[tid / 8][tid % 8], sprof[tid / 8][tid % 8]);
#endif
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

template <int DG>
cudaError_t launch_dqkv_persistent(const Maps& m, const CUtensorMap& tdq,
                                   const CUtensorMap& tdk,
                                   const CUtensorMap& tdv, const void* lse,
                                   const void* delta, int B, int Sq, int Skv,
                                   int H, float scale, int causal, int window,
                                   int q_offset, cudaStream_t stream) {
  constexpr int kTile = DG / kBox * kBoxBytes;
  // the stages' Q, K, V and dO, the scaled Q, two items' stats and the
  // barriers
  const int smem = 1024 + (4 * kDqkvStages + 1) * kTile +
                   4 * kTileRows * (int)sizeof(float) + 8 * kDqkvStages;
  auto kernel = fa_bwd_dqkv_sm90_kernel_persistent<DG>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // one CTA an SM (its shared memory), each taking (batch, head) items in
  // turn
  const int items = B * H;
  kernel<<<items < sms ? items : sms, DG / kBox * 128, smem, stream>>>(
      m.q, m.k, m.v, m.dout, tdq, tdk, tdv, static_cast<const float*>(lse),
      static_cast<const float*>(delta), B, Sq, Skv, H, scale, causal, window,
      q_offset);
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

// dQ, dK and dV of bf16 inputs in one launch, for 1 <= Sq, Skv <= 64 and
// either D 256, G = H / KVH in {1, 2, 4, 8} and a power-of-2 scale in bf16
// (fa_bwd_dqkv_sm90_kernel), or D 192, G 1 and any finite scale
// (fa_bwd_dqkv_sm90_kernel_persistent); the arguments as fa_bwd_dq's and
// fa_bwd_dkv's (dtype 1 = bfloat16, the only one taken). Returns a
// cudaError_t (0 = launched; cudaErrorInvalidValue for what it does not
// take).
#ifdef DQKV_PROF
// g_dqkv_prof (3 x 8 sums) into out, then zeroed; returns a cudaError_t
extern "C" int dqkv_prof(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_dqkv_prof, sizeof(g_dqkv_prof));
  const unsigned long long z[24] = {0};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_dqkv_prof, z, sizeof(z));
  return (int)e;
}
#endif

extern "C" int fa_bwd_dqkv(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dq, void* dk, void* dv,
                           int B, int Sq, int Skv, int H, int KVH, int D,
                           int dtype, float scale, int causal, int window,
                           int q_offset, void* stream) {
  const bool d256 = D == 256 && pow2_bf16(scale);
  const bool d192 = D == 192 && H == KVH && std::isfinite(scale);
  if (dtype != 1 || Sq < 1 || Sq > kTileRows || Skv < 1 ||
      Skv > kTileRows || KVH < 1 || H % KVH != 0 || !(d256 || d192))
    return (int)cudaErrorInvalidValue;
  Maps m;
  CUtensorMap tdq;                     // dQ's, stored by TMA
  if (!encode_all(&m, q, k, v, dout, B, Sq, Skv, H, KVH, D) ||
      !encode(&tdq, dq, D, H, Sq, B))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d192) {
    CUtensorMap tdk, tdv;              // dK's and dV's, stored by TMA too
    if (!encode(&tdk, dk, D, KVH, Skv, B) || !encode(&tdv, dv, D, KVH, Skv, B))
      return (int)cudaErrorInvalidValue;
    return launch_dqkv_persistent<192>(m, tdq, tdk, tdv, lse, delta, B, Sq,
                                       Skv, H, scale, causal, window,
                                       q_offset, st);
  }
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
