// Flash-attention forward for bf16 on NVIDIA Hopper (sm_90a), written by
// hand: both products on wgmma tensor cores, Q/K/V tiles fed by TMA.
//
// Replaces, for bf16 inputs, the Pallas TPU kernel
//   repro/kernels/flash_attention/kernel.py::_fa_kernel
// (f32 inputs stay on fa_fwd_kernel<float, D> in flash_fwd.cu: the tensor
// cores would take f32 as TF32). The contract is flash_fwd.cu's: q
// (B,Sq,H,D), k, v (B,Skv,KVH,D), D in {64, 128}, GQA with query head h on
// KV head h / (H / KVH); padding, causal, window and q_offset masks;
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
// ~202.4 MB (60.4 us) against 4.4 GFLOP. Both are bound by bytes, so the
// design reads each K/V byte once per (KV head, query tile) and keeps S, P
// and O out of device memory.
//
// Design:
//  * A CTA is one (batch, KV head, 64-row query tile) with NWG consumer
//    warpgroups (2 when the group size G is even, else 1); warpgroup w owns
//    the 64 rows of one query head of the group. G = 4 splits the group
//    over two CTAs. Every K/V tile in shared memory serves all of the CTA's
//    warpgroups.
//  * TMA: 4-D tensor maps over (D, heads, S, B) with boxes of 64 columns x
//    64 rows of one head and 128-byte swizzle (a D-128 row, 256 bytes, is
//    two boxes). Rows past Sq or Skv come in zero-filled and batch edges
//    stay edges. One thread issues each copy; an mbarrier with expect_tx
//    reports each arrival. K/V tiles of 64 keys sit in a ring of two
//    stages, so the next tile's copy is in flight while this one is
//    computed. A stage is refilled by the last of the CTA's warps to be
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
//    FP32 and special-function work, not the tensor cores, paces a tile.
//  * O += P.V: wgmma m64nDk16 with A = p in registers (the fragment of
//    S columns 16j..16j+15 is the A fragment of k-step j) and B = V from
//    shared memory, MN-major (D contiguous; transpose-B). The next tile's
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
//  * __launch_bounds__(threads, 2): two CTAs an SM (four warpgroups) hide
//    each other's latency; at D 128 that caps the kernel at 128 registers
//    (127 used, no spills; 160 without the bound, and slower).
// Not here: a producer warp with setmaxnreg, persistent CTAs, clusters,
// the ping-pong of two warpgroups, or overlap of one tile's softmax with
// the next tile's S (that needs a second S accumulator, 32 more registers
// than the 2-CTA bound leaves).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;        // NEG_INF of the TPU kernel
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRows = 64;                // query rows per warpgroup (M)
constexpr int kBlockK = 64;              // keys per KV tile
constexpr int kStages = 2;               // K/V ring depth
constexpr int kBox = 64;                 // columns per TMA box (128 bytes)
constexpr int kBoxBytes = kBox * 64 * 2; // one 64-row box, 8 KB
constexpr int kSwizzleRow = 128;         // bytes per swizzled row
constexpr int kSwizzleAtom = 8 * kSwizzleRow;  // 8 rows: the SBO

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Spins until the barrier's phase of this parity has completed. A wait
// that never ends (a fault in the pipeline) traps after ~2^28 polls, so it
// surfaces as a launch error rather than a hung card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  uint32_t polls = 0;
  do {
    if (++polls == (1u << 28)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// one box of a 4-D tensor map at (c0, c1, c2, c3), innermost first
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// waits until at most N committed wgmma groups are still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Pins registers that an in-flight wgmma writes or reads: no use of an
// accumulator moves above the wait, and no operand register is reused
// before it.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]));
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]));
}

// the 128 threads of warpgroup wg, on named barrier 1 + wg (an immediate:
// a barrier id in a register makes ptxas reserve all 16 for the CTA)
__device__ __forceinline__ void warpgroup_sync(int wg) {
  if (wg == 0)
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
  else
    asm volatile("bar.sync 2, 128;\n" ::: "memory");
}

// 2^x on the special-function unit (what __expf uses after its multiply)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D (+)= A . B for one k-step of 16: A 64 x 16 (shared memory, or four
// registers of bf16 pairs), B 16 x N; d is the m64nN f32 fragment.
__device__ __forceinline__ void wgmma_ss_m64n64(
    float (&d)[32], uint64_t da, uint64_t db,
    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16\n"
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},\n"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_m64n64(
    float (&d)[32], const uint32_t (&a)[4],
    uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16\n"
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},\n"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_m64n128(
    float (&d)[64], const uint32_t (&a)[4],
    uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16\n"
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      " %60, %61, %62, %63},\n"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}


template <int D, int NWG>
__global__ void __launch_bounds__(NWG * 128, 2)
fa_fwd_sm90_kernel(__grid_constant__ const CUtensorMap tq,
                   __grid_constant__ const CUtensorMap tk,
                   __grid_constant__ const CUtensorMap tv,
                   __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                   int Sq, int Skv, int H, int KVH, float scale, int causal,
                   int window, int q_offset) {
  constexpr int kBoxes = D / kBox;
  constexpr int kTile = kBoxes * kBoxBytes;  // one 64-row tile of Q, K or V
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // every tile on a 1024-byte boundary: the period of the 128-byte swizzle
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sQ = smem;                         // [NWG][kTile]
  uint8_t* sK = sQ + NWG * kTile;             // [kStages][kTile]
  uint8_t* sV = sK + kStages * kTile;         // [kStages][kTile]
  uint64_t* bars = reinterpret_cast<uint64_t*>(sV + kStages * kTile);
  const uint32_t bar_q = smem_u32(bars);      // Q arrived
  const uint32_t bar_full = bar_q + 8;        // [kStages]: K/V arrived
  // [kStages]: warps done with the stage; the last one refills it
  int* released = reinterpret_cast<int*>(bars + 1 + kStages);

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int G = H / KVH;
  const int kvh = blockIdx.x / (G / NWG);
  const int h0 = kvh * G + (blockIdx.x % (G / NWG)) * NWG;
  const int h = h0 + wg;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kRows;  // longest first

  // KV tiles that some row of this query tile can see
  const int q_last = min(q0 + kRows, Sq) - 1;
  int kv_end = Skv;
  if (causal) kv_end = min(kv_end, q_last + q_offset + 1);
  int kv_begin = 0;
  if (window > 0) kv_begin = max(0, q0 + q_offset - window + 1);
  const int t_begin = kv_begin / kBlockK;
  const int n_tiles =
      kv_end > kv_begin ? (kv_end + kBlockK - 1) / kBlockK - t_begin : 0;

  auto load_kv = [&](int i) {  // the CTA's i-th KV tile into stage i % kStages
    const int s = i % kStages;
    const int k0 = (t_begin + i) * kBlockK;
    mbar_expect_tx(bar_full + 8 * s, 2 * kTile);
#pragma unroll
    for (int x = 0; x < kBoxes; ++x) {
      tma_load(smem_u32(sK + s * kTile + x * kBoxBytes), &tk, bar_full + 8 * s,
               x * kBox, kvh, k0, b);
      tma_load(smem_u32(sV + s * kTile + x * kBoxBytes), &tv, bar_full + 8 * s,
               x * kBox, kvh, k0, b);
    }
  };

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      released[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, NWG * kTile);
    for (int w = 0; w < NWG; ++w)
      for (int x = 0; x < kBoxes; ++x)
        tma_load(smem_u32(sQ + w * kTile + x * kBoxBytes), &tq, bar_q,
                 x * kBox, h0 + w, q0, b);
    for (int i = 0; i < min(kStages, n_tiles); ++i) load_kv(i);
  }
  __syncwarp();

  // q * scale in bf16 on this warpgroup's Q tile, as the plain version
  // takes it (elementwise, so the swizzle does not matter)
  mbar_wait(bar_q, 0);
  uint8_t* my_q = sQ + wg * kTile;
  {
    const float sc = __bfloat162float(__float2bfloat16_rn(scale));
    uint4* qv = reinterpret_cast<uint4*>(my_q);
    for (int i = tid % 128; i < kTile / 16; i += 128) {
      uint4 x = qv[i];
      __nv_bfloat162* hx = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(hx[j]);
        hx[j] = __floats2bfloat162_rn(f.x * sc, f.y * sc);
      }
      qv[i] = x;
    }
  }
  // the generic-proxy writes above, before the wgmma (async proxy) reads
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
      wgmma_ss_m64n64(sc, sw128_desc(q_addr + off, 16, kSwizzleAtom),
                      sw128_desc(k_addr + off, 16, kSwizzleAtom), kk > 0);
    }
    wgmma_commit();
  };
  if (n_tiles > 0) issue_s(0);

  for (int i = 0; i < n_tiles; ++i) {
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
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int x = 0; x < 4; ++x)
        pa[j][x] = pack_bf16(sc[8 * j + 2 * x], sc[8 * j + 2 * x + 1]);
    }

    // O += P . V; V is the MN-major B operand: LBO steps a 64-column box,
    // SBO 8 keys, and a k-step of 16 keys is 2 KB
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint64_t dv = sw128_desc(v_addr + j * 2 * kSwizzleAtom, kBoxBytes,
                                     kSwizzleAtom);
      if constexpr (D == 64)
        wgmma_rs_m64n64(acc, pa[j], dv, 1);
      else
        wgmma_rs_m64n128(acc, pa[j], dv, 1);
    }
    wgmma_commit();
    // the next tile's S runs on the tensor cores behind this P.V
    if (i + 1 < n_tiles) {
      issue_s(i + 1);
      wgmma_wait<1>();   // this P.V; the next S may still run
    } else {
      wgmma_wait<0>();
    }
    pin(acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) pin(pa[j]);

    // release the stage: the last of the CTA's warps to be done with it
    // issues the copy of the tile that goes there next, so no warp waits
    // for another warpgroup
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();   // this warp's reads of the stage are done
      if (atomicAdd(&released[s], 1) == 4 * NWG - 1) {
        released[s] = 0;
        if (i + kStages < n_tiles) load_kv(i + kStages);
      }
    }
    __syncwarp();
  }

  // epilogue: O / l in bf16, staged in this warpgroup's Q tile as [64][D]
  // with 16-byte chunk c of row r at c ^ (r & 7), then stored 16 bytes a
  // thread for rows < Sq; lse = m + log(l), 0 for rows that saw no key
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const int64_t row_stride = (int64_t)H * D;  // between positions in o
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
  constexpr int kChunks = D / 8;             // 16-byte chunks per row
  __nv_bfloat16* ob = o + ((int64_t)b * Sq * H + h) * D;
  for (int i = tid % 128; i < kRows * kChunks; i += 128) {
    const int row = i / kChunks, c = i % kChunks;
    if (q0 + row < Sq)
      *reinterpret_cast<uint4*>(ob + (q0 + row) * row_stride + c * 8) =
          *reinterpret_cast<const uint4*>(my_q + row * D * 2 +
                                          ((c ^ (row & 7)) * 16));
  }
}

// cuTensorMapEncodeTiled, reached through the runtime (no libcuda link)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a contiguous bf16 (B, S, heads, D) tensor as a 4-D map over
// (D, heads, S, B), in boxes of 64 columns x 64 rows of one head
bool encode(CUtensorMap* map, const void* base, int D, int heads, int S,
            int B) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {kBox, 1, kRows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int NWG>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk,
                   const CUtensorMap& tv, void* o, void* lse, int B, int Sq,
                   int Skv, int H, int KVH, float scale, int causal,
                   int window, int q_offset, cudaStream_t stream) {
  constexpr int kTile = D / kBox * kBoxBytes;
  const int smem =
      1024 + (NWG + 2 * kStages) * kTile + 8 * (1 + kStages) + 4 * kStages;
  const cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_sm90_kernel<D, NWG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(H / NWG, B, (Sq + kRows - 1) / kRows);
  fa_fwd_sm90_kernel<D, NWG><<<grid, NWG * 128, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
      Sq, Skv, H, KVH, scale, causal, window, q_offset);
  return cudaGetLastError();
}

}  // namespace

// The bf16 route of fa_fwd (flash_fwd.cu). Returns a cudaError_t.
cudaError_t fa_fwd_sm90(const void* q, const void* k, const void* v, void* o,
                        void* lse, int B, int Sq, int Skv, int H, int KVH,
                        int D, float scale, int causal, int window,
                        int q_offset, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  // Skv = 0 leaves every tile invisible; the map only needs a valid shape
  const int s_kv = Skv > 0 ? Skv : 1;
  if (!encode(&tq, q, D, H, Sq, B) || !encode(&tk, k, D, KVH, s_kv, B) ||
      !encode(&tv, v, D, KVH, s_kv, B))
    return cudaErrorInvalidValue;
  const bool pair = (H / KVH) % 2 == 0;  // two query heads a CTA
  if (D == 64)
    return pair ? launch<64, 2>(tq, tk, tv, o, lse, B, Sq, Skv, H, KVH, scale,
                                causal, window, q_offset, stream)
                : launch<64, 1>(tq, tk, tv, o, lse, B, Sq, Skv, H, KVH, scale,
                                causal, window, q_offset, stream);
  if (D == 128)
    return pair ? launch<128, 2>(tq, tk, tv, o, lse, B, Sq, Skv, H, KVH,
                                 scale, causal, window, q_offset, stream)
                : launch<128, 1>(tq, tk, tv, o, lse, B, Sq, Skv, H, KVH,
                                 scale, causal, window, q_offset, stream);
  return cudaErrorInvalidValue;
}
