// Hopper (sm_90a) building blocks shared by the bf16 flash-attention
// kernels (flash_fwd_sm90.cu, flash_bwd_sm90.cu): mbarriers, TMA loads
// and their tensor maps, wgmma descriptors and products, and the staging
// of a bf16 tile through shared memory.
//
// Tiles are 64 rows of a (B, S, heads, D) bf16 tensor, loaded by TMA in
// boxes of 64 columns (128 bytes) x 64 rows of one head with 128-byte
// swizzle, so a row of D 128, 192 or 256 is two, three or four boxes 8 KB
// apart. Such a tile is the K-major operand of a product over D
// (descriptor start +32 bytes a k-step of 16 inside a swizzled row, +8 KB a
// box; SBO 1024 bytes, 8 rows) and the MN-major B operand of a product over
// its 64 rows (start +2 KB a k-step of 16 rows; LBO 8 KB, a box along N;
// SBO 1024 bytes, 8 rows); N columns from column c0 (a multiple of 64)
// start c0 / 64 boxes in. A head dim that is not a multiple of 64 (D 96, 112)
// takes the tile of the next multiple (tile_cols: 128), as the TPU kernel
// pads D to a multiple of 128: the tensor map's innermost extent is the
// real D, so TMA fills the columns past it with zeros, which leave every
// product over D unchanged and give zero output columns, never stored.
//
// Everything here has internal linkage: each kernel source includes it
// once, and the library links both sources.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;        // NEG_INF of the TPU kernels
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTileRows = 64;            // rows of a tile, the wgmma M
constexpr int kBox = 64;                 // columns per TMA box (128 bytes)
constexpr int kBoxBytes = kBox * kTileRows * 2;  // one 64-row box, 8 KB
constexpr int kSwizzleRow = 128;         // bytes per swizzled row
constexpr int kSwizzleAtom = 8 * kSwizzleRow;  // 8 rows: the SBO

// the columns of the tile that holds a row of head dim d: d rounded up to
// whole 64-column boxes
__host__ __device__ constexpr int tile_cols(int d) {
  return (d + kBox - 1) / kBox * kBox;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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

// the D/64 boxes of the 64-row tile of head `head` from row `row` of batch
// b into dst, reported to bar
template <int D>
__device__ __forceinline__ void tma_load_tile(uint8_t* dst,
                                              const CUtensorMap* map,
                                              uint32_t bar, int head, int row,
                                              int b) {
#pragma unroll
  for (int x = 0; x < D / kBox; ++x)
    tma_load(smem_u32(dst + x * kBoxBytes), map, bar, x * kBox, head, row, b);
}

// orders this thread's generic-proxy writes to shared memory before later
// async-proxy accesses (wgmma reads, TMA writes)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) pin(r[i]);
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

__device__ __forceinline__ void wgmma_rs_m64n192(
    float (&d)[96], const uint32_t (&a)[4],
    uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16\n"
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      " %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      " %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40,"
      " %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53,"
      " %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66,"
      " %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92,"
      " %93, %94, %95},\n"
      " {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_m64n256(
    float (&d)[128], const uint32_t (&a)[4],
    uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16\n"
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      " %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      " %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40,"
      " %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53,"
      " %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66,"
      " %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92,"
      " %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104,"
      " %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115,"
      " %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126,"
      " %127},\n"
      " {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
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
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// acc = A . B^T, a 64 x 64 product over D: A and B are 64-row tiles in
// shared memory, both K-major (D contiguous), issued but not committed
template <int D>
__device__ __forceinline__ void wgmma_tiles_abt(float (&acc)[32], uint32_t a,
                                                uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
    wgmma_ss_m64n64(acc, sw128_desc(a + off, 16, kSwizzleAtom),
                    sw128_desc(b + off, 16, kSwizzleAtom), kk > 0);
  }
}

// acc += A . B, a 64 x N product over 64 rows: A the bf16 fragments of a
// 64 x 64 accumulator (a[j] is k-step j), B N columns of a 64-row tile in
// shared memory from address b, MN-major (D contiguous); issued but not
// committed
template <int N>
__device__ __forceinline__ void wgmma_frags_b(float (&acc)[N / 2],
                                              const uint32_t (&a)[4][4],
                                              uint32_t b) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint64_t db =
        sw128_desc(b + j * 2 * kSwizzleAtom, kBoxBytes, kSwizzleAtom);
    if constexpr (N == 64)
      wgmma_rs_m64n64(acc, a[j], db, 1);
    else if constexpr (N == 128)
      wgmma_rs_m64n128(acc, a[j], db, 1);
    else if constexpr (N == 192)
      wgmma_rs_m64n192(acc, a[j], db, 1);
    else
      wgmma_rs_m64n256(acc, a[j], db, 1);
  }
}

// A 64 x 64 f32 accumulator as the bf16 A fragments of a product over its
// 64 columns: thread t holds rows 16 (t/32) + (t%32)/4 (+8) and columns
// 8j + 2 (t%4) (+1) in x[4j + 2r + e], and the fragment of columns
// 16j..16j+15 is the A fragment of k-step j
__device__ __forceinline__ void to_frags(const float (&x)[32],
                                         uint32_t (&a)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[j][i] = pack_bf16(x[8 * j + 2 * i], x[8 * j + 2 * i + 1]);
  }
}

// x to the nearest sum of two bf16 values, hi + lo (~16 significant bits)
__device__ __forceinline__ float split_round(float x) {
  const float hi = __bfloat162float(__float2bfloat16_rn(x));
  return hi + __bfloat162float(__float2bfloat16_rn(x - hi));
}

// to_frags for an operand that must keep ~16 bits: x as the fragments of
// hi and lo, two bf16 values a pair, for two products that sum in f32
__device__ __forceinline__ void to_split_frags(const float (&x)[32],
                                               uint32_t (&hi)[4][4],
                                               uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = x[8 * j + 2 * i], b = x[8 * j + 2 * i + 1];
      hi[j][i] = pack_bf16(a, b);
      const float2 h = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&hi[j][i]));
      lo[j][i] = pack_bf16(a - h.x, b - h.y);
    }
  }
}

// eight bf16 values of a 16-byte chunk times sc, rounded to bf16
__device__ __forceinline__ uint4 scale_chunk(uint4 x, float sc) {
  __nv_bfloat162* hx = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(hx[j]);
    hx[j] = __floats2bfloat162_rn(f.x * sc, f.y * sc);
  }
  return x;
}

// q * bf16(scale) rounded to bf16, in place, over a tile of `bytes` in
// shared memory, by the n threads t = 0..n-1 (elementwise, so the swizzle
// does not matter), then fenced for the wgmma that reads it
__device__ __forceinline__ void scale_tile(uint8_t* tile, int bytes,
                                           float scale, int t, int n) {
  const float sc = __bfloat162float(__float2bfloat16_rn(scale));
  uint4* qv = reinterpret_cast<uint4*>(tile);
  for (int i = t; i < bytes / 16; i += n) qv[i] = scale_chunk(qv[i], sc);
  fence_proxy_async();
}

// a 64 x N f32 accumulator times mul, rounded to bf16, into columns
// c0..c0+N-1 of a [64][D] tile in shared memory with 16-byte chunk c of row
// r at c ^ (r & 7) (free of bank conflicts); `warp` and `lane` within the
// warpgroup
template <int D, int N = D>
__device__ __forceinline__ void stage_acc(uint8_t* tile,
                                          const float (&acc)[N / 2],
                                          float mul, int warp, int lane,
                                          int c0 = 0) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + lane / 4 + 8 * r;
    uint8_t* srow = tile + row * D * 2 + (lane % 4) * 4;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      *reinterpret_cast<uint32_t*>(srow + (((c0 / 8 + j) ^ (row & 7)) * 16)) =
          pack_bf16(acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
  }
}

// the first n_rows rows of a tile staged as stage_acc lays it out, to dst
// (row i at dst + i * row_stride elements), 16 bytes a thread and
// coalesced, by the n threads t = 0..n-1; the first DG columns of each of
// the tile's D (DG 112 or 96 of a 128-column tile: 14 or 12 of 16 chunks,
// so a row never spills into the next head's)
template <int D, int DG = D>
__device__ __forceinline__ void store_tile(const uint8_t* tile,
                                           __nv_bfloat16* dst,
                                           int64_t row_stride, int n_rows,
                                           int t, int n) {
  static_assert(DG % 8 == 0 && DG <= D, "whole 16-byte chunks of the tile");
  constexpr int kChunks = DG / 8;            // 16-byte chunks stored per row
  for (int i = t; i < kTileRows * kChunks; i += n) {
    const int row = i / kChunks, c = i % kChunks;
    if (row < n_rows)
      *reinterpret_cast<uint4*>(dst + row * row_stride + c * 8) =
          *reinterpret_cast<const uint4*>(tile + row * D * 2 +
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
// (D, heads, S, B), in boxes of 64 columns x 64 rows of one head; rows
// past S and columns past D (the last box of D 96 or 112) come in zero-filled,
// and batch edges stay edges. S = 0 is encoded as 1 (a tensor with no rows
// has no tile that is ever loaded)
bool encode(CUtensorMap* map, const void* base, int D, int heads, int S,
            int B) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t rows = S > 0 ? S : 1;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, rows,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)heads * D * 2,
                                 rows * heads * D * 2};
  const cuuint32_t box[4] = {kBox, 1, kTileRows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
