// Hopper (sm_90a) building blocks of the bf16 SSD intra-chunk kernels
// (ssd_fwd_sm90.cu, ssd_bwd_sm90.cu), beside the ones they share with the
// flash-attention kernels (flash_attention/csrc/sm90.cuh): 5-D TMA maps
// that cut a strided (B, S, heads, D) view into chunks of L rows, wgmma
// products with both operands MN-major, and hi + lo bf16 splits of f32
// operands into registers and into swizzled shared memory.
//
// A chunk map is a 5-D tensor map over (D, heads, L, S / L, B): a box of
// 64 rows at row r of chunk c reads rows r..r+63 of that chunk only, and
// rows past L come in zero-filled (the kernels mask them explicitly all
// the same). bf16 tiles use boxes of 64 columns with 128-byte swizzle, as
// in sm90.cuh; f32 tiles (dy, dS) are plain row-major boxes, read once by
// the threads that split them.
//
// Everything here has internal linkage: each kernel source includes it
// once.

#pragma once

#include "sm90.cuh"

namespace {

constexpr int kHeadDim = 64;                   // P of the bf16 route
constexpr int kTileF32 = kTileRows * 64 * 4;   // a 64 x 64 f32 tile, 16 KB
constexpr int kMnStep = 2 * kSwizzleAtom;      // 16 rows of a swizzled tile

// one box of a 5-D tensor map at (c0, ..., c4), innermost first
__device__ __forceinline__ void tma_load5(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int c0, int c1, int c2,
                                          int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

// the D/64 boxes of the 64-row bf16 tile of head (or group) `head` from
// row `row` of chunk c of batch b, into dst (boxes 8 KB apart)
template <int D>
__device__ __forceinline__ void tma_chunk_tile(uint8_t* dst,
                                               const CUtensorMap* map,
                                               uint32_t bar, int head, int row,
                                               int c, int b) {
#pragma unroll
  for (int x = 0; x < D / kBox; ++x)
    tma_load5(smem_u32(dst + x * kBoxBytes), map, bar, x * kBox, head, row, c,
              b);
}

// acc (+)= A . B^T over D, both K-major 64-row tiles (as wgmma_tiles_abt,
// which overwrites acc; this one always accumulates), issued, not committed
template <int D>
__device__ __forceinline__ void wgmma_tiles_abt_acc(float (&acc)[32],
                                                    uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
    wgmma_ss_m64n64(acc, sw128_desc(a + off, 16, kSwizzleAtom),
                    sw128_desc(b + off, 16, kSwizzleAtom), 1);
  }
}

// D (+)= A . B for one k-step of 16, both operands in shared memory and
// MN-major (A: K rows of M = 64 contiguous values; B: K rows of N
// contiguous values)
__device__ __forceinline__ void wgmma_ss_tt_m64n64(float (&d)[32], uint64_t da,
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16\n"
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},\n"
      " %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_tt_m64n128(float (&d)[64],
                                                    uint64_t da, uint64_t db,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16\n"
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      " %60, %61, %62, %63},\n"
      " %64, %65, p, 1, 1, 1, 1;\n}\n"
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
      : "l"(da), "l"(db), "r"(scale_d));
}

// acc (+)= A . B over 64 rows: A (64 x 64) is stored transposed, as a
// swizzled [k][m] tile (MN-major), B a 64-row tile [k][n] of N columns
// (MN-major, boxes 8 KB apart); the first k-step overwrites unless
// `accumulate`. Issued, not committed.
template <int N>
__device__ __forceinline__ void wgmma_tiles_tt(float (&acc)[N / 2],
                                               uint32_t a, uint32_t b,
                                               int accumulate) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t da = sw128_desc(a + kk * kMnStep, kBoxBytes, kSwizzleAtom);
    const uint64_t db = sw128_desc(b + kk * kMnStep, kBoxBytes, kSwizzleAtom);
    if constexpr (N == 64)
      wgmma_ss_tt_m64n64(acc, da, db, accumulate || kk > 0);
    else
      wgmma_ss_tt_m64n128(acc, da, db, accumulate || kk > 0);
  }
}

// (v0, v1) as a bf16 pair hi and the pair of what it misses, lo
__device__ __forceinline__ void split_pair(float v0, float v1, uint32_t& hi,
                                           uint32_t& lo) {
  hi = pack_bf16(v0, v1);
  const float2 h =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
  lo = pack_bf16(v0 - h.x, v1 - h.y);
}

// the bf16 value at (row, col) of a 64-column swizzled tile
__device__ __forceinline__ float tile_bf16(const uint8_t* tile, int row,
                                           int col) {
  return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
      tile + row * kSwizzleRow + (((col >> 3) ^ (row & 7)) << 4) +
      (col & 7) * 2));
}

// a 64 x 64 f32 accumulator fragment as hi and lo bf16 tiles [row][col],
// swizzled as TMA lays a 64-column box (the layout of stage_acc<64>)
__device__ __forceinline__ void stage_split(uint8_t* hi, uint8_t* lo,
                                            const float (&v)[32], int warp,
                                            int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + lane / 4 + 8 * r;
    const int at = row * kSwizzleRow + (lane % 4) * 4;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      uint32_t h, l;
      split_pair(v[4 * q + 2 * r], v[4 * q + 2 * r + 1], h, l);
      const int off = at + ((q ^ (row & 7)) << 4);
      *reinterpret_cast<uint32_t*>(hi + off) = h;
      *reinterpret_cast<uint32_t*>(lo + off) = l;
    }
  }
}

// a plain row-major f32 tile of 64 rows x D columns as hi and lo bf16
// tiles, each D/64 swizzled boxes 8 KB apart, by the n threads t = 0..n-1,
// 8 values (one 16-byte chunk of each output) at a time; then fenced for
// the wgmma that reads them
template <int D>
__device__ __forceinline__ void split_tile(const float* src, uint8_t* hi,
                                           uint8_t* lo, int t, int n) {
  constexpr int kChunks = D / 8;             // 16-byte bf16 chunks per row
  for (int i = t; i < kTileRows * kChunks; i += n) {
    const int row = i / kChunks, c = i % kChunks;
    const float4 a = *reinterpret_cast<const float4*>(src + row * D + 8 * c);
    const float4 b =
        *reinterpret_cast<const float4*>(src + row * D + 8 * c + 4);
    uint4 h, l;
    split_pair(a.x, a.y, h.x, l.x);
    split_pair(a.z, a.w, h.y, l.y);
    split_pair(b.x, b.y, h.z, l.z);
    split_pair(b.z, b.w, h.w, l.w);
    const int off = (c / 8) * kBoxBytes + row * kSwizzleRow +
                    (((c % 8) ^ (row & 7)) << 4);
    *reinterpret_cast<uint4*>(hi + off) = h;
    *reinterpret_cast<uint4*>(lo + off) = l;
  }
  fence_proxy_async();
}

// a tensor map of `rank` dims (innermost first) with byte strides of the
// outer dims and a box; false if the driver refuses it
bool encode_map(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                int rank, const cuuint64_t* dims, const cuuint64_t* strides,
                const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  return fn(map, type, (cuuint32_t)rank, const_cast<void*>(base), dims,
            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a bf16 view (B, S, heads, D) with element strides (sb, ss, sh, 1) as a
// chunk map over (D, heads, L, S / L, B), in boxes of 64 columns x 64 rows
// of one head, 128-byte swizzle
bool encode_chunks_bf16(CUtensorMap* map, const void* base, int D, int heads,
                        int L, int nc, int B, long long sb, long long ss,
                        long long sh) {
  const cuuint64_t dims[5] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)L, (cuuint64_t)nc, (cuuint64_t)B};
  const cuuint64_t strides[4] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                                 (cuuint64_t)ss * L * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[5] = {kBox, 1, kTileRows, 1, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, 5, dims,
                    strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace
