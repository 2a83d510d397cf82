// bf16 tensor-core building blocks shared by the bf16 flash attention
// kernels (flash_attention_fwd_bf16.cu, flash_attention_bwd_bf16.cu) on
// Hopper (sm_90a): wgmma products on 128-byte-swizzled bf16 tiles in
// shared memory (namespace wg), the cp.async tile copies that fill them,
// the float32-exact three-plane split of a float32 operand into bf16
// planes (split3, planes_mma), and the row bookkeeping of GQA attention
// (rows flattened to (query position, query head of one KV head), masks).
//
// Tiles hold HDP = hdp<HD>() bf16 columns: a head dim of 32 is held as 64
// columns, zero above 32 (one 128-byte swizzle atom a row).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace bf16mma {

using bf16 = __nv_bfloat16;

constexpr int WG_THREADS = 128;             // a warpgroup
constexpr float LOG2E = 1.4426950408889634f;
// a padding row's position relative to a key: no key is visible to it
constexpr int NO_ROW = INT_MIN + 256;

// bf16 columns a tile holds for head dim HD
template <int HD>
__host__ __device__ constexpr int hdp() {
    return HD < 64 ? 64 : HD;
}

// ---------------------------------------------------------------------------
// wgmma (PTX ISA 8.x, "Asynchronous Warpgroup Level Matrix Multiply").
//
// Shared-memory tiles: R rows of HDP bf16, in column blocks of 64 (128
// bytes a row), each block R x 128 bytes, its 1024-byte atoms of 8 rows
// swizzled as wgmma's 128-byte mode reads them: the 16-byte chunk c of row
// r sits at chunk (c ^ r) % 8 of the row (chunk_off). Tile bases are
// 1024-byte aligned. Fragment layouts (per warpgroup, warp w, lane = 4 g +
// t): the f32 accumulator of m64nNk16 holds d[4j + e] at row 16 w + g + 8
// (e >> 1), column 8 j + 2 t + (e & 1); a register A operand (64 x 16 bf16)
// holds a[i] = the pair at row 16 w + g + 8 (i & 1), columns 2 t + 8 (i >>
// 1) and + 1, so an accumulator's columns 16 kk .. 16 kk + 15 are the A
// operand of k-step kk as pairs (d[8 kk + 2 i], d[8 kk + 2 i + 1]).
namespace wg {

// shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (each >> 4), swizzle mode 1 in bits 62-63
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo,
                                         uint32_t sbo) {
    const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
    return (uint64_t)((a & 0x3FFFF) >> 4)
           | (uint64_t)((lbo >> 4) & 0x3FFF) << 16
           | (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)1 << 62;
}

// K-major operand (A, or B of A B^T): rows [r0, r0 + 64) (or the tile's N
// rows) of a tile of R rows, its 16 columns from 16 kk. Atoms of 8 rows
// 1024 bytes apart (stride byte offset); a k-step inside an atom moves the
// start by 32 bytes, the swizzle being on address bits
__device__ __forceinline__ uint64_t kdesc(const uint8_t* tile, int R, int r0,
                                          int kk) {
    return desc(tile + (kk >> 2) * R * 128 + r0 * 128 + (kk & 3) * 32, 16,
                1024);
}

// MN-major B operand (K = the tile's rows [16 kk, 16 kk + 16), N = its
// columns): 8 k-rows a 1024-byte atom (stride byte offset), 64-column
// blocks R x 128 bytes apart (leading byte offset)
__device__ __forceinline__ uint64_t mdesc(const uint8_t* tile, int R,
                                          int kk) {
    return desc(tile + kk * 2048, R * 128, 1024);
}

__device__ __forceinline__ void fence() {
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void commit() {
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}
// keep the compiler from moving reads of an accumulator above the wait
// that completes it (as CUTLASS's warpgroup_fence_operand)
template <int N>
__device__ __forceinline__ void hold(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (+)= A B^T, m64n32k16: A (64 x 16) and B (32 x 16) K-major in
// shared memory; acc = 0 overwrites d
__device__ __forceinline__ void ss(float (&d)[16], uint64_t a, uint64_t b,
                                   int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(acc));
}

// d (+)= A B^T, m64n64k16: A (64 x 16) and B (64 x 16) K-major in
// shared memory; acc = 0 overwrites d
__device__ __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b,
                                   int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(acc));
}

// d (+)= A B^T, m64n128k16: A (64 x 16) and B (128 x 16) K-major in
// shared memory; acc = 0 overwrites d
__device__ __forceinline__ void ss(float (&d)[64], uint64_t a, uint64_t b,
                                   int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(acc));
}

// d += A B, m64n64k16: A (64 x 16) in registers (four bf16 pairs in
// the accumulator's layout), B (16 x 64) MN-major in shared memory
__device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4],
                                   uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += A B, m64n128k16: A (64 x 16) in registers (four bf16 pairs in
// the accumulator's layout), B (16 x 128) MN-major in shared memory
__device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4],
                                   uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += A B, m64n256k16: A (64 x 16) in registers (four bf16 pairs in
// the accumulator's layout), B (16 x 256) MN-major in shared memory
__device__ __forceinline__ void rs(float (&d)[128], const uint32_t (&a)[4],
                                   uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

}  // namespace wg

// ---------------------------------------------------------------------------

// byte offset of 16-byte chunk c of row r in a tile of R rows (see wg)
__device__ __forceinline__ int chunk_off(int r, int c, int R) {
    return (c >> 3) * R * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// rows [0, R) of a tile from global memory by the block's NT threads: row
// i from src(i), HD bf16 columns, or zeros where src(i) is null; columns
// HD .. HDP zeros. One 16-byte cp.async a chunk (`any`: a valid address
// for the zero fills)
template <int HD, int R, int NT, typename F>
__device__ __forceinline__ void load_tile(uint8_t* tile, const bf16* any,
                                          F src) {
    constexpr int CH = hdp<HD>() / 8;
    static_assert(R * CH % NT == 0, "tile copy");
#pragma unroll
    for (int j = 0; j < R * CH / NT; ++j) {
        const int idx = threadIdx.x + j * NT;
        const int r = idx / CH, c = idx % CH;
        const bf16* p = src(r);
        const bool ok = p != nullptr && c * 8 < HD;
        tf32x3::cp_async16(tile + chunk_off(r, c, R), ok ? p + c * 8 : any,
                           ok ? 16 : 0);
    }
}

// 4-byte cp.async, `valid` bytes (0 or 4) copied, the rest zeros
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int valid) {
    const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
                 :: "r"(s), "l"(gmem), "r"(valid) : "memory");
}

// the block's NT threads (all its warpgroups, whichever code path each is
// on)
template <int NT>
__device__ __forceinline__ void block_sync() {
    asm volatile("bar.sync 1, %0;" :: "n"(NT) : "memory");
}

// cp.async writes made visible to wgmma's reads (the async proxy)
__device__ __forceinline__ void fence_async_smem() {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// 2^x (ex2.approx.ftz: 2 ulp as exp2f, a result below 2^-126 flushed to 0)
__device__ __forceinline__ float exp2_ftz(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// x with its low 16 bits cleared: x rounded toward zero to bf16
__device__ __forceinline__ float chop(float x) {
    return __uint_as_float(__float_as_uint(x) & 0xffff0000u);
}

// the bf16 pair (chop(a), chop(b)), a in the low half: one byte permute
__device__ __forceinline__ uint32_t pack(float a, float b) {
    return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}

// (x0, x1) = hi + mid + lo exactly: three bf16 pairs (x0 in the low half),
// each what the planes before it leave rounded toward zero
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
    const float r0 = x0 - chop(x0), r1 = x1 - chop(x1);
    const float s0 = r0 - chop(r0), s1 = r1 - chop(r1);
    hi = pack(x0, x1);
    mid = pack(r0, r1);
    lo = pack(s0, s1);
}

// Issues d += X B over the 16-column k-steps of the accumulator-layout
// float32 X (16 KS columns), each step as three planes, small first; B's
// k-step kk MN-major from `tile` (R rows). The planes are formed first, then
// fenced (wgmma reads registers written by other instructions only after a
// wgmma.fence); they stay live until the caller's wait
template <int KS, int NA, int ND>
__device__ __forceinline__ void planes_mma(float (&d)[ND],
                                           const float (&x)[NA],
                                           const uint8_t* tile, int R) {
    static_assert(NA == 8 * KS, "k-steps");
    uint32_t pl[KS][3][4];              // [k-step][lo, mid, hi][pair]
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i)
            split3(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1], pl[kk][2][i],
                   pl[kk][1][i], pl[kk][0][i]);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
        const uint64_t b = wg::mdesc(tile, R, kk);
#pragma unroll
        for (int p = 0; p < 3; ++p) wg::rs(d, pl[kk][p], b);
    }
}

// key kl of a tile against a row at position key0 + rel (rel: the row's
// position relative to the tile's first key, NO_ROW for a padding row);
// kmax = keys in the tile
__device__ __forceinline__ bool visible(int rel, int kl, int kmax,
                                        int causal, int window) {
    bool ok = kl < kmax && rel != NO_ROW;
    if (causal) ok = ok && rel >= kl;
    if (window > 0) ok = ok && rel - kl < window;
    return ok;
}

// a position difference clamped to int32: visible() stays exact, since a
// key index in a tile is below 256 and a window below INT_MAX - 256
__device__ __forceinline__ int rel32(int64_t d) {
    return d > INT_MAX ? INT_MAX : (d <= NO_ROW ? NO_ROW + 1 : (int)d);
}

struct Rows {             // the flattened rows of one (batch, KV head)
    int total, G, h;
    int64_t base;         // index of row 0 in a (B, Sq, H) array
    // index of row r in a (B, Sq, H) array (times HD: its first element)
    __device__ __forceinline__ int64_t index(int r) const {
        const int s = r / G;
        return base + (int64_t)s * h + (r - s * G);
    }
};

// the block's dynamic shared memory, its base rounded up to 1024 bytes (a
// swizzle atom; the kernels ask for 1024 bytes more than their tiles)
__device__ __forceinline__ uint8_t* smem_base() {
    extern __shared__ uint8_t smem_raw[];
    const uint32_t a = (uint32_t)__cvta_generic_to_shared(smem_raw);
    return smem_raw + ((1024 - (a & 1023)) & 1023);
}

}  // namespace bf16mma
