// Float32 products on Hopper's tensor cores (3xTF32) and 16-byte cp.async
// copies, shared by the port's attention and SSD kernels; and the
// attention kernels' float32 loads and float32 / bf16 stores (namespace io).
//
// A TF32 operand keeps 10 bits of mantissa, about three decimal digits. To
// keep float32 accuracy, each float32 operand x is split into a TF32 high
// part and a remainder,
//     hi = tf32(x),  lo = x - hi   (see split below),
// and a product a*b is issued as three TF32 products into one float32
// accumulator, small terms first: lo_a*hi_b, hi_a*lo_b, then hi_a*hi_b. The
// dropped lo_a*lo_b term and the rounding of lo leave a relative error of
// order 2^-21 per product (the scheme of CUTLASS's OpMultiplyAddFastF32).
// Effective rate on an NVIDIA H100: 495 / 3 = 165 TFLOP/s of float32
// products (data-sheet TF32 dense peak), against 67 TFLOP/s for float32
// outside the tensor cores.
//
// The products are mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32.
// Fragment layouts (PTX ISA, "Matrix Fragments for mma.m16n8k8", .tf32),
// with g = lane / 4 and t = lane % 4:
//     A (16 x 8):  a0 (g, t)     a1 (g + 8, t)  a2 (g, t + 4)  a3 (g + 8, t + 4)
//     B (8 x 8):   b0 (k = t, n = g)            b1 (k = t + 4, n = g)
//     C (16 x 8):  c0 (g, 2t)    c1 (g, 2t + 1) c2 (g + 8, 2t) c3 (g + 8, 2t + 1)
// The kernels feed an accumulator C straight back as an A operand by
// permuting the k index inside an 8-step: A slot t stands for k = 2t and slot
// t + 4 for k = 2t + 1, so a lane's (c0, c1, c2, c3) are its (a0, a2, a1, a3)
// and the B operand's rows are read in the same order (b0 from row 2t, b1
// from row 2t + 1). A sum over k does not care about the order of its terms.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tf32x3 {

// x = hi + lo: hi is x rounded to TF32 (round half away from zero, on
// the integer bits), lo = x - hi exactly in float32 (|lo| <= 2^-11 |x|).
// lo goes to the tensor core as it is: the mma reads the top 19 bits of a
// .tf32 operand, so lo is truncated to TF32 there (error <= 2^-21 |x|).
// Integer and float adds only: cvt.rna.tf32.f32 issues on the slower
// conversion pipe, and two of them per operand bound the kernels' issue.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A operand of one m16n8k8 step, split
struct FragA {
    uint32_t hi[4], lo[4];
    __device__ __forceinline__ void set(float a0, float a1, float a2,
                                        float a3) {
        split(a0, hi[0], lo[0]);
        split(a1, hi[1], lo[1]);
        split(a2, hi[2], lo[2]);
        split(a3, hi[3], lo[3]);
    }
};

// d += a * b in float32 accuracy: three TF32 products, small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, float b0,
                                     float b1) {
    uint32_t bh0, bl0, bh1, bl1;
    split(b0, bh0, bl0);
    split(b1, bh1, bl1);
    mma(d, a.lo, bh0, bh1);
    mma(d, a.hi, bl0, bl1);
    mma(d, a.hi, bh0, bh1);
}

// the same three products, with the two small terms summed apart from
// hi*hi: two accumulators, so two dependent chains instead of one (the
// caller adds small + big at the end)
__device__ __forceinline__ void mma3_split(float (&small)[4], float (&big)[4],
                                           const FragA& a, float b0,
                                           float b1) {
    uint32_t bh0, bl0, bh1, bl1;
    split(b0, bh0, bl0);
    split(b1, bh1, bl1);
    mma(small, a.lo, bh0, bh1);
    mma(small, a.hi, bl0, bl1);
    mma(big, a.hi, bh0, bh1);
}

// 16-byte asynchronous copy global -> shared; copies `valid` bytes (0 or
// 16) and fills the rest with zeros
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int valid) {
    const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                 :: "r"(s), "l"(gmem), "r"(valid) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most `n` committed groups are still in flight
template <int n>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;" :: "n"(n) : "memory");
}

}  // namespace tf32x3

// Elements of a float32 or bf16 tensor in float32 registers: float32
// loads and stores, and bf16 stores that round to nearest even
// (__floats2bfloat162_rn).
namespace io {

// four float32 elements (16 bytes)
__device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void store4(float* p, float4 x) {
    *reinterpret_cast<float4*>(p) = x;
}
// two elements
__device__ __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

}  // namespace io
