// Flash attention forward for Hopper (sm_90a): causal / non-causal GQA with
// an optional tanh softcap, key padding, causal and sliding-window masks,
// online softmax in float32, products on the tensor cores in 3xTF32.
//
// Replaces the TPU kernel repro/kernels/attention/flash.py::_kernel
// (launched by flash_attention_fwd, wrapped by attention/ops.py).
//
// Bound: operations. Per visible (query, key) pair and query head it does
// 2*hd multiply-adds for Q K^T and 2*hd for P V, against 4 bytes per
// element of q, k, v and out read or written once. At the main path's
// layer shape (B, S, H, KV, hd) = (4, 4500, 8, 4, 256) that is ~330 GFLOP
// per layer over ~440 MB. On an NVIDIA H100 80GB HBM3 at its 700.00 W limit
// the products run as three TF32 tensor-core products each (float32
// accuracy, see ../../csrc/mma_tf32.cuh): ~2.0 ms at the 495 TFLOP/s TF32
// data-sheet peak, against ~0.13 ms of memory traffic at 3.35 TB/s (and
// ~4.9 ms at the 67 TFLOP/s of float32 outside the tensor cores).
//
// Design:
//  * one block of 8 warps per (batch x KV head, tile of 128 rows), where
//    the rows are the flattened (query position, query head of this KV head)
//    pairs: row r is position r / G and head kv*G + r % G, as the TPU
//    kernel holds all G query heads of one KV head in one program. For a
//    given position the G heads are adjacent in memory, so a row tile is
//    read as contiguous runs, and any G (including G = 3) fits one tile
//    shape. Row tiles are issued last-first, so the tiles that see the most
//    keys start first;
//  * each warp owns 16 rows: Q K^T and P V are m16n8k8 mma.sync products in
//    3xTF32 (hi/lo split of every operand, three products into float32
//    accumulators; the split uses integer rounding, not cvt, whose
//    conversion pipe bounded the first version). The 16 x hd output
//    accumulator lives in registers (hd / 2 floats a lane: 128 at
//    hd = 256); Q K^T sums its small terms apart from hi*hi, so each
//    n-tile gives two independent mma chains;
//  * the online softmax runs in registers on the score fragment: a lane
//    holds two rows, so the row max and sum take two shuffles within a quad.
//    The score fragment feeds P V as the A operand with no shuffle or
//    staging tile: the k index of each 8-key step is permuted (slot t is key
//    2t, slot t + 4 key 2t + 1) and V's rows are read in the same order;
//  * K and V tiles of 32 keys are copied with 16-byte cp.async, one buffer
//    each: the next K tile is copied while this tile's P V runs, the next
//    V tile while the next Q K^T runs. Q (pre-scaled by `scale`, as
//    flash.py:47 scales before the product) stays in shared memory for the
//    block's life. Rows are padded to hd + 4 floats so every fragment load
//    hits 32 distinct banks. At hd = 256: 128 x 260 x 4 (Q) + 2 x 32 x 260
//    x 4 (K, V) = 199,680 bytes of dynamic shared memory, under the 232,448
//    a block may use on an H100: one block, 8 warps, per SM;
//  * a loop inside the block walks the KV tiles in place of the TPU's
//    sequential third grid axis. It visits only the tiles the causal and
//    window limits of the block's rows reach, and each warp skips the tiles
//    its own 16 rows cannot see: a skipped tile would contribute p = 0 and
//    a correction of 1, so skipping is exact. Only tiles that straddle a
//    limit (causal, window, or the end of the keys) evaluate the masks;
//  * numerics follow flash.py:52-83: softcap before the mask, masked scores
//    -inf, the running max clamped at -0.7 * FLT_MAX so a fully masked row
//    gives p = 0 and output 0, l == 0 treated as 1. expf and tanhf are the
//    accurate versions (no --use_fast_math). float32 only: bf16 inputs have
//    a forward of their own on the bf16 tensor cores,
//    flash_attention_fwd_bf16.cu.
//  * optional output (the training path's, for flash_attention_bwd.cu):
//    each row's log-sum-exp in float32, written as max(m, MIN_CLAMP) +
//    log(l), so a fully masked row gets the finite clamped max and its
//    recomputed p is 0. A null pointer writes nothing.
// Flags: default nvcc contraction (-fmad=true); the float32 tolerance of
// the tests (3e-5) covers the split products and the summation order.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

using io::load4;
using io::store2;
using tf32x3::FragA;

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int R = 16 * WARPS;  // rows (query position, query head) per block
constexpr int BK = 32;         // keys per KV tile
constexpr float MIN_CLAMP = -0.7f * 3.402823466e38f;

template <int HD>
constexpr size_t smem_bytes() {
    return sizeof(float) * (size_t)(R + 2 * BK) * (HD + 4);
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const float* __restrict__ q,  // (B, Sq, H, HD)
                 const float* __restrict__ k,  // (B, Tk, KV, HD)
                 const float* __restrict__ v,  // (B, Tk, KV, HD)
                 float* __restrict__ out,      // (B, Sq, H, HD)
                 float* __restrict__ lse,      // (B, Sq, H) or null
                 int sq, int tk, int h, int kvh, float scale, int causal,
                 int window, float cap, int64_t q_offset) {
    extern __shared__ float4 smem4[];
    constexpr int S = HD + 4;                // padded row stride
    constexpr int NT = HD / 8;               // n-tiles of the output
    float* Qs = reinterpret_cast<float*>(smem4);   // R x S
    float* Ks = Qs + R * S;                  // BK x S
    float* Vs = Ks + BK * S;                 // BK x S

    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int G = h / kvh;
    const int b = blockIdx.y / kvh, kh = blockIdx.y % kvh;
    const int64_t rows_total = (int64_t)sq * G;
    const int64_t r0 = (int64_t)(gridDim.x - 1 - blockIdx.x) * R;

    // index of row r in a (B, Sq, H) array (lse), and of its first
    // element in q / out
    auto row_index = [&](int64_t rg) -> int64_t {
        const int64_t s = rg / G;
        const int gi = (int)(rg - s * G);
        return ((int64_t)b * sq + s) * h + (int64_t)kh * G + gi;
    };
    auto row_offset = [&](int64_t rg) -> int64_t {
        return row_index(rg) * HD;
    };

    for (int idx = tid; idx < R * HD / 4; idx += THREADS) {
        const int r = idx / (HD / 4), d = (idx % (HD / 4)) * 4;
        const int64_t rg = r0 + r;
        float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (rg < rows_total) {
            val = load4(q + row_offset(rg) + d);
            val.x *= scale; val.y *= scale; val.z *= scale; val.w *= scale;
        }
        *reinterpret_cast<float4*>(&Qs[r * S + d]) = val;
    }

    // the keys this block's rows can see
    const int64_t last = (r0 + R - 1 < rows_total ? r0 + R - 1
                                                   : rows_total - 1);
    const int64_t qpos_lo = q_offset + r0 / G, qpos_hi = q_offset + last / G;
    int64_t k_begin = 0, k_end = tk;
    if (causal && qpos_hi + 1 < k_end) k_end = qpos_hi + 1;
    if (window > 0 && qpos_lo - window + 1 > k_begin)
        k_begin = qpos_lo - window + 1;
    const int ntiles = k_end > k_begin ? (int)((k_end - k_begin + BK - 1) / BK)
                                       : 0;

    // the keys this warp's 16 rows can see
    const int64_t w_r0 = r0 + 16 * warp;
    const bool active = w_r0 < rows_total;
    const int64_t w_last = (w_r0 + 15 < rows_total ? w_r0 + 15
                                                    : rows_total - 1);
    const int64_t wq_lo = q_offset + w_r0 / G, wq_hi = q_offset + w_last / G;
    int64_t wk_begin = 0, wk_end = tk;
    if (causal && wq_hi + 1 < wk_end) wk_end = wq_hi + 1;
    if (window > 0 && wq_lo - window + 1 > wk_begin)
        wk_begin = wq_lo - window + 1;
    // query positions of this lane's two rows (g and g + 8)
    const int64_t qpos0 = q_offset + (w_r0 + g) / G;
    const int64_t qpos1 = q_offset + (w_r0 + g + 8) / G;

    // one tile (BK keys) of k or v into its buffer; one commit group
    auto load_tile = [&](int it, const float* src, float* dst) {
        const int64_t k0 = k_begin + (int64_t)it * BK;
        for (int idx = tid; idx < BK * HD / 4; idx += THREADS) {
            const int j = idx / (HD / 4), d = (idx % (HD / 4)) * 4;
            const int64_t kp = k0 + j;
            const bool ok = kp < tk;         // padded keys: zero, masked
            const int64_t off = ok ? (((int64_t)b * tk + kp) * kvh + kh) * HD
                                     + d : 0;
            tf32x3::cp_async16(dst + j * S + d, src + off, ok ? 16 : 0);
        }
        tf32x3::cp_async_commit();
    };

    float acc[NT][4];
#pragma unroll
    for (int c = 0; c < NT; ++c)
        acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.0f;
    float m0 = -INFINITY, m1 = -INFINITY;   // running max of rows g, g + 8
    float l0 = 0.0f, l1 = 0.0f;             // this lane's share of the sums
    const float* Qw = Qs + (16 * warp + g) * S + t;

    // K and V have one buffer each: the next K tile is copied while this
    // tile's P V runs, the next V tile while the next Q K^T runs. Commit
    // groups go K0, V0, K1, V1, ...; "wait<1>" leaves only the latest open.
    if (ntiles > 0) {
        load_tile(0, k, Ks);
        load_tile(0, v, Vs);
    }
    for (int it = 0; it < ntiles; ++it) {
        tf32x3::cp_async_wait<1>();          // K_it has landed
        __syncthreads();
        const int64_t k0 = k_begin + (int64_t)it * BK;
        const bool visible = active && k0 < wk_end && k0 + BK > wk_begin;
        float s[BK / 8][4];
        if (visible) {
            // scores, 16 rows x BK keys: n-tile n holds keys 8n .. 8n + 7.
            // Each n-tile sums the small terms apart from hi*hi: 2 x BK / 8
            // independent chains of mma.sync
            float sp[2][BK / 8][4];
#pragma unroll
            for (int n = 0; n < BK / 8; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) sp[0][n][e] = sp[1][n][e] = 0.0f;
#pragma unroll 2
            for (int kk = 0; kk < HD / 8; ++kk) {
                FragA a;
                a.set(Qw[kk * 8], Qw[8 * S + kk * 8], Qw[kk * 8 + 4],
                      Qw[8 * S + kk * 8 + 4]);
#pragma unroll
                for (int n = 0; n < BK / 8; ++n) {
                    const float* kr = Ks + (n * 8 + g) * S + kk * 8 + t;
                    tf32x3::mma3_split(sp[0][n], sp[1][n], a, kr[0], kr[4]);
                }
            }

            const bool full = k0 + BK <= tk &&
                              (!causal || k0 + BK - 1 <= wq_lo) &&
                              (window <= 0 || wq_hi - k0 < window);
            float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
            for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    float sv = sp[0][n][e] + sp[1][n][e];
                    if (cap != 0.0f) sv = cap * tanhf(sv / cap);
                    if (!full) {
                        const int64_t kp = k0 + n * 8 + 2 * t + (e & 1);
                        const int64_t qp = e < 2 ? qpos0 : qpos1;
                        bool ok = kp < tk;
                        if (causal) ok = ok && qp >= kp;
                        if (window > 0) ok = ok && (qp - kp) < window;
                        if (!ok) sv = -INFINITY;
                    }
                    s[n][e] = sv;
                }
                mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
                mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
            }
            mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
            mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
            mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
            mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
            const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
            const float ms0 = fmaxf(mn0, MIN_CLAMP);
            const float ms1 = fmaxf(mn1, MIN_CLAMP);
            const float corr0 = expf(fmaxf(m0, MIN_CLAMP) - ms0);
            const float corr1 = expf(fmaxf(m1, MIN_CLAMP) - ms1);
            m0 = mn0;
            m1 = mn1;
            float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
            for (int n = 0; n < BK / 8; ++n) {
                s[n][0] = expf(s[n][0] - ms0);
                s[n][1] = expf(s[n][1] - ms0);
                s[n][2] = expf(s[n][2] - ms1);
                s[n][3] = expf(s[n][3] - ms1);
                sum0 += s[n][0] + s[n][1];
                sum1 += s[n][2] + s[n][3];
            }
            l0 = l0 * corr0 + sum0;
            l1 = l1 * corr1 + sum1;
#pragma unroll
            for (int c = 0; c < NT; ++c) {
                acc[c][0] *= corr0;
                acc[c][1] *= corr0;
                acc[c][2] *= corr1;
                acc[c][3] *= corr1;
            }
        }
        __syncthreads();                     // every read of K_it done
        if (it + 1 < ntiles) load_tile(it + 1, k, Ks);
        else tf32x3::cp_async_commit();      // keep one group per step
        tf32x3::cp_async_wait<1>();          // V_it has landed
        __syncthreads();
        if (visible) {
            // acc += P V; the k index of step n is permuted: slot t is key
            // 8n + 2t, slot t + 4 key 8n + 2t + 1 (mma_tf32.cuh)
#pragma unroll
            for (int n = 0; n < BK / 8; ++n) {
                FragA a;
                a.set(s[n][0], s[n][2], s[n][1], s[n][3]);
                const float* vr = Vs + (n * 8 + 2 * t) * S + g;
#pragma unroll
                for (int c = 0; c < NT; ++c)
                    tf32x3::mma3(acc[c], a, vr[c * 8], vr[S + c * 8]);
            }
        }
        __syncthreads();                     // every read of V_it done
        if (it + 1 < ntiles) load_tile(it + 1, v, Vs);
        else tf32x3::cp_async_commit();
    }

    if (!active) return;
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    if (l0 == 0.0f) l0 = 1.0f;
    if (l1 == 0.0f) l1 = 1.0f;
    const int64_t rg0 = w_r0 + g, rg1 = w_r0 + g + 8;
    if (lse != nullptr && t == 0) {          // one lane of the quad
        if (rg0 < rows_total)
            lse[row_index(rg0)] = fmaxf(m0, MIN_CLAMP) + logf(l0);
        if (rg1 < rows_total)
            lse[row_index(rg1)] = fmaxf(m1, MIN_CLAMP) + logf(l1);
    }
    if (rg0 < rows_total) {
        float* o = out + row_offset(rg0) + 2 * t;
#pragma unroll
        for (int c = 0; c < NT; ++c)
            store2(o + c * 8, acc[c][0] / l0, acc[c][1] / l0);
    }
    if (rg1 < rows_total) {
        float* o = out + row_offset(rg1) + 2 * t;
#pragma unroll
        for (int c = 0; c < NT; ++c)
            store2(o + c * 8, acc[c][2] / l1, acc[c][3] / l1);
    }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int b, int sq, int tk, int h, int kvh, float scale,
           int causal, int window, float cap, int64_t q_offset,
           cudaStream_t stream) {
    const size_t bytes = smem_bytes<HD>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
    const int64_t rows = (int64_t)sq * (h / kvh);
    const dim3 grid((unsigned)((rows + R - 1) / R), (unsigned)(b * kvh));
    flash_fwd_kernel<HD><<<grid, THREADS, bytes, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)out, lse,
        sq, tk, h, kvh, scale, causal, window, cap, q_offset);
    return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). q (B, Sq, H, hd), k/v
// (B, Tk, KV, hd), out (B, Sq, H, hd), all float32, contiguous and 16-byte
// aligned; hd in {32, 64, 128, 256}; H % KV == 0. lse: null, or a float32
// (B, Sq, H) array that receives each row's log-sum-exp. Launches on
// `stream`; returns 0 or the CUDA error.
extern "C" int flash_attention_fwd_launch(
        const void* q, const void* k, const void* v, void* out, void* lse,
        int b, int sq, int tk, int h, int kvh, int hd, float scale,
        int causal, int window, float cap, int64_t q_offset, void* stream) {
    if (b <= 0 || sq <= 0) return (int)cudaGetLastError();
    if (kvh <= 0 || h % kvh != 0) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    float* fl = (float*)lse;
    switch (hd) {
        case 32: return launch<32>(q, k, v, out, fl, b, sq, tk, h, kvh,
                                   scale, causal, window, cap, q_offset, st);
        case 64: return launch<64>(q, k, v, out, fl, b, sq, tk, h, kvh,
                                   scale, causal, window, cap, q_offset, st);
        case 128: return launch<128>(q, k, v, out, fl, b, sq, tk, h, kvh,
                                     scale, causal, window, cap, q_offset,
                                     st);
        case 256: return launch<256>(q, k, v, out, fl, b, sq, tk, h, kvh,
                                     scale, causal, window, cap, q_offset,
                                     st);
        default: return (int)cudaErrorInvalidValue;
    }
}
