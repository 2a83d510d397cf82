// Flash attention backward in bf16 for Hopper (sm_90a): dq, dk, dv of the
// function of flash_attention.cu (GQA, scale, causal, sliding window,
// q_offset, tanh softcap before the masks) for bf16 q, k, v and dO, computed
// in float32 and rounded to bf16 once at the end, its products on the bf16
// tensor cores (wgmma). The float32 backward is flash_attention_bwd.cu.
//
// Stands beside repro/kernels/attention/ops.py:37::_bwd, the custom VJP of
// the TPU kernel, which widens bf16 q, k, v and dO to float32, recomputes
// through XLA ops in float32 and returns bf16 gradients. The math is
// flash_attention_bwd.cu's: P_ij = exp(s_ij - lse_i) on visible pairs,
// dS_ij = P_ij (dP_ij - D_i) times the softcap's derivative, dv_j = sum_i
// P_ij dO_i, dk_j = scale sum_i dS_ij q_i, dq_i = scale sum_j dS_ij k_j,
// with D = rowsum(dO O) from the bf16 output O (dsum kernel below) and the
// forward's float32 lse.
//
// Products, float32-exact. S^T = K Q^T and dP^T = V dO^T multiply two bf16
// tiles: one bf16 wgmma each, whose products are exact in its float32
// sums. dV += P^T dO, dK += dS^T Q and dQ += dS K have a float32 operand
// (P or dS): it is split into three bf16 planes (split3), each what the
// planes before it leave rounded toward zero to bf16 (the float32 bits
// with the low 16 cleared): hi = rz(x), mid = rz(x - hi), lo = x - hi -
// mid. Each plane takes the next 8 significant bits of x's 24, so lo is a
// bf16 value and hi + mid + lo == x exactly
// (tests/test_torch_flash_bf16_planes.py), and each plane times a bf16
// value is exact in float32. The three products go into one float32
// accumulator, small planes first. So the kernel forms the reference's
// float32 products, up to the order of the float32 sums. Rounding each
// plane to nearest even (cvt.rn.bf16x2.f32, the conversion pipe) is as
// exact and was 4% slower at tinyllama-1.1b's layer (PERF.md).
//
// Bound: operations. Per visible (query, key) pair and query head the
// function needs five products of 2 hd FLOP; at their least, two bf16 x
// bf16 and three at 3 bf16 passes: 11 bf16 passes (chip_smoke.py::
// flash_bwd_bound). At tinyllama-1.1b's train_4k layer (B, S, H, KV, hd) =
// (4, 4096, 32, 4, 64), causal: 1.5290 ms at the 989 TFLOP/s bf16 peak of
// an NVIDIA H100 (700 W), against 0.091 ms for its bytes at 3.35 TB/s.
//
// What this replaces, measured (PERF.md, step 0 of this design: one traced
// call at that layer, 9.1469 ms of device time on an H100 80GB HBM3 at 700
// W): the
// bf16 instantiation of flash_attention_bwd.cu, two main launches 3.9185
// ms each, two dq-partials reductions 0.4195 ms each (the float32 dq_acc
// between them ~0.08 ms of their traffic), and torch's D = rowsum(dO O)
// 0.4708 ms (two widening copies, a product, a sum). Its four faults and
// what this design does about each:
//  1. products in TF32, 8 passes per 5 products at half the bf16 rate:
//     here every product is a bf16 wgmma, 13 passes in all (below), on
//     Hopper's full-rate path;
//  2. everything widened to float32 in shared memory (214,528 B at hd 64,
//     one block of 8 warps an SM, 4-byte fragment reads): here K, V, Q, dO
//     stay bf16 in shared memory as wgmma's 128-byte-swizzled tiles, copied
//     with 16-byte cp.async through a ring of STAGES = 2 stages (TMA not
//     used: a row tile of (position, head) rows of one KV head is no box
//     for G that does not divide it); 67,072 B at hd 64;
//  3. dq partials per key tile in a float32 scratch that grows with S^2
//     (4 GiB at that layer, two chunks under the 2 GiB budget, 2.2 GB
//     written and read): here dq has a pass of its own, which recomputes S
//     and dP per row tile over the key tiles its limits reach (1 + 1 + 3
//     bf16 passes; the dk/dv pass runs 1 + 1 + 3 + 3): 13 passes, 1.81 ms
//     at peak at that layer. No scratch, no chunks, no dq_acc, no reduce
//     kernel; D is a kernel of its own (one read of dO and O);
//  4. load imbalance (a chunk's 16 x 16 blocks, one an SM, key tiles whose
//     work differs 32x): here each pass is one launch of all its tiles, the
//     heaviest first (key tile 0 first for dk/dv, the last row tile first
//     for dq, as causal rows give them the most work).
//
// Design (deterministic: no atomics, every sum in a fixed order):
//  * dk/dv pass (flash_bwd_bf16_dkdv_kernel): a block of two warpgroups per
//    (batch x KV head, tile of BKV keys); K and V of the tile stay in shared
//    memory; a loop walks the tiles of BR rows that the causal and window
//    limits let see the keys, in ascending order. Per row tile each
//    warpgroup (64 keys) computes S^T = K Q^T and dP^T = V dO^T (m64nBRk16,
//    both operands in shared memory), P^T and dS^T in registers, then dV +=
//    P^T dO and dK += dS^T Q with each plane of P^T / dS^T as wgmma's
//    register A operand straight from the accumulator (its layout is the A
//    fragment's) and dO / Q read MN-major from the same tiles (m64nHDk16).
//    dK and dV sum over every row tile, all G query heads of the KV head, in
//    that order, in registers. At hd 256 a 64 x 256 float32 accumulator is
//    128 registers a thread, so the two warpgroups share 64 keys: one forms
//    P^T and dV, the other dS^T and dK (SPLIT; S^T runs in both, 14 passes);
//  * dq pass (flash_bwd_bf16_dq_kernel): a block per (batch x KV head,
//    tile of 64 rows a warpgroup); Q and dO of the rows stay in shared
//    memory; a loop walks the key tiles of BN keys the rows' limits reach,
//    in ascending order: S = Q K^T, dP = dO V^T (m64nBNk16), dS in
//    registers, dQ += dS K (dS's planes as the register A operand, K
//    MN-major). Each row's dq sums its key tiles in order in registers and
//    is written once. One warpgroup a block, three blocks an SM at hd <= 64
//    (168 registers), two at 128; at hd 256 two warpgroups share the key
//    tiles (smem);
//  * tiles per head dim (Cfg): hd 32 is held as 64 columns, zero above 32
//    (one 128-byte swizzle atom a row; its products run at hd 64's cost);
//    BR = 64 rows a step at hd 32 / 64, 32 at 128 / 256 (registers); BN =
//    64 keys at hd <= 128, 32 at 256. wgmma takes 64 rows a warpgroup at
//    every head dim, so no head dim needs mma.sync;
//  * a warpgroup skips a step its keys and rows cannot see, and evaluates
//    the masks only on steps that straddle a limit (or the end of the keys
//    or rows);
//  * P = 2^((s - lse) log2 e) by ex2.approx.ftz, as flash_attention_bwd.cu
//    (its header gives the error); accurate tanhf for the softcap.
//
// Measured (PERF.md; H100 80GB HBM3, 700 W): 5.41 ms at that layer
// (dk/dv 3.55, dq 1.88, D 0.05), 0.28 of the bound. What binds, from
// ablations (scripts/flash_bwd_bf16_ab.py): the dV, dK, dQ products with a
// register A operand; without them the passes take 0.99 + 0.59 ms, with
// one plane 2.66 + 1.57, and the split's ALU adds 0.64. The registers
// (236 a thread in dk/dv, 168 in dq) leave no room to keep a step's
// products in flight past the next step's barrier: tried, that spilled and
// was slower; so was one warpgroup a dk/dv block.
// Row math is int32 within one (batch, KV head): Sq * H must stay below
// 2^31 (the launcher refuses more).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_bf16.cuh"

namespace {

using namespace bf16mma;
using io::store2;

constexpr int STAGES = 2;                   // ring of row / key tiles

// Tiles per head dim: HDP columns held in shared memory, BR rows a step of
// the dk/dv pass, BN keys a step of the dq pass; KW / QW warpgroups a block
// of the dk/dv / dq pass, KB / QB blocks an SM holds (launch bounds: the
// registers a thread may take); SPLIT (see top)
template <int HD> struct Cfg;
template <> struct Cfg<32> {
    static constexpr int HDP = 64, BR = 64, BN = 64, KW = 2, QW = 1, KB = 1,
                         QB = 3;
    static constexpr bool SPLIT = false;
};
template <> struct Cfg<64> {
    static constexpr int HDP = 64, BR = 64, BN = 64, KW = 2, QW = 1, KB = 1,
                         QB = 3;
    static constexpr bool SPLIT = false;
};
template <> struct Cfg<128> {
    static constexpr int HDP = 128, BR = 32, BN = 64, KW = 2, QW = 1, KB = 1,
                         QB = 2;
    static constexpr bool SPLIT = false;
};
template <> struct Cfg<256> {
    static constexpr int HDP = 256, BR = 32, BN = 32, KW = 2, QW = 2, KB = 1,
                         QB = 1;
    static constexpr bool SPLIT = true;
};

// keys a block of the dk/dv pass, rows a block of the dq pass
template <int HD>
__host__ __device__ constexpr int bkv() {
    return Cfg<HD>::SPLIT ? 64 : 64 * Cfg<HD>::KW;
}
template <int HD>
__host__ __device__ constexpr int bq() {
    return 64 * Cfg<HD>::QW;
}
// bytes of a tile of R rows x HDP bf16 columns
template <int HD>
__host__ __device__ constexpr int tile_bytes(int r) {
    return r * Cfg<HD>::HDP * 2;
}
// dynamic shared memory of each pass, with 1024 bytes to align the base
template <int HD> constexpr size_t dkdv_smem() {
    return 1024 + 2 * tile_bytes<HD>(bkv<HD>())
           + 2 * STAGES * tile_bytes<HD>(Cfg<HD>::BR)
           + 3 * STAGES * Cfg<HD>::BR * 4;
}
template <int HD> constexpr size_t dq_smem() {
    return 1024 + 2 * tile_bytes<HD>(bq<HD>())
           + 2 * STAGES * tile_bytes<HD>(Cfg<HD>::BN);
}

// P and dS of one score s (before scale) and its dp, for a row with lse
// and D = dsum; the caller masks
template <bool CAP>
__device__ __forceinline__ void p_ds(float& s, float& dp, float lse,
                                     float dsum, float scale, float cap) {
    float x = s * scale;
    if (CAP) x = cap * tanhf(x / cap);
    const float p = exp2_ftz((x - lse) * LOG2E);
    float ds = p * (dp - dsum);
    if (CAP) {
        const float u = x / cap;
        ds *= 1.0f - u * u;
    }
    s = p;
    dp = ds;
}

// the query positions [s_begin, s_end) that see a key of [k0, k_last]
__device__ __forceinline__ void key_tile_rows(
        int64_t k0, int64_t k_last, int sq, int causal, int window,
        int64_t q_offset, int64_t& s_begin, int64_t& s_end) {
    s_begin = 0;
    s_end = sq;
    if (causal && k0 - q_offset > s_begin) s_begin = k0 - q_offset;
    if (window > 0 && k_last + window - q_offset < s_end)
        s_end = k_last + window - q_offset;
    if (s_end < s_begin) s_end = s_begin;
}

struct Args {
    const bf16 *q, *k, *v, *dout;
    const float *lse, *dsum;
    bf16 *dq, *dk, *dv;
    int bh;               // batch x KV heads: blockIdx.x = tile x bh + (b, kv)
    int sq, tk, h, kvh;
    float scale, cap;
    int causal, window;
    int64_t q_offset;
};

// ---------------------------------------------------------------------------
// dk / dv pass. One warpgroup's share of a block: keys [wk0, wk0 + 64) of
// the block's tile; DK / DV: which accumulators it keeps (both, unless
// SPLIT).
template <int HD, bool DK, bool DV>
__device__ __forceinline__ void dkdv_warpgroup(const Args& a, int wk0) {
    using C = Cfg<HD>;
    constexpr int HDP = C::HDP, BR = C::BR, BKV = bkv<HD>();
    constexpr int NT = WG_THREADS * C::KW;
    constexpr int NS = BR / 2, ND = HDP / 2;       // accumulator floats
    uint8_t* sm = smem_base();
    uint8_t* Ks = sm;
    uint8_t* Vs = Ks + tile_bytes<HD>(BKV);
    uint8_t* Qs = Vs + tile_bytes<HD>(BKV);        // STAGES tiles of BR rows
    uint8_t* Os = Qs + STAGES * tile_bytes<HD>(BR);
    float* lse_s = reinterpret_cast<float*>(Os + STAGES * tile_bytes<HD>(BR));
    float* dsum_s = lse_s + STAGES * BR;
    int* rel_s = reinterpret_cast<int*>(dsum_s + STAGES * BR);

    const int tid = threadIdx.x;
    const int w = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2,
              t = lane & 3;
    const int G = a.h / a.kvh, bh = (int)(blockIdx.x % a.bh);
    const int b = bh / a.kvh, kh = bh % a.kvh;
    const Rows rows{a.sq * G, G, a.h,
                    (int64_t)b * a.sq * a.h + (int64_t)kh * G};
    const int k0 = (int)(blockIdx.x / a.bh) * BKV;
    const int kmax = a.tk - k0 < BKV ? a.tk - k0 : BKV;

    auto key_row = [&](const bf16* x) {
        return [=](int j) -> const bf16* {
            return j < kmax
                ? x + (((int64_t)b * a.tk + k0 + j) * a.kvh + kh) * HD
                : nullptr;
        };
    };
    load_tile<HD, BKV, NT>(Ks, a.k, key_row(a.k));
    load_tile<HD, BKV, NT>(Vs, a.v, key_row(a.v));
    tf32x3::cp_async_commit();

    int64_t s_begin, s_end;
    key_tile_rows(k0, k0 + kmax - 1, a.sq, a.causal, a.window, a.q_offset,
                  s_begin, s_end);
    const int r_begin = (int)(s_begin * G), r_end = (int)(s_end * G);
    const int nsteps = (r_end - r_begin + BR - 1) / BR;

    // Q, dO, lse, D and each row's position relative to k0 of the row tile
    // from r0 into stage st (one commit group)
    auto issue = [&](int r0, int st) {
        auto row = [&](const bf16* x) {
            return [=](int i) -> const bf16* {
                return r0 + i < rows.total ? x + rows.index(r0 + i) * HD
                                           : nullptr;
            };
        };
        load_tile<HD, BR, NT>(Qs + st * tile_bytes<HD>(BR), a.q, row(a.q));
        load_tile<HD, BR, NT>(Os + st * tile_bytes<HD>(BR), a.dout,
                          row(a.dout));
        if (tid < BR) {
            const int r = r0 + tid;
            const bool ok = r < rows.total;
            const int64_t idx = ok ? rows.index(r) : 0;
            cp_async4(lse_s + st * BR + tid, a.lse + idx, ok ? 4 : 0);
            cp_async4(dsum_s + st * BR + tid, a.dsum + idx, ok ? 4 : 0);
            rel_s[st * BR + tid] =
                ok ? rel32(a.q_offset + r / G - k0) : NO_ROW;
        }
        tf32x3::cp_async_commit();
    };

    float dka[DK ? ND : 1], dva[DV ? ND : 1];
#pragma unroll
    for (int i = 0; i < ND; ++i) {
        if constexpr (DK) dka[i] = 0.0f;
        if constexpr (DV) dva[i] = 0.0f;
    }

    if (nsteps > 0) issue(r_begin, 0);
    for (int it = 0; it < nsteps; ++it) {
        const int r0 = r_begin + it * BR, st = it % STAGES;
        tf32x3::cp_async_wait<0>();     // stage st (and K, V) landed
        fence_async_smem();
        block_sync<NT>();
        if (it + 1 < nsteps) issue(r0 + BR, (it + 1) % STAGES);

        // this warpgroup's keys against the row tile's positions
        const int r_last = (r0 + BR < rows.total ? r0 + BR : rows.total) - 1;
        const int64_t q_lo = a.q_offset + r0 / G;
        const int64_t q_hi = a.q_offset + r_last / G;
        const int64_t kw_lo = k0 + wk0, kw_hi = k0 + wk0 + 63;
        const bool none = kw_lo >= a.tk || (a.causal && kw_lo > q_hi) ||
                          (a.window > 0 && q_lo - kw_hi >= a.window);
        if (none) continue;
        const bool full = kw_hi < a.tk && r0 + BR <= rows.total &&
                          (!a.causal || kw_hi <= q_lo) &&
                          (a.window <= 0 || q_hi - kw_lo < a.window);
        const uint8_t* Qt = Qs + st * tile_bytes<HD>(BR);
        const uint8_t* Ot = Os + st * tile_bytes<HD>(BR);

        float sc[NS], dp[NS];
        wg::fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
            wg::ss(sc, wg::kdesc(Ks, BKV, wk0, kk), wg::kdesc(Qt, BR, 0, kk),
                   kk);
        if constexpr (DK) {
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk)
                wg::ss(dp, wg::kdesc(Vs, BKV, wk0, kk),
                       wg::kdesc(Ot, BR, 0, kk), kk);
        }
        wg::commit();
        wg::wait<0>();
        wg::hold(sc);
        if constexpr (DK) wg::hold(dp);

        // P^T and dS^T: element 4 j + e at key wk0 + 16 w + g + 8 (e >> 1),
        // row 8 j + 2 t + (e & 1) of the tile
        const float* lse_t = lse_s + st * BR;
        const float* dsum_t = dsum_s + st * BR;
        const int* rel_t = rel_s + st * BR;
        const int kl = wk0 + 16 * w + g;
#pragma unroll
        for (int j = 0; j < NS / 4; ++j) {
            const int rl = 8 * j + 2 * t;
            const float2 l2 = *reinterpret_cast<const float2*>(lse_t + rl);
            const float2 d2 = *reinterpret_cast<const float2*>(dsum_t + rl);
            const int2 q2 = *reinterpret_cast<const int2*>(rel_t + rl);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const bool odd = e & 1;
                float dpe = DK ? dp[4 * j + e] : 0.0f;
                if (a.cap != 0.0f)
                    p_ds<true>(sc[4 * j + e], dpe, odd ? l2.y : l2.x,
                               odd ? d2.y : d2.x, a.scale, a.cap);
                else
                    p_ds<false>(sc[4 * j + e], dpe, odd ? l2.y : l2.x,
                                odd ? d2.y : d2.x, a.scale, a.cap);
                if (!full && !visible(odd ? q2.y : q2.x, kl + 8 * (e >> 1),
                                      kmax, a.causal, a.window)) {
                    sc[4 * j + e] = 0.0f;
                    dpe = 0.0f;
                }
                if constexpr (DK) dp[4 * j + e] = dpe;
            }
        }

        // dV += P^T dO, dK += dS^T Q: the planes of P^T / dS^T as the
        // register A operand, dO and Q MN-major; dS^T's planes are formed
        // while dV's products run
        if constexpr (DV) planes_mma<BR / 16>(dva, sc, Ot, BR);
        if constexpr (DK) planes_mma<BR / 16>(dka, dp, Qt, BR);
        wg::commit();
        wg::wait<0>();
    }
    tf32x3::cp_async_wait<0>();        // the K, V copies of an idle block
    if constexpr (DK) wg::hold(dka);
    if constexpr (DV) wg::hold(dva);

    // dK = scale x dka, dV = dva: element 4 j + e at key wk0 + 16 w + g +
    // 8 (e >> 1), column 8 j + 2 t + (e & 1)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int kl = wk0 + 16 * w + g + 8 * half;
        if (kl >= kmax) continue;
        const int64_t off =
            (((int64_t)b * a.tk + k0 + kl) * a.kvh + kh) * HD + 2 * t;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
            if constexpr (DK)
                store2(a.dk + off + 8 * j, dka[4 * j + 2 * half] * a.scale,
                       dka[4 * j + 2 * half + 1] * a.scale);
            if constexpr (DV)
                store2(a.dv + off + 8 * j, dva[4 * j + 2 * half],
                       dva[4 * j + 2 * half + 1]);
        }
    }
}

template <int HD>
__global__ void __launch_bounds__(WG_THREADS * Cfg<HD>::KW, Cfg<HD>::KB)
flash_bwd_bf16_dkdv_kernel(const Args a) {
    const int wgi = threadIdx.x / WG_THREADS;
    if constexpr (Cfg<HD>::SPLIT) {
        if (wgi == 0) dkdv_warpgroup<HD, false, true>(a, 0);
        else dkdv_warpgroup<HD, true, false>(a, 0);
    } else {
        dkdv_warpgroup<HD, true, true>(a, 64 * wgi);
    }
}

// ---------------------------------------------------------------------------
// dq pass: one block per (batch x KV head, tile of BQ rows), 64 rows a
// warpgroup; row tiles last first (`tiles` of them)
template <int HD>
__global__ void __launch_bounds__(WG_THREADS * Cfg<HD>::QW, Cfg<HD>::QB)
flash_bwd_bf16_dq_kernel(const Args a, int tiles) {
    using C = Cfg<HD>;
    constexpr int HDP = C::HDP, BN = C::BN, BQ = bq<HD>();
    constexpr int NT = WG_THREADS * C::QW;
    constexpr int NS = BN / 2, ND = HDP / 2;
    uint8_t* sm = smem_base();
    uint8_t* Qs = sm;
    uint8_t* Os = Qs + tile_bytes<HD>(BQ);
    uint8_t* Ks = Os + tile_bytes<HD>(BQ);          // STAGES tiles of BN keys
    uint8_t* Vs = Ks + STAGES * tile_bytes<HD>(BN);

    const int tid = threadIdx.x, wgi = tid / WG_THREADS;
    const int w = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2,
              t = lane & 3;
    const int G = a.h / a.kvh, bh = (int)(blockIdx.x % a.bh);
    const int b = bh / a.kvh, kh = bh % a.kvh;
    const Rows rows{a.sq * G, G, a.h,
                    (int64_t)b * a.sq * a.h + (int64_t)kh * G};
    const int R0 = (tiles - 1 - (int)(blockIdx.x / a.bh)) * BQ;

    load_tile<HD, BQ, NT>(Qs, a.q, [&](int i) -> const bf16* {
        return R0 + i < rows.total ? a.q + rows.index(R0 + i) * HD : nullptr;
    });
    load_tile<HD, BQ, NT>(Os, a.dout, [&](int i) -> const bf16* {
        return R0 + i < rows.total ? a.dout + rows.index(R0 + i) * HD
                                   : nullptr;
    });
    tf32x3::cp_async_commit();

    // the keys the block's rows see: [k_lo, k_hi]
    const int R1 = (R0 + BQ < rows.total ? R0 + BQ : rows.total) - 1;
    int64_t k_lo = 0, k_hi = (int64_t)a.tk - 1;
    if (a.causal && a.q_offset + R1 / G < k_hi) k_hi = a.q_offset + R1 / G;
    if (a.window > 0 && a.q_offset + R0 / G - a.window + 1 > k_lo)
        k_lo = a.q_offset + R0 / G - a.window + 1;
    const int nsteps = k_lo > k_hi ? 0 : (int)((k_hi - k_lo) / BN + 1);

    auto issue = [&](int kb, int st) {
        auto row = [&](const bf16* x) {
            return [=](int j) -> const bf16* {
                return kb + j < a.tk
                    ? x + (((int64_t)b * a.tk + kb + j) * a.kvh + kh) * HD
                    : nullptr;
            };
        };
        load_tile<HD, BN, NT>(Ks + st * tile_bytes<HD>(BN), a.k, row(a.k));
        load_tile<HD, BN, NT>(Vs + st * tile_bytes<HD>(BN), a.v, row(a.v));
        tf32x3::cp_async_commit();
    };

    // this thread's two rows: 16 w + g and + 8 of the warpgroup's 64
    const int wr0 = R0 + 64 * wgi;
    int ra[2];
    float lse_r[2], dsum_r[2];
    int64_t pos[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        ra[i] = wr0 + 16 * w + g + 8 * i;
        const bool ok = ra[i] < rows.total;
        const int64_t idx = ok ? rows.index(ra[i]) : 0;
        lse_r[i] = ok ? a.lse[idx] : 0.0f;
        dsum_r[i] = ok ? a.dsum[idx] : 0.0f;
        pos[i] = a.q_offset + ra[i] / G;
    }
    const int wr_last = (wr0 + 64 < rows.total ? wr0 + 64 : rows.total) - 1;
    const bool w_rows = wr0 < rows.total;
    const int64_t p_lo = a.q_offset + wr0 / G;
    const int64_t p_hi = a.q_offset + wr_last / G;

    float dqa[ND];
#pragma unroll
    for (int i = 0; i < ND; ++i) dqa[i] = 0.0f;

    if (nsteps > 0) issue((int)k_lo, 0);
    for (int it = 0; it < nsteps; ++it) {
        const int kb = (int)k_lo + it * BN, st = it % STAGES;
        tf32x3::cp_async_wait<0>();     // stage st (and Q, dO) landed
        fence_async_smem();
        block_sync<NT>();
        if (it + 1 < nsteps) issue(kb + BN, (it + 1) % STAGES);

        const int kmax = a.tk - kb < BN ? a.tk - kb : BN;
        const bool none = !w_rows || (a.causal && kb > p_hi) ||
                          (a.window > 0 && p_lo - (kb + kmax - 1)
                                                   >= a.window);
        if (none) continue;
        const bool full = kmax == BN && wr0 + 64 <= rows.total &&
                          (!a.causal || kb + BN - 1 <= p_lo) &&
                          (a.window <= 0 || p_hi - kb < a.window);
        const uint8_t* Kt = Ks + st * tile_bytes<HD>(BN);
        const uint8_t* Vt = Vs + st * tile_bytes<HD>(BN);

        float sc[NS], dp[NS];
        wg::fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
            wg::ss(sc, wg::kdesc(Qs, BQ, 64 * wgi, kk),
                   wg::kdesc(Kt, BN, 0, kk), kk);
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
            wg::ss(dp, wg::kdesc(Os, BQ, 64 * wgi, kk),
                   wg::kdesc(Vt, BN, 0, kk), kk);
        wg::commit();
        wg::wait<0>();
        wg::hold(sc);
        wg::hold(dp);

        // dS: element 4 j + e at row 16 w + g + 8 (e >> 1), key 8 j + 2 t +
        // (e & 1) of the tile
        int rel[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
            rel[i] = ra[i] < rows.total ? rel32(pos[i] - kb) : NO_ROW;
#pragma unroll
        for (int j = 0; j < NS / 4; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int i = e >> 1;
                if (a.cap != 0.0f)
                    p_ds<true>(sc[4 * j + e], dp[4 * j + e], lse_r[i],
                               dsum_r[i], a.scale, a.cap);
                else
                    p_ds<false>(sc[4 * j + e], dp[4 * j + e], lse_r[i],
                                dsum_r[i], a.scale, a.cap);
                if (!full && !visible(rel[i], 8 * j + 2 * t + (e & 1), kmax,
                                      a.causal, a.window))
                    dp[4 * j + e] = 0.0f;
            }
        }

        // dQ += dS K: dS's planes as the register A operand, K MN-major
        planes_mma<BN / 16>(dqa, dp, Kt, BN);
        wg::commit();
        wg::wait<0>();
    }
    tf32x3::cp_async_wait<0>();        // the Q, dO copies of an idle block
    wg::hold(dqa);

#pragma unroll
    for (int i = 0; i < 2; ++i) {
        if (ra[i] >= rows.total) continue;
        bf16* o = a.dq + rows.index(ra[i]) * HD + 2 * t;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
            store2(o + 8 * j, dqa[4 * j + 2 * i] * a.scale,
                   dqa[4 * j + 2 * i + 1] * a.scale);
    }
}

// ---------------------------------------------------------------------------
// D = rowsum(dO O) in float32 from bf16 dO and O: one 16-byte chunk of a
// row a thread (HD / 8 threads a row), its eight products summed in order,
// then the row's chunks by a butterfly of shuffles (a fixed order)
template <int HD>
__global__ void __launch_bounds__(256)
flash_bwd_bf16_dsum_kernel(const bf16* __restrict__ out,
                           const bf16* __restrict__ dout,
                           float* __restrict__ dsum, int64_t n_rows) {
    constexpr int TPR = HD / 8;                 // threads a row
    const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    const int64_t r = idx / TPR;
    float acc = 0.0f;
    if (r < n_rows) {
        const int64_t off = r * HD + (idx % TPR) * 8;
        const uint4 o4 = *reinterpret_cast<const uint4*>(out + off);
        const uint4 d4 = *reinterpret_cast<const uint4*>(dout + off);
        const __nv_bfloat162* o2 =
            reinterpret_cast<const __nv_bfloat162*>(&o4);
        const __nv_bfloat162* d2 =
            reinterpret_cast<const __nv_bfloat162*>(&d4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float2 of = __bfloat1622float2(o2[i]);
            const float2 df = __bfloat1622float2(d2[i]);
            acc += df.x * of.x;
            acc += df.y * of.y;
        }
    }
#pragma unroll
    for (int m = TPR / 2; m > 0; m >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, m, TPR);
    if (r < n_rows && idx % TPR == 0) dsum[r] = acc;
}

// the three kernels on `stream`: D, then the dk / dv pass, then the dq
// pass; 0 or the first CUDA error
template <int HD>
int launch(const Args& a, const bf16* out, float* dsum, int b,
           cudaStream_t stream) {
    const int64_t n_rows = (int64_t)b * a.sq * a.h;
    if (n_rows > 0) {
        const int64_t threads = n_rows * (HD / 8);
        flash_bwd_bf16_dsum_kernel<HD>
            <<<(unsigned)((threads + 255) / 256), 256, 0, stream>>>(
                out, a.dout, dsum, n_rows);
        const cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    const int64_t nkt = ((int64_t)a.tk + bkv<HD>() - 1) / bkv<HD>();
    const int64_t nrt =
        ((int64_t)a.sq * (a.h / a.kvh) + bq<HD>() - 1) / bq<HD>();
    if (nkt * a.bh > INT_MAX || nrt * a.bh > INT_MAX)
        return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_bf16_dkdv_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dkdv_smem<HD>());
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(flash_bwd_bf16_dq_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dq_smem<HD>());
    if (e != cudaSuccess) return (int)e;
    if (nkt > 0) {
        flash_bwd_bf16_dkdv_kernel<HD>
            <<<(unsigned)(nkt * a.bh), WG_THREADS * Cfg<HD>::KW,
               dkdv_smem<HD>(), stream>>>(a);
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    if (nrt > 0) {
        flash_bwd_bf16_dq_kernel<HD>
            <<<(unsigned)(nrt * a.bh), WG_THREADS * Cfg<HD>::QW,
               dq_smem<HD>(), stream>>>(
                a, (int)nrt);
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    return 0;
}

}  // namespace

// Plain C entry point (loaded with ctypes). q, out, dout, dq (B, Sq, H, hd);
// k, v, dk, dv (B, Tk, KV, hd), all bfloat16; lse (B, Sq, H) float32, the
// forward's (flash_attention_fwd_launch's lse output); dsum a float32 (B,
// Sq, H) buffer the first kernel fills with rowsum(dout * out); all
// contiguous and 16-byte aligned; hd in {32, 64, 128, 256}; H % KV == 0; Sq
// * H below 2^31. Launches three kernels on `stream`; returns 0 or the CUDA
// error.
extern "C" int flash_attention_bwd_bf16_launch(
        const void* q, const void* k, const void* v, const void* out,
        const void* dout, const void* lse, void* dsum, void* dq, void* dk,
        void* dv, int b, int sq, int tk, int h, int kvh, int hd, float scale,
        int causal, int window, float cap, int64_t q_offset, void* stream) {
    if (b <= 0) return (int)cudaGetLastError();
    if (kvh <= 0 || h % kvh != 0 || sq < 0 || tk < 0 ||
        (int64_t)sq * h >= INT_MAX || (int64_t)b * kvh >= INT_MAX)
        return (int)cudaErrorInvalidValue;
    const Args a{(const bf16*)q, (const bf16*)k, (const bf16*)v,
                 (const bf16*)dout, (const float*)lse, (const float*)dsum,
                 (bf16*)dq, (bf16*)dk, (bf16*)dv, b * kvh, sq, tk, h, kvh,
                 scale, cap, causal, window, q_offset};
    const bf16* o = (const bf16*)out;
    float* d = (float*)dsum;
    cudaStream_t st = (cudaStream_t)stream;
    switch (hd) {
        case 32: return launch<32>(a, o, d, b, st);
        case 64: return launch<64>(a, o, d, b, st);
        case 128: return launch<128>(a, o, d, b, st);
        case 256: return launch<256>(a, o, d, b, st);
        default: return (int)cudaErrorInvalidValue;
    }
}
