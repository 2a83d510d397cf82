// Flash attention backward for Hopper (sm_90a): dq, dk, dv of exactly the
// function of flash_attention.cu (GQA, scale, causal, sliding window,
// q_offset, tanh softcap before the masks), in float32, products on the
// tensor cores in 3xTF32 (../../csrc/mma_tf32.cuh).
//
// Stands beside repro/kernels/attention/ops.py:37::_bwd, the custom VJP of
// the TPU kernel. There the backward is no Pallas kernel: it recomputes
// through the VJP of flash_attention_xla in XLA ops.
//
// Math. With raw = scale * q.k, s = cap * tanh(raw / cap) (or raw), the
// forward's per-row log-sum-exp lse (flash_attention.cu, optional output)
// and D_i = rowsum(dO_i * O_i) (a torch reduction in the wrapper):
//     P_ij  = visible(i, j) ? exp(s_ij - lse_i) : 0
//     dP_ij = dO_i . v_j
//     dS_ij = P_ij (dP_ij - D_i) * (1 - (s_ij / cap)^2 if cap else 1)
//     dv_j  = sum_i P_ij dO_i        dk_j = scale * sum_i dS_ij q_i
//     dq_i  = scale * sum_j dS_ij k_j
// where i runs over the (query position, query head) rows of one KV head,
// so dk and dv sum over the H / KV query heads of their KV head. A fully
// masked row has lse = the clamped max and every P_ij = 0: its gradients
// are 0.
//
// Bound: operations. The function needs five products of 2 * hd FLOP per
// visible (query, key) pair and query head (Q K^T, dO V^T, P^T dO, dS^T Q,
// dS K): 10 * hd FLOP. At tinyllama-1.1b's training shape (B, S, H, KV,
// hd) = (4, 2048, 32, 4, 64), causal, that is ~1.7e11 FLOP per launch: on
// an NVIDIA H100 (700 W) ~1.0 ms as three TF32 products each at the 495
// TFLOP/s data-sheet peak, ~2.6 ms at the 67 TFLOP/s of float32 outside
// the tensor cores, against ~0.1 ms of memory traffic (q, k, v, out, dO,
// lse in, dq, dk, dv out, once each) at 3.35 TB/s.
//
// Design (simple and deterministic, no atomics): two kernels, launched
// back to back on one stream.
//  * dkdv: one block of 8 warps per (batch x KV head, tile of BKV keys). K
//    and V of the tile stay in shared memory; a loop walks the tiles of BR
//    rows that the causal and window limits let see the tile. Per row tile
//    (phase A) each warp recomputes a 16-key x (BR / WPM)-row piece of S^T
//    = K Q^T and dP^T = V dO^T, turns it into P^T and dS^T in registers and
//    stores both in shared memory; then (phase B) each warp accumulates a
//    16-key x (HD / WPM)-column piece of dV += P^T dO and dK += dS^T Q in
//    registers (16 to 64 floats a lane). Tiles: BKV x BR = 64 x 64 at hd 32
//    and 64, 64 x 32 at hd 128, 32 x 32 at hd 256 (shared memory: K, V, Q,
//    dO rows padded to hd + 4 floats, P^T and dS^T rows to BR + 8, so
//    every fragment access hits 32 distinct banks; 143,872 bytes at hd 256,
//    107,520 at hd 64, under the 232,448 a block may use);
//  * dq: one block per (batch x KV head, tile of 16 x W rows), the
//    forward's layout: Q and dO rows stay in shared memory, a loop walks
//    the visible tiles of 32 keys (each warp skips those its 16 rows
//    cannot see) and each warp accumulates its 16 x hd piece of dq in
//    registers. W = 8 warps, or 4 at hd 256 (shared memory 199,680 bytes);
//  * products: m16n8k8 mma.sync in 3xTF32, P^T / dS^T / dS feed the next
//    product as its A operand through mma_tf32.cuh's k-permutation; loads
//    are 16-byte cp.async, not overlapped with compute (a later redesign);
//  * q is not pre-scaled (cp.async copies it as it is): scores are scale *
//    (q . k), and dk, dq are scaled once when written;
//  * numerics as the forward: softcap before the masks, accurate expf and
//    tanhf (no --use_fast_math), float32 throughout.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

using tf32x3::FragA;

constexpr int WARPS = 8;                 // dkdv kernel
constexpr int THREADS = 32 * WARPS;
constexpr int BK = 32;                   // keys per tile of the dq kernel
constexpr int64_t NO_ROW = INT64_MIN;    // position of a padding row

// dkdv tiles: BKV keys per block, BR rows per step
template <int HD> struct KV;
template <> struct KV<32> { static constexpr int BKV = 64, BR = 64; };
template <> struct KV<64> { static constexpr int BKV = 64, BR = 64; };
template <> struct KV<128> { static constexpr int BKV = 64, BR = 32; };
template <> struct KV<256> { static constexpr int BKV = 32, BR = 32; };

// warps (16 rows each) of a dq block
template <int HD> struct QW {
    static constexpr int value = HD == 256 ? 4 : 8;
};

template <int HD>
constexpr size_t dkdv_smem() {
    constexpr int BKV = KV<HD>::BKV, BR = KV<HD>::BR;
    return sizeof(float) * ((size_t)2 * BKV * (HD + 4)
                            + (size_t)2 * BR * (HD + 4)
                            + (size_t)2 * BKV * (BR + 8) + 2 * BR)
           + sizeof(int64_t) * BR;
}

template <int HD>
constexpr size_t dq_smem() {
    return sizeof(float) * (size_t)(2 * 16 * QW<HD>::value + 2 * BK)
           * (HD + 4);
}

__device__ __forceinline__ bool visible(int64_t qp, int64_t kp, int64_t tk,
                                        int causal, int window) {
    bool ok = qp != NO_ROW && kp < tk;
    if (causal) ok = ok && qp >= kp;
    if (window > 0) ok = ok && (qp - kp) < window;
    return ok;
}

// softcap, and the factor it puts on the gradient of the raw score
__device__ __forceinline__ float capped(float raw, float cap) {
    return cap != 0.0f ? cap * tanhf(raw / cap) : raw;
}
__device__ __forceinline__ float cap_grad(float s, float cap) {
    if (cap == 0.0f) return 1.0f;
    const float u = s / cap;
    return 1.0f - u * u;
}

struct Rows {             // the flattened rows of one (batch, KV head)
    int64_t sq, total;
    int b, kh, h, G;
    // index of row r in a (B, Sq, H) array (times HD: its first element)
    __device__ __forceinline__ int64_t index(int64_t r) const {
        const int64_t s = r / G;
        return ((int64_t)b * sq + s) * h + (int64_t)kh * G + (r - s * G);
    }
};

// rows r0 .. r0 + n - 1 of q or dO (rows past the end: zeros) into dst
template <int HD>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          const Rows& rows, int64_t r0,
                                          int n, int tid, int nthreads) {
    constexpr int S = HD + 4;
    for (int idx = tid; idx < n * HD / 4; idx += nthreads) {
        const int r = idx / (HD / 4), d = (idx % (HD / 4)) * 4;
        const int64_t rg = r0 + r;
        const bool ok = rg < rows.total;
        tf32x3::cp_async16(dst + r * S + d,
                           src + (ok ? rows.index(rg) * HD + d : 0),
                           ok ? 16 : 0);
    }
}

// keys k0 .. k0 + n - 1 of k or v of KV head kh (keys past tk: zeros)
template <int HD>
__device__ __forceinline__ void load_keys(float* dst, const float* src,
                                          int b, int kh, int kvh, int64_t tk,
                                          int64_t k0, int n, int tid,
                                          int nthreads) {
    constexpr int S = HD + 4;
    for (int idx = tid; idx < n * HD / 4; idx += nthreads) {
        const int j = idx / (HD / 4), d = (idx % (HD / 4)) * 4;
        const int64_t kp = k0 + j;
        const bool ok = kp < tk;
        tf32x3::cp_async16(
            dst + j * S + d,
            src + (ok ? (((int64_t)b * tk + kp) * kvh + kh) * HD + d : 0),
            ok ? 16 : 0);
    }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ float2 load2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkdv_kernel(const float* __restrict__ q,      // (B, Sq, H, HD)
                      const float* __restrict__ k,      // (B, Tk, KV, HD)
                      const float* __restrict__ v,      // (B, Tk, KV, HD)
                      const float* __restrict__ dout,   // (B, Sq, H, HD)
                      const float* __restrict__ lse,    // (B, Sq, H)
                      const float* __restrict__ dsum,   // (B, Sq, H)
                      float* __restrict__ dk,           // (B, Tk, KV, HD)
                      float* __restrict__ dv,           // (B, Tk, KV, HD)
                      int sq, int tk, int h, int kvh, float scale,
                      int causal, int window, float cap, int64_t q_offset) {
    constexpr int BKV = KV<HD>::BKV, BR = KV<HD>::BR;
    constexpr int S = HD + 4, PS = BR + 8;
    constexpr int MT = BKV / 16;         // 16-key m-tiles
    constexpr int WPM = WARPS / MT;      // warps per m-tile
    constexpr int NA = BR / 8 / WPM;     // score n-tiles per warp (phase A)
    constexpr int CW = HD / WPM;         // output columns per warp (phase B)
    constexpr int NB = CW / 8;
    extern __shared__ float4 smem4[];
    float* Ks = reinterpret_cast<float*>(smem4);   // BKV x S
    float* Vs = Ks + BKV * S;                      // BKV x S
    float* Qs = Vs + BKV * S;                      // BR x S
    float* Os = Qs + BR * S;                       // BR x S (dO)
    float* Ps = Os + BR * S;                       // BKV x PS (P^T)
    float* Ds = Ps + BKV * PS;                     // BKV x PS (dS^T)
    float* lse_s = Ds + BKV * PS;                  // BR
    float* dsum_s = lse_s + BR;                    // BR
    int64_t* qpos_s = reinterpret_cast<int64_t*>(dsum_s + BR);   // BR

    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int G = h / kvh;
    const Rows rows{sq, (int64_t)sq * G, (int)(blockIdx.y / kvh),
                    (int)(blockIdx.y % kvh), h, G};
    const int64_t k0 = (int64_t)blockIdx.x * BKV;

    load_keys<HD>(Ks, k, rows.b, rows.kh, kvh, tk, k0, BKV, tid, THREADS);
    load_keys<HD>(Vs, v, rows.b, rows.kh, kvh, tk, k0, BKV, tid, THREADS);
    tf32x3::cp_async_commit();

    // the rows that can see a key of this tile
    const int64_t k_last = (k0 + BKV < tk ? k0 + BKV : (int64_t)tk) - 1;
    int64_t s_begin = 0, s_end = sq;
    if (causal && k0 - q_offset > s_begin) s_begin = k0 - q_offset;
    if (window > 0 && k_last + window - q_offset < s_end)
        s_end = k_last + window - q_offset;
    const int64_t r_begin = s_begin * G;
    const int64_t r_end = s_end > s_begin ? s_end * G : r_begin;

    const int m = warp % MT;                 // this warp's 16 keys
    const int nbase = (warp / MT) * NA;      // its score n-tiles
    const int col0 = (warp / MT) * CW;       // its output columns
    float dka[NB][4], dva[NB][4];
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) dka[c][e] = dva[c][e] = 0.0f;

    for (int64_t r0 = r_begin; r0 < r_end; r0 += BR) {
        __syncthreads();                     // the last step's reads done
        load_rows<HD>(Qs, q, rows, r0, BR, tid, THREADS);
        load_rows<HD>(Os, dout, rows, r0, BR, tid, THREADS);
        tf32x3::cp_async_commit();
        for (int i = tid; i < BR; i += THREADS) {
            const int64_t rg = r0 + i;
            if (rg < rows.total) {
                const int64_t idx = rows.index(rg);
                lse_s[i] = lse[idx];
                dsum_s[i] = dsum[idx];
                qpos_s[i] = q_offset + rg / G;
            } else {
                lse_s[i] = 0.0f;
                dsum_s[i] = 0.0f;
                qpos_s[i] = NO_ROW;
            }
        }
        tf32x3::cp_async_wait<0>();
        __syncthreads();

        // phase A: S^T and dP^T for keys 16m .. 16m + 15 x this warp's rows
        {
            float sc[NA][4], dp[NA][4];
#pragma unroll
            for (int n = 0; n < NA; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.0f;
            const float* Kw = Ks + (16 * m + g) * S + t;
            const float* Vw = Vs + (16 * m + g) * S + t;
#pragma unroll 2
            for (int kk = 0; kk < HD / 8; ++kk) {
                FragA ak, av;
                ak.set(Kw[kk * 8], Kw[8 * S + kk * 8], Kw[kk * 8 + 4],
                       Kw[8 * S + kk * 8 + 4]);
                av.set(Vw[kk * 8], Vw[8 * S + kk * 8], Vw[kk * 8 + 4],
                       Vw[8 * S + kk * 8 + 4]);
#pragma unroll
                for (int n = 0; n < NA; ++n) {
                    const int row = (nbase + n) * 8 + g;
                    const float* qr = Qs + row * S + kk * 8 + t;
                    const float* orr = Os + row * S + kk * 8 + t;
                    tf32x3::mma3(sc[n], ak, qr[0], qr[4]);
                    tf32x3::mma3(dp[n], av, orr[0], orr[4]);
                }
            }
            // element e: key 16m + g (+ 8 for e >= 2), row 2t (+ 1 for odd e)
#pragma unroll
            for (int n = 0; n < NA; ++n) {
                float p[4], ds[4];
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int kl = 16 * m + g + 8 * (e >> 1);
                    const int rl = (nbase + n) * 8 + 2 * t + (e & 1);
                    const float s = capped(sc[n][e] * scale, cap);
                    p[e] = ds[e] = 0.0f;
                    if (visible(qpos_s[rl], k0 + kl, tk, causal, window)) {
                        p[e] = expf(s - lse_s[rl]);
                        ds[e] = p[e] * (dp[n][e] - dsum_s[rl])
                                * cap_grad(s, cap);
                    }
                }
                const int off = (16 * m + g) * PS + (nbase + n) * 8 + 2 * t;
                store2(Ps + off, p[0], p[1]);
                store2(Ps + off + 8 * PS, p[2], p[3]);
                store2(Ds + off, ds[0], ds[1]);
                store2(Ds + off + 8 * PS, ds[2], ds[3]);
            }
        }
        __syncthreads();

        // phase B: dV += P^T dO, dK += dS^T Q over this step's rows; the k
        // index of step kk is permuted (slot t: row 2t, slot t + 4: 2t + 1)
        {
            const float* Pw = Ps + (16 * m + g) * PS + 2 * t;
            const float* Dw = Ds + (16 * m + g) * PS + 2 * t;
#pragma unroll
            for (int kk = 0; kk < BR / 8; ++kk) {
                const float2 p0 = load2(Pw + kk * 8);
                const float2 p1 = load2(Pw + 8 * PS + kk * 8);
                const float2 d0 = load2(Dw + kk * 8);
                const float2 d1 = load2(Dw + 8 * PS + kk * 8);
                FragA ap, ad;
                ap.set(p0.x, p1.x, p0.y, p1.y);
                ad.set(d0.x, d1.x, d0.y, d1.y);
                const float* orr = Os + (kk * 8 + 2 * t) * S + col0 + g;
                const float* qr = Qs + (kk * 8 + 2 * t) * S + col0 + g;
#pragma unroll
                for (int c = 0; c < NB; ++c) {
                    tf32x3::mma3(dva[c], ap, orr[c * 8], orr[S + c * 8]);
                    tf32x3::mma3(dka[c], ad, qr[c * 8], qr[S + c * 8]);
                }
            }
        }
    }
    tf32x3::cp_async_wait<0>();        // the K, V copies of an idle block

    const int64_t key0 = k0 + 16 * m + g, key1 = key0 + 8;
    if (key0 < tk) {
        const int64_t off = (((int64_t)rows.b * tk + key0) * kvh + rows.kh)
                            * HD + col0 + 2 * t;
#pragma unroll
        for (int c = 0; c < NB; ++c) {
            store2(dk + off + c * 8, dka[c][0] * scale, dka[c][1] * scale);
            store2(dv + off + c * 8, dva[c][0], dva[c][1]);
        }
    }
    if (key1 < tk) {
        const int64_t off = (((int64_t)rows.b * tk + key1) * kvh + rows.kh)
                            * HD + col0 + 2 * t;
#pragma unroll
        for (int c = 0; c < NB; ++c) {
            store2(dk + off + c * 8, dka[c][2] * scale, dka[c][3] * scale);
            store2(dv + off + c * 8, dva[c][2], dva[c][3]);
        }
    }
}

template <int HD>
__global__ void __launch_bounds__(32 * QW<HD>::value, 1)
flash_bwd_dq_kernel(const float* __restrict__ q,        // (B, Sq, H, HD)
                    const float* __restrict__ k,        // (B, Tk, KV, HD)
                    const float* __restrict__ v,        // (B, Tk, KV, HD)
                    const float* __restrict__ dout,     // (B, Sq, H, HD)
                    const float* __restrict__ lse,      // (B, Sq, H)
                    const float* __restrict__ dsum,     // (B, Sq, H)
                    float* __restrict__ dq,             // (B, Sq, H, HD)
                    int sq, int tk, int h, int kvh, float scale, int causal,
                    int window, float cap, int64_t q_offset) {
    constexpr int W = QW<HD>::value;
    constexpr int NTH = 32 * W, R = 16 * W;
    constexpr int S = HD + 4, NT = HD / 8;
    extern __shared__ float4 smem4[];
    float* Qs = reinterpret_cast<float*>(smem4);   // R x S
    float* Os = Qs + R * S;                        // R x S (dO)
    float* Ks = Os + R * S;                        // BK x S
    float* Vs = Ks + BK * S;                       // BK x S

    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int G = h / kvh;
    const Rows rows{sq, (int64_t)sq * G, (int)(blockIdx.y / kvh),
                    (int)(blockIdx.y % kvh), h, G};
    const int64_t r0 = (int64_t)(gridDim.x - 1 - blockIdx.x) * R;

    load_rows<HD>(Qs, q, rows, r0, R, tid, NTH);
    load_rows<HD>(Os, dout, rows, r0, R, tid, NTH);
    tf32x3::cp_async_commit();

    // the keys this block's rows can see (as the forward)
    const int64_t last = (r0 + R - 1 < rows.total ? r0 + R - 1
                                                   : rows.total - 1);
    const int64_t qpos_lo = q_offset + r0 / G, qpos_hi = q_offset + last / G;
    int64_t k_begin = 0, k_end = tk;
    if (causal && qpos_hi + 1 < k_end) k_end = qpos_hi + 1;
    if (window > 0 && qpos_lo - window + 1 > k_begin)
        k_begin = qpos_lo - window + 1;
    const int ntiles = k_end > k_begin ? (int)((k_end - k_begin + BK - 1) / BK)
                                       : 0;

    // the keys this warp's 16 rows can see
    const int64_t w_r0 = r0 + 16 * warp;
    const bool active = w_r0 < rows.total;
    const int64_t w_last = (w_r0 + 15 < rows.total ? w_r0 + 15
                                                    : rows.total - 1);
    const int64_t wq_lo = q_offset + w_r0 / G, wq_hi = q_offset + w_last / G;
    int64_t wk_begin = 0, wk_end = tk;
    if (causal && wq_hi + 1 < wk_end) wk_end = wq_hi + 1;
    if (window > 0 && wq_lo - window + 1 > wk_begin)
        wk_begin = wq_lo - window + 1;

    // this lane's two rows (g and g + 8)
    const int64_t rg0 = w_r0 + g, rg1 = w_r0 + g + 8;
    const bool ok0 = rg0 < rows.total, ok1 = rg1 < rows.total;
    const int64_t qpos0 = ok0 ? q_offset + rg0 / G : NO_ROW;
    const int64_t qpos1 = ok1 ? q_offset + rg1 / G : NO_ROW;
    const float lse0 = ok0 ? lse[rows.index(rg0)] : 0.0f;
    const float lse1 = ok1 ? lse[rows.index(rg1)] : 0.0f;
    const float dsum0 = ok0 ? dsum[rows.index(rg0)] : 0.0f;
    const float dsum1 = ok1 ? dsum[rows.index(rg1)] : 0.0f;

    float acc[NT][4];
#pragma unroll
    for (int c = 0; c < NT; ++c)
        acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.0f;
    const float* Qw = Qs + (16 * warp + g) * S + t;
    const float* Ow = Os + (16 * warp + g) * S + t;

    for (int it = 0; it < ntiles; ++it) {
        __syncthreads();                     // the last tile's reads done
        const int64_t kt0 = k_begin + (int64_t)it * BK;
        load_keys<HD>(Ks, k, rows.b, rows.kh, kvh, tk, kt0, BK, tid, NTH);
        load_keys<HD>(Vs, v, rows.b, rows.kh, kvh, tk, kt0, BK, tid, NTH);
        tf32x3::cp_async_commit();
        tf32x3::cp_async_wait<0>();
        __syncthreads();
        if (!(active && kt0 < wk_end && kt0 + BK > wk_begin)) continue;

        // S and dP, 16 rows x BK keys: n-tile n holds keys 8n .. 8n + 7
        float sc[BK / 8][4], dp[BK / 8][4];
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.0f;
#pragma unroll 2
        for (int kk = 0; kk < HD / 8; ++kk) {
            FragA aq, ao;
            aq.set(Qw[kk * 8], Qw[8 * S + kk * 8], Qw[kk * 8 + 4],
                   Qw[8 * S + kk * 8 + 4]);
            ao.set(Ow[kk * 8], Ow[8 * S + kk * 8], Ow[kk * 8 + 4],
                   Ow[8 * S + kk * 8 + 4]);
#pragma unroll
            for (int n = 0; n < BK / 8; ++n) {
                const float* kr = Ks + (n * 8 + g) * S + kk * 8 + t;
                const float* vr = Vs + (n * 8 + g) * S + kk * 8 + t;
                tf32x3::mma3(sc[n], aq, kr[0], kr[4]);
                tf32x3::mma3(dp[n], ao, vr[0], vr[4]);
            }
        }
        // dS in place of the scores; element e: row g (+ 8 for e >= 2),
        // key 8n + 2t (+ 1 for odd e)
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int64_t kp = kt0 + n * 8 + 2 * t + (e & 1);
                const bool lo = e < 2;
                const float s = capped(sc[n][e] * scale, cap);
                float ds = 0.0f;
                if (visible(lo ? qpos0 : qpos1, kp, tk, causal, window)) {
                    const float p = expf(s - (lo ? lse0 : lse1));
                    ds = p * (dp[n][e] - (lo ? dsum0 : dsum1))
                         * cap_grad(s, cap);
                }
                sc[n][e] = ds;
            }
        }
        // acc += dS K; the k index of step n is permuted: slot t is key
        // 8n + 2t, slot t + 4 key 8n + 2t + 1 (mma_tf32.cuh)
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
            FragA a;
            a.set(sc[n][0], sc[n][2], sc[n][1], sc[n][3]);
            const float* kr = Ks + (n * 8 + 2 * t) * S + g;
#pragma unroll
            for (int c = 0; c < NT; ++c)
                tf32x3::mma3(acc[c], a, kr[c * 8], kr[S + c * 8]);
        }
    }
    tf32x3::cp_async_wait<0>();        // the Q, dO copies of an idle block

    if (ok0) {
        float* o = dq + rows.index(rg0) * HD + 2 * t;
#pragma unroll
        for (int c = 0; c < NT; ++c)
            store2(o + c * 8, acc[c][0] * scale, acc[c][1] * scale);
    }
    if (ok1) {
        float* o = dq + rows.index(rg1) * HD + 2 * t;
#pragma unroll
        for (int c = 0; c < NT; ++c)
            store2(o + c * 8, acc[c][2] * scale, acc[c][3] * scale);
    }
}

template <int HD>
int launch(const float* q, const float* k, const float* v, const float* dout,
           const float* lse, const float* dsum, float* dq, float* dk,
           float* dv, int b, int sq, int tk, int h, int kvh, float scale,
           int causal, int window, float cap, int64_t q_offset,
           cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkdv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)dkdv_smem<HD>());
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)dq_smem<HD>());
    if (err != cudaSuccess) return (int)err;
    if (tk > 0) {
        const dim3 grid((unsigned)((tk + KV<HD>::BKV - 1) / KV<HD>::BKV),
                        (unsigned)(b * kvh));
        flash_bwd_dkdv_kernel<HD><<<grid, THREADS, dkdv_smem<HD>(), stream>>>(
            q, k, v, dout, lse, dsum, dk, dv, sq, tk, h, kvh, scale, causal,
            window, cap, q_offset);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    if (sq > 0) {
        constexpr int R = 16 * QW<HD>::value;
        const int64_t rows = (int64_t)sq * (h / kvh);
        const dim3 grid((unsigned)((rows + R - 1) / R), (unsigned)(b * kvh));
        flash_bwd_dq_kernel<HD><<<grid, 32 * QW<HD>::value, dq_smem<HD>(),
                                  stream>>>(
            q, k, v, dout, lse, dsum, dq, sq, tk, h, kvh, scale, causal,
            window, cap, q_offset);
    }
    return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). q, dout, dq (B, Sq, H, hd);
// k, v, dk, dv (B, Tk, KV, hd); lse, dsum (B, Sq, H); all float32,
// contiguous and 16-byte aligned; hd in {32, 64, 128, 256}; H % KV == 0.
// lse is the forward's (flash_attention_fwd_launch's lse output), dsum
// rowsum(dout * out). Launches two kernels on `stream`; returns 0 or the
// CUDA error.
extern "C" int flash_attention_bwd_launch(
        const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* dsum, void* dq, void* dk, void* dv,
        int b, int sq, int tk, int h, int kvh, int hd, float scale,
        int causal, int window, float cap, int64_t q_offset, void* stream) {
    if (b <= 0) return (int)cudaGetLastError();
    if (kvh <= 0 || h % kvh != 0) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const float *fq = (const float*)q, *fk = (const float*)k,
                *fv = (const float*)v, *fo = (const float*)dout,
                *fl = (const float*)lse, *fd = (const float*)dsum;
    float *gq = (float*)dq, *gk = (float*)dk, *gv = (float*)dv;
    switch (hd) {
        case 32: return launch<32>(fq, fk, fv, fo, fl, fd, gq, gk, gv, b, sq,
                                   tk, h, kvh, scale, causal, window, cap,
                                   q_offset, st);
        case 64: return launch<64>(fq, fk, fv, fo, fl, fd, gq, gk, gv, b, sq,
                                   tk, h, kvh, scale, causal, window, cap,
                                   q_offset, st);
        case 128: return launch<128>(fq, fk, fv, fo, fl, fd, gq, gk, gv, b,
                                     sq, tk, h, kvh, scale, causal, window,
                                     cap, q_offset, st);
        case 256: return launch<256>(fq, fk, fv, fo, fl, fd, gq, gk, gv, b,
                                     sq, tk, h, kvh, scale, causal, window,
                                     cap, q_offset, st);
        default: return (int)cudaErrorInvalidValue;
    }
}
