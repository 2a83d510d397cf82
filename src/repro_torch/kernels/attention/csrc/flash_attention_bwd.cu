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
// dS K): 10 * hd FLOP, and this kernel does exactly those five. At
// tinyllama-1.1b's training shape (B, S, H, KV, hd) = (4, 2048, 32, 4, 64),
// causal, that is ~1.7e11 FLOP per call: on an NVIDIA H100 (700 W) ~1.0 ms
// as three TF32 products each at the 495 TFLOP/s data-sheet peak, against
// ~0.1 ms for q, k, v, out, dO, lse in and dq, dk, dv out at 3.35 TB/s (the
// dq partials below add 570,425,344 bytes written and read back there,
// ~0.34 ms; 2.6 GB at gemma2-2b's hd-256 shapes, ~1.6 ms).
// With mma.sync at hd 64 a 3xTF32 product is cheap next to what feeds it,
// so the design is about issue slots and shared-memory bandwidth per mma.
//
// Design (deterministic: no atomics, every sum in a fixed order):
//  * one block of 8 warps per (batch x KV head, tile of BKV keys); K and V
//    of the tile stay in shared memory, and a loop walks the tiles of BR
//    rows that the causal and window limits let see the tile. Per row tile
//    (phase A) the block computes S^T = K Q^T and dP^T = V dO^T, turns them
//    into P^T and dS^T in registers and stores both in shared memory; then
//    (phase C) dV += P^T dO and dK += dS^T Q accumulate in registers, and
//    dQ_part = dS K, with dS read back from the dS^T tile as the A operand,
//    goes to a float32 scratch, one slice per key tile. So each product
//    runs once per visible pair: five, not the seven of a separate dq pass
//    that recomputes S and dP;
//  * a second kernel sums each row's dq partials over its key tiles in
//    ascending key-tile order and scales them: two calls on the same
//    tensors give the same bits. The scratch holds, per (batch x KV head,
//    key tile), the rows that can see that tile, at a stride of the longest
//    such range: B * KV * ceil(T / BKV) rows x hd floats for causal global
//    attention, less with a window. At (4, 2048, 32, 4, 64) causal:
//    1,073,741,824 bytes; at gemma2-2b's (1, 4500, 8, 4, 256), window 4096
//    / global: 4,766,982,144 / 5,197,824,000 bytes. As that grows with S^2,
//    the wrapper allocates (torch.empty) at most a budget, or one key
//    tile's partials where they take more (scratch_floats), and the
//    launcher runs the key tiles in chunks that fit it, each at the stride
//    of its own longest range (chunk): per chunk the main kernel, then the
//    reduction, which adds the chunk's partials to the rows' sums, kept
//    unscaled in dq between chunks. Every chunking gives the same bits;
//  * operands split once: Q and dO of a row tile are split into TF32
//    hi / lo planes in shared memory once, by the threads that copy them,
//    so every product reads them split (FragB::load). K and V (their planes
//    would need 69,632 bytes more at hd 64, past the limit) and P^T / dS^T
//    are split where a warp reads them, each split feeding the warp's whole
//    tile: at hd 64 the tiles are BKV x BR = 128 x 64 and each warp holds
//    32 x 32 of S^T / dP^T and of dK / dV (an A fragment feeds four
//    n-tiles, a B fragment two m-tiles) and 16 x 32 of dQ_part. Splitting
//    Q and dO at every use instead (from a cp.async ring, same tiles)
//    timed the same within 0.2% on an H100 (PERF.md): the planes trade
//    the splits' issue slots for twice the shared-memory reads;
//  * loads overlap compute: Q and dO of row tile r + 1 are loaded into
//    registers while tile r's dQ_part, dK and dV products run and split
//    into the planes after them; lse, D and the rows' positions of tile
//    r + 1 go through a two-stage cp.async ring. Per row tile one wait and
//    three barriers;
//  * masks only where they apply: a row tile wholly inside the causal and
//    window limits (and the keys) skips the per-element test; elsewhere the
//    test is int32 (each row's position relative to the tile's first key,
//    clamped to int32, computed once per row tile in the copy step);
//  * P = 2^((s - lse) log2 e) by ex2.approx.ftz in place of expf(s - lse):
//    the two roundings before it add a relative error of at most 2^-23
//    |s - lse| to P (under 2e-6 for every P above 2^-20), beside ex2's
//    2 ulp (as exp2f's, CUDA math documentation); a P below 2^-126 flushes
//    to 0, where it adds nothing at float32 precision to sums over a row
//    whose P add up to 1. Within the tests' float32 gradient tolerance
//    (rtol 1e-3, atol 1e-4). Softcap before the masks, accurate tanhf,
//    no --use_fast_math, float32 throughout, as the forward;
//  * bank-conflict-free shared memory: K, V rows and the Q, dO planes'
//    rows padded to hd + 4 floats, P^T and dS^T rows to BR + 8, and dS^T's
//    columns XOR-swizzled by bit 2 of the key (swz) so that both its
//    row-wise (dK) and its column-wise (dQ) fragment reads hit 32
//    distinct banks;
//  * tiles per head dim (Tile): 128 x 64 at hd 32 and 64, 64 x 32 at
//    hd 128, 32 x 32 at hd 256; shared memory 148,992 / 214,528 / 156,416
//    / 210,688 bytes, under the 232,448 a block may use: one block per SM.
//    Key tiles go to blockIdx.y, so the first blocks to start are those of
//    the first key tile, which causal rows see most.
// bfloat16 inputs have a backward of their own on the bf16 tensor cores,
// with no dq partials: flash_attention_bwd_bf16.cu.
// Row math is int32 within one (batch, KV head): Sq * H must stay below
// 2^31 (the launcher refuses more).
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

using io::load4;
using io::store2;
using io::store4;
using tf32x3::FragA;

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr float LOG2E = 1.4426950408889634f;
// a padding row's position relative to a key: no key is causally visible
constexpr int NO_ROW = INT_MIN + 256;

// Tiles per head dim: BKV keys per block, BR rows per step, and the warp
// grids (8 warps) of phase A (AK warps along keys x 8 / AK along rows), of
// dK / dV (CK along keys x 8 / CK along columns) and of dQ_part (QR along
// rows x 8 / QR along columns)
template <int HD> struct Tile;
template <> struct Tile<32> {
    static constexpr int BKV = 128, BR = 64, AK = 4, CK = 4, QR = 2;
};
template <> struct Tile<64> {
    static constexpr int BKV = 128, BR = 64, AK = 4, CK = 4, QR = 4;
};
template <> struct Tile<128> {
    static constexpr int BKV = 64, BR = 32, AK = 4, CK = 2, QR = 1;
};
template <> struct Tile<256> {
    static constexpr int BKV = 32, BR = 32, AK = 2, CK = 1, QR = 1;
};

template <int HD>
constexpr size_t smem_bytes() {
    constexpr int BKV = Tile<HD>::BKV, BR = Tile<HD>::BR;
    return sizeof(float) * ((size_t)2 * BKV * (HD + 4)     // K, V
                            + (size_t)4 * BR * (HD + 4)    // Q, dO planes
                            + (size_t)2 * BKV * (BR + 8)   // P^T, dS^T
                            + (size_t)6 * BR);             // lse, D, rel x 2
}

// B operand of one m16n8k8 step, split once for every m-tile it feeds
// (set), or read split from hi / lo planes at offsets o0, o1 (load)
struct FragB {
    uint32_t hi[2], lo[2];
    __device__ __forceinline__ void set(float b0, float b1) {
        tf32x3::split(b0, hi[0], lo[0]);
        tf32x3::split(b1, hi[1], lo[1]);
    }
    __device__ __forceinline__ void load(const uint32_t* h, const uint32_t* l,
                                         int o0, int o1) {
        hi[0] = h[o0];
        hi[1] = h[o1];
        lo[0] = l[o0];
        lo[1] = l[o1];
    }
};

// d += a * b in float32 accuracy, both operands split: small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
    tf32x3::mma(d, a.lo, b.hi[0], b.hi[1]);
    tf32x3::mma(d, a.hi, b.lo[0], b.lo[1]);
    tf32x3::mma(d, a.hi, b.hi[0], b.hi[1]);
}

// 4-byte asynchronous copy global -> shared; copies `valid` bytes (0 or 4)
// and fills the rest with zeros
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int valid) {
    const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
                 :: "r"(s), "l"(gmem), "r"(valid) : "memory");
}

// 2^x (ex2.approx.ftz: 2 ulp as exp2f, a result below 2^-126 flushed to 0)
__device__ __forceinline__ float exp2_ftz(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ float2 load2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
}

// key kl of a tile against a row at position key0 + rel (rel: the row's
// position relative to the tile's first key); kmax = keys in the tile
__device__ __forceinline__ bool visible(int rel, int kl, int kmax,
                                        int causal, int window) {
    bool ok = kl < kmax;
    if (causal) ok = ok && rel >= kl;
    if (window > 0) ok = ok && rel - kl < window;
    return ok;
}

// a position difference clamped to int32: visible() stays exact, since a
// key index in a tile is below 256 and a window below INT_MAX - 256
__device__ __forceinline__ int rel32(int64_t d) {
    return d > INT_MAX ? INT_MAX : (d < NO_ROW ? NO_ROW : (int)d);
}

// the query positions [s_begin, s_end) that see a key of the tile
// [k0, k_last]
__host__ __device__ __forceinline__ void key_tile_rows(
        int64_t k0, int64_t k_last, int sq, int causal, int window,
        int64_t q_offset, int64_t& s_begin, int64_t& s_end) {
    s_begin = 0;
    s_end = sq;
    if (causal && k0 - q_offset > s_begin) s_begin = k0 - q_offset;
    if (window > 0 && k_last + window - q_offset < s_end)
        s_end = k_last + window - q_offset;
    if (s_end < s_begin) s_end = s_begin;
}

// x = hi + lo per component (tf32x3::split), into 16-byte hi and lo
__device__ __forceinline__ void split4(float4 x, uint32_t* hi, uint32_t* lo) {
    uint4 h, l;
    tf32x3::split(x.x, h.x, l.x);
    tf32x3::split(x.y, h.y, l.y);
    tf32x3::split(x.z, h.z, l.z);
    tf32x3::split(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(hi) = h;
    *reinterpret_cast<uint4*>(lo) = l;
}

// XOR swizzle of a P^T / dS^T column (row of the row tile) by bit 2 of
// the key: keeps the float2 pairs (2t, 2t + 1) together
__device__ __forceinline__ int swz(int key, int row) {
    return row ^ (((key >> 2) & 1) << 3);
}

// P^T and dS^T of one warp's phase-A tile (MA x 16 keys from kw0, NA x 8
// rows from rw0; element e of a fragment: key + 8 for e >= 2, row + 1 for
// odd e) into Ps and Ds (row stride PS). CAP: softcap on; MASK: test each
// element (a row tile that straddles a limit). lse, dsum, rel: this row
// tile's stage.
template <bool CAP, bool MASK, int MA, int NA>
__device__ __forceinline__ void p_ds(
        const float (&sc)[MA][NA][4], const float (&dp)[MA][NA][4],
        float* Ps, float* Ds, int PS, const float* lse, const float* dsum,
        const int* rel, int kw0, int rw0, int g, int t, float scale,
        float cap, int kmax, int causal, int window) {
#pragma unroll
    for (int ni = 0; ni < NA; ++ni) {
        const int rl = rw0 + 8 * ni + 2 * t;
        const float2 l2 = load2(lse + rl), d2 = load2(dsum + rl);
        const int2 r2 = *reinterpret_cast<const int2*>(rel + rl);
#pragma unroll
        for (int mi = 0; mi < MA; ++mi) {
            float p[4], ds[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const bool odd = e & 1;
                float s = sc[mi][ni][e] * scale;
                if (CAP) s = cap * tanhf(s / cap);
                p[e] = exp2_ftz((s - (odd ? l2.y : l2.x)) * LOG2E);
                ds[e] = p[e] * (dp[mi][ni][e] - (odd ? d2.y : d2.x));
                if (CAP) {
                    const float u = s / cap;
                    ds[e] *= 1.0f - u * u;
                }
                if (MASK && !visible(odd ? r2.y : r2.x,
                                     kw0 + 16 * mi + g + 8 * (e >> 1), kmax,
                                     causal, window))
                    p[e] = ds[e] = 0.0f;
            }
            const int ka = kw0 + 16 * mi + g;
            store2(Ps + ka * PS + swz(ka, rl), p[0], p[1]);
            store2(Ps + (ka + 8) * PS + swz(ka + 8, rl), p[2], p[3]);
            store2(Ds + ka * PS + swz(ka, rl), ds[0], ds[1]);
            store2(Ds + (ka + 8) * PS + swz(ka + 8, rl), ds[2], ds[3]);
        }
    }
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

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_kernel(const float* __restrict__ q,       // (B, Sq, H, HD)
                 const float* __restrict__ k,       // (B, Tk, KV, HD)
                 const float* __restrict__ v,       // (B, Tk, KV, HD)
                 const float* __restrict__ dout,    // (B, Sq, H, HD)
                 const float* __restrict__ lse,     // (B, Sq, H)
                 const float* __restrict__ dsum,    // (B, Sq, H)
                 float* __restrict__ dk,            // (B, Tk, KV, HD)
                 float* __restrict__ dv,            // (B, Tk, KV, HD)
                 float* __restrict__ dq_part,       // scratch, see top
                 int sq, int tk, int h, int kvh, float scale, int causal,
                 int window, float cap, int64_t q_offset, int kt0,
                 int64_t seg_rows) {
    using TL = Tile<HD>;
    constexpr int BKV = TL::BKV, BR = TL::BR;
    constexpr int S = HD + 4, PS = BR + 8;
    constexpr int AR = WARPS / TL::AK, CH = WARPS / TL::CK;
    constexpr int QH = WARPS / TL::QR;
    constexpr int MA = BKV / 16 / TL::AK, NA = BR / 8 / AR;
    constexpr int MC = BKV / 16 / TL::CK, NC = HD / 8 / CH;
    constexpr int MQ = BR / 16 / TL::QR, NQ = HD / 8 / QH;
    static_assert(MA * 16 * TL::AK == BKV && NA * 8 * AR == BR, "phase A");
    static_assert(MC * 16 * TL::CK == BKV && NC * 8 * CH == HD, "dK, dV");
    static_assert(MQ * 16 * TL::QR == BR && NQ * 8 * QH == HD, "dQ");
    static_assert(BR <= THREADS && BR % 16 == 0, "row tile");
    extern __shared__ float4 smem4[];
    float* Ks = reinterpret_cast<float*>(smem4);   // BKV x S
    float* Vs = Ks + BKV * S;                      // BKV x S
    // Q and dO of the row tile as TF32 hi / lo planes, BR x S each
    uint32_t* Qhi = reinterpret_cast<uint32_t*>(Vs + BKV * S);
    uint32_t* Qlo = Qhi + BR * S;
    uint32_t* Ohi = Qlo + BR * S;
    uint32_t* Olo = Ohi + BR * S;
    float* Ps = reinterpret_cast<float*>(Olo + BR * S);   // BKV x PS (P^T)
    float* Ds = Ps + BKV * PS;                     // BKV x PS (dS^T)
    float* lse_s = Ds + BKV * PS;                  // 2 x BR
    float* dsum_s = lse_s + 2 * BR;                // 2 x BR
    int* rel_s = reinterpret_cast<int*>(dsum_s + 2 * BR);   // 2 x BR

    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int G = h / kvh;
    const int bh = blockIdx.x, kt = kt0 + (int)blockIdx.y;
    const int b = bh / kvh, kh = bh % kvh;
    const Rows rows{sq * G, G, h, (int64_t)b * sq * h + (int64_t)kh * G};
    const int k0 = kt * BKV;
    const int kmax = tk - k0 < BKV ? tk - k0 : BKV;   // keys in the tile

    for (int idx = tid; idx < BKV * HD / 4; idx += THREADS) {
        const int j = idx / (HD / 4), d = (idx % (HD / 4)) * 4;
        const bool ok = j < kmax;
        const int64_t off = ok ? (((int64_t)b * tk + k0 + j) * kvh + kh) * HD
                                 + d : 0;
        tf32x3::cp_async16(Ks + j * S + d, k + off, ok ? 16 : 0);
        tf32x3::cp_async16(Vs + j * S + d, v + off, ok ? 16 : 0);
    }
    tf32x3::cp_async_commit();

    int64_t s_begin, s_end;
    key_tile_rows(k0, k0 + kmax - 1, sq, causal, window, q_offset, s_begin,
                  s_end);
    const int r_begin = (int)(s_begin * G), r_end = (int)(s_end * G);
    const int nsteps = (r_end - r_begin + BR - 1) / BR;
    // this key tile's slice of the dq partials: row r at (r - r_begin) * HD
    float* part = dq_part + ((int64_t)bh * gridDim.y + blockIdx.y) * seg_rows
                            * HD;

    // lse, D and each row's position relative to k0 of row tile r0 into
    // stage st (cp.async, one commit group)
    auto issue = [&](int r0, int st) {
        if (tid < BR) {
            const int r = r0 + tid;
            const bool ok = r < rows.total;
            const int64_t idx = ok ? rows.index(r) : 0;
            cp_async4(lse_s + st * BR + tid, lse + idx, ok ? 4 : 0);
            cp_async4(dsum_s + st * BR + tid, dsum + idx, ok ? 4 : 0);
            rel_s[st * BR + tid] = ok ? rel32(q_offset + r / G - k0) : NO_ROW;
        }
        tf32x3::cp_async_commit();
    };
    // Q and dO of row tile r0 into registers (fetch: in flight while the
    // block computes), then split once into the planes (planes)
    constexpr int NLD = BR * HD / 4 / THREADS;      // float4s per thread
    static_assert(NLD * 4 * THREADS == BR * HD, "row tile copy");
    float4 rq[NLD], ro[NLD];
    auto fetch = [&](int r0) {
#pragma unroll
        for (int j = 0; j < NLD; ++j) {
            const int idx = tid + j * THREADS;
            const int i = idx / (HD / 4), d = (idx % (HD / 4)) * 4;
            const bool ok = r0 + i < rows.total;
            const int64_t off = ok ? rows.index(r0 + i) * HD + d : 0;
            const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            rq[j] = ok ? load4(q + off) : zero;
            ro[j] = ok ? load4(dout + off) : zero;
        }
    };
    auto planes = [&]() {
#pragma unroll
        for (int j = 0; j < NLD; ++j) {
            const int idx = tid + j * THREADS;
            const int o = idx / (HD / 4) * S + (idx % (HD / 4)) * 4;
            split4(rq[j], Qhi + o, Qlo + o);
            split4(ro[j], Ohi + o, Olo + o);
        }
    };

    float dka[MC][NC][4], dva[MC][NC][4];
#pragma unroll
    for (int mi = 0; mi < MC; ++mi)
#pragma unroll
        for (int ni = 0; ni < NC; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) dka[mi][ni][e] = dva[mi][ni][e] = 0.0f;

    if (nsteps > 0) {
        issue(r_begin, 0);
        fetch(r_begin);
        planes();
    }
    // per row tile: one wait and three barriers (the last step: two)
    for (int it = 0; it < nsteps; ++it) {
        const int r0 = r_begin + it * BR, st = it & 1;
        tf32x3::cp_async_wait<0>();    // stage st (and K, V) landed
        __syncthreads();               // ... and the planes written, for
                                       // every thread
        if (it + 1 < nsteps) issue(r0 + BR, st ^ 1);

        // phase A: S^T, dP^T for this warp's MA x 16 keys x NA x 8 rows
        {
            const int kw0 = (warp % TL::AK) * MA * 16;
            const int rw0 = (warp / TL::AK) * NA * 8;
            float sc[MA][NA][4], dp[MA][NA][4];
#pragma unroll
            for (int mi = 0; mi < MA; ++mi)
#pragma unroll
                for (int ni = 0; ni < NA; ++ni)
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        sc[mi][ni][e] = dp[mi][ni][e] = 0.0f;
#pragma unroll
            for (int kk = 0; kk < HD / 8; ++kk) {
                FragA ak[MA], av[MA];
#pragma unroll
                for (int mi = 0; mi < MA; ++mi) {
                    const int o = (kw0 + 16 * mi + g) * S + kk * 8 + t;
                    const float* kr = Ks + o;
                    const float* vr = Vs + o;
                    ak[mi].set(kr[0], kr[8 * S], kr[4], kr[8 * S + 4]);
                    av[mi].set(vr[0], vr[8 * S], vr[4], vr[8 * S + 4]);
                }
#pragma unroll
                for (int ni = 0; ni < NA; ++ni) {
                    const int o = (rw0 + 8 * ni + g) * S + kk * 8 + t;
                    FragB bq, bo;
                    bq.load(Qhi, Qlo, o, o + 4);
                    bo.load(Ohi, Olo, o, o + 4);
#pragma unroll
                    for (int mi = 0; mi < MA; ++mi) {
                        mma3(sc[mi][ni], ak[mi], bq);
                        mma3(dp[mi][ni], av[mi], bo);
                    }
                }
            }
            // P^T and dS^T: the mask test only where the row tile
            // straddles a limit (or the keys end inside the tile)
            const int r_last = (r0 + BR < rows.total ? r0 + BR
                                                     : rows.total) - 1;
            const int64_t q_lo = q_offset + r0 / G;
            const int64_t q_hi = q_offset + r_last / G;
            const bool full = kmax == BKV &&
                              (!causal || k0 + BKV - 1 <= q_lo) &&
                              (window <= 0 || q_hi - k0 < window);
#define P_DS(CAP, MASK)                                                    \
    p_ds<CAP, MASK>(sc, dp, Ps, Ds, PS, lse_s + st * BR, dsum_s + st * BR, \
                    rel_s + st * BR, kw0, rw0, g, t, scale, cap, kmax,     \
                    causal, window)
            if (cap != 0.0f) {
                if (full) P_DS(true, false);
                else P_DS(true, true);
            } else {
                if (full) P_DS(false, false);
                else P_DS(false, true);
            }
#undef P_DS
        }
        __syncthreads();
        if (it + 1 < nsteps) fetch(r0 + BR);   // in flight through phase C

        // dQ_part = dS K for this warp's MQ x 16 rows x NQ x 8 columns; the
        // k index of step kk is permuted (slot t: key 2t, slot t + 4: key
        // 2t + 1), dS read from the dS^T tile
        {
            const int rq0 = (warp % TL::QR) * MQ * 16;
            const int hq0 = (warp / TL::QR) * NQ * 8;
            float acc[MQ][NQ][4];
#pragma unroll
            for (int mi = 0; mi < MQ; ++mi)
#pragma unroll
                for (int ni = 0; ni < NQ; ++ni)
#pragma unroll
                    for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;
#pragma unroll
            for (int kk = 0; kk < BKV / 8; ++kk) {
                const int ka = kk * 8 + 2 * t;
                const float* d0 = Ds + ka * PS;
                const float* d1 = d0 + PS;
                FragA a[MQ];
#pragma unroll
                for (int mi = 0; mi < MQ; ++mi) {
                    const int m = rq0 + 16 * mi + g;
                    a[mi].set(d0[swz(ka, m)], d0[swz(ka, m + 8)],
                              d1[swz(ka, m)], d1[swz(ka, m + 8)]);
                }
#pragma unroll
                for (int ni = 0; ni < NQ; ++ni) {
                    const float* kr = Ks + ka * S + hq0 + 8 * ni + g;
                    FragB bk;
                    bk.set(kr[0], kr[S]);
#pragma unroll
                    for (int mi = 0; mi < MQ; ++mi)
                        mma3(acc[mi][ni], a[mi], bk);
                }
            }
#pragma unroll
            for (int mi = 0; mi < MQ; ++mi) {
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int r = r0 + rq0 + 16 * mi + g + 8 * half;
                    if (r >= r_end) continue;
                    float* o = part + (int64_t)(r - r_begin) * HD + hq0
                               + 2 * t;
#pragma unroll
                    for (int ni = 0; ni < NQ; ++ni)
                        store2(o + 8 * ni, acc[mi][ni][2 * half],
                               acc[mi][ni][2 * half + 1]);
                }
            }
        }

        // dV += P^T dO, dK += dS^T Q over this step's rows for this warp's
        // MC x 16 keys x NC x 8 columns; the k index of step kk is permuted
        // (slot t: row 2t, slot t + 4: row 2t + 1)
        {
            const int kc0 = (warp % TL::CK) * MC * 16;
            const int hc0 = (warp / TL::CK) * NC * 8;
#pragma unroll
            for (int kk = 0; kk < BR / 8; ++kk) {
                const int rr = kk * 8 + 2 * t;
                FragA ap[MC], ad[MC];
#pragma unroll
                for (int mi = 0; mi < MC; ++mi) {
                    const int ka = kc0 + 16 * mi + g;
                    const int o0 = ka * PS + swz(ka, rr);
                    const int o1 = (ka + 8) * PS + swz(ka + 8, rr);
                    const float2 p0 = load2(Ps + o0), p1 = load2(Ps + o1);
                    const float2 d0 = load2(Ds + o0), d1 = load2(Ds + o1);
                    ap[mi].set(p0.x, p1.x, p0.y, p1.y);
                    ad[mi].set(d0.x, d1.x, d0.y, d1.y);
                }
#pragma unroll
                for (int ni = 0; ni < NC; ++ni) {
                    const int o = rr * S + hc0 + 8 * ni + g;
                    FragB bo, bq;
                    bo.load(Ohi, Olo, o, o + S);
                    bq.load(Qhi, Qlo, o, o + S);
#pragma unroll
                    for (int mi = 0; mi < MC; ++mi) {
                        mma3(dva[mi][ni], ap[mi], bo);
                        mma3(dka[mi][ni], ad[mi], bq);
                    }
                }
            }
        }
        if (it + 1 < nsteps) {
            __syncthreads();           // every read of this tile's planes done
            planes();
        }
    }
    tf32x3::cp_async_wait<0>();        // the K, V copies of an idle block

    const int kc0 = (warp % TL::CK) * MC * 16;
    const int hc0 = (warp / TL::CK) * NC * 8;
#pragma unroll
    for (int mi = 0; mi < MC; ++mi) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int kl = kc0 + 16 * mi + g + 8 * half;
            if (kl >= kmax) continue;
            const int64_t off = (((int64_t)b * tk + k0 + kl) * kvh + kh) * HD
                                + hc0 + 2 * t;
#pragma unroll
            for (int ni = 0; ni < NC; ++ni) {
                store2(dk + off + 8 * ni, dka[mi][ni][2 * half] * scale,
                       dka[mi][ni][2 * half + 1] * scale);
                store2(dv + off + 8 * ni, dva[mi][ni][2 * half],
                       dva[mi][ni][2 * half + 1]);
            }
        }
    }
}

// dq = scale * sum over the key tiles that row r sees of its partials, in
// ascending key-tile order, one launch per chunk of key tiles [kt0, kt1)
// (see launch): the running sum is kept unscaled in dq between chunks,
// and the last chunk writes it scaled, so every chunking gives the same
// bits. One float4 of a row per thread
template <int HD>
__global__ void __launch_bounds__(256)
flash_bwd_dq_reduce_kernel(const float* __restrict__ dq_part,
                           float* dq,               // (B, Sq, H, HD)
                           int sq, int tk, int h, int kvh, float scale,
                           int causal, int window, int64_t q_offset, int kt0,
                           int kt1, int64_t seg_rows) {
    constexpr int BKV = Tile<HD>::BKV, C4 = HD / 4;
    const int G = h / kvh;
    const int bh = blockIdx.y, b = bh / kvh, kh = bh % kvh;
    const Rows rows{sq * G, G, h, (int64_t)b * sq * h + (int64_t)kh * G};
    const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= (int64_t)rows.total * C4) return;
    const int r = (int)(idx / C4), c = (int)(idx % C4) * 4;
    const int64_t qpos = q_offset + r / G;
    const int64_t at = rows.index(r) * HD + c;
    // the key tiles of this chunk that row r sees
    int64_t k_lo = 0, k_hi = (int64_t)tk - 1;
    if (causal && qpos < k_hi) k_hi = qpos;
    if (window > 0 && qpos - window + 1 > k_lo) k_lo = qpos - window + 1;
    const int kt_lo = k_lo / BKV > kt0 ? (int)(k_lo / BKV) : kt0;
    const int kt_hi = k_hi < 0 ? -1
                      : (k_hi / BKV < kt1 - 1 ? (int)(k_hi / BKV) : kt1 - 1);
    float4 acc = kt0 == 0 ? make_float4(0.0f, 0.0f, 0.0f, 0.0f)
                          : load4(dq + at);
    if (k_lo <= k_hi) {
#pragma unroll 4
        for (int kt = kt_lo; kt <= kt_hi; ++kt) {
            int64_t s_begin, s_end;
            const int64_t k0 = (int64_t)kt * BKV;
            const int64_t k_last = k0 + BKV < tk ? k0 + BKV - 1 : tk - 1;
            key_tile_rows(k0, k_last, sq, causal, window, q_offset, s_begin,
                          s_end);
            const float4 p = *reinterpret_cast<const float4*>(
                dq_part + (((int64_t)bh * (kt1 - kt0) + kt - kt0) * seg_rows
                           + (r - s_begin * G)) * HD + c);
            acc.x += p.x;
            acc.y += p.y;
            acc.z += p.z;
            acc.w += p.w;
        }
    }
    if ((int64_t)kt1 * BKV >= tk)   // the last chunk
        store4(dq + at, make_float4(acc.x * scale, acc.y * scale,
                                    acc.z * scale, acc.w * scale));
    else
        store4(dq + at, acc);
}

// rows (query position x query head of one KV head) that see key tile kt
template <int HD>
int64_t tile_rows(int kt, int sq, int tk, int G, int causal, int window,
                  int64_t q_offset) {
    constexpr int BKV = Tile<HD>::BKV;
    const int64_t k0 = (int64_t)kt * BKV;
    const int64_t k_last = k0 + BKV < tk ? k0 + BKV - 1 : tk - 1;
    int64_t s_begin, s_end;
    key_tile_rows(k0, k_last, sq, causal, window, q_offset, s_begin, s_end);
    return (s_end - s_begin) * G;
}

// The key tiles [kt0, kt1) of one launch and its scratch rows per key tile
// (seg_rows, the longest of their row ranges): as many tiles from kt0 as
// fit in part_floats floats, and at least one
template <int HD>
void chunk(int b, int sq, int tk, int h, int kvh, int causal, int window,
           int64_t q_offset, int kt0, int64_t part_floats, int& kt1,
           int64_t& seg_rows) {
    const int nkt = (tk + Tile<HD>::BKV - 1) / Tile<HD>::BKV;
    const int64_t per_tile_row = (int64_t)b * kvh * HD;
    seg_rows = 0;
    for (kt1 = kt0; kt1 < nkt; ++kt1) {
        int64_t n = tile_rows<HD>(kt1, sq, tk, h / kvh, causal, window,
                                  q_offset);
        if (n < seg_rows) n = seg_rows;
        if (kt1 > kt0 && (kt1 - kt0 + 1) * n > part_floats / per_tile_row)
            break;
        seg_rows = n;
    }
}

// Floats of scratch for a budget of `budget` floats: all key tiles' partials
// at the stride of the longest row range, where that fits the budget; else
// the budget, but never less than the largest single key tile needs
template <int HD>
int64_t scratch_floats(int b, int sq, int tk, int h, int kvh, int causal,
                       int window, int64_t q_offset, int64_t budget) {
    const int nkt = (tk + Tile<HD>::BKV - 1) / Tile<HD>::BKV;
    int64_t longest = 0;
    for (int kt = 0; kt < nkt; ++kt) {
        const int64_t n = tile_rows<HD>(kt, sq, tk, h / kvh, causal, window,
                                        q_offset);
        if (n > longest) longest = n;
    }
    const int64_t one = (int64_t)b * kvh * longest * HD;
    const int64_t all = one * nkt;
    return all <= budget ? all : (one > budget ? one : budget);
}

// Key tiles in chunks that fit the scratch (one chunk where it holds all):
// per chunk, the main kernel writes the chunk's dq partials and the reduce
// kernel adds them to the rows' running sums (in dq)
template <int HD>
int launch(const float* q, const float* k, const float* v, const float* dout,
           const float* lse, const float* dsum, float* dq, float* dk,
           float* dv, float* dq_part, int64_t part_floats, int b, int sq,
           int tk, int h, int kvh, float scale, int causal, int window,
           float cap, int64_t q_offset, cudaStream_t stream) {
    const int nkt = (tk + Tile<HD>::BKV - 1) / Tile<HD>::BKV;
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes<HD>());
    if (err != cudaSuccess) return (int)err;
    int kt0 = 0;
    do {
        int kt1;
        int64_t seg_rows;
        chunk<HD>(b, sq, tk, h, kvh, causal, window, q_offset, kt0,
                  part_floats, kt1, seg_rows);
        if ((int64_t)b * kvh * (kt1 - kt0) * seg_rows * HD > part_floats)
            return (int)cudaErrorInvalidValue;   // scratch below one tile's
        if (kt1 > kt0) {
            const dim3 grid((unsigned)(b * kvh), (unsigned)(kt1 - kt0));
            flash_bwd_kernel<HD>
                <<<grid, THREADS, smem_bytes<HD>(), stream>>>(
                    q, k, v, dout, lse, dsum, dk, dv, dq_part, sq, tk, h, kvh,
                    scale, causal, window, cap, q_offset, kt0, seg_rows);
            const cudaError_t e = cudaGetLastError();
            if (e != cudaSuccess) return (int)e;
        }
        if (sq > 0) {
            const int64_t n4 = (int64_t)sq * (h / kvh) * (HD / 4);
            const dim3 grid((unsigned)((n4 + 255) / 256), (unsigned)(b * kvh));
            flash_bwd_dq_reduce_kernel<HD><<<grid, 256, 0, stream>>>(
                dq_part, dq, sq, tk, h, kvh, scale, causal, window, q_offset,
                kt0, kt1, seg_rows);
            const cudaError_t e = cudaGetLastError();
            if (e != cudaSuccess) return (int)e;
        }
        kt0 = kt1;
    } while (kt0 < nkt);
    return 0;
}

bool takes(int sq, int tk, int h, int kvh) {
    return kvh > 0 && h % kvh == 0 && sq >= 0 && tk >= 0 &&
           (int64_t)sq * h < INT_MAX;
}

}  // namespace

// Float32 count of the dq partials' scratch for flash_attention_bwd_launch
// at these arguments and a budget of `budget` floats (see scratch_floats;
// 0 where there is no key), or -1 where it does not take them.
extern "C" int64_t flash_attention_bwd_scratch_floats(
        int b, int sq, int tk, int h, int kvh, int hd, int causal, int window,
        int64_t q_offset, int64_t budget) {
    if (b < 0 || !takes(sq, tk, h, kvh)) return -1;
    switch (hd) {
        case 32: return scratch_floats<32>(b, sq, tk, h, kvh, causal, window,
                                           q_offset, budget);
        case 64: return scratch_floats<64>(b, sq, tk, h, kvh, causal, window,
                                           q_offset, budget);
        case 128: return scratch_floats<128>(b, sq, tk, h, kvh, causal,
                                             window, q_offset, budget);
        case 256: return scratch_floats<256>(b, sq, tk, h, kvh, causal,
                                             window, q_offset, budget);
        default: return -1;
    }
}

// Plain C entry point (loaded with ctypes). q, dout, dq (B, Sq, H, hd);
// k, v, dk, dv (B, Tk, KV, hd), all float32; lse, dsum (B, Sq, H) float32;
// all contiguous and 16-byte aligned; hd in {32, 64, 128, 256}; H % KV ==
// 0; Sq * H below 2^31. lse is the forward's (flash_attention_fwd_launch's
// lse output), dsum rowsum(dout * out); dq_part a float32 scratch of
// part_floats floats, 16-byte aligned, at least what
// flash_attention_bwd_scratch_floats gives for a budget of 0. Launches two
// kernels on `stream` per chunk of key tiles that fits the scratch;
// returns 0 or the CUDA error.
extern "C" int flash_attention_bwd_launch(
        const float* q, const float* k, const float* v, const float* dout,
        const float* lse, const float* dsum, float* dq, float* dk, float* dv,
        float* dq_part, int64_t part_floats, int b, int sq, int tk, int h,
        int kvh, int hd, float scale, int causal, int window, float cap,
        int64_t q_offset, void* stream) {
    if (b <= 0) return (int)cudaGetLastError();
    if (!takes(sq, tk, h, kvh)) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    switch (hd) {
        case 32: return launch<32>(q, k, v, dout, lse, dsum, dq, dk, dv,
                                   dq_part, part_floats, b, sq, tk, h, kvh,
                                   scale, causal, window, cap, q_offset, st);
        case 64: return launch<64>(q, k, v, dout, lse, dsum, dq, dk, dv,
                                   dq_part, part_floats, b, sq, tk, h, kvh,
                                   scale, causal, window, cap, q_offset, st);
        case 128: return launch<128>(q, k, v, dout, lse, dsum, dq, dk, dv,
                                     dq_part, part_floats, b, sq, tk, h, kvh,
                                     scale, causal, window, cap, q_offset,
                                     st);
        case 256: return launch<256>(q, k, v, dout, lse, dsum, dq, dk, dv,
                                     dq_part, part_floats, b, sq, tk, h, kvh,
                                     scale, causal, window, cap, q_offset,
                                     st);
        default: return (int)cudaErrorInvalidValue;
    }
}
