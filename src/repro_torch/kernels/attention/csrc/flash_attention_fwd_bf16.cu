// Flash attention forward in bf16 for Hopper (sm_90a): GQA with any G = H /
// KV, the scale, a tanh softcap before the masks, key padding, causal and
// sliding-window masks and q_offset, for bf16 q, k, v, computed in float32
// and rounded to bf16 once at the end, its products on the bf16 tensor
// cores (wgmma); optionally each row's float32 log-sum-exp, which the bf16
// backward (flash_attention_bwd_bf16.cu) recomputes P from. The float32
// forward is flash_attention.cu.
//
// Replaces the TPU kernel repro/kernels/attention/flash.py::_kernel as it
// runs on bf16 q, k, v: widened to float32, q scaled in float32, float32
// online softmax, the output rounded to bf16 once at the end. Fully masked
// scores are -inf; the running max is clamped at -0.7 FLT_MAX, so a fully
// masked row gives 0, and l == 0 counts as 1. lse is max(m, MIN_CLAMP) +
// log(l), in float32; a null pointer writes none.
//
// Products, float32-exact. S = Q K^T multiplies two bf16 tiles: one bf16
// wgmma, whose products are exact in its float32 sums. O += P V has a
// float32 operand, P: it is split into three bf16 planes (split3 in
// wgmma_bf16.cuh: each what the planes before it leave, rounded toward
// zero; hi + mid + lo == P exactly), each multiplied into V by one bf16
// wgmma into the float32 accumulator, small planes first. So the kernel
// forms the reference's float32 products, up to the order of the float32
// sums: 4 bf16 passes per (query, key) pair and query head.
//
// The scale is applied to the float32 accumulator S, where the reference
// scales q before the product: the two differ by float32 round-off only,
// and not at all where the scale is a power of two (hd 64, 256). The
// softmax runs in base 2: t = s * scale * log2(e) (with a softcap: t =
// cap * log2(e) * tanhf(s * scale / cap), tanhf the accurate one), P =
// 2^(t - max t) by ex2.approx.ftz (2 ulp as exp2f; a P below 2^-126,
// which the reference keeps as a denormal, is flushed to 0). The rounding
// of scale * log2(e) and of the max in base 2 add a relative error of at
// most about 2^-23 |t| to each P. The row max is kept in the units of s
// (before the factor), so lse's max is m = max(s) * scale (or cap x max
// tanh) as the reference forms it, and log(l) is the accurate logf.
//
// Bound: operations. Per visible (query, key) pair and query head: Q K^T,
// 2 hd FLOP bf16 x bf16, at the bf16 rate; P V, 2 hd FLOP with a float32
// operand, at 3 bf16 passes (chip_smoke.py::flash_fwd_bf16_bound). At
// tinyllama-1.1b's train_4k layer (B, S, H, KV, hd) = (4, 4096, 32, 4, 64),
// causal: 0.5560 ms at the 989 TFLOP/s bf16 peak of an NVIDIA H100 80GB
// HBM3 (700.00 W), against 0.02 ms for its bytes at 3.35 TB/s.
//
// What this replaces (PERF.md row 2''', NVIDIA H100 80GB HBM3, 700.00 W):
// flash_attention.cu's kernel with bf16 widened on load, 10.2359 ms at that
// layer. Its three faults and what this design does about each:
//  1. q, k, v widened to float32 in shared memory padded to hd + 4 floats
//     (199,680 B at hd 256, one block of 8 warps an SM): here they stay
//     bf16 in shared memory, as wgmma's 128-byte-swizzled tiles;
//  2. every product as 3xTF32 mma.sync m16n8k8, six TF32 passes per pair
//     and head at half the bf16 rate: here Q K^T is one bf16 wgmma pass and
//     P V three, on Hopper's full-rate path;
//  3. 32-key K and V tiles with one buffer each: here BN keys (32 to 64) in
//     a ring of STAGES tiles, copied with 16-byte cp.async while the
//     tile before runs (TMA not used: a row tile of (position, head) rows
//     of one KV head is no box for G that does not divide it, and K and V
//     tiles are the ring of the backward's dq pass, proven there).
//
// Design (deterministic: no atomics, every sum in a fixed order):
//  * a block of NW warpgroups per (batch x KV head, tile of 64 NW rows),
//    the rows flattened to (query position, query head of this KV head) as
//    in flash_attention.cu: row r is position r / G, head kv G + r % G, so
//    any G (G = 3 too) fits one tile shape and a tile reads contiguous
//    runs. Row tiles are issued last first: under a causal mask they see
//    the most keys. The Q tile is copied once, unscaled (scaled q is no
//    bf16 value);
//  * a loop walks the key tiles of BN keys that the block's rows can see,
//    in ascending order; per tile each warpgroup (64 rows) computes S = Q
//    K^T (m64nBNk16, both operands in shared memory), the online softmax on
//    the accumulator fragment (a thread holds two rows: row max and sum
//    over the quad of lanes), rescales its O accumulator (64 x hd float32
//    in registers) by the correction, and issues O += P V with P's three
//    planes as wgmma's register A operand straight from the accumulator
//    (its layout is the A fragment's) and V read MN-major from its tile
//    (m64nHDk16, hd 32 as 64 columns);
//  * a warpgroup skips a tile its rows cannot see (p = 0, correction 1:
//    skipping is exact), and evaluates the masks only on tiles that
//    straddle a limit (causal, window, the end of the keys or rows);
//  * tiles per head dim (Cfg): BN = 64 keys at hd <= 128, 32 at 256 (its
//    64 x 256 float32 O is 128 registers a thread); one warpgroup a block,
//    three blocks an SM at hd <= 64 (168 registers), two at 128 and 256
//    (241, 255); no spills. Measured variants (PERF.md, scripts/
//    flash_fwd_bf16_ab.py): two warpgroups a block sharing the key tiles
//    (16% slower at hd 64, within 5% either way at 256), 128 keys a step
//    at hd 64 (9% slower), 64 at hd 256 (3-10% faster, but spills), two
//    tiles copied ahead (no gain at hd 64, 18-25% slower at 256: one
//    block an SM), FA3's intra-warpgroup overlap (the next tile's S
//    issued before this tile's P V, its softmax under it: 4-5% slower at
//    hd 64), the O rescale skipped where a warp's corrections are all 1
//    (1-7% faster, within the 3-6% spread of repeat runs);
//  * epilogue: O / l rounded once to bf16 (round to nearest even), lse in
//    float32.
// Measured (PERF.md, NVIDIA H100 80GB HBM3, 700.00 W): 1.4924 ms at that
// layer with lse, 0.373 of the bound (cuDNN's bf16 forward, which rounds P
// to bf16: 0.6399); 0.4335 / 0.4508 ms at gemma2-2b's (1, 4500, 8, 4, 256)
// layers, softcap 50, windowed / global. With P's hi plane alone (an
// ablation, not float32-exact) 1.08 ms: the two low planes cost 0.4.
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

// ring of key tiles: STAGES - 1 tiles are copied ahead of the one in use
constexpr int STAGES = 2;
constexpr float MIN_CLAMP = -0.7f * 3.402823466e38f;

// Tiles per head dim: BN keys a step, NW warpgroups (64 rows each) a
// block, NB blocks an SM (launch bounds: the registers a thread may take)
template <int HD> struct Cfg;
template <> struct Cfg<32> {
    static constexpr int BN = 64, NW = 1, NB = 3;
};
template <> struct Cfg<64> {
    static constexpr int BN = 64, NW = 1, NB = 3;
};
template <> struct Cfg<128> {
    static constexpr int BN = 64, NW = 1, NB = 2;
};
template <> struct Cfg<256> {
    static constexpr int BN = 32, NW = 1, NB = 2;
};

// bytes of a tile of R rows x HDP bf16 columns
template <int HD>
__host__ __device__ constexpr int tile_bytes(int r) {
    return r * hdp<HD>() * 2;
}
// dynamic shared memory, with 1024 bytes to align the base
template <int HD> constexpr size_t fwd_smem() {
    return 1024 + tile_bytes<HD>(64 * Cfg<HD>::NW)
           + 2 * STAGES * tile_bytes<HD>(Cfg<HD>::BN);
}

struct Args {
    const bf16 *q, *k, *v;
    bf16* out;
    float* lse;           // (B, Sq, H) or null
    int bh;               // batch x KV heads: blockIdx.x = tile x bh + (b, kv)
    int sq, tk, h, kvh;
    float scale, cap;
    int causal, window;
    int64_t q_offset;
};

// The online softmax of a thread's two rows (16 w + g and + 8 of its
// warpgroup's 64), in base 2: t = f x the pre-transformed score, s *
// scale, or tanhf(s * scale / cap) with a softcap (|cap|: the softcap is
// odd in cap), f = log2(e) times the scale or the cap
struct Softmax {
    bool capped;
    float pre, f, kn;     // kn: the max of the pre-transformed s times kn is m
    int causal, window;
    // per row: the max of the pre-transformed scores so far, that max times
    // f clamped at MIN_CLAMP (the exponent's offset), this thread's share
    // of the sum of P
    float mx[2] = {-INFINITY, -INFINITY}, ms[2] = {MIN_CLAMP, MIN_CLAMP};
    float l[2] = {0.0f, 0.0f};

    __device__ explicit Softmax(const Args& a)
        : capped(a.cap != 0.0f),
          pre(a.cap != 0.0f ? a.scale / fabsf(a.cap) : 1.0f),
          f((a.cap != 0.0f ? fabsf(a.cap) : a.scale) * LOG2E),
          kn(a.cap != 0.0f ? fabsf(a.cap) : a.scale), causal(a.causal),
          window(a.window) {}

    // row i's max(m, MIN_CLAMP), m the max of its capped, masked scores
    __device__ __forceinline__ float m(int i) const {
        return mx[i] == -INFINITY ? MIN_CLAMP : mx[i] * kn;
    }

    // S of one key tile of kmax keys from kb (element 4 j + e at row 16 w
    // + g + 8 (e >> 1), key 8 j + 2 t + (e & 1)) to P in place, masked
    // scores -inf first where `masked` (a tile that some row does not see
    // whole; pos: the rows' positions, ra their indices, total the rows);
    // corr: each row's correction of the sums before this tile
    template <int NS>
    __device__ __forceinline__ void tile(float (&s)[NS], float (&corr)[2],
                                         bool masked,
                                         const int64_t (&pos)[2],
                                         const int (&ra)[2], int total,
                                         int kb, int kmax, int t) {
        if (capped) {
#pragma unroll
            for (int i = 0; i < NS; ++i) s[i] = tanhf(s[i] * pre);
        }
        if (masked) {
            int rel[2];
#pragma unroll
            for (int i = 0; i < 2; ++i)
                rel[i] = ra[i] < total ? rel32(pos[i] - kb) : NO_ROW;
#pragma unroll
            for (int j = 0; j < NS / 4; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    if (!visible(rel[e >> 1], 8 * j + 2 * t + (e & 1), kmax,
                                 causal, window))
                        s[4 * j + e] = -INFINITY;
        }
        float tmx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < NS / 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                tmx[e >> 1] = fmaxf(tmx[e >> 1], s[4 * j + e]);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            tmx[i] = fmaxf(tmx[i], __shfl_xor_sync(0xffffffffu, tmx[i], 1));
            tmx[i] = fmaxf(tmx[i], __shfl_xor_sync(0xffffffffu, tmx[i], 2));
            mx[i] = fmaxf(mx[i], tmx[i]);
            const float m2 = fmaxf(mx[i] * f, MIN_CLAMP);
            corr[i] = exp2_ftz(ms[i] - m2);
            ms[i] = m2;
        }
        float sum[2] = {0.0f, 0.0f};
#pragma unroll
        for (int j = 0; j < NS / 4; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float p = exp2_ftz(fmaf(s[4 * j + e], f, -ms[e >> 1]));
                s[4 * j + e] = p;
                sum[e >> 1] += p;
            }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + sum[i];
    }
};

// One block per (batch x KV head, tile of BQ rows), 64 rows a warpgroup;
// row tiles last first (`tiles` of them)
template <int HD>
__global__ void __launch_bounds__(WG_THREADS * Cfg<HD>::NW, Cfg<HD>::NB)
flash_fwd_bf16_kernel(const Args a, int tiles) {
    using C = Cfg<HD>;
    constexpr int HDP = hdp<HD>(), BN = C::BN, BQ = 64 * C::NW;
    constexpr int NT = WG_THREADS * C::NW;
    constexpr int NS = BN / 2, ND = HDP / 2;        // accumulator floats
    uint8_t* sm = smem_base();
    uint8_t* Qs = sm;
    uint8_t* Ks = Qs + tile_bytes<HD>(BQ);          // STAGES tiles of BN keys
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
    int64_t pos[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        ra[i] = wr0 + 16 * w + g + 8 * i;
        pos[i] = a.q_offset + ra[i] / G;
    }
    const int wr_last = (wr0 + 64 < rows.total ? wr0 + 64 : rows.total) - 1;
    const bool w_rows = wr0 < rows.total;
    const int64_t p_lo = a.q_offset + wr0 / G;
    const int64_t p_hi = a.q_offset + wr_last / G;

    Softmax sm_rows(a);
    float o[ND];
#pragma unroll
    for (int i = 0; i < ND; ++i) o[i] = 0.0f;

    // one commit group a tile, empty past the last, so that "all but the
    // latest STAGES - 2 groups landed" means the tile in use landed
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < nsteps) issue((int)k_lo + s * BN, s);
        else tf32x3::cp_async_commit();
    }
    for (int it = 0; it < nsteps; ++it) {
        const int kb = (int)k_lo + it * BN, st = it % STAGES;
        tf32x3::cp_async_wait<STAGES - 2>();   // stage st (and Q) landed
        fence_async_smem();
        block_sync<NT>();
        // into the stage every warpgroup finished with before the barrier
        const int ahead = it + STAGES - 1;
        if (ahead < nsteps) issue(kb + (STAGES - 1) * BN, ahead % STAGES);
        else tf32x3::cp_async_commit();

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

        float sc[NS];
        wg::fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
            wg::ss(sc, wg::kdesc(Qs, BQ, 64 * wgi, kk),
                   wg::kdesc(Kt, BN, 0, kk), kk);
        wg::commit();
        wg::wait<0>();
        wg::hold(sc);

        float corr[2];
        sm_rows.tile(sc, corr, !full, pos, ra, rows.total, kb, kmax, t);
#pragma unroll
        for (int j = 0; j < ND / 4; ++j) {
            o[4 * j] *= corr[0];
            o[4 * j + 1] *= corr[0];
            o[4 * j + 2] *= corr[1];
            o[4 * j + 3] *= corr[1];
        }

        // O += P V: P's planes as the register A operand, V MN-major
        planes_mma<BN / 16>(o, sc, Vt, BN);
        wg::commit();
        wg::wait<0>();
        wg::hold(o);
    }
    tf32x3::cp_async_wait<0>();        // the Q copy of an idle block

    // element 4 j + e of O at row 16 w + g + 8 (e >> 1), column 8 j + 2 t +
    // (e & 1)
    float* l = sm_rows.l;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
        if (l[i] == 0.0f) l[i] = 1.0f;
        if (ra[i] >= rows.total) continue;
        const int64_t idx = rows.index(ra[i]);
        if (a.lse != nullptr && t == 0)
            a.lse[idx] = sm_rows.m(i) + logf(l[i]);
        bf16* out = a.out + idx * HD + 2 * t;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
            store2(out + 8 * j, o[4 * j + 2 * i] / l[i],
                   o[4 * j + 2 * i + 1] / l[i]);
    }
}

template <int HD>
int launch(const Args& a, cudaStream_t stream) {
    constexpr int BQ = 64 * Cfg<HD>::NW;
    const int64_t tiles = ((int64_t)a.sq * (a.h / a.kvh) + BQ - 1) / BQ;
    if (tiles * a.bh > INT_MAX) return (int)cudaErrorInvalidValue;
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_bf16_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)fwd_smem<HD>());
    if (e != cudaSuccess) return (int)e;
    flash_fwd_bf16_kernel<HD>
        <<<(unsigned)(tiles * a.bh), WG_THREADS * Cfg<HD>::NW,
           fwd_smem<HD>(), stream>>>(a, (int)tiles);
    return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). q, out (B, Sq, H, hd); k, v
// (B, Tk, KV, hd); all bfloat16, contiguous and 16-byte aligned; hd in
// {32, 64, 128, 256}; H % KV == 0; Sq * H below 2^31. lse: null, or a
// float32 (B, Sq, H) array that receives each row's log-sum-exp. Launches
// on `stream`; returns 0 or the CUDA error.
extern "C" int flash_attention_fwd_bf16_launch(
        const void* q, const void* k, const void* v, void* out, void* lse,
        int b, int sq, int tk, int h, int kvh, int hd, float scale,
        int causal, int window, float cap, int64_t q_offset, void* stream) {
    if (b <= 0 || sq <= 0) return (int)cudaGetLastError();
    if (kvh <= 0 || h % kvh != 0 || tk < 0 ||
        (int64_t)sq * h >= INT_MAX || (int64_t)b * kvh >= INT_MAX)
        return (int)cudaErrorInvalidValue;
    const Args a{(const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out,
                 (float*)lse, b * kvh, sq, tk, h, kvh, scale, cap, causal,
                 window, q_offset};
    cudaStream_t st = (cudaStream_t)stream;
    switch (hd) {
        case 32: return launch<32>(a, st);
        case 64: return launch<64>(a, st);
        case 128: return launch<128>(a, st);
        case 256: return launch<256>(a, st);
        default: return (int)cudaErrorInvalidValue;
    }
}
