// Flash attention forward for Hopper (sm_90a): causal / non-causal GQA with
// an optional tanh softcap, key padding, causal and sliding-window masks,
// online softmax in float32.
//
// Replaces the TPU kernel repro/kernels/attention/flash.py::_kernel
// (launched by flash_attention_fwd, wrapped by attention/ops.py).
//
// Bound: operations. Per visible (query, key) pair and query head it does
// 2*hd multiply-adds for Q K^T and 2*hd for P V, against 4 bytes per
// element of q, k, v and out read or written once. At the main path's
// layer shape (B, S, H, KV, hd) = (4, 4500, 8, 4, 256) that is ~330 GFLOP
// per layer over ~440 MB: on an NVIDIA H100 80GB HBM3 at its 700.00 W
// limit (data-sheet peaks: 67 TFLOP/s float32 without tensor cores,
// 3.35 TB/s), ~5 ms of arithmetic against ~0.13 ms of memory traffic.
//
// Design (simple and right first; wgmma, TMA and pipelining are later
// work):
//  * one thread block per (batch x KV head, tile of 64 rows), where the
//    rows are the flattened (query position, query head of this KV head)
//    pairs: row r is position r / G and head kv*G + r % G, as the TPU
//    kernel holds all G query heads of one KV head in one program. For a
//    given position the G heads are adjacent in memory, so a row tile is
//    read as contiguous runs, and any G (including G = 3) fits one tile
//    shape;
//  * a loop inside the block walks the KV tiles (64 keys each) in place of
//    the TPU's sequential third grid axis. It visits only the tiles the
//    causal and window limits of the tile's rows can reach: a skipped tile
//    would contribute p = 0 and a correction of 1, so skipping is exact;
//  * the Q tile (pre-scaled by `scale`, as flash.py:47 scales before the
//    product), the K and V tiles and the 64 x 64 score tile live in shared
//    memory as float32 (bf16 inputs are widened on load); rows of Q and K
//    are padded by one float so the 16 keys a half-warp reads sit in 16
//    banks. At hd = 256 that is 214,528 bytes of dynamic shared memory,
//    under the 232,448 bytes a block may use on an H100, so one block runs
//    per SM;
//  * each of the 256 threads computes a 4 x 4 block of scores and owns
//    4 rows x hd/16 columns of the output accumulator in registers; one
//    warp per 8 rows does the row max / exp / sum with shuffles;
//  * numerics follow flash.py:52-83: softcap before the mask, masked
//    scores -inf, the running max clamped at -0.7 * FLT_MAX so a fully
//    masked row gives p = 0 and output 0, l == 0 treated as 1. expf and
//    tanhf are the accurate versions (no --use_fast_math).
// Flags: default nvcc contraction (-fmad=true); the float32 tolerance of
// the tests (3e-5) covers multiply-add rounding and the summation order.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int R = 64;        // rows (query position, query head) per block
constexpr int BK = 64;       // keys per KV tile
constexpr float MIN_CLAMP = -0.7f * 3.402823466e38f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
    return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
    return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);
}

template <int HD>
constexpr size_t smem_bytes() {
    return sizeof(float) * ((size_t)R * (HD + 1) + (size_t)BK * (HD + 1)
                            + (size_t)BK * HD + (size_t)R * (BK + 1) + 3 * R);
}

template <int HD, typename T>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const T* __restrict__ q,      // (B, Sq, H, HD)
                 const T* __restrict__ k,      // (B, Tk, KV, HD)
                 const T* __restrict__ v,      // (B, Tk, KV, HD)
                 T* __restrict__ out,          // (B, Sq, H, HD)
                 int sq, int tk, int h, int kvh, float scale, int causal,
                 int window, float cap, int64_t q_offset) {
    extern __shared__ float smem[];
    constexpr int QS = HD + 1;               // padded row stride of Q and K
    constexpr int SS = BK + 1;               // padded row stride of S
    constexpr int NCOL = HD / 16;            // accumulator columns/thread
    float* Qs = smem;                        // R x QS
    float* Ks = Qs + R * QS;                 // BK x QS
    float* Vs = Ks + BK * QS;                // BK x HD
    float* Ss = Vs + BK * HD;                // R x SS
    float* m_s = Ss + R * SS;                // R running max
    float* l_s = m_s + R;                    // R running denominator
    float* c_s = l_s + R;                    // R correction of this tile

    const int tid = threadIdx.x;
    const int tx = tid & 15, ty = tid >> 4;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = h / kvh;
    const int b = blockIdx.y / kvh, kh = blockIdx.y % kvh;
    const int64_t rows_total = (int64_t)sq * g;
    const int64_t r0 = (int64_t)blockIdx.x * R;

    // offset of row r's first element in q / out
    auto row_offset = [&](int64_t rg) -> int64_t {
        const int64_t s = rg / g;
        const int gi = (int)(rg - s * g);
        return (((int64_t)b * sq + s) * h + (int64_t)kh * g + gi) * HD;
    };

    for (int idx = tid; idx < R * HD; idx += THREADS) {
        const int r = idx / HD, d = idx % HD;
        const int64_t rg = r0 + r;
        Qs[r * QS + d] = rg < rows_total
            ? to_f32(q[row_offset(rg) + d]) * scale : 0.0f;
    }
    if (tid < R) {
        m_s[tid] = -INFINITY;
        l_s[tid] = 0.0f;
    }

    // the keys this tile's rows can see
    const int64_t last = (r0 + R - 1 < rows_total ? r0 + R - 1
                                                   : rows_total - 1);
    const int64_t qpos_lo = q_offset + r0 / g, qpos_hi = q_offset + last / g;
    int64_t k_begin = 0, k_end = tk;
    if (causal && qpos_hi + 1 < k_end) k_end = qpos_hi + 1;
    if (window > 0 && qpos_lo - window + 1 > k_begin)
        k_begin = qpos_lo - window + 1;

    float acc[4][NCOL];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NCOL; ++c) acc[i][c] = 0.0f;

    for (int64_t k0 = k_begin; k0 < k_end; k0 += BK) {
        __syncthreads();                     // last tile's readers are done
        for (int idx = tid; idx < BK * HD; idx += THREADS) {
            const int j = idx / HD, d = idx % HD;
            const int64_t kp = k0 + j;
            float kval = 0.0f, vval = 0.0f;  // padded keys: zero, masked
            if (kp < tk) {
                const int64_t off = (((int64_t)b * tk + kp) * kvh + kh) * HD
                                    + d;
                kval = to_f32(k[off]);
                vval = to_f32(v[off]);
            }
            Ks[j * QS + d] = kval;
            Vs[j * HD + d] = vval;
        }
        __syncthreads();

        // scores: rows ty + 16 i, keys tx + 16 j
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
        for (int d = 0; d < HD; ++d) {
            float qv[4], kv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * QS + d];
#pragma unroll
            for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * QS + d];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) s[i][j] += qv[i] * kv[j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int r = ty + 16 * i;
            const int64_t qpos = q_offset + (r0 + r) / g;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int64_t kp = k0 + tx + 16 * j;
                float sv = s[i][j];
                if (cap != 0.0f) sv = cap * tanhf(sv / cap);
                bool ok = kp < tk;
                if (causal) ok = ok && qpos >= kp;
                if (window > 0) ok = ok && (qpos - kp) < window;
                Ss[r * SS + tx + 16 * j] = ok ? sv : -INFINITY;
            }
        }
        __syncthreads();

        // online softmax, one warp per R / 8 rows
        for (int rr = 0; rr < R / 8; ++rr) {
            const int r = warp * (R / 8) + rr;
            float sv[BK / 32];
            float mx = -INFINITY;
#pragma unroll
            for (int u = 0; u < BK / 32; ++u) {
                sv[u] = Ss[r * SS + lane + 32 * u];
                mx = fmaxf(mx, sv[u]);
            }
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_prev = m_s[r];
            const float m_new = fmaxf(m_prev, mx);
            const float m_safe = fmaxf(m_new, MIN_CLAMP);
            float sum = 0.0f;
#pragma unroll
            for (int u = 0; u < BK / 32; ++u) {
                const float p = expf(sv[u] - m_safe);
                Ss[r * SS + lane + 32 * u] = p;
                sum += p;
            }
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                sum += __shfl_xor_sync(0xffffffffu, sum, off);
            if (lane == 0) {
                const float corr = expf(fmaxf(m_prev, MIN_CLAMP) - m_safe);
                l_s[r] = l_s[r] * corr + sum;
                m_s[r] = m_new;
                c_s[r] = corr;
            }
        }
        __syncthreads();

        // acc = acc * corr + P V: rows ty + 16 i, columns tx + 16 c
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float corr = c_s[ty + 16 * i];
#pragma unroll
            for (int c = 0; c < NCOL; ++c) acc[i][c] *= corr;
        }
#pragma unroll 2
        for (int jj = 0; jj < BK; ++jj) {
            float pv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) pv[i] = Ss[(ty + 16 * i) * SS + jj];
#pragma unroll
            for (int c = 0; c < NCOL; ++c) {
                const float vv = Vs[jj * HD + tx + 16 * c];
#pragma unroll
                for (int i = 0; i < 4; ++i) acc[i][c] += pv[i] * vv;
            }
        }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        const int64_t rg = r0 + r;
        if (rg >= rows_total) continue;
        float l = l_s[r];
        if (l == 0.0f) l = 1.0f;
        T* o = out + row_offset(rg);
#pragma unroll
        for (int c = 0; c < NCOL; ++c)
            o[tx + 16 * c] = from_f32<T>(acc[i][c] / l);
    }
}

template <int HD, typename T>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int sq, int tk, int h, int kvh, float scale, int causal,
           int window, float cap, int64_t q_offset, cudaStream_t stream) {
    const size_t bytes = smem_bytes<HD>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<HD, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
    const int64_t rows = (int64_t)sq * (h / kvh);
    const dim3 grid((unsigned)((rows + R - 1) / R), (unsigned)(b * kvh));
    flash_fwd_kernel<HD, T><<<grid, THREADS, bytes, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)out, sq, tk, h, kvh,
        scale, causal, window, cap, q_offset);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v,
              void* out, int b, int sq, int tk, int h, int kvh, float scale,
              int causal, int window, float cap, int64_t q_offset,
              cudaStream_t stream) {
    switch (hd) {
        case 32: return launch<32, T>(q, k, v, out, b, sq, tk, h, kvh, scale,
                                      causal, window, cap, q_offset, stream);
        case 64: return launch<64, T>(q, k, v, out, b, sq, tk, h, kvh, scale,
                                      causal, window, cap, q_offset, stream);
        case 128: return launch<128, T>(q, k, v, out, b, sq, tk, h, kvh,
                                        scale, causal, window, cap, q_offset,
                                        stream);
        case 256: return launch<256, T>(q, k, v, out, b, sq, tk, h, kvh,
                                        scale, causal, window, cap, q_offset,
                                        stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// Plain C entry point (loaded with ctypes). q (B, Sq, H, hd), k/v
// (B, Tk, KV, hd), out (B, Sq, H, hd), all contiguous, float32
// (is_bf16 = 0) or bfloat16 (is_bf16 = 1); hd in {32, 64, 128, 256};
// H % KV == 0. Launches on `stream`; returns 0 or the CUDA error.
extern "C" int flash_attention_fwd_launch(
        const void* q, const void* k, const void* v, void* out, int b,
        int sq, int tk, int h, int kvh, int hd, int is_bf16, float scale,
        int causal, int window, float cap, int64_t q_offset, void* stream) {
    if (b <= 0 || sq <= 0) return (int)cudaGetLastError();
    if (kvh <= 0 || h % kvh != 0) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    return is_bf16
        ? launch_hd<__nv_bfloat16>(hd, q, k, v, out, b, sq, tk, h, kvh,
                                   scale, causal, window, cap, q_offset, st)
        : launch_hd<float>(hd, q, k, v, out, b, sq, tk, h, kvh, scale,
                           causal, window, cap, q_offset, st);
}
