// Mamba-2 SSD intra-chunk dual form for Hopper (sm_90a) [arXiv:2405.21060],
// products on the tensor cores in 3xTF32.
//
// Replaces the TPU kernel repro/kernels/ssd/chunk_kernel.py::_kernel
// (launched by ssd_intra_chunk, wrapped by ssd/ops.py::ssd_chunked).
//
// Per (batch x chunk, head), with chunk length Q, head dim P, state N and
// B, C shared across heads (n_groups = 1):
//     da     = dt * a_h                  cum = inclusive prefix sum of da
//     L      = tril(exp(cum_i - cum_j))
//     y_diag = ((C B^T) o L o dt_j) X    (Q, P)
//     state  = X^T (B o dt o exp(cum_Q - cum))     (P, N)
//     in_dec = exp(cum)                  (Q,)
//
// Bound: operations. The function needs the Q(Q+1)/2 pairs i >= j only:
// Q(Q+1)N FLOPs of C B^T per chunk (B and C are shared by its H heads),
// then per (chunk, head) Q(Q+1)P (W X) + 2QPN (the state), against
// 4(QP + Q) bytes of x and dt read and 4(QP + PN + Q) written per (chunk,
// head) and 8QN bytes of B and C per chunk. At the main path's (Q, P, N,
// H) = (256, 64, 128, 48) that is ~412 MFLOP per ~8.2 MB. On an NVIDIA
// H100 80GB HBM3 at its 700.00 W limit the products run as three TF32
// tensor-core products each (float32 accuracy, ../../csrc/mma_tf32.cuh):
// 165 TFLOP/s of float32 products at the 495 TFLOP/s TF32 data-sheet peak,
// so the work and the bytes (3.35 TB/s) take about the same least time.
//
// Design:
//  * one block of 8 warps per (batch x chunk, group of `hg` adjacent heads);
//    the launcher picks hg: the most that the accumulators take (128 / P,
//    so the group's concatenated P columns are at most 128), no more than
//    H, whose shared memory fits the device's per-block limit. A larger
//    group computes C B^T for more heads at once (on an H100 80GB HBM3 at
//    700.00 W, 1.09 ms at 2 heads per block against 1.62 ms at 1, PERF.md).
//    The last group may be partial (its missing heads are skipped). The
//    block reads x (B, L, H, P), dt (B, L, H), B and C (B, L, N) in place
//    and writes y in the same (B, L, H, P) layout: no regrouping copies. dt
//    for the group's heads is read as contiguous runs of hg floats;
//  * cum is an inclusive scan per head by one warp (each lane sums a run, a
//    shuffle scan joins the runs): the TPU forms it with a ones-tril
//    product, so the summation order differs. dt, cum and the decay to the
//    chunk's end stay in shared memory for the block's life;
//  * y: the block walks 64-row tiles I of the chunk and, for each, the
//    64-column tiles J <= I (the tiles above the diagonal are zero and
//    skipped). The 8 warps are 4 slices of 16 rows x 2 halves of the
//    group's concatenated (head, p) columns. C_I B_J^T is computed once for
//    the whole group (each warp a 16 x 32 part, in 3xTF32 mma.sync), passed
//    through shared memory over the B_J tile it was read from, and reused
//    for every head: w_h = CB o exp(cum_i - cum_j) o dt_j is formed in
//    registers straight into the A operand of y_I,h += w_h X_J,h (the k
//    index of each 8-key step is permuted, mma_tf32.cuh, so rows of CB are
//    read as pairs). exp(cum_i - cum_j) is evaluated only for i >= j: above
//    the diagonal the exponent is positive and may overflow, and inf * 0
//    would be NaN (chunk_kernel.py:54 discards it with a where). Each warp
//    keeps 16 x 64 y accumulators in registers (32 floats a lane);
//  * the state of each head, X_h^T (B o dec_h) (P x N over K = Q), runs on
//    the tensor cores in one pass over the chunk for all the group's heads:
//    warp w owns rows 16w .. 16w + 15 of the concatenated (head, p) rows,
//    and the B operand is scaled by dec_h on its way from shared memory;
//  * C_I, B_J and the group's X_J tiles are copied with 16-byte cp.async,
//    rows padded to N + 4 and P + 4 floats so every fragment load hits 32
//    distinct banks: 2 x 64 x 132 x 4 + hg x 64 x 68 x 4 + 12 hg Q bytes at
//    (P, N, Q) = (64, 128, 256), 108,544 at hg = 2, so two blocks (16
//    warps) share an H100 SM; __launch_bounds__ keeps 128 registers a
//    thread for that;
//  * padded steps (dt = 0, past the end of the sequence) have da = 0 and
//    contribute nothing to y or the state; rows past Q (Q < 64) are zero.
// Float32 only. Flags: default nvcc contraction (-fmad=true); the tests'
// tolerance (1e-4) covers the split products and the summation order.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

using tf32x3::FragA;

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int T = 64;             // tile of chunk positions (4 x 16 rows)
constexpr int CBS = T + 8;        // padded row stride of the C B^T tile

// heads per block at most: their concatenated P columns are 128, two
// halves of 64 for the two warps of each 16-row slice
template <int P>
__host__ __device__ constexpr int max_group() { return 128 / P; }

// the B tile's region, which the C B^T tile reuses
template <int N>
__host__ __device__ constexpr size_t b_floats() {
    return (size_t)T * (N + 4) > (size_t)T * CBS ? (size_t)T * (N + 4)
                                                 : (size_t)T * CBS;
}

template <int P, int N>
size_t smem_bytes(int q, int hg) {
    return sizeof(float) * ((size_t)T * (N + 4) + b_floats<N>()
                            + (size_t)hg * T * (P + 4) + 3 * (size_t)hg * q);
}

template <int P, int N>
__global__ void __launch_bounds__(THREADS, 2)
ssd_chunk_kernel(const float* __restrict__ x,     // (B, L, H, P)
                 const float* __restrict__ dt,    // (B, L, H)
                 const float* __restrict__ a,     // (H,)
                 const float* __restrict__ bm,    // (B, L, N)
                 const float* __restrict__ cm,    // (B, L, N)
                 float* __restrict__ y,           // (B, L, H, P)
                 float* __restrict__ states,      // (B, NC, H, P, N)
                 float* __restrict__ in_decay,    // (B, NC, H, Q)
                 int nc, int q, int h, int hg) {
    extern __shared__ float4 smem4[];
    constexpr int NS = N + 4;         // padded row stride of C and B
    constexpr int XS = P + 4;         // padded row stride of X
    constexpr int HW = P < 64 ? 64 / P : 1;   // heads a warp's half spans
    constexpr int CW = (P < 64 ? P : 64) / 8; // n-tiles per head and warp
    float* Cs = reinterpret_cast<float*>(smem4);   // T x NS
    float* Bs = Cs + T * NS;          // T x NS
    float* CBs = Bs;                  // T x CBS, once B_J is read
    float* Xs = Bs + b_floats<N>();   // hg x T x XS
    float* dts = Xs + hg * T * XS;    // hg x Q
    float* cum = dts + hg * q;        // hg x Q
    float* dec = cum + hg * q;        // hg x Q: exp(cum_{Q-1} - cum_j) dt_j

    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int bc = blockIdx.x, h0 = blockIdx.y * hg;
    const int nh = min(hg, h - h0);   // heads of this (maybe partial) group
    const int bi = bc / nc, ci = bc % nc;
    const int64_t tok0 = (int64_t)bi * nc * q + (int64_t)ci * q;

    for (int idx = tid; idx < q * hg; idx += THREADS) {
        const int j = idx / hg, e = idx % hg;
        dts[e * q + j] = e < nh ? dt[(tok0 + j) * h + h0 + e] : 0.0f;
    }
    __syncthreads();
    for (int e = warp; e < nh; e += WARPS) {   // inclusive scan of dt * a_h
        const float a_h = a[h0 + e];
        const float* d = dts + e * q;
        float* c = cum + e * q;
        const int per = (q + 31) / 32;
        const int j0 = lane * per;
        const int j1 = min(j0 + per, q);
        float run = 0.0f;
        for (int j = j0; j < j1; ++j) run += d[j] * a_h;
        float incl = run;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const float o = __shfl_up_sync(0xffffffffu, incl, off);
            if (lane >= off) incl += o;
        }
        run = incl - run;             // sum of the lanes before this one
        for (int j = j0; j < j1; ++j) {
            run += d[j] * a_h;
            c[j] = run;
        }
    }
    __syncthreads();
    for (int idx = tid; idx < q * nh; idx += THREADS) {
        const int e = idx / q, j = idx % q;
        const float cl = cum[e * q + q - 1], cj = cum[e * q + j];
        dec[e * q + j] = expf(cl - cj) * dts[e * q + j];
        in_decay[((int64_t)bc * h + h0 + e) * q + j] = expf(cj);
    }

    // copy rows [r0, r0 + T) of a (token, width)-strided tensor into a
    // padded tile, zeros past the chunk's end
    auto load_rows = [&](float* dst, int stride, const float* src,
                         int64_t row_pitch, int width, int r0) {
        const int chunks = width / 4;
        for (int idx = tid; idx < T * chunks; idx += THREADS) {
            const int r = idx / chunks, d = (idx % chunks) * 4;
            const bool ok = r0 + r < q;
            tf32x3::cp_async16(dst + r * stride + d,
                               ok ? src + (tok0 + r0 + r) * row_pitch + d
                                  : src, ok ? 16 : 0);
        }
    };
    auto load_b_x = [&](int r0) {   // B_J and the group's X_J tiles
        load_rows(Bs, NS, bm, N, N, r0);
        for (int e = 0; e < nh; ++e)
            load_rows(Xs + e * T * XS, XS, x + (int64_t)(h0 + e) * P,
                      (int64_t)h * P, P, r0);
    };

    const int ntiles = (q + T - 1) / T;
    // this warp's 16 rows of a tile, and its half of the group's
    // concatenated (head, p) columns: n-tile c is column 64 slot + 8c
    const int m = warp & 3, slot = warp >> 2;
    // ---- y_diag, 64 rows at a time -------------------------------------
    for (int it = 0; it < ntiles; ++it) {
        const int i0 = it * T;
        const int ir0 = i0 + 16 * m + g, ir1 = ir0 + 8;
        const bool active = i0 + 16 * m < q;
        float yacc[8][4];
#pragma unroll
        for (int c = 0; c < 8; ++c)
            yacc[c][0] = yacc[c][1] = yacc[c][2] = yacc[c][3] = 0.0f;

        for (int jt = 0; jt <= it; ++jt) {
            const int j0 = jt * T;
            __syncthreads();                 // last readers of the tiles done
            if (jt == 0) load_rows(Cs, NS, cm, N, N, i0);
            load_b_x(j0);
            tf32x3::cp_async_commit();
            tf32x3::cp_async_wait<0>();
            __syncthreads();

            // C_I B_J^T: this warp's 16 rows x 32 columns (n-tiles
            // 4 slot .. 4 slot + 3), then the whole 64 x 64 tile through
            // shared memory (over B_J, which is no longer read)
            float cb[4][4];
#pragma unroll
            for (int n = 0; n < 4; ++n)
                cb[n][0] = cb[n][1] = cb[n][2] = cb[n][3] = 0.0f;
            if (active) {
                const float* Cw = Cs + (16 * m + g) * NS + t;
#pragma unroll 4
                for (int kk = 0; kk < N / 8; ++kk) {
                    FragA fa;
                    fa.set(Cw[kk * 8], Cw[8 * NS + kk * 8], Cw[kk * 8 + 4],
                           Cw[8 * NS + kk * 8 + 4]);
#pragma unroll
                    for (int n = 0; n < 4; ++n) {
                        const float* br =
                            Bs + ((4 * slot + n) * 8 + g) * NS + kk * 8 + t;
                        tf32x3::mma3(cb[n], fa, br[0], br[4]);
                    }
                }
            }
            __syncthreads();                 // every read of B_J done
            if (active) {
#pragma unroll
                for (int n = 0; n < 4; ++n) {
                    float* o = CBs + (16 * m + g) * CBS + (4 * slot + n) * 8
                               + 2 * t;
                    *reinterpret_cast<float2*>(o) =
                        make_float2(cb[n][0], cb[n][1]);
                    *reinterpret_cast<float2*>(o + 8 * CBS) =
                        make_float2(cb[n][2], cb[n][3]);
                }
            }
            __syncthreads();
            if (!active) continue;

            // per head: y_I += (CB o exp(cum_i - cum_j) o dt_j) X_J
            const float* CBw = CBs + (16 * m + g) * CBS + 2 * t;
#pragma unroll
            for (int hw = 0; hw < HW; ++hw) {
                const int e = 64 * slot / P + hw;
                if (e >= nh) break;
                const float* ce = cum + e * q;
                const float* de = dts + e * q;
                const float ci0 = ir0 < q ? ce[ir0] : 0.0f;
                const float ci1 = ir1 < q ? ce[ir1] : 0.0f;
                const float* Xe = Xs + e * T * XS + (64 * slot + 64 * hw) % P;
#pragma unroll
                for (int n = 0; n < T / 8; ++n) {
                    const int ja = j0 + n * 8 + 2 * t, jb = ja + 1;
                    const float2 c01 =
                        *reinterpret_cast<const float2*>(CBw + n * 8);
                    const float2 c23 = *reinterpret_cast<const float2*>(
                        CBw + 8 * CBS + n * 8);
                    float w[4];              // (g, ja) (g, jb) (g+8, ja) (g+8, jb)
                    w[0] = ir0 >= ja && ir0 < q
                        ? c01.x * expf(ci0 - ce[ja]) * de[ja] : 0.0f;
                    w[1] = ir0 >= jb && ir0 < q
                        ? c01.y * expf(ci0 - ce[jb]) * de[jb] : 0.0f;
                    w[2] = ir1 >= ja && ir1 < q
                        ? c23.x * expf(ci1 - ce[ja]) * de[ja] : 0.0f;
                    w[3] = ir1 >= jb && ir1 < q
                        ? c23.y * expf(ci1 - ce[jb]) * de[jb] : 0.0f;
                    FragA fw;                // slot t: key 2t, t + 4: 2t + 1
                    fw.set(w[0], w[2], w[1], w[3]);
                    const float* xr = Xe + (n * 8 + 2 * t) * XS + g;
#pragma unroll
                    for (int c = 0; c < CW; ++c)
                        tf32x3::mma3(yacc[hw * CW + c], fw, xr[c * 8],
                                     xr[XS + c * 8]);
                }
            }
        }
        if (!active) continue;
#pragma unroll
        for (int hw = 0; hw < HW; ++hw) {
            const int e = 64 * slot / P + hw;
            if (e >= nh) break;
            const int p0 = (64 * slot + 64 * hw) % P;
#pragma unroll
            for (int c = 0; c < CW; ++c) {
                const int col = p0 + c * 8 + 2 * t;
                const float* v = yacc[hw * CW + c];
                if (ir0 < q)
                    *reinterpret_cast<float2*>(
                        y + ((tok0 + ir0) * h + h0 + e) * P + col) =
                        make_float2(v[0], v[1]);
                if (ir1 < q)
                    *reinterpret_cast<float2*>(
                        y + ((tok0 + ir1) * h + h0 + e) * P + col) =
                        make_float2(v[2], v[3]);
            }
        }
    }

    // ---- chunk states: X_h^T (B o dec_h) --------------------------------
    // warp w owns rows 16w .. 16w + 15 of the concatenated (head, p) rows
    const int se = 16 * warp / P, sp0 = 16 * warp % P;
    const bool sactive = se < nh;
    float st[N / 8][4];
#pragma unroll
    for (int n = 0; n < N / 8; ++n)
        st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.0f;
    const float* de = dec + se * q;
    for (int jt = 0; jt < ntiles; ++jt) {
        const int j0 = jt * T;
        __syncthreads();
        load_b_x(j0);
        tf32x3::cp_async_commit();
        tf32x3::cp_async_wait<0>();
        __syncthreads();
        if (!sactive) continue;
        const float* Xe = Xs + se * T * XS + sp0 + g;
#pragma unroll 2
        for (int s = 0; s < T / 8; ++s) {
            const int ja = j0 + s * 8 + 2 * t;
            const float* xr = Xe + (s * 8 + 2 * t) * XS;
            FragA fx;                        // slot t: key 2t, t + 4: 2t + 1
            fx.set(xr[0], xr[8], xr[XS], xr[XS + 8]);
            const float da = ja < q ? de[ja] : 0.0f;
            const float db = ja + 1 < q ? de[ja + 1] : 0.0f;
            const float* br = Bs + (s * 8 + 2 * t) * NS + g;
#pragma unroll
            for (int n = 0; n < N / 8; ++n)
                tf32x3::mma3(st[n], fx, br[n * 8] * da, br[NS + n * 8] * db);
        }
    }
    if (sactive) {
        float* so = states + ((int64_t)bc * h + h0 + se) * P * N;
#pragma unroll
        for (int n = 0; n < N / 8; ++n) {
            const int pr = sp0 + g, col = n * 8 + 2 * t;
            *reinterpret_cast<float2*>(so + pr * N + col) =
                make_float2(st[n][0], st[n][1]);
            *reinterpret_cast<float2*>(so + (pr + 8) * N + col) =
                make_float2(st[n][2], st[n][3]);
        }
    }
}

template <int P, int N>
int launch(const float* x, const float* dt, const float* a, const float* bm,
           const float* cm, float* y, float* states, float* in_decay,
           int bsz, int nc, int q, int h, cudaStream_t stream) {
    int dev = 0, limit = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(
            &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    // heads per block: as many as the accumulators take, within H and the
    // shared memory (dt, cum and the decay of each head grow with Q)
    int hg = h < max_group<P>() ? h : max_group<P>();
    while (hg > 1 && smem_bytes<P, N>(q, hg) > (size_t)limit) --hg;
    const size_t bytes = smem_bytes<P, N>(q, hg);
    if (bytes > (size_t)limit) return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(ssd_chunk_kernel<P, N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)(bsz * nc), (unsigned)((h + hg - 1) / hg));
    ssd_chunk_kernel<P, N><<<grid, THREADS, bytes, stream>>>(
        x, dt, a, bm, cm, y, states, in_decay, nc, q, h, hg);
    return (int)cudaGetLastError();
}

template <int P>
int launch_n(int n, const float* x, const float* dt, const float* a,
             const float* bm, const float* cm, float* y, float* states,
             float* in_decay, int bsz, int nc, int q, int h,
             cudaStream_t stream) {
    switch (n) {
        case 16: return launch<P, 16>(x, dt, a, bm, cm, y, states, in_decay,
                                      bsz, nc, q, h, stream);
        case 64: return launch<P, 64>(x, dt, a, bm, cm, y, states, in_decay,
                                      bsz, nc, q, h, stream);
        case 128: return launch<P, 128>(x, dt, a, bm, cm, y, states,
                                        in_decay, bsz, nc, q, h, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// Plain C entry point (loaded with ctypes). x (B, L, H, P), dt (B, L, H),
// a (H,), b/c (B, L, N) with L = nc * q, all float32, contiguous and
// 16-byte aligned; outputs y (B, L, H, P), states (B, nc, H, P, N),
// in_decay (B, nc, H, q). P in {32, 64, 128}, N in {16, 64, 128}. Launches
// on `stream` on the current device; returns 0 or the CUDA error.
extern "C" int ssd_chunk_launch(const float* x, const float* dt,
                                const float* a, const float* bm,
                                const float* cm, float* y, float* states,
                                float* in_decay, int bsz, int nc, int q,
                                int h, int p, int n, void* stream) {
    if (bsz <= 0 || nc <= 0 || h <= 0) return (int)cudaGetLastError();
    if (q <= 0) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    switch (p) {
        case 32: return launch_n<32>(n, x, dt, a, bm, cm, y, states,
                                     in_decay, bsz, nc, q, h, st);
        case 64: return launch_n<64>(n, x, dt, a, bm, cm, y, states,
                                     in_decay, bsz, nc, q, h, st);
        case 128: return launch_n<128>(n, x, dt, a, bm, cm, y, states,
                                       in_decay, bsz, nc, q, h, st);
        default: return (int)cudaErrorInvalidValue;
    }
}
